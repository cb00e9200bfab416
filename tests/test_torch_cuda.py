"""flan_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import flan_tpu_torch
from flan_tpu_torch.ops import spv_kernels

SR = 48000.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _signal(n, ch, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / SR
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 1187.0 * t + 0.3)
         + 0.01 * rng.standard_normal(n).astype(np.float32))
    return np.ascontiguousarray(np.stack([x, -0.5 * x])[:ch],
                                dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,ch,n", [(16, 1, 4001), (96, 2, 20000),
                                        (512, 1, 30011), (2048, 1, 9000)])
def test_spv_kernels_match_plain(cuda_device, nbins, ch, n):
    x = torch.from_numpy(_signal(n, ch)).to(cuda_device)
    before = dict(spv_kernels.LAUNCHES)
    mag, freq = spv_kernels.spv_forward(x, nbins, SR)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, nbins, SR)
    m64, f64 = spv_kernels.spv_forward_ref(x.double(), nbins, SR)
    out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    ref_out = spv_kernels.spv_inverse_ref(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert spv_kernels.LAUNCHES["spv_forward"] == before["spv_forward"] + 1
    assert spv_kernels.LAUNCHES["spv_inverse"] == before["spv_inverse"] + 1
    scale = ref_m.abs().max()
    assert (mag - ref_m).abs().max() < 1e-5 * scale
    # frequencies: as accurate as the float32 plain version, against the
    # float64 one (float32 drift on weak bins: see chip_smoke.py phase 2)
    live = m64 > 1e-3 * scale
    drift_kernel = (freq[live] - f64[live]).pow(2).mean().sqrt()
    drift_plain = (ref_f[live] - f64[live]).pow(2).mean().sqrt()
    assert drift_kernel <= 2.0 * drift_plain + 1e-4
    assert (out - ref_out).abs().max() < 1e-4 * ref_out.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,ch,n", [(2, 1, 1), (2, 2, 300), (3, 3, 129),
                                        (17, 1, 127), (33, 2, 1000)])
def test_spv_kernels_edge_shapes(cuda_device, nbins, ch, n):
    """The smallest bin count, one partial tile, odd bin counts and three
    channels; short enough that float32 drift stays at rounding."""
    x = torch.from_numpy(np.tile(_signal(n, 1), (ch, 1)) *
                         np.float32([[1.0], [-0.5], [0.25]][:ch])).to(
        cuda_device)
    mag, freq = spv_kernels.spv_forward(x, nbins, SR)
    ref_m, ref_f = spv_kernels.spv_forward_ref(x, nbins, SR)
    out = spv_kernels.spv_inverse(ref_m, ref_f, SR)
    ref_out = spv_kernels.spv_inverse_ref(ref_m, ref_f, SR)
    torch.cuda.synchronize()
    assert mag.shape == (ch, n, nbins) and out.shape == (ch, n)
    scale = ref_m.abs().max()
    assert (mag - ref_m).abs().max() <= 1e-5 * scale
    strong = ref_m > 1e-2 * scale
    assert (freq - ref_f)[strong].abs().max() < 0.1
    assert (out - ref_out).abs().max() <= 1e-4 * ref_out.abs().max()


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_input(cuda_device):
    x = torch.zeros((1, 256), device=cuda_device)
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x.double(), 16, SR)
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x, spv_kernels.MAX_BINS + 1, SR)
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x[:, ::2], 16, SR)


@pytest.mark.cuda
def test_stretch_runs_on_the_card(cuda_device):
    """The stretch on the card against the CPU, at the size the CPU tests
    hold the port to the JAX package (sr 8000, 6000 samples)."""
    x = _signal(6000, 2)
    cpu = (flan_tpu_torch.Audio.create_from_array(x, 8000.0)
           .convert_to_PV(512, 64, 512).stretch(2.0).convert_to_audio())
    gpu = (flan_tpu_torch.Audio.create_from_array(x, 8000.0,
                                                  device=cuda_device)
           .convert_to_PV(512, 64, 512).stretch(2.0).convert_to_audio())
    assert gpu.device.type == "cuda"
    want = cpu.to_numpy()
    got = gpu.to_numpy()
    assert got.shape == want.shape
    # cuFFT against pocketfft, integrated into phase by the inverse: 6.0e-5
    # of the peak on chip_smoke.py's signal of this size (H100); bound 3x
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()
