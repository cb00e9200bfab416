"""flan_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import flan_tpu_torch
from flan_tpu_torch.ops import spv_kernels, sqpv_kernels
from flan_tpu_torch.sqpv.transform import sqpv_forward, sqpv_inverse

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
    cpu = (flan_tpu_torch.Audio.create_from_array(x, 8000.0, device="cpu")
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


def _decoded(pitch, positive):
    return torch.where(positive, 1.0, -1.0).double() * torch.exp2(
        pitch.double())


def _rms_mod(a, b, period):
    """RMS of a - b with each difference wrapped into [-period/2, period/2]."""
    d = a - b
    return (d - period * (d / period).round()).pow(2).mean().sqrt()


def _sqpv_checks(x, sr, bpo, band, tol_mag=2e-5, tol_inv=2e-4):
    """B3 and B4 against their plain versions on the same CUDA tensors:
    magnitude against the peak, the decoded frequency's RMS drift against
    the float64 plain version at most twice the float32 plain version's
    (modulo the sample rate, as chip_smoke.py sqpv_errors says why), and
    the inverse on the plain planes against the plain inverse."""
    before = dict(sqpv_kernels.LAUNCHES)
    mag, pitch, pos = sqpv_forward(x, sr, bpo, band)
    ref = sqpv_kernels.sqpv_forward_ref(x, sr, bpo, band)
    ref64 = sqpv_kernels.sqpv_forward_ref(x.double(), sr, bpo, band)
    out = sqpv_inverse(*ref, sr, bpo, band)
    ref_out = sqpv_kernels.sqpv_inverse_ref(*ref, sr, bpo, band)
    torch.cuda.synchronize()
    assert sqpv_kernels.LAUNCHES["sqpv_forward"] == \
        before["sqpv_forward"] + 1
    assert sqpv_kernels.LAUNCHES["sqpv_inverse"] == \
        before["sqpv_inverse"] + 1
    assert mag.shape == pitch.shape == pos.shape == ref[0].shape
    assert pos.dtype == torch.bool and out.shape == x.shape
    scale = ref[0].abs().max()
    live = ref64[0] > 1e-3 * scale
    f64 = _decoded(*ref64[1:])[live]
    drift_kernel = _rms_mod(_decoded(pitch, pos)[live], f64, sr)
    drift_plain = _rms_mod(_decoded(*ref[1:])[live], f64, sr)
    mag_err = (mag - ref[0]).abs().max() / scale
    inv_err = (out - ref_out).abs().max() / ref_out.abs().max()
    print(f"sr={sr} bpo={bpo} band={band} shape={tuple(mag.shape)}: "
          f"mag {float(mag_err):.3g}, drift {float(drift_kernel):.4g} vs "
          f"{float(drift_plain):.4g} Hz, inverse {float(inv_err):.3g}")
    # chip_smoke.py's tolerances: its largest readings are 1.21e-5
    # (magnitude) and 1.00e-4 (inverse) at 10 s, 1.05e-5 here on one bin
    assert mag_err <= tol_mag
    assert drift_kernel <= 2.0 * drift_plain + 1e-4
    assert inv_err <= tol_inv


@pytest.mark.cuda
@pytest.mark.parametrize("sr,bpo,band,ch,n", [
    (8000.0, 6.0, (100.0, 3000.0), 1, 16000),
    (8000.0, 12.0, (100.0, 3000.0), 2, 12345),
    (48000.0, 24.0, (16.0, 24000.0), 1, 96000),
    (48000.0, 12.0, (16.0, 24000.0), 2, 50001)])
def test_sqpv_kernels_match_plain(cuda_device, sr, bpo, band, ch, n):
    x = torch.from_numpy(_signal(n, ch)).to(cuda_device)
    _sqpv_checks(x, sr, bpo, band)


@pytest.mark.cuda
@pytest.mark.parametrize("bpo,band,ch,n", [
    (6.0, (1150.0, 1250.0), 1, 3000),      # one bin, at the 1187 Hz tone
    (6.0, (100.0, 3000.0), 1, 100),        # shorter than a tile
    (8.0, (200.0, 2000.0), 3, 1300)])      # three channels, odd periods
def test_sqpv_kernels_edge_shapes(cuda_device, bpo, band, ch, n):
    x = torch.from_numpy(np.tile(_signal(n, 1), (ch, 1)) *
                         np.float32([[1.0], [-0.5], [0.25]][:ch])).to(
        cuda_device)
    _sqpv_checks(x.contiguous(), 8000.0, bpo, band)


@pytest.mark.cuda
def test_sqpv_wrappers_reject_bad_input(cuda_device):
    x = torch.zeros((1, 256), device=cuda_device)
    band = (100.0, 3000.0)
    with pytest.raises(ValueError):
        sqpv_forward(x.double(), 8000.0, 6.0, band)
    with pytest.raises(ValueError):
        sqpv_forward(x[:, ::2], 8000.0, 6.0, band)
    mag = torch.zeros((1, 8, 30), device=cuda_device)
    with pytest.raises(ValueError):
        sqpv_inverse(mag, mag, mag, 8000.0, 6.0, band)   # positive not bool
    with pytest.raises(ValueError):
        sqpv_inverse(mag, mag, mag.bool(), 8000.0, 8.0, band)   # 27 bins


@pytest.mark.cuda
def test_sqpv_round_trip_runs_on_the_card(cuda_device):
    """The SQPV class path and repitch on the card against the CPU."""
    x = _signal(3000, 2)
    band = (100.0, 3000.0)
    runs = [flan_tpu_torch.Audio.create_from_array(x, 8000.0, device=d)
            .convert_to_SQPV(band, 6.0).repitch(1.5).convert_to_audio()
            for d in ("cpu", cuda_device)]
    want, got = (a.to_numpy() for a in runs)
    assert runs[1].device.type == "cuda" and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
