"""The salience histogram kernel (csrc/pv_info_kernels.cu) and the PV
family's card paths, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pv_info.py
"""
import math

import numpy as np
import pytest
import torch

from flan_tpu_torch import Audio
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.ops import pv_info_kernels as pk
from flan_tpu_torch.ops import scan_kernels
from flan_tpu_torch.pv import modify_extra

LOG2_MIN = math.log2(55.0)
# get_salience on the card against the CPU on the same planes, times its
# peak (1): the same peaks, their amplitude corrections through torch's
# sin on each device (an ulp apart), then the same adds in the same order
TOL_SAL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(frames, k_cnt, width=620, seed=1):
    """Peaks with the kernel's edge cases: a frame with no peak, the row's
    first and last valid bins, i_f <= 0 entries, empty slots past a
    frame's peaks (made at least 6 x 8, then cut to frames x k_cnt)."""
    rng = np.random.default_rng(seed)
    shape = (max(frames, 6), max(k_cnt, 8))
    i_f = rng.uniform(60.0, 3000.0, shape).astype(np.float32)
    i_m = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    i_m[1] = 0.0
    top = 55.0 * 2.0 ** ((width - 21) / 120.0)
    i_f[2, :3] = (55.0, top, 55.0 * 2.0 ** (-0.5 / 120.0))
    i_f[3, :3] = (0.0, -5.0, 1e-12)
    i_m[4, shape[1] // 2:] = 0.0
    return (torch.from_numpy(i_f[:frames, :k_cnt].copy()),
            torch.from_numpy(i_m[:frames, :k_cnt].copy()))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,k_cnt", [(6, 1), (40, 16), (17, 48),
                                          (33, 2049)])
def test_kernel_matches_plain_version(cuda_device, frames, k_cnt):
    """Against the plain version on the CPU on the same inputs, K from 1
    to 2,049 (the most a PV of 2,049 bins gives), blocks ragged at the
    end: the same bits (both take the log2 in float64, add in one order
    and round every product and sum on its own)."""
    i_f, i_m = _inputs(frames, k_cnt)
    want = pk.salience_histogram_ref(i_f, i_m, 620, LOG2_MIN)
    pk.reset_launch_counts()
    got = pk.salience_histogram(i_f.to(cuda_device), i_m.to(cuda_device),
                                620, LOG2_MIN)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["salience_histogram"] == 1
    assert got.shape == want.shape == (frames, 600)
    assert torch.equal(got.cpu(), want), float((got.cpu() - want).abs().max())


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_every_call(cuda_device):
    i_f, i_m = (t.to(cuda_device) for t in _inputs(5000, 64))
    first = pk.salience_histogram_cuda(i_f, i_m, 620, LOG2_MIN)
    for _ in range(3):
        assert torch.equal(pk.salience_histogram_cuda(i_f, i_m, 620,
                                                      LOG2_MIN), first)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    i_f, i_m = _inputs(4, 8)
    with pytest.raises(ValueError):
        pk.salience_histogram_cuda(i_f, i_m, 620, LOG2_MIN)   # on the CPU
    with pytest.raises(ValueError):
        pk.salience_histogram_cuda(i_f.cuda(), i_m.cuda(), 641, LOG2_MIN)
    with pytest.raises(ValueError):
        pk.salience_histogram_cuda(i_f.cuda(), i_m[:, :4].cuda(), 620,
                                   LOG2_MIN)


def _tone_pv(device, seconds=2.0, sr=48000.0):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(3)
    x = np.stack([sum(0.4 / k * np.sin(2 * np.pi * k * (220.0 + 30.0 * t)
                                       * t) for k in range(1, 6))
                  + 0.02 * rng.standard_normal(n)] * 2).astype(np.float32)
    return Audio.create_from_array(x, sr, device=device).convert_to_PV(
        2048, 128, 4096)


@pytest.mark.cuda
def test_get_salience_on_the_card_matches_the_cpu(cuda_device):
    """A whole get_salience call on the card against the same call on the
    CPU on the card's planes; two card calls give the same bits."""
    pv = _tone_pv(cuda_device)
    m, f = pv.to_numpy()
    cpu = pv_from_numpy(m, f, pv.sample_rate, pv.hop_size, pv.window_size,
                        device="cpu")
    pk.reset_launch_counts()
    got = pv.get_salience(0)
    assert pk.LAUNCHES["salience_histogram"] == 1
    again = pv.get_salience(0)
    assert np.array_equal(got.buffer, again.buffer)
    want = cpu.get_salience(0)
    assert got.buffer.shape == want.buffer.shape
    assert np.abs(got.buffer - want.buffer).max() <= TOL_SAL


@pytest.mark.cuda
def test_stretch_spline_on_the_card_runs_the_linear_scan(cuda_device):
    """stretch_spline launches the linear scan kernel twice a plane (four
    a call) and matches the CPU's plain run to float32 rounding of the
    two scans' orders (1e-5 of the peak)."""
    pv = _tone_pv(cuda_device, seconds=0.5)
    m, f = pv.to_numpy()
    cpu = pv_from_numpy(m, f, pv.sample_rate, pv.hop_size, pv.window_size,
                        device="cpu")
    scan_kernels.reset_launch_counts()
    got = pv.stretch_spline(lambda t: 1.0 + 6.0 * t)
    torch.cuda.synchronize()
    assert scan_kernels.LAUNCHES["scan_linear"] == 4
    want = cpu.stretch_spline(lambda t: 1.0 + 6.0 * t)
    for a, b in zip(got.to_numpy(), want.to_numpy()):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [7, 100])
def test_modify_on_the_card_in_chunks(monkeypatch, cuda_device, chunk):
    """modify on the card over chunks of frames: the bits of one chunk
    of everything (scatter-max is order-free), and the CPU's run within
    1e-5 of the peak."""
    pv = _tone_pv(cuda_device, seconds=0.3)

    def mod(t, f):
        return (t * (0.8 + 0.2 * t) + f * 1e-7 * t, f * (0.95 - 0.1 * t)
                + 20.0)
    whole = pv.modify(mod)
    monkeypatch.setattr(modify_extra, "MODIFY_CHUNK_QUADS", 2048 * chunk)
    part = pv.modify(mod)
    assert torch.equal(whole.mag, part.mag)
    assert torch.equal(whole.freq, part.freq)
    m, f = pv.to_numpy()
    cpu = pv_from_numpy(m, f, pv.sample_rate, pv.hop_size, pv.window_size,
                        device="cpu").modify(mod)
    assert np.abs(part.mag.cpu().numpy() - cpu.mag.numpy()).max() <= \
        1e-5 * float(cpu.mag.abs().max())
