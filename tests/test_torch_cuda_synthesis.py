"""The synthesis kernels (csrc/random_kernels.cu K1, csrc/synth_kernels.cu
K2 and K3), C.18's float32 grid and the synthesis paths, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_synthesis.py
"""
import math

import numpy as np
import pytest
import torch

from flan_tpu_torch import Audio, PitchMode, SnapMode, Wavetable
from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func.function import waveforms
from flan_tpu_torch.ops import cycle_scan as cs
from flan_tpu_torch.ops import grain_mix as gm
from flan_tpu_torch.ops import random as rnd
from flan_tpu_torch.ops import scan_kernels

SR = 48000.0
# a synthesis call on the card against the same call on the CPU, times
# the peak: the same kernels' bits, with torch's sin, cos and FFTs on each
# device an ulp or so apart, through the resampler
TOL_PATH = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 5])
def test_float_iota_on_the_card(cuda_device, start):
    """28,800,001 elements: each index rounded once, plus the start."""
    n = 28_800_001
    want = np.arange(n, dtype=np.int64).astype(np.float32) + np.float32(
        start)
    got = float_iota(start, start + n, device=cuda_device).cpu().numpy()
    assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1_000_003])
@pytest.mark.parametrize("seed,lo,hi", [(0, -1.0, 1.0),
                                        (2 ** 40 + 9, 0.0, 2 * math.pi)])
def test_threefry_matches_plain(cuda_device, n, seed, lo, hi):
    k = rnd.key(seed)
    want = rnd.threefry_ref(k, n, lo, hi)
    rnd.reset_launch_counts()
    got = rnd.uniform(k, n, lo, hi, cuda_device)
    torch.cuda.synchronize()
    assert rnd.LAUNCHES["threefry_uniform"] == 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(rnd.random_bits(k, n, cuda_device).cpu(),
                       rnd.random_bits(k, n, "cpu"))
    assert rnd.split(k, 3, cuda_device) == rnd.split(k, 3, "cpu")


@pytest.mark.cuda
def test_threefry_same_bits_every_call(cuda_device):
    k = rnd.key(17)
    first = rnd.threefry_cuda(k, 5_000_011, -1.0, 1.0, cuda_device)
    for _ in range(3):
        assert torch.equal(rnd.threefry_cuda(k, 5_000_011, -1.0, 1.0,
                                             cuda_device), first)


def _wrap_heavy(n, in_rate, seed=0):
    """Frequencies up to 3.5 times the rate either way: the increments
    wrap at every sample, negatives take 1 - frac."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(-3.5, 3.5, n) * in_rate
    f[: n // 3] = 220.0 + 2000.0 * np.arange(n // 3) / in_rate
    return torch.from_numpy(f.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 65_537,
                               1_000_003])
def test_cycle_scan_matches_plain(cuda_device, n):
    in_rate = 768000.0
    f = _wrap_heavy(n, in_rate)
    want = cs.cycle_scan_ref(f, None, in_rate, n)
    cs.reset_launch_counts()
    got = cs.cycle_scan(f.to(cuda_device), None, in_rate, n)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["cycle_scan"] == 1
    assert torch.equal(got.cpu(), want)
    plain_card = cs.cycle_scan_ref(f.to(cuda_device), None, in_rate, n)
    assert torch.equal(plain_card.cpu(), want)
    inc = cs.constant_increment(440.0, in_rate)
    assert torch.equal(cs.cycle_scan(None, inc, in_rate, n, cuda_device)
                       .cpu(), cs.cycle_scan_ref(None, inc, in_rate, n))


@pytest.mark.cuda
def test_cycle_scan_same_bits_every_call(cuda_device):
    in_rate = 768000.0
    n = 40_000_003
    f = _wrap_heavy(n, in_rate).to(cuda_device)
    first = cs.cycle_scan_cuda(f, None, in_rate, n)
    for _ in range(3):
        assert torch.equal(cs.cycle_scan_cuda(f, None, in_rate, n), first)
    assert torch.equal(first.cpu(), cs.cycle_scan_ref(f.cpu(), None,
                                                      in_rate, n))


def _plan(seed, count, width, n, span, envelope):
    rng = np.random.default_rng(seed)
    s0 = rng.integers(0, n - width, count)
    lens = rng.integers(1, width + 1, count)
    fts = rng.integers(0, width // 2, count)
    sf = np.minimum(fts, lens)
    ef = np.minimum(fts, lens)
    over = sf + ef > lens
    sf = np.where(over, (sf * (lens / np.maximum(sf + ef, 1))).astype(int),
                  sf)
    ef = np.where(over, lens - sf, ef)
    starts = np.sort(rng.integers(0, span, count))
    out_n = int((starts + lens).max())
    meta = torch.from_numpy(np.stack([s0, lens, sf, ef, starts % 128,
                                      starts // 128]).astype(np.int32))
    nblk_g = gm.grain_blocks(int(lens.max()))
    offsets, entries = gm.grain_plan(starts // 128, nblk_g, out_n)
    envp = (torch.from_numpy(rng.uniform(0, 1, (count, nblk_g * 128))
                             .astype(np.float32)) if envelope else None)
    return meta, offsets, entries, out_n, envp


@pytest.mark.cuda
@pytest.mark.parametrize("count,width,span", [(1, 100, 10), (70, 300, 200),
                                              (3000, 4800, 1_440_000)])
@pytest.mark.parametrize("envelope", [False, True])
def test_grain_overlap_add_matches_plain(cuda_device, count, width, span,
                                         envelope):
    """Overlap from 1 to 64 grains (70 grains of up to 300 samples within
    500), an envelope plane, a 30 s plan."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, span + 2 * width)).astype(np.float32))
    meta, offsets, entries, out_n, envp = _plan(count, count, width,
                                                x.shape[1], span, envelope)
    want = gm.grain_overlap_add_ref(x, meta, offsets, entries, out_n, envp)
    gm.reset_launch_counts()
    got = gm.grain_overlap_add(x.to(cuda_device), meta, offsets, entries,
                               out_n, None if envp is None
                               else envp.to(cuda_device))
    torch.cuda.synchronize()
    assert gm.LAUNCHES["grain_overlap_add"] == 1
    assert torch.equal(got.cpu(), want)
    for _ in range(3):
        again = gm.grain_overlap_add(x.to(cuda_device), meta, offsets,
                                     entries, out_n, None if envp is None
                                     else envp.to(cuda_device))
        assert torch.equal(again, got)


@pytest.mark.cuda
def test_grain_overlap_add_of_a_stack(cuda_device):
    rng = np.random.default_rng(2)
    stack = torch.from_numpy(rng.standard_normal((33, 2, 700))
                             .astype(np.float32))
    starts = np.sort(rng.integers(0, 3000, 33))
    out_n = int(starts.max()) + 700
    meta = torch.from_numpy(np.stack([np.zeros(33), np.full(33, 700),
                                      np.zeros(33), np.zeros(33),
                                      starts % 128, starts // 128])
                            .astype(np.int32))
    offsets, entries = gm.grain_plan(starts // 128, gm.grain_blocks(700),
                                     out_n)
    want = gm.grain_overlap_add_ref(stack, meta, offsets, entries, out_n)
    got = gm.grain_overlap_add(stack.to(cuda_device), meta, offsets,
                               entries, out_n)
    assert torch.equal(got.cpu(), want)


def _rel(got, want):
    got, want = got.to_numpy(), want.to_numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.cuda
def test_synthesis_on_the_card_matches_the_cpu(cuda_device):
    """The synthesizers and the granular engine at 48 kHz on both devices;
    the noise's draws the same bits."""
    sweep = lambda t: 220.0 + 2000.0 * t  # noqa: E731
    for make in (
            lambda d: Audio.synthesize_waveform(waveforms.sine, 0.5, 440.0,
                                                SR, 16, device=d),
            lambda d: Audio.synthesize_waveform(waveforms.sine, 0.5, sweep,
                                                SR, 16, device=d),
            lambda d: Audio.synthesize_pink_noise(0.5, SR, seed=3,
                                                  device=d),
            lambda d: Audio.synthesize_spectrum(0.25, 300.0, seed=2,
                                                spectrum_size_power=16,
                                                sample_rate=SR, device=d)):
        assert _rel(make(cuda_device), make("cpu")) < TOL_PATH
    assert torch.equal(
        Audio.synthesize_white_noise(0.5, SR, 1, seed=4,
                                     device=cuda_device).data.cpu(),
        Audio.synthesize_white_noise(0.5, SR, 1, seed=4, device="cpu").data)
    x = np.random.default_rng(5).standard_normal((2, 96000)).astype(
        np.float32) * 0.3
    cpu = Audio.create_from_array(x, SR, device="cpu")
    card = Audio.create_from_array(x, SR, device=cuda_device)
    args = (2.0, 100.0, 0.01, lambda t: 0.2 + 0.3 * t, 0.1, 0.01)
    gm.reset_launch_counts()
    assert _rel(card.granulate(*args), cpu.granulate(*args)) == 0.0
    assert gm.LAUNCHES["grain_overlap_add"] == 1
    mod = lambda a, t: a.modify_volume(0.5 + 0.1 * t)  # noqa: E731
    src = card.cut(0.0, 0.25)
    assert _rel(src.texture(2.0, 20.0, 0.0, mod),
                cpu.cut(0.0, 0.25).texture(2.0, 20.0, 0.0, mod)) < TOL_PATH
    assert _rel(src.delay(0.5, 0.1, 0.5),
                cpu.cut(0.0, 0.25).delay(0.5, 0.1, 0.5)) < TOL_PATH


@pytest.mark.cuda
def test_wavetable_on_the_card_runs_the_scan(cuda_device):
    """The constructor's pitch path runs the 2 x 2 scan kernel (the FIR
    probe of filter_1pole_lowpass); the card's table and playback against
    the CPU's."""
    t = np.arange(int(2 * SR)) / SR
    x = (0.5 * np.sin(2 * np.pi * (110.0 + 30.0 * t) * t))[None].astype(
        np.float32)
    scan_kernels.reset_launch_counts()
    card = Wavetable(Audio.create_from_array(x, SR, device=cuda_device),
                     SnapMode.ZERO, PitchMode.LOCAL)
    assert scan_kernels.LAUNCHES["scan_affine2x2"] >= 1
    cpu = Wavetable(Audio.create_from_array(x, SR, device="cpu"),
                    SnapMode.ZERO, PitchMode.LOCAL)
    assert card.waveform_starts == cpu.waveform_starts
    args = (0.5, lambda t: 220.0 + 100.0 * t, lambda t: t, True, 0.001)
    assert _rel(card.synthesize(*args), cpu.synthesize(*args)) < TOL_PATH
