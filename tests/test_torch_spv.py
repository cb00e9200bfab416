"""flan_tpu_torch SPV transforms against flan_tpu on the CPU.

The plain versions (spv_forward_ref / spv_inverse_ref) are held against
the JAX scan path and against the Pallas kernels in interpret mode, with
the tolerances of tests/test_spv_pallas.py, and against the compiled
reference's sliding-DFT goldens at B=16 (tests/test_algo_golden.py:
153-190). Where the CUDA kernels round differently from the plain versions
(fixed-point cycles, a half-turn cosine, a hoisted scale, reciprocals),
PyTorch emulations of exactly that arithmetic are held against the plain
versions in float32 and float64. tests/test_torch_cuda.py holds the CUDA
kernels to the plain versions on the card.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.ops.spv_pallas import spv_forward_fused, spv_inverse_fused
from flan_tpu.spv.spv import (_spv_forward_scan, _spv_inverse_scan,
                              _twiddle_table_np)
from flan_tpu_torch.convert import audio_from_numpy, spv_from_numpy
from flan_tpu_torch.ops import spv_kernels

SR = 8000.0
NBINS = 128
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _np(a):
    return np.array(a)


def _signal(n=2000, ch=1):
    rng = np.random.default_rng(7)
    t = np.arange(n, dtype=np.float32) / SR
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 1187.0 * t + 0.3)
         + 0.01 * rng.standard_normal(n).astype(np.float32))
    x = np.stack([x, -0.5 * x])[:ch]
    return np.ascontiguousarray(x, dtype=np.float32)


@pytest.fixture(scope="module", params=[1, 2], ids=["mono", "stereo"])
def forward_case(request):
    x = _signal(ch=request.param)
    xj = jnp.asarray(x)
    scan = tuple(_np(a) for a in _spv_forward_scan(xj, nbins=NBINS,
                                                   sample_rate=SR))
    fused = tuple(_np(a) for a in spv_forward_fused(xj, nbins=NBINS,
                                                    sample_rate=SR))
    ours = tuple(a.numpy() for a in spv_kernels.spv_forward_ref(
        torch.from_numpy(x), NBINS, SR))
    return x, scan, fused, ours


@pytest.mark.parametrize("jax_path", ["scan", "fused"])
def test_forward_ref_matches_jax(forward_case, jax_path):
    x, scan, fused, (mag, freq) = forward_case
    want_m, want_f = scan if jax_path == "scan" else fused
    assert mag.shape == want_m.shape == (x.shape[0], x.shape[1], NBINS)
    scale = np.abs(want_m).max()
    assert np.abs(mag - want_m).max() < 1e-5 * scale
    # freq on live bins; near-dead bins are phase noise in every form
    live = want_m > 1e-3 * scale
    assert live.any()
    assert np.abs((freq - want_f)[live]).max() < 0.1


@pytest.mark.parametrize("jax_path", ["scan", "fused"])
def test_inverse_ref_matches_jax(forward_case, jax_path):
    _, (mag, freq), _, _ = forward_case
    inverse = _spv_inverse_scan if jax_path == "scan" else spv_inverse_fused
    want = _np(inverse(jnp.asarray(mag), jnp.asarray(freq), sample_rate=SR))
    got = spv_kernels.spv_inverse_ref(torch.from_numpy(mag),
                                      torch.from_numpy(freq), SR).numpy()
    assert got.shape == want.shape
    # same mod-1 accumulation; summation order differs only
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_ragged_length_and_short_chunks():
    """A length off every chunk and tile edge, with the plain version's
    chunk cut to 100 frames, still matches the JAX scan path."""
    x = _signal(n=1300, ch=2)
    mag_s, _ = (_np(a) for a in _spv_forward_scan(
        jnp.asarray(x), nbins=NBINS, sample_rate=SR, chunk=256))
    mag, _ = spv_kernels.spv_forward_ref(torch.from_numpy(x), NBINS, SR,
                                         chunk=100)
    scale = np.abs(mag_s).max()
    assert np.abs(mag.numpy() - mag_s).max() < 1e-5 * scale


def test_float64_plain_version_bounds_float32_drift():
    """The plain versions compute in their input's dtype; float64 is the
    reference the card check measures float32 drift against."""
    x = torch.from_numpy(_signal(n=1500))
    m32, f32 = spv_kernels.spv_forward_ref(x, NBINS, SR)
    m64, f64 = spv_kernels.spv_forward_ref(x.double(), NBINS, SR)
    assert m64.dtype == f64.dtype == torch.float64
    scale = m64.abs().max()
    assert (m32 - m64).abs().max() < 1e-5 * scale
    assert (f32 - f64)[m64 > 1e-2 * scale].abs().max() < 0.1
    y32 = spv_kernels.spv_inverse_ref(m32, f32, SR)
    y64 = spv_kernels.spv_inverse_ref(m64, f64, SR)
    assert y64.dtype == torch.float64
    assert (y32 - y64).abs().max() < 1e-4 * y64.abs().max()


@pytest.mark.parametrize("nbins", [16, 96, 128, 512])
def test_twiddle_table_is_bit_identical(nbins):
    ours = spv_kernels.twiddle_table_np(nbins)
    theirs = _twiddle_table_np(nbins)
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


# ---- compiled-reference goldens (tests/test_algo_golden.py:153-190)

def _planes(name):
    dims = tuple(int(x) for x in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    mag = np.fromfile(os.path.join(FIXDIR, name + "_mag.f32"),
                      dtype="<f4").reshape(dims)
    freq = np.fromfile(os.path.join(FIXDIR, name + "_freq.f32"),
                       dtype="<f4").reshape(dims)
    return mag, freq


def test_sdft_forward_golden():
    sig = np.fromfile(os.path.join(FIXDIR, "sdft_sig.f32"), dtype="<f4")
    got_m, got_f = audio_from_numpy(sig, SR, device="cpu").convert_to_SPV(16).to_numpy()
    ref_m, ref_f = _planes("sdft_fwd")
    assert got_m.shape == ref_m.shape
    np.testing.assert_allclose(got_m, ref_m, atol=2e-4)
    # the reference leaves +-sample_rate aliases unwrapped at analysis
    # rate == sample rate; the port wraps deliberately, as flan_tpu does
    live = ref_m > 1e-3
    d = got_f[live] - ref_f[live]
    d = d - SR * np.round(d / SR)
    np.testing.assert_allclose(d, 0.0, atol=2.0)


def test_sdft_inverse_golden():
    ref_m, ref_f = _planes("sdft_fwd")
    inv = spv_from_numpy(ref_m, ref_f, SR,
                         device="cpu").convert_to_audio().to_numpy()[0]
    ref_inv = np.fromfile(os.path.join(FIXDIR, "sdft_inv.f32"), dtype="<f4")
    assert inv.shape == ref_inv.shape
    np.testing.assert_allclose(inv, ref_inv, atol=2e-3)


# ---- the kernels' own roundings, emulated on the CPU

def _emulation_signal(n, sr):
    rng = np.random.default_rng(7)
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 1187.0 * t + 0.3)
         + 0.01 * rng.standard_normal(n).astype(np.float32))
    return torch.from_numpy(np.ascontiguousarray(x[None], dtype=np.float32))


# (sample rate, bins, frames): the short cases, then 30 s at 48 kHz, which
# shows what accumulates over 1.44 M frames
EMULATION_CASES = [(8000.0, b, n) for b in (16, 96, 128)
                   for n in (2000, 2049)] + [(48000.0, 16, 1_440_000)]


@pytest.fixture(scope="module", params=EMULATION_CASES,
                ids=lambda c: f"sr{int(c[0])}-B{c[1]}-N{c[2]}")
def emulation_case(request):
    sr, nbins, n = request.param
    x = _emulation_signal(n, sr)
    ref32 = spv_kernels.spv_forward_ref(x, nbins, sr)
    ref64 = spv_kernels.spv_forward_ref(x.double(), nbins, sr)
    return sr, nbins, n, x, ref32, ref64


def test_forward_emulation_matches_plain(emulation_case):
    """The forward kernel's cheaper roundings (hoisted stencil scale,
    reciprocal in atan2 and in the phase wrap) against the plain version.
    Readings: magnitude 1.7e-7 of the peak at B=96 (2B no power of two), 0
    elsewhere; frequency on live bins 1.2e-3 Hz at 8 kHz, 7.8e-3 Hz at 48
    kHz over 1.44 M frames; against float64 the emulation's magnitude error
    is 5.0e-7 where the plain version's is 4.5e-7, and the frequency RMS
    equal to three digits (76.2 Hz on the long case's weak bins)."""
    sr, nbins, n, x, (m32, f32), (m64, f64) = emulation_case
    mag, freq = spv_kernels.spv_forward_emulated(x, nbins, sr)
    scale = float(m64.abs().max())
    live = m64 > 1e-3 * scale
    assert float((mag - m32).abs().max()) < 1e-6 * scale
    assert float((freq - f32)[live].abs().max()) < (0.01 if n < 10000
                                                    else 0.05)
    err_e = float((mag.double() - m64).abs().max())
    err_p = float((m32.double() - m64).abs().max())
    assert err_e <= 1.25 * err_p + 1e-7 * scale

    def rms(a):
        return float((a.double() - f64)[live].pow(2).mean().sqrt())
    assert rms(freq) <= 1.1 * rms(f32) + 1e-4


def test_inverse_emulation_matches_plain(emulation_case):
    """The inverse kernel's fixed-point cycles and half-turn cosine against
    the plain version on the plain float32 planes. Readings, as shares of
    the output's peak: 3.4e-7 to 4.2e-7 from the float32 plain version and
    3.0e-7 to 4.9e-7 from the float64 one on the short cases; over 1.44 M
    frames 9.6e-6 from float32, which is the float32 version's own distance
    from float64 (9.3e-6): the emulation stays at 2.2e-6 from float64."""
    sr, nbins, n, _, (m32, f32), _ = emulation_case
    got = spv_kernels.spv_inverse_emulated(m32, f32, sr)
    y32 = spv_kernels.spv_inverse_ref(m32, f32, sr)
    y64 = spv_kernels.spv_inverse_ref(m32.double(), f32.double(), sr)
    assert got.dtype == torch.float32 and got.shape == y32.shape
    peak = float(y64.abs().max())
    err32 = float((got - y32).abs().max())
    err64 = float((got.double() - y64).abs().max())
    plain64 = float((y32.double() - y64).abs().max())
    short = n < 10000
    assert err32 < (2e-6 if short else 3e-5) * peak
    assert err64 < (2e-6 if short else 1e-5) * peak
    if not short:
        assert err64 < plain64


@pytest.mark.parametrize("freq,want", [
    (0.0, 0), (2000.0, 2 ** 30), (-2000.0, -2 ** 30),
    (8000.0, 0), (10000.0, 2 ** 30), (-6000.0, 2 ** 30),
    (4000.0, 2 ** 31 - 1),          # +0.5 saturates one unit short
    (-4000.0, -2 ** 31), (1.0, 536871), (8001.0, 536871)])
def test_cycle_increments_fixed_point(freq, want):
    """frac(freq / sr) * 2^32 as a signed 32-bit value, whole cycles
    dropped; 1 Hz at 8 kHz is 2^32 / 8000 = 536870.9."""
    got = spv_kernels.cycle_increments_fixed(torch.tensor([freq]), SR)
    # the float32 quotient 8001 / 8000 holds 2^-23 cycles: 512 units
    assert abs(int(got[0]) - want) <= (0 if freq != 8001.0 else 512)


def test_fixed_point_cycles_associate_exactly():
    """Any split of the frames gives the same cycles: the sum modulo 2^32
    of two halves' sums is the whole sum, which float32 mod-1 sums do not
    give."""
    rng = np.random.default_rng(3)
    freq = torch.from_numpy(rng.uniform(-4000.0, 12000.0, (1, 4096, 8))
                            .astype(np.float32))
    inc = spv_kernels.cycle_increments_fixed(freq, SR)
    whole = inc.sum(dim=1) & 0xFFFFFFFF
    halves = ((inc[:, :1000].sum(dim=1) & 0xFFFFFFFF)
              + (inc[:, 1000:].sum(dim=1) & 0xFFFFFFFF)) & 0xFFFFFFFF
    assert torch.equal(whole, halves)


# ---- dispatch and build, without a card

def test_cpu_tensors_take_the_plain_versions():
    spv_kernels.reset_launch_counts()
    x = torch.from_numpy(_signal(n=300))
    mag, freq = spv_kernels.spv_forward(x, 16, SR)
    out = spv_kernels.spv_inverse(mag, freq, SR)
    assert out.shape == (1, 300)
    assert spv_kernels.LAUNCHES == {"spv_forward": 0, "spv_inverse": 0}


def test_other_devices_raise():
    x = torch.zeros((1, 64), device="meta")
    with pytest.raises(ValueError):
        spv_kernels.spv_forward(x, 16, SR)
    with pytest.raises(ValueError):
        spv_kernels.spv_inverse(torch.zeros((1, 8, 4), device="meta"),
                                torch.zeros((1, 8, 4), device="meta"), SR)


def test_kernel_module_imports_without_nvcc():
    code = ("import flan_tpu_torch.ops.spv_kernels as k, sys; "
            "assert 'jax' not in sys.modules; "
            "print(k.TILE_FRAMES, k.MAX_BINS)")
    env = dict(os.environ, PATH="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["128", "2048"]

