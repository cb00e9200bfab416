"""flan_tpu_torch.ops.stft (and its helpers) against flan_tpu on the CPU.

One numpy input, made from a seed, goes through the JAX function and its
port; JAX runs on the CPU (conftest.py). The port is also held to the
compiled-reference goldens of tests/test_reference_golden.py with the same
tolerances.
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.core import types as jtypes
from flan_tpu.ops import fastmath as jfastmath
from flan_tpu.ops import stft as jstft
from flan_tpu.ops.windows import hann_window as jhann
from flan_tpu_torch.core import types as ttypes
from flan_tpu_torch.ops import fastmath as tfastmath
from flan_tpu_torch.ops import stft as tstft
from flan_tpu_torch.ops.windows import hann_window as thann


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
# (window, hop, dft) at sr 8000
CONFIGS = [(512, 64, 512), (256, 64, 512)]


def _np(a):
    """Copy a JAX result out: np.asarray can alias a buffer that JAX
    reuses once the array is collected."""
    return np.array(a)


def _signal(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return np.stack([
        0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n),
        0.3 * np.sin(2 * np.pi * 1000.0 * t + 0.2),
    ]).astype(np.float32)


def _f32(name, shape):
    return np.fromfile(os.path.join(FIXDIR, name), dtype="<f4").reshape(shape)


@pytest.mark.parametrize("n,hop", [(0, 64), (63, 64), (64, 64), (1037, 48),
                                   (28_800_000, 128)])
def test_num_hops(n, hop):
    assert tstft.num_hops(n, hop) == jstft.num_hops(n, hop)


@pytest.mark.parametrize("size", [1, 2, 256, 2048])
def test_hann_window_is_bit_identical(size):
    assert np.array_equal(thann(size).numpy(), _np(jhann(size)))


def test_types_helpers():
    db = np.array([-60.0, -6.0, 0.0, 12.0], np.float32)
    np.testing.assert_allclose(ttypes.decibel_to_amplitude(torch.from_numpy(db)),
                               _np(jtypes.decibel_to_amplitude(db)), rtol=1e-6)
    amp = np.array([1e-6, 1e-3, 0.5, 2.0], np.float32)
    np.testing.assert_allclose(ttypes.amplitude_to_decibel(torch.from_numpy(amp)),
                               _np(jtypes.amplitude_to_decibel(amp)),
                               rtol=1e-6)
    assert ttypes.decibel_to_amplitude(-6.0) == jtypes.decibel_to_amplitude(-6.0)
    for x in (0, 1, 3, 4, 1000, 4097):
        assert ttypes.power_of_2_container(x) == jtypes.power_of_2_container(x)


def test_fastmath_matches_jax():
    rng = np.random.default_rng(3)
    y = rng.standard_normal(4096).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:4], y[:4] = [0.0, -1.0, 1.0, -2.0], [1.0, 0.0, 0.0, -2.0]
    got = tfastmath.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    # same polynomial, same operation order: float32 rounding only
    np.testing.assert_allclose(got, _np(jfastmath.atan2(y, x)), atol=4e-7)
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=3e-7)
    u = (rng.random(4096) * 8 - 4).astype(np.float32)
    ts, tc = tfastmath.sincos_2pi(torch.from_numpy(u))
    js, jc = jfastmath.sincos_2pi(u)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-6)


def test_cumsum_mod1_frames_matches_jax():
    inc = np.random.default_rng(5).random((2, 700, 9)).astype(np.float32)
    want = _np(jstft.cumsum_mod1_frames(jnp.asarray(inc)))
    got = tstft.cumsum_mod1_frames(torch.from_numpy(inc)).numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    d = np.minimum(d, 1.0 - d)          # distance on the unit circle
    # JAX forms the 256-frame block prefix as a float32 matmul, the port
    # sums in float64: block sums reach ~128, whose float32 ulp is 7.6e-6,
    # so the JAX package is off by a few of those
    assert d.max() < 2e-4


@pytest.mark.parametrize("window,hop,dft", CONFIGS)
def test_pv_forward_matches_jax(window, hop, dft):
    x = _signal()
    kw = dict(window_size=window, hop=hop, dft_size=dft, sample_rate=SR,
              chunk_hops=16)
    jm, jf = (_np(a) for a in jstft.pv_forward(jnp.asarray(x), **kw))
    tm, tf = (a.numpy() for a in tstft.pv_forward(torch.from_numpy(x), **kw))
    assert tm.shape == jm.shape == (2, 4000 // hop + 1, dft // 2 + 1)
    peak = jm.max()
    # two float32 FFTs (pocketfft vs XLA's) agree to a few ulp of the peak
    assert np.abs(tm - jm).max() < 1e-6 * peak
    live = jm > 1e-2 * peak
    df = np.abs(tf - jf)[live]
    ar = SR / hop
    # a phase difference at exactly +-pi may wrap to either end
    assert np.minimum(df, np.abs(df - ar)).max() < 0.02
    assert np.median(df) < 1e-3


@pytest.mark.parametrize("window,hop,dft", CONFIGS)
def test_pv_inverse_matches_jax(window, hop, dft):
    x = _signal()
    mag, freq = (_np(a) for a in jstft.pv_forward(
        jnp.asarray(x), window_size=window, hop=hop, dft_size=dft,
        sample_rate=SR))
    kw = dict(window_size=window, hop=hop, sample_rate=SR, chunk_hops=16)
    want = _np(jstft.pv_inverse(jnp.asarray(mag), jnp.asarray(freq), **kw))
    got = tstft.pv_inverse(torch.from_numpy(mag), torch.from_numpy(freq),
                           **kw).numpy()
    assert got.shape == want.shape == (2, mag.shape[1] * hop)
    # the mod-1 cycle sums differ by up to ~1e-4 cycles (see
    # test_cumsum_mod1_frames_matches_jax), i.e. ~6e-4 rad of phase:
    # measured 1.06e-4 of the peak in both configurations, bound 1.9x that
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


# ---- compiled-reference goldens (tests/test_reference_golden.py:120-176)

SIG1 = dict(sr=8000.0, n=1600, window=256, hop=64, dft=512, c=1, f=26, b=257)
SIG2 = dict(sr=8000.0, n=1037, window=128, hop=48, dft=256, c=2, f=22, b=129)


@pytest.mark.parametrize("name,p", [("sig1", SIG1), ("sig2", SIG2)])
def test_forward_pv_matches_reference_golden(name, p):
    shape = (p["c"], p["f"], p["b"])
    sig = _f32(f"{name}.f32", (p["c"], p["n"]))
    ref_mag = _f32(f"fwd_{name}_mag.f32", shape)
    ref_freq = _f32(f"fwd_{name}_freq.f32", shape)
    mag, freq = (a.numpy() for a in tstft.pv_forward(
        torch.from_numpy(sig), window_size=p["window"], hop=p["hop"],
        dft_size=p["dft"], sample_rate=p["sr"]))
    assert mag.shape == shape, "num_hops floor quirk must match"
    peak = float(ref_mag.max())
    assert np.abs(mag - ref_mag).max() < 2e-3 * peak
    mask = ref_mag > 1e-2 * peak
    df = np.abs(freq - ref_freq)[mask]
    assert np.median(df) < 0.05
    ar = p["sr"] / p["hop"]
    assert np.minimum(df, np.abs(df - ar)).max() < 2.0
    assert int((df > 2.0).sum()) <= 2


def test_inverse_pv_matches_reference_golden():
    p = SIG1
    shape = (p["c"], p["f"], p["b"])
    ref_mag = _f32("fwd_sig1_mag.f32", shape)
    ref_freq = _f32("fwd_sig1_freq.f32", shape)
    ref_audio = _f32("inv_sig1.f32", (p["c"], p["f"] * p["hop"]))
    ours = tstft.pv_inverse(torch.from_numpy(ref_mag),
                            torch.from_numpy(ref_freq),
                            window_size=p["window"], hop=p["hop"],
                            sample_rate=p["sr"]).numpy()
    assert ours.shape == ref_audio.shape
    scale = float(np.abs(ref_audio).max())
    assert np.abs(ours - ref_audio).max() < 2e-4 * max(scale, 1e-9)
    assert np.abs(ours).max() > 0.1 * scale


def test_frame_signal_pads_outside_the_signal():
    x = torch.arange(1, 11, dtype=torch.float32)[None]      # [1, 10]
    fr = tstft._frame_signal(x, 0, 4, 3, 4)
    want = _np(jstft._frame_signal(jnp.asarray(x.numpy()), 0, 4, 3, 4))
    assert np.array_equal(fr.numpy(), want)
    assert math.isclose(float(fr.sum()), float(want.sum()))
