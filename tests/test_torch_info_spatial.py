"""flan_tpu_torch's DSP utilities (ops/dsp_utility.py), the information
methods (audio/information.py: YIN wavelengths and frequencies, the
envelopes) and the spatial methods (audio/spatial.py: pan, widen,
stereo_spatialize, filter_pinna) against flan_tpu on the CPU and against
the compiled reference's goldens (tests/test_dsp_reference_golden.py:
22-62, tests/test_algo_golden.py:435-502) at their floors. Inputs are made
with numpy from a seed at 8 kHz; every tolerance names the reading it was
set from (CPU).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.audio import spatial as jax_spatial
from flan_tpu.ops import dsp_utility as jax_dsp
from flan_tpu_torch.audio import spatial
from flan_tpu_torch.ops import dsp_utility


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

# sample paths against flan_tpu, times the peak: the same operations, the
# FFTs' and sinc taps' sums in other orders (up to 3e-6 read, the ILD's
# scan and the doppler gather); bound 1e-5
TOL = 1e-5
# d' against flan_tpu: two float32 orders of its cumulative sums (up to
# 2e-6 of d''s peak read); bound 1e-5
TOL_YIN = 1e-5


def _noise(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tones(n, seed=0, sr=SR):
    """A sum of two tones that glide, and a little noise: pitch to find."""
    t = np.arange(n) / sr
    f = 180.0 + 120.0 * t / t[-1]
    x = (0.6 * np.sin(2 * np.pi * np.cumsum(f) / sr)
         + 0.25 * np.sin(2 * np.pi * 3.0 * np.cumsum(f) / sr))
    return (x + 0.02 * np.random.default_rng(seed).standard_normal(n)
            ).astype(np.float32)[None]


def _audios(x, sr=SR):
    return (flan_tpu.Audio.create_from_array(x, sr),
            flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu"))


def _rel(got, want):
    got = got.to_numpy() if hasattr(got, "to_numpy") else np.asarray(got)
    want = np.array(want.data) if hasattr(want, "data") else np.array(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(name):
    return np.fromfile(os.path.join(FIXDIR, name), np.float32)


def _fixture(name):
    dims = tuple(int(v) for v in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return _f32(name + ".f32").reshape(dims)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    n = min(len(ref), len(got))
    err = float(((ref[:n] - got[:n]) ** 2).mean())
    return 10.0 * np.log10(max(float((ref[:n] ** 2).mean()), 1e-300)
                           / max(err, 1e-300))


def _golden_input():
    return flan_tpu_torch.Audio.create_from_array(_fixture("filt_sig"), SR,
                                                  device="cpu")


# --------------------------------------------------------------- dsp_utility

QUADS = [(0.5, 1.0, 0.25, 7), (1.0, 1.0, 0.999999, 3),
         (-2.0, 0.5, -1.0, 0), (0.1, 0.9, 0.85, 100), (3.0, 3.5, 3.25, 55)]


def test_parabolic_interpolation_golden():
    gold = _f32("dsp_parabolic.f32").reshape(-1, 2)
    for (y0, y1, y2, x1), (gx, gy) in zip(QUADS, gold):
        x, y = dsp_utility.parabolic_interpolation(
            np.float32(y0), np.float32(y1), np.float32(y2), x1)
        np.testing.assert_allclose(float(x), gx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(y), gy, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("interp", [False, True])
def test_peaks_and_valleys_golden(interp):
    bumpy = _f32("dsp_bumpy.f32")
    sfx = "_interp" if interp else "_raw"
    np.testing.assert_allclose(
        dsp_utility.find_peaks(bumpy, interpolate=interp),
        _f32("dsp_peaks" + sfx + ".f32").reshape(-1, 2), rtol=1e-5,
        atol=1e-4)
    np.testing.assert_allclose(
        dsp_utility.find_valleys(bumpy, interpolate=interp),
        _f32("dsp_valleys" + sfx + ".f32").reshape(-1, 2), rtol=1e-5,
        atol=1e-4)


def test_mean_and_sd_golden_and_peak_options():
    bumpy = _f32("dsp_bumpy.f32")
    np.testing.assert_allclose(dsp_utility.mean_and_sd(bumpy),
                               _f32("dsp_mean_sd.f32"), rtol=1e-5, atol=1e-6)
    assert dsp_utility.mean_and_sd([]) == (0.0, 0.0)
    for kw in (dict(max_peaks=3, amp_order=True), dict(max_peaks=2)):
        np.testing.assert_array_equal(dsp_utility.find_peaks(bumpy, **kw),
                                      jax_dsp.find_peaks(bumpy, **kw))


@pytest.mark.parametrize("window", [64, 256, 512])
def test_yin_and_wavelength_selection_match_flan_tpu(window):
    """d' within TOL_YIN of its peak; the selected wavelengths equal, or
    within 1e-3 where d''s float32 sums move a valley's vertex (none
    flipped at these inputs)."""
    x = _tones(6000, seed=window)[0]
    starts = np.arange(0, 6000 - window, window // 4)
    wins = np.stack([x[s:s + window] for s in starts])
    want = np.array(jax_dsp.yin_d_prime_batched(jnp.asarray(wins),
                                                window_size=window))
    got = dsp_utility.yin_d_prime_batched(torch.from_numpy(wins),
                                          window_size=window)
    assert _rel(got.numpy(), want) < TOL_YIN
    wl_want = np.array(jax_dsp.select_wavelength_batched(
        jnp.asarray(want), absolute_cutoff=0.2, minimum_wavelength=10))
    wl_got = dsp_utility.select_wavelength_batched(
        torch.from_numpy(want), absolute_cutoff=0.2,
        minimum_wavelength=10).numpy()
    np.testing.assert_allclose(wl_got, wl_want, rtol=0, atol=1e-4)
    wl_own = dsp_utility.select_wavelength_batched(got).numpy()
    np.testing.assert_allclose(wl_own, wl_want, rtol=1e-3)
    assert (wl_want > 0).any()


# --------------------------------------------------------------- information

def test_information_goldens():
    a = _golden_input()
    wl = a.get_local_wavelengths(0, 0, -1, 256, 64)
    ref = _f32("info_wavelengths.f32")
    assert wl.shape == ref.shape
    np.testing.assert_allclose(wl, ref, rtol=1e-3)
    t = np.arange(512, dtype=np.float32) / SR
    env = a.get_amplitude_envelope(0.02)(torch.from_numpy(t)).numpy()
    assert _snr_db(_f32("info_amp_env.f32"), env) >= 40.0


@pytest.mark.parametrize("window,hop", [(256, 64), (512, 128), (384, 100)])
def test_local_wavelengths_and_frequencies_match_flan_tpu(window, hop):
    ja, ta = _audios(_tones(7000, seed=hop))
    want = np.array(ja.get_local_wavelengths(0, 100, -1, window, hop))
    got = ta.get_local_wavelengths(0, 100, -1, window, hop)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(
        ta.get_local_frequencies(0, 0, 5000, window, hop),
        np.array(ja.get_local_frequencies(0, 0, 5000, window, hop)),
        rtol=1e-3)
    assert ta.get_local_wavelength(0, 777, window) == pytest.approx(
        ja.get_local_wavelength(0, 777, window), rel=1e-3)
    assert ta.get_local_frequency(0, 321, window) == pytest.approx(
        ja.get_local_frequency(0, 321, window), rel=1e-3)
    assert ta.get_average_wavelength(0, 0.0, -1.0, 0, -1, window,
                                     hop) == pytest.approx(
        ja.get_average_wavelength(0, 0.0, -1.0, 0, -1, window, hop),
        rel=1e-3)


def test_octave_flicker_fold_and_average_options():
    """The continuity fold halves a short octave-up run; the average's
    sigma and active-ratio gates; the same on both packages."""
    _, ta = _audios(_tones(2000))
    from flan_tpu_torch.audio.information import _fold_octave_flicker
    out = np.array([100.0, 100.0, 200.0, 200.0, 100.0, 100.0])
    _fold_octave_flicker(out, 3)
    assert out.tolist() == [100.0] * 6
    locals_ = np.array([0.0, 50.0, 52.0, 90.0], np.float32)
    assert ta.get_average_wavelength(locals_) == pytest.approx(64.0)
    assert ta.get_average_wavelength(locals_, 0.0, 5.0) == -1.0
    assert ta.get_average_wavelength(locals_, 1.0) == -1.0


@pytest.mark.parametrize("width", [0.01, 0.05])
def test_envelopes_match_flan_tpu(width):
    ja, ta = _audios(_tones(9000, seed=3) * np.linspace(0, 1, 9000,
                                                         dtype=np.float32))
    t = np.linspace(-0.1, 1.3, 1001).astype(np.float32)
    want = np.array(ja.get_amplitude_envelope(width)(jnp.asarray(t)))
    got = ta.get_amplitude_envelope(width)(torch.from_numpy(t)).numpy()
    assert _rel(got, want) < 1e-5       # the FFT convolution: 2e-7 read
    want = np.array(ja.get_frequency_envelope()(jnp.asarray(t)))
    got = ta.get_frequency_envelope()(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------------- spatial

@pytest.mark.parametrize("name,call,snr", [
    ("spat_pan_c", lambda a: a.pan(0.6), 80.0),
    ("spat_pan_v", lambda a: a.pan(lambda t: -1.0 + 31.25 * t), 80.0),
    ("spat_widen", lambda a: a.widen(0.7), 80.0),
    ("spat_spatialize", lambda a: a.convert_to_mono().stereo_spatialize(
        lambda t: (1.0 - 10.0 * t, 2.0)), 40.0),
])
def test_spatial_goldens(name, call, snr):
    ref = _fixture(name)
    got = call(_golden_input()).to_numpy()
    assert got.shape == ref.shape
    assert _snr_db(ref, got) >= snr


# the pinna's shelves sit at 3.5, 8 and 10 kHz: those run at 48 kHz (at
# 8 kHz they pass Nyquist, where the two packages' filters part)
CALLS = {
    "pan_mono": (1, lambda a: a.pan(-0.4)),
    "pan_swept": (2, lambda a: a.pan(lambda t: 0.9 - 4.0 * t)),
    "widen": (2, lambda a: a.widen(lambda t: 0.2 + t)),
    "pinna_constant": (1, lambda a: a.filter_pinna(0.7)),
    "pinna_swept": (2, lambda a: a.filter_pinna(lambda t: -2.0 + 8.0 * t)),
    "spatialize_still": (1, lambda a: a.stereo_spatialize((0.5, 1.5))),
    "spatialize_moving": (1, lambda a: a.stereo_spatialize(
        lambda t: (3.0 - 40.0 * t, 0.8 + t), 0.2)),
    "spatialize_limited": (1, lambda a: a.stereo_spatialize(
        lambda t: (60.0 * t, 1.0), 0.18, 30.0)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_spatial_methods_match_flan_tpu(name):
    channels, call = CALLS[name]
    ja, ta = _audios(_noise((channels, 2400), seed=len(name)),
                     48000.0 if name.startswith("pinna") else SR)
    assert _rel(call(ta), call(ja)) < TOL


def test_spatial_refusals_and_feed_plan():
    _, st = _audios(_noise((2, 100)))
    assert st.stereo_spatialize((0.0, 1.0)).is_null()
    _, tri = _audios(_noise((3, 100)))
    assert tri.pan(0.1).is_null()
    stretches = [1.0, 1.3, 0.5, 2.0, 1.0, 0.77]
    got = spatial._wdl_feed_plan(190, 32, stretches, 260)
    want = jax_spatial._wdl_feed_plan(190, 32, stretches, 260)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
