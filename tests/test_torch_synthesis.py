"""flan_tpu_torch's synthesis family and granular engine (audio/
synthesis.py, Audio.delay) against flan_tpu on the CPU: the noise draws
and synthesize_spectrum's phases exact (JAX's threefry bits), the
waveform and pulsar phases within the JAX package's own distance from an
exact scan, granulate, the modded texture, delay and texture_effect exact
(the same adds in the same order), the rest within a stated tolerance.
Inputs are made with numpy from seeds at 8 kHz, oversample <= 4, <= 1 s.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.audio import synthesis as j_synth
from flan_tpu.func.function import waveforms as j_waves
from flan_tpu_torch.audio import synthesis
from flan_tpu_torch.func.function import waveforms
from flan_tpu_torch.ops import cycle_scan, grain_mix, random

SR = 8000.0
J, T = flan_tpu.Audio, flan_tpu_torch.Audio

# against flan_tpu, times the peak; each bound beside its reading (CPU)
TOL_WAVE = 1e-5       # constant 440 Hz: 5.5e-7 read (the JAX tree's 1.3e-7
#                       cycles of phase, through sin and the resampler)
TOL_SWEEP = 2e-5      # 220 + 2000 t Hz: 2.8e-6 read (the tree's 1.5e-6)
TOL_PULSAR = 5e-5     # 4.9e-6 read (the phase above, times wf / pf)
TOL_FFT = 1e-5        # spectrum, texture, trainlets: 2.4e-7 - 3.9e-7 read
#                       (pocketfft against XLA's FFT, and the port's one
#                       transform against its overlap-save blocks)
TOL_SUM = 1e-6        # impulse: 2.2e-8 - 1.2e-7 read (the harmonic sum's
#                       order, torch's cos and pow against XLA's)
TOL_PSOLA = 1e-5      # 6.6e-8 - 1.3e-7 read (the pitch envelope's x = t
#                       sr / hop against the port's t (sr / hop), an ulp)


@pytest.fixture
def jax_scan_jit(monkeypatch):
    """The JAX package's mod-1 tree (synthesis.py:57, :539) run under jit:
    eagerly it dispatches op by op, ~10 s a call on the CPU; the same
    float32 operations either way."""
    orig = jax.lax.associative_scan
    scan = jax.jit(lambda x: orig(lambda a, b: jnp.mod(a + b, 1.0), x))
    monkeypatch.setattr(jax.lax, "associative_scan", lambda fn, x: scan(x))


def _rel(got, want):
    got = got.to_numpy() if hasattr(got, "to_numpy") else np.asarray(got)
    want = np.array(want.data)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _audios(x):
    return (J.create_from_array(x, SR),
            T.create_from_array(x, SR, device="cpu"))


def _tone(seconds=1.0):
    t = np.arange(int(seconds * SR)) / SR
    x = 0.5 * np.sin(2 * np.pi * 220 * t) * (1 + 0.2 * np.sin(
        2 * np.pi * 3 * t))
    return x[None].astype(np.float32)


def _noise(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("freq,tol", [(440.0, TOL_WAVE),
                                      (lambda t: 220.0 + 2000.0 * t,
                                       TOL_SWEEP)])
def test_synthesize_waveform(jax_scan_jit, freq, tol):
    want = J.synthesize_waveform(j_waves.sine, 0.5, freq, SR, 4)
    got = T.synthesize_waveform(waveforms.sine, 0.5, freq, SR, 4,
                                device="cpu")
    assert _rel(got, want) < tol


def test_synthesize_pulsars(jax_scan_jit):
    args = (0.25, lambda t: 50.0 + 100.0 * t)
    rest = (lambda t: 400.0 + 0.0 * t, lambda p: 1.0 - p, SR, 4)
    want = J.synthesize_pulsars(*args, j_waves.sine, *rest)
    got = T.synthesize_pulsars(*args, waveforms.sine, *rest, device="cpu")
    assert _rel(got, want) < TOL_PULSAR


def test_white_noise_draws_are_jaxs():
    """At oversample 1 the resample is a copy: the draws themselves,
    exact; at oversample 2 through the resampler."""
    for over, tol in ((1, 0.0), (2, 1e-6)):
        want = J.synthesize_white_noise(0.25, SR, over, seed=1)
        got = T.synthesize_white_noise(0.25, SR, over, seed=1, device="cpu")
        assert _rel(got, want) <= tol


def test_pink_noise_is_jaxs():
    """The same split chain, draws, repeats and adds in order, and the
    same normalisation: exact."""
    want = J.synthesize_pink_noise(0.5, SR, 16, seed=2)
    got = T.synthesize_pink_noise(0.5, SR, 16, seed=2, device="cpu")
    assert np.array_equal(got.to_numpy(), np.array(want.data))


def test_spectrum_phases_exact_and_output():
    kw = dict(fundamental_power=6, spectrum_size_power=12, sample_rate=SR,
              seed=3)
    _, theta = synthesis.spectrum_table(6, 12, seed=3, sample_rate=SR,
                                        device="cpu")
    want_theta = np.array(jax.random.uniform(
        jax.random.PRNGKey(3), (2 ** 11 + 1,), jnp.float32, 0.0,
        2.0 * math.pi))
    assert np.array_equal(theta.numpy(), want_theta)
    want = J.synthesize_spectrum(0.25, lambda t: 150.0 + 100.0 * t, **kw)
    got = T.synthesize_spectrum(0.25, lambda t: 150.0 + 100.0 * t,
                                device="cpu", **kw)
    assert _rel(got, want) < TOL_FFT


@pytest.mark.parametrize("args", [(100.0, 10, 1.0), (50.0, 2 ** 14, 0.9)])
def test_synthesize_impulse(args):
    want = J.synthesize_impulse(*args, SR)
    got = T.synthesize_impulse(*args, SR, device="cpu")
    assert _rel(got, want) < TOL_SUM


def test_integrate_event_rate_is_jaxs():
    for rate, scatter in ((10.0, 0.0), (lambda t: 5.0 + 20.0 * t, 0.02),
                          (7.0, lambda t: 0.01 + 0.0 * t)):
        want = j_synth.integrate_event_rate(1.0, rate, scatter, SR, seed=3)
        got = synthesis.integrate_event_rate(1.0, rate, scatter, SR, seed=3)
        assert np.array_equal(got, want)


def test_granulate_is_jaxs():
    """Fades, a moving selection, scatter: the planned render's adds in
    grain order, exact."""
    ja, ta = _audios(_noise((2, 8000)))
    args = (1.0, 40.0, 0.01, lambda t: 0.2 + 0.5 * t, 0.05, 0.01)
    got = ta.granulate(*args, seed=4)
    assert grain_mix.LAUNCHES["grain_overlap_add"] == 0
    assert _rel(got, ja.granulate(*args, seed=4)) == 0.0


def test_granulate_with_a_mod_is_jaxs():
    ja, ta = _audios(_noise((1, 4000), 1))
    args = (0.5, 20.0, 0.0, 0.3, 0.05, 0.01,
            lambda a, t: a.modify_volume(0.5))
    assert _rel(ta.granulate(*args, seed=4),
                ja.granulate(*args, seed=4)) == 0.0


@pytest.mark.parametrize("with_mod", [False, True])
def test_psola(with_mod):
    """The batched render under the hann plane, and the per-grain path of
    a mod (the JAX package reads the pitch one sample at a time: short)."""
    ja, ta = _audios(_tone(0.5))
    if with_mod:
        mod = lambda a, t: a.modify_volume(0.5)  # noqa: E731
        args = (0.1, 0.2, mod)
    else:
        args = (0.1, lambda t: 0.1 + 0.5 * t)
    assert _rel(ta.psola(*args, seed=1), ja.psola(*args, seed=1)) \
        < TOL_PSOLA


@pytest.mark.parametrize("form", ["plain", "mod", "feedback"])
def test_texture(form):
    """Without a mod (one FFT convolution: TOL_FFT), with a mod (K3 in
    grain order: exact) and with feedback (the sequential mix: exact)."""
    ja, ta = _audios(_noise((2, 800), 2))
    if form == "plain":
        assert _rel(ta.texture(0.5, 20.0, 0.0, seed=1),
                    ja.texture(0.5, 20.0, 0.0, seed=1)) < TOL_FFT
    elif form == "mod":
        mod = lambda a, t: a.modify_volume(0.5 + t)  # noqa: E731
        assert _rel(ta.texture(0.5, 20.0, 0.01, mod, seed=1),
                    ja.texture(0.5, 20.0, 0.01, mod, seed=1)) == 0.0
    else:
        mod = lambda a, t: a.modify_volume(0.9)  # noqa: E731
        assert _rel(ta.texture(0.5, 20.0, 0.0, mod, True, seed=1),
                    ja.texture(0.5, 20.0, 0.0, mod, True, seed=1)) == 0.0


def test_texture_mod_grains_of_two_shapes_raise():
    _, ta = _audios(_noise((1, 400), 3))
    with pytest.raises(ValueError, match="one shape"):
        ta.texture(0.5, 20.0, 0.0, lambda a, t: a.cut(0.0, 0.01 + t))


def test_delay_is_jaxs():
    ja, ta = _audios(_noise((2, 800), 2))
    assert _rel(ta.delay(0.3, 0.05, 0.6), ja.delay(0.3, 0.05, 0.6)) == 0.0
    dt = lambda t: 0.03 + 0.05 * t  # noqa: E731
    mod = lambda a, t: a.modify_volume(0.8)  # noqa: E731
    assert _rel(ta.delay(0.2, dt, lambda t: 0.7 - 0.2 * t, mod),
                ja.delay(0.2, dt, lambda t: 0.7 - 0.2 * t, mod)) == 0.0


def test_texture_effect_is_jaxs():
    ja, ta = _audios(_tone())
    mod = lambda a, t: a.modify_volume(0.5)  # noqa: E731
    assert _rel(ta.texture_effect(5.0, 0.0, 0.1, mod, seed=2),
                ja.texture_effect(5.0, 0.0, 0.1, mod, seed=2)) == 0.0


def test_synthesize_trainlets():
    kw = dict(num_harmonics=64, chroma=0.8, impulse_harmonic_frequency=60.0,
              sample_rate=SR, seed=2)
    args = (0.25, 8.0, 0.0, (1.0, 0.5), lambda t: 1.0 - t, 150.0, 0.08)
    want = J.synthesize_trainlets(*args, **kw)
    got = T.synthesize_trainlets(*args, device="cpu", **kw)
    assert _rel(got, want) < TOL_FFT


def test_synthesizers_default_to_the_card():
    """No device named: the card, which this CPU-only torch refuses."""
    assert synthesis._device(None) == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            T.synthesize_white_noise(0.01, SR, 1)


def test_cpu_takes_the_plain_versions():
    assert random.LAUNCHES["threefry_uniform"] == 0
    assert cycle_scan.LAUNCHES["cycle_scan"] == 0
    assert grain_mix.LAUNCHES["grain_overlap_add"] == 0
