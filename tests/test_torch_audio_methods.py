"""flan_tpu_torch's Audio methods beyond the filters (audio/audio.py: the
channel conversions, energies, reverse, ring modulation, constructors,
Function conversions, the *_in_place names, play) and the buffer, SPV and
interpolator accessors against flan_tpu on the CPU, the goldens
temp_reverse and info_energy (tests/test_algo_golden.py:380, 496), and
the API parity of the Audio class. Inputs are made with numpy from a seed
at 8 kHz; every tolerance names the reading it was set from (CPU).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.core.audio_buffer import AudioFormat as JaxFormat
from flan_tpu.func import interpolators as jax_interp
from flan_tpu_torch.core.audio_buffer import AudioFormat
from flan_tpu_torch.func import interpolators

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

# sample paths against flan_tpu, times the peak (0 to 1.2e-7 read: the
# channel mean's and the energy sums' orders); bound 1e-5
TOL = 1e-5

# flan_tpu's public Audio names the port does not have yet, each waiting
# for a later module: the graph and bitmap methods and convert_to_spectrum
# for graph/ and spectrum.py (ROADMAP A.15)
WAITING = {
    "convert_to_graph", "save_to_bmp", "convert_to_spectrum_graph",
    "save_spectrum_to_bmp", "convert_to_spectrum",
}


def _noise(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _audios(x, sr=SR):
    return (flan_tpu.Audio.create_from_array(x, sr),
            flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu"))


def _rel(got, want):
    got = got.to_numpy() if hasattr(got, "to_numpy") else np.asarray(got)
    want = np.array(want.data) if hasattr(want, "data") else np.array(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fixture(name):
    dims = tuple(int(v) for v in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return np.fromfile(os.path.join(FIXDIR, name + ".f32"),
                       dtype="<f4").reshape(dims)


def test_audio_has_flan_tpus_public_names_but_the_waiting_ones():
    """Every public name of flan_tpu's Audio is on the port's, except the
    stated list that waits for A.15; none of those is there."""
    want = {n for n in dir(flan_tpu.Audio) if not n.startswith("_")}
    have = {n for n in dir(flan_tpu_torch.Audio) if not n.startswith("_")}
    assert want - have == WAITING


def test_golden_reverse_and_energy():
    a = flan_tpu_torch.Audio.create_from_array(_fixture("filt_sig"), SR,
                                               device="cpu")
    ref = _fixture("temp_reverse")
    assert np.array_equal(a.reverse().to_numpy(), ref)
    np.testing.assert_allclose(a.get_total_energy(),
                               np.fromfile(os.path.join(
                                   FIXDIR, "info_energy.f32"), "<f4"),
                               rtol=1e-4)


CHANNELS = [1, 2, 3]
CALLS = {
    "convert_to_mono": lambda a: a.convert_to_mono(),
    "reverse": lambda a: a.reverse(),
    "split_channels": lambda a: a.split_channels()[-1],
    "combine_channels": lambda a: type(a).combine_channels(
        [a, a.cut_frames(10, 700)]),
    "modify_volume_in_place": lambda a: a.modify_volume_in_place(
        lambda t: 1.0 - 3.0 * t),
    "set_volume_in_place": lambda a: a.set_volume_in_place(0.3),
    "fade_in_place": lambda a: a.fade_in_place(0.01, 0.02),
    "fade_frames_in_place": lambda a: a.fade_frames_in_place(30, 200),
}


@pytest.mark.parametrize("name", sorted(CALLS))
@pytest.mark.parametrize("channels", CHANNELS)
def test_audio_methods_match_flan_tpu(name, channels):
    ja, ta = _audios(_noise((channels, 1500), seed=channels))
    assert _rel(CALLS[name](ta), CALLS[name](ja)) < TOL


@pytest.mark.parametrize("channels", [1, 2])
def test_stereo_pan_and_mix_in_place_match_flan_tpu(channels):
    ja, ta = _audios(_noise((channels, 1200), seed=4))
    assert _rel(ta.convert_to_stereo(), ja.convert_to_stereo()) < TOL
    assert _rel(ta.pan_in_place(0.3), ja.pan_in_place(0.3)) < TOL
    jo, to = _audios(_noise((2, 700), seed=5))
    assert _rel(ta.mix_in_place(to, 0.02, 0.5),
                ja.mix_in_place(jo, 0.02, 0.5)) < TOL


def test_convert_to_stereo_refuses_three_channels():
    _, ta = _audios(_noise((3, 100)))
    with pytest.raises(ValueError):
        ta.convert_to_stereo()


@pytest.mark.parametrize("other_shape", [(1, 300), (2, 2000), (3, 50)])
def test_ring_modulate_matches_flan_tpu(other_shape):
    ja, ta = _audios(_noise((2, 1000), seed=6))
    jo, to = _audios(_noise(other_shape, seed=7))
    assert _rel(ta.ring_modulate(to), ja.ring_modulate(jo)) < TOL


def test_energies_and_peak_match_flan_tpu():
    ja, ta = _audios(_noise((2, 3000), seed=8))
    jb, tb = _audios(_noise((3, 2000), seed=9))
    np.testing.assert_allclose(ta.get_total_energy(),
                               np.array(ja.get_total_energy()), rtol=1e-6)
    np.testing.assert_allclose(ta.get_energy_difference(tb),
                               np.array(ja.get_energy_difference(jb)),
                               rtol=1e-6)
    for span in ((0.0, 0.0), (0.05, 0.2)):
        assert ta.get_max_sample_magnitude(*span) == pytest.approx(
            ja.get_max_sample_magnitude(*span), rel=0, abs=0)


def test_constructors_match_flan_tpu():
    buf = _noise(600, seed=10)
    J, T = flan_tpu.Audio, flan_tpu_torch.Audio
    assert _rel(T.create_from_buffer(buf, 3, SR, device="cpu"),
                J.create_from_buffer(buf, 3, SR)) == 0.0
    for got, want in (
            (T.create_from_format(AudioFormat(2, 77, SR), device="cpu"),
             J.create_from_format(JaxFormat(2, 77, SR))),
            (T.create_empty_with_length(0.0101, 2, SR, device="cpu"),
             J.create_empty_with_length(0.0101, 2, SR)),
            (T.create_empty_with_frames(5, 1, SR, device="cpu"),
             J.create_empty_with_frames(5, 1, SR))):
        assert got.data.shape == tuple(want.data.shape)
        assert got.sample_rate == want.sample_rate
        assert not got.data.any()


def test_function_conversions_match_flan_tpu():
    ja, ta = _audios(_noise((2, 800), seed=11))
    t = np.linspace(-0.01, 0.11, 517).astype(np.float32)
    want = np.array(ja.convert_to_function()(jnp.asarray(t)))
    got = ta.convert_to_function()(torch.from_numpy(t)).numpy()
    assert np.array_equal(got, want)
    gain = lambda t: 0.5 + 2.0 * t      # noqa: E731
    fs = ta.sample_function_over_domain(gain)
    assert np.array_equal(fs.as_array().numpy(), np.array(
        ja.sample_function_over_domain(gain).as_array()))
    assert ta.sample_function_over_domain(0.25).get_constant() == 0.25


def test_match_sample_rates_or_return_null():
    T = flan_tpu_torch.Audio
    a = T.create_from_array(_noise((1, 400)), 8000.0, device="cpu")
    b = T.create_from_array(_noise((1, 300)), 12000.0, device="cpu")
    assert T.match_sample_rates_or_return_null([a, a]) == []
    out = T.match_sample_rates_or_return_null([a, b])
    assert [o.sample_rate for o in out] == [12000.0, 12000.0]
    want = flan_tpu.Audio.create_from_array(_noise((1, 400)), 8000.0)
    assert _rel(out[0], want.resample(12000.0)) < 2e-6


def test_play_raises_as_flan_tpus():
    _, ta = _audios(_noise((1, 10)))
    with pytest.raises(NotImplementedError):
        ta.play()


def test_audio_accessors(capsys):
    ja, ta = _audios(_noise((2, 300), seed=12))
    assert ta.get_sample(1, 17) == ja.get_sample(1, 17)
    ta.print_summary()
    ja.print_summary()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def test_pv_accessors_match_flan_tpu(capsys):
    ja, ta = _audios(_noise((2, 2000), seed=13))
    jp, tp = (a.convert_to_PV(256, 64, 256) for a in (ja, ta))
    assert tp.get_MF(1, 5, 17) == pytest.approx(jp.get_MF(1, 5, 17),
                                                rel=1e-5)
    for window in ((0, 0, 0, 0), (3, 9, 10, 40)):
        assert tp.get_max_partial_magnitude(*window) == pytest.approx(
            jp.get_max_partial_magnitude(*window), rel=1e-5)
    assert tp.max_frequency == jp.max_frequency
    assert not tp.is_nan_or_inf()
    bad = tp.__class__(mag=tp.mag, freq=tp.freq.clone().fill_(np.nan),
                       sample_rate=SR, hop_size=64, window_size=256)
    assert bad.is_nan_or_inf()
    tp.print_summary()
    jp.print_summary()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def test_spv_bin_conversions_match_flan_tpu():
    ja, ta = _audios(_noise((1, 500), seed=14))
    js, ts = ja.convert_to_SPV(64), ta.convert_to_SPV(64)
    for b in (0, 3, 63):
        assert ts.bin_to_frequency(b) == js.bin_to_frequency(b)
    assert ts.frequency_to_bin(1234.5) == js.frequency_to_bin(1234.5)


@pytest.mark.parametrize("interp", ["linear", "sqrt", "smoothstep", "sine2"])
def test_interpolate_points_match_flan_tpu(interp):
    pts = [(0.0, 1.0), (0.3, -2.0), (0.35, 0.5), (1.2, 4.0)]
    t = np.linspace(-0.5, 1.6, 301).astype(np.float32)
    want = np.array(jax_interp.interpolate_points(
        pts, getattr(jax_interp, interp))(jnp.asarray(t)))
    got = interpolators.interpolate_points(
        pts, getattr(interpolators, interp))(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.array(jax_interp.interpolate_intervals(
        0.25, [1.0, 3.0, -1.0])(jnp.asarray(t)))
    got = interpolators.interpolate_intervals(
        0.25, [1.0, 3.0, -1.0])(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
