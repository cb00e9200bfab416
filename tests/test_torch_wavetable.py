"""flan_tpu_torch's Wavetable (wavetable.py) on the CPU: against the
compiled reference's goldens wt_wl, wt_meta, wt_fix_synth, wt_loc_synth,
wt_edit_synth, wt_jump_synth, wt_fn_synth and synth_wave as
tests/test_algo_golden.py:477 and :732-836 read them, at the same SNR
floors; and against flan_tpu: the same segmentation, a table within
float32 roundings of the JAX package's, and the JAX package's table
played by both (convert.wavetable_from_numpy).
"""
import os

import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu_torch import PitchMode, SnapMode, Wavetable
from flan_tpu_torch.convert import wavetable_from_numpy


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
SR = 8000.0

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(FIXDIR, "wt_src.dims")),
    reason="wavetable fixtures not generated")

# the JAX package's table played by both packages, times its peak: 3.9e-7
# read (the crossfade's products and the sinc taps: torch's cos and sinc
# against XLA's); bound 1e-5
TOL_PLAY = 1e-5
# the tables built by both, times their peak: the port's numpy is the JAX
# package's, on a pitch path within float32 roundings; bound 1e-5
TOL_TABLE = 1e-5


def _src():
    return np.fromfile(os.path.join(FIXDIR, "wt_src.f32"), dtype="<f4")


def _source():
    return flan_tpu_torch.Audio.create_from_array(_src()[None], SR,
                                                  device="cpu")


def _ref(name):
    return np.fromfile(os.path.join(FIXDIR, f"{name}.f32"), dtype="<f4")


def _snr(audio, name):
    got = audio.to_numpy().astype(np.float64).reshape(-1)
    ref = _ref(name).astype(np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = ((got - ref) ** 2).mean()
    return 10 * np.log10((ref ** 2).mean() / max(err, 1e-30))


def _dims(name):
    return open(os.path.join(FIXDIR, f"{name}.dims")).read().split()


def test_pitch_path_canary():
    """The pitch the constructor follows: wt_wl within 5e-3, the zero hops
    one for one, the truncated average within 1e-3."""
    lp = _source().filter_1pole_lowpass(4000.0, 2)
    wl = np.asarray(lp.get_local_wavelengths(0, 0, -1, 128, 128, 1.0, 32))
    ref = _ref("wt_wl")
    assert len(wl) == len(ref)
    np.testing.assert_allclose(wl, ref, atol=5e-3)
    np.testing.assert_array_equal(wl == 0.0, ref == 0.0)
    assert abs(lp.get_average_wavelength(wl, 0.2, 64.0)
               - float(_dims("wt_wl")[2])) < 1e-3


@pytest.mark.parametrize("case", ["fixed", "local", "edit", "jumps"])
def test_synthesis_goldens(case):
    if case in ("fixed", "jumps"):
        wt = Wavetable(_source(), SnapMode.NONE, PitchMode.NONE, 128, 0.3,
                       45)
    else:
        wt = Wavetable(_source(), SnapMode.ZERO, PitchMode.LOCAL, 128, 0.3,
                       256)
    if case == "fixed":
        assert wt.get_num_waveforms(0) == int(_dims("wt_meta")[0])
        out = wt.synthesize(0.25, lambda t: 220.0 + 100.0 * t,
                            lambda t: 0.9 * t, True, 0.001)
        name = "wt_fix_synth"
    elif case == "local":
        assert wt.get_num_waveforms(0) == int(_dims("wt_meta")[1])
        out = wt.synthesize(0.25, lambda t: 160.0 + 80.0 * t,
                            lambda t: 0.5 + 0.4 * t, False, 0.001)
        name = "wt_loc_synth"
    elif case == "edit":
        wt.add_fades_in_place(16)
        wt.remove_dc_in_place()
        wt.normalize_in_place()
        out = wt.synthesize(0.125, 200.0, lambda t: 2.0 * t, True, 0.001)
        name = "wt_edit_synth"
    else:
        wt.remove_jumps_in_place(12)
        out = wt.synthesize(0.125, 300.0, lambda t: 0.8 * t, True, 0.001)
        name = "wt_jump_synth"
    assert _snr(out, name) > 60.0


def test_functional_ctor_golden():
    def tri(p):
        m = p - torch.floor(p)
        return torch.where(m < 0.5, 4.0 * m - 1.0, 3.0 - 4.0 * m)
    wt = Wavetable.from_function(tri, 1, 128, device="cpu")
    out = wt.synthesize(0.02, lambda t: 2000.0 + 9000.0 * t, 0.0, True,
                        0.001)
    assert _snr(out, "wt_fn_synth") > 60.0


def test_synth_wave_golden():
    """synthesize_waveform's golden (tests/test_algo_golden.py:472-477)."""
    def tri(p):
        return torch.where(p < 0.5, 4.0 * p - 1.0, 3.0 - 4.0 * p)
    out = flan_tpu_torch.Audio.synthesize_waveform(tri, 0.064, 220.0, SR, 2,
                                                   device="cpu")
    ref = _ref("synth_wave").reshape(
        tuple(int(v) for v in _dims("synth_wave")))
    got = out.to_numpy()
    assert got.shape == ref.shape
    snr = 10 * np.log10((ref.astype(np.float64) ** 2).sum()
                        / max(((got - ref).astype(np.float64) ** 2).sum(),
                              1e-30))
    assert snr >= 40.0


def test_against_flan_tpu():
    """The same segmentation and table as the JAX package's, and its table
    played by both packages."""
    jwt = flan_tpu.Wavetable(flan_tpu.Audio.create_from_array(
        _src()[None], SR), flan_tpu.SnapMode.ZERO,
        flan_tpu.PitchMode.LOCAL, 128, 0.3, 256)
    twt = Wavetable(_source(), SnapMode.ZERO, PitchMode.LOCAL, 128, 0.3,
                    256)
    assert twt.waveform_starts == jwt.waveform_starts
    jtab = np.array(jwt.table)
    assert np.abs(twt.table.numpy() - jtab).max() <= TOL_TABLE * np.abs(
        jtab).max()
    shared = wavetable_from_numpy(jtab, jwt.waveform_starts, 128, SR, "cpu",
                                  num_source_frames=jwt.num_source_frames)
    args = (0.25, lambda t: 160.0 + 80.0 * t, lambda t: 0.5 + 0.4 * t,
            True, 0.001)
    want = np.array(jwt.synthesize(*args).data)
    got = shared.synthesize(*args).to_numpy()
    assert np.abs(got - want).max() <= TOL_PLAY * np.abs(want).max()
    assert shared.ratio_to_table_index(0.37) == jwt.ratio_to_table_index(
        0.37)


def test_wavetable_api():
    """The names of flan_tpu's Wavetable, the graph and bitmap pair
    included since graph/ came (ROADMAP A.15)."""
    want = {n for n in dir(flan_tpu.Wavetable) if not n.startswith("_")}
    have = {n for n in dir(Wavetable) if not n.startswith("_")}
    assert want - have == set()
    assert Wavetable().is_null()
    assert flan_tpu_torch.Wavetable is Wavetable
