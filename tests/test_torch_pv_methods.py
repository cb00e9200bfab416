"""flan_tpu_torch's PV class surface against flan_tpu on the CPU: the two
frequency gathers, the frame utilities, repitch and modify_frequency, the
.flan codec both ways, FunctionSample, and the compiled-reference goldens
of tests/test_algo_golden.py (algo_modfreq_const, algo_modfreq_var,
algo_repitch15, algo_getframe, algo_cutf, algo_pvjoin) with its helpers
and tolerances.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
from flan_tpu.func import function_sample as j_fs
from flan_tpu.func import interpolators as jinterp
from flan_tpu.io import flan_format as j_flan
from flan_tpu.ops import pv_modify as jmod
from flan_tpu.pv.pv import PV as JPV
from flan_tpu_torch import Audio, PV, PVFormat
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.func import function_sample as t_fs
from flan_tpu_torch.func import interpolators as tinterp
from flan_tpu_torch.io import flan_format as t_flan
from flan_tpu_torch.ops import pv_modify as tmod

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

# the goldens' input PV (tests/test_algo_golden.py:39-64): C=2 F=24 B=17,
# sr 8000, hop 8 (analysis rate 1000), window 32, bin width 250 Hz
C, F, B = 2, 24, 17
SR, HOP, WIN = 8000.0, 8, 32


def _planes(name):
    dims = tuple(int(x) for x in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    mag = np.fromfile(os.path.join(FIXDIR, name + "_mag.f32"),
                      dtype="<f4").reshape(dims)
    freq = np.fromfile(os.path.join(FIXDIR, name + "_freq.f32"),
                       dtype="<f4").reshape(dims)
    return mag, freq


def input_planes(seed=0):
    """The C++ generator's input PV (gen_algo_fixtures.cpp make_input_pv;
    seed 997 is its amp_source operand)."""
    i = np.arange(C * F * B, dtype=np.uint64)
    h = ((i + np.uint64(seed)) * np.uint64(2654435761)).astype(np.uint32)
    h2 = ((i + np.uint64(seed + 131))
          * np.uint64(2246822519)).astype(np.uint32)
    m = (h % np.uint32(1000)).astype(np.float32) / np.float32(1000.0)
    jit = (h2 % np.uint32(2001)).astype(np.float32) / np.float32(1000.0) \
        - np.float32(1.0)
    b = (i % np.uint64(B)).astype(np.float32)
    fr = (b + np.float32(0.45) * jit) * np.float32(250.0)
    return m.reshape(C, F, B), fr.reshape(C, F, B)


def input_pvs(seed=0, planes=None):
    """(port PV on the CPU, JAX PV) on the same planes."""
    m, f = input_planes(seed) if planes is None else planes
    return (pv_from_numpy(m, f, SR, HOP, WIN, device="cpu"),
            JPV(mag=jnp.asarray(m), freq=jnp.asarray(f), sample_rate=SR,
                hop_size=HOP, window_size=WIN))


def assert_golden(ours, name, mag_tol=1e-4, freq_tol=1e-2, mag_floor=1e-5):
    """tests/test_algo_golden.py's _assert_planes_close on a port PV."""
    ref_m, ref_f = _planes(name)
    got_m, got_f = ours.to_numpy()
    assert got_m.shape == ref_m.shape, (
        f"{name}: shape {got_m.shape} != reference {ref_m.shape}")
    np.testing.assert_allclose(got_m, ref_m, rtol=mag_tol, atol=mag_tol,
                               err_msg=f"{name}: magnitude plane")
    live = ref_m > mag_floor
    np.testing.assert_allclose(got_f[live], ref_f[live], rtol=freq_tol,
                               atol=freq_tol * 250.0,
                               err_msg=f"{name}: frequency plane")


def assert_like_jax(ours, theirs, mag_atol=1e-6, freq_atol=1e-3):
    """Port PV against JAX PV: magnitudes to float32 rounding of values
    below 1000 (or as given), frequencies (below 5000 Hz) likewise."""
    got_m, got_f = ours.to_numpy()
    want_m, want_f = np.array(theirs.mag), np.array(theirs.freq)
    assert got_m.shape == want_m.shape
    np.testing.assert_allclose(got_m, want_m, rtol=1e-6, atol=mag_atol)
    np.testing.assert_allclose(got_f, want_f, rtol=1e-6, atol=freq_atol)


def test_input_pv_is_bit_reproducible():
    ref_m, ref_f = _planes("algo_in")
    m, f = input_pvs()[0].to_numpy()
    assert np.array_equal(m, ref_m) and np.array_equal(f, ref_f)


# ------------------------------------------------------- the two gathers

def _random_planes(seed, c=2, f=20, b=65, width=125.0):
    rng = np.random.default_rng(seed)
    mag = rng.random((c, f, b)).astype(np.float32)
    mag[:, 3:5, 10:20] = 0.0         # zero magnitudes never write
    freq = ((np.arange(b) + rng.uniform(-0.5, 0.5, (c, f, b)))
            * width).astype(np.float32)
    return mag, freq


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.5, 2.3])
def test_modify_frequency_gather_const_matches_jax(factor):
    """The host-planned constant gather: the same pairs, mixes and picks,
    so the same bits (the top bin never written, a write only where the
    picked magnitude is positive, the smaller weight winning)."""
    mag, freq = _random_planes(3)
    jm, jf = (np.array(a) for a in jmod.modify_frequency_gather_const(
        jnp.asarray(mag), jnp.asarray(freq), factor, 125.0))
    tm, tf = (a.numpy() for a in tmod.modify_frequency_gather_const(
        torch.from_numpy(mag), torch.from_numpy(freq), factor, 125.0))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tf, jf)
    assert (tm[..., -1] == 0).all()


@pytest.mark.parametrize("interp", ["linear", "smoothstep"])
def test_modify_frequency_gather_matches_jax(interp):
    """The general gather on a per-frame monotone bin map and a modified
    frequency plane given to both: the same bits."""
    mag, freq = _random_planes(4)
    rng = np.random.default_rng(8)
    bin_map = np.cumsum(rng.uniform(0.3, 2.0, (20, 65)), axis=1).astype(
        np.float32)
    jm, jf = (np.array(a) for a in jmod.modify_frequency_gather(
        jnp.asarray(mag), jnp.asarray(freq), jnp.asarray(bin_map),
        interp=getattr(jinterp, interp)))
    tm, tf = (a.numpy() for a in tmod.modify_frequency_gather(
        torch.from_numpy(mag), torch.from_numpy(freq),
        torch.from_numpy(bin_map), interp=getattr(tinterp, interp)))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tf, jf)


def test_repitch_with_jax_bin_map_is_bit_exact():
    """PV.repitch's pieces (map_through_bins, the gather) given the bin
    map JAX integrates in float32 give JAX's planes bit for bit; the port's
    own map is summed in float64 (integrate_bins), which rounds a few
    entries apart."""
    tp, jp = input_pvs()

    def fn(t, f):
        return 1.2 + 0.3 * t * 20.0
    t = jnp.arange(F, dtype=jnp.float32) * jnp.float32(1.0 / 1000.0)
    bins = jnp.arange(B, dtype=jnp.float32) * 250.0
    bin_map = np.array(jnp.cumsum(jnp.broadcast_to(
        fn(t[:, None], bins[None, :]), (F, B)), axis=1))
    want = jp.repitch(fn)
    bm = torch.from_numpy(bin_map)
    m, f = tmod.modify_frequency_gather(
        tp.mag, tmod.map_through_bins(tp.freq, bm, tp.bin_width), bm)
    np.testing.assert_array_equal(m.numpy(), np.array(want.mag))
    np.testing.assert_array_equal(f.numpy(), np.array(want.freq))
    sums = torch.broadcast_to(torch.as_tensor(
        np.array(fn(t[:, None], bins[None, :]))), (F, B))
    assert np.abs(tmod.integrate_bins(sums).numpy() - bin_map).max() \
        < 1e-4


# ---------------------------------------------------- the class methods

def test_modify_frequency_goldens_and_jax():
    tp, jp = input_pvs()
    for name, mod in (
            ("algo_modfreq_const", lambda t, f: f * 1.3),
            ("algo_modfreq_var",
             lambda t, f: f * (0.7 + ((0.09 * t) * 257.0) / 4.0))):
        ours = tp.modify_frequency(mod)
        assert_golden(ours, name)
        assert_like_jax(ours, jp.modify_frequency(mod))


@pytest.mark.parametrize("factor", ["callable", "constant"])
def test_repitch_golden_and_jax(factor):
    """A callable factor takes the general gather, a constant the
    host-planned one: both give the reference's planes."""
    tp, jp = input_pvs()
    f = (lambda t, fr: 1.5) if factor == "callable" else 1.5
    ours = tp.repitch(f)
    assert_golden(ours, "algo_repitch15")
    assert_like_jax(ours, jp.repitch(f))


def test_repitch_const_with_another_interp_takes_the_general_gather():
    tp, jp = input_pvs()
    ours = tp.repitch(1.5, interp=tinterp.smoothstep)
    assert_like_jax(ours, jp.repitch(1.5, interp=jinterp.smoothstep))


def test_get_frame_golden_and_jax():
    tp, jp = input_pvs()
    ours = tp.get_frame(0.0105)
    assert_golden(ours, "algo_getframe")
    assert_like_jax(ours, jp.get_frame(0.0105), mag_atol=0, freq_atol=0)
    assert tp.get_frame(1.0).num_frames == 1    # clamped to the last frame


def test_cut_frames_and_join_goldens():
    tp, jp = input_pvs()
    assert_golden(tp.cut_frames(5, 17), "algo_cutf")
    joined = PV.join([tp.cut_frames(0, 10), tp.cut_frames(10, 24)])
    assert_golden(joined, "algo_pvjoin")
    assert_like_jax(joined, JPV.join([jp.cut_frames(0, 10),
                                      jp.cut_frames(10, 24)]), 0, 0)
    assert tp.cut_frames(5, 5).is_null()
    assert PV.join([PV.create_null()]).is_null()


def test_split_at_times_matches_jax():
    """Split frames truncate; a duplicate time gives a null piece; the
    last piece loses a frame to cut_frames' end clamp."""
    tp, jp = input_pvs()
    times = [0.0055, 0.012, 0.012, 0.030]
    ours, theirs = tp.split_at_times(times), jp.split_at_times(times)
    assert [p.num_frames for p in ours] == [p.num_frames for p in theirs] \
        == [5, 7, 0, 11]
    for a, b in zip(ours, theirs):
        if not b.is_null():
            assert_like_jax(a, b, 0, 0)


def test_constructors_copy_and_sampling_match_jax():
    tp, jp = input_pvs()
    fmt = PVFormat(2, 7, 17, SR, HOP, WIN)
    z = PV.create_from_format(fmt, device="cpu")
    assert z.mag.shape == (2, 7, 17) and not z.mag.any() and not z.freq.any()
    assert z.get_format() == fmt
    c = tp.copy()
    assert torch.equal(c.mag, tp.mag) and c.mag.data_ptr() != tp.mag.data_ptr()

    def fn(t, f):
        return t * 3.0 + f / 1000.0
    got = tp.sample_function_over_domain(fn)
    want = jp.sample_function_over_domain(fn)
    assert not got.is_constant
    np.testing.assert_array_equal(got.as_array().numpy(),
                                  np.array(want.as_array()))
    assert tp.sample_function_over_domain(2.0).is_constant
    got = tp.sample_function_over_time_domain(lambda t: 1.0 + t)
    want = jp.sample_function_over_time_domain(lambda t: 1.0 + t)
    np.testing.assert_array_equal(got.as_array().numpy(),
                                  np.array(want.as_array()))


def test_get_bin_interpolated_matches_jax():
    tp, jp = input_pvs()
    for args in ((0, 3.25, 7.5), (1, 10.0, 2.0), (1, 22.9, 15.1)):
        got = tp.get_bin_interpolated(*args)
        want = jp.get_bin_interpolated(*args)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mid_side_pv_round_trip_matches_jax():
    """Audio.convert_to_ms_PV and PV.convert_to_lr_audio; a null PV and a
    null audio for anything but two channels. Bound 5e-4 of the peak, as
    the stretch of tests/test_torch_slice.py (the JAX side's float32
    cycle sums)."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
    ours = Audio.create_from_array(x, SR, device="cpu").convert_to_ms_PV(
        256, 64, 256)
    theirs = flan_tpu.Audio.create_from_array(x, SR).convert_to_ms_PV(
        256, 64, 256)
    assert_like_jax(ours, theirs, mag_atol=1e-4, freq_atol=0.05)
    got = ours.convert_to_lr_audio().to_numpy()
    want = np.array(theirs.convert_to_lr_audio().data)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()
    mono = Audio.create_from_array(x[:1], SR, device="cpu")
    assert mono.convert_to_ms_PV().is_null()
    assert mono.convert_to_PV(256, 64, 256).convert_to_lr_audio().is_null()


# ------------------------------------------------------------ .flan files

def test_flan_files_cross_between_the_packages(tmp_path):
    """A file the port writes, flan_tpu reads, and the other way; both
    writers give the same bytes, and a read returns the 24-bit values."""
    m, f = input_planes()
    tp, jp = input_pvs()
    ours, theirs = tmp_path / "port.flan", tmp_path / "jax.flan"
    tp.save(str(ours))
    jp.save(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    from_port = JPV.load_from_file(str(ours))
    from_jax = PV.load_from_file(str(theirs), device="cpu")
    assert from_jax.device.type == "cpu"
    np.testing.assert_array_equal(from_jax.mag.numpy(),
                                  np.array(from_port.mag))
    np.testing.assert_array_equal(from_jax.freq.numpy(),
                                  np.array(from_port.freq))
    assert (from_jax.sample_rate, from_jax.hop_size, from_jax.window_size) \
        == (SR, HOP, WIN)
    # 24-bit quantisation of mag / dft and freq / sample rate
    assert np.abs(from_jax.mag.numpy() - m).max() <= 32 / 2 ** 23
    assert np.abs(from_jax.freq.numpy() - f).max() <= SR / 2 ** 23
    want = j_flan.read_flan(str(theirs))
    got = t_flan.read_flan(str(theirs))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)


def test_flan_reader_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.flan"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVEfmt ")
    with pytest.raises(ValueError, match="bad.flan"):
        PV.load_from_file(str(bad), device="cpu")
    tp, _ = input_pvs()
    good = tmp_path / "cut.flan"
    tp.save(str(good))
    good.write_bytes(good.read_bytes()[:-6])
    with pytest.raises(ValueError, match="data chunk"):
        PV.load_from_file(str(good), device="cpu")


def test_load_from_file_goes_to_the_card_unless_named(tmp_path):
    tp, _ = input_pvs()
    path = tmp_path / "x.flan"
    tp.save(str(path))
    if torch.cuda.is_available():
        assert PV.load_from_file(str(path)).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            PV.load_from_file(str(path))
        with pytest.raises((AssertionError, RuntimeError)):
            PV.create_from_format(PVFormat(1, 2, 3))


# --------------------------------------------------------- FunctionSample

def test_function_sample_matches_jax():
    vals = np.linspace(-1.0, 2.0, 9, dtype=np.float32)
    t, j = t_fs.FunctionSample(torch.from_numpy(vals), 9), \
        j_fs.FunctionSample(jnp.asarray(vals), 9)
    np.testing.assert_allclose(t.exclusive_scan(0.5).as_array().numpy(),
                               np.array(j.exclusive_scan(0.5).as_array()),
                               rtol=1e-6)
    assert t.accumulate() == pytest.approx(j.accumulate(), rel=1e-6)
    assert t.maximum(abs) == j.maximum(jnp.abs)
    np.testing.assert_array_equal(
        t.transform(lambda v: v * 2.0).as_array().numpy(),
        np.array(j.transform(lambda v: v * 2.0).as_array()))
    c = t_fs.FunctionSample(3.0, 4)
    assert c.is_constant and c.accumulate() == 12.0 and c[2] == 3.0
    assert c.transform(lambda v: v + 1.0).get_constant() == 4.0
    with pytest.raises(ValueError):
        t.exclusive_scan(op="mul")
    g = t_fs.FunctionSample2d(torch.arange(6.0).reshape(2, 3), 2, 3)
    assert g.at(1, 2) == 5.0 and g.maximum() == 5.0
    c2 = t_fs.FunctionSample2d(1.5, 2, 3)
    assert c2.as_array().shape == (2, 3) and c2.at(0, 0) == 1.5
