"""flan_tpu_torch time remap, interpolators and Function layer against
flan_tpu on the CPU, plus the compiled-reference goldens of
tests/test_algo_golden.py:54-107 with the same helpers and tolerances.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.func import function as jfunction
from flan_tpu.func import interpolators as jinterp
from flan_tpu.ops import pv_modify as jmod
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.func import function as tfunction
from flan_tpu_torch.func import interpolators as tinterp
from flan_tpu_torch.ops import pv_modify as tmod


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

INTERPS = ["midpoint", "nearest", "floor", "ceil", "linear", "smoothstep",
           "smootherstep", "sine", "sine2", "sqrt"]


def _np(a):
    return np.array(a)


def _planes_in(seed=1, c=2, f=40, b=33):
    rng = np.random.default_rng(seed)
    mag = rng.random((c, f, b)).astype(np.float32)
    freq = (rng.random((c, f, b)) * 4000.0).astype(np.float32)
    mag[:, 10:13, :5] = 0.0     # zero pairs exercise the zero-abort quirk
    return mag, freq


def _gather_both(mag, freq, time_map, chunk_frames, interp="linear"):
    out_frames = int(np.ceil(time_map.max()))
    jm, jf = (_np(a) for a in jmod.modify_time_gather(
        jnp.asarray(mag), jnp.asarray(freq), jnp.asarray(time_map),
        out_frames=out_frames, interp=getattr(jinterp, interp)))
    tm, tf = (a.numpy() for a in tmod.modify_time_gather(
        torch.from_numpy(mag), torch.from_numpy(freq),
        torch.from_numpy(time_map), out_frames=out_frames,
        interp=getattr(tinterp, interp), chunk_frames=chunk_frames))
    return (jm, jf), (tm, tf)


@pytest.mark.parametrize("chunk_frames", [3, 8192])
def test_modify_time_gather_constant_map(chunk_frames):
    """A 2x map: every pair spans two output frames, so chunks of 3 frames
    split pair spans; the zeroed frames hit the zero-abort quirk."""
    mag, freq = _planes_in()
    time_map = np.cumsum(np.full((40, 1), 2.0, np.float32), axis=0)
    (jm, jf), (tm, tf) = _gather_both(mag, freq, time_map, chunk_frames)
    assert tm.shape == jm.shape == (2, 80, 33)
    # input frame i lands at 2(i+1); frames 10-12 are zero, so the spans
    # starting at them (outputs 22-27) abort whole, the one into frame 13
    # included, while the span out of frame 9 is written
    assert (tm[:, 22:28, :5] == 0.0).all()
    assert (tm[:, 20:22, :5] > 0).all() and (tm[:, 28:40, :5] > 0).all()
    np.testing.assert_array_equal(tm == 0.0, jm == 0.0)
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=1e-7)
    # the weighted frequency average: float32 rounding of values < 4000
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3)


@pytest.mark.parametrize("interp", ["linear", "smoothstep", "sine"])
def test_modify_time_gather_bin_dependent_map(interp):
    mag, freq = _planes_in(seed=2)
    rng = np.random.default_rng(9)
    time_map = (np.cumsum(1.0 + rng.random((40, 33)), axis=0)
                - 1.5).astype(np.float32)
    (jm, jf), (tm, tf) = _gather_both(mag, freq, time_map, 5, interp)
    assert tm.shape == jm.shape
    np.testing.assert_array_equal(tm == 0.0, jm == 0.0)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", INTERPS)
def test_interpolators_match_jax(name):
    x = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(getattr(tinterp, name)(torch.from_numpy(x)),
                               _np(getattr(jinterp, name)(x)), atol=1e-6)


def test_function_layer_matches_jax():
    fn = lambda t: 1.0 + 0.5 * t   # noqa: E731
    tf, jf = tfunction.as_function(fn), jfunction.as_function(fn)
    assert not tf.is_constant
    np.testing.assert_allclose(tf.sample(3, 20, 0.01),
                               _np(jf.sample(3, 20, 0.01)), rtol=1e-7)
    c = tfunction.as_function(2)
    assert c.is_constant and c.sample(0, 5, 0.1) == 2.0
    assert tfunction.as_function(c) is c

    fn2 = lambda t, f: t * (1.5 + (0.5 / 4000.0) * f)   # noqa: E731
    t2, j2 = tfunction.as_function2d(fn2), jfunction.as_function2d(fn2)
    got = t2.sample_grid(7, 1.0 / 1000.0, 5, 250.0)
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got, _np(j2.sample_grid(7, 1.0 / 1000.0, 5,
                                                       250.0)), rtol=1e-7)
    # a Function lifts to a Function2d of time only
    lifted = tfunction.as_function2d(tf)
    np.testing.assert_allclose(lifted.sample_grid(4, 0.5, 3, 1.0)[:, 0],
                               tf.sample(0, 4, 0.5))
    assert tfunction.as_function2d(3.0).sample_grid(2, 1, 2, 1) == 3.0


# ---- compiled-reference goldens (tests/test_algo_golden.py:54-107)

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


def _input_pv():
    i = np.arange(C * F * B, dtype=np.uint64)
    h = (i * np.uint64(2654435761)).astype(np.uint32)
    h2 = ((i + np.uint64(131)) * np.uint64(2246822519)).astype(np.uint32)
    m = (h % np.uint32(1000)).astype(np.float32) / np.float32(1000.0)
    jit = (h2 % np.uint32(2001)).astype(np.float32) / np.float32(1000.0) \
        - np.float32(1.0)
    b = (i % np.uint64(B)).astype(np.float32)
    fr = (b + np.float32(0.45) * jit) * np.float32(250.0)
    return pv_from_numpy(m.reshape(C, F, B), fr.reshape(C, F, B), SR, HOP,
                         WIN, device="cpu")


def _assert_planes_close(ours, name, mag_tol=1e-4, freq_tol=1e-2,
                         mag_floor=1e-5):
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


def test_input_pv_is_bit_reproducible():
    ref_m, ref_f = _planes("algo_in")
    m, f = _input_pv().to_numpy()
    assert np.array_equal(m, ref_m) and np.array_equal(f, ref_f)


def test_stretch_constant2_golden():
    _assert_planes_close(_input_pv().stretch(lambda t, f: 2.0),
                         "algo_stretch2")
    # a plain constant takes the [F, 1] map path to the same planes
    _assert_planes_close(_input_pv().stretch(2.0), "algo_stretch2")


def test_stretch_varying_golden():
    def factor(t, f):
        return 1.0 + ((0.5 * t) * 41.0) / 43.0
    _assert_planes_close(_input_pv().stretch(factor), "algo_stretch_var")


def test_modify_time_golden():
    def mod(t, f):
        return t * (1.5 + (0.5 / 4000.0) * f)
    _assert_planes_close(_input_pv().modify_time(mod), "algo_modtime")


def test_modify_time_rejects_a_constant():
    with pytest.raises(ValueError):
        _input_pv().modify_time(1.0)
