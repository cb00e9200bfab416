"""flan_tpu_torch's PV modify extras (pv/modify_extra.py: desample,
smear_time, time_extrapolate, stretch_spline, modify) against flan_tpu on
the CPU and against the compiled reference's goldens (tests/
test_algo_golden.py:131-138, 632-672, with its tolerances); the spline's
band solve against float64 dense solves of the same natural spline
(flan_tpu.pv.modify_extra._natural_spline_matrix) on irregular knots; and
modify over chunks of frames against one pass, bit for bit. Inputs are
the goldens' input PV and planes made with numpy from a seed.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.pv import modify_extra as j_extra
from flan_tpu.pv.pv import PV as JPV
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.ops import scan
from flan_tpu_torch.pv import modify_extra
from test_torch_pv_methods import (HOP, SR, WIN, assert_golden,
                                   input_pvs)


def _cos_dist_t(t):
    return 0.5 * (1.0 + torch.cos(torch.pi * t))


def _cos_dist_j(t):
    return 0.5 * (1.0 + jnp.cos(jnp.pi * t))


def _lin(t, f):
    return (t * 1.2 + 0.001, f * 0.8 + 50.0)


def _warp(t, f):
    t2 = t * (1.0 + 0.125 * t) + f * (0.25 / 4000.0) * t
    f2 = f * (0.9 - 0.25 * t) + 125.0
    return (t2, f2)


# name -> (method, port args, JAX args (None: the same), golden, tolerance
# against JAX: (magnitude, frequency Hz) absolute, each the reading on the
# CPU with room)
CASES = {
    # 0 read: the same float32 operations (the float64 accumulator crosses
    # the same integers here)
    "desample": ("desample", (lambda t, f: 0.4 + 10.0 * t,), None,
                 "algo_desample", (0.0, 0.0)),
    # 6.0e-8 / 4.9e-4 Hz read: XLA's and torch's cos of the distribution
    # table differ by an ulp
    "smear": ("smear_time", (lambda t, f: 0.004, 2, _cos_dist_t),
              (lambda t, f: 0.004, 2, _cos_dist_j), "algo_smear",
              (1e-6, 5e-3)),
    "smear2": ("smear_time", (lambda t, f: 0.005,
                              lambda t, f: 1.0 + torch.trunc(f / 1800.0),
                              _cos_dist_t),
               (lambda t, f: 0.005, lambda t, f: 1.0 + jnp.trunc(f / 1800.0),
                _cos_dist_j), "algo_smear2", (1e-6, 5e-3)),
    "extrap": ("time_extrapolate", (0.008, 0.016, 0.01), None, "algo_extrap",
               (0.0, 0.0)),
    # 2.4e-7 / 9.8e-4 Hz read: the band solve against the JAX package's
    # dense float32 product
    "spline": ("stretch_spline", (lambda t: 2.0 + 30.0 * t,), None,
               "algo_spline", (2e-6, 1e-2)),
    # 4.2e-7 (linear) and 4.9e-6 (warped) read: XLA's roundings in the
    # inverse bilinear solve; on the warp the port lies 2.2e-6 from the
    # compiled reference, JAX 3.5e-6
    "modify_lin": ("modify", (_lin,), None, "algo_modify_lin", (5e-6, 1e-2)),
    "modify_warp": ("modify", (_warp,), None, "algo_modify_warp",
                    (2e-5, 1e-2)),
}


def _run(name):
    method, targs, jargs, golden, tol = CASES[name]
    tp, jp = input_pvs()
    return (getattr(tp, method)(*targs),
            getattr(jp, method)(*(jargs or targs)), golden, tol)


def _assert_near_jax(ours, theirs, tol):
    got_m, got_f = ours.to_numpy()
    want_m, want_f = np.array(theirs.mag), np.array(theirs.freq)
    assert got_m.shape == want_m.shape
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=tol[0])
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=tol[1])


@pytest.mark.parametrize("name", list(CASES))
def test_method_matches_golden_and_jax(name):
    ours, theirs, golden, tol = _run(name)
    assert_golden(ours, golden)
    _assert_near_jax(ours, theirs, tol)


def _random_pv(seed, c=2, f=96, b=33, width=125.0):
    rng = np.random.default_rng(seed)
    mag = rng.random((c, f, b)).astype(np.float32)
    freq = ((np.arange(b) + rng.uniform(-0.45, 0.45, (c, f, b)))
            * width).astype(np.float32)
    return (pv_from_numpy(mag, freq, 8000.0, 32, 256, device="cpu"),
            JPV(mag=jnp.asarray(mag), freq=jnp.asarray(freq),
                sample_rate=8000.0, hop_size=32, window_size=256))


@pytest.mark.parametrize("ratio", [0.3, 0.77])
def test_desample_on_96_frames_matches_jax(ratio):
    """96 frames, per-bin ratios: the port's float64 accumulator and the
    JAX package's float32 one select the same frames here: the same
    bits."""
    tp, jp = _random_pv(3)
    rt = (lambda t, f: ratio + 0.2 * torch.sin(40.0 * t + f / 900.0))
    rj = (lambda t, f: ratio + 0.2 * jnp.sin(40.0 * t + f / 900.0))
    _assert_near_jax(tp.desample(rt), jp.desample(rj), (0.0, 0.0))


def test_desample_accumulator_is_float64():
    """Over 6,000 frames a constant ratio 0.1 selects the frames where a
    float64 host sum of the float32 ratio crosses an integer (a float32
    cumulative sum drifts across floor() there)."""
    f = 6000
    mag = np.ones((1, f, 3), np.float32)
    freq = np.full((1, f, 3), 100.0, np.float32)
    pv = pv_from_numpy(mag, freq, 8000.0, 32, 256, device="cpu")
    out = pv.desample(0.1).mag.numpy()[0, :, 0]
    acc = np.floor(1.0 + np.cumsum(np.full(f, np.float32(0.1), np.float64)))
    sel = np.concatenate([[True], np.diff(acc) >= 1.0])
    # a selected frame keeps its own magnitude (mix 0); the frames after
    # the last selected one are invalid (no right bracket)
    last = np.flatnonzero(sel)[-1]
    assert np.array_equal(out[:last] == 1.0, np.ones(last, bool))
    assert np.all(out[last:] == 0.0)
    f32 = np.floor(np.float32(1.0) + np.cumsum(np.full(f, np.float32(0.1),
                                                       np.float32)))
    assert not np.array_equal(np.diff(f32) >= 1.0, np.diff(acc) >= 1.0)
    # the selected frames themselves: where the bracket is the frame itself
    l_frame = np.maximum.accumulate(np.where(sel, np.arange(f), -1))
    assert np.array_equal(np.flatnonzero(l_frame == np.arange(f)),
                          np.flatnonzero(sel))


def test_smear_warns_and_clips_like_jax():
    """An explicit max_kernel below the derived half-width warns and clips,
    in both packages alike."""
    tp, jp = input_pvs()
    with pytest.warns(UserWarning, match="clipped to explicit max_kernel"):
        ours = tp.smear_time(0.02, 3, None, max_kernel=5)
    with pytest.warns(UserWarning):
        theirs = jp.smear_time(0.02, 3, None, max_kernel=5)
    _assert_near_jax(ours, theirs, (1e-6, 5e-3))


def test_smear_warns_past_4096_half_taps():
    """Smear sizes implying more than 4096 half-taps warn before the
    offsets' passes start (each a pass over the planes); raised here as
    an error, so none runs."""
    pv = pv_from_numpy(np.ones((1, 2, 1), np.float32),
                       np.full((1, 2, 1), 50.0, np.float32), 8000.0, 8, 32,
                       device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(UserWarning, match="4097-half-tap kernel"):
            pv.smear_time(4.097, 1)


@pytest.mark.parametrize("times", [(0.0, -1, 0.005), (0.004, 0.02, 0.003)])
def test_time_extrapolate_ends_match_jax(times):
    """An end of -1 (the last frame index one past the planes: JAX clamps
    the read) and a late anchor pair: the same bits as JAX."""
    tp, jp = input_pvs()
    _assert_near_jax(tp.time_extrapolate(*times), jp.time_extrapolate(*times),
                     (0.0, 0.0))


def test_time_extrapolate_null_cases():
    tp, _ = input_pvs()
    assert tp.time_extrapolate(0.01, 0.005, 0.01).is_null()
    assert tp.time_extrapolate(0.005, 0.01, 0.0).is_null()


# ------------------------------------------------------------ the band solve

def _spline_pv(exp, seed=5, b=9):
    """A PV of len(exp) frames, and its planes, float32."""
    rng = np.random.default_rng(seed)
    f = len(exp)
    mag = rng.random((2, f, b)).astype(np.float32)
    freq = (rng.random((2, f, b)) * 3000.0).astype(np.float32)
    return pv_from_numpy(mag, freq, SR, HOP, WIN, device="cpu"), mag, freq


def _dense64(exp, y):
    """The natural spline through y [C, F, B] on the knots of exp, by the
    JAX package's float64 dense matrix, [C, F_out, B] float64."""
    exp = np.maximum(np.asarray(exp, np.int64), 1)
    xs = modify_extra.spline_knots(exp)
    w = j_extra._natural_spline_matrix(xs, np.arange(int(xs[-1]),
                                                     dtype=np.float64))
    return np.einsum("tf,cfb->ctb", w, y.astype(np.float64))


# expansions: all 1 (the identity), irregular odd ones, a long irregular
# run, two frames
EXPANSIONS = {
    "ones": [1] * 12,
    "odd": [3, 1, 5, 7, 1, 1, 9, 3, 5, 1, 3],
    "irregular": list(np.random.default_rng(4).integers(1, 9, 200)),
    "two_frames": [3, 4],
}


@pytest.mark.parametrize("name", list(EXPANSIONS))
def test_band_solve_matches_float64_dense_spline(name):
    """The port's stretch_spline (two linear recurrences along frames, then
    each frame's cubic from its knots) against the float64 dense solve of
    the same system: within 2e-6 of each plane's peak (float32 rounding
    in the elimination and the cubic; 1.2e-7 to 4.8e-7 read). All-1
    expansions give the input frames themselves, bit for bit."""
    exp = np.asarray(EXPANSIONS[name], np.float64)
    pv, mag, freq = _spline_pv(exp)
    table = torch.tensor(exp, dtype=torch.float32)
    fn = (lambda t: table[torch.round(t * pv.analysis_rate).long()])
    out = pv.stretch_spline(fn)
    got_m, got_f = out.to_numpy()
    for got, y in ((got_m, mag), (got_f, freq)):
        want = _dense64(exp, y)
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 2e-6, err
    if name == "ones":
        np.testing.assert_array_equal(got_m, mag[:, :-1])
        np.testing.assert_array_equal(got_f, freq[:, :-1])


def test_band_solve_plan_solves_the_tridiagonal_system():
    """spline_band_plan's recurrences in float64 solve A m = B y of
    _natural_spline_matrix to float64 rounding."""
    exp = np.asarray(EXPANSIONS["irregular"], np.int64)
    xs = modify_extra.spline_knots(exp)
    y = np.random.default_rng(9).standard_normal(len(xs))
    alpha, p, q, beta = (v.astype(np.float64)
                         for v in modify_extra.spline_band_plan(xs))
    n = len(xs)
    d = np.diff(y)
    r = np.zeros(n)
    r[1:-1] = d[1:] * p[1:-1] - d[:-1] * q[1:-1]
    dp = np.zeros(n)
    for i in range(n):
        dp[i] = alpha[i] * (dp[i - 1] if i else 0.0) + r[i]
    m = np.zeros(n)
    for i in range(n - 1, -1, -1):
        m[i] = beta[i] * (m[i + 1] if i < n - 1 else 0.0) + dp[i]
    h = np.diff(xs)
    resid = (h[:-1] / 6 * m[:-2] + (h[:-1] + h[1:]) / 3 * m[1:-1]
             + h[1:] / 6 * m[2:] - (d[1:] / h[1:] - d[:-1] / h[:-1]))
    # the plan is float32: its pivots carry float32 rounding
    assert np.abs(resid).max() < 1e-5 * np.abs(y).max()
    assert m[0] == 0.0 and m[-1] == 0.0


def test_stretch_spline_runs_two_linear_recurrences_per_plane(monkeypatch):
    """stretch_spline builds no dense matrix: its solve is two calls of
    ops/scan.py linear_recurrence per plane (flan_scan kind 0 on the
    card), four a call."""
    calls = []
    real = scan.linear_recurrence

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)
    monkeypatch.setattr(modify_extra, "linear_recurrence", spy)
    tp, jp = input_pvs()
    ours = tp.stretch_spline(2.0)
    assert len(calls) == 4
    assert all(s == (2, 17, 24) for s in calls)
    _assert_near_jax(ours, jp.stretch_spline(2.0), (2e-6, 1e-2))


@pytest.mark.parametrize("exp", [1.0, 1.9])
def test_stretch_spline_short_and_null(exp):
    """One frame gives a null PV (no knot interval), as in JAX."""
    one = pv_from_numpy(np.ones((1, 1, 4), np.float32),
                        np.ones((1, 1, 4), np.float32), SR, HOP, WIN,
                        device="cpu")
    assert one.stretch_spline(exp).is_null()


# ------------------------------------------------------------------ modify

@pytest.mark.parametrize("chunk", [1, 2, 5, 23])
@pytest.mark.parametrize("mod", [_lin, _warp])
def test_modify_in_chunks_gives_the_bits_of_one_pass(monkeypatch, chunk,
                                                     mod):
    """Chunks of 1, 2, 5 and 23 frames of quads (23: all of them; 16 quads
    a frame here) against one chunk of every quad: a quad writes only near
    its own cells and max is order-free, so the bits are the same."""
    tp, _ = input_pvs()
    whole = tp.modify(mod)
    monkeypatch.setattr(modify_extra, "MODIFY_CHUNK_QUADS", 16 * chunk)
    part = tp.modify(mod)
    assert torch.equal(whole.mag, part.mag)
    assert torch.equal(whole.freq, part.freq)


def test_modify_on_a_random_pv_matches_jax_in_chunks(monkeypatch):
    """96 frames of random planes and a swept warp, in chunks of 7 frames,
    against JAX: 2.2e-5 read, bound 1e-4 of the magnitudes' peak (1). The
    inverse bilinear solve cancels here (qb's a0 b3 and X b3 nearly
    cancel on the warp's thin quads), so XLA's roundings of the same
    quads move the interpolation weights by ~1e-4 relative."""
    tp, jp = _random_pv(8)

    def mod(t, f):
        return (t * (0.9 + 2.0 * t) + f * 2e-5 * t,
                f * (1.1 - 3.0 * t) + 20.0)
    monkeypatch.setattr(modify_extra, "MODIFY_CHUNK_QUADS", 32 * 7)
    _assert_near_jax(tp.modify(mod), jp.modify(mod), (1e-4, 1e-2))


def test_modify_span_clip_warns_like_jax():
    """A max_quad_span below the derived span warns and clips alike."""
    tp, jp = input_pvs()
    with pytest.warns(UserWarning, match="clipped"):
        ours = tp.modify(_warp, max_quad_span=1)
    with pytest.warns(UserWarning):
        theirs = jp.modify(_warp, max_quad_span=1)
    _assert_near_jax(ours, theirs, (2e-5, 1e-2))


def test_modify_refuses_outputs_over_600_s():
    tp, jp = input_pvs()

    def far(t, f):
        return (t * 1e6, f)
    assert tp.modify(far).is_null() and jp.modify(far).is_null()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not tp.modify(_lin).is_null()
