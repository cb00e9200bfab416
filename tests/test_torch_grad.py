"""Gradients through flan_tpu_torch against jax.grad of flan_tpu on the CPU.

The counterparts of tests/test_differentiable.py's filter, resampler,
compressor and resonate cases (:102, :134, :149, :164), with the port's
gradient held to the JAX package's on the same inputs, and the three scan
backwards (max-affine, 2 x 2, k x k: the adjoint recurrence run reversed)
held to jax.grad of flan_tpu/ops/scan.py. A parameter to differentiate in
is a 0-d tensor that requires grad, where the JAX package takes a traced
scalar. Inputs are made with numpy from a seed; every tolerance names the
reading it was set from (CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.ops import scan as jax_scan
from flan_tpu.ops.resample import resample as jax_resample
from flan_tpu_torch.ops import scan, sequential_kernels
from flan_tpu_torch.ops.resample import resample


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0


def _sine(seconds=0.5, freq=440.0):
    t = np.arange(int(seconds * SR), dtype=np.float32) / SR
    return (0.5 * np.sin(2 * np.pi * freq * t))[None].astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _grad_signal(x, jax_loss, torch_loss):
    want = np.array(jax.grad(jax_loss)(jnp.asarray(x)))
    v = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(torch_loss(v), (v,))
    return got.numpy(), want


# ------------------------------------------------ the scans' backwards

def _loss_weights(shape):
    return np.random.default_rng(99).uniform(0.5, 1.5, shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 700, 5000])
def test_max_affine_backward_matches_jax_grad(n):
    """MaxAffineRecurrence (a reversed linear scan with the winning branch
    as its switch) against jax.grad of the JAX scan's tree: 1.2e-7 of the
    largest gradient read at 5000 (CPU); bound 1e-5."""
    rng = np.random.default_rng(n)
    m = rng.standard_normal((2, n)).astype(np.float32)
    a = rng.uniform(0.5, 0.999, (1, n)).astype(np.float32)
    c = ((1 - a) * rng.standard_normal((2, n))).astype(np.float32)
    y0 = np.float32([[0.3], [2.5]])
    w = _loss_weights((2, n))

    def jloss(*v):
        y = jax_scan.max_affine_recurrence(*v[:3], y0=v[3])
        return jnp.sum(w * y * y)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (m, a, c, y0)))
    ts = [torch.from_numpy(v).requires_grad_() for v in (m, a, c, y0)]
    y = scan.max_affine_recurrence(*ts[:3], y0=ts[3])
    got = torch.autograd.grad((torch.from_numpy(w) * y * y).sum(), ts)
    for g, v in zip(got, want):
        assert g.shape == v.shape
        assert _rel(g.numpy(), v) < 1e-5


@pytest.mark.parametrize("n", [1, 700, 5000])
def test_affine2x2_backward_matches_jax_grad(n):
    """Affine2x2Recurrence (the 2 x 2 scan reversed on the transposed
    planes), the SVF's shared coefficient planes included, against jax.grad
    of matrix_affine_recurrence: up to 2.1e-7 read (CPU); bound 1e-5."""
    rng = np.random.default_rng(n + 1)
    A = rng.uniform(-0.6, 0.6, (1, n, 2, 2)).astype(np.float32)
    b = rng.standard_normal((2, n, 2)).astype(np.float32)
    y0 = rng.standard_normal((2, 2)).astype(np.float32)
    w = _loss_weights((2, n, 2))

    def jloss(A_, b_, y0_):
        y = jax_scan.matrix_affine_recurrence(
            jnp.broadcast_to(A_, (2, n, 2, 2)), b_, y0_)
        return jnp.sum(w * y * y)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(v) for v in (A, b, y0)))
    tA, tb, ty = (torch.from_numpy(v).requires_grad_() for v in (A, b, y0))
    s1, s2 = scan.affine2x2_recurrence(
        tA[..., 0, 0], tA[..., 0, 1], tA[..., 1, 0], tA[..., 1, 1],
        tb[..., 0], tb[..., 1], (ty[:, 0:1], ty[:, 1:2]))
    y = torch.stack([s1, s2], dim=-1)
    got = torch.autograd.grad((torch.from_numpy(w) * y * y).sum(),
                              (tA, tb, ty))
    for g, v in zip(got, want):
        assert _rel(g.numpy(), v) < 1e-5


@pytest.mark.parametrize("k", [1, 3, 4])
def test_kxk_backward_matches_jax_grad(k):
    """MatrixAffineRecurrence (the k x k scan reversed on the transposed
    maps) against jax.grad of matrix_affine_recurrence, A one map for both
    channels: up to 2.0e-7 read (CPU); bound 1e-5."""
    n = 600
    rng = np.random.default_rng(k)
    A = (rng.uniform(-1, 1, (n, k, k)) * 0.9 / k).astype(np.float32)
    b = rng.standard_normal((2, n, k)).astype(np.float32)
    y0 = rng.standard_normal((2, k)).astype(np.float32)
    w = _loss_weights((2, n, k))

    def jloss(A_, b_, y0_):
        y = jax_scan.matrix_affine_recurrence(
            jnp.broadcast_to(A_, (2, n, k, k)), b_, y0_)
        return jnp.sum(w * y * y)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(v) for v in (A, b, y0)))
    tA, tb, ty = (torch.from_numpy(v).requires_grad_() for v in (A, b, y0))
    y = scan.matrix_affine_recurrence(tA, tb, ty)
    got = torch.autograd.grad((torch.from_numpy(w) * y * y).sum(),
                              (tA, tb, ty))
    for g, v in zip(got, want):
        assert g.shape == v.shape
        assert _rel(g.numpy(), v) < 1e-5


# ------------------------ tests/test_differentiable.py's cases, held to JAX

def test_grad_through_iir_filter_scan():
    """d(energy)/d(signal) and d(energy)/d(cutoff) through the 2-pole
    lowpass (the 2 x 2 scan's backward), against jax.grad: 2.6e-7 and 0.0
    read (CPU); bound 1e-4. The cutoff's gradient is positive: a
    440 Hz tone's energy grows with the lowpass's cutoff."""
    x = _sine()
    got, want = _grad_signal(
        x, lambda v: jnp.sum(flan_tpu.Audio.create_from_array(v, SR)
                             .filter_2pole_lowpass(800.0, 0.7).data ** 2),
        lambda v: (flan_tpu_torch.Audio.create_from_array(v, SR)
                   .filter_2pole_lowpass(800.0, 0.7).data ** 2).sum())
    assert np.isfinite(got).all() and _rel(got, want) < 1e-4
    ja = flan_tpu.Audio.create_from_array(x, SR)
    want_c = float(jax.grad(lambda c: jnp.sum(
        ja.filter_2pole_lowpass(c, 0.7).data ** 2))(jnp.float32(800.0)))
    ta = flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu")
    c = torch.tensor(800.0, requires_grad=True)
    got_c, = torch.autograd.grad(
        (ta.filter_2pole_lowpass(c, 0.7).data ** 2).sum(), (c,))
    assert float(got_c) > 0
    assert abs(float(got_c) - want_c) < 1e-4 * abs(want_c)


def test_grad_through_polyphase_resampler():
    """The resampler is linear: its gradient at 2x is twice that at x (the
    JAX package's check, rtol 2e-4), and equals jax.grad's: 4.0e-7 read
    (CPU); bound 1e-5."""
    x = _sine()

    def tloss(v):
        return (resample(v, SR, 12000.0) ** 2).sum()

    got, want = _grad_signal(
        x, lambda v: jnp.sum(jax_resample(v, SR, 12000.0) ** 2), tloss)
    assert _rel(got, want) < 1e-5
    v = torch.from_numpy(2.0 * x).requires_grad_()
    g2, = torch.autograd.grad(tloss(v), (v,))
    np.testing.assert_allclose(g2.numpy(), 2 * got, rtol=2e-4, atol=1e-6)


def test_grad_through_compressor_max_affine_scan():
    """d(energy)/d(signal) through the compressor (the max-affine and
    linear scans' backwards) against jax.grad: 4.1e-7 read (CPU); bound
    1e-4."""
    got, want = _grad_signal(
        _sine(),
        lambda v: jnp.sum(flan_tpu.Audio.create_from_array(v, SR)
                          .compress(-20.0, ratio=4.0).data ** 2),
        lambda v: (flan_tpu_torch.Audio.create_from_array(v, SR)
                   .compress(-20.0, ratio=4.0).data ** 2).sum())
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert _rel(got, want) < 1e-4


def test_grad_in_algorithm_parameter_2d():
    """d(energy)/d(decay) through PV.resonate's max-affine scan, the decay
    a 0-d tensor taking Function2d's sampled path: the value equals the
    constant-parameter run's (the JAX package's check, 1e-5), the value
    JAX's to 4.1e-7 and the gradient jax.grad's to 3.6e-7 (read, CPU);
    bounds 1e-5 and 1e-4."""
    x = _sine()
    jpv = flan_tpu.Audio.create_from_array(x, SR).convert_to_PV(512, 64, 512)
    val_w, g_w = jax.value_and_grad(
        lambda d: jnp.sum(jpv.resonate(0.1, d).mag ** 2))(jnp.float32(0.05))
    tpv = flan_tpu_torch.Audio.create_from_array(
        x, SR, device="cpu").convert_to_PV(512, 64, 512)
    d = torch.tensor(0.05, requires_grad=True)
    val = (tpv.resonate(0.1, d).mag ** 2).sum()
    g, = torch.autograd.grad(val, (d,))
    const = float((tpv.resonate(0.1, 0.05).mag ** 2).sum())
    value = float(val.detach())
    assert abs(value - const) <= 1e-5 * max(abs(const), 1.0)
    assert abs(value - float(val_w)) <= 1e-5 * abs(float(val_w))
    assert np.isfinite(float(g))
    assert abs(float(g) - float(g_w)) < 1e-4 * abs(float(g_w))


def test_grad_through_multinotch_kxk_scan():
    """d(energy)/d(signal) and d(energy)/d(feedback) through a swept
    1-pole multinotch of order 3 (the k x k scan's backward, k = 3)
    against jax.grad: 2.1e-7 and 1.4e-7 read (CPU); bound
    1e-4."""
    x = _sine(0.25)

    def jrun(v, fb):
        return flan_tpu.Audio.create_from_array(v, SR).filter_1pole_multinotch(
            3, lambda t: 300.0 + 3000.0 * t, fb).data

    def trun(v, fb):
        return flan_tpu_torch.Audio.create_from_array(
            v, SR, device="cpu").filter_1pole_multinotch(
                3, lambda t: 300.0 + 3000.0 * t, fb).data

    got, want = _grad_signal(x, lambda v: jnp.sum(jrun(v, 0.5) ** 2),
                             lambda v: (trun(v, 0.5) ** 2).sum())
    assert _rel(got, want) < 1e-4
    want_f = float(jax.grad(lambda f: jnp.sum(jrun(jnp.asarray(x), f) ** 2))(
        jnp.float32(0.5)))
    fb = torch.tensor(0.5, requires_grad=True)
    got_f, = torch.autograd.grad((trun(torch.from_numpy(x), fb) ** 2).sum(),
                                 (fb,))
    assert abs(float(got_f) - want_f) < 1e-4 * abs(want_f)


def test_grad_through_swept_comb_on_the_cpu():
    """The swept comb's adjoint (CombSwept: its plain loop in reverse time
    on the CPU, the backward kernel on the card) against jax.grad of the
    JAX package's lax.scan, 1.8e-7 read (CPU); bound 1e-5."""
    got, want = _grad_signal(
        _sine(0.1),
        lambda v: jnp.sum(flan_tpu.Audio.create_from_array(v, SR).filter_comb(
            lambda t: 300.0 + 5000.0 * t, 0.6).data ** 2),
        lambda v: (flan_tpu_torch.Audio.create_from_array(v, SR).filter_comb(
            lambda t: 300.0 + 5000.0 * t, 0.6).data ** 2).sum())
    assert _rel(got, want) < 1e-5


def test_grad_through_swept_comb_parameters():
    """d(energy)/d(feedback) and d(energy)/d(wet_dry), each a 0-d tensor,
    through the swept comb (CombSwept: du/dk = f u[n - d], dy/da = u -
    f u[n - d], summed over frames and channels) against jax.grad: bound
    1e-5 of each."""
    x = np.concatenate([_sine(0.1), _sine(0.1, 660.0)])

    def jrun(fb, mix):
        return jnp.sum(flan_tpu.Audio.create_from_array(x, SR).filter_comb(
            lambda t: 300.0 + 5000.0 * t, fb, mix, True).data ** 2)

    want = [float(g) for g in jax.grad(jrun, argnums=(0, 1))(
        jnp.float32(0.6), jnp.float32(0.4))]
    fb = torch.tensor(0.6, requires_grad=True)
    mix = torch.tensor(0.4, requires_grad=True)
    y = flan_tpu_torch.Audio.create_from_array(
        x, SR, device="cpu").filter_comb(
            lambda t: 300.0 + 5000.0 * t, fb, mix, True).data
    got = [float(g) for g in torch.autograd.grad((y ** 2).sum(), (fb, mix))]
    for g, w in zip(got, want):
        assert abs(g - w) < 1e-5 * abs(w), (got, want)


# the saturator multinotch: the signal's, the cutoff's and the feedback's
# gradients through SaturatorMultinotch (its adjoint in reverse time:
# Newton's 8 steps, the cascade, the feedback sum) against jax.grad
# through the JAX package's lax.scan, 0.04 s; bound 1e-4 of each (float32
# Newton steps in two orders)
SATURATOR_GRAD = {
    "1pole_o2": ("filter_1pole_multinotch", 2, False),
    "1pole_o3_inv": ("filter_1pole_multinotch", 3, True),
    "2pole_o2_inv": ("filter_2pole_multinotch", 2, True),
    "2pole_o1": ("filter_2pole_multinotch", 1, False),
}


@pytest.mark.parametrize("case", sorted(SATURATOR_GRAD))
def test_grad_through_saturator_matches_jax_grad(case):
    method, order, invert = SATURATOR_GRAD[case]
    x = np.concatenate([_sine(0.04), _sine(0.04, 1300.0)]) * 3.0

    def args(cut, fb):
        cutoff = (lambda t: cut * (1.0 + 10.0 * t))
        if method == "filter_2pole_multinotch":
            return (order, cutoff, 0.4, fb, invert, 0.5, True)
        return (order, cutoff, fb, invert, 0.5, True)

    def jloss(v, cut, fb):
        a = flan_tpu.Audio.create_from_array(v, SR)
        return jnp.sum(getattr(a, method)(*args(cut, fb)).data ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.float32(600.0), jnp.float32(0.7))
    v = torch.from_numpy(x).requires_grad_()
    cut = torch.tensor(600.0, requires_grad=True)
    fb = torch.tensor(0.7, requires_grad=True)
    a = flan_tpu_torch.Audio.create_from_array(v, SR)
    y = getattr(a, method)(*args(cut, fb)).data
    got = torch.autograd.grad((y ** 2).sum(), (v, cut, fb))
    assert _rel(got[0].numpy(), np.array(want[0])) < 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) < 1e-4 * abs(float(w)), (g, w)


def _float64_planes(n, two_pole, seed):
    rng = np.random.default_rng(seed)

    def plane(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, n)).requires_grad_()
    g, k, mix = plane(0.02, 0.6), plane(0.2, 0.9), plane(0.2, 0.8)
    if two_pole:
        R, d, G = plane(0.2, 0.8), plane(0.5, 0.9), plane(-0.5, 0.9)
        return [g, G, k, mix, R, d]
    return [g, plane(0.02, 0.4), plane(-0.95, -0.2), k, mix]


@pytest.mark.parametrize("case", ["sat1_o1", "sat1_o3_inv", "sat2_o1_inv",
                                  "sat2_o3", "comb"])
def test_sequential_backward_matches_autograd(case):
    """The hand-written adjoints that the autograd Functions run on the CPU
    (saturator_backward_plain, the saturator's adjoint as per-step maps on
    the k x k scan; comb_swept_backward_ref: what the backward kernels
    compute) against autograd through the plain forward loops, in float64
    on random planes: bound 1e-12 of each gradient's peak (9.3e-16 read,
    CPU)."""
    rng = np.random.default_rng(len(case))
    n = 80 if case != "comb" else 600
    x = torch.from_numpy(rng.standard_normal((2, n)) * 2.0).requires_grad_()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (2, n)))
    if case == "comb":
        d = torch.from_numpy(rng.integers(1, 40, n).astype(np.int32))
        d[200:232] = torch.arange(3, 35, dtype=torch.int32)  # rising: reads
        # of one sample by two steps of a round
        inputs = [x] + _float64_planes(n, False, 1)[3:]
        k, a = inputs[1:]

        def plain():
            return sequential_kernels.comb_swept_ref(x, d, k, a, -1.0)

        def adjoint():
            return sequential_kernels.CombSwept.apply(x, d, k, a, -1.0)
    else:
        two_pole = case.startswith("sat2")
        order, inv = int(case[6]), -1.0 if case.endswith("inv") else 1.0
        planes = _float64_planes(n, two_pole, 2)
        inputs = [x] + planes
        ref = (sequential_kernels.saturator_2pole_ref if two_pole
               else sequential_kernels.saturator_1pole_ref)

        def plain():
            return ref(x, *planes, inv, order)

        def adjoint():
            return sequential_kernels.SaturatorMultinotch.apply(
                x, inv, order, two_pole, *planes)
    y1 = plain()
    want = torch.autograd.grad((w * y1 * y1).sum(), inputs)
    y2 = adjoint()
    assert torch.equal(y1.detach(), y2.detach())
    got = torch.autograd.grad((w * y2 * y2).sum(), inputs)
    for g, v in zip(got, want):
        assert (g - v).abs().max() <= 1e-12 * v.abs().max()
