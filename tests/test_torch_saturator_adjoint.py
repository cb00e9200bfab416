"""The saturator multinotch's backward as a scan, on the CPU.

flan_tpu_torch's saturator backward (ops/sequential_kernels.py
saturator_backward_plain, the plain version of the card's maps kernel, the
k x k scan and the read-out kernel) against the step-by-step adjoint loop
(saturator_backward_ref), against a float64 run of that loop, and against
jax.grad through the JAX package's lax.scan (flan_tpu/audio/filters.py
_multinotch_saturator_scan, through the public filter_1pole_multinotch /
filter_2pole_multinotch with use_saturator=True), on the same inputs made
from a seed with numpy. Both cascades, orders 1 to 4, inv +1 and -1, swept
and constant parameters, whole and in chunks, and frames that drive
Newton's denominator into its |den| < 1e-6 guard.

    python -m pytest tests/test_torch_saturator_adjoint.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu_torch.ops import sequential_kernels

SR = 8000.0
N = 200             # frames of the loop cases
# leading zeros where feedback k = 1 / G^order: a guarded Newton step's
# adjoint doubles the cotangent of u (den = 1: gu - gr = 2 gu), 256 times a
# frame, so the gradients before these frames grow by 256^frames and two
# float32 implementations drift apart with them (2.7e-4 of the peak between
# the port and JAX at 10 frames, 2-pole order 1, CPU)
GUARD_FRAMES = 4
# the plain backward vs the float32 loop, times each gradient's peak (both
# float32: 2.0e-7 to 4.9e-7 read)
TOL_LOOP = 1e-5
# vs jax.grad, as tests/test_torch_grad.py holds the saturator's gradients:
# float32 Newton steps in two orders
TOL_JAX = 1e-4
# vs a float64 run of the loop: the plain backward's error (the largest
# over the gradients, each over its peak) at most this times the float32
# loop's own (0.60 to 1.67 read)
FLOAT64_RATIO = 2.0


def _planes(n, two_pole, order, swept, guard, dtype):
    """The planes as the filters build them (filters.py: g = tan(pi w /
    sr), the allpass gains, d), a cutoff swept 300 -> 3300 Hz a second or
    constant at 700 Hz, feedback swept or 0.6, damping 0.4, mix 0.5; with
    guard, feedback 1 / G^order over the first GUARD_FRAMES frames."""
    t = np.arange(n) / SR
    w = ((300.0 + 3000.0 * t) if swept else np.full(n, 700.0)).astype(
        np.float32)
    g = np.tan(np.float32(np.pi / SR) * w)
    k = ((0.3 + 2.0 * t) if swept else np.full(n, 0.6)).astype(np.float32)
    mix = np.full(n, 0.5, np.float32)
    if two_pole:
        R = np.full(n, 0.4, np.float32)
        d = (1.0 / (1.0 + 2.0 * R * g + g * g)).astype(np.float32)
        G = (d * (1.0 - 2.0 * R * g + g * g)).astype(np.float32)
        planes, at_g, at_k = [g, G, k, mix, R, d], 1, 2
    else:
        planes = [g, g / (1 + g), (g - 1) / (g + 1), k, mix]
        planes, at_g, at_k = [p.astype(np.float32) for p in planes], 2, 3
    if guard:
        gn = sequential_kernels.ipow(torch.from_numpy(planes[at_g]),
                                     order).numpy()
        planes[at_k][:GUARD_FRAMES] = 1.0 / gn[:GUARD_FRAMES]
    return [torch.from_numpy(p).to(dtype) for p in planes]


def _inputs(two_pole, order, guard):
    rng = np.random.default_rng(order + 10 * two_pole + 100 * guard)
    x = (rng.standard_normal((2, N)) * 2.0).astype(np.float32)
    if guard:
        x[:, :GUARD_FRAMES] = 0.0
    return x, rng.standard_normal((2, N)).astype(np.float32)


def _errors(got, want):
    """Each gradient's largest difference over its peak: the signal's, then
    each plane's per channel."""
    (gx, gp), (wx, wp) = got, want
    return [float((gx - wx).abs().max() / wx.abs().max())] + [
        float((gp[:, i] - wp[:, i]).abs().max() / wp[:, i].abs().max())
        for i in range(wp.shape[1])]


def chunk_bytes(frames, channels, nstates):
    """ADJOINT_CHUNK_BYTES for the backward's chunks of `frames` frames."""
    k = nstates + 1
    return frames * 4 * channels * (k * k + 2 * k)


# (two_pole, order, inv, swept, guard): orders 1 to 4 on each cascade,
# swept and constant, inv alternating; a guarded case on each cascade
LOOP_CASES = ([(two, o, -1.0 if (o + sw) % 2 else 1.0, bool(sw), False)
               for two in (False, True) for o in (1, 2, 3, 4)
               for sw in (0, 1)]
              + [(False, 2, 1.0, False, True), (True, 3, 1.0, True, True)])


@pytest.mark.parametrize("two_pole,order,inv,swept,guard", LOOP_CASES)
def test_plain_backward_matches_loop(monkeypatch, two_pole, order, inv,
                                     swept, guard):
    """The scan form (whole, and in chunks of 37 frames whose carries cross
    the borders) against the step-by-step loop on the float32 forward's
    states: each gradient within TOL_LOOP of its peak; against the float64
    loop on the float64 forward no further than FLOAT64_RATIO times the
    float32 loop."""
    x, gy = _inputs(two_pole, order, guard)
    ref = (sequential_kernels.saturator_2pole_ref if two_pole
           else sequential_kernels.saturator_1pole_ref)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        planes = _planes(N, two_pole, order, swept, guard, dtype)
        xt, gyt = (torch.from_numpy(a).to(dtype) for a in (x, gy))
        y, states = ref(xt, *planes, inv, order, keep_states=True)
        args = (gyt, xt, planes, y, states, inv, order, two_pole)
        loop = sequential_kernels.saturator_backward_ref(*args)
        whole = sequential_kernels.saturator_backward_plain(*args)
        with monkeypatch.context() as m:
            m.setattr(sequential_kernels, "ADJOINT_CHUNK_BYTES",
                      chunk_bytes(37, *states.shape[:2]))
            assert sequential_kernels.adjoint_chunk(*states.shape[:2]) == 37
            chunked = sequential_kernels.saturator_backward_plain(*args)
        runs[dtype] = (loop, whole, chunked)
        if guard:       # t = 0 there, so den = inv k G^order - 1
            gn = sequential_kernels.ipow(planes[1 if two_pole else 2], order)
            den = inv * planes[2 if two_pole else 3] * gn - 1.0
            assert bool((den[:GUARD_FRAMES].abs() < 1e-6).all())
    loop, whole, chunked = runs[torch.float32]
    truth = tuple(t.float() for t in runs[torch.float64][0])
    loop_err = max(_errors(loop, truth))
    for got in (whole, chunked):
        assert max(_errors(got, loop)) <= TOL_LOOP
        assert max(_errors(got, truth)) <= FLOAT64_RATIO * loop_err


def test_plain_backward_is_the_cpu_backward():
    """SaturatorMultinotch's backward on the CPU is the scan form: the same
    bits as saturator_backward_plain, its plane gradients summed over the
    channels; nothing launches a kernel."""
    x, gy = _inputs(True, 2, False)
    planes = [p.requires_grad_() for p in _planes(N, True, 2, True, False,
                                                  torch.float32)]
    xt = torch.from_numpy(x).requires_grad_()
    y = sequential_kernels.SaturatorMultinotch.apply(xt, -1.0, 2, True,
                                                     *planes)
    got = torch.autograd.grad(y, [xt] + planes, torch.from_numpy(gy))
    _, states = sequential_kernels.saturator_2pole_ref(
        xt.detach(), *(p.detach() for p in planes), -1.0, 2,
        keep_states=True)
    gx, gp = sequential_kernels.saturator_backward_plain(
        torch.from_numpy(gy), xt.detach(), [p.detach() for p in planes],
        y.detach(), states, -1.0, 2, True)
    assert torch.equal(got[0], gx)
    for i, g in enumerate(got[1:]):
        assert torch.equal(g, gp[:, i].sum(0))
    assert sequential_kernels.LAUNCHES == dict.fromkeys(
        sequential_kernels.LAUNCHES, 0)


# (method, order, invert, swept, guard) through the public filters, with
# respect to the signal, the cutoff and the feedback (0-d parameters)
JAX_CASES = {
    "1pole_o1_swept": ("filter_1pole_multinotch", 1, False, True, False),
    "1pole_o4_inv": ("filter_1pole_multinotch", 4, True, False, False),
    "2pole_o2_inv_swept": ("filter_2pole_multinotch", 2, True, True, False),
    "2pole_o3": ("filter_2pole_multinotch", 3, False, False, False),
    "1pole_o2_guard": ("filter_1pole_multinotch", 2, False, False, True),
    "2pole_o1_guard": ("filter_2pole_multinotch", 1, False, True, True),
}


def _guard_feedback(method, order, cut):
    """The feedback 1 / G^order of the cutoff at frame 0 in float32 (a
    constant cutoff; a swept one starts there), which puts Newton's
    denominator within 1e-6 of 0 while the signal is 0."""
    g = np.tan(np.float32(np.pi / SR) * np.float32(cut))
    if method == "filter_2pole_multinotch":
        d = np.float32(1.0) / (1 + 2 * np.float32(0.4) * g + g * g)
        G = d * (1 - 2 * np.float32(0.4) * g + g * g)
    else:
        G = (g - 1) / (g + 1)
    return float(np.float32(1.0) / np.float32(G) ** order)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_plain_backward_matches_jax_grad(case):
    """Gradients through the port's saturator on the CPU (the scan form)
    against jax.grad through the JAX package's, with respect to the signal
    (TOL_JAX of its peak), the cutoff and the feedback (TOL_JAX of each):
    400 frames; a swept cutoff c (1 + 10 t) or a constant one; the guarded
    cases hold the feedback at 1 / G^order over the signal's leading
    zeros, then at 0.5."""
    method, order, invert, swept, guard = JAX_CASES[case]
    n = 400
    rng = np.random.default_rng(len(case))
    x = (rng.standard_normal((2, n)) * 2.0).astype(np.float32)
    cut0 = 600.0
    fb0 = _guard_feedback(method, order, cut0) if guard else 0.7
    if guard:
        x[:, :GUARD_FRAMES] = 0.0
    t0 = GUARD_FRAMES / SR

    def args(cut, fb):
        cutoff = (lambda t: cut * (1.0 + 10.0 * t)) if swept else cut
        feedback = ((lambda t: 0.5 + (fb - 0.5) * (t < t0)) if guard
                    else fb)
        if method == "filter_2pole_multinotch":
            return (order, cutoff, 0.4, feedback, invert, 0.5, True)
        return (order, cutoff, feedback, invert, 0.5, True)

    def jloss(v, cut, fb):
        a = flan_tpu.Audio.create_from_array(v, SR)
        return jnp.sum(getattr(a, method)(*args(cut, fb)).data ** 2)

    want = [np.array(w) for w in jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.float32(cut0), jnp.float32(fb0))]
    v = torch.from_numpy(x).requires_grad_()
    cut = torch.tensor(cut0, requires_grad=True)
    fb = torch.tensor(fb0, requires_grad=True)
    a = flan_tpu_torch.Audio.create_from_array(v, SR)
    y = getattr(a, method)(*args(cut, fb)).data
    got = [g.numpy() for g in torch.autograd.grad((y ** 2).sum(),
                                                  (v, cut, fb))]
    assert np.abs(got[0] - want[0]).max() <= TOL_JAX * np.abs(want[0]).max()
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= TOL_JAX * abs(float(w)), (g, w)
