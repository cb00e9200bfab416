"""Parallel recurrence solvers (counterpart of flan_tpu/ops/scan.py).

The reference's per-sample IIR loops (filters AudioFilter.cpp:61-186, the
compressor's peak detector AudioVolume.cpp:246-253) are first-order
recurrences y[n] = f_n(y[n-1]) whose maps compose associatively:

* linear y[n] = a[n] y[n-1] + b[n]
* the compressor's max-smoother y[n] = max(m[n], a[n] y[n-1] + c[n]),
  a >= 0
* state recurrences y[n] = A[n] y[n-1] + b[n]: the 2-pole SVF's 2 x 2
  (six planes, never stacked) and the multinotch filters' k x k

Each function broadcasts its operands as the JAX version does and
dispatches by device: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel (ops/scan_kernels.py, csrc/scan_kernels.cu) or the
call raises. The kernels scan the last axis; a scan along another axis
moves that axis last (one transposing copy in, one out).

Every recurrence is differentiable on both devices. Its backward is a
torch.autograd.Function whose adjoint g[n] = J[n+1]^T g[n+1] + gy[n] is
the same kind of recurrence run reversed (a linear one for the max-affine
map), so on the card the backward runs on the forward kernels too.
"""
from __future__ import annotations

import math

import torch

from flan_tpu_torch.ops.scan_kernels import (affine2x2_ref, affine_kxk_ref,
                                             linear_maps_ref, linear_ref,
                                             max_affine_ref, scan_affine2x2,
                                             scan_affine_kxk, scan_linear,
                                             scan_max_affine)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _compact(p: torch.Tensor, keep: int = 1) -> torch.Tensor:
    """The smallest tensor that p broadcasts from: size 1 along every
    leading axis (all but the last `keep`) on which p has stride 0. A plane
    shared by the rows stays one row through the backward's flips."""
    lead = p.ndim - keep
    idx = tuple(slice(0, 1) if i < lead and p.stride(i) == 0 else slice(None)
                for i in range(p.ndim))
    return p[idx]


def _next(p: torch.Tensor) -> torch.Tensor:
    """p[n+1] at n along the last axis, 0 past the end, flipped in time:
    a coefficient of the reversed adjoint recurrence."""
    return torch.nn.functional.pad(_compact(p)[..., 1:], (0, 1)).flip(-1)


def _prev(y: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """y[n-1] along the last axis, y0 at n = 0."""
    return torch.cat([torch.broadcast_to(y0, y.shape[:-1] + (1,)),
                      y[..., :-1]], dim=-1)


def _linear_rows(a, b, y0) -> torch.Tensor:
    """y = a y + b along the last axis from y0 ([..., 1]) on the tensors'
    device, without autograd."""
    return linear_ref(a, b, y0) if _on_cpu(b) else scan_linear(a, b, y0)


def _max_affine_rows(m, a, c, y0) -> torch.Tensor:
    return (max_affine_ref(m, a, c, y0) if _on_cpu(m)
            else scan_max_affine(m, a, c, y0))


def _affine2x2_rows(planes, y0s):
    if _on_cpu(planes[4]):
        return affine2x2_ref(*planes, *y0s)
    return scan_affine2x2(*planes, *y0s)


def _kxk_rows(A, b, y0) -> torch.Tensor:
    """y = A y + b for A [..., k, k, N], b [..., k, N], y0 [..., k, 1] of
    one leading shape (A may be a broadcast view of one A for every row),
    without autograd."""
    *lead, k, n = b.shape
    rows = math.prod(lead)
    a = _compact(A, keep=3)
    a = (a.reshape(1, k * k, n) if a.shape[:-3] == (1,) * len(lead)
         else torch.broadcast_to(A, tuple(lead) + (k, k, n)).reshape(
             rows, k * k, n)).contiguous()
    bb = b.reshape(rows, k, n).contiguous()
    s0 = y0.reshape(rows, k).contiguous()
    y = (affine_kxk_ref(a, bb, s0) if _on_cpu(b)
         else scan_affine_kxk(a, bb, s0))
    return y.reshape(b.shape)


class LinearRecurrence(torch.autograd.Function):
    """The linear scan with the backward of T1/T2's custom_vjp
    (pallas_scan_experiment.py:200-215): the adjoint g[n] = a[n+1] g[n+1]
    + gy[n] is the same recurrence reversed, run by _linear_rows; then
    da = g y[n-1], db = g and dy0 = g[0] a[0]. a and b have one shape
    [..., N] and y0 is [..., 1]; the callers' broadcasts reduce the
    gradients back to their inputs' shapes."""

    @staticmethod
    def forward(ctx, a, b, y0):
        y = _linear_rows(a, b, y0)
        ctx.save_for_backward(a, y, y0)
        return y

    @staticmethod
    def backward(ctx, gy):
        a, y, y0 = ctx.saved_tensors
        g = _linear_rows(_next(a), gy.flip(-1),
                         torch.zeros_like(y0)).flip(-1)
        return g * _prev(y, y0), g, g[..., :1] * a[..., :1]


class MaxAffineRecurrence(torch.autograd.Function):
    """The max-affine scan's backward. With s[n] = 1 where the affine
    branch a[n] y[n-1] + c[n] wins over m[n] and 0 where m[n] does, the
    adjoint g[n] = gy[n] + s[n+1] a[n+1] g[n+1] is a reversed *linear*
    recurrence (the linear kernel on the card); then dm = (1 - s) g,
    da = s g y[n-1], dc = s g and dy0 = s[0] a[0] g[0]. Where the two
    branches tie, s = 1/2: jnp.maximum, whose gradient the JAX package's
    scan takes, splits it so."""

    @staticmethod
    def forward(ctx, m, a, c, y0):
        y = _max_affine_rows(m, a, c, y0)
        ctx.save_for_backward(m, a, c, y, y0)
        return y

    @staticmethod
    def backward(ctx, gy):
        m, a, c, y, y0 = ctx.saved_tensors
        y_prev = _prev(y, y0)
        affine = a * y_prev + c
        s = (affine > m).to(gy.dtype) + 0.5 * (affine == m).to(gy.dtype)
        sa = s * a
        g = _linear_rows(_next(sa), gy.flip(-1),
                         torch.zeros_like(y0)).flip(-1)
        sg = s * g
        return (g - sg, sg * y_prev, sg, sg[..., :1] * a[..., :1])


class Affine2x2Recurrence(torch.autograd.Function):
    """The 2 x 2 scan's backward: the adjoint g[n] = A[n+1]^T g[n+1] +
    gy[n] is the 2 x 2 recurrence reversed on the transposed planes; then
    dA[n] = g[n] s[n-1]^T, db = g, dy0 = A[0]^T g[0]. Takes the six planes
    and two start states, all broadcast to one shape."""

    @staticmethod
    def forward(ctx, a11, a12, a21, a22, b1, b2, y01, y02):
        s1, s2 = _affine2x2_rows((a11, a12, a21, a22, b1, b2), (y01, y02))
        ctx.save_for_backward(a11, a12, a21, a22, s1, s2, y01, y02)
        return s1, s2

    @staticmethod
    def backward(ctx, g1y, g2y):
        a11, a12, a21, a22, s1, s2, y01, y02 = ctx.saved_tensors
        gys = [torch.zeros_like(s1) if g is None else g for g in (g1y, g2y)]
        shape = s1.shape
        transposed = tuple(torch.broadcast_to(_next(p), shape)
                           for p in (a11, a21, a12, a22))
        g1, g2 = (g.flip(-1) for g in _affine2x2_rows(
            transposed + (gys[0].flip(-1), gys[1].flip(-1)),
            (torch.zeros_like(y01), torch.zeros_like(y02))))
        p1, p2 = _prev(s1, y01), _prev(s2, y02)
        f = (slice(None),) * (len(shape) - 1) + (slice(0, 1),)
        return (g1 * p1, g1 * p2, g2 * p1, g2 * p2, g1, g2,
                a11[f] * g1[f] + a21[f] * g2[f],
                a12[f] * g1[f] + a22[f] * g2[f])


class MatrixAffineRecurrence(torch.autograd.Function):
    """The k x k scan's backward, as the 2 x 2 one's: g[n] = A[n+1]^T
    g[n+1] + gy[n] is the k x k recurrence reversed on the transposed maps
    (the same kernel on the card); then dA[n] = g[n] y[n-1]^T, db = g and
    dy0 = A[0]^T g[0]. A [..., k, k, N] (a broadcast view where one A
    serves every row: its gradient is summed over the rows by the
    broadcast's own backward), b [..., k, N], y0 [..., k, 1]."""

    @staticmethod
    def forward(ctx, A, b, y0):
        y = _kxk_rows(A, b, y0)
        ctx.save_for_backward(A, y, y0)
        return y

    @staticmethod
    def backward(ctx, gy):
        A, y, y0 = ctx.saved_tensors
        At = torch.broadcast_to(_next(_compact(A, keep=3).transpose(-3, -2)),
                                A.shape)
        g = _kxk_rows(At, gy.flip(-1), torch.zeros_like(y0)).flip(-1)
        y_prev = _prev(y, y0)
        dA = g[..., :, None, :] * y_prev[..., None, :, :]
        dy0 = (A[..., :1] * g[..., :, None, :1]).sum(dim=-3)
        return dA, g, dy0


def _operands(first, *rest, axis: int):
    """The operands as tensors of first's dtype and device, broadcast to one
    shape (views) with the scan axis last, and that shape."""
    first = torch.as_tensor(first)
    ts = (first,) + tuple(torch.as_tensor(t, dtype=first.dtype,
                                          device=first.device) for t in rest)
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return tuple(torch.movedim(torch.broadcast_to(t, shape), axis, -1)
                 for t in ts), shape


def _start(y0, like: torch.Tensor, shape, axis: int) -> torch.Tensor:
    """y0 broadcast to `shape` with the scan axis of size 1, moved last."""
    target = list(shape)
    target[axis] = 1
    y0 = torch.as_tensor(y0, dtype=like.dtype, device=like.device)
    try:
        y0 = torch.broadcast_to(y0, target)
    except RuntimeError as e:
        raise ValueError(f"y0 of shape {tuple(y0.shape)} must broadcast to "
                         f"{tuple(target)}: one start state per row") from e
    return torch.movedim(y0, axis, -1)


def linear_scanned_maps(a, b, axis: int = -1):
    """Composed prefix maps of y -> a y + b along `axis`: (aa, bb) with
    y[n] = aa[n] y[-1] + bb[n] (scan.py:158-176). On the card these are two
    passes of the linear kernel, from y[-1] = 1 with b = 0 and from 0."""
    (b, a), _ = _operands(b, a, axis=axis)
    if _on_cpu(b):
        aa, bb = linear_maps_ref(a, b)
    else:
        aa = scan_linear(a, torch.zeros((), device=b.device), 1.0)
        bb = scan_linear(a, b, 0.0)
    return torch.movedim(aa, -1, axis), torch.movedim(bb, -1, axis)


def linear_recurrence(a, b, y0=0.0, axis: int = -1) -> torch.Tensor:
    """Solve y[n] = a[n] y[n-1] + b[n] with y[-1] = y0 along `axis`
    (scan.py:179-186). a, b broadcastable; y0 broadcastable to their shape
    with the scan axis of size 1. Differentiable in a, b and y0 on both
    devices (LinearRecurrence)."""
    (b, a), shape = _operands(b, a, axis=axis)
    y0 = _start(y0, b, shape, axis)
    if _wants_grad(a, b, y0):
        y = LinearRecurrence.apply(a, b, y0)
    else:
        y = _linear_rows(a, b, y0)
    return torch.movedim(y, -1, axis)


def max_affine_recurrence(m, a, c, y0=0.0, axis: int = -1) -> torch.Tensor:
    """Solve y[n] = max(m[n], a[n] y[n-1] + c[n]) along `axis`
    (scan.py:189-220), the compressor's smooth decoupled peak detector
    (reference AudioVolume.cpp:246-253). Requires a >= 0 (true for
    exp(-1 / (t sr)) smoothing coefficients): the composition law of the
    maps holds only then, and neither version checks it. Differentiable on
    both devices (MaxAffineRecurrence)."""
    (m, a, c), shape = _operands(m, a, c, axis=axis)
    y0 = _start(y0, m, shape, axis)
    if _wants_grad(m, a, c, y0):
        y = MaxAffineRecurrence.apply(m, a, c, y0)
    else:
        y = _max_affine_rows(m, a, c, y0)
    return torch.movedim(y, -1, axis)


def affine2x2_recurrence(a11, a12, a21, a22, b1, b2, y0=(0.0, 0.0)):
    """Solve (s1, s2)[n] = A[n] (s1, s2)[n-1] + (b1, b2)[n] along the last
    axis from (s1, s2)[-1] = y0, with A = [[a11, a12], [a21, a22]]. Each of
    the six coefficient planes broadcasts to the common shape [..., N] and
    none is stacked: the 2-pole SVF's planes go to the kernel as they are.
    Differentiable on both devices (Affine2x2Recurrence)."""
    planes, shape = _operands(b1, a11, a12, a21, a22, b2, axis=-1)
    b1, a11, a12, a21, a22, b2 = planes
    y01, y02 = (_start(v, b1, shape, -1) for v in y0)
    planes = (a11, a12, a21, a22, b1, b2)
    if _wants_grad(*planes, y01, y02):
        return Affine2x2Recurrence.apply(*planes, y01, y02)
    return _affine2x2_rows(planes, (y01, y02))


def affine_kxk_recurrence(A, b, y0=0.0) -> torch.Tensor:
    """Solve y[n] = A[n] y[n-1] + b[n] along the last axis for any k, in
    the layout the multinotch filters build: A [..., k, k, N] (A[..., i, j,
    n] multiplies state j into state i), b [..., k, N], y0 broadcastable to
    [..., k, 1]; returns [..., k, N]. An A without the rows' leading axes
    is one map for every row and is read once by the kernel.
    Differentiable on both devices (MatrixAffineRecurrence)."""
    b = torch.as_tensor(b)
    A = torch.as_tensor(A, dtype=b.dtype, device=b.device)
    k, n = b.shape[-2:]
    if A.shape[-3:] != (k, k, n):
        raise ValueError(f"A {tuple(A.shape)} must end in {(k, k, n)} for b "
                         f"{tuple(b.shape)}")
    y0 = torch.as_tensor(y0, dtype=b.dtype, device=b.device)
    if y0.ndim < 2:
        y0 = torch.broadcast_to(y0, (k,))[..., None]
    lead = torch.broadcast_shapes(A.shape[:-3], b.shape[:-2], y0.shape[:-2])
    A = torch.broadcast_to(A, lead + (k, k, n))
    b = torch.broadcast_to(b, lead + (k, n))
    y0 = torch.broadcast_to(y0, lead + (k, 1))
    if _wants_grad(A, b, y0):
        return MatrixAffineRecurrence.apply(A, b, y0)
    return _kxk_rows(A, b, y0)


def matrix_affine_recurrence(A, b, y0) -> torch.Tensor:
    """Solve y[n] = A[n] @ y[n-1] + b[n] for any state size k
    (scan.py:264-279). A: [..., T, k, k], b: [..., T, k], y0: [..., k];
    returns [..., T, k], on the k x k kernel for every k."""
    b = torch.as_tensor(b)
    A = torch.as_tensor(A, dtype=b.dtype, device=b.device)
    y0 = torch.as_tensor(y0, dtype=b.dtype, device=b.device)
    y = affine_kxk_recurrence(torch.movedim(A, -3, -1),
                              torch.movedim(b, -2, -1), y0[..., None])
    return torch.movedim(y, -1, -2)
