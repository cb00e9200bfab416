"""Parallel recurrence solvers (counterpart of flan_tpu/ops/scan.py).

The reference's per-sample IIR loops (filters AudioFilter.cpp:61-186, the
compressor's peak detector AudioVolume.cpp:246-253) are first-order
recurrences y[n] = f_n(y[n-1]) whose maps compose associatively:

* linear y[n] = a[n] y[n-1] + b[n]
* the compressor's max-smoother y[n] = max(m[n], a[n] y[n-1] + c[n]),
  a >= 0
* 2-dim state recurrences (the 2-pole SVF) y[n] = A[n] y[n-1] + b[n]

Each function broadcasts its operands as the JAX version does and
dispatches by device: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel (ops/scan_kernels.py, csrc/scan_kernels.cu) or the
call raises. The kernels scan the last axis; a scan along another axis
moves that axis last (one transposing copy in, one out).
"""
from __future__ import annotations

import torch

from flan_tpu_torch.ops.scan_kernels import (affine2x2_ref, linear_maps_ref,
                                             linear_ref, max_affine_ref,
                                             scan_affine2x2, scan_linear,
                                             scan_max_affine)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _linear_rows(a, b, y0) -> torch.Tensor:
    """y = a y + b along the last axis from y0 ([..., 1]) on the tensors'
    device, without autograd."""
    return linear_ref(a, b, y0) if _on_cpu(b) else scan_linear(a, b, y0)


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
        a_next = torch.nn.functional.pad(a[..., 1:], (0, 1))
        g = _linear_rows(a_next.flip(-1), gy.flip(-1),
                         torch.zeros_like(y0)).flip(-1)
        y_prev = torch.cat([y0, y[..., :-1]], dim=-1)
        return g * y_prev, g, g[..., :1] * a[..., :1]


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, y0)):
        y = LinearRecurrence.apply(a, b, y0)
    else:
        y = _linear_rows(a, b, y0)
    return torch.movedim(y, -1, axis)


def max_affine_recurrence(m, a, c, y0=0.0, axis: int = -1) -> torch.Tensor:
    """Solve y[n] = max(m[n], a[n] y[n-1] + c[n]) along `axis`
    (scan.py:189-220), the compressor's smooth decoupled peak detector
    (reference AudioVolume.cpp:246-253). Requires a >= 0 (true for
    exp(-1 / (t sr)) smoothing coefficients): the composition law of the
    maps holds only then, and neither version checks it. No gradient on
    the card yet (ROADMAP A.12): a CUDA input that requires grad raises."""
    (m, a, c), shape = _operands(m, a, c, axis=axis)
    y0 = _start(y0, m, shape, axis)
    if _on_cpu(m):
        y = max_affine_ref(m, a, c, y0)
    else:
        y = scan_max_affine(m, a, c, y0)
    return torch.movedim(y, -1, axis)


def affine2x2_recurrence(a11, a12, a21, a22, b1, b2, y0=(0.0, 0.0)):
    """Solve (s1, s2)[n] = A[n] (s1, s2)[n-1] + (b1, b2)[n] along the last
    axis from (s1, s2)[-1] = y0, with A = [[a11, a12], [a21, a22]]. Each of
    the six coefficient planes broadcasts to the common shape [..., N] and
    none is stacked: the 2-pole SVF's planes go to the kernel as they are.
    No gradient on the card yet (ROADMAP A.12)."""
    planes, shape = _operands(b1, a11, a12, a21, a22, b2, axis=-1)
    b1, a11, a12, a21, a22, b2 = planes
    y01, y02 = (_start(v, b1, shape, -1) for v in y0)
    if _on_cpu(b1):
        return affine2x2_ref(a11, a12, a21, a22, b1, b2, y01, y02)
    return scan_affine2x2(a11, a12, a21, a22, b1, b2, y01, y02)


def matrix_affine_recurrence(A, b, y0) -> torch.Tensor:
    """Solve y[n] = A[n] @ y[n-1] + b[n] (scan.py:264-279). A: [..., T, k, k],
    b: [..., T, k], y0: [..., k]; returns [..., T, k]. Only k = 2, the SVF's
    state, is ported; k > 2 serves the multinotch filters, which wait
    (ROADMAP A.13)."""
    k = A.shape[-1]
    if k != 2:
        raise NotImplementedError(
            f"matrix_affine_recurrence with k = {k}: only k = 2 is ported; "
            "the k x k scan of the multinotch filters waits (ROADMAP A.13)")
    y0 = torch.as_tensor(y0, dtype=b.dtype, device=b.device)
    s1, s2 = affine2x2_recurrence(
        A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1], b[..., 0],
        b[..., 1], (y0[..., 0:1], y0[..., 1:2]))
    return torch.stack([s1, s2], dim=-1)
