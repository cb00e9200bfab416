"""Sequence-parallel IIR recurrences: boundary states handed across ranks
(counterpart of flan_tpu/parallel/scan_sp.py).

Each rank scans its span of the time axis from an unknown start state,
which gives the composed prefix maps y[t] = aa[t] y_in + bb[t] of its
span (ops/scan.py linear_scanned_maps and matrix_affine_scanned_leaves:
passes of the scan kernels on the card). One all_gather of the spans'
total maps ([ranks, C] numbers or [ranks, C, k, k] matrices) lets every
rank fold its predecessors' totals over y0, in rank order, into its true
start state; its states are then aa * y_start + bb. No rank waits on
another's scan, and the only coupling is the gathered totals.

Every function is called on every rank with the same global arguments
and returns the global result on every rank, on the mesh's device.
"""
from __future__ import annotations

import math

import torch

from flan_tpu_torch.ops.scan import (linear_scanned_maps,
                                     matrix_affine_scanned_leaves)
from flan_tpu_torch.ops.stft import _cdiv
from flan_tpu_torch.parallel.mesh import (Mesh, all_gather, gather_time,
                                          shard_time)


def _f32(x, like=None) -> torch.Tensor:
    dev = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def linear_recurrence_sp(a, b, mesh: Mesh, y0=0.0,
                         axis_name: str = "sp") -> torch.Tensor:
    """y[n] = a[n] y[n-1] + b[n] with the time axis sharded.

    a, b: [C, N] (a broadcastable to b); y0: a number or [C]. N is padded
    to a multiple of the mesh with identity maps (a = 1, b = 0) and the
    padding sliced off the result."""
    b = _f32(b)
    a = torch.broadcast_to(_f32(a, b), b.shape)
    c, n = b.shape
    d = mesh.shape[axis_name]
    n_pad = _cdiv(n, d) * d
    a_l = shard_time(mesh, torch.nn.functional.pad(a, (0, n_pad - n),
                                                   value=1.0))
    b_l = shard_time(mesh, torch.nn.functional.pad(b, (0, n_pad - n)))
    a_l, b_l = a_l.to(mesh.device), b_l.to(mesh.device)
    aa, bb = linear_scanned_maps(a_l, b_l)              # [C, n_local]
    ga = all_gather(mesh, aa[:, -1].contiguous())       # [d, C]
    gb = all_gather(mesh, bb[:, -1].contiguous())
    s = torch.broadcast_to(_f32(y0, b_l), (c,))
    for i in range(mesh.rank):                          # in rank order
        s = ga[i] * s + gb[i]
    return gather_time(mesh, aa * s[:, None] + bb)[:, :n]


def matrix_affine_recurrence_sp(A, b, y0, mesh: Mesh,
                                axis_name: str = "sp") -> torch.Tensor:
    """y[t] = A[t] @ y[t-1] + b[t] with the T axis sharded.

    A: [C, T, k, k], b: [C, T, k], y0: [C, k] (k = 2 for the 2-pole SVF's
    state). T is padded to a multiple of the mesh with identity maps."""
    b = _f32(b)
    A = _f32(A, b)
    c, t, k, _ = A.shape
    d = mesh.shape[axis_name]
    t_pad = _cdiv(t, d) * d
    if t_pad != t:
        eye = torch.broadcast_to(torch.eye(k, dtype=b.dtype, device=b.device),
                                 (c, t_pad - t, k, k))
        A = torch.cat([A, eye], dim=1)
        b = torch.nn.functional.pad(b, (0, 0, 0, t_pad - t))
    A_l = shard_time(mesh, A, axis=1).to(mesh.device)
    b_l = shard_time(mesh, b, axis=1).to(mesh.device)
    s = _f32(y0, b_l)                                   # [C, k]
    leaves = matrix_affine_scanned_leaves(A_l, b_l)     # k*k + k of [C, T_l]
    AA, bb = leaves[:k * k], leaves[k * k:]
    tot_a = torch.stack([torch.stack([AA[i * k + j][:, -1] for j in range(k)],
                                     dim=-1) for i in range(k)], dim=-2)
    tot_b = torch.stack([bb[i][:, -1] for i in range(k)], dim=-1)
    ga = all_gather(mesh, tot_a)                        # [d, C, k, k]
    gb = all_gather(mesh, tot_b)                        # [d, C, k]
    for i in range(mesh.rank):
        s = torch.einsum("cij,cj->ci", ga[i], s) + gb[i]
    y = torch.stack([sum(AA[i * k + m] * s[:, m, None] for m in range(k))
                     + bb[i] for i in range(k)], dim=-1)  # [C, T_l, k]
    return gather_time(mesh, y, axis=1)[:, :t]


def filter_1pole_lowpass_sp(x, cutoff, sample_rate: float, mesh: Mesh,
                            axis_name: str = "sp") -> torch.Tensor:
    """Sequence-parallel TPT 1-pole lowpass, the arithmetic of
    ops/filter_cores.py onepole_core (reference Filter_1Pole::process_sample,
    AudioFilter.cpp:61-74) on linear_recurrence_sp, for swept cutoffs the
    constant-coefficient FIR path does not take.

    x: [C, N]; cutoff: Hz, a number or [N] per sample. g = tan(pi / sr *
    cutoff) as the port's filters form it (audio/filters.py _g_of)."""
    x = _f32(x).to(mesh.device)
    w = torch.broadcast_to(_f32(cutoff, x), (x.shape[-1],))
    g = torch.tan((math.pi / sample_rate) * w)
    big_g = (g / (1.0 + g))[None, :]
    s = linear_recurrence_sp(1.0 - 2.0 * big_g, 2.0 * big_g * x, mesh, 0.0,
                             axis_name)
    s_prev = torch.nn.functional.pad(s[:, :-1], (1, 0))
    return big_g * x + (1.0 - big_g) * s_prev
