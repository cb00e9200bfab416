"""PV desample / smear / extrapolate / spline-stretch / general modify
(counterpart of flan_tpu/pv/modify_extra.py; reference:
src/flan/PV/PVModify.cpp:15-194, 387-666). Bound onto PV in pv/__init__.py.

Plain torch on the PV's device, with one kernel on the path:
- desample: cumulative maxima and minima along frames (torch.cummax /
  cummin) for the bracketing selected frames; the accumulator is summed in
  float64.
- smear_time: a loop over the kernel's offsets on the device, each a pass
  over a whole plane (the JAX package's lax.scan).
- time_extrapolate: scatter_reduce_ "amax" / "amin", the lowest source
  bin winning a tie, as pv/algorithms.py shape does.
- stretch_spline: the natural spline's tridiagonal system solved as two
  linear recurrences along frames (ops/scan.py linear_recurrence: the scan
  kernel, flan_scan kind 0, on the card; its plain version on the CPU),
  then each output frame's cubic from its two knots. No dense [F_out, F]
  matrix is built (the JAX package's is 4 GB at 60 s and 48 kHz).
- modify: the two scatter-max sweeps over the quads' neighbourhood steps,
  over chunks of frames of quads so that the quads' corner and coefficient
  planes are never all resident.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import (as_function, as_function2d,
                                          broadcast_f32)
from flan_tpu_torch.ops.scan import linear_recurrence
from flan_tpu_torch.ops.stft import cpu_exact, true_div

# quads per chunk of `modify`: frames of quads per chunk are this over the
# bins, so a chunk's ~50 [C, frames, B] float32 planes stay a few GB
MODIFY_CHUNK_QUADS = 1 << 23


def _null():
    from flan_tpu_torch.pv.pv import PV
    return PV.create_null()


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on like's device: an operand that torch's CUDA
    kernels do not fold into a rounded reciprocal."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def desample(self, decimation_ratio, interp: Callable = interpolators.linear):
    """Integrate-and-select decimation with interpolated restoration
    (reference PVModify.cpp:445-511; flan_tpu/pv/modify_extra.py:20-67).
    The per-bin accumulator 1 + cumsum(ratio) is summed in float64, where
    the JAX package sums in float32: the two agree at the goldens' 96
    frames, and float32 sums over a long PV drift across floor()."""
    if self.is_null():
        return _null()
    c, f, b = self.mag.shape
    ratio = torch.clamp(torch.broadcast_to(self._sample_2d(decimation_ratio),
                                           (f, b)), 0.0, 1.0)
    # accumulator starts at 1 so frame 0 is always selected
    crossings = torch.floor(1.0 + torch.cumsum(ratio.double(), dim=0))
    selected = torch.ones((f, b), dtype=torch.bool, device=self.device)
    selected[1:] = (crossings[1:] - crossings[:-1]) >= 1.0
    del crossings
    f_row = float_iota(f, device=self.device)
    f_idx = f_row[:, None]
    # lFrame: the last selected frame <= f; rFrame: the next one > f. The
    # running max and min run along the innermost axis (bins outermost),
    # where torch's CUDA scans are fast
    sel_t = selected.t().contiguous()
    del selected
    l_frame = torch.cummax(torch.where(sel_t, f_row, -1.0), dim=1
                           ).values.t()
    r_rev = torch.cummin(torch.where(sel_t, f_row, float(f + 1)).flip(1),
                         dim=1).values.flip(1).t()
    del sel_t
    r_frame = torch.cat([r_rev[1:], torch.full((1, b), f + 1.0,
                                               device=self.device)], dim=0)
    valid = (l_frame >= 0) & (r_frame <= f - 1)
    li = torch.clamp(l_frame, 0, f - 1).long()
    ri = torch.clamp(r_frame, 0, f - 1).long()
    mix = interp(torch.clamp((f_idx - l_frame)
                             / torch.clamp(r_frame - l_frame, min=1e-9),
                             0.0, 1.0))

    def gather(a, idx):
        return torch.gather(a, 1, idx[None].expand(c, f, b))

    w0 = (1.0 - mix)[None] * gather(self.mag, li)
    w1 = mix[None] * gather(self.mag, ri)
    out_mag = torch.where(valid[None], w0 + w1, 0.0)
    out_freq = torch.where(valid[None], torch.where(
        w0 > w1, gather(self.freq, li), gather(self.freq, ri)), 0.0)
    return self._with(mag=out_mag, freq=out_freq)


def smear_time(self, smear_size, granularity=5, distribution=None,
               max_kernel: Optional[int] = None):
    """Windowed time average of the surrounding MF data (reference
    PVModify.cpp:513-605; flan_tpu/pv/modify_extra.py:70-178). The kernel's
    half-width comes from the sampled smear sizes; the offsets run as a
    loop on the device, each a pass over the whole planes. The
    distribution is sampled once into a table on the quantised grid the
    reference looks it up on, on the host (one table for every device);
    each (frame, bin) steps from -exp by its own integer granularity."""
    if self.is_null():
        return _null()
    if distribution is None:
        def distribution(t):
            return 0.5 * (1.0 + torch.cos(math.pi * t))
    c, f, b = self.mag.shape
    dev = self.device
    smear = torch.clamp(torch.broadcast_to(self._sample_2d(smear_size),
                                           (f, b)), min=0.0)     # seconds
    # granularity is an int-valued Function upstream (PVModify.cpp:515):
    # truncate, then at least 1
    gran = torch.clamp(torch.trunc(torch.broadcast_to(
        self._sample_2d(granularity), (f, b))), min=1.0).to(torch.int32)

    # loop bounds use the truncated frame count (PVModify.cpp:545,573); the
    # weights keep the float smear
    exp_int = torch.trunc(smear * self.analysis_rate)
    max_exp = int(exp_int.max())
    fr_ix = float_iota(f, device=dev)[:, None]
    leftmost = int(min(0.0, float((fr_ix - exp_int).min())))
    rightmost = int(max(float(f - 1), float((fr_ix + exp_int).max())))
    left = -leftmost
    f_out = rightmost - leftmost

    half_taps = max(max_exp, 1)
    if max_kernel is not None and half_taps > max_kernel:
        warnings.warn(f"smear_time: derived kernel {half_taps} half-taps "
                      f"clipped to explicit max_kernel={max_kernel}")
        half_taps = max_kernel
    elif max_kernel is None and half_taps > 4096:
        warnings.warn(
            f"smear_time: smear sizes imply a {half_taps}-half-tap kernel "
            "(each tap is a full-plane pass); pass max_kernel to bound it")

    # the distribution on the quantised grid i / (2 max_exp)
    # (PVModify.cpp:554-556, 581-584), looked up by the truncated index
    m2 = 2 * max(max_exp, 1)
    grid = true_div(torch.arange(-m2, m2, dtype=torch.float32), float(m2))
    table = broadcast_f32(distribution(grid), grid.shape, "cpu").to(dev)

    in_frame = torch.clamp(torch.arange(f_out, device=dev) - left, 0, f - 1)
    smear_o = torch.clamp(smear[in_frame], min=1e-30)     # [F_out, B] s
    exp_o = exp_int[in_frame].to(torch.int32)
    gran_o = gran[in_frame]
    del smear, gran, exp_int
    src_rows = torch.arange(f_out, device=dev) - left

    mag_sum = torch.zeros((c, f_out, b), dtype=torch.float32, device=dev)
    freq_sum = torch.zeros_like(mag_sum)
    total_w = torch.zeros((f_out, b), dtype=torch.float32, device=dev)
    used_w = torch.zeros_like(total_w)
    rate32 = np.float32(self.analysis_rate)
    for off in range(-half_taps, half_taps):
        # the reference loop: for off = -exp; off < exp; off += gran
        # (PVModify.cpp:578), anchored at -exp
        # (-exp <= off < exp is exp > off for off >= 0, exp > -off - 1
        # below)
        in_window = ((exp_o > (off if off >= 0 else -off - 1))
                     & ((off + exp_o) % gran_o == 0))
        # d = frame_to_time(off) / smear (float32), idx = trunc(size * 0.5
        # * (1 + d)) clamped
        d = _scalar(float(np.float32(off) / rate32), smear_o) / smear_o
        idx = torch.clamp((1.0 + d) * float(m2), 0, 2 * m2 - 1).long()
        w = table[idx] * in_window
        ok = (src_rows + off >= 0) & (src_rows + off < f)
        w_ok = w * ok[:, None]
        total_w += w
        used_w += w_ok
        # the rows of this offset's sources that lie inside the input
        lo = int(max(0, left - off))
        hi = int(min(f_out, f + left - off))
        if lo < hi:
            s0 = lo - left + off
            mag_sum[:, lo:hi] += self.mag[:, s0:s0 + hi - lo] * w_ok[lo:hi]
            freq_sum[:, lo:hi] += (self.freq[:, s0:s0 + hi - lo]
                                   * w_ok[lo:hi])
    out_mag = torch.where(total_w > 0, mag_sum / torch.clamp(
        total_w, min=1e-12), 0.0)
    del mag_sum
    out_freq = torch.where(used_w > 0, freq_sum / torch.clamp(
        used_w, min=1e-12), 0.0)
    return self._with(mag=out_mag, freq=out_freq)


def time_extrapolate(self, start_time: float, end_time: float,
                     extrap_time: float,
                     interp: Callable = interpolators.linear):
    """Interpolate between two anchor frames, then keep extrapolating, with
    bin-shift alignment (reference PVModify.cpp:607-666;
    flan_tpu/pv/modify_extra.py:181-253)."""
    if self.is_null():
        return _null()
    length = self.length
    start_time = float(np.clip(start_time, 0.0, length))
    if end_time == -1:
        end_time = length
    end_time = float(np.clip(end_time, 0.0, length))
    if start_time >= end_time or extrap_time <= 0:
        return _null()

    c, f, b = self.mag.shape
    dev = self.device
    start = int(self.time_to_frame(start_time))
    end = int(self.time_to_frame(end_time))
    ext = int(self.time_to_frame(extrap_time))
    f_out = end + ext

    # Reference quirk (golden-tested): the interpolator table is filled
    # with interp((i - start)/(end - start)) but indexed by frame - start
    # (PVModify.cpp:628-631, 640), so output frame k mixes
    # interp((k - 2 start)/(end - start)); negative inputs reach it
    mix = interp(torch.tensor((np.arange(start, f_out) - 2 * start)
                              / max(end - start, 1), dtype=torch.float32,
                              device=dev))
    # an anchor past the last frame reads the last (JAX clamps the index)
    s_ix, e_ix = min(start, f - 1), min(end, f - 1)
    lm, rm = self.mag[:, s_ix, None], self.mag[:, e_ix, None]
    lf, rf = self.freq[:, s_ix, None], self.freq[:, e_ix, None]
    m = mix[None, :, None]
    ext_mag = torch.abs((1 - m) * lm + m * rm)
    ext_freq = (1 - m) * lf + m * rf

    bin_ix = torch.arange(b, device=dev)
    # C truncation on the float expressions, nested (as PV::shape):
    # shift = Bin(bin - f2b(right.f)), target = Bin(f2b(extrap.f) + shift)
    right_shift = torch.trunc(bin_ix.to(torch.float32)
                              - true_div(rf, self.bin_width))
    target = torch.trunc(true_div(ext_freq, self.bin_width)
                         + right_shift).long()
    valid = (target >= 0) & (target < b)
    tb = torch.clamp(target, 0, b - 1)
    n_ext = f_out - start
    sc_mag = torch.zeros((c, n_ext, b), dtype=torch.float32,
                         device=dev).scatter_reduce_(
        2, tb, torch.where(valid, ext_mag, -1.0), "amax")
    winner = torch.gather(sc_mag, 2, tb)
    # first wins on equal-magnitude ties: the sequential strict > write
    # keeps the lowest source bin's frequency (PVModify.cpp:661-662)
    tie = valid & (ext_mag == winner) & (ext_mag > 0)
    win_src = torch.full((c, n_ext, b), b, dtype=torch.int64,
                         device=dev).scatter_reduce_(
        2, tb, torch.where(tie, torch.broadcast_to(bin_ix, tie.shape), b),
        "amin")
    got = torch.gather(ext_freq, 2, torch.clamp(win_src, 0, b - 1))
    sc_freq = torch.where(win_src < b, got, 0.0)
    out_mag = torch.cat([self.mag[:, :start], torch.clamp(sc_mag, min=0.0)],
                        dim=1)
    out_freq = torch.cat([self.freq[:, :start], sc_freq], dim=1)
    return self._with(mag=out_mag, freq=out_freq)


# ------------------------------------------------------------ stretch_spline

def spline_knots(exp: np.ndarray) -> np.ndarray:
    """Knot positions xs [F] (float64) of per-frame integer expansions exp
    (>= 1): xs[i] = sum(exp[:i]) for i < F - 1 and xs[F - 1] = xs[F - 2] +
    exp[F - 2] (flan_tpu/pv/modify_extra.py:275-281)."""
    return np.concatenate([[0.0], np.cumsum(exp[:-1], dtype=np.float64)])


def spline_band_plan(xs: np.ndarray):
    """The natural spline's tridiagonal system A m = B y (the one of
    flan_tpu/pv/modify_extra.py _natural_spline_matrix: m[0] = m[n-1] = 0,
    row i: h[i-1]/6 m[i-1] + (h[i-1] + h[i])/3 m[i] + h[i]/6 m[i+1] =
    (y[i+1] - y[i]) / h[i] - (y[i] - y[i-1]) / h[i-1]) as the two linear
    recurrences of the Thomas algorithm, whose pivots depend on the knots
    alone (float64, on the host):
      forward    d'[i] = alpha[i] d'[i-1] + p[i] D[i] - q[i] D[i-1]
      backward   m[i]  = beta[i] m[i+1] + d'[i]
    with D[i] = y[i+1] - y[i]. Returns (alpha, p, q, beta), float32 [n]
    (p and q are 0 on the two end rows)."""
    n = len(xs)
    h = np.diff(xs).tolist()        # Python floats: a fast scalar loop
    alpha, beta, p, q = ([0.0] * n for _ in range(4))
    cp = 0.0            # c'[i-1]; row 0 is m[0] = 0, so c'[0] = 0
    for i in range(1, n - 1):
        h0, h1 = h[i - 1], h[i]
        a_i = h0 / 6.0
        den = (h0 + h1) / 3.0 - a_i * cp
        cp = h1 / 6.0 / den
        alpha[i] = -a_i / den
        beta[i] = -cp
        p[i] = 1.0 / (h1 * den)
        q[i] = 1.0 / (h0 * den)
    return tuple(np.asarray(v, np.float32) for v in (alpha, p, q, beta))


def spline_eval_plan(xs: np.ndarray, f_out: int):
    """Each output frame t's knot interval idx and the weights of its cubic
    s(t) = w0 y0 + w1 y1 + c0 m0 + c1 m1 (u = (t - x0) / h: w0 = 1 - u,
    w1 = u, c0 = h^2/6 ((1-u)^3 - (1-u)), c1 = h^2/6 (u^3 - u);
    flan_tpu/pv/modify_extra.py:315-331), float64 on the host, returned
    as (idx int64, w0, w1, c0, c1 float32)."""
    n = len(xs)
    ts = np.arange(f_out, dtype=np.float64)
    idx = np.clip(np.searchsorted(xs, ts, side="right") - 1, 0, n - 2)
    x0 = xs[idx]
    hi = xs[idx + 1] - x0
    u = (ts - x0) / hi
    c0 = hi * hi / 6.0 * ((1 - u) ** 3 - (1 - u))
    c1 = hi * hi / 6.0 * (u ** 3 - u)
    return (idx,) + tuple(v.astype(np.float32) for v in (1 - u, u, c0, c1))


def spline_second_derivatives(y: torch.Tensor, plan) -> torch.Tensor:
    """m [..., n] of the natural spline through y [..., n] (knots along the
    last axis) from spline_band_plan: two linear recurrences along the
    last axis (the scan kernel on the card), the second in reverse time.
    Each coefficient row is one [n] row shared by every row of y."""
    alpha, p, q, beta = (torch.from_numpy(v).to(y.device) for v in plan)
    n = y.shape[-1]
    r = torch.zeros_like(y)
    if n > 2:
        d = y[..., 1:] - y[..., :-1]                         # D [..., n-1]
        r[..., 1:-1] = d[..., 1:] * p[1:-1] - d[..., :-1] * q[1:-1]
        del d
    dp = linear_recurrence(alpha, r, 0.0, axis=-1)
    del r
    return linear_recurrence(beta.flip(0), dp.flip(-1), 0.0,
                             axis=-1).flip(-1)


def stretch_spline(self, expansion):
    """Integer per-frame expansion filled by natural cubic splines
    (reference PVModify.cpp:387-443; flan_tpu/pv/modify_extra.py:256-331).
    The knots are bin-independent, so one band plan (spline_band_plan)
    serves every channel and bin: the second derivatives come from two
    linear recurrences along frames, then each output frame is a cubic of
    its two knots (spline_eval_plan). The planes cross to the recurrences'
    layout, frames last, once each."""
    if self.is_null():
        return _null()
    c, f, b = self.mag.shape
    fn = as_function(expansion)
    if fn.is_constant:
        exp = np.full(f, fn.constant_value)
    else:
        t = torch.tensor(np.arange(f, dtype=np.float64) / self.analysis_rate,
                         dtype=torch.float32)
        out = fn(t)
        out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) \
            else out
        exp = np.broadcast_to(np.asarray(out, np.float64).reshape(-1), (f,))
    exp = np.maximum(exp.astype(np.int64), 1)
    xs = spline_knots(exp)
    f_out = int(xs[-1])
    if f_out <= 0:
        return _null()
    band = spline_band_plan(xs)
    idx, *weights = spline_eval_plan(xs, f_out)
    idx = torch.from_numpy(idx).to(self.device)
    w0, w1, c0, c1 = (torch.from_numpy(v).to(self.device)[:, None]
                      for v in weights)

    def one(plane):
        # frames last for the recurrences, then back
        m = spline_second_derivatives(plane.transpose(1, 2).contiguous(),
                                      band).transpose(1, 2)
        out = w0 * plane.index_select(1, idx)
        out += w1 * plane.index_select(1, idx + 1)
        out += c0 * m.index_select(1, idx)
        out += c1 * m.index_select(1, idx + 1)
        return out
    return self._with(mag=one(self.mag), freq=one(self.freq))


# ------------------------------------------------------------------- modify

def _edge(X, Y, py, qy, ax, ay, dxx, dyy):
    """One edge's crossing of the crossing-number test, half-open in y
    (PVModify.cpp:100-105)."""
    yr = ((py <= Y) & (Y < qy)) | ((qy <= Y) & (Y < py))
    icpt = dxx / torch.where(dyy == 0.0, 1.0, dyy) * (Y - ay) + ax
    return yr & (X < icpt)


class _QuadChunk:
    """The quads of frames [f0, f1) of `modify`: their corners, inverse
    bilinear coefficients, bounding boxes, corner magnitudes and
    frequencies, and step() for one neighbourhood offset."""

    def __init__(self, PX, PY, mag, mf_freq, f0, f1, interp, out_frames, b):
        sl, sl1 = slice(f0, f1), slice(f0 + 1, f1 + 1)
        x00, y00 = PX[sl, :-1], PY[sl, :-1]
        x10, y10 = PX[sl1, :-1], PY[sl1, :-1]
        x11, y11 = PX[sl1, 1:], PY[sl1, 1:]
        x01, y01 = PX[sl, 1:], PY[sl, 1:]
        # inverse bilinear coefficients (PVModify.cpp:109-137)
        a0, a1 = x00, x10 - x00
        a2, a3 = x01 - x00, x00 - x10 + x11 - x01
        b0, b1 = y00, y10 - y00
        b2, b3 = y01 - y00, y00 - y10 + y11 - y01
        self.a0, self.a1, self.a2, self.a3 = a0, a1, a2, a3
        self.b1, self.b3 = b1, b3
        self.qa = a3 * b2 - a2 * b3
        # the parts of qb and qc without X and Y, in the JAX package's
        # left-to-right order
        self.kb = a3 * b0 - a0 * b3 + a1 * b2 - a2 * b1
        self.kc = a1 * b0 - a0 * b1
        self.edges = (
            (y00, y01, x00, y00, x00 - x01, y00 - y01),
            (y10, y00, x10, y10, x10 - x00, y10 - y00),
            (y11, y10, x11, y11, x11 - x10, y11 - y10),
            (y01, y11, x01, y01, x01 - x11, y01 - y11))
        self.minx = torch.floor(torch.minimum(torch.minimum(x00, x10),
                                              torch.minimum(x11, x01))).int()
        self.miny = torch.floor(torch.minimum(torch.minimum(y00, y10),
                                              torch.minimum(y11, y01))).int()
        self.mags = (mag[:, sl, :-1], mag[:, sl1, :-1], mag[:, sl1, 1:],
                     mag[:, sl, 1:])
        self.freqs = torch.stack((mf_freq[:, sl, :-1], mf_freq[:, sl1, :-1],
                                  mf_freq[:, sl1, 1:], mf_freq[:, sl, 1:]))
        self.interp, self.out_frames, self.b = interp, out_frames, b

    def step(self, dx: int, dy: int):
        """(flat target cell [C, Q], value [C, Q], frequency [C, Q], ok
        [C, Q]) of the neighbourhood offset (dx, dy) (flan_tpu/pv/
        modify_extra.py:426-486 step_vals)."""
        a0, a1, a2, a3 = self.a0, self.a1, self.a2, self.a3
        tx_i, ty_i = self.minx + dx, self.miny + dy
        X, Y = tx_i.float(), ty_i.float()
        # solve the bilinear (l, m): X = a0 + a1 l + a2 m + a3 l m, and Y
        qa = self.qa
        qb = self.kb + X * self.b3 - a3 * Y
        qc = self.kc + X * self.b1 - a1 * Y
        disc = qb * qb - 4.0 * qa * qc
        lin = torch.abs(qa) < 1e-9
        mm = torch.where(
            lin, -qc / torch.where(torch.abs(qb) > 1e-9, qb, 1.0),
            (-qb + cpu_exact(torch.sqrt, torch.clamp(disc, min=0.0)))
            / torch.where(lin, 1.0, 2.0 * qa))
        ldenom = a1 + a3 * mm
        ll = (X - a0 - a2 * mm) / torch.where(torch.abs(ldenom) > 1e-9,
                                              ldenom, 1.0)
        eps = 1e-4
        cross = _edge(X, Y, *self.edges[0])
        for e in self.edges[1:]:
            cross = cross ^ _edge(X, Y, *e)
        inside = (cross & (torch.abs(ll - 0.5) <= 0.5 + eps)
                  & (torch.abs(mm - 0.5) <= 0.5 + eps) & (disc >= 0))
        iL = self.interp(torch.clamp(ll, 0.0, 1.0))
        iM = self.interp(torch.clamp(mm, 0.0, 1.0))
        m = self.mags
        w = torch.stack([(1 - iL) * (1 - iM) * m[0], iL * (1 - iM) * m[1],
                         iL * iM * m[2], (1 - iL) * iM * m[3]])
        max_w, max_i = torch.max(w, dim=0)
        sel_freq = torch.gather(self.freqs, 0, max_i[None])[0]
        ok = (inside & (tx_i >= 0) & (tx_i < self.out_frames)
              & (ty_i >= 0) & (ty_i < self.b))[None] & (max_w > 0)
        tx = torch.clamp(tx_i, 0, self.out_frames - 1).long()
        ty = torch.clamp(ty_i, 0, self.b - 1).long()
        flat = torch.broadcast_to((tx * self.b + ty).reshape(1, -1),
                                  (max_w.shape[0], tx.numel()))
        c = max_w.shape[0]
        return (flat, torch.where(ok, max_w, -1.0).reshape(c, -1),
                sel_freq.reshape(c, -1), ok.reshape(c, -1))


def modify(self, mod, interp: Callable = interpolators.linear,
           max_quad_span: Optional[int] = None):
    """General time x frequency remap by quad rasterisation (reference
    PVModify.cpp:15-194; flan_tpu/pv/modify_extra.py:333-510). Each input
    cell's quad is rasterised by inverse bilinear interpolation with
    scatter-max writes over a neighbourhood whose span comes from the
    mapped quads themselves (max_quad_span an optional ceiling). Two
    sweeps, each a loop over the span_x * span_y neighbourhood offsets:
    the magnitudes' scatter-max, then the winning magnitude's frequency.
    Both run over chunks of frames of MODIFY_CHUNK_QUADS quads: a quad
    writes only near its own mapped cells and max is order-free, so the
    chunks give the bits of one pass."""
    if self.is_null():
        return _null()
    c, f, b = self.mag.shape
    dev = self.device
    fn = mod if callable(mod) else as_function2d(mod)

    # the float32 multiply grid the reference samples (Function.h:165-167)
    t = float_iota(f, device=dev) * np.float32(
        1.0 / self.analysis_rate)
    fr = float_iota(b, device=dev) * self.bin_width

    def split(mapped, shape):
        if isinstance(mapped, tuple):
            m_t, m_f = mapped
        else:
            mapped = torch.as_tensor(mapped)
            m_t, m_f = mapped[..., 0], mapped[..., 1]
        return broadcast_f32(m_t, shape, dev), broadcast_f32(m_f, shape, dev)

    m_t, m_f = split(fn(t[:, None], fr[None, :]), (f, b))
    # to output frame / bin coordinates
    PX = (m_t * self.analysis_rate).contiguous()
    PY = true_div(m_f, self.bin_width).contiguous()
    del m_t, m_f
    out_frames = int(math.ceil(float(PX.max())))
    if out_frames / self.analysis_rate > 600.0:
        # the reference refuses outputs over 10 minutes (PVModify.cpp:31-35)
        return _null()
    out_frames = max(out_frames, 1)
    # each MF's modified frequency: the map at the MF's own frequency
    tt = torch.broadcast_to(t[None, :, None], self.freq.shape)
    mf_freq = split(fn(tt, self.freq), self.freq.shape)[1].contiguous()

    # the rasterisation span from the mapped quads' bounding boxes
    def corners_max(P):
        return torch.maximum(torch.maximum(P[:-1, :-1], P[1:, :-1]),
                             torch.maximum(P[1:, 1:], P[:-1, 1:]))

    def corners_min(P):
        return torch.minimum(torch.minimum(P[:-1, :-1], P[1:, :-1]),
                             torch.minimum(P[1:, 1:], P[:-1, 1:]))
    span_x = int(float((torch.floor(corners_max(PX))
                        - torch.floor(corners_min(PX))).max())) + 1
    span_y = int(float((torch.floor(corners_max(PY))
                        - torch.floor(corners_min(PY))).max())) + 1
    span_x, span_y = max(span_x, 1), max(span_y, 1)
    if max_quad_span is not None and (span_x > max_quad_span
                                      or span_y > max_quad_span):
        warnings.warn(
            f"PV.modify: derived quad span ({span_x}x{span_y}) clipped "
            f"to explicit max_quad_span={max_quad_span}; extreme quads "
            "will rasterize incompletely")
        span_x = min(span_x, max_quad_span)
        span_y = min(span_y, max_quad_span)
    elif max_quad_span is None and span_x * span_y > 4096:
        warnings.warn(
            f"PV.modify: one quad spans {span_x}x{span_y} output cells, "
            f"driving a {span_x * span_y}-step rasterization scan; pass "
            "max_quad_span to trade completeness for speed")

    chunk_frames = max(1, MODIFY_CHUNK_QUADS // max(b - 1, 1))
    starts = range(0, f - 1, chunk_frames)

    def chunks():
        for f0 in starts:
            yield _QuadChunk(PX, PY, self.mag, mf_freq, f0,
                             min(f0 + chunk_frames, f - 1), interp,
                             out_frames, b)

    steps = [(s // span_y, s % span_y) for s in range(span_x * span_y)]
    # sweep 1: the magnitudes' scatter-max over the neighbourhood
    out_mag = torch.zeros((c, out_frames * b), dtype=torch.float32,
                          device=dev)
    for q in chunks():
        for dx, dy in steps:
            flat, val, _, _ = q.step(dx, dy)
            out_mag.scatter_reduce_(1, flat, val, "amax")
    # sweep 2: the winning magnitude's frequency, each step recomputed
    out_freq = torch.full((c, out_frames * b), -math.inf,
                          dtype=torch.float32, device=dev)
    for q in chunks():
        for dx, dy in steps:
            flat, val, sel_freq, ok = q.step(dx, dy)
            write = ok & (val >= torch.gather(out_mag, 1, flat)) & (val > 0)
            out_freq.scatter_reduce_(
                1, flat, torch.where(write, sel_freq, -math.inf), "amax")
    out_freq = torch.where(torch.isneginf(out_freq), 0.0, out_freq)
    return self._with(mag=out_mag.reshape(c, out_frames, b),
                      freq=out_freq.reshape(c, out_frames, b))
