"""PV time and frequency remaps (counterpart of flan_tpu/ops/pv_modify.py;
reference: src/flan/PV/PVModify.cpp:196-362).

The reference walks adjacent input frame pairs and paints every integer
output frame in the mapped interval. For a monotonic map the painted
intervals partition the output axis, so the scatter inverts into a gather:
one searchsorted per output frame plus a weighted read of the surrounding
input pair, under the reference's weighted-frequency-sum policy (magnitude
is the weight sum, frequency the weighted average). The frequency remaps
(repitch, modify_frequency) invert the same way along bins, one lookup per
frame, under the reference's max-weight endpoint policy.

The gather runs in chunks of output frames. A 2x stretch of ten minutes of
stereo at 4096-point frames has [2, 450002, 2049] outputs, 7.4 GB per
plane; a literal transcription would make several temporaries of that
size, while a chunk bounds them at [C, chunk, B]. Each output frame
depends only on its own pair, so chunk boundaries change no value.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.ops.stft import true_div

DEFAULT_CHUNK_FRAMES = 8192


def _pair_lookup(time_map_t: torch.Tensor, xs: torch.Tensor):
    """For each x, the pair index i with map[i-1] <= x < map[i].

    time_map_t: [Bm, F] non-decreasing rows; xs: [X]. Returns (idx, valid)
    [X, Bm], idx clipped to [1, F-1]."""
    bm, f = time_map_t.shape
    idx = torch.searchsorted(time_map_t, xs.expand(bm, -1).contiguous(),
                             right=True).T
    valid = (idx >= 1) & (idx <= f - 1)
    return torch.clamp(idx, 1, f - 1), valid


def _mix(xs, l, r, interp):
    return interp(torch.clamp((xs - l) / torch.where(r == l, 1.0, r - l),
                              0.0, 1.0))


def modify_time_gather(mag: torch.Tensor, freq: torch.Tensor,
                       time_map: torch.Tensor, *, out_frames: int,
                       interp: Callable = interpolators.linear,
                       chunk_frames: int = DEFAULT_CHUNK_FRAMES):
    """Monotonic time remap (stretch / modify_time).

    mag, freq: [C, F, B]. time_map: [F, B] or [F, 1], the mapped output
    position of each input frame in PV frames (monotonic in F).
    Returns (mag, freq) [C, out_frames, B].
    """
    c, f, b = mag.shape
    bm = time_map.shape[1]
    dev = mag.device
    map_t = time_map.T.contiguous()                          # [Bm, F]
    out_mag = torch.empty((c, out_frames, b), dtype=torch.float32,
                          device=dev)
    out_freq = torch.empty_like(out_mag)
    for x0 in range(0, out_frames, chunk_frames):
        nx = min(chunk_frames, out_frames - x0)
        xs = float_iota(x0, x0 + nx, device=dev)
        idx, valid = _pair_lookup(map_t, xs)                 # [X, Bm]
        l = torch.gather(time_map, 0, idx - 1)
        r = torch.gather(time_map, 0, idx)
        mix = _mix(xs[:, None], l, r, interp)
        if bm == 1:
            i0, i1 = idx[:, 0] - 1, idx[:, 0]
            m_l, m_r = mag.index_select(1, i0), mag.index_select(1, i1)
            f_l, f_r = freq.index_select(1, i0), freq.index_select(1, i1)
        else:
            i0 = (idx - 1).expand(c, nx, b)
            i1 = idx.expand(c, nx, b)
            m_l, m_r = torch.gather(mag, 1, i0), torch.gather(mag, 1, i1)
            f_l, f_r = torch.gather(freq, 1, i0), torch.gather(freq, 1, i1)
        w0 = (1.0 - mix) * m_l
        w1 = mix * m_r
        total = w0 + w1
        fsum = w0 * f_l + w1 * f_r
        # Reference zero-abort quirk (PVModify.cpp:350-351): the spread loop
        # RETURNS at the first x whose totalWeight == 0, leaving the rest of
        # the pair span unwritten. For linear-family interps and
        # non-negative magnitudes the blend is monotone in x, so the whole
        # span is killed iff the weight at its first x = max(ceil(l), 0) is
        # 0. The test depends only on the pair, so it holds across chunks.
        mix0 = _mix(torch.clamp(torch.ceil(l), min=0.0), l, r, interp)
        aborted = (1.0 - mix0) * m_l + mix0 * m_r == 0.0
        live = valid & ~aborted
        out_mag[:, x0:x0 + nx] = torch.where(live, total, 0.0)
        pos = live & (total > 0.0)
        out_freq[:, x0:x0 + nx] = torch.where(
            pos, fsum / torch.where(total > 0.0, total, 1.0), 0.0)
    return out_mag, out_freq


def _pair_lookup_rows(map_rows: torch.Tensor, xs: torch.Tensor):
    """For each row of map_rows [F, B] and each x of xs [X], the pair index
    i with map[i-1] <= x < map[i] (flan_tpu/ops/pv_modify.py:30, one
    lookup per frame). Returns (idx, valid) [F, X], idx clipped to
    [1, B-1]."""
    f, b = map_rows.shape
    idx = torch.searchsorted(map_rows.contiguous(),
                             xs.expand(f, -1).contiguous(), right=True)
    valid = (idx >= 1) & (idx <= b - 1)
    return torch.clamp(idx, 1, b - 1), valid


def _const_pairs(factor: float, b: int):
    """The inverse bin map of a constant factor, on the host in float32 as
    flan_tpu/ops/pv_modify.py:146-157 builds it: bin_map[j] = factor (j+1),
    each output bin's pair index, mix and validity."""
    f32 = np.float32(factor)
    bin_map = f32 * np.arange(1, b + 1, dtype=np.float32)
    ys = np.arange(b, dtype=np.float32)
    idx = np.searchsorted(bin_map, ys, side="right")
    valid = (idx >= 1) & (idx <= b - 1)
    idx = np.clip(idx, 1, b - 1)
    lo = bin_map[idx - 1]
    hi = bin_map[idx]
    mix = np.clip((ys - lo) / np.where(hi == lo, 1.0, hi - lo), 0.0, 1.0)
    # end-clamp quirk: end_bin = clamp(ceil(hiBin), 0, B-1) with a y != end
    # loop means the TOP bin is never written (PVModify.cpp:224-230)
    valid &= ys < b - 1
    return idx, mix.astype(np.float32), valid


def _max_weight_pick(m_lo, m_hi, f_lo, f_hi, mix, valid):
    """The reference's endpoint policy (PVModify.cpp:230-243). Its ternary
    is INVERTED against its own comment: w0 < w1 picks the low endpoint,
    so the SMALLER weight wins; and a write needs the picked magnitude to
    beat the zero-initialised output. Both kept bug for bug."""
    w0 = (1.0 - mix) * m_lo
    w1 = mix * m_hi
    pick_lo = w0 < w1
    out_m = torch.where(pick_lo, m_lo, m_hi)
    out_f = torch.where(pick_lo, f_lo, f_hi)
    live = valid & (out_m > 0.0)
    return torch.where(live, out_m, 0.0), torch.where(live, out_f, 0.0)


def modify_frequency_gather_const(mag: torch.Tensor, freq: torch.Tensor,
                                  factor: float, bin_width: float):
    """Constant-factor frequency remap (repitch by a constant;
    flan_tpu/ops/pv_modify.py:128-176). The pair indices, mixes and
    validity come from the host (_const_pairs); the per-MF frequency remap
    is factor * (clip(freq) + bin_width), the reference's +1-bin offset
    (PVModify.cpp:263-268, 287-302). mag, freq: [..., B]."""
    b = mag.shape[-1]
    dev = mag.device
    idx, mix, valid = _const_pairs(factor, b)
    i_hi = torch.from_numpy(idx).to(dev)
    i_lo = i_hi - 1
    mix_t = torch.from_numpy(mix).to(dev)
    clamp_hi = (b - 1 - 1e-4) * bin_width
    f32 = float(np.float32(factor))
    freq_mod = f32 * (torch.clamp(freq, 0.0, clamp_hi)
                      + float(np.float32(bin_width)))
    m_lo, m_hi = mag.index_select(-1, i_lo), mag.index_select(-1, i_hi)
    f_lo, f_hi = freq_mod.index_select(-1, i_lo), freq_mod.index_select(-1,
                                                                       i_hi)
    return _max_weight_pick(m_lo, m_hi, f_lo, f_hi, mix_t,
                            torch.from_numpy(valid).to(dev))


def modify_frequency_gather(mag: torch.Tensor, freq_modified: torch.Tensor,
                            bin_map: torch.Tensor, *,
                            interp: Callable = interpolators.linear):
    """Monotonic frequency remap (repitch / modify_frequency;
    flan_tpu/ops/pv_modify.py:179-219). mag, freq_modified: [C, F, B], the
    latter the mod applied to each MF's own frequency. bin_map: [F, B], each
    bin's mapped position in output bins, monotonic in B per frame.
    Returns (mag, freq) [C, F, B] under the max-weight endpoint policy."""
    c, f, b = mag.shape
    ys = float_iota(b, device=mag.device)
    idx, valid = _pair_lookup_rows(bin_map, ys)            # [F, B_out]
    lo = torch.gather(bin_map, 1, idx - 1)
    hi = torch.gather(bin_map, 1, idx)
    mix = _mix(ys, lo, hi, interp)
    i_lo, i_hi = (idx - 1).expand(c, f, b), idx.expand(c, f, b)
    return _max_weight_pick(
        torch.gather(mag, 2, i_lo), torch.gather(mag, 2, i_hi),
        torch.gather(freq_modified, 2, i_lo),
        torch.gather(freq_modified, 2, i_hi), mix,
        valid & (ys < b - 1))


def map_through_bins(freq: torch.Tensor, bin_map: torch.Tensor,
                     bin_width: float) -> torch.Tensor:
    """Each MF's frequency (freq [C, F, B]) mapped through the integrated
    bin map [F, B] (in bins, one row a frame): the map's Hz value linearly
    interpolated at the MF's fractional bin, clipped below the top bin
    (flan_tpu/pv/pv.py:227-241, flan_tpu/pipelines/streamed.py:431-445)."""
    c, f, b = freq.shape
    freq_map_hz = bin_map * bin_width
    fbin = torch.clamp(true_div(freq, bin_width), 0.0, b - 1 - 1e-4)
    lo = torch.floor(fbin).to(torch.int64)
    r = fbin - lo
    rows = freq_map_hz.expand(c, f, b)
    return (torch.gather(rows, 2, lo) * (1 - r)
            + torch.gather(rows, 2, lo + 1) * r)


def integrate_bins(factor: torch.Tensor) -> torch.Tensor:
    """The partial integral of a per-bin factor [F, B] over bins, the bin
    map of a repitch (PVModify.cpp:273-285), summed in float64 and rounded
    to float32: the same bits on every device (torch's CUDA cumsum sums in
    float32, its CPU cumsum in float64)."""
    return torch.cumsum(factor.to(torch.float64), dim=1).to(factor.dtype)
