"""PV time remap (counterpart of flan_tpu/ops/pv_modify.py:30-124;
reference: src/flan/PV/PVModify.cpp:307-362).

The reference walks adjacent input frame pairs and paints every integer
output frame in the mapped interval. For a monotonic map the painted
intervals partition the output axis, so the scatter inverts into a gather:
one searchsorted per output frame plus a weighted read of the surrounding
input pair, under the reference's weighted-frequency-sum policy (magnitude
is the weight sum, frequency the weighted average).

The gather runs in chunks of output frames. A 2x stretch of ten minutes of
stereo at 4096-point frames has [2, 450002, 2049] outputs, 7.4 GB per
plane; a literal transcription would make several temporaries of that
size, while a chunk bounds them at [C, chunk, B]. Each output frame
depends only on its own pair, so chunk boundaries change no value.
"""
from __future__ import annotations

from typing import Callable

import torch

from flan_tpu_torch.func import interpolators

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
        xs = torch.arange(x0, x0 + nx, dtype=torch.float32, device=dev)
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
