"""Sequence-parallel phase vocoder: audio sharded along time over ranks
(counterpart of flan_tpu/parallel/stft_sp.py).

* pv_forward_sp: each rank owns a contiguous span of PV hops. Its analysis
  windows reach window/2 samples past the span, so neighbours hand each
  other halo blocks (ppermute); one helper hop before the first gives the
  previous phase, so no rank waits on another.
* pv_inverse_sp: the mod-1 cycle accumulation needs a global prefix. Each
  rank scans its frames, the per-rank totals ([ranks, C, B]) are gathered,
  and each rank adds the exclusive prefix of its predecessors, summed in
  rank order. The overlap-add tail goes to the right neighbour.
* stretch_sp and streamed_sp_process shard by OUTPUT frames: the monotone
  time map gives each rank a contiguous range of input hops, planned on
  the host, and each rank analyses that range from the audio itself. Every
  rank holds the whole input (the functions are called on every rank with
  the same global arguments), so the all_gather of the raw audio that the
  JAX kernels start with has nothing to do here.
* streamed_sp_process runs each rank's span in chunks of output frames
  (pipelines/streamed.py's stages), in two passes: the first sums the
  rank's mod-1 cycle total without synthesis, the totals are gathered, and
  the second synthesises from the rank's exclusive prefix.

Every function is called on every rank with the same global arguments and
returns the global result on every rank, on the mesh's device. Padding,
raised errors and output lengths are the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flan_tpu_torch.ops import pv_stages
from flan_tpu_torch.ops.stft import _cdiv, num_hops
from flan_tpu_torch.parallel.mesh import (Mesh, all_gather, from_last,
                                          gather_time, shard_time,
                                          shift_left, shift_right)
from flan_tpu_torch.pipelines.streamed import (_analysis, _as_inputs,
                                               _geometry, _morph_chunk_op,
                                               _overlap_add,
                                               _repitch_chunk_op, _synthesis,
                                               _window)
from flan_tpu_torch.pipelines.stretch import stretch_factors


def _prefix(mesh: Mesh, total: torch.Tensor) -> torch.Tensor:
    """The exclusive prefix of the ranks' totals, summed in rank order from
    0, modulo 1."""
    totals = all_gather(mesh, total)
    prefix = torch.zeros_like(total)
    for i in range(mesh.rank):
        prefix = prefix + totals[i]
    return torch.remainder(prefix, 1.0)


def _hand_over_tail(mesh: Mesh, g, audio: torch.Tensor, tail: torch.Tensor):
    """Add the left neighbour's overlap-add tail onto the first r hops of
    this rank's audio [C, frames * hop]; the whole stream on every rank,
    the last rank's tail appended."""
    c = audio.shape[0]
    audio[:, :g.r * g.hop] += shift_right(mesh, tail).reshape(c, -1)
    last = from_last(mesh, tail)
    return torch.cat([gather_time(mesh, audio), last.reshape(c, -1)], dim=-1)


def pv_forward_sp(x, mesh: Mesh, *, window_size: int = 2048,
                  hop: int = 128, dft_size: int = 4096,
                  sample_rate: float = 48000.0, axis: str = "sp"):
    """Audio [C, N] -> (mag, freq) [C, nh_padded, B], the hops sharded.
    Rows past num_hops(N, hop) are padding (a zero signal)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    c, n = x.shape
    d = mesh.shape[axis]
    nh_local = _cdiv(num_hops(n, hop), d)
    n_local = nh_local * hop
    g = _geometry(window_size, hop, dft_size, sample_rate, mesh.device)
    # the halo: window/2 + hop to the left (the helper hop's window),
    # window/2 to the right; one symmetric block, within a neighbour's span
    halo = window_size // 2 + hop
    if halo > n_local:
        raise ValueError(
            "shard too small for the analysis window halo; use fewer "
            "devices or longer audio")
    x_l = shard_time(mesh, torch.nn.functional.pad(
        x, (0, n_local * d - n))).to(mesh.device)
    # the span is zero outside the signal: rank 0's left halo, the last
    # rank's right halo and the padding past N
    span = torch.cat([shift_right(mesh, x_l[:, -halo:]), x_l,
                      shift_left(mesh, x_l[:, :halo])], dim=-1)
    # local hop j - 1 (j = 0 the helper) starts at span sample j * hop
    frames = span.unfold(-1, window_size, hop)[:, :nh_local + 1] * g.window
    spec = torch.fft.rfft(frames, n=dft_size, dim=-1)
    # hops before the first have phase 0 (the reference's zero start)
    mag, freq, _ = pv_stages.analysis(
        spec, g.bin_freq, g.expected, g.analysis_rate,
        dead=max(0, 2 - mesh.rank * nh_local))
    return (gather_time(mesh, mag.contiguous(), axis=1),
            gather_time(mesh, freq.contiguous(), axis=1))


def pv_inverse_sp(mag, freq, mesh: Mesh, *, window_size: int = 2048,
                  hop: int = 128, sample_rate: float = 48000.0,
                  axis: str = "sp"):
    """(mag, freq) [C, F, B], the frames sharded -> audio [C, F * hop].
    F must divide by the mesh (pad the frames with zero magnitude)."""
    mag = torch.as_tensor(mag, dtype=torch.float32)
    freq = torch.as_tensor(freq, dtype=torch.float32)
    c, f, nbins = mag.shape
    d = mesh.shape[axis]
    if f % d:
        raise ValueError(f"{f} PV frames do not split over {d} ranks: pad "
                         "PV frames to a multiple of the mesh size")
    g = _geometry(window_size, hop, 2 * (nbins - 1), sample_rate,
                  mesh.device)
    if g.r > f // d:
        raise ValueError("shard too small for the overlap-add tail")
    m_l = shard_time(mesh, mag, axis=1).to(mesh.device)
    f_l = shard_time(mesh, freq, axis=1).to(mesh.device)
    # the rank's last cycle from 0 (one walk, nothing written), then the
    # spectrum from the ranks' prefix
    _, last = pv_stages.synthesis(m_l, f_l, None, g.analysis_rate,
                                  write=False)
    spec, _ = pv_stages.synthesis(m_l, f_l, _prefix(mesh, last),
                                  g.analysis_rate)
    audio, tail = _overlap_add(g, _window(g, spec),
                               m_l.new_zeros((c, g.r, hop)))
    stream = _hand_over_tail(mesh, g, audio, tail)
    shift = window_size // 2
    return stream[:, shift:shift + f * hop]


def _output_plan(time_map: np.ndarray, out_frames: int, fpad: int):
    """The host gather plan of output frames 0 .. fpad - 1 through the
    monotone time map, in float64 (stft_sp.py:249-256, :532-538): each
    frame's left input hop (idx - 1), the right hop's weight, and whether
    the frame lies inside the map."""
    nt = time_map.shape[0]
    xs = np.arange(fpad, dtype=np.float64)
    raw_idx = np.searchsorted(time_map, xs, side="right")
    valid = ((raw_idx >= 1) & (raw_idx <= nt - 1) & (xs < out_frames)
             & (xs >= time_map[0]))
    idx = np.clip(raw_idx, 1, nt - 1)
    left = time_map[idx - 1]
    right = time_map[idx]
    mix = np.clip((xs - left) / np.where(right == left, 1.0, right - left),
                  0.0, 1.0)
    return idx, mix, valid


def stretch_sp(x, mesh: Mesh, *, factor, window_size: int = 2048,
               hop: int = 128, dft_size: int = 4096,
               sample_rate: float = 48000.0, axis: str = "sp"):
    """Sequence-parallel PV time-stretch, audio [C, N] -> audio, the PV
    planes of each rank's output span held whole. Each rank owns a
    contiguous span of output frames and analyses the contiguous range of
    input hops they read. Matches Audio.convert_to_PV >> stretch >>
    convert_to_audio for monotone maps."""
    x = torch.as_tensor(x, dtype=torch.float32).to(mesh.device)
    c, n = x.shape
    d = mesh.shape[axis]
    nh = num_hops(n, hop)
    time_map = np.cumsum(stretch_factors(factor, nh, hop, sample_rate,
                                         mesh.device, "stretch_sp"))
    out_frames = int(math.ceil(time_map.max()))
    oh_local = _cdiv(out_frames, d)
    g = _geometry(window_size, hop, dft_size, sample_rate, mesh.device)
    if oh_local < g.r:
        raise ValueError(
            "output shard shorter than the overlap-add tail; use fewer "
            "devices or longer audio")
    idx, mix, valid = _output_plan(time_map, out_frames, oh_local * d)
    idx_s = idx.reshape(d, oh_local)
    lo = idx_s.min(axis=1) - 1                  # first input hop read
    h_count = int((idx_s.max(axis=1) - lo).max()) + 2   # + pair, + helper
    span = slice(mesh.rank * oh_local, (mesh.rank + 1) * oh_local)
    li = torch.from_numpy(idx_s[mesh.rank] - 1 - lo[mesh.rank]).to(
        mesh.device)
    mag, freq = _analysis(g, [x], int(lo[mesh.rank]), h_count)
    plan = (li,
            torch.from_numpy(mix[span].astype(np.float32)).to(mesh.device),
            torch.from_numpy(valid[span]).to(mesh.device))
    # the remap fused into H2: the rank's last cycle from 0, then the
    # spectrum from the ranks' prefix
    _, last = pv_stages.synthesis(mag[0], freq[0], None, g.analysis_rate,
                                  plan=plan, write=False)
    spec, _ = pv_stages.synthesis(mag[0], freq[0], _prefix(mesh, last),
                                  g.analysis_rate, plan=plan)
    audio, tail = _overlap_add(g, _window(g, spec),
                               x.new_zeros((c, g.r, hop)))
    stream = _hand_over_tail(mesh, g, audio, tail)
    shift = window_size // 2
    return stream[:, shift:shift + out_frames * hop]


def streamed_sp_process(xs_list, mesh: Mesh, chunk_op=None, *,
                        time_map=None, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0, axis: str = "sp",
                        chunk_out: int = 256):
    """Sequence-parallel AND streamed PV pipeline: each rank runs the
    O(chunk)-memory chunk loop of pipelines/streamed.py over its own span
    of output frames.

    xs_list: [C, N] inputs with equal channels (shorter ones read as zeros
    past their end); chunk_op(mags, freqs, f0) -> (mag, freq) as
    pipelines/streamed.py's, f0 the chunk's first GLOBAL output frame;
    time_map: per-input-hop monotone output positions (None: the
    identity, frame-aligned ops).

    The mod-1 cycle total of a rank is known only after its chunks are
    scanned, so the loop runs twice: pass 1 analyses, remaps and applies
    the op to sum the rank's total (no synthesis), one all_gather of the
    [ranks, C, B] totals gives each rank its prefix, and pass 2 repeats the
    chunks and synthesises from that prefix. The last chunk's overlap-add
    tail goes to the right neighbour."""
    if len({int(x.shape[0]) for x in xs_list}) != 1:
        raise ValueError("streamed_sp_process requires equal channels")
    xs = _as_inputs(xs_list, mesh.device)
    n = max(int(x.shape[-1]) for x in xs)
    c = int(xs[0].shape[0])
    d = mesh.shape[axis]
    nh = num_hops(n, hop)
    if time_map is None:
        # the identity plan: output frame j is input hop j, the trailing
        # entry keeps frame nh - 1 inside the map
        tm = np.arange(nh + 1, dtype=np.float64)
        out_frames = nh
    else:
        tm = np.asarray(time_map, np.float64)
        out_frames = int(math.ceil(float(np.max(tm))))

    # ---- host: the chunked gather plan, sharded by output span ----
    nchunks_local = _cdiv(_cdiv(out_frames, d), chunk_out)
    oh_local = nchunks_local * chunk_out
    nchunks = nchunks_local * d
    idx, mix, valid = _output_plan(tm, out_frames, oh_local * d)
    idx_c = idx.reshape(nchunks, chunk_out)
    i0 = idx_c[:, 0] - 1
    h_count = int((idx_c.max(axis=1) - i0).max()) + 2   # + pair, + helper
    g = _geometry(window_size, hop, dft_size, sample_rate, mesh.device)
    if oh_local < g.r:
        raise ValueError("output shard shorter than the overlap-add tail; "
                         "use fewer devices or longer audio")
    mine = range(mesh.rank * nchunks_local, (mesh.rank + 1) * nchunks_local)
    li = torch.from_numpy(idx_c - 1 - i0[:, None]).to(mesh.device)
    mix_d = torch.from_numpy(mix.reshape(nchunks, chunk_out).astype(
        np.float32)).to(mesh.device)
    valid_d = torch.from_numpy(valid.reshape(nchunks, chunk_out)).to(
        mesh.device)

    def chunk(k: int):
        mag, freq = _analysis(g, xs, int(i0[k]), h_count)
        s_mag, s_freq = pv_stages.remap(mag, freq, li[k], mix_d[k],
                                         valid_d[k])
        if chunk_op is not None:
            return chunk_op(s_mag, s_freq, k * chunk_out)
        return s_mag[0], s_freq[0]

    # ---- pass 1: this rank's mod-1 cycle total, no synthesis ----
    nbins = dft_size // 2 + 1
    total = torch.zeros((c, 1, nbins), dtype=torch.float32,
                        device=mesh.device)
    for k in mine:
        _, total = pv_stages.synthesis(*chunk(k), total, g.analysis_rate,
                                       write=False)

    # ---- pass 2: the chunks synthesised from the rank's prefix ----
    cycle = _prefix(mesh, total)
    tail = total.new_zeros((c, g.r, hop))
    audio = total.new_empty((c, oh_local * hop))
    step = chunk_out * hop
    for j, k in enumerate(mine):
        s_mag, s_freq = chunk(k)
        frames, cycle = _synthesis(g, s_mag, s_freq, cycle)
        audio[:, j * step:(j + 1) * step], tail = _overlap_add(g, frames,
                                                               tail)
    stream = _hand_over_tail(mesh, g, audio, tail)
    shift = window_size // 2
    return stream[:, shift:shift + out_frames * hop]


def stretch_sp_streamed(x, mesh: Mesh, *, factor, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0, axis: str = "sp",
                        chunk_out: int = 256):
    """Sequence-parallel AND streamed PV time-stretch: streamed_sp_process
    on the monotone time map of the factors."""
    x = torch.as_tensor(x, dtype=torch.float32)
    factors = stretch_factors(factor, num_hops(int(x.shape[-1]), hop), hop,
                              sample_rate, mesh.device,
                              "stretch_sp_streamed")
    return streamed_sp_process(
        [x], mesh, None, time_map=np.cumsum(factors),
        window_size=window_size, hop=hop, dft_size=dft_size,
        sample_rate=sample_rate, axis=axis, chunk_out=chunk_out)


def repitch_sp_streamed(x, mesh: Mesh, *, factor, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0, axis: str = "sp",
                        chunk_out: int = 256):
    """Sequence-parallel streamed PV repitch (reference
    PVModify.cpp:273-305) on the identity time map, with the chunk op of
    pipelines/streamed.py pv_repitch_pipeline."""
    chunk_op = _repitch_chunk_op(factor, sample_rate / dft_size,
                                 sample_rate / hop)
    return streamed_sp_process(
        [x], mesh, chunk_op, time_map=None, window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=sample_rate, axis=axis,
        chunk_out=chunk_out)


def morph_sp_streamed(a, b, mesh: Mesh, *, amount, window_size: int = 2048,
                      hop: int = 128, dft_size: int = 4096,
                      sample_rate: float = 48000.0, axis: str = "sp",
                      chunk_out: int = 256):
    """Sequence-parallel streamed two-source spectral morph (reference
    PV.cpp:205-236, replace_amplitudes semantics), with the chunk op of
    pipelines/streamed.py pv_morph_pipeline."""
    min_nh = min(num_hops(int(a.shape[-1]), hop),
                 num_hops(int(b.shape[-1]), hop))
    chunk_op = _morph_chunk_op(amount, min_nh, sample_rate / dft_size,
                               sample_rate / hop)
    return streamed_sp_process(
        [a, b], mesh, chunk_op, time_map=None, window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=sample_rate, axis=axis,
        chunk_out=chunk_out)
