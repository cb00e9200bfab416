"""Streamed phase-vocoder pipelines: audio -> audio in O(chunk) device
memory (counterpart of flan_tpu/pipelines/streamed.py).

Any chain of

    STFT forward -> [monotonic time remap] -> [per-chunk spectral op]
    -> STFT inverse

runs chunk by chunk of output frames without materialising the full PV
planes (overlap factor x 2 larger than the audio: 23.8 GB peak for the
class path's 2x stretch of 600 s stereo, H100 80GB HBM3). Two states cross
from chunk to chunk: the per-bin cycle offset [C, B] and the overlap-add
tail [C, r, hop]. Each chunk rebuilds its analysis frames from the input,
with one helper hop before its first whose phase seeds the phase
difference and is then dropped.

Instantiations:
* pv_stretch_pipeline (pipelines/stretch.py): a time remap, no op;
* pv_repitch_pipeline: the identity map and a per-frame frequency remap
  (reference PVModify.cpp:273-305);
* pv_morph_pipeline: the identity map and a two-source amplitude blend
  (reference PV.cpp:205-236, replace_amplitudes semantics).

The remap plan is host numpy in float32 arithmetic, copied from the JAX
package so that both pick the same hops with the same mixes (remap_plan).
The JAX package's static-row plan, its A/B knobs and its chunk-op memo
exist for XLA on the TPU and have no counterpart here. On the card the
transforms run on cuFFT through torch.fft and the rest is PyTorch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func.function import as_function2d, broadcast_f32
from flan_tpu_torch.ops import pv_modify
from flan_tpu_torch.ops.stft import (_TWO_PI, _cdiv, _wrap_radians,
                                     bin_frequencies, cumsum_mod1_frames,
                                     irfft_polar, num_hops, rfft_mag_phase,
                                     true_div)
from flan_tpu_torch.ops.windows import hann_window

# Output frames per chunk unless the caller names a count. Device memory
# grows with it (about 21 [channels, chunk, bins] float32 planes at once)
# and the host's launch cost falls with it (~124 launches a chunk). The 2x
# stretch of 600 s stereo 48 kHz, dft 4096, on an H100 80GB HBM3 at
# 700 W, in two runs of chip_smoke.py phase 7: 2.6-5.7 s at 256 frames,
# 0.52-0.69 s at 2048 (1.2 GB above the input), 0.48-0.54 s at 4096
# (1.9 GB), 0.46-0.49 s at 8192 (3.3 GB).
DEFAULT_CHUNK_OUT = 4096


@dataclass(frozen=True)
class RemapPlan:
    """The host remap plan of a chunked monotonic time map
    (flan_tpu/pipelines/streamed.py:276-320, its dynamic form).

    i0       [nchunks] int32: each chunk's first input hop, less one;
    li       [nchunks, chunk_out] int32: each output frame's left hop,
             relative to the chunk's i0;
    mix      [nchunks, chunk_out] float32: the right hop's weight;
    valid    [nchunks, chunk_out] bool: the frame lies inside the map;
    out_frames, chunk_out, max_hops: output frames, frames per chunk, and
             input hops each chunk analyses (the helper hop included).
    """
    i0: np.ndarray
    li: np.ndarray
    mix: np.ndarray
    valid: np.ndarray
    out_frames: int
    chunk_out: int
    max_hops: int


def remap_plan(time_map: Optional[np.ndarray], nh: int,
               chunk_out: int) -> RemapPlan:
    """The remap plan for `nh` input hops. time_map: per-input-hop output
    positions in PV frames (float64 [nh], strictly increasing), or None for
    the identity, where output frame j reads input hop j with weight 1."""
    if time_map is None:
        # identity: with tm = [0, 1, ..., nh], searchsorted(j, right) =
        # j + 1, so the pair is (j, j + 1) with mix 0; the extra trailing
        # entry keeps frame nh - 1 inside the valid interval
        out_frames = nh
        chunk_out = min(chunk_out, max(out_frames, 1))
        tm = np.arange(nh + 1, dtype=np.float64)
        max_hops = chunk_out + 4
    else:
        tm = np.asarray(time_map, np.float64)
        out_frames = int(math.ceil(float(np.max(tm))))
        chunk_out = min(chunk_out, max(out_frames, 1))
        steps = np.diff(np.concatenate([[0.0], tm]))
        min_step = float(steps.min())
        if min_step <= 0:
            raise ValueError("time_map must be strictly increasing")
        max_hops = int(math.ceil(chunk_out / min_step)) + 4

    nchunks = _cdiv(out_frames, chunk_out)
    fpad = nchunks * chunk_out
    tm32 = tm.astype(np.float32)
    nt = tm32.shape[0]
    xs_idx = np.arange(fpad, dtype=np.float32)
    idx = np.clip(np.searchsorted(tm32, xs_idx, side="right"),
                  1, nt - 1).astype(np.int64)
    l = tm32[idx - 1]
    rr = tm32[idx]
    mix = np.clip((xs_idx - l) / np.where(rr == l, np.float32(1.0), rr - l),
                  np.float32(0.0), np.float32(1.0)).astype(np.float32)
    valid = ((xs_idx < out_frames) & (xs_idx >= tm32[0])
             & (xs_idx < tm32[nt - 1]))
    i0 = (idx.reshape(nchunks, chunk_out)[:, 0] - 1).astype(np.int32)
    li = np.clip(idx.reshape(nchunks, chunk_out) - 1
                 - i0[:, None].astype(np.int64),
                 0, max_hops - 3).astype(np.int32)
    return RemapPlan(i0=i0, li=li, mix=mix.reshape(nchunks, chunk_out),
                     valid=valid.reshape(nchunks, chunk_out),
                     out_frames=out_frames, chunk_out=chunk_out,
                     max_hops=max_hops)


def _span(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """x[:, start:start + length] of x [C, N], zero outside [0, N)."""
    n = x.shape[-1]
    lo, hi = max(start, 0), min(start + length, n)
    if hi <= lo:
        return x.new_zeros((x.shape[0], length))
    return torch.nn.functional.pad(x[:, lo:hi],
                                   (lo - start, start + length - hi))


def _as_inputs(xs, device) -> list:
    """The inputs as float32 [C, N] tensors on one device: a tensor keeps
    its device unless `device` is named, host data goes to `device` or the
    card."""
    out = []
    for x in xs:
        dev = device
        if not isinstance(x, torch.Tensor):
            dev = DEFAULT_DEVICE if dev is None else dev
            # torch takes no negative strides (a reversed numpy view)
            x = np.ascontiguousarray(x, dtype=np.float32)
        t = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if t.ndim != 2:
            raise ValueError(f"pipeline inputs are [channels, frames], got "
                             f"shape {tuple(t.shape)}")
        out.append(t)
    if len({t.device for t in out}) != 1:
        raise ValueError("pipeline inputs must lie on one device, got "
                         f"{sorted(str(t.device) for t in out)}")
    if len({t.shape[0] for t in out}) != 1:
        raise ValueError("streamed_pv_process requires equal channels")
    return out


@dataclass(frozen=True)
class _Geometry:
    """The chunk loop's constants, on the data's device."""
    window_size: int
    hop: int
    dft_size: int
    analysis_rate: float
    wpad: int                 # the window padded to whole hops
    r: int                    # hops a frame spans, wpad / hop
    window: torch.Tensor      # analysis hann window
    inv_window: torch.Tensor  # synthesis window with the 2.67 gain
    bin_freq: torch.Tensor
    expected: torch.Tensor    # expected phase advance a hop, radians


def _geometry(window_size: int, hop: int, dft_size: int, sample_rate: float,
              device) -> _Geometry:
    nbins = dft_size // 2 + 1
    analysis_rate = sample_rate / hop
    wpad = _cdiv(window_size, hop) * hop
    if wpad > dft_size:
        raise ValueError(f"window {window_size} padded to whole hops "
                         f"({wpad}) exceeds the dft size {dft_size}")
    bin_freq, expected = bin_frequencies(nbins, sample_rate / dft_size,
                                         analysis_rate, device=device)
    # the reference's 2.67 gain for FFTW's unnormalised c2r, with
    # torch.fft.irfft's 1/dft_size folded back in
    inv_window = torch.zeros(wpad, dtype=torch.float32, device=device)
    inv_window[:window_size] = hann_window(window_size, device) * (
        2.67 / (dft_size * window_size / hop) * dft_size)
    return _Geometry(window_size, hop, dft_size, analysis_rate, wpad,
                     wpad // hop, hann_window(window_size, device),
                     inv_window, bin_freq, expected)


def _analysis(g: _Geometry, xs: Sequence[torch.Tensor], i0: int, H: int):
    """(mag, freq) [n_in, C, H - 1, B] of input hops i0 .. i0 + H - 2: the
    frames of hops i0 - 1 .. i0 + H - 2 cut from the inputs, the first a
    helper hop whose phase seeds the phase difference and is dropped."""
    # H hops of r blocks each, overlapping: H + r - 1 blocks, and two more
    # as the JAX package cuts the span
    span_len = (H + g.r + 1) * g.hop
    start = (i0 - 1) * g.hop - g.window_size // 2
    frames = torch.stack([
        _span(x, start, span_len).unfold(-1, g.wpad, g.hop)[
            :, :H, :g.window_size] for x in xs]) * g.window
    mag, phase = rfft_mag_phase(frames, g.dft_size)
    prev = torch.nn.functional.pad(phase[:, :, :-1], (0, 0, 1, 0))
    # hops before the first have phase 0 (the reference's zero start)
    dead = max(0, 2 - i0)
    if dead > 1:
        prev[:, :, 1:dead] = 0.0
    delta = _wrap_radians(phase - prev - g.expected)
    freq = g.bin_freq + delta * (g.analysis_rate / _TWO_PI)
    return mag[:, :, 1:], freq[:, :, 1:]


def _remap(mag, freq, li, mix, valid):
    """The monotonic time remap of one chunk, weighted-frequency-sum
    policy (PVModify.cpp:344-355): output frame j reads hops li[j] and
    li[j] + 1 with weights 1 - mix[j] and mix[j]; frames outside the map
    are zero."""
    mix = mix[:, None]
    w0 = (1.0 - mix) * mag.index_select(2, li)
    w1 = mix * mag.index_select(2, li + 1)
    total = w0 + w1
    fsum = w0 * freq.index_select(2, li) + w1 * freq.index_select(2, li + 1)
    v = valid[:, None]
    pos = total > 0.0
    return (torch.where(v, total, 0.0),
            torch.where(v & pos, fsum / torch.where(pos, total, 1.0), 0.0))


def _synthesis(g: _Geometry, mag, freq, cycle):
    """The inverse of one chunk's planes [C, chunk, B]: mod-1 cycles from
    the offset the chunk before left (`cycle` [C, 1, B]), the polar irFFT,
    the synthesis window. Returns the frames [C, chunk, wpad] and the
    offset for the next chunk."""
    inc = torch.remainder(true_div(freq, g.analysis_rate), 1.0)
    cycles = torch.remainder(cumsum_mod1_frames(inc) + cycle, 1.0)
    frames = irfft_polar(mag, cycles * _TWO_PI,
                         g.dft_size)[..., :g.wpad] * g.inv_window
    return frames, cycles[:, -1:]


def _overlap_add(g: _Geometry, frames, tail):
    """One chunk's frames [C, chunk, wpad] overlap-added onto the tail the
    chunk before left [C, r, hop]: the chunk's audio [C, chunk * hop] and
    the new tail."""
    c, chunk, _ = frames.shape
    blocks = frames.reshape(c, chunk, g.r, g.hop)
    acc = torch.zeros((c, chunk + g.r, g.hop), dtype=torch.float32,
                      device=frames.device)
    acc[:, :g.r] = tail
    for j in range(g.r):
        acc[:, j:j + chunk] += blocks[:, :, j]
    return acc[:, :chunk].reshape(c, chunk * g.hop), acc[:, chunk:]


def _run_chunks(xs: Sequence[torch.Tensor], plan: RemapPlan, chunk_op, *,
                window_size: int, hop: int, dft_size: int,
                sample_rate: float) -> torch.Tensor:
    """The chunk loop (flan_tpu/pipelines/streamed.py:74-251): per chunk,
    _analysis, _remap, chunk_op, _synthesis and _overlap_add, the cycle
    offset and the tail carried to the next; then the window/2 shift."""
    c = xs[0].shape[0]
    dev = xs[0].device
    g = _geometry(window_size, hop, dft_size, sample_rate, dev)
    chunk = plan.chunk_out
    nchunks = plan.i0.shape[0]
    li_all = torch.from_numpy(plan.li.astype(np.int64)).to(dev)
    mix_all = torch.from_numpy(plan.mix).to(dev)
    valid_all = torch.from_numpy(plan.valid).to(dev)

    stream = torch.zeros((c, (nchunks * chunk + g.r) * hop),
                         dtype=torch.float32, device=dev)
    cycle = torch.zeros((c, 1, dft_size // 2 + 1), dtype=torch.float32,
                        device=dev)
    tail = torch.zeros((c, g.r, hop), dtype=torch.float32, device=dev)
    for k in range(nchunks):
        mag, freq = _analysis(g, xs, int(plan.i0[k]), plan.max_hops)
        s_mag, s_freq = _remap(mag, freq, li_all[k], mix_all[k],
                               valid_all[k])
        if chunk_op is not None:
            s_mag, s_freq = chunk_op(s_mag, s_freq, k * chunk)
        else:
            s_mag, s_freq = s_mag[0], s_freq[0]
        frames, cycle = _synthesis(g, s_mag, s_freq, cycle)
        stream[:, k * chunk * hop:(k + 1) * chunk * hop], tail = \
            _overlap_add(g, frames, tail)
    stream[:, nchunks * chunk * hop:] = tail.reshape(c, g.r * hop)
    shift = window_size // 2
    return stream[:, shift:shift + plan.out_frames * hop]


def streamed_pv_process(xs: Sequence, chunk_op: Optional[Callable] = None,
                        *, time_map: Optional[np.ndarray] = None,
                        window_size: int = 2048, hop: int = 128,
                        dft_size: int = 4096, sample_rate: float = 48000.0,
                        chunk_out: Optional[int] = None,
                        device=None) -> torch.Tensor:
    """Stream inputs through forward PV -> remap -> op -> inverse PV.

    xs: [C, N] audio tensors or arrays with equal channel counts; a shorter
    input reads as zeros past its end. chunk_op(mags, freqs, frame0) takes
    the stacked [n_in, C, chunk, B] remapped planes and the chunk's first
    output frame and returns one (mag, freq) pair [C, chunk, B]; None
    passes input 0 through. time_map: per-input-hop monotonic output
    positions in PV frames (float64 [nh]); None is the identity. Tensors
    keep their device unless `device` is named; host arrays go to `device`
    or the card. Returns [C, out_frames * hop] on that device."""
    xs = _as_inputs(xs, device)
    n = max(int(x.shape[-1]) for x in xs)
    plan = remap_plan(time_map, num_hops(n, hop),
                      DEFAULT_CHUNK_OUT if chunk_out is None else chunk_out)
    return _run_chunks(xs, plan, chunk_op, window_size=window_size, hop=hop,
                       dft_size=dft_size, sample_rate=float(sample_rate))


def _frame_grid(f0: int, chunk: int, nbins: int, bin_width: float,
                analysis_rate: float, device):
    """(t [chunk, 1], f [1, B]): the chunk's frame times (f0 + j) /
    analysis_rate and the bin frequencies, float32."""
    t = true_div(f0 + float_iota(chunk, device=device), analysis_rate)
    fr = float_iota(nbins, device=device) * bin_width
    return t[:, None], fr[None, :]


def pv_repitch_pipeline(x, factor, *, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0,
                        chunk_out: Optional[int] = None,
                        device=None) -> torch.Tensor:
    """Streamed PV repitch of x [C, N]: a per-frame monotonic frequency
    remap (reference PVModify.cpp:273-305) without materialising the PV.
    factor: a positive constant, or a Function of (t, f) evaluated on
    tensors on the data's device."""
    chunk_op = _repitch_chunk_op(factor, sample_rate / dft_size,
                                 sample_rate / hop)
    return streamed_pv_process(
        [x], chunk_op, window_size=window_size, hop=hop, dft_size=dft_size,
        sample_rate=sample_rate, chunk_out=chunk_out, device=device)


def _repitch_chunk_op(factor, bin_width: float, analysis_rate: float):
    """The repitch chunk op (flan_tpu/pipelines/streamed.py:420-462): a
    constant factor takes the host-planned gather, any other the bin map
    integrated per frame."""
    fn = as_function2d(factor)
    if fn.is_constant:
        f = float(fn.constant_value)
        return lambda mags, freqs, f0: \
            pv_modify.modify_frequency_gather_const(mags[0], freqs[0], f,
                                                    bin_width)

    def chunk_op(mags, freqs, f0):
        mag, freq = mags[0], freqs[0]
        _, chunk, b = mag.shape
        t, fr = _frame_grid(f0, chunk, b, bin_width, analysis_rate,
                            mag.device)
        bin_map = pv_modify.integrate_bins(
            broadcast_f32(fn(t, fr), (chunk, b), mag.device))
        freq_modified = pv_modify.map_through_bins(freq, bin_map, bin_width)
        return pv_modify.modify_frequency_gather(mag, freq_modified,
                                                 bin_map)
    return chunk_op


def pv_morph_pipeline(a, b, amount, *, window_size: int = 2048,
                      hop: int = 128, dft_size: int = 4096,
                      sample_rate: float = 48000.0,
                      chunk_out: Optional[int] = None,
                      device=None) -> torch.Tensor:
    """Streamed two-source spectral morph with replace_amplitudes
    semantics (reference PV.cpp:205-236): magnitudes blend toward b's by
    amount(t, f) clipped to [0, 1], frequencies stay a's. Past the shorter
    source's frames the planes are zero, as replace_amplitudes zero-fills
    beyond its overlap."""
    a, b = _as_inputs([a, b], device)
    min_nh = min(num_hops(int(a.shape[-1]), hop),
                 num_hops(int(b.shape[-1]), hop))
    fn = as_function2d(amount)
    bin_width, analysis_rate = sample_rate / dft_size, sample_rate / hop

    def chunk_op(mags, freqs, f0):
        _, _, chunk, nb = mags.shape
        t, fr = _frame_grid(f0, chunk, nb, bin_width, analysis_rate,
                            mags.device)
        amt = torch.clamp(broadcast_f32(fn(t, fr), (chunk, nb),
                                        mags.device), 0.0, 1.0)
        mag = mags[1] * amt + mags[0] * (1.0 - amt)
        live = (f0 + torch.arange(chunk, device=mags.device)
                < min_nh)[:, None]
        return (torch.where(live, mag, 0.0),
                torch.where(live, freqs[0], 0.0))

    return streamed_pv_process(
        [a, b], chunk_op, window_size=window_size, hop=hop, dft_size=dft_size,
        sample_rate=sample_rate, chunk_out=chunk_out)
