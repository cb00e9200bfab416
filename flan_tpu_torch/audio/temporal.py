"""Audio temporal methods: boundaries, cuts, fades, silence, splits,
rearrangement, repitch, iteration and the cross-feedback stereo delay
(counterpart of flan_tpu/audio/temporal.py; reference:
src/flan/Audio/AudioTemporal.cpp). Bound onto Audio in audio/__init__.py.

Host work stays on the host as in the JAX package: the noisy-frame masks'
chunk bounds, the random draws (np.random.default_rng(seed), so a seed
gives the JAX package's chunks), and the WDL resampler's feed plan of
repitch (_wdl_sinc_plan, copied with its arithmetic unchanged: a Python
loop over blocks and output frames). The samples stay on the audio's
device: the repitch gather is ops/resample.py fractional_gather, the
constant stereo delay one linear recurrence on ops/scan.py, the swept one
the sequential kernel of ops/sequential_kernels.py stereo_delay_swept.
`delay` runs on synthesis.texture in the JAX package and is not here yet.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops import resample as resample_ops
from flan_tpu_torch.ops.stft import true_div


def _null():
    from flan_tpu_torch.audio.audio import Audio
    return Audio.create_null()


def modify_boundaries_frames(self, start: int, end: int):
    """Pad or trim both ends: the output covers frames [start, num_frames +
    end) of the input, zeros outside it (reference
    AudioTemporal.cpp:96-114)."""
    if self.is_null():
        return _null()
    num_out = -start + self.num_frames + end
    if num_out <= 0:
        return _null()
    out = torch.zeros((self.num_channels, num_out), dtype=torch.float32,
                      device=self.device)
    src_lo = max(start, 0)
    src_hi = min(self.num_frames, num_out + start)
    if src_hi > src_lo:
        dst_lo = src_lo - start
        out[:, dst_lo:dst_lo + (src_hi - src_lo)] = self.data[:, src_lo:src_hi]
    return self._with(data=out)


def modify_boundaries(self, start: float, end: float):
    return modify_boundaries_frames(self, self.time_to_frame(start),
                                    self.time_to_frame(end))


def cut_frames(self, start: int, end: int, start_fade: int = 0,
               end_fade: int = 0):
    """Keep frames [start, end), clamped into the audio, with sqrt fades
    (reference AudioTemporal.cpp:207-234)."""
    if self.is_null() or end <= start:
        return _null()
    start = int(np.clip(start, 0, self.num_frames - 1))
    end = int(np.clip(end, 0, self.num_frames - 1))
    if end <= start:
        return _null()
    out = self._with(data=self.data[:, start:end])
    return fade_frames(out, start_fade, end_fade, interpolators.sqrt)


def cut(self, start: float, end: float, start_fade: float = 0.0,
        end_fade: float = 0.0):
    return cut_frames(self, self.time_to_frame(start),
                      self.time_to_frame(end),
                      self.time_to_frame(start_fade),
                      self.time_to_frame(end_fade))


def _ramp(frames: int, interp, device) -> torch.Tensor:
    """interp over i / frames for i < frames, float32 on `device`."""
    return interp(true_div(float_iota(frames, device=device), frames))


def fade_frames(self, start: int = 16, end: int = 16,
                interp=interpolators.sqrt):
    """Fade in over the first `start` frames and out over the last `end`,
    shaped by interp (sqrt: constant power), shrunk in proportion where
    they overlap (reference AudioVolume.cpp fades)."""
    if self.is_null():
        return self
    n = self.num_frames
    start = int(np.clip(start, 0, n))
    end = int(np.clip(end, 0, n))
    if start + end > n:
        scale = n / (start + end)
        start = int(start * scale)
        end = n - start
    env = torch.ones((n,), dtype=torch.float32, device=self.device)
    if start > 0:
        env[:start] = _ramp(start, interp, self.device)
    if end > 0:
        env[n - end:] = _ramp(end, interp, self.device).flip(0)
    return self._with(data=self.data * env[None, :])


def fade(self, start: float = 16.0 / 48000.0, end: float = 16.0 / 48000.0,
         interp=interpolators.sqrt):
    return fade_frames(self, self.time_to_frame(start),
                       self.time_to_frame(end), interp)


def _noisy_mask(self, non_silent_level: float) -> np.ndarray:
    """Each frame: is any channel above the level (reference
    AudioTemporal.cpp:24-39), on the host."""
    return (self.data > non_silent_level).any(dim=0).cpu().numpy()


def remove_edge_silence(self, non_silent_level: float,
                        fade_in_time: float = 0.0):
    """Cut from the first noisy frame to the last, with fades into the
    silence kept (reference AudioTemporal.cpp:124-153)."""
    if self.is_null():
        return _null()
    idx = np.nonzero(_noisy_mask(self, non_silent_level))[0]
    if len(idx) == 0:
        return _null()
    start_frame, end_frame = int(idx[0]), int(idx[-1]) + 1
    fade_n = self.time_to_frame(fade_in_time)
    start_fade = min(start_frame, fade_n)
    end_fade = min(self.num_frames - end_frame, fade_n)
    return cut_frames(self, start_frame - fade_n, end_frame + fade_n,
                      start_fade, end_fade)


def _loud_chunk_bounds(self, non_silent_level: float, minimum_gap: float
                       ) -> List[tuple]:
    """[start, last noisy + 1) spans separated by more than the gap's quiet
    frames; the last one runs to the end when the audio ends within a gap
    of it (reference get_loud_chunks_base, AudioTemporal.cpp:10-50)."""
    idx = np.nonzero(_noisy_mask(self, non_silent_level))[0]
    gap_frames = self.time_to_frame(minimum_gap)
    if len(idx) == 0:
        return []
    splits = np.nonzero(np.diff(idx) > gap_frames)[0]
    starts = np.concatenate([[idx[0]], idx[splits + 1]])
    ends = np.concatenate([idx[splits], [idx[-1]]])
    bounds = list(zip(starts.tolist(), (ends + 1).tolist()))
    if self.num_frames - bounds[-1][1] <= gap_frames:
        bounds[-1] = (bounds[-1][0], self.num_frames)
    return bounds


def get_loud_chunks(self, non_silent_level: float, minimum_gap: float,
                    fade_in_time: float = 0.0):
    bounds = _loud_chunk_bounds(self, non_silent_level, minimum_gap)
    fade_n = self.time_to_frame(fade_in_time)
    chunks = []
    for a, b in bounds:
        lf = min(a, fade_n)
        rf = min(self.num_frames - b, fade_n)
        chunks.append(cut_frames(self, a - lf, b + rf, lf, rf))
    return chunks


def remove_silence(self, non_silent_level: float, minimum_gap: float,
                   fade_in_time: float = 0.0):
    """The loud chunks joined, their fades overlapping (reference
    AudioTemporal.cpp:164-172)."""
    from flan_tpu_torch.audio.audio import Audio
    chunks = get_loud_chunks(self, non_silent_level, minimum_gap,
                             fade_in_time)
    if not chunks:
        return _null()
    return Audio.join(chunks, offset=-2.0 * fade_in_time)


def split_at_times(self, split_times: Sequence[float], fade: float = 0.0):
    """(reference AudioTemporal.cpp:409-438)"""
    if self.is_null():
        return []
    fade_n = self.time_to_frame(fade)
    frames = [0]
    for t in sorted(split_times):
        f = self.time_to_frame(t)
        if f <= 0:
            continue
        if f >= self.num_frames:
            break
        frames.append(f)
    frames.append(self.num_frames)
    return [cut_frames(self, a, b, fade_n, fade_n)
            for a, b in zip(frames, frames[1:])]


def split_with_lengths(self, split_lengths: Sequence[float],
                       fade: float = 0.0):
    lengths = [max(0.0, t) for t in split_lengths]
    return split_at_times(self, list(np.cumsum(lengths)), fade)


def split_with_equal_lengths(self, slice_length: float, fade: float = 0.0):
    if slice_length <= 0:
        return []
    count = int(math.ceil(self.length / slice_length))
    return split_with_lengths(self, [slice_length] * count, fade)


def rearrange(self, slice_length: float, fade: float = 0.0, *, seed=None):
    """Equal slices shuffled and joined with crossfades (reference
    AudioTemporal.cpp:463-482); the shuffle draws from
    np.random.default_rng(seed), as the JAX package's does."""
    from flan_tpu_torch.audio.audio import Audio
    if self.is_null():
        return _null()
    chops = split_with_equal_lengths(self, slice_length + fade, fade)
    if len(chops) < 2:
        return _null()
    chops.pop()     # the final slice is usually short
    np.random.default_rng(seed).shuffle(chops)
    return Audio.join(chops, offset=-fade)


def _eval_scalar(fn, t: float) -> float:
    """A Function at one time, on the host."""
    if fn.is_constant:
        return fn.constant_value
    v = fn(torch.tensor(t, dtype=torch.float32))
    return float(torch.as_tensor(v).reshape(()))


def random_chunks(self, length: float, chunk_length, fade=0.0, mod=None,
                  *, seed=None):
    """Random chunks of the source joined with crossfades to `length`
    seconds (reference AudioTemporal.cpp:484-546); chunk starts integrate
    1 / chunk_length on the host, positions draw from
    np.random.default_rng(seed)."""
    from flan_tpu_torch.audio.audio import Audio
    if self.is_null() or length <= 0:
        return _null()
    chunk_fn = as_function(chunk_length)
    fade_fn = as_function(fade)
    sr = self.sample_rate
    total_frames = self.time_to_frame(length)
    starts = [0]
    frame = 0
    while frame < total_frames:
        cl = float(np.clip(_eval_scalar(chunk_fn, frame / sr),
                           32 / sr, max(self.length, 32 / sr)))
        step = int(np.clip(round(cl * sr), 32, total_frames))
        frame += step
        starts.append(min(frame, total_frames))
    sizes = np.diff(starts)
    fades = [float(max(0.0, _eval_scalar(fade_fn, s / sr))) for s in starts]
    rng = np.random.default_rng(seed)
    chunks = []
    for i, size in enumerate(sizes):
        desired = int(size + self.time_to_frame(
            (fades[i] + fades[i + 1]) / 2))
        if desired >= self.num_frames:
            start_frame = 0
        else:
            start_frame = int(rng.integers(0, self.num_frames - desired))
        chunk = cut_frames(self, start_frame, start_frame + desired,
                           self.time_to_frame(fades[i]),
                           self.time_to_frame(fades[i + 1]))
        if mod is not None:
            chunk = mod(chunk, starts[i] / sr)
        chunks.append(chunk)
    return Audio.join(chunks, offsets=[-f for f in fades])


def _wdl_sinc_plan(num_frames: int, gran: int, rates_inv: np.ndarray,
                   is_constant: bool):
    """Host simulation of the reference repitch's feed loop
    (AudioTemporal.cpp:236-299 driving WDL resample.cpp in sinc mode,
    SetMode(true, 0, true, 64)), copied from flan_tpu/audio/temporal.py:
    266-355 with its arithmetic unchanged; see the docstring there. The
    resampler is fed gran-frame output blocks, the rate chosen by the feed
    head, which runs ahead of the read head by the buffer's fill; the loop
    ends when the feed head passes the input's end; the two-slice sinc
    reads global position window_start + srcpos + 31.

    Returns (positions, rates): float64 [num_out] input read positions
    (-1e9 for frames never written: the gather reads zeros there) and each
    frame's ratio (for the anti-alias cutoff 1 / (1.03 ratio))."""
    SINC = 64
    HFS = SINC // 2
    nblocks = len(rates_inv)
    if is_constant:
        acc = np.float32(rates_inv[0]) * np.float32(nblocks)
    else:
        acc = np.float32(0.0)
        for v in rates_inv:
            acc = np.float32(acc + np.float32(v))
    num_out = int(np.ceil(np.float32(acc * np.float32(gran))))

    pos = np.full(num_out, -1e9, np.float64)
    rate = np.ones(num_out, np.float64)
    buf_pos = np.full(gran, -1e9, np.float64)
    buf_rate = np.ones(gran, np.float64)

    samples_in = 0
    fracpos = 0.0
    win = 0
    in_frame = 0
    out_frame = 0
    while in_frame < num_frames:
        fi = min(int(in_frame / float(gran)), nblocks - 1)
        ratio = 1.0 / float(rates_inv[fi])
        if samples_in < HFS - 1:
            win -= (HFS - 1) - samples_in
            samples_in = HFS - 1
        sreq = int(ratio * gran) + 4 + SINC - samples_in
        if sreq < 0:
            sreq = 0
        if sreq == 0:
            break
        samples_in += sreq
        filtlen = samples_in - SINC
        srcpos = fracpos
        for j in range(gran):
            ipos = int(srcpos)
            if ipos >= filtlen - 1:
                break
            buf_pos[j] = win + srcpos + (HFS - 1)
            buf_rate[j] = ratio
            srcpos += ratio
        ncopy = min(gran, num_out - out_frame)
        if ncopy > 0:
            pos[out_frame:out_frame + ncopy] = buf_pos[:ncopy]
            rate[out_frame:out_frame + ncopy] = buf_rate[:ncopy]
        out_frame += gran
        in_frame += sreq
        isrcpos = int(srcpos)
        if isrcpos > samples_in:
            isrcpos = samples_in
        fracpos = srcpos - isrcpos
        samples_in -= isrcpos
        if samples_in < 0:
            samples_in = 0
        win += isrcpos
    return pos, rate


def _host_sample(fn, t: np.ndarray) -> np.ndarray:
    """A callable Function on a float32 host grid, as a float32 array."""
    out = fn(torch.from_numpy(np.ascontiguousarray(t, np.float32)))
    return np.broadcast_to(torch.as_tensor(out, dtype=torch.float32)
                           .reshape(-1).numpy(), t.shape)


def repitch(self, factor, granularity: float = 0.001,
            quality: str = "sinc", num_taps: int = 64):
    """Time-varying repitch, the WDL resampler's (reference
    AudioTemporal.cpp:236-299): the rate curve sampled a block of
    `granularity` at a time and clamped as the reference clamps 1 / factor
    in float32, the feed loop planned on the host (_wdl_sinc_plan), then
    one windowed-sinc gather of num_taps (64: the reference's sinc size)
    on the audio's device, or a linear read."""
    if self.is_null():
        return _null()
    gran = max(1, self.time_to_frame(granularity))
    fn = as_function(factor)
    nblocks = int(math.ceil(self.num_frames / gran))
    if fn.is_constant:
        fvals = np.full(nblocks, fn.constant_value, np.float32)
    else:
        tgrid = np.arange(nblocks, dtype=np.float64) * granularity
        fvals = _host_sample(fn, tgrid.astype(np.float32))
    rates_inv = np.clip((np.float32(1.0) / fvals).astype(np.float32),
                        np.float32(1.0 / 1000.0), np.float32(1000.0))
    positions, rates = _wdl_sinc_plan(self.num_frames, gran, rates_inv,
                                      fn.is_constant)
    # WDL's anti-alias margin reading faster than realtime
    # (resample.cpp:1327)
    cutoff = np.where(rates > 1.0, 1.0 / (1.03 * rates), 1.0)
    dev = self.device
    pos = torch.from_numpy(positions.astype(np.float32)).to(dev)
    if quality == "linear":
        n = self.num_frames
        base = torch.floor(pos).to(torch.int64)
        frac = (pos - base)[None, :]
        written = torch.from_numpy(positions > -1e8).to(dev)[None, :]
        lo = self.data[:, base.clamp(0, n - 1)]
        hi = self.data[:, (base + 1).clamp(0, n - 1)]
        data = torch.where(written, lo * (1 - frac) + hi * frac, 0.0)
    else:
        data = resample_ops.fractional_gather(
            self.data, pos, torch.from_numpy(cutoff.astype(np.float32))
            .to(dev), num_taps=num_taps)
    return self._with(data=data)


def sample_delay_times(fn, out_n: int, sr: float):
    """A delay-time Function at every output frame, as
    flan_tpu/audio/temporal.py:467-473 samples it: a constant as a number
    (the JAX package's float64 fill), a callable on the float32 grid
    arange(out_n) / sr as a float32 CPU tensor [out_n]. Everything after
    (the widening to float64, the frames, the rings) is
    stereo_delay_frames' and stereo_delay's, on the audio's device."""
    if fn.is_constant:
        return float(fn.constant_value)
    t = true_div(float_iota(out_n), sr)
    out = torch.as_tensor(fn(t), dtype=torch.float32)
    return torch.broadcast_to(out.reshape(-1), (out_n,)).contiguous()


def _delay_times_on(times, device):
    """Sampled delay times on `device`: a number stays one; a tensor
    crosses once, from pinned memory to the card."""
    if not isinstance(times, torch.Tensor):
        return times
    if torch.device(device).type == "cuda":
        return times.pin_memory().to(device, non_blocking=True)
    return times.to(device)


def _ring_frames(times, sr: float) -> int:
    """The ring a delay time needs: int(max(time) * sr), the largest
    float32 sample widened (the frame cast truncates, as the reference)."""
    peak = float(times.max()) if isinstance(times, torch.Tensor) else times
    return int(peak * sr)


def delay(self, added_length: float, delay_time, decay=0.5, mod=None,
          *, seed: int = 0):
    """A volume-decaying delay through the texture engine with feedback
    (reference AudioTemporal.cpp:326-361; flan_tpu/audio/temporal.py:
    406-435): echoes at the rate 1 / delay_time, each the mod of the one
    before scaled by the decay at its time."""
    from flan_tpu_torch.audio.synthesis import texture
    if self.is_null():
        return _null()
    length = self.length + max(0.0, added_length)
    dt_fn = as_function(delay_time)
    decay_fn = as_function(decay)
    sr = self.sample_rate

    def events_per_second(t):
        dt = torch.clamp(torch.as_tensor(dt_fn(t), dtype=torch.float32),
                         min=1.0 / sr)
        return 1.0 / dt

    def delay_mod(audio, t):
        if t == 0:
            return audio
        out = audio if mod is None else mod(audio, t)
        return out.modify_volume(_eval_scalar(decay_fn, t))

    return texture(self, length, events_per_second, 0.0, delay_mod,
                   mod_feedback=True, seed=seed)


def stereo_delay(self, length: float, l_time, r_time, decay):
    """Cross-feedback stereo delay, the reference's commented
    implementation as the JAX package activates it
    (AudioTemporal.cpp:363-408; flan_tpu/audio/temporal.py:439-528): two
    rings of max(delay) frames feed each other through the decay, and each
    output reads its ring a full ring late. Stereo only (null otherwise);
    `length` is the output's length.

    Constant delays: w_R[t] = (x_R + g x_L)[t] + g[t]^2 w_R[t - rb], a
    linear recurrence down the rows of time cut into [ceil(n / rb), rb]
    (ops/scan.py, the scan kernel on the card), then w_L = x_L + g shift(
    w_R, rb) and the two outputs as shifts. Time-varying delays: the ring
    loop, on ops/sequential_kernels.py stereo_delay_swept (the plain loop
    on the CPU, the kernel on the card), differentiable in the signal and
    the decay. The delay times are sampled on the host (the Functions'
    own float32 values) and cross once; their frames, the rings and the
    reads' distances are worked out on the audio's device, as is the
    decay."""
    from flan_tpu_torch.audio.audio import Audio
    from flan_tpu_torch.ops.scan import linear_recurrence
    from flan_tpu_torch.ops.sequential_kernels import (stereo_delay_frames,
                                                       stereo_delay_reads,
                                                       stereo_delay_swept)
    if self.is_null() or self.num_channels != 2:
        return _null()
    sr = self.sample_rate
    out_n = int(length * sr)
    if out_n <= 0:
        return _null()
    lt_fn, rt_fn, g_fn = (as_function(f) for f in (l_time, r_time, decay))
    dev = self.device
    lt, rt = (_delay_times_on(sample_delay_times(fn, out_n, sr), dev)
              for fn in (lt_fn, rt_fn))
    lb, rb = _ring_frames(lt, sr), _ring_frames(rt, sr)
    if lb <= 0 or rb <= 0:
        return _null()
    x = torch.nn.functional.pad(
        self.data, (0, max(0, out_n - self.num_frames)))[:, :out_n]
    g = g_fn.sample(0, out_n, 1.0 / sr, dev)
    if g_fn.is_constant:
        g = torch.full((out_n,), g, dtype=torch.float32, device=dev)

    def shift(v, d):
        return torch.nn.functional.pad(v, (d, 0))[:out_n]

    if lt_fn.is_constant and rt_fn.is_constant:
        u_r = x[1] + g * x[0]
        m = -(-out_n // rb)
        pad = m * rb - out_n
        a = torch.nn.functional.pad(g * g, (0, pad)).reshape(m, rb)
        b = torch.nn.functional.pad(u_r, (0, pad)).reshape(m, rb)
        w_r = linear_recurrence(a, b, axis=0).reshape(-1)[:out_n]
        w_l = x[0] + g * shift(w_r, rb)
        out = torch.stack([shift(w_l, lb), shift(w_r, rb)])
        return Audio(data=out, sample_rate=sr)

    el, er = stereo_delay_reads(stereo_delay_frames(lt, sr, lb, out_n, dev),
                                stereo_delay_frames(rt, sr, rb, out_n, dev),
                                lb, rb)
    out = stereo_delay_swept(x.contiguous(), g.contiguous(), el, er, lb, rb)
    return Audio(data=out, sample_rate=sr)


def iterate(self, n: int, crossfade_time: float = 0.0, mod=None,
            feedback: bool = False):
    """n repeats joined with crossfades, each through mod(audio, start
    time) where given, from the last repeat with feedback (reference
    AudioTemporal.cpp:301-324)."""
    from flan_tpu_torch.audio.audio import Audio
    if self.is_null() or n < 1:
        return _null()
    if mod is None:
        return Audio.join([self] * n, offset=-crossfade_time)
    outs = []
    current = self
    for i in range(n):
        source = current if (feedback and i > 0) else self
        current = mod(source, i * self.length)
        outs.append(current)
    return Audio.join(outs, offset=-crossfade_time)
