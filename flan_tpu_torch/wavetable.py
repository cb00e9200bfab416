"""Wavetable: pitch-tracked waveform extraction and playback (counterpart
of flan_tpu/wavetable.py; reference: src/flan/Wavetable.h, Wavetable.cpp).

* The constructor's segmentation walk, zero-crossing snapping and the
  per-cycle spectral resample run on the host in numpy, copied from the
  JAX package with their arithmetic unchanged; the pitch they follow comes
  from the port's filter_1pole_lowpass (a scan kernel on the card) and
  get_local_wavelengths. The finished table is a float32 tensor on the
  source's device.
* Playback simulates the reference's blockwise WDL-sinc feed loop on the
  host (_wavetable_wdl_plan), then on the table's device expands the
  crossfaded table stream and reads it by one 64-tap windowed-sinc gather
  (ops/resample.py fractional_gather).

The reference's quirks are kept as the JAX package keeps them (see its
docstring): the trailing all-zero slot per channel, the truncated source
frame in ratio_to_table_index, the truncated wavelength estimates.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops.resample import fractional_gather
from flan_tpu_torch.ops.stft import true_div


class SnapMode:
    NONE = "none"
    ZERO = "zero"
    LEVEL = "level"


class PitchMode:
    NONE = "none"
    LOCAL = "local"
    GLOBAL = "global"


def _snap_frame(data: np.ndarray, frame: int, height: float,
                search: int) -> int:
    """Nudge frame to the nearest crossing of `height` (reference
    snap_frame_to_sample, Wavetable.cpp:19-60)."""
    n = len(data)
    frame = int(np.clip(frame, 0, n - 1))
    search = int(max(search, 0))
    lo = max(frame - search, 0)
    hi = min(frame + search, n - 1)
    above = data[frame] > height
    for off in range(search + 1):
        left = frame - off
        if left >= lo and (data[left] > height) != above:
            return left + 1
        right = frame + off
        if right < hi and (data[right] > height) != above:
            return right
    # no crossing: the frame nearest the height by a distance-weighted
    # norm, the first of the window's minima unless the frame itself ties
    window = np.arange(lo, hi + 1)
    r = 1.0 + np.abs(window - frame).astype(np.float32) / np.float32(
        max(search, 1))
    dist = np.abs(data[window] - np.float32(height)) * r
    d_frame = dist[frame - lo]
    m = dist.min()
    if m < d_frame:
        return int(window[int(dist.argmin())])
    return frame


class Wavetable:
    """table: [channels, num_waves, wavelength] float32 tensor."""

    def __init__(self, source=None, snap_mode: str = SnapMode.ZERO,
                 pitch_mode: str = PitchMode.LOCAL, wavelength: int = 2048,
                 snap_ratio: float = 0.3, fixed_frame_size: int = 256,
                 *, _table=None, _starts=None, _num_source_frames=0,
                 _sample_rate=48000.0):
        if source is None:
            self.table = _table
            self.waveform_starts = _starts or []
            self.wavelength = wavelength
            self.num_source_frames = _num_source_frames
            self.sample_rate = _sample_rate
            return
        self.wavelength = wavelength
        self.sample_rate = float(source.sample_rate)
        self.num_source_frames = source.num_frames
        self.waveform_starts = _get_waveform_starts(
            source, snap_mode, pitch_mode, wavelength, snap_ratio,
            fixed_frame_size)
        self.table = _resample_waveforms(source, self.waveform_starts,
                                         wavelength)

    @staticmethod
    def from_function(f, num_waves: int, wavelength: int = 2048,
                      sample_rate: float = 48000.0,
                      device=None) -> "Wavetable":
        """f sampled on [k, k + 1) for wave k (reference
        Wavetable.cpp:235-248), on `device`, the card unless named. Each
        wave gets its own samples, as in the JAX package (the reference
        writes every wave to wave 0's slots: docs/PARITY.md)."""
        device = DEFAULT_DEVICE if device is None else device
        grid = (torch.arange(num_waves, device=device)[:, None]
                + true_div(float_iota(wavelength, device=device),
                           wavelength)[None, :])
        table = torch.as_tensor(as_function(f)(grid), dtype=torch.float32,
                                device=device)
        table = torch.broadcast_to(table, grid.shape)[None].contiguous()
        return Wavetable(_table=table, _starts=[list(range(num_waves))],
                         _num_source_frames=num_waves,
                         _sample_rate=sample_rate, wavelength=wavelength)

    def is_null(self) -> bool:
        return (self.table is None or self.wavelength <= 0
                or not self.waveform_starts
                or any(len(s) == 0 for s in self.waveform_starts)
                or self.num_source_frames <= 0)

    def get_num_waveforms(self, channel: int = 0) -> int:
        return len(self.waveform_starts[channel])

    def get_waveform(self, waveform_index: int, channel: int) -> np.ndarray:
        """One table cycle as a numpy array (reference Wavetable.cpp:
        454-461)."""
        return self.table[channel, waveform_index].cpu().numpy()

    def ratio_to_table_index(self, r, channel: int = 0):
        """A [0, 1] source-position ratio as a fractional table index
        (reference Wavetable.cpp:463-488); the source frame is the
        truncated r * num_source_frames, as the reference's Frame cast."""
        out = self._ratio_to_table_index(np.asarray(r), channel)
        return float(out) if np.ndim(r) == 0 else out

    def _ratio_to_table_index(self, r: np.ndarray, channel: int
                              ) -> np.ndarray:
        starts = np.asarray(self.waveform_starts[channel], np.int64)
        size = len(starts)
        nsf = np.float32(self.num_source_frames)
        src = np.trunc(np.asarray(r, np.float32) * nsf).astype(np.int64)
        ri = np.searchsorted(starts, src, side="right")
        ric = np.clip(ri, 1, size - 1)
        left = starts[ric - 1]
        right = starts[ric]
        idx = (ric - 1).astype(np.float32) + (
            (src - left).astype(np.float32)
            / np.maximum(right - left, 1).astype(np.float32))
        idx = np.clip(idx, 0.0, np.float32(size - 1))
        idx = np.where(ri == 0, 0.0, idx)
        idx = np.where(ri == size, np.float32(size - 1), idx)
        idx = np.where(src <= 0, 0.0, idx)
        idx = np.where(src.astype(np.float32) > nsf,
                       np.float32(size - 1), idx)
        return idx

    # --- Playback (reference Wavetable.cpp:266-334) -------------------------
    def synthesize(self, length: float, freq, ratio=0.0,
                   smooth: bool = True, granularity: float = 0.001):
        """Variable-rate wavetable playback: the WDL feed loop planned on
        the host (_wavetable_wdl_plan, the frequency and the table index
        sampled at the output head), then per channel one table-stream
        expansion and one 64-tap windowed-sinc gather on the table's
        device."""
        from flan_tpu_torch.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        sr = self.sample_rate
        L = self.wavelength
        num_out = int(np.float32(length) * np.float32(sr))
        gran = max(1, int(np.float32(granularity) * np.float32(sr)))
        if num_out < 1:
            return Audio.create_null()

        freq_fn = as_function(freq)
        ratio_fn = as_function(ratio)
        tgrid = (np.arange(num_out, dtype=np.float32)
                 / np.float32(sr)).astype(np.float32)

        def grid_eval(fn):
            if fn.is_constant:
                return np.full(num_out, np.float32(fn.constant_value),
                               np.float32)
            out = fn(torch.from_numpy(tgrid))
            vals = torch.as_tensor(out, dtype=torch.float32).cpu()
            return np.broadcast_to(vals.reshape(-1).numpy(), (num_out,))

        f_grid = grid_eval(freq_fn)
        r_grid = grid_eval(ratio_fn)
        in_freq = float(sr) / L
        dev = self.table.device

        rows = []
        for channel in range(self.table.shape[0]):
            pos, rate, sreqs, lefts, rights, rems = _wavetable_wdl_plan(
                num_out, gran, f_grid, in_freq,
                self._ratio_to_table_index(r_grid, channel),
                self.get_num_waveforms(channel))
            total = int(sreqs.sum())
            if total == 0:
                rows.append(torch.zeros(num_out, dtype=torch.float32,
                                        device=dev))
                continue
            cutoff = np.where(rate > 1.0, 1.0 / (1.03 * rate), 1.0)
            rows.append(_synthesize_stream_core(
                self.table[channel], sreqs, lefts, rights,
                rems.astype(np.float32), pos.astype(np.float32),
                cutoff.astype(np.float32), total, smooth))
        return Audio(data=torch.stack(rows), sample_rate=sr)

    # --- Edit ops (reference Wavetable.cpp:364-451) -------------------------
    def add_fades_in_place(self, fade_frames: int = 32) -> None:
        env = _edge_fade_env(self.wavelength, fade_frames, self.table.device)
        self.table = self.table * env[None, None, :]

    def remove_jumps_in_place(self, fade_frames: int = 32) -> None:
        mid = (self.table[..., :1] + self.table[..., -1:]) / 2.0
        env = _edge_fade_env(self.wavelength, fade_frames, self.table.device)
        self.table = (self.table - mid) * env[None, None, :] + mid

    def remove_dc_in_place(self) -> None:
        self.table = self.table - torch.mean(self.table, dim=-1,
                                             keepdim=True)

    def normalize_in_place(self) -> None:
        peak = torch.amax(torch.abs(self.table), dim=-1, keepdim=True)
        self.table = torch.where(peak < 1e-3, self.table,
                                 self.table / torch.clamp(peak, min=1e-9))


def _synthesize_stream_core(table: torch.Tensor, sreqs, lefts, rights, rems,
                            pos, cutoff, total_fed: int,
                            smooth: bool) -> torch.Tensor:
    """The device half of synthesize (flan_tpu/wavetable.py:289-310): the
    per-block feed plan expanded into the periodic (crossfaded) table
    stream of total_fed samples, then one 64-tap sinc gather."""
    dev = table.device
    L = table.shape[1]
    nblocks = len(sreqs)
    blk = torch.repeat_interleave(
        torch.arange(nblocks, device=dev),
        torch.from_numpy(np.asarray(sreqs, np.int64)).to(dev),
        output_size=total_fed)
    col = torch.remainder(torch.arange(total_fed, device=dev), L)
    left_v = table[torch.from_numpy(np.asarray(lefts, np.int64)).to(dev)[blk],
                   col]
    if smooth:
        right_v = table[torch.from_numpy(np.asarray(rights, np.int64)
                                         ).to(dev)[blk], col]
        rem_v = torch.from_numpy(rems).to(dev)[blk]
        stream = left_v * (1.0 - rem_v) + right_v * rem_v
    else:
        stream = left_v
    return fractional_gather(stream[None, :], torch.from_numpy(pos).to(dev),
                             torch.from_numpy(cutoff).to(dev),
                             num_taps=64)[0]


def _wavetable_wdl_plan(num_out: int, gran: int, f_grid: np.ndarray,
                        in_freq: float, tix_grid: np.ndarray,
                        num_waves: int):
    """Host simulation of synthesize's WDL feed loop (Wavetable.cpp:288-332
    driving WDL resample.cpp in sinc-64 mode), copied from
    flan_tpu/wavetable.py:313-384 with its arithmetic unchanged: the rate
    and the table index are chosen by the output head, the input is the
    endless periodic table stream, and the output head advances by what
    ResampleOut returns.

    Returns (positions [num_out] float64 in fed-stream coordinates, rates
    [num_out], sreq per block, left and right table indices and crossfade
    remainder per block)."""
    SINC, HFS = 64, 32
    pos = np.full(num_out, -1e9, np.float64)
    rate = np.ones(num_out, np.float64)
    sreqs: List[int] = []
    lefts: List[int] = []
    rights: List[int] = []
    rems: List[float] = []

    samples_in = 0
    fracpos = 0.0
    win = 0                     # fed-stream position of rsinbuf[0]
    out_gen = 0
    while out_gen < num_out:
        ratio = float(f_grid[out_gen]) / in_freq      # double m_ratio
        tix = np.float32(tix_grid[out_gen])
        left = int(math.floor(tix))
        right = min(int(math.ceil(tix)), num_waves - 1)
        rem = float(np.float32(tix - np.float32(left)))
        # ResamplePrepare (resample.cpp:1218-1264): zero history pad
        if samples_in < HFS - 1:
            win -= (HFS - 1) - samples_in
            samples_in = HFS - 1
        sreq = int(ratio * gran) + 4 + SINC - samples_in
        if sreq < 0:
            sreq = 0
        sreqs.append(sreq)
        lefts.append(left)
        rights.append(right)
        rems.append(rem)
        samples_in += sreq
        # ResampleOut (resample.cpp:1313-1415): produce until the filter
        # runs out of input or the output is full
        filtlen = samples_in - SINC
        srcpos = fracpos
        ret = 0
        while out_gen + ret < num_out:
            ipos = int(srcpos)
            if ipos >= filtlen - 1:
                break
            pos[out_gen + ret] = win + srcpos + (HFS - 1)
            rate[out_gen + ret] = ratio
            srcpos += ratio
            ret += 1
        out_gen += ret
        if ret == 0 and sreq == 0:
            break               # rate too small to ever advance
        # post-loop bookkeeping (resample.cpp:1556-1570)
        isrcpos = int(srcpos)
        if isrcpos > samples_in:
            isrcpos = samples_in
        fracpos = srcpos - isrcpos
        samples_in -= isrcpos
        if samples_in < 0:
            samples_in = 0
        win += isrcpos
    return (pos, rate, np.asarray(sreqs, np.int64),
            np.asarray(lefts, np.int64), np.asarray(rights, np.int64),
            np.asarray(rems, np.float64))


def _edge_fade_env(wavelength: int, fade_frames: int,
                   device=None) -> torch.Tensor:
    """sin fades at both waveform edges (reference Wavetable.cpp:375-380),
    float32 on `device`."""
    env = np.ones(wavelength, np.float32)
    for f in range(max(fade_frames - 1, 0)):
        fade = math.sin(math.pi / 2.0 * (f + 1) / fade_frames)
        env[f] *= fade
        env[wavelength - 1 - f] *= fade
    return torch.from_numpy(env).to(device)


def _get_waveform_starts(source, snap_mode, pitch_mode, wavelength,
                         snap_ratio, fixed_frame) -> List[List[int]]:
    """Sequential pitch-following waveform segmentation (reference
    get_waveform_starts, Wavetable.cpp:134-218), copied from
    flan_tpu/wavetable.py:397-453: every float wavelength estimate
    truncates to whole frames at use, as the reference's Frame casts."""
    if source.is_null() or fixed_frame < 1 or not (0 < snap_ratio < 0.95):
        return []
    lp = source.filter_1pole_lowpass(4000.0, 2)
    ac_gran = 128

    out = []
    for channel in range(source.num_channels):
        data = source.data[channel].cpu().numpy()
        local = np.zeros(0)
        global_wl = 0
        mode = pitch_mode
        if mode != PitchMode.NONE:
            local = np.asarray(lp.get_local_wavelengths(
                channel, 0, -1, wavelength, ac_gran, 1.0, 32))
            global_wl = int(lp.get_average_wavelength(local, 0.2, 64.0))
            if mode == PitchMode.GLOBAL and global_wl == -1:
                mode = PitchMode.NONE

        def snap(frame, src_frame, max_snap):
            if snap_mode == SnapMode.NONE:
                return int(frame)
            height = 0.0 if snap_mode == SnapMode.ZERO else float(
                data[int(np.clip(src_frame, 0, len(data) - 1))])
            return _snap_frame(data, int(frame), height, int(max_snap))

        starts = [snap(0, 0, snap_ratio * max(global_wl, 0))]
        while True:
            if mode == PitchMode.LOCAL:
                li = int(starts[-1] // ac_gran)
                if li >= len(local):
                    break
                wl = int(local[li])
                if wl > 0:
                    expected = wl
                elif global_wl > 0:
                    expected = global_wl
                else:
                    expected = fixed_frame
            elif mode == PitchMode.GLOBAL:
                expected = global_wl
            else:
                expected = fixed_frame
            expected = int(expected)
            if expected < 1 or starts[-1] + expected >= source.num_frames:
                break
            starts.append(snap(starts[-1] + expected, starts[-1],
                               snap_ratio * expected))
        out.append(starts)
    return out


def _resample_waveforms(source, waveform_starts, wavelength):
    """Per-cycle spectral resample to the table's wavelength (reference
    resample_waveforms, Wavetable.cpp:67-132), host numpy copied from
    flan_tpu/wavetable.py:456-503: the cycle's rFFT zero-padded, inverse
    FFT at the wavelength, realigned to the first zero crossing within 10%
    of it, scaled by 1 / num_input_frames; one trailing all-zero slot per
    channel. The table goes to the source's device."""
    if source.is_null() or not waveform_starts:
        return None
    L = wavelength
    nb_out = L // 2 + 1
    sd = int(np.float32(L) * np.float32(0.1))
    channels = []
    for channel, starts in enumerate(waveform_starts):
        W = max(len(starts), 1)
        tab = np.zeros((W, L), np.float32)
        data = source.data[channel].cpu().numpy().astype(np.float64)
        for w in range(len(starts) - 1):
            a, b = starts[w], starts[w + 1]
            num_in = b - a
            if num_in <= 0:
                continue
            sp = np.fft.rfft(data[a:b])
            spec = np.zeros(nb_out, np.complex128)
            k = min(len(sp), nb_out)
            spec[:k] = sp[:k]
            y = (np.fft.irfft(spec, L) * L / num_in).astype(np.float32)
            above = y[0] > 0
            zc = 0
            for off in range(1, sd + 1):
                if (y[L - off] > 0) != above:
                    zc = L - off
                    break
                if (y[off] > 0) != above:
                    zc = off
                    break
            tab[w] = np.roll(y, -zc)
        channels.append(tab)
    max_w = max(ch.shape[0] for ch in channels)
    padded = [np.pad(ch, [(0, max_w - ch.shape[0]), (0, 0)])
              for ch in channels]
    return torch.from_numpy(np.stack(padded)).to(source.device)
