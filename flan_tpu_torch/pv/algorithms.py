"""PV selection / combination / generation / extras (counterpart of
flan_tpu/pv/algorithms.py; reference: src/flan/PV/PV.cpp).

Plain functions on a PV's [C, F, B] tensors, bound onto PV in
pv/__init__.py. The reference's scatter-with-max loops become
scatter_reduce passes; its frame loop of `resonate` is the max-affine
recurrence and the two damped walks of `perturb` are linear recurrences,
both through ops/scan.py, which runs them on the scan kernels on the card
(csrc/scan_kernels.cu kinds 1 and 0) and on their plain versions on the CPU.

Random draws: `synthesize` and `perturb` draw their noise from a
torch.Generator seeded with `seed` on the PV's device. JAX's random bits
cannot be reproduced, so each keeps its deterministic remainder in a
private function of the noise planes (_synthesize_planes, _perturb_planes),
which the tests feed with the JAX package's own noise.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import (as_function, as_function2d,
                                          broadcast_f32)
from flan_tpu_torch.ops.scan import linear_recurrence, max_affine_recurrence
from flan_tpu_torch.ops.stft import true_div
from flan_tpu_torch.ops.windows import hann


def _null():
    from flan_tpu_torch.pv.pv import PV
    return PV.create_null()


def _grid(self, frames: int):
    """(t [frames], f [B]): t = frame / analysis_rate and the bin
    frequencies, float32 on the PV's device."""
    t = true_div(float_iota(frames, device=self.device), self.analysis_rate)
    fr = float_iota(self.num_bins, device=self.device) * self.bin_width
    return t, fr


def get_bin_interpolated(self, channel: int, frame: float, b: float,
                         interp: Callable = interpolators.linear):
    """Bilinear MF read (reference PV.cpp:41-60): (magnitude, frequency)."""
    f0, f1 = int(np.floor(frame)), int(np.ceil(frame))
    b0, b1 = int(np.floor(b)), int(np.ceil(b))
    l = float(interp(torch.tensor(frame - f0, dtype=torch.float32)))
    m = float(interp(torch.tensor(b - b0, dtype=torch.float32)))

    def mix(a):
        return ((1 - m) * ((1 - l) * a[f0, b0] + l * a[f1, b0])
                + m * ((1 - l) * a[f0, b1] + l * a[f1, b1]))
    return float(mix(self.mag[channel])), float(mix(self.freq[channel]))


def select(self, length: float, selector,
           interp: Callable = interpolators.linear):
    """Inverse-map gather with frequency rescale (reference PV.cpp:92-127).
    selector maps (t, f) to the source (time, frequency): a tuple of two
    tensors or one with a last axis of 2."""
    if self.is_null() or length <= 0:
        return _null()
    out_frames = int(self.time_to_frame(length))
    t, fr = _grid(self, out_frames)
    sel = as_function2d(selector)(t[:, None], fr[None, :])
    if isinstance(sel, tuple):
        sel_t, sel_f = sel
    else:
        sel = torch.as_tensor(sel)
        sel_t, sel_f = sel[..., 0], sel[..., 1]
    shape = (out_frames, self.num_bins)
    sel_t, sel_f = (broadcast_f32(s, shape, self.device)
                    for s in (sel_t, sel_f))

    src_frame = (sel_t * self.analysis_rate).to(torch.int64)
    src_bin = true_div(sel_f, self.bin_width).to(torch.int64)
    valid = ((src_frame >= 0) & (src_frame < self.num_frames - 1)
             & (src_bin >= 0) & (src_bin < self.num_bins - 1))
    sf = torch.clamp(src_frame, 0, self.num_frames - 1)
    sb = torch.clamp(src_bin, 0, self.num_bins - 1)
    mag = self.mag[:, sf, sb]
    freq = self.freq[:, sf, sb]
    # frequency rescale (PV.cpp:120-121)
    scale = torch.where(sel_f > 1.0,
                        fr[None, :] / torch.clamp(sel_f, min=1e-9), 1.0)
    return self._with(mag=torch.where(valid, mag, 0.0),
                      freq=torch.where(valid, freq * scale, 0.0))


def freeze(self, pause_times: Sequence[float],
           pause_lengths: Sequence[float]):
    """Frame-repetition schedule -> one gather (reference PV.cpp:129-198).

    Reference quirk (PV.cpp:175-194, golden-tested): a frozen frame is
    written `length` times INSTEAD of once, so a zero-length pause drops
    its frame, and the output, sized num_frames + sum(lengths), keeps one
    trailing zero frame per pause. Of duplicate pause frames the last is
    kept."""
    if self.is_null() or len(pause_times) != len(pause_lengths):
        return _null()
    timing = sorted(
        {int(np.clip(self.time_to_frame(t), 0, self.num_frames - 1)):
         max(int(self.time_to_frame(l)), 0)
         for t, l in zip(pause_times, pause_lengths)}.items())
    index_map = []
    ti = 0
    for in_frame in range(self.num_frames):
        if ti < len(timing) and in_frame == timing[ti][0]:
            index_map.extend([in_frame] * timing[ti][1])
            ti += 1
        else:
            index_map.append(in_frame)
    n_out = self.num_frames + sum(l for _, l in timing)
    idx = torch.tensor(index_map, dtype=torch.int64, device=self.device)
    pad = (0, 0, 0, n_out - len(index_map))
    return self._with(
        mag=torch.nn.functional.pad(self.mag.index_select(1, idx), pad),
        freq=torch.nn.functional.pad(self.freq.index_select(1, idx), pad))


def _overlap(self, other):
    return (min(self.num_channels, other.num_channels),
            min(self.num_frames, other.num_frames),
            min(self.num_bins, other.num_bins))


def replace_amplitudes(self, amp_source, amount=1.0):
    """Magnitudes blend toward amp_source's by amount(t, f) in [0, 1];
    frequencies stay this PV's; outside the two PVs' overlap both planes
    are zero (reference PV.cpp:205-236)."""
    if self.is_null() or amp_source.is_null():
        return _null()
    c, f, b = _overlap(self, amp_source)
    amt = torch.clamp(self._sample_2d(amount), 0.0, 1.0)
    amt = torch.broadcast_to(amt, (self.num_frames, self.num_bins))[:f, :b]
    mag = torch.zeros_like(self.mag)
    mag[:c, :f, :b] = (amp_source.mag[:c, :f, :b] * amt
                       + self.mag[:c, :f, :b] * (1.0 - amt))
    freq = torch.zeros_like(self.freq)
    freq[:c, :f, :b] = self.freq[:c, :f, :b]
    return self._with(mag=mag, freq=freq)


def subtract_amplitudes(self, amp_source, amount=1.0):
    """|mag - amount(t, f) * amp_source.mag| over the overlap
    (reference PV.cpp:238-264)."""
    if self.is_null() or amp_source.is_null():
        return _null()
    c, f, b = _overlap(self, amp_source)
    amt = torch.broadcast_to(self._sample_2d(amount),
                             (self.num_frames, self.num_bins))[:f, :b]
    mag = self.mag.clone()
    mag[:c, :f, :b] = torch.abs(self.mag[:c, :f, :b]
                                - amp_source.mag[:c, :f, :b] * amt)
    return self._with(mag=mag, freq=self.freq)


_SYNTH_FORMAT = (2049, 48000.0, 128, 2048)   # bins, rate, hop, window


def synthesize(length: float, freq, harmonic_weights=None,
               harmonic_bandwidth=60.0, harmonic_frequency_std_dev=0.0,
               *, seed: int = 0, device=DEFAULT_DEVICE):
    """Generate a mono PV from harmonic descriptions (reference
    PV.cpp:271-356): each harmonic spreads a hann profile over `bandwidth`
    Hz; the highest harmonic covering a bin wins. The frequency jitter is
    N(0, std) noise from a generator seeded with `seed` on `device`."""
    from flan_tpu_torch.core.pv_buffer import PVFormat
    from flan_tpu_torch.pv.pv import PV
    bins, sr, hop, window = _SYNTH_FORMAT
    out = PV.create_from_format(
        PVFormat(1, int(length * sr / hop), bins, sr, hop, window), device)
    if out.num_frames <= 0:
        return PV.create_null()
    gen = torch.Generator(device=out.device).manual_seed(seed)
    noise = torch.randn((out.num_frames, out.num_bins), generator=gen,
                        dtype=torch.float32, device=out.device)
    return _synthesize_planes(out, freq, harmonic_weights,
                              harmonic_bandwidth, harmonic_frequency_std_dev,
                              noise)


def _synthesize_planes(out, freq, harmonic_weights, harmonic_bandwidth,
                       harmonic_frequency_std_dev, noise: torch.Tensor):
    """synthesize's planes on `out`'s format from the frequency noise
    [F, B] (flan_tpu/pv/algorithms.py:153-209)."""
    F, B = out.num_frames, out.num_bins
    dev = out.device
    height = out.bin_to_frequency(B - 1)
    scale = math.sqrt(out.dft_size)
    min_frequency = height / B / 2.0

    t, bin_f = _grid(out, F)
    base = torch.clamp(broadcast_f32(as_function(freq)(t), (F,), dev),
                       min=min_frequency)
    bw = broadcast_f32(as_function(harmonic_bandwidth)(t), (F,), dev) / 2.0
    weights_fn = harmonic_weights if harmonic_weights is not None else (
        lambda tt, h: 1.0 / h)
    sd_fn = as_function2d(harmonic_frequency_std_dev)

    # the highest harmonic h with h * base - bw <= bin_f covers the bin
    # (the reference writes harmonics in ascending order)
    h = torch.floor((bin_f[None, :] + bw[:, None]) / base[:, None])
    # harmonics per frame (PV.cpp:297-299); a Python number over a tensor
    # would be a reciprocal times the number in torch
    max_h = torch.floor(torch.full((), height, device=dev) / base)
    h = torch.minimum(torch.clamp(h, min=0.0), max_h[:, None])
    central = h * base[:, None]
    low = central - bw[:, None]
    high = central + bw[:, None]
    covered = (h >= 1) & (bin_f[None, :] >= low) & (bin_f[None, :] <= high)

    w = broadcast_f32(weights_fn(t[:, None], torch.clamp(h, min=1.0)),
                      (F, B), dev)
    pos = (bin_f[None, :] - low) / torch.clamp(high - low, min=1e-9)
    mag = torch.where(covered, w * scale * hann(pos), 0.0)

    sd = broadcast_f32(sd_fn(t[:, None], bin_f[None, :]), (F, B), dev)
    freq_out = torch.where(
        covered, central + torch.where(sd > 0, noise * sd, 0.0), 0.0)
    return out._with(mag=mag[None], freq=freq_out[None])


def _harmonic_scaler(self, series, harmonic_freq_fn, num_harmonics: int):
    """Scatter-max harmonic painting (reference harmonic_scaler,
    PV.cpp:362-407): per harmonic, each MF's magnitude times the series
    lands on the bin of its harmonic frequency, largest magnitude winning;
    then the winners' frequencies. The series is scalar over (time,
    harmonic), sampled per harmonic ([F] floats each)."""
    c, f, b = self.mag.shape
    t, _ = _grid(self, f)
    series_fn = series if callable(series) else (lambda tt, hh: series)

    def series_row(h):
        raw = torch.as_tensor(series_fn(t[:, None], h), dtype=torch.float32,
                              device=self.device)
        if raw.ndim == 2 and raw.shape[-1] != 1:
            raise ValueError(
                "harmonic series functions are scalar over (time, harmonic)"
                " - the reference's Function<pair<Second, Harmonic>,"
                " Magnitude> (PV.cpp:362-407); per-bin series are not"
                f" supported (got shape {tuple(raw.shape)})")
        return torch.broadcast_to(raw, (f, 1))[:, 0]

    def step(h):
        hf = harmonic_freq_fn(self.freq, float(h) + 1.0)          # [C, F, B]
        hbin = true_div(hf, self.bin_width).to(torch.int64)
        val = self.mag * series_row(h)[None, :, None]
        valid = (self.freq > 1.0) & (hbin < b) & (hbin >= 0)
        return torch.clamp(hbin, 0, b - 1), torch.where(valid, val, -1.0), \
            hf, valid

    out_mag = torch.zeros_like(self.mag)
    for h in range(num_harmonics):
        tb, val, _, _ = step(h)
        out_mag.scatter_reduce_(2, tb, val, "amax")
    out_freq = torch.full_like(self.freq, -math.inf)
    for h in range(num_harmonics):
        tb, val, hf, valid = step(h)
        write = valid & (val >= torch.gather(out_mag, 2, tb)) & (val > 0)
        out_freq.scatter_reduce_(2, tb, torch.where(write, hf, -math.inf),
                                 "amax")
    out_freq = torch.where(torch.isneginf(out_freq), 0.0, out_freq)
    return self._with(mag=torch.clamp(out_mag, min=0.0), freq=out_freq)


def add_octaves(self, series):
    """(reference PV.cpp:409-413): ceil(log2(height)) octaves, height the
    band edge bin_to_frequency(num_bins) (PV.cpp:413)."""
    if self.is_null():
        return _null()
    height = self.bin_to_frequency(self.num_bins)
    n = int(math.ceil(math.log2(max(height, 2.0))))
    return _harmonic_scaler(self, series, lambda fr, h: fr * (2.0 ** h), n)


def add_harmonics(self, series, max_harmonics: Optional[int] = None):
    """(reference PV.cpp:415-419): num_bins harmonics per partial, as the
    reference paints them (golden-tested); max_harmonics lowers the count
    (each harmonic is two full-plane scatter passes)."""
    if self.is_null():
        return _null()
    n = self.num_bins
    if max_harmonics is not None:
        n = min(n, int(max_harmonics))
    return _harmonic_scaler(self, series, lambda fr, h: fr * (h + 1.0), n)


def shape(self, shaper, use_shift_alignment: bool = False):
    """MF -> MF map (reference PV.cpp:421-458). shaper takes (mag, freq)
    tensors and returns (mag, freq). With shift alignment each shaped MF
    moves to the bin its frequency shift points at; the loudest lands, the
    lowest source bin winning a tie (PV.cpp:446-448)."""
    if self.is_null():
        return _null()
    s_mag, s_freq = shaper(self.mag, self.freq)
    s_mag = broadcast_f32(s_mag, self.mag.shape, self.device)
    s_freq = broadcast_f32(s_freq, self.freq.shape, self.device)
    if not use_shift_alignment:
        return self._with(mag=s_mag, freq=s_freq)

    c, f, b = self.mag.shape
    bin_ix = torch.arange(b, device=self.device)
    # C truncation toward zero lands on the float expressions, nested
    # (PV.cpp:440-441): binShift = Bin(bin - f2b(in.f)), then
    # target = Bin(f2b(shaped.f) + binShift)
    bin_shift = torch.trunc(bin_ix.to(torch.float32)
                            - true_div(self.freq, self.bin_width))
    target = torch.trunc(true_div(s_freq, self.bin_width)
                         + bin_shift).to(torch.int64)
    valid = (target >= 0) & (target < b)
    tb = torch.clamp(target, 0, b - 1)
    # out starts cleared and a bin writes only on strict improvement, so
    # the zero init blocks non-positive shaped magnitudes
    out_mag = torch.zeros_like(s_mag).scatter_reduce_(
        2, tb, torch.where(valid, s_mag, -1.0), "amax")
    winner = torch.gather(out_mag, 2, tb)
    tie = valid & (s_mag == winner) & (s_mag > 0)
    src_bin = torch.broadcast_to(bin_ix, s_mag.shape)
    win_src = torch.full(s_mag.shape, b, dtype=torch.int64,
                         device=self.device).scatter_reduce_(
        2, tb, torch.where(tie, src_bin, b), "amin")
    got = torch.gather(s_freq, 2, torch.clamp(win_src, 0, b - 1))
    return self._with(mag=torch.clamp(out_mag, min=0.0),
                      freq=torch.where(win_src < b, got, 0.0))


def _n_loudest_mask(self, num_partials, keep_loudest: bool):
    """Rank bins by |magnitude| per frame (reference
    predicateNLoudestPartials, PV.cpp:552-588); a stable sort, so of equal
    magnitudes the lower bin ranks first."""
    t, _ = _grid(self, self.num_frames)
    n = broadcast_f32(as_function(num_partials)(t), (self.num_frames,),
                      self.device).to(torch.int64)
    order = torch.argsort(-torch.abs(self.mag), dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    keep = ranks < n[None, :, None]
    if not keep_loudest:
        keep = ~keep
    return self._with(mag=torch.where(keep, self.mag, 0.0), freq=self.freq)


def retain_n_loudest_partials(self, num_partials):
    if self.is_null():
        return _null()
    return _n_loudest_mask(self, num_partials, True)


def remove_n_loudest_partials(self, num_partials):
    if self.is_null():
        return _null()
    return _n_loudest_mask(self, num_partials, False)


def resonate(self, length: float, decay):
    """Per-bin exponential decay with a max against the input, extended by
    `length` seconds (reference PV.cpp:602-641, a sequential frame loop):
    y[f] = max(m[f], a[f] y[f-1]) with a = decay(t, f)^(1/analysis_rate),
    a max-affine recurrence along frames; each frequency follows the last
    frame whose input won."""
    if self.is_null():
        return _null()
    extra = int(math.ceil(self.time_to_frame(max(length, 0.0))))
    c, f_in, b = self.mag.shape
    f_out = f_in + extra
    t, fr = _grid(self, f_out)
    dec = torch.clamp(broadcast_f32(as_function2d(decay)(t[:, None],
                                                         fr[None, :]),
                                    (f_out, b), self.device), 0.0, 1.0)
    a = torch.pow(dec, 1.0 / self.analysis_rate)           # [F_out, B]
    m_in = torch.nn.functional.pad(self.mag, (0, 0, 0, extra))
    # the channels share the decay plane; c is 0 (one value for all)
    y = max_affine_recurrence(m_in, a, 0.0, axis=1)
    won = m_in >= y - 1e-12
    # the last frame whose input won, a running max along frames, taken
    # along the innermost axis: torch's CUDA scan along an outer axis took
    # 9.6 ms at 60 s stereo (H100), 19x the recurrence itself
    f_idx = torch.arange(f_out, dtype=torch.int32, device=self.device)
    last_win = torch.cummax(torch.where(won.movedim(1, -1), f_idx, 0)
                            .contiguous(), dim=-1).values
    freq_in = torch.nn.functional.pad(self.freq, (0, 0, 0, extra))
    freq = torch.gather(freq_in.movedim(1, -1), -1, last_win.long())
    return self._with(mag=y.contiguous(), freq=freq.movedim(-1, 1)
                      .contiguous())


def perturb(self, mf_std_dev, damping: float = 0.99, *, seed: int = 0):
    """Randomly perturb the MF data (the reference's commented
    experimental implementation, PV.cpp:460-548, as the JAX package
    activates it): frequency accelerations ~ N(0, f_std(t, f) / 20)
    accumulate through two damped recurrences, along frames per bin and
    then along bins per frame, and land scaled by 200; magnitudes get a
    per-frame random walk ~ N(0, m_std(t, bin 0) / 20) shared by the bins
    of a frame, drawn per channel. mf_std_dev: a (mag_std, freq_std) pair
    or one value for both, each a constant or a Function of (time,
    frequency); negative stds clamp to 0. The noise comes from a generator
    seeded with `seed` on the PV's device."""
    if self.is_null():
        return _null()
    c, nf, nb = self.mag.shape
    gen = torch.Generator(device=self.device).manual_seed(seed)
    noise_acc = torch.randn((nf, nb), generator=gen, dtype=torch.float32,
                            device=self.device)
    noise_mag = torch.randn((c, nf), generator=gen, dtype=torch.float32,
                            device=self.device)
    return _perturb_planes(self, mf_std_dev, damping, noise_acc, noise_mag)


def _perturb_planes(self, mf_std_dev, damping: float,
                    noise_acc: torch.Tensor, noise_mag: torch.Tensor):
    """perturb from its noise: noise_acc [F, B] for the frequency
    accelerations, noise_mag [C, F] for the magnitude walk
    (flan_tpu/pv/algorithms.py:438-480)."""
    try:
        m_in, f_in = mf_std_dev
    except TypeError:
        m_in = f_in = mf_std_dev
    c, nf, nb = self.mag.shape
    t, fr = _grid(self, nf)
    t, fr = t[:, None], fr[None, :]
    m_std = torch.clamp(broadcast_f32(as_function2d(m_in)(t, fr),
                                      (nf, nb), self.device), min=0.0)
    f_std = torch.clamp(broadcast_f32(as_function2d(f_in)(t, fr),
                                      (nf, nb), self.device), min=0.0)

    eps = 1e-5
    accel = torch.where(f_std < eps, 0.0,
                        noise_acc * true_div(f_std, 20.0))
    d = float(np.float32(damping))
    # the reference seeds each recurrence with its own first element and
    # then runs the loop from index 0 reading the seed (PV.cpp:496-523),
    # doubling the first step: v[0] = 2 d a[0] (per bin) and o[0] =
    # 2 d v[0] (per frame), reproduced through y0
    velocs = linear_recurrence(d, d * accel, y0=accel[0], axis=0)
    offs = linear_recurrence(d, d * velocs, y0=velocs[:, 0:1], axis=1)

    mag_std0 = m_std[:, 0]
    steps = torch.where(mag_std0[None, :] < eps, 0.0,
                        noise_mag * true_div(mag_std0, 20.0)[None, :])
    mag_off = torch.cumsum(steps, dim=1)
    return self._with(mag=self.mag + mag_off[:, :, None],
                      freq=self.freq + offs[None] * 200.0)
