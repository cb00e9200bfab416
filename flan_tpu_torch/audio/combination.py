"""Audio combination: mix, join, select, convolve (counterpart of
flan_tpu/audio/combination.py; reference:
src/flan/Audio/AudioCombination.cpp). mix is the universal combiner: join
and select route through it. Bound onto Audio in
flan_tpu_torch/audio/__init__.py (mix, join, select as static methods).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops.fft_conv import fft_convolve_full
from flan_tpu_torch.ops.stft import true_div


def _match_sample_rates(ins: Sequence) -> List:
    """Every input resampled to the highest rate among them (reference
    AudioCombination.cpp:17-35)."""
    max_sr = max(a.sample_rate for a in ins)
    return [a if a.sample_rate == max_sr else a.resample(max_sr)
            for a in ins]


def mix(ins: Sequence, start_times: Optional[Sequence[float]] = None,
        gains: Optional[Sequence] = None):
    """Sum the inputs at start offsets (seconds), each scaled by a gain
    Function of global time (reference AudioCombination.cpp:102-170). More
    gains or start times than inputs reuse the inputs cyclically. The
    result lies on the first input's device."""
    from flan_tpu_torch.audio.audio import Audio
    ins = list(ins)
    if not ins:
        return Audio.create_null()
    start_times = list(start_times) if start_times else []
    gains = list(gains) if gains else []
    num_sources = max(len(ins), len(start_times), len(gains))

    ins = _match_sample_rates(ins)
    initial = len(ins)
    for i in range(initial, num_sources):
        ins.append(ins[i % initial])
    while len(start_times) < num_sources:
        start_times.append(0.0)

    sr = ins[0].sample_rate
    device = ins[0].device
    start_frames = [int(round(t * sr)) for t in start_times]
    num_channels = max(a.num_channels for a in ins)
    num_frames = max(max(0, a.num_frames + s)
                     for a, s in zip(ins, start_frames))
    out = torch.zeros((num_channels, num_frames), dtype=torch.float32,
                      device=device)
    for i, (a, s) in enumerate(zip(ins, start_frames)):
        g = as_function(gains[i]) if i < len(gains) else as_function(1.0)
        data = a.data.to(device)
        if g.is_constant:
            contrib = data * g.constant_value
        else:
            # the gain at global time over the input's span
            # (AudioCombination.cpp:134-139)
            t = true_div(float_iota(a.num_frames, device=device) + s, sr)
            contrib = data * torch.broadcast_to(torch.as_tensor(
                g(t), dtype=torch.float32, device=device),
                (a.num_frames,))[None, :]
        lo, hi = max(0, s), min(num_frames, s + a.num_frames)
        if hi <= lo:
            continue
        out[:a.num_channels, lo:hi] += contrib[:, lo - s:hi - s]
    return Audio(data=out, sample_rate=sr)


def join(ins: Sequence, offset: float = 0.0,
         offsets: Optional[Sequence[float]] = None):
    """Concatenate tip to tail with optional overlaps (reference
    AudioCombination.cpp:205-237). `offsets` takes len(ins) + 1 entries as
    the reference's does; a scalar `offset` applies between all."""
    from flan_tpu_torch.audio.audio import Audio
    ins = [a for a in ins if not a.is_null()]
    if not ins:
        return Audio.create_null()
    if offsets is None:
        offsets = [offset] * (len(ins) + 1)
    if len(offsets) != len(ins) + 1:
        return Audio.create_null()
    start_times = [0.0]
    for i in range(len(ins) - 1):
        start_times.append(start_times[-1] + ins[i].length + offsets[i + 1])
    return mix(ins, start_times)


def select(ins: Sequence, selection,
           start_times: Optional[Sequence[float]] = None):
    """Crossfade between streams by a selection index (reference
    AudioCombination.cpp:239-258): input i's gain is sqrt(1 - |selection(t)
    - i|) within distance 1 of it, else 0."""
    sel = as_function(selection)
    gains = []
    for i in range(len(ins)):
        def balance(t, i=i):
            d = torch.abs(torch.as_tensor(sel(t), dtype=torch.float32) - i)
            return torch.where(d >= 1.0, 0.0,
                               torch.sqrt(torch.clamp(1.0 - d, min=0.0)))
        gains.append(balance)
    return mix(ins, start_times, gains)


def convolve(self, ir, normalize: bool = True):
    """Full FFT convolution with an impulse response, n + m frames long,
    peak-normalised unless told not to (reference
    AudioCombination.cpp:299-353). The impulse response's channels are used
    cyclically when the counts differ, and it is resampled to this audio's
    rate first."""
    from flan_tpu_torch.audio.audio import Audio
    if self.is_null() or ir.is_null():
        return Audio.create_null()
    if ir.sample_rate != self.sample_rate:
        ir = ir.resample(self.sample_rate)
    out_frames = self.num_frames + ir.num_frames
    rows = [c % ir.num_channels for c in range(self.num_channels)]
    h = ir.data.to(self.device)[rows]
    conv = fft_convolve_full(self.data, h)
    conv = torch.nn.functional.pad(conv, (0, out_frames - conv.shape[-1]))
    if normalize:
        peak = torch.max(torch.abs(conv))
        conv = conv / torch.where(peak > 0, peak, 1.0)
    return Audio(data=conv, sample_rate=self.sample_rate)
