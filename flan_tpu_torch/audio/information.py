"""Audio information: pitch tracking and envelopes (counterpart of
flan_tpu/audio/information.py; reference:
src/flan/Audio/AudioInformation.cpp). Bound onto Audio in
audio/__init__.py.

The YIN search runs batched over every hop on the audio's device
(ops/dsp_utility.py); the octave-flicker continuity fold works on the
per-hop wavelengths on the host, as in the JAX package. The envelopes are
Functions that answer on the audio's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flan_tpu_torch.core.types import power_of_2_container
from flan_tpu_torch.func.function import Function
from flan_tpu_torch.ops.dsp_utility import (select_wavelength_batched,
                                            yin_d_prime_batched)
from flan_tpu_torch.ops.windows import hann_window


def get_local_wavelength(self, channel: int, start: int,
                         window_size: int = 2048,
                         absolute_cutoff: float = 0.2,
                         minimum_wavelength: int = 10) -> float:
    """The wavelength in frames of one window from `start`, zero-padded
    past the end, 0 where none is found (reference
    AudioInformation.cpp:138-166)."""
    if self.is_null():
        return 0.0
    w = self.data[channel, start:start + window_size]
    w = torch.nn.functional.pad(w, (0, window_size - w.shape[0]))
    dp = yin_d_prime_batched(w[None, :], window_size=window_size)
    return float(select_wavelength_batched(
        dp, absolute_cutoff=absolute_cutoff,
        minimum_wavelength=minimum_wavelength)[0])


def _fold_octave_flicker(out: np.ndarray, min_hops: int) -> None:
    """Short octave-up jumps folded back down, in place (reference
    AudioInformation.cpp:190-226; information.py:64-89)."""
    sus = []
    for i in range(len(out) - 1):
        if out[i] == 0:
            continue
        r = out[i + 1] / out[i]
        if 1.95 < r < 2.05:
            sus.append(i + 1)
    for h in sus:
        sus_len = 0
        while sus_len <= min_hops:
            g = h + sus_len
            if g >= len(out):
                break
            if out[g] != 0:
                r = out[g] / out[h]
                if r < 0.95 or r > 1.05:
                    break
            sus_len += 1
        if sus_len > min_hops:
            break
        out[h:h + sus_len] /= 2.0


def get_local_wavelengths(self, channel: int, start: int = 0, end: int = -1,
                          window_size: int = 2048, hop: int = 128,
                          absolute_cutoff: float = 0.2,
                          minimum_wavelength: int = 10) -> np.ndarray:
    """Each hop's wavelength in frames from `start` to `end` (-1: the
    audio's end), float32 on the host, with the octave-flicker continuity
    fold (reference AudioInformation.cpp:168-229)."""
    if self.is_null():
        return np.zeros((0,), np.float32)
    if end == -1:
        end = self.num_frames
    starts = np.arange(start, max(start, end - window_size), hop)
    if len(starts) == 0:
        return np.zeros((0,), np.float32)
    dev = self.device
    idx = torch.from_numpy(starts[:, None]
                           + np.arange(window_size)[None, :]).to(dev)
    windows = self.data[channel][idx.clamp(0, self.num_frames - 1)]
    windows = torch.where(idx < self.num_frames, windows, 0.0)
    dp = yin_d_prime_batched(windows, window_size=window_size)
    out = select_wavelength_batched(
        dp, absolute_cutoff=absolute_cutoff,
        minimum_wavelength=minimum_wavelength).cpu().numpy().astype(
            np.float64)
    min_hops = int(self.time_to_frame(0.1) / hop)   # a note of 0.1 s
    _fold_octave_flicker(out, min_hops)
    return out.astype(np.float32)


def get_average_wavelength(self, locals_or_channel, min_active_ratio=0.0,
                           max_length_sigma=-1.0, start=0, end=-1,
                           window_size=2048, hop=128) -> float:
    """The mean of the non-zero local wavelengths, -1 where too few hops
    are active or they spread more than max_length_sigma (reference
    AudioInformation.cpp:231-265)."""
    if self.is_null():
        return 0.0
    if isinstance(locals_or_channel, (int, np.integer)):
        locals_ = get_local_wavelengths(self, locals_or_channel, start, end,
                                        window_size, hop)
    else:
        locals_ = np.asarray(locals_or_channel)
    num_valid = int((locals_ != -1).sum())
    if num_valid <= min_active_ratio * len(locals_):
        return -1.0
    valid = locals_[locals_ != 0]
    if len(valid) == 0:
        return -1.0
    m, sd = float(valid.mean()), float(valid.std())
    if max_length_sigma != -1 and sd > max_length_sigma:
        return -1.0
    return m


def get_local_frequency(self, channel: int, start: int = 0,
                        window_size: int = 2048) -> float:
    """(reference AudioInformation.cpp:267-294)"""
    wl = get_local_wavelength(self, channel, start, window_size, 0.2, 10)
    return self.sample_rate / wl if wl > 0 else 0.0


def get_local_frequencies(self, channel: int, start: int = 0, end: int = -1,
                          window_size: int = 2048, hop: int = 128
                          ) -> np.ndarray:
    """(reference AudioInformation.cpp:296-318)"""
    wl = get_local_wavelengths(self, channel, start, end, window_size, hop,
                               0.2, 10)
    out = np.where(wl != 0, self.sample_rate / np.where(wl != 0, wl, 1.0),
                   0.0)
    return out.astype(np.float32)


def _lerp_function(ys: torch.Tensor, rate: float, size: int) -> Function:
    """The function of time t reading ys at x = t rate, linearly between
    neighbours, 0 outside [0, size - 1); it answers on ys's device."""
    def fn(t):
        x = torch.as_tensor(t, dtype=torch.float32, device=ys.device) * rate
        x1 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(size - 2, 0))
        y1 = ys[x1]
        y2 = ys[torch.clamp(x1 + 1, max=size - 1)]
        out = y1 + (y2 - y1) * (x - x1)
        return torch.where((x >= 0) & (x < size - 1), out, 0.0)
    return Function(fn)


def get_amplitude_envelope(self, window_width: float = 0.1) -> Function:
    """The rectified mono mix smoothed by a hann window by FFT
    convolution, with the reference's pi/2 compensation (reference
    AudioInformation.cpp:320-363)."""
    if self.is_null() or window_width <= 0:
        return Function(0.0)
    rectified = torch.abs(self.convert_to_mono().data[0])
    wframes = int(self.time_to_frame(window_width))
    win = hann_window(max(wframes, 2), rectified.device)
    integral = float(win.sum())
    n = rectified.shape[0] + wframes
    dft = 2 * power_of_2_container(max(rectified.shape[0], wframes))
    spec = (torch.fft.rfft(rectified, n=dft) * torch.fft.rfft(win, n=dft))
    env = torch.fft.irfft(spec, n=dft)[:n] * (math.pi / 2.0 / integral)
    return _lerp_function(env, self.sample_rate, int(n))


def get_frequency_envelope(self) -> Function:
    """The local frequencies of the mono mix (window 2048, hop 128), read
    linearly between hops (reference AudioInformation.cpp:388-407)."""
    hop = 128
    freqs = get_local_frequencies(self.convert_to_mono(), 0, 0, -1, 2048,
                                  hop)
    if freqs.shape[0] == 0:
        return Function(0.0)
    return _lerp_function(torch.from_numpy(freqs).to(self.device),
                          self.sample_rate / hop, int(freqs.shape[0]))
