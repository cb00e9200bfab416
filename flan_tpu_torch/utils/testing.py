"""Verification helpers mirroring the reference's manual test tools
(counterpart of flan_tpu/utils/testing.py).

The reference verifies filters by graphing sweep responses and
spectrograms (reference tests/flanTest.cpp:59-131: `test` ms-per-call
timing, `frequency_response_1d`, `frequency_response_2d`). These helpers
give the same oracles programmatically. The audio they make goes to
`device`, the card unless named.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from flan_tpu_torch.core.types import DEFAULT_DEVICE


def frequency_response_1d(filter_fn: Callable, sample_rate: float = 8000.0,
                          freqs: Sequence[float] = None,
                          seconds: float = 0.5,
                          device=DEFAULT_DEVICE) -> np.ndarray:
    """Steady-state gain of filter_fn(Audio) at probe frequencies.

    Returns [len(freqs)] linear gains (the reference graphs an exponential
    sine sweep's envelope; discrete probes give the same curve points)."""
    from flan_tpu_torch.audio.audio import Audio
    if freqs is None:
        freqs = np.geomspace(40.0, sample_rate / 2 * 0.9, 16)
    gains = []
    n = int(seconds * sample_rate)
    t = np.arange(n, dtype=np.float32) / sample_rate
    for f in freqs:
        x = Audio.create_from_array(
            (0.5 * np.sin(2 * np.pi * f * t))[None], sample_rate,
            device=device)
        a = filter_fn(x).to_numpy()[0]
        sl = slice(n // 2, min(len(a), n) - 64)
        gains.append(float(np.sqrt((a[sl] ** 2).mean())
                           / np.sqrt((x.to_numpy()[0][sl] ** 2).mean())))
    return np.asarray(gains)


def frequency_response_2d(filter_fn: Callable, sample_rate: float = 8000.0,
                          seconds: float = 1.0, *, seed: int = 0,
                          device=DEFAULT_DEVICE):
    """White noise through filter_fn -> PV spectrogram Graph
    (reference tests/flanTest.cpp:104-131)."""
    from flan_tpu_torch.audio.synthesis import synthesize_white_noise
    noise = synthesize_white_noise(seconds, sample_rate, oversample=1,
                                   seed=seed, device=device)
    return filter_fn(noise).convert_to_PV(512, 64, 512).convert_to_graph()


def spectrum_peak_hz(audio, start: int, count: int,
                     channel: int = 0) -> float:
    """Dominant frequency of a slice (test oracle)."""
    x = audio.to_numpy()[channel, start:start + count]
    spec = np.abs(np.fft.rfft(x))
    return float(spec.argmax() * audio.sample_rate / count)
