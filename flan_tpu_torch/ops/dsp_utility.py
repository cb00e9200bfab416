"""DSP utility: parabolic interpolation, peaks and valleys, mean and sd, and
the batched YIN pitch search (counterpart of flan_tpu/ops/dsp_utility.py;
reference: src/flan/DSPUtility.cpp, AudioInformation.cpp:18-75).

The peak, valley, parabolic and mean/sd helpers work on small control
arrays and stay on the host in numpy, copied from the JAX package. The YIN
difference function and the valley choice run in torch over every analysis
hop at once, on the windows' device: the modified autocorrelation as an FFT
correlation (torch.fft), the valley choice as masks and a first-index
search.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def parabolic_interpolation(y0, y1, y2, x1):
    """Vertex (x, y) of the parabola through (x1 - 1, y0), (x1, y1), (x1 +
    1, y2) (reference DSPUtility.cpp:37-44); numpy."""
    y0, y1, y2 = (np.asarray(v) for v in (y0, y1, y2))
    denom = y0 - 2.0 * y1 + y2
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom, 0.0)
    return x1 + delta, y1 - 0.25 * (y0 - y2) * delta


def find_peaks(data: np.ndarray, max_peaks: int = -1,
               amp_order: bool = False, interpolate: bool = True
               ) -> np.ndarray:
    """Local maxima of a 1-D array as [(x, y)], the reference's semantics
    (DSPUtility.cpp:55-131): a point is a peak when runs of equal values
    reach a strictly lower neighbour on both sides (a flat shoulder or a
    plateau at an edge is none); a plateau gives one entry at its centre,
    x = (left + right) / 2 when interpolating, y uninterpolated. Host numpy
    over run-length-encoded runs of equal values."""
    d = np.asarray(data, np.float64)
    n = len(d)
    if n < 3:
        return np.zeros((0, 2))
    change = np.nonzero(np.diff(d) != 0.0)[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change, [n - 1]])
    vals = d[starts]
    interior = (starts > 0) & (ends < n - 1)
    is_peak = np.zeros(len(starts), bool)
    is_peak[interior] = (d[starts[interior] - 1] < vals[interior]) & (
        d[ends[interior] + 1] < vals[interior])
    s, e, v = starts[is_peak], ends[is_peak], vals[is_peak]
    plateau = e > s
    frame = np.where(plateau, (s + e) // 2, s)
    if interpolate:
        y0 = d[np.maximum(frame - 1, 0)]
        y2 = d[np.minimum(frame + 1, n - 1)]
        denom = y0 - 2 * v + y2
        with np.errstate(divide="ignore", invalid="ignore"):
            delta = np.where(np.abs(denom) > 1e-12,
                             0.5 * (y0 - y2) / denom, 0.0)
        xs = np.where(plateau, (s - 1 + e + 1) / 2.0, frame + delta)
        ys = np.where(plateau, v, v - 0.25 * (y0 - y2) * delta)
    else:
        xs = frame.astype(np.float64)
        ys = v
    peaks = np.stack([xs, ys], axis=-1)
    if amp_order:
        peaks = peaks[np.argsort(-peaks[:, 1], kind="stable")]
    if max_peaks != -1:
        peaks = peaks[:max_peaks]
    return peaks


def find_valleys(data: np.ndarray, max_peaks: int = -1,
                 amp_order: bool = False, interpolate: bool = True
                 ) -> np.ndarray:
    """Local minima, as find_peaks of the negated data."""
    p = find_peaks(-np.asarray(data, np.float64), max_peaks, amp_order,
                   interpolate)
    if len(p):
        p[:, 1] *= -1
    return p


def mean_and_sd(data) -> Tuple[float, float]:
    d = np.asarray(data, np.float64)
    if d.size == 0:
        return 0.0, 0.0
    return float(d.mean()), float(d.std())


def yin_d_prime_batched(windows: torch.Tensor, *, window_size: int
                        ) -> torch.Tensor:
    """YIN's cumulative-mean-normalised difference function of a batch of
    windows [H, window_size] -> d' [H, window_size // 2], float32 on the
    windows' device (dsp_utility.py:94-128). The modified autocorrelation
    is the full window against its first half, one FFT correlation per
    hop (reference compute_d, AudioInformation.cpp:18-57); irfft's 1 / n
    is the reference's division of its FFTW result by n. The power terms
    and the normalisation are float32 cumulative sums, whose order differs
    between devices: d' agrees to float32 accuracy, not to the bit."""
    n = window_size
    half = n // 2
    dev = windows.device
    sq = windows * windows
    csum0 = torch.nn.functional.pad(torch.cumsum(sq, dim=-1), (1, 0))
    taus = torch.arange(half, device=dev)
    power = csum0[..., taus + half] - csum0[..., taus]
    full_fft = torch.fft.rfft(windows, n=n, dim=-1)
    first = torch.where(torch.arange(n, device=dev) < half, windows, 0.0)
    half_fft = torch.fft.rfft(first, n=n, dim=-1)
    corr = torch.fft.irfft(full_fft * torch.conj(half_fft), n=n,
                           dim=-1)[..., :half]
    d = power[..., :1] + power - 2.0 * corr
    dsum = torch.cumsum(d[..., 1:], dim=-1)
    dp = torch.where(dsum > 0, d[..., 1:] * taus[1:].to(d.dtype) / dsum, 1.0)
    return torch.cat([torch.ones_like(d[..., :1]), dp], dim=-1)


def select_wavelength_batched(d_prime: torch.Tensor, *,
                              absolute_cutoff: float = 0.2,
                              minimum_wavelength: int = 10) -> torch.Tensor:
    """Each hop's wavelength from d' [H, half] (reference
    Audio::get_local_wavelength, AudioInformation.cpp:138-166;
    dsp_utility.py:131-164): the lowest valley past minimum_wavelength,
    then the smallest-lag valley whose interpolated y is below twice that
    minimum (the bare 2x band of the reference: a negative minimum admits
    none, and the hop reads 0), and 0 where its y is not below the cutoff.
    Returns [H] float32 on d''s device."""
    h, half = d_prime.shape
    y0, y1, y2 = d_prime[:, :-2], d_prime[:, 1:-1], d_prime[:, 2:]
    is_valley = (y1 < y0) & (y1 <= y2)
    lag = torch.arange(1, half - 1, device=d_prime.device)[None, :]
    denom = y0 - 2.0 * y1 + y2
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (y0 - y2) / denom, 0.0)
    xs = lag + delta
    ys = y1 - 0.25 * (y0 - y2) * delta
    valid = is_valley & (xs > minimum_wavelength)
    min_y = torch.where(valid, ys, 1e30).amin(dim=-1, keepdim=True)
    near = valid & (ys < min_y * 2.0)
    first = torch.argmax(near.to(torch.int8), dim=-1, keepdim=True)
    any_near = near.any(dim=-1)
    best_x = torch.where(any_near, xs.gather(-1, first)[:, 0], 0.0)
    best_y = torch.where(any_near, ys.gather(-1, first)[:, 0], 0.0)
    return torch.where(best_y < absolute_cutoff, best_x, 0.0)
