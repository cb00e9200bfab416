"""STFT phase-vocoder forward/inverse (counterpart of flan_tpu/ops/stft.py;
reference: src/flan/Conversions/AudioPV.cpp:12-139, phase_vocoder.cpp:5-61).

The forward transform is a batched program per chunk of hops: frame, window,
rFFT (cuFFT on the card through torch.fft), then the analysis epilogue
(ops/pv_stages.py: H1 on the card): polar, and the lag-1 phase
difference, with the last phase of one chunk carried into the next. The
inverse accumulates phase as cycles modulo 1, so float32 keeps its
precision over long signals (the synthesis prologue, H2 on the card,
builds each chunk's polar spectrum), and overlap-adds each chunk's windowed
frames into one output stream with slice-adds. Peak memory beyond the
input and output planes is one chunk of hops.

Quirks kept from the reference, as the JAX package keeps them: the
num_hops integer floor, frames centred at -window/2, zero initial phase,
round-half-even phase wrap, and the 2.67 overlap-add gain rescaled for the
normalised irFFT.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops import pv_stages
# stft's names for the shared numerics, which its importers take from here
from flan_tpu_torch.ops.phase_math import (_MOD1_BLOCK, _TWO_PI, _cdiv,
                                           _wrap_radians, cpu_exact,
                                           cumsum_mod1_frames, true_div)
from flan_tpu_torch.ops.windows import hann_window


def num_hops(num_frames: int, hop: int) -> int:
    """PV frame count: N // hop + 1 (reference AudioPV.cpp:17).

    The reference writes `std::ceil(get_num_frames() / hopSize) + 1` with
    int32 operands, so the division floors before ceil sees it.
    """
    return num_frames // hop + 1


def _frame_signal(x: torch.Tensor, start_hop: int, chunk_hops: int,
                  hop: int, window_size: int) -> torch.Tensor:
    """Frames for hops [start_hop, start_hop + chunk_hops) of x [C, N], as
    [C, chunk_hops, window_size], zero outside the signal. Frame i starts
    at sample i * hop - window_size // 2 (reference AudioPV.cpp:52-65)."""
    c, n = x.shape
    s0 = start_hop * hop - window_size // 2
    s1 = s0 + (chunk_hops - 1) * hop + window_size
    lo, hi = max(s0, 0), min(s1, n)
    if hi <= lo:
        return x.new_zeros((c, chunk_hops, window_size))
    span = torch.nn.functional.pad(x[:, lo:hi], (lo - s0, s1 - hi))
    return span.unfold(-1, window_size, hop)


def bin_frequencies(nbins: int, bin_hz: float, frame_rate: float,
                    dtype=torch.float32, device=None):
    """(bin_freq, expected): each bin's centre frequency, b * bin_hz, and
    its expected phase advance per frame in radians, bin_freq / frame_rate
    * 2 pi (phase_vocoder.cpp:47), in the JAX package's float32 operation
    order. Built in numpy on the host, so every device gets the same bits."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    bin_freq = np.arange(nbins, dtype=npdt) * npdt(bin_hz)
    expected = bin_freq / npdt(frame_rate) * npdt(_TWO_PI)
    return (torch.from_numpy(bin_freq).to(device),
            torch.from_numpy(expected).to(device))


def pv_forward(x: torch.Tensor, *, window_size: int = 2048, hop: int = 128,
               dft_size: int = 4096, sample_rate: float = 48000.0,
               chunk_hops: int = 2048):
    """Audio [C, N] -> (mag, freq) each [C, num_hops, dft/2+1] float32.

    Matches reference Audio::convert_to_PV (AudioPV.cpp:12-78): hann
    analysis window of window_size, zero-padded to dft_size, r2c FFT,
    per-bin phase vocoding with zero initial phase.
    """
    c, n = x.shape
    nh = num_hops(n, hop)
    nbins = dft_size // 2 + 1
    analysis_rate = sample_rate / hop
    dev = x.device

    window = hann_window(window_size, dev)
    bin_freq, expected = bin_frequencies(nbins, sample_rate / dft_size,
                                         analysis_rate, device=dev)

    mag = torch.empty((c, nh, nbins), dtype=torch.float32, device=dev)
    freq = torch.empty_like(mag)
    prev_phase = torch.zeros((c, 1, nbins), dtype=torch.float32, device=dev)
    for start in range(0, nh, chunk_hops):
        h = min(chunk_hops, nh - start)
        framed = _frame_signal(x, start, h, hop, window_size) * window
        spec = torch.fft.rfft(framed, n=dft_size, dim=-1)
        _, _, prev_phase = pv_stages.analysis(
            spec, bin_freq, expected, analysis_rate, prev=prev_phase,
            out=(mag[:, start:start + h], freq[:, start:start + h]))
    return mag, freq


def pv_inverse(mag: torch.Tensor, freq: torch.Tensor, *,
               window_size: int = 2048, hop: int = 128,
               sample_rate: float = 48000.0, chunk_hops: int = 2048):
    """(mag, freq) [C, F, B] -> audio [C, F * hop] float32.

    Matches reference PV::convert_to_audio (AudioPV.cpp:86-139): per-bin
    phase accumulation of freq / analysis_rate revolutions per frame, c2r
    FFT, overlap-add with a hann window scaled by the reference's empirical
    2.67 round-trip gain constant (AudioPV.cpp:99).
    """
    c, f, nbins = mag.shape
    dft_size = 2 * (nbins - 1)
    analysis_rate = sample_rate / hop
    dev = mag.device

    # window padded to a hop multiple so overlap-add is r block slice-adds
    wpad = _cdiv(window_size, hop) * hop
    r = wpad // hop
    # The reference scale assumes FFTW's unnormalized c2r; torch.fft.irfft
    # divides by dft_size, so fold that back in.
    window_scale = 2.67 / (dft_size * window_size / hop) * dft_size
    window = torch.zeros(wpad, dtype=torch.float32, device=dev)
    window[:window_size] = hann_window(window_size, dev) * window_scale

    # Block a of the stream holds output samples [hop*a - window/2,
    # hop*a - window/2 + hop); the r blocks past the last frame are the
    # overlap-add tail.
    stream = torch.zeros((c, f + r, hop), dtype=torch.float32, device=dev)
    cycle0 = torch.zeros((c, 1, nbins), dtype=torch.float32, device=dev)
    for start in range(0, f, chunk_hops):
        h = min(chunk_hops, f - start)
        spec, cycle0 = pv_stages.synthesis(
            mag[:, start:start + h], freq[:, start:start + h], cycle0,
            analysis_rate)
        frames = torch.fft.irfft(spec, n=dft_size, dim=-1)[..., :wpad] * window
        blocks = frames.reshape(c, h, r, hop)
        for j in range(r):
            stream[:, start + j:start + j + h] += blocks[:, :, j]
    shift = window_size // 2
    return stream.reshape(c, (f + r) * hop)[:, shift:shift + f * hop]
