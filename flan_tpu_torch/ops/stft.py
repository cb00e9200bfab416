"""STFT phase-vocoder forward/inverse (counterpart of flan_tpu/ops/stft.py;
reference: src/flan/Conversions/AudioPV.cpp:12-139, phase_vocoder.cpp:5-61).

The forward transform is a batched program per chunk of hops: frame, window,
rFFT (cuFFT on the card through torch.fft), polar, and the lag-1 phase
difference, with the last phase of one chunk carried into the next. The
inverse accumulates phase as cycles modulo 1, so float32 keeps its
precision over long signals, and overlap-adds each chunk's windowed frames
into one output stream with slice-adds. Peak memory beyond the input and
output planes is one chunk of hops.

Quirks kept from the reference, as the JAX package keeps them: the
num_hops integer floor, frames centred at -window/2, zero initial phase,
round-half-even phase wrap, and the 2.67 overlap-add gain rescaled for the
normalised irFFT.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flan_tpu_torch.ops.fastmath import atan2 as _fast_atan2
from flan_tpu_torch.ops.windows import hann_window

_TWO_PI = 2.0 * math.pi
_MOD1_BLOCK = 256  # frames per within-block cumsum in cumsum_mod1_frames


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, correctly rounded on every device. torch's CUDA kernels turn
    division by a Python scalar into multiplication by its rounded
    reciprocal, a bias of up to one ulp in every element that the phase
    accumulators would integrate over every frame."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def cpu_exact(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for fn torch.sqrt, torch.log2 or torch.sin, with a float32 CPU
    tensor evaluated in float64 and rounded back. torch's float32 CPU sqrt
    and log2 can be off by up to 3e-4 relative in the part of a call that
    an intra-op worker thread computes the first time it runs them (torch
    2.13 on an AVX-512 CPU, in one process in two to ten), so a plain
    version gave two outputs for one input; its sin likewise (the second
    half of a 2,400-element call up to 2,522 ulps off, in one fresh
    process in 96 and one in 192). Rounded back from float64 the result
    stays within one float32 ulp. On the card fn runs in float32."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return fn(x.double()).to(x.dtype)
    return fn(x)


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


def _wrap_radians(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi] with round-half-even (reference
    phase_vocoder.cpp:38-41; torch.round rounds half to even, as
    jnp.round does)."""
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def rfft_mag_phase(x: torch.Tensor, n: int):
    """(|X|, arg X) of the real FFT of x [..., m] zero-padded to n.

    The phase is the polynomial atan2 (ops/fastmath.py); zero-energy points
    get phase 0, as in the JAX package."""
    spec = torch.fft.rfft(x, n=n, dim=-1)
    re, im = spec.real, spec.imag
    energy = re * re + im * im
    dead = energy == 0.0
    phase = _fast_atan2(torch.where(dead, 0.0, im), torch.where(dead, 1.0, re))
    return cpu_exact(torch.sqrt, energy), phase


def irfft_polar(mag: torch.Tensor, phase: torch.Tensor, n: int):
    """Inverse real FFT of mag * exp(i phase) [..., n//2+1] -> [..., n]."""
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return torch.fft.irfft(spec, n=n, dim=-1)


def cumsum_mod1_frames(inc: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum modulo 1 along axis 1 of [C, F, B].

    Within blocks of 256 frames the prefix is a plain cumsum; the blocks
    chain through a mod-1 prefix of their totals, as in the JAX package
    (which forms the within-block prefix as a triangular matmul and the
    chain as an associative scan). The sums run in float64 and the result
    is cast back: torch's CPU cumsum accumulates in float64 and its CUDA
    cumsum in float32, and a float32 block sum reaching 256 cycles keeps
    only ~1e-4 cycles of phase, so float64 makes the result the same on
    every device to the final rounding.
    """
    c, f, b = inc.shape
    blk = _MOD1_BLOCK
    fpad = _cdiv(f, blk) * blk
    x = inc.to(torch.float64)
    if fpad != f:
        x = torch.nn.functional.pad(x, (0, 0, 0, fpad - f))
    within = torch.cumsum(x.reshape(c, fpad // blk, blk, b), dim=2)
    totals = torch.remainder(within[:, :, -1, :], 1.0)         # [C, nb, B]
    prefix = torch.remainder(torch.cumsum(totals, dim=1), 1.0)
    prefix = torch.nn.functional.pad(prefix[:, :-1], (0, 0, 1, 0))
    out = torch.remainder(within + prefix[:, :, None, :], 1.0)
    return out.reshape(c, fpad, b)[:, :f].to(inc.dtype)


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
        m, phase = rfft_mag_phase(framed, dft_size)
        prev = torch.cat([prev_phase, phase[:, :-1]], dim=1)
        delta = _wrap_radians(phase - prev - expected)
        mag[:, start:start + h] = m
        freq[:, start:start + h] = bin_freq + delta * (analysis_rate
                                                       / _TWO_PI)
        prev_phase = phase[:, -1:]
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
        inc = torch.remainder(true_div(freq[:, start:start + h],
                                       analysis_rate), 1.0)
        cycles = torch.remainder(cumsum_mod1_frames(inc) + cycle0, 1.0)
        frames = irfft_polar(mag[:, start:start + h], cycles * _TWO_PI,
                             dft_size)[..., :wpad] * window
        blocks = frames.reshape(c, h, r, hop)
        for j in range(r):
            stream[:, start + j:start + j + h] += blocks[:, :, j]
        cycle0 = cycles[:, -1:]
    shift = window_size // 2
    return stream.reshape(c, (f + r) * hop)[:, shift:shift + f * hop]
