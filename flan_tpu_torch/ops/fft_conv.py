"""Full linear convolution by FFT (counterpart of flan_tpu/ops/fft_conv.py;
reference: AudioCombination.cpp:299-353, one whole-signal FFTW transform).

The JAX package blocks the signal into overlap-save transforms of its
matmul FFT (rfft_mxu), a workaround for the TPU's slow long FFTs. On the
card cuFFT (through torch.fft) takes the whole signal in one transform of
the next power of two: 2^25 points for 600 s stereo with a 2 s impulse
response, about 1 GB of spectra.
"""
from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def fft_convolve_full(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution along the last axis: x [C, n] with h [C, m]
    -> [C, n + m - 1] (callers pad or trim to their length conventions).
    Convolution commutes, so the longer operand is taken as the signal, as
    the JAX package does."""
    c, n = x.shape
    if h.shape[0] != c:
        raise ValueError(f"fft_convolve_full: {c} channels of signal, "
                         f"{h.shape[0]} of impulse response")
    m = h.shape[-1]
    if m > n:
        return fft_convolve_full(h, x)
    size = _next_pow2(n + m - 1)
    spec = torch.fft.rfft(x, n=size) * torch.fft.rfft(h, n=size)
    return torch.fft.irfft(spec, n=size)[:, :n + m - 1]
