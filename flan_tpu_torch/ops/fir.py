"""FIR application via block FFT convolution, and IIR -> FIR truncation
(counterpart of flan_tpu/ops/fir.py).

The constant-coefficient fast path of the filter family. A stable LTI
filter's impulse response decays like r^n, so truncating it where its tail
falls below the float32 noise floor turns the recurrence into an FFT
convolution:

    signal -> non-overlapping blocks of L -> rfft(block) * rfft(h)
           -> irfft -> overlap-add the k-1 tail into the next block

The transforms are torch.fft (cuFFT on the card), where the JAX package
used its matmul FFT for the TPU. The response is found by running the
filter's own scan path on a unit impulse and doubling its length until the
tail is quiet, so the kernels of ops/scan.py run here too.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _fir_blocks(x: torch.Tensor, h: torch.Tensor, fft_size: int):
    """Causal conv of x [C, N] with h [K], output [C, N]; K <= fft_size/2
    (fir.py:40-61)."""
    c, n = x.shape
    k = h.shape[0]
    L = fft_size - k + 1
    nb = _cdiv(n, L)
    xp = torch.nn.functional.pad(x, (0, nb * L - n)).reshape(c, nb, L)
    full = torch.fft.irfft(torch.fft.rfft(xp, n=fft_size)
                           * torch.fft.rfft(h, n=fft_size), n=fft_size)
    heads = full[..., :L]
    tails = full[..., L:L + k - 1]                  # [C, nb, k-1]
    tails_prev = torch.nn.functional.pad(tails[:, :-1],
                                         (0, L - (k - 1), 1, 0))
    return (heads + tails_prev).reshape(c, nb * L)[:, :n]


def fir_apply(x: torch.Tensor, h) -> torch.Tensor:
    """Causal FIR: y[i] = sum_j h[j] x[i-j], same length as x [C, N]; h a
    host array or tensor [K]. The block size scales with K as in the JAX
    package (fir.py:64-74)."""
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    k = int(h.shape[0])
    fft_size = min(max(_next_pow2(2 * k), 8192), 1 << 18)
    if fft_size < 2 * k:  # K beyond the block cap: grow to fit
        fft_size = _next_pow2(2 * k)
    return _fir_blocks(x, h, fft_size)


# host cache of truncated responses: (cache_key, device type) -> (K, h)
_IR_CACHE: dict = {}


def impulse_response(run_data: Callable[[torch.Tensor], torch.Tensor],
                     max_len: int, *, device, start_len: int = 4096,
                     eps: float = 1e-8, tail_window: int = 1024,
                     cache_key=None) -> Optional[np.ndarray]:
    """Truncated impulse response of a linear constant-parameter filter
    (fir.py:77-122).

    run_data maps data [1, K] -> [1, K] on `device` (the filter's own scan
    path applied to a unit impulse). Doubles K until the trailing
    tail_window samples fall below eps * peak, or K would reach max_len -
    then the FIR holds no advantage over the scan and None is returned.
    cache_key (the filter type, its constant parameters and the sample
    rate) memoizes the host response per device type, so a CPU run and a
    card run each use the response their own scans produced.
    """
    key = None if cache_key is None else (cache_key, torch.device(device).type)
    if key is not None and key in _IR_CACHE:
        k_found, h = _IR_CACHE[key]
        if h is not None:
            # a response longer than this signal holds no advantage
            return h if h.shape[0] <= max_len else None
        if k_found >= max_len:
            return None  # previously failed to converge within this length
    k = min(start_len, _next_pow2(max_len))
    while True:
        imp = torch.zeros((1, k), dtype=torch.float32, device=device)
        imp[0, 0] = 1.0
        h = run_data(imp)[0].cpu().numpy()
        peak = float(np.abs(h).max())
        tail = float(np.abs(h[-min(tail_window, k // 4):]).max())
        if tail <= eps * max(peak, 1e-20):
            if key is not None:
                _IR_CACHE[key] = (k, h)
            # K can overshoot max_len when the last doubling crosses it
            return h if h.shape[0] <= max_len else None
        if k >= max_len:
            if key is not None:
                _IR_CACHE[key] = (k, None)
            return None
        k *= 2
