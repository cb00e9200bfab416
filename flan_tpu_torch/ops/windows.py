"""Window functions (counterpart of flan_tpu/ops/windows.py).

The reference implements only a symmetric hann window evaluated at
i / (window_size - 1) (reference: src/flan/WindowFunctions.cpp:10).
"""
from __future__ import annotations

import numpy as np
import torch


def hann_window_np(window_size: int) -> np.ndarray:
    """float32 symmetric hann window, built in float64 numpy exactly as
    flan_tpu.ops.windows.hann_window builds it, so both packages hold the
    same bits (reference: Conversions/AudioPV.cpp:30-34)."""
    if window_size == 1:
        return np.ones((1,), np.float32)
    i = np.arange(window_size, dtype=np.float64) / (window_size - 1)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i))).astype(np.float32)


def hann_window(window_size: int, device=None) -> torch.Tensor:
    """Symmetric hann window of length window_size, float32 on `device`."""
    return torch.from_numpy(hann_window_np(window_size)).to(device)


def hann(x: torch.Tensor) -> torch.Tensor:
    """The hann window function on [0, 1]: 0.5 (1 - cos(2 pi x))
    (flan_tpu/ops/windows.py:11)."""
    return 0.5 * (1.0 - torch.cos(2.0 * np.pi * x))
