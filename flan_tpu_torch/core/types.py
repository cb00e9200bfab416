"""Numeric conventions (counterpart of flan_tpu/core/types.py): dB <->
amplitude and the power-of-two container size (reference:
src/flan/defines.h, FFTHelper.h).
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor, float, int]

# Where host data (numpy arrays, lists, files) goes unless the caller names
# a device: the port runs on the card, and the CPU only when asked for.
# Without a card the default raises, as torch raises.
DEFAULT_DEVICE = "cuda"


def float_iota(start: int, end: int = None, device=None) -> torch.Tensor:
    """The float32 grid start, start + 1, ..., end - 1 (end alone: 0 ..
    start - 1) as jnp.arange(start, end, dtype=float32) makes it: each
    index i rounded to float32 once, plus start in float32 where start is
    not 0. torch.arange in float32 steps by repeated adds and lands up to
    a few units off past 2^24 elements (ROADMAP C.18)."""
    if end is None:
        start, end = 0, start
    grid = torch.arange(end - start, dtype=torch.int64,
                        device=device).to(torch.float32)
    return grid if start == 0 else grid + float(np.float32(start))


def decibel_to_amplitude(db: ArrayLike) -> ArrayLike:
    """dB -> linear amplitude."""
    if isinstance(db, (float, int)):
        return 10.0 ** (db / 20.0)
    return torch.pow(10.0, torch.as_tensor(db, dtype=torch.float32) / 20.0)


def amplitude_to_decibel(amp: ArrayLike) -> ArrayLike:
    """Linear amplitude -> dB."""
    if isinstance(amp, (float, int)):
        return 20.0 * math.log10(max(amp, 1e-38))
    amp = torch.as_tensor(amp, dtype=torch.float32)
    return 20.0 * torch.log10(torch.clamp(amp, min=1e-38))


def power_of_2_container(x: int) -> int:
    """Smallest power of two >= x (reference FFTHelper.h)."""
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()
