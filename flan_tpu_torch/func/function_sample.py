"""FunctionSample: constant-optimised sampled-function containers on tensors
(counterpart of flan_tpu/func/function_sample.py; reference:
src/flan/FunctionSample.h:18-199).

A sampled Function is either a scalar (the constant short-circuit, O(1)
storage) or a float32 tensor; the container gives the reference's
transform / accumulate / scan / maximum surface on both. Constants
materialise on `device`, the CPU unless named, since they hold no data of
their own.
"""
from __future__ import annotations

from typing import Callable

import torch


def _is_scalar(value) -> bool:
    return isinstance(value, (int, float)) or (
        hasattr(value, "shape") and tuple(value.shape) == ())


class FunctionSample:
    """A constant or a 1-D sampled tensor."""

    def __init__(self, value, size: int, device=None):
        self._size = int(size)
        self._device = device
        if _is_scalar(value):
            self._const, self._vec = float(value), None
        else:
            self._const = None
            self._vec = torch.as_tensor(value, dtype=torch.float32,
                                        device=device)
            self._device = self._vec.device

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    def get_constant(self) -> float:
        return self._const

    def as_array(self) -> torch.Tensor:
        if self._const is not None:
            return torch.full((self._size,), self._const,
                              dtype=torch.float32, device=self._device)
        return self._vec

    def __len__(self) -> int:
        return self._size

    def __getitem__(self, i):
        if self._const is not None:
            return self._const
        return self._vec[i]

    def transform(self, f: Callable) -> "FunctionSample":
        """(reference FunctionSample.h transform)"""
        if self._const is not None:
            out = f(torch.tensor(self._const, dtype=torch.float32))
            return FunctionSample(float(out), self._size, self._device)
        return FunctionSample(f(self._vec), self._size, self._device)

    # the reference's mutating for_each is transform on immutable samples
    for_each = transform

    def accumulate(self) -> float:
        if self._const is not None:
            return self._const * self._size
        return float(torch.sum(self._vec))

    def exclusive_scan(self, init: float = 0.0,
                       op: str = "add") -> "FunctionSample":
        if op != "add":
            raise ValueError("only additive exclusive_scan is provided")
        a = self.as_array()
        scanned = torch.cat([torch.full((1,), init, dtype=a.dtype,
                                        device=a.device),
                             init + torch.cumsum(a, 0)[:-1]])
        return FunctionSample(scanned, self._size, self._device)

    def maximum(self, key: Callable = None) -> float:
        a = self.as_array()
        if key is not None:
            a = key(a)
        return float(torch.max(a))


class FunctionSample2d:
    """A constant or a 2-D sampled grid (frames x bins)."""

    def __init__(self, value, num_frames: int, num_bins: int, device=None):
        self._shape = (int(num_frames), int(num_bins))
        self._device = device
        if _is_scalar(value):
            self._const, self._grid = float(value), None
        else:
            self._const = None
            self._grid = torch.as_tensor(value, dtype=torch.float32,
                                         device=device)
            self._device = self._grid.device

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    def as_array(self) -> torch.Tensor:
        if self._const is not None:
            return torch.full(self._shape, self._const, dtype=torch.float32,
                              device=self._device)
        return torch.broadcast_to(self._grid, self._shape)

    def at(self, frame: int, b: int):
        if self._const is not None:
            return self._const
        return self.as_array()[frame, b]

    def transform(self, f: Callable) -> "FunctionSample2d":
        if self._const is not None:
            out = f(torch.tensor(self._const, dtype=torch.float32))
            return FunctionSample2d(float(out), *self._shape, self._device)
        return FunctionSample2d(f(self._grid), *self._shape, self._device)

    for_each = transform

    def maximum(self, key: Callable = None) -> float:
        a = self.as_array()
        if key is not None:
            a = key(a)
        return float(torch.max(a))
