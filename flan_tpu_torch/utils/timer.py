"""Timer: wall-clock stopwatch and a device-honest timing helper
(flan_tpu/utils/timer.py; reference: src/flan/Utility/Timer.h).

Torch queues CUDA work and returns before the card finishes, so a host
clock around card work must wait for it: `sync` synchronizes the device
of every CUDA tensor it is given, and `time_torch` (the JAX package's
`time_jax`) reads the host clock around a call and that synchronize.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


class Timer:
    """Chrono-style stopwatch (reference Utility/Timer.h)."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self._elapsed

    def reset(self) -> None:
        self._start = None
        self._elapsed = 0.0

    @property
    def elapsed(self) -> float:
        if self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            yield from _tensors(leaf)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from _tensors(leaf)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def sync(tree) -> None:
    """Wait for the card's work behind every CUDA tensor in tree (tensors,
    lists, tuples, dicts and dataclasses such as Audio and PV)."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)


def time_torch(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best-of-reps wall seconds of fn(*args), the card's work included."""
    for _ in range(warmup):
        sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
