"""Pipe: composable effect chains (counterpart of flan_tpu/func/pipe.py;
reference: src/flan/Pipe.h:14-44).

The C++ version chains callables with operator>> to exploit rvalue inputs;
here stages are plain functions of a buffer (Audio, PV, ...) returning a
buffer, and a Pipe applies them in order.
"""
from __future__ import annotations

from typing import Callable, List


class Pipe:
    """Composable transform: Pipe(f) >> Pipe(g) applies f then g.

    Any callable taking and returning a buffer object (Audio, PV, ...)
    can participate; plain callables compose via >> automatically.
    """

    def __init__(self, *stages: Callable):
        self.stages: List[Callable] = list(stages)

    def __call__(self, x):
        for stage in self.stages:
            x = stage(x)
        return x

    def __rshift__(self, other) -> "Pipe":
        stages = other.stages if isinstance(other, Pipe) else [other]
        return Pipe(*self.stages, *stages)

    def __rrshift__(self, other):
        """buffer >> pipe applies the pipe; callable >> pipe prepends. A
        buffer is what has samples (Audio.data) or planes (PV.mag)."""
        if callable(other) and not hasattr(other, "data") \
                and not hasattr(other, "mag"):
            return Pipe(other, *self.stages)
        return self(other)
