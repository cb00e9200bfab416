"""Interpolators: [0, 1] -> [0, 1] shaping curves on tensors (counterpart of
flan_tpu/func/interpolators.py; reference: src/flan/Utility/Interpolator.h).
Each takes and returns a float32 tensor, so `PV.stretch` and
`PV.modify_time` can take any of them as their `interp`.
"""
from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def midpoint(x):
    return torch.full_like(_f32(x), 0.5)


def nearest(x):
    return torch.round(_f32(x))


def floor(x):
    return torch.zeros_like(_f32(x))


def ceil(x):
    return torch.ones_like(_f32(x))


def linear(x):
    return _f32(x)


def smoothstep(x):
    x = _f32(x)
    return x * x * (3.0 - 2.0 * x)


def smootherstep(x):
    x = _f32(x)
    return x * x * x * (x * (x * 6.0 - 15.0) + 10.0)


def sine(x):
    """(1 - cos(pi x)) / 2 (reference Interpolator.cpp sine)."""
    return (1.0 - torch.cos(math.pi * _f32(x))) / 2.0


def sine2(x):
    """sqrt(2) * sin(pi/4 * x) (reference Interpolator.cpp sine2)."""
    return _SQRT2 * torch.sin(math.pi / 4.0 * _f32(x))


def sqrt(x):
    return torch.sqrt(torch.clamp(_f32(x), min=0.0))

