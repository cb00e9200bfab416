"""Interpolators: [0, 1] -> [0, 1] shaping curves on tensors (counterpart of
flan_tpu/func/interpolators.py; reference: src/flan/Utility/Interpolator.h).
Each takes and returns a float32 tensor, so `PV.stretch` and
`PV.modify_time` can take any of them as their `interp`.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

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



def interpolate_points(points: Sequence[Tuple[float, float]],
                       interp: Callable = linear) -> Callable:
    """Piecewise function through (x, y) points sorted by x, each span
    shaped by `interp`, held at the end values outside them (reference
    Interpolator.cpp; flan_tpu/func/interpolators.py:63-80). The returned
    callable takes a tensor and answers on its device."""
    xs = torch.tensor([p[0] for p in points], dtype=torch.float32)
    ys = torch.tensor([p[1] for p in points], dtype=torch.float32)

    def fn(t):
        t = _f32(t)
        x_, y_ = xs.to(t.device), ys.to(t.device)
        idx = torch.clamp(torch.searchsorted(x_, t, side="left"), 1,
                          len(x_) - 1)
        x0, x1 = x_[idx - 1], x_[idx]
        y0, y1 = y_[idx - 1], y_[idx]
        mix = interp(torch.clamp((t - x0) / torch.clamp(x1 - x0, min=1e-20),
                                 0, 1))
        out = (1.0 - mix) * y0 + mix * y1
        out = torch.where(t <= x_[0], y_[0], out)
        return torch.where(t >= x_[-1], y_[-1], out)

    return fn


def interpolate_intervals(delta_x: float, ys: Sequence[float],
                          interp: Callable = linear) -> Callable:
    """interpolate_points over points delta_x apart from 0."""
    return interpolate_points([(i * delta_x, y) for i, y in enumerate(ys)],
                              interp)
