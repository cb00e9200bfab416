"""Polynomial transcendentals (counterpart of flan_tpu/ops/fastmath.py).

The JAX package computes every forward-path phase with a degree-15 odd
minimax atan polynomial (max error 7.5e-8 on atan, ~1.5e-7 rad through the
quadrant logic). The port keeps the same coefficients and the same
operation order, so its phases and frequencies agree with the JAX package
to float32 rounding rather than to the difference between two atan2s.
csrc/spv_kernels.cu carries the same polynomial.
"""
from __future__ import annotations

import math

import torch

# atan(z) ~= z * P(z^2), z in [0, 1]; Chebyshev-fit, max err 7.5e-8
_ATAN_COEF = (0.9999999, -0.3333196, 0.19969235, -0.14016585,
              0.09906097, -0.0593671, 0.02416619, -0.004668773)


def atan_poly(z: torch.Tensor) -> torch.Tensor:
    z2 = z * z
    p = torch.full_like(z, _ATAN_COEF[-1])
    for c in _ATAN_COEF[-2::-1]:
        p = p * z2 + c
    return z * p


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant atan2 from the [0, 1] polynomial; (0, 0) excluded
    (callers gate zero-energy points)."""
    ay, ax = y.abs(), x.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp(hi, min=1e-37)
    at = atan_poly(z)
    at = torch.where(ay > ax, math.pi / 2 - at, at)
    at = torch.where(x < 0, math.pi - at, at)
    return torch.where(y < 0, -at, at)


def sincos_2pi(u: torch.Tensor):
    """(sin(2 pi u), cos(2 pi u)) for u in cycles, any range: quadrant
    reduction to |r| <= 1/8 cycle plus odd/even Taylor forms."""
    k = torch.round(u * 4.0)
    r = (u - k * 0.25) * (2.0 * math.pi)
    z = r * r
    s = r * (1.0 + z * (-1.0 / 6.0 + z * (1.0 / 120.0 + z * (-1.0 / 5040.0))))
    c = 1.0 + z * (-0.5 + z * (1.0 / 24.0 + z * (-1.0 / 720.0
                                                 + z * (1.0 / 40320.0))))
    q = torch.remainder(k, 4.0)
    sin = torch.where(q == 0, s, torch.where(q == 1, c,
                                             torch.where(q == 2, -s, -c)))
    cos = torch.where(q == 0, c, torch.where(q == 1, -s,
                                             torch.where(q == 2, -c, s)))
    return sin, cos
