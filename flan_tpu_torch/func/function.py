"""Function layer: constant-or-callable algorithm parameters on tensors
(counterpart of flan_tpu/func/function.py; reference: src/flan/Function.h).

A Function wraps a constant or a callable. Callables are evaluated once on
a whole float32 grid tensor, so they must accept tensors (plain arithmetic
and torch functions do). Constants short-circuit: sampling a constant
returns a python float, which keeps downstream ops cheap exactly like the
reference's variant fast path. A tensor that requires grad is no constant:
it becomes a callable returning itself broadcast, so algorithms take their
sampled path and the result is differentiable in it, as a traced scalar
is in the JAX package (flan_tpu/func/function.py:38-47).
"""
from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.ops.stft import true_div

FunctionLike = Union[float, int, "Function", Callable]


def _traced(f) -> bool:
    """A parameter to differentiate in: a tensor that requires grad."""
    return isinstance(f, torch.Tensor) and f.requires_grad


def _broadcaster(v: torch.Tensor):
    """The callable a traced parameter becomes: v broadcast to the shape of
    whatever grid it is given, as float32 on the grid's device."""
    def fn(*grid):
        shape = torch.broadcast_shapes(*(torch.as_tensor(g).shape
                                         for g in grid))
        device = next((g.device for g in grid
                       if isinstance(g, torch.Tensor)), v.device)
        return torch.broadcast_to(v.to(device=device, dtype=torch.float32),
                                  shape)
    return fn


def broadcast_f32(out, shape, device) -> torch.Tensor:
    """A Function's output (a tensor or a number) as a float32 tensor of
    `shape` on `device` (a broadcast view where it can be)."""
    out = torch.as_tensor(out, dtype=torch.float32, device=device)
    return torch.broadcast_to(out, shape)


class Function:
    """A constant or a callable over one scalar input (usually time)."""

    def __init__(self, f: FunctionLike):
        if isinstance(f, Function):
            self._const, self._fn = f._const, f._fn
        elif callable(f):
            self._const, self._fn = None, f
        elif _traced(f):
            self._const, self._fn = None, _broadcaster(f)
        else:
            self._const, self._fn = float(f), None

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    @property
    def constant_value(self) -> float:
        return self._const

    def __call__(self, x):
        if self._const is not None:
            if isinstance(x, torch.Tensor):
                return torch.full(x.shape, self._const, dtype=torch.float32,
                                  device=x.device)
            return self._const
        return self._fn(x)

    def sample(self, start: int, end: int, period: float, device=None):
        """Rasterize onto the grid (start..end-1) * period (reference
        Function::sample, Function.h:139-187). Constants return a python
        float; callables a float32 [end-start] tensor on `device`."""
        if self._const is not None:
            return self._const
        grid = float_iota(start, end, device=device) * period
        return broadcast_f32(self._fn(grid), grid.shape, device)

    def sample_device(self, count: int, period: float, device=None
                      ) -> torch.Tensor:
        """The float32 [count] tensor on `device` of the grid (0 .. count -
        1) * period (flan_tpu/func/function.py:76-87): a constant filled, a
        callable evaluated on the grid, which is float_iota's."""
        if self._const is not None:
            return torch.full((count,), self._const, dtype=torch.float32,
                              device=device)
        grid = float_iota(count, device=device) * period
        return broadcast_f32(self._fn(grid), grid.shape, device)

    def copy(self) -> "Function":
        """Reference Function::copy (Function.h:65-72); Functions are
        immutable, so this is a fresh wrapper over the same underlying."""
        return Function(self)

    def periodize(self, period: float = 1.0) -> "Function":
        """Repeat this function with the given period (Function.h:128-137):
        f(t mod period), the modulo taking the period's sign, as jnp.mod."""
        if self._const is not None:
            return self
        fn = self._fn
        return Function(lambda t: fn(t % period))

    @staticmethod
    def uniform_distribution(lower: FunctionLike, upper: FunctionLike,
                             seed: int = 0) -> "Function":
        """Stochastic Function drawing uniform values between the bounds,
        evaluated per call (the reference's commented-out
        Function::uniformDistribution, Function.h:105-112). The draw is on
        the host from np.random.default_rng(seed), as the JAX package
        draws it, so one seed gives both packages the same values; a tensor
        grid gets a float32 tensor on its device."""
        lo, hi = as_function(lower), as_function(upper)
        rng = np.random.default_rng(seed)

        def f(x):
            u = rng.random(_shape(x)).astype(np.float32)
            a, b = _host(lo(x)), _host(hi(x))
            return _like(x, a + (b - a) * u)
        return Function(f)

    @staticmethod
    def normal_distribution(mean: FunctionLike, sigma: FunctionLike,
                            seed: int = 0) -> "Function":
        """Stochastic Function drawing normal(mean, sigma) per call, with
        the reference's sigma <= 0 -> mean short-circuit (the commented-out
        Function::normalDistribution, Function.h:114-125); drawn on the
        host as uniform_distribution is."""
        m_f, s_f = as_function(mean), as_function(sigma)
        rng = np.random.default_rng(seed)

        def f(x):
            m, s = _host(m_f(x)), _host(s_f(x))
            z = rng.standard_normal(_shape(x)).astype(np.float32)
            return _like(x, np.where(s > 0, m + s * z, m))
        return Function(f)

    # Arithmetic composition (flan_tpu/func/function.py:164-187)
    def __mul__(self, other):
        return _binary(self, other, lambda a, b: a * b)

    def __add__(self, other):
        return _binary(self, other, lambda a, b: a + b)

    def __neg__(self):
        if self._const is not None:
            return Function(-self._const)
        fn = self._fn
        return Function(lambda t: -fn(t))


# camelCase aliases of the reference's declared names
Function.uniformDistribution = Function.uniform_distribution
Function.normalDistribution = Function.normal_distribution


def _binary(left: Function, right, op) -> Function:
    """Compose two Functions (or a Function and a constant) pointwise."""
    r = as_function(right)
    if left.is_constant and r.is_constant:
        return Function(float(op(left.constant_value, r.constant_value)))
    return Function(lambda t: op(left(t), r(t)))


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _host(v) -> np.ndarray:
    """A Function's value as float32 numpy on the host."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _like(x, out: np.ndarray):
    """A host draw in x's kind: a float32 tensor on a tensor grid's device,
    an array for an array grid, a float for a scalar."""
    if isinstance(x, torch.Tensor):
        out = np.array(np.broadcast_to(out, tuple(x.shape)), np.float32)
        return torch.from_numpy(out).to(x.device)
    return out if np.shape(x) else float(out)


class Function2d:
    """A constant or a callable over (time, frequency); callables take
    broadcastable tensors."""

    def __init__(self, f: FunctionLike):
        if isinstance(f, Function2d):
            self._const, self._fn = f._const, f._fn
        elif isinstance(f, Function):
            fn = f._fn
            self._const = f._const
            self._fn = None if fn is None else (lambda t, fr: fn(t))
        elif callable(f):
            self._const, self._fn = None, f
        elif _traced(f):
            self._const, self._fn = None, _broadcaster(f)
        else:
            self._const, self._fn = float(f), None

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    @property
    def constant_value(self) -> float:
        return self._const

    def __call__(self, t, f):
        if self._const is not None:
            shape = torch.broadcast_shapes(t.shape, f.shape)
            return torch.full(shape, self._const, dtype=torch.float32,
                              device=t.device)
        return self._fn(t, f)

    def sample_grid(self, num_frames: int, frame_period: float,
                    num_bins: int, bin_width: float, device=None):
        """Rasterize over the frame x bin grid (reference Function.h:157-187):
        a python float for constants, else a float32 [num_frames, num_bins]
        tensor on `device`."""
        if self._const is not None:
            return self._const
        t = float_iota(num_frames, device=device)[:, None] * frame_period
        f = float_iota(num_bins, device=device)[None, :] * bin_width
        return broadcast_f32(self._fn(t, f), (num_frames, num_bins), device)


def as_function(f: FunctionLike) -> Function:
    return f if isinstance(f, Function) else Function(f)


def as_function2d(f) -> Function2d:
    return f if isinstance(f, Function2d) else Function2d(f)


# --- Waveforms (reference Function.h:295-300; period and amplitude 1) --------
class waveforms:
    """Unit-period waveforms of a phase in cycles (flan_tpu/func/function.py
    :311-330); add_moisture's default shaper is sine."""

    @staticmethod
    def sine(t):
        return torch.sin(2.0 * math.pi * torch.as_tensor(t, dtype=torch.float32))

    @staticmethod
    def square(t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.where(torch.remainder(t, 1.0) < 0.5, -1.0, 1.0)

    @staticmethod
    def saw(t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return 2.0 * torch.remainder(t, 1.0) - 1.0

    @staticmethod
    def triangle(t):
        m = torch.remainder(torch.as_tensor(t, dtype=torch.float32), 1.0)
        return torch.where(m < 0.5, 4.0 * m - 1.0, 3.0 - 4.0 * m)


# --- ADSR (reference Function.h:281-300, Function.cpp) -----------------------
def adsr(attack_time: float, decay_time: float, sustain_time: float,
         release_time: float, sustain_level: float,
         attack_exponent: float = 1.0, decay_exponent: float = 1.0,
         release_exponent: float = 1.0) -> Function:
    """ADSR envelope Function from 0 to 1 with power curves
    (flan_tpu/func/function.py:279-307). The curve shapes are the
    reference's (Function.cpp:21-29): decay pow(1 - x, dExp) * (1 - sLvl)
    + sLvl, release pow(1 - x, rExp) * sLvl."""
    a, d, s, r = attack_time, decay_time, sustain_time, release_time

    def env(t):
        t = torch.as_tensor(t, dtype=torch.float32)

        def ramp(since, length):    # since: t minus the segment's start
            return torch.clamp(true_div(since, max(length, 1e-20)), 0, 1)

        attack = (torch.pow(ramp(t, a), attack_exponent) if a > 0
                  else torch.ones_like(t))
        decay = sustain_level + (1.0 - sustain_level) * torch.pow(
            1.0 - ramp(t - a, d), decay_exponent)
        release = sustain_level * torch.pow(1.0 - ramp(t - a - d - s, r),
                                            release_exponent)
        out = torch.where(t < a, attack,
                          torch.where(t < a + d, decay,
                                      torch.where(t < a + d + s,
                                                  sustain_level, release)))
        return torch.where((t < 0) | (t > a + d + s + r), 0.0, out)

    return Function(env)
