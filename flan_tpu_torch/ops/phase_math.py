"""Elementwise numerics shared by the STFT (ops/stft.py), its stages
(ops/pv_stages.py) and the other representations' plain versions: exact
division and roots, the half-even phase wrap, the mod-1 cycle sum and the
test of which of its columns sum exactly in any order.

They import nothing of the port, so ops/stft.py and ops/pv_stages.py both
take them from here; ops/stft.py keeps their names for its importers.
"""
from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi
_MOD1_BLOCK = 256  # frames per within-block cumsum in cumsum_mod1_frames


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, correctly rounded on every device. torch's CUDA kernels turn
    division by a Python scalar into multiplication by its rounded
    reciprocal, a bias of up to one ulp in every element that the phase
    accumulators would integrate over every frame."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def cpu_exact(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for fn torch.sqrt, torch.log2 or torch.sin, with a float32 CPU
    tensor evaluated in float64 and rounded back. torch's float32 CPU sqrt
    and log2 can be off by up to 3e-4 relative in the part of a call that
    an intra-op worker thread computes the first time it runs them (torch
    2.13 on an AVX-512 CPU, in one process in two to ten), so a plain
    version gave two outputs for one input; its sin likewise (the second
    half of a 2,400-element call up to 2,522 ulps off, in one fresh
    process in 96 and one in 192). Rounded back from float64 the result
    stays within one float32 ulp. On the card fn runs in float32."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return fn(x.double()).to(x.dtype)
    return fn(x)


def _wrap_radians(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi] with round-half-even (reference
    phase_vocoder.cpp:38-41; torch.round rounds half to even, as
    jnp.round does)."""
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def cumsum_mod1_frames(inc: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum modulo 1 along axis 1 of [C, F, B].

    Within blocks of 256 frames the prefix is a plain cumsum; the blocks
    chain through a mod-1 prefix of their totals, as in the JAX package
    (which forms the within-block prefix as a triangular matmul and the
    chain as an associative scan). The sums run in float64 and the result
    is cast back: torch's CPU cumsum accumulates in float64 and its CUDA
    cumsum in float32, and a float32 block sum reaching 256 cycles keeps
    only ~1e-4 cycles of phase, so float64 makes the result the same on
    every device to the final rounding.
    """
    c, f, b = inc.shape
    blk = _MOD1_BLOCK
    fpad = _cdiv(f, blk) * blk
    x = inc.to(torch.float64)
    if fpad != f:
        x = torch.nn.functional.pad(x, (0, 0, 0, fpad - f))
    within = torch.cumsum(x.reshape(c, fpad // blk, blk, b), dim=2)
    totals = torch.remainder(within[:, :, -1, :], 1.0)         # [C, nb, B]
    prefix = torch.remainder(torch.cumsum(totals, dim=1), 1.0)
    prefix = torch.nn.functional.pad(prefix[:, :-1], (0, 0, 1, 0))
    out = torch.remainder(within + prefix[:, :, None, :], 1.0)
    return out.reshape(c, fpad, b)[:, :f].to(inc.dtype)


def clean_columns(inc: torch.Tensor) -> torch.Tensor:
    """[C, blocks, B] of increments [C, F, B]: whether every increment of
    a column's block of 256 frames is a whole multiple of 2^-45 (inc 2^45
    whole; false for a nonzero float32 below 2^-22 with low bits set, or
    NaN). Such a column's float64 sums in cumsum_mod1_frames are exact, so
    they give the same bits in any order (csrc/pv_stage_kernels.cu)."""
    c, f, b = inc.shape
    fpad = _cdiv(f, _MOD1_BLOCK) * _MOD1_BLOCK
    q = torch.nn.functional.pad(inc * 2.0 ** 45, (0, 0, 0, fpad - f))
    whole = (q == torch.trunc(q)).reshape(c, fpad // _MOD1_BLOCK,
                                          _MOD1_BLOCK, b)
    return whole.all(dim=2)
