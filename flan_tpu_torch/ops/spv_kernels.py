"""SPV sliding-DFT forward and inverse: Hopper kernels and plain versions.

Counterpart of flan_tpu/ops/spv_pallas.py. Each kernel replaces one TPU
kernel and has a plain PyTorch version beside it:

  spv_forward  CUDA csrc/spv_kernels.cu flan_spv_forward, replacing
               flan_tpu/ops/spv_pallas.py spv_forward_fused -> _fwd_kernel;
               plain version spv_forward_ref, a transcription of
               flan_tpu/spv/spv.py _spv_forward_scan.
  spv_inverse  CUDA csrc/spv_kernels.cu flan_spv_inverse, replacing
               flan_tpu/ops/spv_pallas.py spv_inverse_fused -> _inv_kernel;
               plain version spv_inverse_ref, a transcription of
               _spv_inverse_scan.

Both kernels are memory-bound: the forward writes 2*C*N*B floats, the
inverse reads as many, so the floor is those bytes at 3.35 TB/s. The
design is described in the CUDA source: tile totals, an exclusive prefix
over tiles that fills the card, then an epilogue that re-runs each tile
from its carried offset, with a thread on 4 adjacent bins (16-byte loads
and stores) wherever B is a multiple of 4. The forward's stencil takes its
neighbours from registers, warp shuffles and one halo bin per warp side,
so its frame loop has no barrier; the inverse keeps its cycles as 32-bit
fixed point, which wrap and associate exactly. Where the kernels' roundings
differ from the plain versions', spv_forward_emulated and
spv_inverse_emulated repeat the kernels' arithmetic in PyTorch for the CPU
tests. The TPU kernel's limit of B % 128 == 0 and B <= 1024 was a VMEM
limit and does not apply: the kernels take 2 <= B <= 2048 and any N.

Dispatch is by the tensor's device: a CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel or the call raises. The kernel
library (ops/build.py) is built with nvcc from the package's own sources
at first use. LAUNCHES counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from flan_tpu_torch.ops.build import (MAX_BINS, TILE_FRAMES, check_cuda,
                                      load_library, raise_on, tile_scratch)
from flan_tpu_torch.ops.fastmath import atan2 as _fast_atan2
from flan_tpu_torch.ops.fastmath import atan_poly
from flan_tpu_torch.ops.stft import (_wrap_radians, bin_frequencies,
                                     cpu_exact, cumsum_mod1_frames, true_div)

_REF_CHUNK = 1024       # frames per chunk of the plain versions (as spv.py)
_REF_BLOCK = 128        # frames per cumsum block inside a chunk (as spv.py)
_TWO_PI = 2.0 * math.pi

LAUNCHES = {"spv_forward": 0, "spv_inverse": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _twiddle_table_f64(nbins: int):
    """One period of e^{-i pi j b / B}: rows j in [0, 2B), bins b in [0, B),
    with exact integer phase reduction mod 2B (reference AudioSPV.cpp:13-38).
    Returns (re, im) float64 [2B, B]."""
    two_b = 2 * nbins
    j = np.arange(two_b, dtype=np.int64)
    b = np.arange(nbins, dtype=np.int64)
    idx = (j[:, None] * b[None, :]) % two_b
    ang = -2.0 * np.pi / two_b * idx.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def twiddle_table_np(nbins: int):
    """The twiddle table as float32 [2B, B] (re, im): the same float64 numpy
    expressions as flan_tpu/spv/spv.py _twiddle_table_np, so both packages
    hold the same bits."""
    return tuple(t.astype(np.float32) for t in _twiddle_table_f64(nbins))


# ------------------------------------------------------------ plain versions

def cumsum_blocked(x: torch.Tensor, block: int = _REF_BLOCK):
    """Inclusive cumsum along axis 1 of [C, T, B] in blocks of `block`
    frames chained by an exclusive prefix of block totals: the association
    of flan_tpu/spv/spv.py _cumsum_frames_tri."""
    c, t, b = x.shape
    if t <= block:
        return torch.cumsum(x, dim=1)
    tp = -(-t // block) * block
    if tp != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, tp - t))
    inner = torch.cumsum(x.reshape(c, tp // block, block, b), dim=2)
    totals = inner[:, :, -1, :]
    offs = torch.cumsum(totals, dim=1) - totals
    return (inner + offs[:, :, None, :]).reshape(c, tp, b)[:, :t]


def _stencil_taps(f_re: torch.Tensor, f_im: torch.Tensor):
    """2 f[b] - f[b-1] - f[b+1] of the 3-tap hann spectral convolution
    (AudioSPV.cpp:65-92), real and imaginary. At bin 0 both neighbour taps
    collapse to 2*Re(f[1]) and at bin B-1 to 2*Re(f[B-2]); the imaginary
    edge taps are zero."""
    zero = f_re.new_zeros(f_re.shape[:-1] + (1,))
    left_re = torch.cat([2.0 * f_re[..., 1:2], f_re[..., :-2], zero], -1)
    right_re = torch.cat([zero, f_re[..., 2:], 2.0 * f_re[..., -2:-1]], -1)
    left_im = torch.cat([zero, f_im[..., :-2], zero], -1)
    right_im = torch.cat([zero, f_im[..., 2:], zero], -1)
    return 2.0 * f_re - left_re - right_re, 2.0 * f_im - left_im - right_im


def _hann_stencil(f_re: torch.Tensor, f_im: torch.Tensor, two_b: int):
    """The hann spectral convolution: 0.25 * taps / 2B."""
    taps_re, taps_im = _stencil_taps(f_re, f_im)
    return 0.25 * taps_re / two_b, 0.25 * taps_im / two_b


def _forward_chunks(x: torch.Tensor, nbins: int, sample_rate: float,
                    chunk: int, stencil, atan2, wrap):
    """The sliding-DFT forward streamed over chunks of frames, carrying the
    running complex sum and the previous frame's phase, with the stencil,
    the atan2 and the phase wrap given by the caller."""
    c, n = x.shape
    two_b = 2 * nbins
    dev, dt = x.device, x.dtype
    # the periodic table tiled so any chunk's rows are one slice; the cast
    # to float32 rounds as twiddle_table_np does
    reps = -(-(chunk + 1) // two_b) + 1
    tw_re, tw_im = (torch.from_numpy(np.tile(t, (reps, 1))).to(dev, dt)
                    for t in _twiddle_table_f64(nbins))
    bin_freq, expected = bin_frequencies(nbins, sample_rate / two_b,
                                         sample_rate, dt, dev)
    # comb-filter operand: x zero-padded 2B to the left (AudioSPV.cpp:47-52)
    xp = torch.nn.functional.pad(x, (two_b, 0))

    mag = torch.empty((c, n, nbins), dtype=dt, device=dev)
    freq = torch.empty_like(mag)
    sum_re = torch.zeros((c, 1, nbins), dtype=dt, device=dev)
    sum_im = torch.zeros_like(sum_re)
    prev_phase = torch.zeros_like(sum_re)
    for t0 in range(0, n, chunk):
        h = min(chunk, n - t0)
        off = t0 % two_b
        deltas = (xp[:, t0 + two_b:t0 + two_b + h] - xp[:, t0:t0 + h])
        deltas = deltas[:, :, None]
        s_re = cumsum_blocked(deltas * tw_re[off:off + h]) + sum_re
        s_im = cumsum_blocked(deltas * tw_im[off:off + h]) + sum_im
        # rotate to the frame's reference phase: * conj(twiddle(t+1, b))
        cn_re = tw_re[off + 1:off + 1 + h]
        cn_im = -tw_im[off + 1:off + 1 + h]
        f_re = s_re * cn_re - s_im * cn_im
        f_im = s_re * cn_im + s_im * cn_re
        conv_re, conv_im = stencil(f_re, f_im, two_b)
        energy = conv_re * conv_re + conv_im * conv_im
        dead = energy == 0.0
        phase = atan2(torch.where(dead, 0.0, conv_im),
                      torch.where(dead, 1.0, conv_re))
        prev = torch.cat([prev_phase, phase[:, :-1]], dim=1)
        # deliberate wrap at analysis rate == sample rate (spv.py:252-258)
        delta = wrap(phase - prev - expected)
        mag[:, t0:t0 + h] = cpu_exact(torch.sqrt, energy)
        freq[:, t0:t0 + h] = bin_freq + delta * (sample_rate / _TWO_PI)
        sum_re, sum_im = s_re[:, -1:], s_im[:, -1:]
        prev_phase = phase[:, -1:]
    return mag, freq


def spv_forward_ref(x: torch.Tensor, nbins: int, sample_rate: float,
                    chunk: int = _REF_CHUNK):
    """Plain PyTorch sliding-DFT forward: audio [C, N] -> (mag, freq)
    [C, N, nbins], streamed over chunks of frames carrying the running
    complex sum and the previous frame's phase. Computes in x's dtype:
    float32 is the version the kernel is held to, float64 a reference for
    how far float32 summation drifts."""
    return _forward_chunks(x, nbins, sample_rate, chunk, _hann_stencil,
                           _fast_atan2, _wrap_radians)


def spv_inverse_ref(mag: torch.Tensor, freq: torch.Tensor,
                    sample_rate: float, chunk: int = _REF_CHUNK):
    """Plain PyTorch SPV inverse: (mag, freq) [C, F, B] -> audio [C, F]:
    mod-1 phase accumulation, then 2 * sum_b (-1)^b mag cos(2 pi cycles)
    (reference AudioSPV.cpp:113-145). Computes in mag's dtype."""
    c, f, b = mag.shape
    dev, dt = mag.device, mag.dtype
    signs = 1.0 - 2.0 * (torch.arange(b, device=dev) % 2).to(dt)
    out = torch.empty((c, f), dtype=dt, device=dev)
    cycle0 = torch.zeros((c, 1, b), dtype=dt, device=dev)
    for t0 in range(0, f, chunk):
        h = min(chunk, f - t0)
        inc = torch.remainder(true_div(freq[:, t0:t0 + h], sample_rate), 1.0)
        cycles = torch.remainder(cumsum_mod1_frames(inc) + cycle0, 1.0)
        real = mag[:, t0:t0 + h] * torch.cos(cycles * _TWO_PI)
        out[:, t0:t0 + h] = 2.0 * torch.sum(real * signs, dim=-1)
        cycle0 = cycles[:, -1:]
    return out


# ------------------------------------------ the kernels' arithmetic, emulated

def _hann_stencil_scaled(f_re: torch.Tensor, f_im: torch.Tensor, two_b: int):
    """_hann_stencil with 0.25 / 2B hoisted into one rounded factor, as the
    forward kernel has it: the same bits when 2B is a power of two, within
    one ulp otherwise."""
    taps_re, taps_im = _stencil_taps(f_re, f_im)
    scale = torch.tensor(0.25, dtype=f_re.dtype) / two_b
    return taps_re * scale, taps_im * scale


def _atan2_reciprocal(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ops/fastmath.py atan2 with the quotient as lo * (1 / hi): the two
    roundings of the kernel's fast reciprocal (the card's is within 1 ulp
    of the correctly rounded one used here)."""
    ay, ax = y.abs(), x.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    at = atan_poly(lo * (1.0 / torch.clamp(hi, min=1e-37)))
    at = torch.where(ay > ax, math.pi / 2 - at, at)
    at = torch.where(x < 0, math.pi - at, at)
    return torch.where(y < 0, -at, at)


def _wrap_radians_reciprocal(x: torch.Tensor) -> torch.Tensor:
    """_wrap_radians with x / 2pi as x * (1 / 2pi) rounded to x's type."""
    inv = torch.tensor(1.0 / _TWO_PI, dtype=x.dtype)
    return x - _TWO_PI * torch.round(x * inv)


def spv_forward_emulated(x: torch.Tensor, nbins: int, sample_rate: float,
                         chunk: int = _REF_CHUNK):
    """spv_forward_ref with the forward kernel's three cheaper roundings
    (hoisted stencil scale, reciprocal inside atan2, reciprocal in the phase
    wrap); its summation order stays the plain version's. For the CPU tests:
    no path calls it."""
    return _forward_chunks(x, nbins, sample_rate, chunk, _hann_stencil_scaled,
                           _atan2_reciprocal, _wrap_radians_reciprocal)


def cycle_increments_fixed(freq: torch.Tensor,
                           sample_rate: float) -> torch.Tensor:
    """frac(freq / sr) as 32-bit fixed point, the inverse kernel's
    arithmetic: q = freq / sr in float32 (true division), q - round(q)
    (exact, in [-0.5, 0.5]), times 2^32, rounded to nearest and saturated at
    2^31 - 1. Returned as int64 holding the signed 32-bit values."""
    q = true_div(freq.to(torch.float32), sample_rate)
    r = (q - torch.round(q)).double() * 4294967296.0
    return torch.round(r).clamp(max=2.0 ** 31 - 1).to(torch.int64)


def spv_inverse_emulated(mag: torch.Tensor, freq: torch.Tensor,
                         sample_rate: float) -> torch.Tensor:
    """The inverse kernel's arithmetic in PyTorch, float32 out: fixed-point
    cycle increments summed modulo 2^32 (exact in any order), the phase
    taken as a signed 32-bit fraction of a half turn rounded to float32, its
    cosine correctly rounded (cospif is within 1 ulp), then the signed sum
    over bins. For the CPU tests: no path calls it."""
    b = mag.shape[-1]
    cycles = torch.cumsum(cycle_increments_fixed(freq, sample_rate), dim=1)
    signed = ((cycles + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    half_turns = signed.to(torch.float32) * 2.0 ** -31
    cos = torch.cos(half_turns.double() * math.pi).to(torch.float32)
    signs = 1.0 - 2.0 * (torch.arange(b, device=mag.device) % 2).float()
    real = mag.to(torch.float32) * cos
    return 2.0 * torch.sum(real * signs, dim=-1)


# ------------------------------------------------------------------ kernels

@functools.lru_cache(maxsize=8)
def _device_twiddles(nbins: int, device: torch.device):
    return tuple(torch.from_numpy(t).to(device)
                 for t in twiddle_table_np(nbins))


def _check_bins(nbins: int, low: int) -> None:
    if not low <= nbins <= MAX_BINS:
        raise ValueError(f"nbins must be in [{low}, {MAX_BINS}], got {nbins}")


def _spv_forward_cuda(x: torch.Tensor, nbins: int, sample_rate: float):
    check_cuda(x, "x", 2)
    _check_bins(nbins, 2)
    lib = load_library()
    c, n = x.shape
    with torch.cuda.device(x.device):
        tw_re, tw_im = _device_twiddles(nbins, x.device)
        mag = torch.empty((c, n, nbins), dtype=torch.float32, device=x.device)
        freq = torch.empty_like(mag)
        tot_re = tile_scratch(c, n, nbins, x.device)
        tot_im = torch.empty_like(tot_re)
        err = lib.flan_spv_forward(
            x.data_ptr(), tw_re.data_ptr(), tw_im.data_ptr(),
            tot_re.data_ptr(), tot_im.data_ptr(), mag.data_ptr(),
            freq.data_ptr(), c, n, nbins, float(sample_rate),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "spv_forward")
    LAUNCHES["spv_forward"] += 1
    return mag, freq


def _spv_inverse_cuda(mag: torch.Tensor, freq: torch.Tensor,
                      sample_rate: float):
    check_cuda(mag, "mag", 3)
    check_cuda(freq, "freq", 3)
    if freq.shape != mag.shape or freq.device != mag.device:
        raise ValueError("mag and freq must share shape and device")
    c, n, nbins = mag.shape
    _check_bins(nbins, 1)
    lib = load_library()
    with torch.cuda.device(mag.device):
        out = torch.empty((c, n), dtype=torch.float32, device=mag.device)
        tot = tile_scratch(c, n, nbins, mag.device, torch.int32)
        err = lib.flan_spv_inverse(
            mag.data_ptr(), freq.data_ptr(), tot.data_ptr(), out.data_ptr(),
            c, n, nbins, float(sample_rate),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "spv_inverse")
    LAUNCHES["spv_inverse"] += 1
    return out


def spv_forward(x: torch.Tensor, nbins: int, sample_rate: float):
    """Audio [C, N] -> (mag, freq) [C, N, nbins] by sliding DFT + PV: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return _spv_forward_cuda(x, nbins, sample_rate)
    if x.device.type == "cpu":
        return spv_forward_ref(x, nbins, sample_rate)
    raise ValueError(f"spv_forward runs on cuda or cpu, not {x.device}")


def spv_inverse(mag: torch.Tensor, freq: torch.Tensor, sample_rate: float):
    """(mag, freq) [C, F, B] -> audio [C, F]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if mag.device.type == "cuda":
        return _spv_inverse_cuda(mag, freq, sample_rate)
    if mag.device.type == "cpu":
        return spv_inverse_ref(mag, freq, sample_rate)
    raise ValueError(f"spv_inverse runs on cuda or cpu, not {mag.device}")
