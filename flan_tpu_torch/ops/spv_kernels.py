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
design (tile totals, an exclusive prefix over tiles, then an epilogue
that re-runs each tile from its carried offset) is described in the CUDA
source. The TPU kernel's limit of B % 128 == 0 and B <= 1024 was a VMEM
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
                                      load_library, raise_on)
from flan_tpu_torch.ops.fastmath import atan2 as _fast_atan2
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


def _hann_stencil(f_re: torch.Tensor, f_im: torch.Tensor, two_b: int):
    """3-tap hann spectral convolution (AudioSPV.cpp:65-92). At bin 0 both
    neighbour taps collapse to 2*Re(f[1]) and at bin B-1 to 2*Re(f[B-2]);
    the imaginary edge taps are zero."""
    zero = f_re.new_zeros(f_re.shape[:-1] + (1,))
    left_re = torch.cat([2.0 * f_re[..., 1:2], f_re[..., :-2], zero], -1)
    right_re = torch.cat([zero, f_re[..., 2:], 2.0 * f_re[..., -2:-1]], -1)
    left_im = torch.cat([zero, f_im[..., :-2], zero], -1)
    right_im = torch.cat([zero, f_im[..., 2:], zero], -1)
    conv_re = 0.25 * (2.0 * f_re - left_re - right_re) / two_b
    conv_im = 0.25 * (2.0 * f_im - left_im - right_im) / two_b
    return conv_re, conv_im


def spv_forward_ref(x: torch.Tensor, nbins: int, sample_rate: float,
                    chunk: int = _REF_CHUNK):
    """Plain PyTorch sliding-DFT forward: audio [C, N] -> (mag, freq)
    [C, N, nbins], streamed over chunks of frames carrying the running
    complex sum and the previous frame's phase. Computes in x's dtype:
    float32 is the version the kernel is held to, float64 a reference for
    how far float32 summation drifts."""
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
        conv_re, conv_im = _hann_stencil(f_re, f_im, two_b)
        energy = conv_re * conv_re + conv_im * conv_im
        dead = energy == 0.0
        phase = _fast_atan2(torch.where(dead, 0.0, conv_im),
                            torch.where(dead, 1.0, conv_re))
        prev = torch.cat([prev_phase, phase[:, :-1]], dim=1)
        # deliberate wrap at analysis rate == sample rate (spv.py:252-258)
        delta = _wrap_radians(phase - prev - expected)
        mag[:, t0:t0 + h] = cpu_exact(torch.sqrt, energy)
        freq[:, t0:t0 + h] = bin_freq + delta * (sample_rate / _TWO_PI)
        sum_re, sum_im = s_re[:, -1:], s_im[:, -1:]
        prev_phase = phase[:, -1:]
    return mag, freq


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
    ntiles = -(-n // TILE_FRAMES)
    with torch.cuda.device(x.device):
        tw_re, tw_im = _device_twiddles(nbins, x.device)
        mag = torch.empty((c, n, nbins), dtype=torch.float32, device=x.device)
        freq = torch.empty_like(mag)
        tot_re = torch.empty((c, ntiles, nbins), dtype=torch.float32,
                             device=x.device)
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
    ntiles = -(-n // TILE_FRAMES)
    with torch.cuda.device(mag.device):
        out = torch.empty((c, n), dtype=torch.float32, device=mag.device)
        tot = torch.empty((c, ntiles, nbins), dtype=torch.float32,
                          device=mag.device)
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
