"""Audio <-> SQPV: the sliding constant-Q transform (counterpart of
flan_tpu/sqpv/transform.py; reference: AudioSQPV.cpp:1-170, "Sliding With
A Constant-Q", DAFx-08).

Per bin b with period N_b = ceil(Q sr / f_b) and twiddles
a_{b,j} = exp(2 pi i (Q + j) / N_b), j in {-1, 0, +1}, the forward runs

    F_j[t] = a_{b,j} * ( F_j[t-1] + u_b[t] ),
    u_b[t] = (fiddle * x[t + P_b] - x[t - M_b]) / N_b,

with P_b = N_b // 2 and M_b = (N_b + 1) // 2, then windows spectrally
(0.5 F_0 - 0.25 (F_-1 + F_+1)) and phase-vocodes at analysis rate ==
sample rate. The output keeps log2 |f| (pitch) and the sign of f.

This module holds the host geometry (float64 numpy, built as the JAX
package builds it, so both packages hold the same constants), the comb
staging with the reference's toward-zero truncation quirk, and the public
transforms, which dispatch by the tensor's device to the Hopper kernels
(CUDA) or their plain versions (CPU) in ops/sqpv_kernels.py.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _cq_params(sample_rate: float, bins_per_octave: float,
               bandwidth: Tuple[float, float]):
    """Host-side constant-Q geometry (reference SQPVBuffer.cpp:17-31):
    (Q, bin count, bin frequencies, periods)."""
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lo_pitch = math.log2(bandwidth[0])
    hi_pitch = math.log2(bandwidth[1])
    nbins = int(math.ceil((hi_pitch - lo_pitch) * bins_per_octave))
    freqs = 2.0 ** (np.arange(nbins) / bins_per_octave + lo_pitch)
    periods = np.ceil(q * sample_rate / freqs).astype(np.int64)
    return q, nbins, freqs, periods


@dataclass(frozen=True)
class CQGeometry:
    """Every per-bin constant of one (sample rate, bins per octave,
    bandwidth), float64 unless stated. Frame t of the transform's timeline
    is output frame t - w0: the w0 frames before are the warm-up in which
    the longest window slides in."""
    sample_rate: float
    q: float
    nbins: int
    freqs: np.ndarray        # [B] bin centre frequencies
    periods: np.ndarray      # [B] int64 N_b
    w0: int
    off_p: np.ndarray        # [B] int64 P_b
    off_m: np.ndarray        # [B] int64 M_b
    fiddle: complex          # exp(-2 pi i Q) (AudioSQPV.cpp:82)
    t_new: np.ndarray        # [B] int64 quirk frame of the + side, -1: none
    t_old: np.ndarray        # [B] int64 quirk frame of the - side, -1: none

    @property
    def scale(self) -> np.ndarray:
        return 1.0 / self.periods.astype(np.float64)

    @property
    def quirk_coefficients(self):
        """(+ side re, + side im, - side re): what x[0] is multiplied by
        where an odd-period bin's half-period offset truncates to 0."""
        s = self.scale
        return self.fiddle.real * s, self.fiddle.imag * s, -s

    def twiddle_tables(self, length: int):
        """t1 = a^-i and t2 = a^(i+1), i in [0, length), per line j in
        {-1, 0, +1}: complex128 [3, length, B] (transform.py:154-158)."""
        jv = np.array([-1.0, 0.0, 1.0])
        theta = 2.0 * np.pi * (self.q + jv[:, None]) / self.periods[None, :]
        i_loc = np.arange(length, dtype=np.float64)
        t1 = np.exp(-1j * i_loc[None, :, None] * theta[:, None, :])
        t2 = np.exp(1j * (i_loc + 1.0)[None, :, None] * theta[:, None, :])
        return t1, t2

    @property
    def synthesis_twiddle(self) -> np.ndarray:
        """exp(2 pi i Q / N_b), complex128 [B] (AudioSQPV.cpp:133)."""
        return np.exp(1j * 2.0 * np.pi * self.q
                      / self.periods.astype(np.float64))

    def bin_frequencies(self, dtype):
        """(bin_freq, expected phase advance per frame) in `dtype` (numpy),
        in the JAX package's operation order."""
        bin_freq = self.freqs.astype(dtype)
        expected = bin_freq / dtype(self.sample_rate) * dtype(2.0 * np.pi)
        return bin_freq, expected


@functools.lru_cache(maxsize=16)
def cq_geometry(sample_rate: float, bins_per_octave: float,
                bandwidth: Tuple[float, float]) -> CQGeometry:
    q, nbins, freqs, periods = _cq_params(sample_rate, bins_per_octave,
                                          bandwidth)
    if nbins < 1:
        raise ValueError(f"bandwidth {bandwidth} holds no constant-Q bin")
    # the reference starts each bin at floor(-N_b/2 - 1) (AudioSQPV.cpp:98);
    # u is zero before the window slides in, so one global start at the
    # earliest bin is the same
    w0 = int(periods.max() // 2 + 2)
    off_p = periods // 2
    off_m = (periods + 1) // 2
    odd = periods % 2 == 1
    return CQGeometry(
        sample_rate=float(sample_rate), q=q, nbins=nbins, freqs=freqs,
        periods=periods, w0=w0, off_p=off_p, off_m=off_m,
        fiddle=complex(np.exp(-1j * 2.0 * np.pi * q)),
        t_new=np.where(odd, w0 - off_m, -1),
        t_old=np.where(odd, w0 + off_p, -1))


def _pad_for_comb(x: torch.Tensor, geo: CQGeometry) -> torch.Tensor:
    """x [C, N] zero-padded so that every comb read of the timeline
    [0, w0 + N) is in range: timeline frame t of bin b reads xq at
    t + max(M) + P_b (new) and t + max(M) - M_b (old)."""
    pad_l = geo.w0 + int(geo.off_m.max())
    pad_r = int(geo.off_p.max()) + 1
    return torch.nn.functional.pad(x, (pad_l, pad_r))


def _stage_comb(xq: torch.Tensor, x0: torch.Tensor, geo: CQGeometry,
                t0: int, h: int):
    """The comb operand u for timeline frames [t0, t0 + h): (re, im) each
    [C, h, B] in xq's dtype, rounded step by step as the JAX package's
    _stage_comb rounds it. xq is _pad_for_comb(x) and x0 = x[:, 0].

    The reference's toward-zero truncation quirk (AudioSQPV.cpp:100-103):
    at frame t_new of an odd-period bin the + side offset t - w0 + P_b is
    -1 and the reference's float index -0.5 truncates to 0, so it reads
    x[0]; likewise the - side at frame t_old. The quirk adds x[0] times
    the bin's coefficient at those frames, as the JAX package does."""
    dev, dt = xq.device, xq.dtype
    npdt = np.float64 if dt == torch.float64 else np.float32
    t = torch.arange(t0, t0 + h, device=dev)[:, None]               # [h, 1]
    rel = t + int(geo.off_m.max())
    off_p = torch.from_numpy(geo.off_p).to(dev)
    off_m = torch.from_numpy(geo.off_m).to(dev)
    new = xq[:, rel + off_p]                                    # [C, h, B]
    old = xq[:, rel - off_m]
    fiddle = geo.fiddle
    scale = torch.from_numpy(geo.scale.astype(npdt)).to(dev)
    u_re = (new * npdt(fiddle.real) - old) * scale
    u_im = (new * npdt(fiddle.imag)) * scale
    q_re, q_im, q_old = (torch.from_numpy(a.astype(npdt)).to(dev)
                         for a in geo.quirk_coefficients)
    x0 = x0[:, None, None]
    at_new = t == torch.from_numpy(geo.t_new).to(dev)               # [h, B]
    at_old = t == torch.from_numpy(geo.t_old).to(dev)
    u_re = torch.where(at_new, u_re + x0 * q_re, u_re)
    u_im = torch.where(at_new, u_im + x0 * q_im, u_im)
    u_re = torch.where(at_old, u_re + x0 * q_old, u_re)
    return u_re, u_im


def sqpv_forward(x: torch.Tensor, sample_rate: float, bins_per_octave: float,
                 bandwidth: Tuple[float, float]):
    """Audio [C, N] -> (mag, pitch, positive) each [C, N, B]: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    from flan_tpu_torch.ops import sqpv_kernels
    args = (float(sample_rate), float(bins_per_octave),
            (float(bandwidth[0]), float(bandwidth[1])))
    if x.device.type == "cuda":
        return sqpv_kernels.sqpv_forward_cuda(x, *args)
    if x.device.type == "cpu":
        return sqpv_kernels.sqpv_forward_ref(x, *args)
    raise ValueError(f"sqpv_forward runs on cuda or cpu, not {x.device}")


def sqpv_inverse(mag: torch.Tensor, pitch: torch.Tensor,
                 positive: torch.Tensor, sample_rate: float,
                 bins_per_octave: float,
                 bandwidth: Tuple[float, float]) -> torch.Tensor:
    """(mag, pitch, positive) [C, F, B] -> audio [C, F] (reference
    AudioSQPV.cpp:128-165): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    from flan_tpu_torch.ops import sqpv_kernels
    args = (float(sample_rate), float(bins_per_octave),
            (float(bandwidth[0]), float(bandwidth[1])))
    if mag.device.type == "cuda":
        return sqpv_kernels.sqpv_inverse_cuda(mag, pitch, positive, *args)
    if mag.device.type == "cpu":
        return sqpv_kernels.sqpv_inverse_ref(mag, pitch, positive, *args)
    raise ValueError(f"sqpv_inverse runs on cuda or cpu, not {mag.device}")
