"""SQPV sliding constant-Q forward and inverse: Hopper kernels and plain
versions.

Counterpart of flan_tpu/ops/sqpv_pallas.py. Each kernel replaces one TPU
kernel and has a plain PyTorch version beside it:

  sqpv_forward  CUDA csrc/sqpv_kernels.cu flan_sqpv_forward, replacing
                flan_tpu/ops/sqpv_pallas.py sqpv_forward_fused ->
                _fwd_kernel; plain version sqpv_forward_ref, a
                transcription of flan_tpu/sqpv/transform.py
                _sqpv_forward_scan.
  sqpv_inverse  CUDA csrc/sqpv_kernels.cu flan_sqpv_inverse, replacing
                flan_tpu/ops/sqpv_pallas.py sqpv_inverse_fused ->
                _inv_kernel; plain version sqpv_inverse_ref, a
                transcription of _sqpv_inverse_scan.

Both kernels are memory-bound: the forward writes mag and pitch (float32)
and positive (bool) planes [C, N, B], 9 bytes an element; the inverse
reads as many, once. The design is described in the CUDA source; the
inverse kernel's cycles are 32-bit fixed point and its twiddle is folded
into each bin's starting cycles (inverse_offsets), so its roundings differ
from the plain version's: tests/test_torch_sqpv.py emulates them. The TPU
path's bin padding to 128, tile batching, prefix modes and staging split
existed for Mosaic and are not carried over: the kernels take 1 <= B <=
2048, any N, and read x directly instead of a staged comb plane.

The public transforms (sqpv/transform.py) dispatch by device: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel or the call
raises. LAUNCHES counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from flan_tpu_torch.ops.build import (MAX_BINS, SQPV_CARRY_CHUNK, TILE_FRAMES,
                                      check_cuda, load_library, raise_on)
from flan_tpu_torch.ops.fastmath import atan2 as _fast_atan2
from flan_tpu_torch.ops.spv_kernels import cumsum_blocked
from flan_tpu_torch.ops.stft import (_wrap_radians, cpu_exact,
                                     cumsum_mod1_frames, true_div)
from flan_tpu_torch.sqpv.transform import (_pad_for_comb, _stage_comb,
                                           cq_geometry)

_REF_CHUNK = 1024       # frames per chunk of the plain versions (as JAX)
_TWO_PI = 2.0 * math.pi

LAUNCHES = {"sqpv_forward": 0, "sqpv_inverse": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _np_dtype(dt: torch.dtype):
    return np.float64 if dt == torch.float64 else np.float32


@functools.lru_cache(maxsize=16)
def _twiddles(sample_rate, bins_per_octave, bandwidth, length, npdt):
    """(t1_re, t1_im, t2_re, t2_im), each [3, length, B] in npdt."""
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    t1, t2 = geo.twiddle_tables(length)
    return tuple(a.astype(npdt) for a in (t1.real, t1.imag, t2.real, t2.imag))


# ------------------------------------------------------------ plain versions

def sqpv_forward_ref(x: torch.Tensor, sample_rate: float,
                     bins_per_octave: float, bandwidth, chunk: int = _REF_CHUNK):
    """Plain PyTorch sliding constant-Q forward: audio [C, N] -> (mag,
    pitch, positive) [C, N, B], streamed over chunks of the timeline
    carrying each line's F and the previous frame's phase. Computes in x's
    dtype: float32 is the version the kernel is held to, float64 a
    reference for how far float32 summation drifts."""
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    c, n = x.shape
    nb, w0 = geo.nbins, geo.w0
    dev, dt = x.device, x.dtype
    npdt = _np_dtype(dt)
    t1_re, t1_im, t2_re, t2_im = (
        torch.from_numpy(a).to(dev)[:, None]                 # [3, 1, L, B]
        for a in _twiddles(sample_rate, bins_per_octave, bandwidth, chunk,
                           npdt))
    bin_freq, expected = (torch.from_numpy(a).to(dev)
                          for a in geo.bin_frequencies(npdt))
    hz_per_radian = sample_rate / _TWO_PI
    xq = _pad_for_comb(x, geo)

    mag = torch.empty((c, n, nb), dtype=dt, device=dev)
    pitch = torch.empty_like(mag)
    positive = torch.empty((c, n, nb), dtype=torch.bool, device=dev)
    f_re = torch.zeros((3, c, 1, nb), dtype=dt, device=dev)
    f_im = torch.zeros_like(f_re)
    prev_phase = torch.zeros((c, 1, nb), dtype=dt, device=dev)
    total = w0 + n
    for t0 in range(0, total, chunk):
        h = min(chunk, total - t0)
        u_re, u_im = _stage_comb(xq, x[:, 0], geo, t0, h)       # [C, h, B]
        # v = a^-i u on each line, then F = a^(i+1) (F_prev + cumsum v)
        v_re = u_re * t1_re[:, :, :h] - u_im * t1_im[:, :, :h]
        v_im = u_re * t1_im[:, :, :h] + u_im * t1_re[:, :, :h]
        s_re = cumsum_blocked(v_re.reshape(3 * c, h, nb)).reshape(
            3, c, h, nb) + f_re
        s_im = cumsum_blocked(v_im.reshape(3 * c, h, nb)).reshape(
            3, c, h, nb) + f_im
        big_re = s_re * t2_re[:, :, :h] - s_im * t2_im[:, :, :h]
        big_im = s_re * t2_im[:, :, :h] + s_im * t2_re[:, :, :h]
        # spectral hann over the lines (AudioSQPV.cpp:110-112)
        fw_re = 0.5 * big_re[1] - 0.25 * (big_re[0] + big_re[2])
        fw_im = 0.5 * big_im[1] - 0.25 * (big_im[0] + big_im[2])
        phase = _fast_atan2(fw_im, fw_re)
        lo = max(t0, w0) - t0          # first output frame of the chunk
        if lo < h:
            prev = torch.cat([prev_phase, phase[:, :-1]], dim=1)[:, lo:]
            # deliberate wrap at analysis rate == sample rate
            # (transform.py:197-202)
            delta = _wrap_radians(phase[:, lo:] - prev - expected)
            freq = bin_freq + delta * hz_per_radian
            rows = slice(t0 + lo - w0, t0 + h - w0)
            fr, fi = fw_re[:, lo:], fw_im[:, lo:]
            mag[:, rows] = cpu_exact(torch.sqrt, fr * fr + fi * fi)
            pitch[:, rows] = cpu_exact(torch.log2,
                                       torch.clamp(freq.abs(), min=1e-12))
            positive[:, rows] = freq >= 0
        f_re, f_im = big_re[:, :, -1:], big_im[:, :, -1:]
        prev_phase = phase[:, -1:]
    return mag, pitch, positive


def _decode_frequency(pitch: torch.Tensor, positive: torch.Tensor):
    """+-2^pitch, the sign from `positive` (transform.py:281-282)."""
    sign = torch.where(positive, 1.0, -1.0).to(pitch.dtype)
    return sign * torch.exp2(pitch)


def sqpv_inverse_ref(mag: torch.Tensor, pitch: torch.Tensor,
                     positive: torch.Tensor, sample_rate: float,
                     bins_per_octave: float, bandwidth,
                     chunk: int = _REF_CHUNK):
    """Plain PyTorch SQPV inverse: (mag, pitch, positive) [C, F, B] ->
    audio [C, F]: mod-1 phase accumulation of the decoded frequencies, then
    sum_b mag Re(e^{2 pi i cycles} tw_b) (AudioSQPV.cpp:128-165). Computes
    in mag's dtype."""
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    c, f, b = mag.shape
    if b != geo.nbins:
        raise ValueError(f"planes have {b} bins, the geometry {geo.nbins}")
    dev, dt = mag.device, mag.dtype
    npdt = _np_dtype(dt)
    tw = geo.synthesis_twiddle
    tw_re = torch.from_numpy(tw.real.astype(npdt)).to(dev)
    tw_im = torch.from_numpy(tw.imag.astype(npdt)).to(dev)
    out = torch.empty((c, f), dtype=dt, device=dev)
    cycle0 = torch.zeros((c, 1, b), dtype=dt, device=dev)
    for t0 in range(0, f, chunk):
        h = min(chunk, f - t0)
        freq = _decode_frequency(pitch[:, t0:t0 + h], positive[:, t0:t0 + h])
        inc = torch.remainder(true_div(freq, sample_rate), 1.0)
        cycles = torch.remainder(cumsum_mod1_frames(inc) + cycle0, 1.0)
        ang = cycles * _TWO_PI
        real = mag[:, t0:t0 + h] * (torch.cos(ang) * tw_re
                                    - torch.sin(ang) * tw_im)
        out[:, t0:t0 + h] = torch.sum(real, dim=-1)
        cycle0 = cycles[:, -1:]
    return out


# ------------------------------------------------------------------ kernels

def carry_powers_np(geo, chunk: int = SQPV_CARRY_CHUNK) -> np.ndarray:
    """a^(TILE_FRAMES i) for i in [0, chunk], per line: complex128
    [3, chunk + 1, B]. Row 1 is the carry's factor over one tile (equal to
    the last row of t2), row `chunk` its factor over one chunk of tiles."""
    jv = np.array([-1.0, 0.0, 1.0])
    theta = 2.0 * np.pi * (geo.q + jv[:, None]) / geo.periods[None, :]
    steps = float(TILE_FRAMES) * np.arange(chunk + 1, dtype=np.float64)
    return np.exp(1j * steps[None, :, None] * theta[:, None, :])


@functools.lru_cache(maxsize=8)
def forward_consts(sample_rate, bins_per_octave, bandwidth,
                   device: torch.device):
    """The forward kernel's constants on `device`, float32 from the float64
    geometry: t2 [128, B, 3, 2] (re, im of a^(i+1) per row, bin and line;
    t1 = a^-i is its conjugate one row up, bit for bit), the
    carry's powers [2, 3, SQPV_CARRY_CHUNK + 1, B], the float per-bin rows
    [6, B] (scale, quirk + re, + im, - re, bin Hz, expected) and the int
    rows [4, B] (P, M, quirk frames + and -)."""
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    f32 = np.float32
    t2 = np.stack(_twiddles(sample_rate, bins_per_octave, bandwidth,
                            TILE_FRAMES, f32)[2:]).transpose(2, 3, 1, 0)
    apow = carry_powers_np(geo)
    apow = np.stack([apow.real, apow.imag]).astype(f32)
    bin_freq, expected = geo.bin_frequencies(f32)
    bin_f = np.stack([geo.scale.astype(f32),
                      *(a.astype(f32) for a in geo.quirk_coefficients),
                      bin_freq, expected])
    bin_i = np.stack([geo.off_p, geo.off_m, geo.t_new, geo.t_old]).astype(
        np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (t2, apow, bin_f, bin_i))


def forward_scratch(channels: int, frames: int, geo, device) -> torch.Tensor:
    """The forward kernel's uninitialised scratch: the tile totals
    [C, ntiles, 6, B] over the timeline of w0 + frames, then the carries of
    the chunks of SQPV_CARRY_CHUNK tiles [C, nchunks, 6, B]."""
    ntiles = -(-(geo.w0 + frames) // TILE_FRAMES)
    nchunks = -(-ntiles // SQPV_CARRY_CHUNK)
    return torch.empty(channels * (ntiles + nchunks) * 6 * geo.nbins,
                       dtype=torch.float32, device=device)


INVERSE_STAGE_BYTES = 64 * 1024   # kInvStageBytes of csrc/sqpv_kernels.cu


def inverse_tile_frames(nbins: int) -> int:
    """Frames per tile of the inverse kernel for nbins bins, as
    flan_sqpv_inverse_tile_frames computes them: a multiple of 4 whose 9
    bytes a frame-bin fit INVERSE_STAGE_BYTES, from 4 to 128."""
    return min(max(INVERSE_STAGE_BYTES // (9 * nbins) // 4 * 4, 4), 128)


def inverse_offsets_np(geo) -> np.ndarray:
    """Each bin's synthesis twiddle e^{2 pi i Q / N_b} as the inverse kernel
    takes it: the angle Q / N_b in cycles, as 32-bit fixed point (rounded to
    2^-32 cycles in float64), the bin's starting cycles. uint32 [B]."""
    cycles = np.mod(geo.q / geo.periods.astype(np.float64), 1.0)
    return (np.round(cycles * 2.0 ** 32).astype(np.int64)
            % 2 ** 32).astype(np.uint32)


@functools.lru_cache(maxsize=8)
def inverse_offsets(sample_rate, bins_per_octave, bandwidth,
                    device: torch.device) -> torch.Tensor:
    """inverse_offsets_np on `device`, its bits as int32 [B]."""
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    return torch.from_numpy(inverse_offsets_np(geo).view(np.int32)).to(device)


def _check_geometry(geo) -> None:
    if geo.nbins > MAX_BINS:
        raise ValueError(f"{geo.nbins} bins: the kernels take at most "
                         f"{MAX_BINS}")


def sqpv_forward_cuda(x: torch.Tensor, sample_rate: float,
                      bins_per_octave: float, bandwidth):
    """The forward kernel on a float32 [C, N] CUDA tensor."""
    check_cuda(x, "x", 2)
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    _check_geometry(geo)
    lib = load_library()
    c, n = x.shape
    nb = geo.nbins
    fr, fi = np.float32(geo.fiddle.real), np.float32(geo.fiddle.imag)
    with torch.cuda.device(x.device):
        consts = forward_consts(sample_rate, bins_per_octave, bandwidth,
                                x.device)
        mag = torch.empty((c, n, nb), dtype=torch.float32, device=x.device)
        pitch = torch.empty_like(mag)
        positive = torch.empty((c, n, nb), dtype=torch.bool, device=x.device)
        tot = forward_scratch(c, n, geo, x.device)
        err = lib.flan_sqpv_forward(
            x.data_ptr(), *(t.data_ptr() for t in consts), tot.data_ptr(),
            mag.data_ptr(), pitch.data_ptr(), positive.data_ptr(), c, n, nb,
            geo.w0, float(fr), float(fi), float(sample_rate),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "sqpv_forward")
    LAUNCHES["sqpv_forward"] += 1
    return mag, pitch, positive


def sqpv_inverse_cuda(mag: torch.Tensor, pitch: torch.Tensor,
                      positive: torch.Tensor, sample_rate: float,
                      bins_per_octave: float, bandwidth):
    """The inverse kernel on float32 mag and pitch and bool positive
    [C, F, B] CUDA tensors."""
    check_cuda(mag, "mag", 3)
    check_cuda(pitch, "pitch", 3)
    check_cuda(positive, "positive", 3, torch.bool)
    if not (pitch.shape == positive.shape == mag.shape
            and pitch.device == positive.device == mag.device):
        raise ValueError("mag, pitch and positive must share shape and "
                         "device")
    geo = cq_geometry(sample_rate, bins_per_octave, bandwidth)
    _check_geometry(geo)
    c, n, nb = mag.shape
    if nb != geo.nbins:
        raise ValueError(f"planes have {nb} bins, the geometry {geo.nbins}")
    lib = load_library()
    with torch.cuda.device(mag.device):
        offsets = inverse_offsets(sample_rate, bins_per_octave, bandwidth,
                                  mag.device)
        out = torch.empty((c, n), dtype=torch.float32, device=mag.device)
        # the ticket counter and the look-back's descriptors, 8-byte words
        scratch = torch.empty(lib.flan_sqpv_inverse_scratch_bytes(c, n, nb)
                              // 8, dtype=torch.int64, device=mag.device)
        err = lib.flan_sqpv_inverse(
            mag.data_ptr(), pitch.data_ptr(), positive.data_ptr(),
            offsets.data_ptr(), scratch.data_ptr(), out.data_ptr(), c, n, nb,
            float(sample_rate), torch.cuda.current_stream().cuda_stream)
    raise_on(err, "sqpv_inverse")
    LAUNCHES["sqpv_inverse"] += 1
    return out
