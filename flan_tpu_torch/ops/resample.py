"""Sample-rate conversion (counterpart of flan_tpu/ops/resample.py).

* Whole-buffer rational resampling, the port of the reference's r8brain
  call (AudioConversions.cpp:14-30): a Kaiser-windowed sinc designed on
  the host in float64 (copied from the JAX package) and folded into one
  [L, win] polyphase matrix, so each block of L outputs is one row of a
  matrix product with the block's window of input. The product is
  torch.matmul in full float32 (the JAX package asks Precision.HIGHEST for
  its 140 dB design; TF32 would keep about three digits), taken over
  chunks of blocks: the windows of a 4x oversample of 600 s stereo would
  be ~15 GB if built at once.
* Variable-rate fractional-delay reading, the port of the WDL resampler
  (repitch, wavetable, doppler): read positions integrated on the host,
  then a dense gather of windowed-sinc taps per output frame.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

# windows of at most this many floats are built at once (256 MB)
_CHUNK_FLOATS = 1 << 26


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


def design_lowpass(num_taps: int, cutoff: float, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc FIR, cutoff in [0, 1] of Nyquist-normalized
    frequency (1 = Nyquist of the sampling rate the filter runs at)."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    w = np.i0(beta * np.sqrt(np.clip(
        1 - (2 * n / (num_taps - 1)) ** 2, 0, 1))) / np.i0(beta)
    return (h * w).astype(np.float64)


@functools.cache
def _rational_filter(L: int, M: int, taps_per_phase: int,
                     atten_db: float) -> np.ndarray:
    """Anti-aliasing/anti-imaging filter for L/M rational resampling,
    designed at the upsampled rate L*sr with gain L."""
    cutoff = 1.0 / max(L, M)
    num_taps = taps_per_phase * L
    if num_taps % 2 == 0:
        num_taps += 1
    h = design_lowpass(num_taps, cutoff, _kaiser_beta(atten_db)) * L
    return h.astype(np.float32)


@functools.cache
def polyphase_matrix(L: int, M: int, taps_per_phase: int, atten_db: float):
    """(mat [L, win] float32, off): y[b L + p] = sum_w mat[p, w] x[b M +
    off + w], with x zero outside the signal (resample.py:58-91). Output
    n reads upsampled position e = n M + c, c centring the filter; only
    taps s with (e - s) % L == 0 touch real input."""
    h = _rational_filter(L, M, taps_per_phase, atten_db).astype(np.float64)
    k = h.shape[0]
    kk = -(-k // L)                                 # taps per phase
    hp = np.zeros((kk * L,), np.float64)
    hp[:k] = h
    c = k - 1 - (k - 1) // 2                        # center (matches conv)
    p = np.arange(L)
    e = p * M + c
    ph = e % L                                      # starting tap phase
    d = e // L                                      # input index offset
    j = np.arange(kk)
    xi = d[:, None] - j[None, :]                    # [L, kk] input offsets
    off = int(xi.min())
    win = int(xi.max()) - off + 1
    mat = np.zeros((L, win), np.float64)
    taps = hp[(ph[:, None] + L * j[None, :]).reshape(-1)].reshape(L, kk)
    np.add.at(mat, (np.repeat(p, kk), (xi - off).reshape(-1)),
              taps.reshape(-1))
    return mat.astype(np.float32), off


def rational_resample(x: torch.Tensor, L: int, M: int, num_out: int,
                      taps_per_phase: int = 64,
                      atten_db: float = 140.0) -> torch.Tensor:
    """x [C, N] resampled by L/M to [C, num_out]: blocks of L outputs, each
    the polyphase matrix times the block's window of input, over chunks of
    blocks whose windows take at most _CHUNK_FLOATS floats."""
    mat_np, off = polyphase_matrix(L, M, taps_per_phase, atten_db)
    mat_t = torch.from_numpy(mat_np).to(x.device).t()      # [win, L]
    win = mat_np.shape[1]
    c, n = x.shape
    nb = -(-num_out // L)
    # block b reads x[b M + off : b M + off + win]: pad so every block is in
    # range, then take the windows as a strided view of the padded signal
    left = max(0, -off)
    right = max(0, (nb - 1) * M + off + win - n)
    xp = torch.nn.functional.pad(x, (left, right))[:, off + left:]
    out = torch.empty((c, nb, L), dtype=x.dtype, device=x.device)
    step = max(1, _CHUNK_FLOATS // max(1, c * win))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        span = xp[:, b0 * M:(b1 - 1) * M + win]
        out[:, b0:b1] = torch.matmul(span.unfold(-1, win, M), mat_t)
    return out.reshape(c, nb * L)[:, :num_out]


def resample(x: torch.Tensor, sr_in: float, sr_out: float,
             taps_per_phase: int = 64, atten_db: float = 140.0,
             max_denominator: int = 1000) -> torch.Tensor:
    """Whole-buffer SRC of [C, N] audio (resample.py:124-147). The output
    length is the reference's truncation num_frames * sr_out / sr_in
    (AudioConversions.cpp:22); the ratio is the nearest fraction with a
    denominator up to max_denominator."""
    if sr_in == sr_out:
        return x
    frac = Fraction(sr_out / sr_in).limit_denominator(max_denominator)
    L, M = frac.numerator, frac.denominator
    num_out = int(x.shape[-1] * (sr_out / sr_in))
    return rational_resample(x, L, M, num_out, taps_per_phase, atten_db)


def _tap_sum(p: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of p as a fixed tree of elementwise adds
    (halves added pairwise, the axis padded with zeros in front to a power
    of two): every output's order of operations is the same whatever the
    other axes hold, on either device."""
    k = p.shape[-1]
    width = 1 << (k - 1).bit_length()
    if width != k:
        p = torch.nn.functional.pad(p, (width - k, 0))
    while width > 1:
        width //= 2
        p = p[..., :width] + p[..., width:]
    return p[..., 0]


def fractional_gather(x: torch.Tensor, positions: torch.Tensor,
                      cutoff: torch.Tensor, num_taps: int = 32
                      ) -> torch.Tensor:
    """Windowed-sinc interpolation of x [C, N] at fractional read positions
    [num_out] with a per-output cutoff [num_out] in (0, 1] (1 = the input's
    Nyquist; min(1, 1 / rate) antialiases downward sweeps); positions
    outside the input read zeros (resample.py:150-183). The outputs go in
    chunks whose [C, O, K] gather takes at most _CHUNK_FLOATS floats (a
    chunk's planes peak at about 6 times that many bytes: ~1.5 GB), each
    output's taps summed in a fixed order (_tap_sum), so a chunk's outputs
    have the same bits as in one call; the JAX package's einsum at
    Precision.HIGHEST is a full float32 sum too."""
    c = x.shape[0]
    num_out = positions.shape[0]
    step = max(1, _CHUNK_FLOATS // max(1, c * num_taps))
    if num_out <= step:
        return _gather_taps(x, positions, cutoff, num_taps)
    out = torch.empty((c, num_out), dtype=x.dtype, device=x.device)
    for o0 in range(0, num_out, step):
        o1 = min(num_out, o0 + step)
        out[:, o0:o1] = _gather_taps(x, positions[o0:o1], cutoff[o0:o1],
                                     num_taps)
    return out


def _gather_taps(x, positions, cutoff, num_taps: int) -> torch.Tensor:
    """fractional_gather over one chunk of outputs."""
    c, n = x.shape
    base = torch.floor(positions).to(torch.int64)
    frac = positions - base
    offs = torch.arange(-(num_taps // 2 - 1), num_taps // 2 + 1,
                        device=x.device)                        # [K]
    idx = base[:, None] + offs[None, :]                         # [O, K]
    valid = (idx >= 0) & (idx < n)
    samples = x[:, idx.clamp(0, n - 1)]                         # [C, O, K]
    samples = torch.where(valid[None], samples, 0.0)
    # Kaiser-windowed sinc taps evaluated at (offs - frac) * cutoff, under a
    # 4-term cosine window over the tap span
    t = (offs[None, :] - frac[:, None]) * cutoff[:, None]
    sinc = torch.sinc(t) * cutoff[:, None]
    u = torch.clamp((offs[None, :] - frac[:, None]) / (num_taps / 2),
                    -1.0, 1.0)
    w = (0.35875 + 0.48829 * torch.cos(math.pi * u)
         + 0.14128 * torch.cos(2 * math.pi * u)
         + 0.01168 * torch.cos(3 * math.pi * u))
    return _tap_sum(samples * (sinc * w)[None])


def variable_rate_positions(rate_per_block: np.ndarray,
                            block_frames: int) -> np.ndarray:
    """Per-block read rates integrated into per-output-frame read positions
    (resample.py:186-200), as the reference's blockwise WDL loop does
    (AudioTemporal.cpp:267-296): each block of block_frames output frames
    advances the read head at its own constant rate. Host float64."""
    starts = np.concatenate(
        [[0.0], np.cumsum(rate_per_block.astype(np.float64))
         * block_frames])[:-1]
    local = np.arange(block_frames, dtype=np.float64)
    pos = starts[:, None] + local[None, :] * rate_per_block[:, None]
    return pos.reshape(-1)
