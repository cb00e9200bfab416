"""The phase vocoder's analysis epilogue (H1) and synthesis prologue (H2):
Hopper kernels and their plain versions.

They replace no TPU kernel. flan_tpu/ops/stft.py (rfft_mag_phase,
_wrap_radians, cumsum_mod1_frames, pv_forward, pv_inverse) and
flan_tpu/pipelines/streamed.py (_streamed_scan) leave the work around the
FFTs to XLA, which fuses it; here it is one kernel a chunk on each side of
cuFFT.

  analysis_cuda   H1, csrc/pv_stage_kernels.cu flan_pv_analysis: from the
                  R2C spectrum [..., H, B], mag, the polynomial phase, the
                  lag-1 phase difference less the expected advance,
                  wrapped half to even, and freq, written straight into the
                  caller's rows; the last phase carried.
  synthesis_cuda  H2, same file, flan_pv_synthesis: the remap of a chunk's
                  plan (optional), the increments, the mod-1 cycles of
                  ops/phase_math.py cumsum_mod1_frames from a carried
                  cycle, and the polar spectrum [C, F, B] complex64 that
                  irfft takes; the last cycle carried. Without writing,
                  the last cycle alone (the sharded paths' totals). Each
                  element is read, computed and written once: a block a
                  (channel, 32 bins, 256 frames), the blocks of 32 bins
                  chained in a thread-block cluster.
  analysis_ref,   the plain PyTorch versions: the operations the callers ran
  synthesis_ref   before the kernels, in the same order, so each kernel
                  gives their bits.
  remap           the chunk's remap alone, on every device: the streamed
                  paths' stage before a chunk op.
  exact_path_columns  the columns of a call whose cycle sums H2 takes in
                  frame order (the rest it adds in any order, exactly).

analysis() and synthesis() dispatch by device: the CPU takes the plain
version, CUDA the kernel or the call raises. LAUNCHES counts the kernels'
calls.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on
from flan_tpu_torch.ops.fastmath import atan2 as _fast_atan2
from flan_tpu_torch.ops.phase_math import (_TWO_PI, _wrap_radians,
                                           clean_columns, cpu_exact,
                                           cumsum_mod1_frames, true_div)

LAUNCHES = {"pv_analysis": 0, "pv_synthesis": 0}

# float32 constants as torch's CUDA kernels round them: the wrap divides by
# 2 pi as a multiply by float32(1) / float32(2 pi)
_TWO_PI_F32 = np.float32(_TWO_PI)
_INV_TWO_PI_F32 = np.float32(1.0) / _TWO_PI_F32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scale(analysis_rate: float) -> float:
    """float32(analysis_rate / 2 pi), the factor freq takes the wrapped
    phase difference by."""
    return float(np.float32(analysis_rate / _TWO_PI))


# ------------------------------------------------------------------- H1

def analysis_ref(spec: torch.Tensor, bin_freq: torch.Tensor,
                 expected: torch.Tensor, analysis_rate: float,
                 prev=None, dead: int = 0):
    """(mag, freq, last phase) of the spectrum [..., H, B] complex64.

    prev [..., 1, B]: frame 0's previous phase; None: frame 0 is a helper
    hop that only seeds the difference and is dropped (mag and freq then
    [..., H - 1, B]), and frames 1 .. dead - 1 take a previous phase of 0
    (hops before the signal's first). The last phase is frame H - 1's,
    [..., 1, B]."""
    re, im = spec.real, spec.imag
    energy = re * re + im * im
    zero = energy == 0.0
    phase = _fast_atan2(torch.where(zero, 0.0, im), torch.where(zero, 1.0, re))
    mag = cpu_exact(torch.sqrt, energy)
    if prev is None:
        before = torch.nn.functional.pad(phase[..., :-1, :], (0, 0, 1, 0))
        if dead > 1:
            before[..., 1:dead, :] = 0.0
    else:
        before = torch.cat([prev, phase[..., :-1, :]], dim=-2)
    delta = _wrap_radians(phase - before - expected)
    freq = bin_freq + delta * (analysis_rate / _TWO_PI)
    skip = 1 if prev is None else 0
    return mag[..., skip:, :], freq[..., skip:, :], phase[..., -1:, :]


def _rows_view(t: torch.Tensor, rows: int, frames: int, nbins: int,
               name: str) -> int:
    """The row stride of an output plane [..., frames, nbins] whose bins
    are contiguous, frames nbins apart, and leading dimensions one run of
    rows; raises for any other layout."""
    if t.dtype != torch.float32 or t.shape[-2:] != (frames, nbins):
        raise ValueError(f"{name}: want float32 [..., {frames}, {nbins}], "
                         f"got {t.dtype} {tuple(t.shape)}")
    try:
        v = t.view(rows, frames, nbins)
    except RuntimeError as e:
        raise ValueError(f"{name}: its rows are not evenly strided") from e
    if nbins > 1 and v.stride(2) != 1 or frames > 1 and v.stride(1) != nbins:
        raise ValueError(f"{name}: want contiguous rows of frames")
    return v.stride(0)


def analysis_cuda(spec: torch.Tensor, bin_freq: torch.Tensor,
                  expected: torch.Tensor, analysis_rate: float,
                  prev=None, dead: int = 0, out=None):
    """H1 on the card: analysis_ref's (mag, freq, last phase), mag and freq
    written into out = (mag, freq) when given (views whose frames are
    contiguous rows: mag[:, start:start + h] of a [C, hops, B] plane)."""
    if spec.device.type != "cuda" or spec.dtype != torch.complex64:
        raise ValueError(f"spec must be complex64 on a CUDA device, got "
                         f"{spec.dtype} on {spec.device}")
    if spec.ndim < 2 or spec.numel() == 0 or not spec.is_contiguous():
        raise ValueError(f"spec must be a non-empty contiguous [..., H, B] "
                         f"tensor, got {tuple(spec.shape)}")
    lead, (H, B) = spec.shape[:-2], spec.shape[-2:]
    rows = int(np.prod(lead, dtype=np.int64))
    skip = 1 if prev is None else 0
    for t, name in ((bin_freq, "bin_freq"), (expected, "expected")):
        check_cuda(t, name, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} bins, spec {B}")
    if prev is not None:
        check_cuda(prev, "prev", prev.ndim)
        if prev.numel() != rows * B:
            raise ValueError(f"prev has {prev.numel()} elements, want "
                             f"{rows} x {B}")
        dead = 0
    if out is None:
        mag = torch.empty((*lead, H - skip, B), dtype=torch.float32,
                          device=spec.device)
        out = (mag, torch.empty_like(mag))
    stride = _rows_view(out[0], rows, H - skip, B, "mag")
    if _rows_view(out[1], rows, H - skip, B, "freq") != stride:
        raise ValueError("mag and freq must share their layout")
    carry = torch.empty((*lead, 1, B), dtype=torch.float32,
                        device=spec.device)
    lib = load_library()
    with torch.cuda.device(spec.device):
        err = lib.flan_pv_analysis(
            spec.data_ptr(), rows, H, B,
            None if prev is None else prev.data_ptr(), int(dead),
            bin_freq.data_ptr(), expected.data_ptr(),
            float(_INV_TWO_PI_F32), float(_TWO_PI_F32),
            _scale(analysis_rate), out[0].data_ptr(), out[1].data_ptr(),
            stride, carry.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "pv_analysis")
    LAUNCHES["pv_analysis"] += 1
    return out[0], out[1], carry


def analysis(spec: torch.Tensor, bin_freq: torch.Tensor,
             expected: torch.Tensor, analysis_rate: float, *, prev=None,
             dead: int = 0, out=None):
    """(mag, freq, last phase) of the R2C spectrum [..., H, B] (analysis_ref
    says what they are), on spec's device: the plain version on the CPU
    (copied into out when it is given), H1 on the card."""
    if spec.device.type == "cpu":
        mag, freq, last = analysis_ref(spec, bin_freq, expected,
                                       analysis_rate, prev, dead)
        if out is None:
            return mag, freq, last
        out[0].copy_(mag)
        out[1].copy_(freq)
        return out[0], out[1], last
    return analysis_cuda(spec.contiguous(), bin_freq, expected,
                         analysis_rate, prev, dead, out)


# ------------------------------------------------------------------- H2

def remap(mag, freq, li, mix, valid):
    """The monotonic time remap of one chunk, weighted-frequency-sum
    policy (PVModify.cpp:344-355), on planes [..., frames, B]: output frame
    j reads frames li[j] and li[j] + 1 with weights 1 - mix[j] and mix[j];
    frames outside the map (valid false) are zero. The remap stage of the
    streamed paths with a chunk op, on every device, and the first step of
    synthesis_ref with a plan (H2 fuses it)."""
    mix = mix[:, None]
    w0 = (1.0 - mix) * mag.index_select(-2, li)
    w1 = mix * mag.index_select(-2, li + 1)
    total = w0 + w1
    fsum = (w0 * freq.index_select(-2, li)
            + w1 * freq.index_select(-2, li + 1))
    v = valid[:, None]
    pos = total > 0.0
    return (torch.where(v, total, 0.0),
            torch.where(v & pos, fsum / torch.where(pos, total, 1.0), 0.0))


def synthesis_ref(mag, freq, cycle, analysis_rate: float, plan=None,
                  write: bool = True):
    """(spectrum, last cycle) of the planes [C, frames, B].

    plan (li, mix, valid) [F]: the planes remapped first (remap). The
    cycles are the mod-1 sums of remainder(freq / analysis_rate, 1) along
    the frames (cumsum_mod1_frames), plus the carried cycle [C, 1, B] mod 1;
    the spectrum [C, F, B] complex64 is mag exp(2 pi i cycles), None when
    write is false. The last cycle [C, 1, B] is the last frame's; with
    cycle None (write false only) the raw sum's, no cycle added."""
    if plan is not None:
        mag, freq = remap(mag, freq, *plan)
    cycles = cumsum_mod1_frames(
        torch.remainder(true_div(freq, analysis_rate), 1.0))
    if cycle is not None:
        cycles = torch.remainder(cycles + cycle, 1.0)
    if not write:
        return None, cycles[:, -1:]
    phase = cycles * _TWO_PI
    return (torch.complex(mag * torch.cos(phase), mag * torch.sin(phase)),
            cycles[:, -1:])


def exact_path_columns(mag, freq, analysis_rate: float, plan=None) -> int:
    """How many columns (channel, block of 256 frames, bin) of synthesis'
    increments hold one that is not a whole multiple of 2^-45 (a nonzero
    increment below 2^-22 with low bits set, or NaN): the columns H2 sums
    in frame order. Every other column's float64 sums are exact, and H2
    adds them in any order (csrc/pv_stage_kernels.cu)."""
    if plan is not None:
        mag, freq = remap(mag, freq, *plan)
    inc = torch.remainder(true_div(freq, analysis_rate), 1.0)
    return int((~clean_columns(inc)).sum())


def synthesis_cuda(mag, freq, cycle, analysis_rate: float, plan=None,
                   write: bool = True):
    """H2 on the card: synthesis_ref's (spectrum, last cycle). mag and freq
    [C, frames, B] may be views whose frames are contiguous rows
    (mag[:, start:start + h] of a [C, F, B] plane)."""
    if mag.shape != freq.shape or mag.ndim != 3 or mag.numel() == 0:
        raise ValueError(f"mag and freq must be one non-empty [C, frames, "
                         f"B] shape, got {tuple(mag.shape)}, "
                         f"{tuple(freq.shape)}")
    c, frames, nbins = mag.shape
    for t, name in ((mag, "mag"), (freq, "freq")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    stride = _rows_view(mag, c, frames, nbins, "mag")
    if _rows_view(freq, c, frames, nbins, "freq") != stride:
        raise ValueError("mag and freq must share their layout")
    n_out = frames
    if plan is not None:
        li, mix, valid = plan
        check_cuda(li, "li", 1, torch.int64)
        check_cuda(mix, "mix", 1)
        check_cuda(valid, "valid", 1, torch.bool)
        n_out = li.shape[0]
        if mix.shape[0] != n_out or valid.shape[0] != n_out:
            raise ValueError("li, mix and valid must have one length")
    if cycle is not None:
        check_cuda(cycle, "cycle", 3)
        if tuple(cycle.shape) != (c, 1, nbins):
            raise ValueError(f"cycle must be [{c}, 1, {nbins}], got "
                             f"{tuple(cycle.shape)}")
    elif write:
        raise ValueError("synthesis writes from a carried cycle")
    dev = mag.device
    spec = (torch.empty((c, n_out, nbins), dtype=torch.complex64, device=dev)
            if write else None)
    last = torch.empty((c, 1, nbins), dtype=torch.float32, device=dev)
    ptrs = ((None, None, None) if plan is None else
            (li.data_ptr(), mix.data_ptr(), valid.data_ptr()))
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.flan_pv_synthesis(
            mag.data_ptr(), freq.data_ptr(), stride, *ptrs,
            None if cycle is None else cycle.data_ptr(), last.data_ptr(),
            None if spec is None else spec.data_ptr(), int(write), c, n_out,
            nbins, float(np.float32(analysis_rate)), float(_TWO_PI_F32),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "pv_synthesis")
    LAUNCHES["pv_synthesis"] += 1
    return spec, last


def synthesis(mag, freq, cycle, analysis_rate: float, *, plan=None,
              write: bool = True):
    """(spectrum, last cycle) of the planes [C, frames, B] from the carried
    cycle (synthesis_ref says what they are), on mag's device: the plain
    version on the CPU, H2 on the card."""
    if mag.device.type == "cpu":
        return synthesis_ref(mag, freq, cycle, analysis_rate, plan, write)
    # a chunk op may hand back any layout: the kernel reads rows of frames
    if not (mag.ndim == 3 and mag.stride() == freq.stride()
            and mag.stride(2) == 1 and mag.stride(1) == mag.shape[2]):
        mag, freq = mag.contiguous(), freq.contiguous()
    return synthesis_cuda(mag, freq, cycle, analysis_rate, plan, write)
