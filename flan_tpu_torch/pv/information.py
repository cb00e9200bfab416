"""PV salience / contours / prism, the Salamon & Gomez melody machinery
(counterpart of flan_tpu/pv/information.py; reference:
src/flan/PV/PVInformation.cpp). Bound onto PV in pv/__init__.py.

The salience map runs on the PV's device: per-frame peaks batched through
a top-K, then the histogram of their subharmonic contributions and its
cosine spread in one fixed order (ops/pv_info_kernels.py: the
salience_histogram kernel on the card, its plain version on the CPU).
Contour tracking is greedy control flow over sparse peak lists, and prism
rewrites each contour's frames: both are host numpy loops by the
reference's design, copied from the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from flan_tpu_torch.ops.pv_info_kernels import salience_histogram
from flan_tpu_torch.ops.stft import cpu_exact, true_div

_NOTES_CLOSE_LO = 2.0 ** (-1.0 / 24.0)
_NOTES_CLOSE_HI = 2.0 ** (1.0 / 24.0)


@dataclasses.dataclass
class Salience:
    """(reference PV.h:131-137); buffer [frames, bins] float32 numpy."""
    num_frames: int = 0
    num_bins: int = 0
    buffer: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.float32))

    def get(self, frame: int, b: int) -> float:
        return float(self.buffer[frame, b])


@dataclasses.dataclass
class Contour:
    """(reference PV.h:153-162): bins holds (pitch_bin, salience) pairs."""
    pitch_mean: float = 0.0
    pitch_std_dev: float = 0.0
    salience_mean: float = 0.0
    salience_std_dev: float = 0.0
    start_frame: int = 0
    bins: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2)))


def _hann_dft2(f: torch.Tensor) -> torch.Tensor:
    """The hann window's DFT magnitude at bin offset f, normalised to 1 at
    0 (flan_tpu/pv/information.py:50-56)."""
    af = torch.abs(f)
    return torch.where(
        af < 1e-9, 1.0,
        torch.where(torch.abs(af - 1.0) < 1e-9, 0.5,
                    cpu_exact(torch.sin, math.pi * f)
                    / (math.pi * f * (1.0 - f * f) + 1e-30)))


def salience_peaks(self, channel: int, max_peaks=None):
    """Each frame's magnitude peaks as (i_f, i_m) [F, K] float32 on the
    PV's device: the K loudest strict local maxima above the frame's
    maximum / 100, with the hann-DFT amplitude correction
    (PVInformation.cpp:28-87; flan_tpu/pv/information.py:82-111). K
    defaults to the measured most peaks in a frame rounded up to 16, which
    is lossless; slots past a frame's peaks hold i_m = 0."""
    e_test = 10.0 ** (40.0 / 20.0)
    mag = self.mag[channel]                      # [F, B]
    freq = self.freq[channel]
    b_cnt = mag.shape[1]
    mid = mag[:, 1:-1]
    is_peak = (mid > mag[:, :-2]) & (mid >= mag[:, 2:])
    peak_mask = torch.nn.functional.pad(is_peak, (1, 1))
    a_max = torch.max(mag, dim=-1, keepdim=True).values
    peak_mask = peak_mask & (mag > true_div(a_max, e_test))
    if max_peaks is None:
        most = int(torch.sum(peak_mask, dim=-1).max())
        max_peaks = -(-max(most, 1) // 16) * 16
    max_peaks = min(max_peaks, b_cnt)
    vals, idxs = torch.topk(torch.where(peak_mask, mag, -1.0), max_peaks,
                            dim=-1)
    picked = vals > 0
    i_f = torch.gather(freq, 1, idxs)
    # instantaneous amplitude correction (PVInformation.cpp:82-87)
    bin_offset = true_div(i_f, self.bin_width) - idxs
    kernel = _hann_dft2(true_div(bin_offset * self.window_size,
                                 self.dft_size))
    i_m = torch.where(kernel >= 0.5, vals / torch.clamp(kernel, min=1e-9),
                      0.0)
    i_m = torch.where(picked & (i_f > 0), i_m, 0.0)
    return i_f.contiguous(), i_m.contiguous()


def get_salience(self, channel: int, min_frequency: float = 55.0,
                 max_frequency: float = 1760.0, max_peaks=None) -> Salience:
    """Perceived-pitch salience map (reference PVInformation.cpp:28-109):
    per-frame magnitude peaks, hann-DFT amplitude correction, subharmonic
    accumulation with cosine spreading, normalised to its peak. Pass
    max_peaks to cap the peaks a frame feeds (lossy on dense noise)."""
    if self.is_null():
        return Salience()
    log2_min = math.log2(min_frequency)
    sal_bins = int(round(120.0 * (math.log2(max_frequency) - log2_min)))
    i_f, i_m = salience_peaks(self, channel, max_peaks)
    sal = salience_histogram(i_f, i_m, sal_bins + 20, log2_min)
    peak = torch.max(sal)
    sal = sal / torch.where(peak > 0, peak, 1.0)
    return Salience(num_frames=int(sal.shape[0]), num_bins=sal_bins,
                    buffer=sal.cpu().numpy())


def _frame_peaks(row: np.ndarray):
    """Interpolated local maxima of one salience frame, loudest first."""
    from flan_tpu_torch.ops.dsp_utility import find_peaks
    return find_peaks(row, -1, True, True)


def get_contours(self, channel: int, min_frequency: float = 55.0,
                 max_frequency: float = 1760.0, filter_short: int = 30,
                 filter_quiet: float = 20.0) -> List[Contour]:
    """Greedy S+/S- contour tracking (reference PVInformation.cpp:111-263;
    flan_tpu/pv/information.py:151-245), on the host."""
    t_plus = 0.9
    t_sigma = 0.9
    pitch_bin_cents = 10.0
    max_delta_pitch = 80.0
    max_gap = int(self.time_to_frame(0.1))

    sal = get_salience(self, channel, min_frequency, max_frequency)
    if sal.buffer.size == 0:
        return []
    nf = sal.num_frames

    s_plus: List[list] = []
    s_minus: List[list] = []
    for f in range(nf):
        peaks = _frame_peaks(sal.buffer[f])
        thresh = t_plus * sal.buffer[f].max()
        s_plus.append([list(p) for p in peaks if p[1] >= thresh])
        s_minus.append([list(p) for p in peaks if p[1] < thresh])

    all_plus = [p for f in s_plus for p in f]
    if not all_plus:
        return []
    ys = np.asarray([p[1] for p in all_plus])
    global_thresh = ys.mean() - t_sigma * ys.std()
    for f in range(nf):
        keep, drop = [], []
        for p in s_plus[f]:
            (keep if p[1] >= global_thresh else drop).append(p)
        s_plus[f] = keep
        s_minus[f].extend(drop)

    delta = max_delta_pitch / pitch_bin_cents

    def extend(start, end, bins):
        step = 1 if end > start else -1
        current = bins[-1][0]
        gap = 0
        f = start
        while f != end and gap < max_gap:
            hit = next((p for p in s_plus[f]
                        if abs(p[0] - current) < delta), None)
            if hit is not None:
                bins.append(hit)
                current = hit[0]
                s_plus[f].remove(hit)
                gap = 0
            else:
                hit = next((p for p in s_minus[f]
                            if abs(p[0] - current) < delta), None)
                if hit is None:
                    break
                bins.append(hit)
                current = hit[0]
                s_minus[f].remove(hit)
                gap += 1
            f += step

    contours: List[Contour] = []
    while True:
        best_frame, best_val = -1, 0.0
        for f in range(nf):
            if s_plus[f] and s_plus[f][0][1] > best_val:
                best_val = s_plus[f][0][1]
                best_frame = f
        if best_frame < 0:
            break
        bins = [s_plus[best_frame].pop(0)]
        extend(best_frame - 1, -1, bins)
        start_frame = best_frame + 1 - len(bins)
        bins.reverse()
        extend(best_frame + 1, nf, bins)

        if len(bins) < filter_short:
            continue
        arr = np.asarray(bins)
        contours.append(Contour(
            pitch_mean=float(arr[:, 0].mean()),
            pitch_std_dev=float(arr[:, 0].std()),
            salience_mean=float(arr[:, 1].mean()),
            salience_std_dev=float(arr[:, 1].std()),
            start_frame=int(start_frame), bins=arr))

    if not contours:
        return []
    max_sal = max(c.salience_mean for c in contours)
    return [c for c in contours if c.salience_mean >= max_sal / filter_quiet]


def prism(self, prism_func, use_local_contour_time: bool = True):
    """Per-contour per-harmonic magnitude/frequency rewriting (reference
    PVInformation.cpp:265-421; flan_tpu/pv/information.py:248-311).
    prism_func(note_index, time, harmonic, base_freq, harmonic_mags) ->
    (mag, freq), harmonic_mags the numpy array of the frame's harmonic
    magnitudes. The planes come to the host once; each contour's frames
    are rewritten as batched numpy over [contour frames, harmonics, 21-bin
    windows], the callback called once per contour frame with the
    harmonics vectorised (a scalar-only callback is retried per
    harmonic); the result goes back to the PV's device."""
    from flan_tpu_torch.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    min_frequency, max_frequency = 55.0, 1760.0
    # reference get_height() is bin_to_frequency(num_bins), one past the
    # last bin (PVBuffer.cpp:391-393), golden-tested via algo_prism_*
    height = self.bin_to_frequency(self.num_bins)
    src_mag, src_freq = self.to_numpy()
    out_mag = src_mag.copy()
    out_freq = src_freq.copy()

    for channel in range(self.num_channels):
        contours = get_contours(self, channel, min_frequency, max_frequency,
                                60, 20.0)
        if not contours:
            # reference parity: any channel without contours nulls the
            # whole call (PVInformation.cpp:299)
            return PV.create_null()
        contours.sort(key=lambda c: c.start_frame)
        for ci, contour in enumerate(contours):
            _prism_one_contour(self, prism_func, use_local_contour_time,
                               channel, ci, contour, src_mag, src_freq,
                               out_mag, out_freq, min_frequency, height,
                               self.num_bins, self.bin_width)

    return self._with(mag=torch.from_numpy(out_mag).to(self.device),
                      freq=torch.from_numpy(out_freq).to(self.device))


def _prism_one_contour(self, prism_func, use_local_contour_time, channel,
                       ci, contour, src_mag, src_freq, out_mag, out_freq,
                       min_frequency, height, b_cnt, bin_width):
    """One contour's rewrite (flan_tpu/pv/information.py:314-480): its
    base frequencies, harmonic windows and selections batched; the writes
    harmonic by harmonic, as the reference orders them within a frame."""
    frames, cfs, approxs = [], [], []
    for cf in range(len(contour.bins)):
        frame = contour.start_frame + cf
        if 0 <= frame < self.num_frames:
            frames.append(frame)
            cfs.append(cf)
            approxs.append(min_frequency * 2.0 ** (contour.bins[cf][0]
                                                   / 120.0))
    if not frames:
        return
    fr_idx = np.asarray(frames, np.int64)
    approx = np.asarray(approxs, np.float64)

    # base-frequency estimate (PVInformation.cpp:300-318), in float32 like
    # the reference, so borderline ratio and threshold comparisons resolve
    # the same way
    mg = src_mag[channel][fr_idx]                 # [M, B]
    fq = src_freq[channel][fr_idx]
    ratio_a = fq / approx.astype(np.float32)[:, None]
    close = ((fq > 0.01) & (ratio_a > _NOTES_CLOSE_LO)
             & (ratio_a < _NOTES_CLOSE_HI))
    w = np.where(close, np.abs(mg), np.float32(0.0)).astype(np.float32)
    tot = w.sum(axis=-1, dtype=np.float32)
    base = np.where(tot > 0, (fq * w).sum(axis=-1, dtype=np.float32)
                    / np.maximum(tot, np.float32(1e-30)),
                    np.float32(0.0)).astype(np.float64)
    # the harmonic count floors the float32 quotient (PVInformation.cpp:314)
    nharm = np.where(base >= 1.0,
                     (np.float32(height)
                      / np.maximum(base, 1e-9).astype(np.float32))
                     .astype(np.int64), 0)
    keep = np.nonzero((tot > 0) & (base >= 1.0) & (nharm >= 1))[0]
    if keep.size == 0:
        return
    fr_idx, base, nharm = fr_idx[keep], base[keep], nharm[keep]
    mg, fq = mg[keep], fq[keep]
    cfs_k = [cfs[i] for i in keep]
    m_cnt = keep.size
    h_max = int(nharm.max())

    # harmonic windows and selection, the decisions in float32 like the
    # reference's Frequency / fBin types (PVInformation.cpp:324-336)
    h = np.arange(1, h_max + 1, dtype=np.float32)
    bwd32 = np.float32(bin_width)
    f_h = base.astype(np.float32)[:, None] * h[None, :]  # [M, H] f32
    hvalid = h[None, :] <= nharm[:, None]
    c_bin = (f_h / bwd32).astype(np.int32)           # trunc, as Bin()
    offs = np.arange(-10, 11, dtype=np.int32)
    wb = c_bin[:, :, None] + offs[None, None, :]     # [M, H, 21]
    vb = (wb >= 0) & (wb < b_cnt) & hvalid[:, :, None]
    wbc = np.clip(wb, 0, b_cnt - 1)
    m_ix = np.arange(m_cnt)[:, None, None]
    wf = fq[m_ix, wbc]                               # [M, H, 21]
    wm = mg[m_ix, wbc]
    f_h32 = np.maximum(f_h, np.float32(1e-30))
    ratio = wf / f_h32[:, :, None]
    sel = (vb & (wf > 0.01)
           & (ratio > np.float32(_NOTES_CLOSE_LO))
           & (ratio < np.float32(_NOTES_CLOSE_HI)))

    fidx3 = np.broadcast_to(fr_idx[:, None, None], wb.shape)
    out_mag[channel][fidx3[sel], wbc[sel]] = 0.0     # zeroing pass

    wm_sel = np.where(sel, wm, -np.inf)
    arg = wm_sel.argmax(axis=-1)                     # [M, H]
    any_sel = sel.any(axis=-1)
    max_bins = np.take_along_axis(wbc, arg[:, :, None], axis=-1)[:, :, 0]
    mm_raw = np.take_along_axis(wm, arg[:, :, None], axis=-1)[:, :, 0]
    max_mags = np.where(any_sel & (mm_raw >= 0.01), mm_raw, 0.0)
    max_bins = np.where(any_sel, max_bins, 0)

    # the user callback, one call per entry (harmonics vectorised)
    new_m = np.zeros((m_cnt, h_max), np.float64)
    new_f = np.full((m_cnt, h_max), -1.0, np.float64)
    for i in range(m_cnt):
        hn = int(nharm[i])
        t_arg = self.frame_to_time(
            cfs_k[i] if use_local_contour_time else int(fr_idx[i]))
        hm = max_mags[i, :hn].astype(np.float32)
        try:
            rm, rf = prism_func(ci, t_arg, np.arange(1, hn + 1),
                                float(base[i]), hm)
            rm = np.broadcast_to(np.asarray(rm, np.float64).reshape(-1),
                                 (hn,))
            rf = np.broadcast_to(np.asarray(rf, np.float64).reshape(-1),
                                 (hn,))
        except Exception:
            rm = np.empty(hn)
            rf = np.empty(hn)
            for hh in range(hn):
                rm[hh], rf[hh] = prism_func(ci, t_arg, hh + 1,
                                            float(base[i]), hm)
        new_m[i, :hn] = rm
        new_f[i, :hn] = rf

    # shifted-copy writes (max-magnitude combine), the target bins and
    # scales in float32 (PVInformation.cpp:382-386)
    wh = hvalid & (max_mags != 0) & (new_f >= 0)
    f_h_safe = np.maximum(f_h, np.float32(1e-30))
    nf32 = new_f.astype(np.float32)
    nm32 = new_m.astype(np.float32)
    new_max_bin = (nf32 / f_h_safe
                   * max_bins.astype(np.float32)).astype(np.int64)
    shift = new_max_bin - max_bins
    nb = wb + shift[:, :, None]
    ok = sel & wh[:, :, None] & (nb >= 0) & (nb < b_cnt)
    m_scale = np.where(
        max_mags != 0,
        nm32 / np.maximum(max_mags, 1e-30).astype(np.float32),
        np.float32(0.0)).astype(np.float32)
    sm = wm * m_scale[:, :, None]
    smf = wf * (nf32 / f_h_safe)[:, :, None]
    # hann-bump paint where no harmonic energy existed; bounds through the
    # float32 frequency_to_bin, low = max(0, ceil), high = min(bins - 1,
    # floor) (PVInformation.cpp:403-414)
    wp = hvalid & (max_mags == 0) & (new_f >= 0)
    bw32 = np.float32(10.0)
    lo_f = nf32 - np.float32(5.0)
    hi_f = nf32 + np.float32(5.0)
    w2 = int(10.0 / bin_width) + 2
    pofs = np.arange(w2, dtype=np.int64)
    lo_bin = np.maximum(0, np.ceil(lo_f / bwd32).astype(np.int64))
    hi_bin = np.minimum(b_cnt - 1, np.floor(hi_f / bwd32).astype(np.int64))
    pb = lo_bin[:, :, None] + pofs[None, None, :]       # [M, H, W2]
    okp = wp[:, :, None] & (pb <= hi_bin[:, :, None])
    pos = (pb.astype(np.float32) * bwd32 - lo_f[:, :, None]) / bw32
    pval = nm32[:, :, None] * np.float32(0.5) * (
        np.float32(1.0) - np.cos(np.float32(2.0 * np.pi) * pos))
    fidx3p = np.broadcast_to(fr_idx[:, None, None], pb.shape)
    pbc = np.clip(pb, 0, b_cnt - 1)

    # writes harmonic by harmonic (each batched over entries and taps),
    # keeping the reference's in-frame order between max-combine copies
    # and unconditional paints of different harmonics
    # (PVInformation.cpp:332-368)
    for hh in range(h_max):
        sel_h = ok[:, hh, :]
        if sel_h.any():
            fi = fidx3[:, hh, :][sel_h]
            bi = nb[:, hh, :][sel_h]
            vals = sm[:, hh, :][sel_h].astype(np.float32)
            vfs = smf[:, hh, :][sel_h]
            # freq is written only on strict improvement (reference 'if out
            # < sm', PVInformation.cpp:350); among equal in-batch
            # candidates the first wins (reversed write order)
            prev = out_mag[channel][fi, bi].copy()
            np.maximum.at(out_mag[channel], (fi, bi), vals)
            winners = (vals > prev) & (out_mag[channel][fi, bi] == vals)
            wi = np.flatnonzero(winners)[::-1]
            out_freq[channel][fi[wi], bi[wi]] = vfs[wi]
        selp_h = okp[:, hh, :]
        if selp_h.any():
            fip = fidx3p[:, hh, :][selp_h]
            bip = pbc[:, hh, :][selp_h]
            out_mag[channel][fip, bip] = \
                pval[:, hh, :][selp_h].astype(np.float32)
            out_freq[channel][fip, bip] = np.broadcast_to(
                new_f[:, hh, None], pb[:, hh, :].shape)[selp_h].astype(
                    np.float32)
