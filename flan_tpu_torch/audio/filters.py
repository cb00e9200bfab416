"""Audio filter family: VA-design TPT filters, Butterworth cascades,
shelves, the constant-delay comb, the Hilbert network and frequency
shifting (counterpart of flan_tpu/audio/filters.py; reference:
src/flan/Audio/AudioFilter.cpp, after "VA Filter Design" 2nd ed.).

Every linear per-sample loop is a parallel scan (ops/scan.py through
ops/filter_cores.py); cascades run stage by stage, and the multinotch
filters' allpass cascade with its feedback is one k x k matrix scan. A
filter whose parameters are all constant runs, from 16384 frames on, as an
FFT convolution with its truncated impulse response (ops/fir.py). The two
loops that are not linear, the multinotch's tanh saturator and the comb
with a time-varying delay, run in time order (ops/sequential_kernels.py).
A parameter given as a tensor that requires grad takes the direct scan
path (func/function.py), so the filters are differentiable in it. Bound
onto Audio in flan_tpu_torch/audio/__init__.py.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops.filter_cores import (allpass_1pole_chain,
                                             butterworth_poles, comb_core,
                                             onepole_core,
                                             phase_diff_network_poles,
                                             svf_core)
from flan_tpu_torch.ops.fir import fir_apply, impulse_response
from flan_tpu_torch.ops.scan import affine_kxk_recurrence
from flan_tpu_torch.ops.sequential_kernels import (comb_swept, ipow,
                                                   saturator_multinotch)
from flan_tpu_torch.ops.stft import cpu_exact, true_div

# Constant-coefficient fast path: at or above this length, a filter whose
# parameters are all constants is applied as an FFT convolution of its
# truncated impulse response instead of a state scan (filters.py:27-31).
_FIR_MIN_FRAMES = 16384


def _null():
    from flan_tpu_torch.audio.audio import Audio
    return Audio.create_null()


def _is_constant(*params) -> bool:
    return all(p is None or as_function(p).is_constant for p in params)


def _const_val(p):
    """Constant value of a parameter already known to be constant."""
    return None if p is None else float(as_function(p).constant_value)


def _fir_fastpath(self, run_direct, cache_key=None):
    """FIR-truncation application of a constant-parameter linear filter.

    run_direct: Audio -> Audio, the filter's scan path. Returns the
    convolved Audio, or None when the impulse response does not decay
    within the signal length (then the scan path is no slower).
    """
    if self.num_frames < _FIR_MIN_FRAMES:
        return None
    h = impulse_response(
        lambda data: run_direct(self._with(data=data)).data,
        max_len=self.num_frames, device=self.device, cache_key=cache_key)
    if h is None:
        return None
    return self._with(data=fir_apply(self.data, h))


def _sample_over_frames(self, f, clamp_cutoff=False):
    """A parameter sampled at every frame: a float32 [N] tensor on the
    audio's device (filters.py:67-77)."""
    fn = as_function(f)
    n = self.num_frames
    if fn.is_constant:
        v = torch.full((n,), fn.constant_value, dtype=torch.float32,
                       device=self.device)
    else:
        v = torch.broadcast_to(torch.as_tensor(
            fn(self.time_grid()), dtype=torch.float32, device=self.device),
            (n,))
    if clamp_cutoff:
        v = torch.clamp(v, 1.0, self.sample_rate / 2.0)
    return v


def _g_of(self, w):
    """Prewarped normalized cutoff g = tan(T_half * w_hz) with the
    reference's T_half = pi / sr (AudioFilter.cpp:56-58)."""
    return torch.tan((math.pi / self.sample_rate) * w)


def _db_gain(gain, parts):
    """10^(gain / parts / 20) (filters.py:169, 228)."""
    return torch.pow(10.0, true_div(true_div(gain, parts), 20.0))


# ===========================================================================
# 1-pole Butterworth cascades (reference AudioFilter.cpp:326-418)
# ===========================================================================
def _butterworth_1pole(self, order, cutoff, lowpass: bool, _direct=False):
    if not _direct and _is_constant(cutoff):
        key = ("bw1", order, _const_val(cutoff), lowpass, self.sample_rate)
        out = _fir_fastpath(self, lambda a: _butterworth_1pole(
            a, order, cutoff, lowpass, _direct=True), cache_key=key)
        if out is not None:
            return out
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    g = _g_of(self, w)[None, :]
    y = self.data
    if order % 2 == 1:
        lp, hp = onepole_core(y, g)
        y = lp if lowpass else hp
    for p in butterworth_poles(order):
        R = torch.tensor(-p.real, dtype=torch.float32, device=self.device)
        lp, bp, hp = svf_core(y, g, R)
        y = lp if lowpass else hp
    return self._with(data=y)


def filter_1pole_lowpass(self, cutoff, order: int = 1):
    if self.is_null():
        return _null()
    if order == 0:
        return self.copy()
    return _butterworth_1pole(self, order, cutoff, True)


def filter_1pole_highpass(self, cutoff, order: int = 1):
    if self.is_null():
        return _null()
    if order == 0:
        return self.copy()
    return _butterworth_1pole(self, order, cutoff, False)


def filter_1pole_split(self, cutoff, order: int = 1):
    """Low/high band split (reference AudioFilter.cpp:392-424)."""
    if order <= 1:
        return [filter_1pole_lowpass(self, cutoff, 1),
                filter_1pole_highpass(self, cutoff, 1)]
    lo = filter_1pole_lowpass(
        filter_1pole_lowpass(self, cutoff, order), cutoff, order)
    hi = filter_1pole_highpass(
        filter_1pole_highpass(self, cutoff, order), cutoff, order)
    return [lo, hi]


def filter_1pole_repeat_low(self, cutoff, repeats: int):
    """(reference AudioFilter.cpp:280-323)"""
    y = self
    for _ in range(max(1, repeats)):
        y = filter_1pole_lowpass(y, cutoff, 1)
    return y


def filter_1pole_repeat_high(self, cutoff, repeats: int):
    y = self
    for _ in range(max(1, repeats)):
        y = filter_1pole_highpass(y, cutoff, 1)
    return y


# ===========================================================================
# 1-pole Butterworth shelving (reference AudioFilter.cpp:430-521)
# ===========================================================================
def _butterworth_1pole_tilt(self, order, cutoff, gain_db, _direct=False):
    if not _direct and _is_constant(cutoff, gain_db):
        key = ("bw1t", order, _const_val(cutoff), _const_val(gain_db),
               self.sample_rate)
        out = _fir_fastpath(self, lambda a: _butterworth_1pole_tilt(
            a, order, cutoff, gain_db, _direct=True), cache_key=key)
        if out is not None:
            return out
    w0 = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    gain = _sample_over_frames(self, gain_db)
    M = _db_gain(gain, 2 * order)
    M2 = M * M
    w = M * w0
    g = _g_of(self, w)[None, :]
    y = self.data
    if order % 2 == 1:
        lp, hp = onepole_core(y, g)
        y = lp * M[None, :] + hp / M[None, :]
    for p in butterworth_poles(order):
        # the reference uses R = p.real / w in the tilt variant
        # (AudioFilter.cpp:489); its sign quirk is kept
        R = (torch.tensor(p.real, dtype=torch.float32, device=self.device)
             / w)[None, :]
        lp, bp, hp = svf_core(y, g, R)
        y = lp / M2[None, :] + bp + hp * M2[None, :]
    return self._with(data=y)


def filter_1pole_lowshelf(self, cutoff, gain, order: int = 1):
    if self.is_null():
        return _null()
    gain_fn = as_function(gain)
    tilt = _butterworth_1pole_tilt(self, max(order, 1), cutoff, gain_fn)
    scale = _db_gain(_sample_over_frames(self, gain_fn), 2)
    return tilt._with(data=tilt.data * scale[None, :])


def _negated(fn):
    """-fn, a constant where fn is one (filters.py:202-203)."""
    if fn.is_constant:
        return -fn.constant_value
    return lambda t: -torch.as_tensor(fn(t))


def filter_1pole_highshelf(self, cutoff, gain, order: int = 1):
    if self.is_null():
        return _null()
    gain_fn = as_function(gain)
    tilt = _butterworth_1pole_tilt(self, max(order, 1), cutoff,
                                   _negated(gain_fn))
    scale = _db_gain(_sample_over_frames(self, gain_fn), 2)
    return tilt._with(data=tilt.data * scale[None, :])


# ===========================================================================
# 2-pole Butterworth cascades (reference AudioFilter.cpp:527-624)
# ===========================================================================
def _butterworth_2pole(self, order, cutoff, damping, sel: int,
                       tilt_gain=None, tilt_mode=None, _direct=False):
    if not _direct and _is_constant(cutoff, damping, tilt_gain):
        key = ("bw2", order, _const_val(cutoff), _const_val(damping), sel,
               _const_val(tilt_gain), tilt_mode, self.sample_rate)
        out = _fir_fastpath(self, lambda a: _butterworth_2pole(
            a, order, cutoff, damping, sel, tilt_gain, tilt_mode,
            _direct=True), cache_key=key)
        if out is not None:
            return out
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    R = _sample_over_frames(self, damping)

    if tilt_gain is not None:
        M = _db_gain(_sample_over_frames(self, tilt_gain), 2 * order)
        M2 = M * M
        if tilt_mode in ("low", "high"):
            w = w * M
        elif tilt_mode == "band":
            R = R * M

    alpha = true_div(torch.arccos(torch.clamp(R, -1.0, 1.0)), order)
    # pole splitter: R > 1 -> real scaling, else complex rotation, in
    # real/imaginary components as the JAX package computes it
    scaler_real = torch.pow(
        R + cpu_exact(torch.sqrt, torch.clamp(R * R - 1.0, min=0.0)),
        1.0 / order)
    over = R > 1.0
    sc_re = torch.where(over, scaler_real, torch.cos(alpha))
    sc_im = torch.where(over, 0.0, -torch.sin(alpha))
    sc_mag2 = sc_re * sc_re + sc_im * sc_im

    def stage_out(lp, bp, hp):
        if tilt_gain is None:
            return [lp, bp, hp][sel]
        if tilt_mode == "low":
            return lp / (M2 * M2)[None, :] + bp / M2[None, :] + hp
        if tilt_mode == "band":
            return lp + bp / M2[None, :] + hp
        return lp + bp * M2[None, :] + hp * (M2 * M2)[None, :]

    y = self.data
    if order % 2 == 1:
        lp, bp, hp = svf_core(y, _g_of(self, w)[None, :],
                              torch.cos(alpha)[None, :])
        y = stage_out(lp, bp, hp)
    for p in butterworth_poles(order):
        pw_re = p.real * w
        pw_im = p.imag * w
        # pole * scaler and pole / scaler (conjugate over |scaler|^2)
        mul = (pw_re * sc_re - pw_im * sc_im,
               pw_re * sc_im + pw_im * sc_re)
        div = ((pw_re * sc_re + pw_im * sc_im) / sc_mag2,
               (pw_im * sc_re - pw_re * sc_im) / sc_mag2)
        for re, im in (mul, div):
            mag = cpu_exact(torch.sqrt, re * re + im * im)
            pr = -re / torch.clamp(mag, min=1e-9)
            lp, bp, hp = svf_core(y, _g_of(self, mag)[None, :],
                                  pr[None, :])
            y = stage_out(lp, bp, hp)
    return self._with(data=y)


def filter_2pole_lowpass(self, cutoff, damping, order: int = 1):
    if self.is_null():
        return _null()
    if order == 0:
        return self.copy()
    return _butterworth_2pole(self, order, cutoff, damping, 0)


def filter_2pole_bandpass(self, cutoff, damping, order: int = 1):
    if self.is_null():
        return _null()
    if order == 0:
        return self.copy()
    return _butterworth_2pole(self, order, cutoff, damping, 1)


def filter_2pole_highpass(self, cutoff, damping, order: int = 1):
    if self.is_null():
        return _null()
    if order == 0:
        return self.copy()
    return _butterworth_2pole(self, order, cutoff, damping, 2)


def filter_2pole_notch(self, cutoff, damping, order: int = 1):
    """input - bandpass (reference AudioFilter.cpp:614-624)."""
    if self.is_null():
        return _null()
    bp = filter_2pole_bandpass(self, cutoff, damping, order)
    return self._with(data=self.data - bp.data)


def filter_2pole_split(self, cutoff, damping, order: int = 1):
    return [filter_2pole_lowpass(self, cutoff, damping, order),
            filter_2pole_highpass(self, cutoff, damping, order)]


def _halved(fn):
    """fn / 2, a constant where fn is one (filters.py:325-326)."""
    if fn.is_constant:
        return fn.constant_value / 2.0
    return lambda t: true_div(torch.as_tensor(fn(t)), 2.0)


def filter_2pole_lowshelf(self, cutoff, damping, gain, order: int = 1):
    if self.is_null():
        return _null()
    return _butterworth_2pole(self, max(order, 1), cutoff, damping, 0,
                              tilt_gain=_halved(as_function(gain)),
                              tilt_mode="low")


def filter_2pole_bandshelf(self, cutoff, damping, gain, order: int = 1):
    if self.is_null():
        return _null()
    return _butterworth_2pole(self, max(order, 1), cutoff, damping, 0,
                              tilt_gain=_negated(as_function(gain)),
                              tilt_mode="band")


def filter_2pole_highshelf(self, cutoff, damping, gain, order: int = 1):
    if self.is_null():
        return _null()
    return _butterworth_2pole(self, max(order, 1), cutoff, damping, 0,
                              tilt_gain=_halved(as_function(gain)),
                              tilt_mode="high")


# ===========================================================================
# Multinotch (allpass phaser with feedback; reference
# AudioFilter.cpp:802-985). The no-saturator path is a linear time-varying
# state space over the allpass states, solved with one k x k matrix scan;
# its coefficient rows come from propagating affine forms through the
# cascade (filters.py:389-418, 466-509). Forms are kept as [k, N] planes
# (state component first), so the stacked A is [k, k, N], the layout the
# scan takes, and is one map for every channel.
# ===========================================================================
def _multinotch_out(self, A, b_x, cx, s_coeff, u_cx, u_cs, mix, inv):
    """The cascade's states from the scan, then x_bar and the wet/dry mix
    (filters.py:420-428): x [C, N], the forms [k, N] or [N]."""
    x = self.data
    s = affine_kxk_recurrence(A, b_x[None] * x[:, None, :])   # [C, k, N]
    s_prev = torch.nn.functional.pad(s[..., :-1], (1, 0))
    x_bar = cx * x + torch.sum(s_coeff * s_prev, dim=-2)
    y_bar = u_cx * x + torch.sum(u_cs * s_prev, dim=-2)
    return self._with(data=mix * x_bar + (1.0 - mix) * y_bar * inv)


def filter_1pole_multinotch(self, order, cutoff, feedback=0.0,
                            invert: bool = False, wet_dry=0.5,
                            use_saturator: bool = False, _direct=False):
    """Phaser: a cascade of `order` 1-pole allpasses with feedback
    (filters.py:360-431); k = order states."""
    if self.is_null():
        return _null()
    if (not _direct and not use_saturator
            and _is_constant(cutoff, feedback, wet_dry)):
        key = ("mn1", order, _const_val(cutoff), _const_val(feedback),
               invert, _const_val(wet_dry), self.sample_rate)
        out = _fir_fastpath(self, lambda a: filter_1pole_multinotch(
            a, order, cutoff, feedback, invert, wet_dry, _direct=True),
            cache_key=key)
        if out is not None:
            return out
    order = max(1, int(order))
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    k = _sample_over_frames(self, feedback)
    mix = _sample_over_frames(self, wet_dry)
    inv = -1.0 if invert else 1.0

    g = _g_of(self, w)
    G_f = g / (1.0 + g)                      # TPT filter G
    G_ap = (g - 1.0) / (g + 1.0)             # allpass gain
    if use_saturator:
        return self._with(data=saturator_multinotch(
            self.data, (g, G_f, G_ap, k, mix), inv, order, two_pole=False))

    # the affine form of x_bar over [x, s_0 .. s_{order-1}]
    denom = 1.0 - inv * k * ipow(G_ap, order)
    cx = 1.0 / denom
    mem_scale = inv * k * (2.0 / (1.0 + g)) * cx
    s_coeff = torch.stack([mem_scale * ipow(G_ap, order - 1 - i)
                           for i in range(order)])           # [k, N]
    eye = torch.eye(order, dtype=torch.float32, device=self.device)
    u_cx, u_cs = cx, s_coeff
    A = g.new_empty((order, order, g.shape[0]))
    b_x = g.new_empty((order, g.shape[0]))
    for j in range(order):
        e_j = eye[:, j:j + 1]
        # s_j' = 2 G_f u_j + (1 - 2 G_f) s_j
        A[j] = 2.0 * G_f * u_cs + (1.0 - 2.0 * G_f) * e_j
        b_x[j] = 2.0 * G_f * u_cx
        # y_j = (2 G_f - 1) u_j + 2 (1 - G_f) s_j -> u_{j+1}
        u_cs = (2.0 * G_f - 1.0) * u_cs + (2.0 * (1.0 - G_f)) * e_j
        u_cx = (2.0 * G_f - 1.0) * u_cx
    return _multinotch_out(self, A, b_x, cx, s_coeff, u_cx, u_cs, mix, inv)


def filter_2pole_multinotch(self, order, cutoff, damping, feedback=0.0,
                            invert: bool = False, wet_dry=0.5,
                            use_saturator: bool = False, _direct=False):
    """Phaser: a cascade of `order` 2-pole SVF allpasses with feedback
    (filters.py:434-521); k = 2 order states, (s1, s2) per stage."""
    if self.is_null():
        return _null()
    if (not _direct and not use_saturator
            and _is_constant(cutoff, damping, feedback, wet_dry)):
        key = ("mn2", order, _const_val(cutoff), _const_val(damping),
               _const_val(feedback), invert, _const_val(wet_dry),
               self.sample_rate)
        out = _fir_fastpath(self, lambda a: filter_2pole_multinotch(
            a, order, cutoff, damping, feedback, invert, wet_dry,
            _direct=True), cache_key=key)
        if out is not None:
            return out
    order = max(1, int(order))
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    k = _sample_over_frames(self, feedback)
    R = _sample_over_frames(self, damping)
    mix = _sample_over_frames(self, wet_dry)
    inv = -1.0 if invert else 1.0

    g = _g_of(self, w)
    d = 1.0 / (1.0 + 2.0 * R * g + g * g)
    G = d * (1.0 - 2.0 * R * g + g * g)      # allpass gain
    if use_saturator:
        return self._with(data=saturator_multinotch(
            self.data, (g, G, k, mix, R, d), inv, order, two_pole=True))

    nstates = 2 * order
    cx = 1.0 / (1.0 - inv * k * ipow(G, order))
    # memory_sum = sum_i G^i (g s2_{N-1-i} - s1_{N-1-i});
    # x_bar = (x + inv k 4 R d msum) / denom
    mcoef = inv * k * 4.0 * R * d * cx
    s_rows = [None] * nstates
    for i in range(order):
        j = order - 1 - i
        s_rows[2 * j] = -mcoef * ipow(G, i)
        s_rows[2 * j + 1] = mcoef * g * ipow(G, i)
    s_coeff = torch.stack(s_rows)                              # [k, N]

    g1 = 2.0 * R + g
    eye = torch.eye(nstates, dtype=torch.float32, device=self.device)
    u_cx, u_cs = cx, s_coeff
    A = g.new_empty((nstates, nstates, g.shape[0]))
    b_x = g.new_empty((nstates, g.shape[0]))
    for j in range(order):
        e1, e2 = eye[:, 2 * j:2 * j + 1], eye[:, 2 * j + 1:2 * j + 2]
        # hp = d u - d g1 s1 - d s2
        hp_cs = d * u_cs - (d * g1) * e1 - d * e2
        hp_cx = d * u_cx
        # bp = g hp + s1
        bp_cs = g * hp_cs + e1
        bp_cx = g * hp_cx
        # lp = g bp + s2
        lp_cs = g * bp_cs + e2
        lp_cx = g * bp_cx
        # s1' = s1 + 2 g hp ; s2' = s2 + 2 g bp
        A[2 * j] = e1 * torch.ones_like(g) + 2.0 * g * hp_cs
        b_x[2 * j] = 2.0 * g * hp_cx
        A[2 * j + 1] = e2 * torch.ones_like(g) + 2.0 * g * bp_cs
        b_x[2 * j + 1] = 2.0 * g * bp_cx
        # allpass out: lp - 2R bp + hp
        u_cs = lp_cs - (2.0 * R) * bp_cs + hp_cs
        u_cx = lp_cx - 2.0 * R * bp_cx + hp_cx
    return _multinotch_out(self, A, b_x, cx, s_coeff, u_cx, u_cs, mix, inv)


# ===========================================================================
# Comb (reference AudioFilter.cpp:988-1045)
# ===========================================================================
def filter_comb(self, cutoff, feedback=0.0, wet_dry=0.5,
                invert: bool = False):
    """Feedback comb at delay 1 / (2 cutoff): a constant cutoff runs as
    lag-t scans (ops/filter_cores.py comb_core), a swept one in time order
    with the delay taken per sample, d[n] = clip(int(sr / (2 w[n])), 1, N)
    (filters.py:622-644)."""
    if self.is_null():
        return _null()
    cut_fn = as_function(cutoff)
    k = _sample_over_frames(self, feedback)
    a = _sample_over_frames(self, wet_dry)
    if cut_fn.is_constant:
        w = float(np.clip(cut_fn.constant_value, 1.0, self.sample_rate / 2.0))
        delay = self.time_to_frame(1.0 / (2.0 * w))
        return self._with(data=comb_core(self.data, delay, k, invert, a))
    w = _sample_over_frames(self, cut_fn, clamp_cutoff=True)
    sr = torch.full((), self.sample_rate, dtype=torch.float32,
                    device=self.device)
    delays = torch.clamp((sr / (2.0 * w)).to(torch.int32), 1,
                         self.num_frames)
    return self._with(data=comb_swept(self.data, delays, k, a,
                                      -1.0 if invert else 1.0))


# ===========================================================================
# Hilbert network / frequency shift (reference AudioFilter.cpp:1047-1262)
# ===========================================================================
def _hilbert_pair(self):
    """Approximate analytic signal via two 1-pole allpass cascades
    (90-degree phase differencing network; AudioFilter.cpp:1162-1171).
    The reference's multi-allpass path skips prewarping: g = w * T_half
    with T_half = pi / sr, fed the design's rad/s poles directly
    (AudioFilter.cpp:1066), kept for parity."""
    poles_a, poles_b = phase_diff_network_poles(20, 5.0, 22000.0)
    T_half = math.pi / self.sample_rate
    gs_a = [p * T_half for p in poles_a]
    gs_b = [p * T_half for p in poles_b]
    if self.num_frames >= _FIR_MIN_FRAMES:
        # the 2 x 10-pole allpass cascades have fixed coefficients, so both
        # run as truncated-FIR convolutions (see _fir_fastpath)
        hs = [impulse_response(lambda d, gs=gs: allpass_1pole_chain(d, gs),
                               max_len=self.num_frames, device=self.device,
                               cache_key=("hilbert", side, self.sample_rate))
              for side, gs in enumerate((gs_a, gs_b))]
        if all(h is not None for h in hs):
            return fir_apply(self.data, hs[0]), fir_apply(self.data, hs[1])
    return (allpass_1pole_chain(self.data, gs_a),
            allpass_1pole_chain(self.data, gs_b))


def _modulator_parts(m, n: int, device):
    """(re, im) [N] float32 of a modulator's value: a (re, im) tuple, a
    complex tensor or a real one (filters.py:688-700)."""
    def row(v):
        return torch.broadcast_to(torch.as_tensor(v, device=device).to(
            torch.float32), (n,))
    if isinstance(m, tuple):
        return row(m[0]), row(m[1])
    m = torch.as_tensor(m, device=device)
    if m.is_complex():
        return row(m.real), row(m.imag)
    return row(m), torch.zeros(n, dtype=torch.float32, device=device)


def halfband_modulate(self, modulator):
    """Multiply the analytic signal by a complex modulator (reference
    AudioFilter.cpp:1173-1197). The modulator is a constant or a callable
    of time returning a complex tensor, a real one or a (re, im) tuple."""
    if self.is_null():
        return _null()
    re, im = _hilbert_pair(self)
    fn = modulator if callable(modulator) else as_function(modulator)
    m_re, m_im = _modulator_parts(fn(self.time_grid()), self.num_frames,
                                  self.device)
    return self._with(data=re * m_re[None, :] - im * m_im[None, :])


def _frame_lookup(values: torch.Tensor, sample_rate: float, n: int):
    """A Function of time reading values[clip(int(t * sr), 0, n - 1)], as
    the JAX package's lambdas do (filters.py:727-743)."""
    def at(t):
        return values[torch.clamp((t * sample_rate).to(torch.int32), 0,
                                  n - 1).long()]
    return at


def shift_frequency(self, shift, low_cutoff: float = 30.0):
    """Single-sideband frequency shift via the Hilbert network (reference
    AudioFilter.cpp:1199-1238)."""
    if self.is_null():
        return _null()
    sr, n = self.sample_rate, self.num_frames
    high_cutoff = sr / 2.0 - 1000.0
    shift_fn = as_function(shift)
    s = _sample_over_frames(self, shift_fn)

    if shift_fn.is_constant:
        # constant shift -> constant antialias cutoffs, which lets the
        # 8-pole cascades take the FIR-convolution fast path
        sc = float(shift_fn.constant_value)
        lp_c = high_cutoff - sc if sc > 0 else high_cutoff
        hp_c = low_cutoff - sc if sc < 0 else low_cutoff
        antialiased = filter_1pole_highpass(
            filter_1pole_lowpass(self, lp_c, 8), hp_c, 8)
    else:
        lp_cut = torch.where(s > 0, high_cutoff - s, high_cutoff)
        hp_cut = torch.where(s < 0, low_cutoff - s, low_cutoff)
        antialiased = filter_1pole_highpass(
            filter_1pole_lowpass(self, _frame_lookup(lp_cut, sr, n), 8),
            _frame_lookup(hp_cut, sr, n), 8)

    # exclusive mod-1 cycle accumulation; the prefix sums run in float64
    # on every device (the JAX package's is float32)
    cycles = torch.remainder(true_div(s, sr), 1.0)
    acc = torch.nn.functional.pad(
        torch.cumsum(cycles.double(), 0)[:-1], (1, 0))
    phase = (torch.remainder(acc, 1.0) * (2.0 * math.pi)).to(torch.float32)
    at = _frame_lookup(phase, sr, n)
    return halfband_modulate(antialiased,
                             lambda t: (torch.cos(at(t)), torch.sin(at(t))))


def halfband_multiply(self, modulator):
    """Analytic-signal product of two audios (reference
    AudioFilter.cpp:1240-1262)."""
    if self.is_null() or modulator.is_null():
        return _null()

    def bandpass(a):
        return filter_1pole_highpass(
            filter_1pole_lowpass(a, a.sample_rate / 2 - 2000.0, 8),
            30.0, 8)

    a_re, a_im = _hilbert_pair(bandpass(self))
    b_re, b_im = _hilbert_pair(bandpass(modulator))
    c = min(self.num_channels, modulator.num_channels)
    n = min(self.num_frames, modulator.num_frames)
    return self._with(data=a_re[:c, :n] * b_re[:c, :n]
                      - a_im[:c, :n] * b_im[:c, :n])
