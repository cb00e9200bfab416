"""Audio synthesis and the granular engine (counterpart of
flan_tpu/audio/synthesis.py; reference: src/flan/Audio/AudioSynthesis.cpp).

The static synthesizers take device=None, the card unless named; the
methods follow their Audio's device. Three hand-written kernels carry the
work XLA compiled for the JAX package:
- the noise and synthesize_spectrum's phases draw JAX's own threefry bits
  (ops/random.py, K1), so one seed gives the JAX package's draws;
- synthesize_waveform's and synthesize_pulsars' phase is the exclusive
  mod-1 cycle scan in fixed point (ops/cycle_scan.py, K2);
- granulate, psola and texture's modded grains land by the granular
  overlap-add in grain order (ops/grain_mix.py, K3).
Event times integrate on the host in numpy from explicit seeds, as the
JAX package integrates them (integrate_event_rate). Bound onto Audio in
flan_tpu_torch/audio/__init__.py.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import as_function, broadcast_f32
from flan_tpu_torch.ops import random
from flan_tpu_torch.ops.cycle_scan import constant_increment, cycle_scan
from flan_tpu_torch.ops.fft_conv import fft_convolve_full
from flan_tpu_torch.ops.grain_mix import (BLOCK, grain_blocks,
                                          grain_overlap_add, grain_plan)
from flan_tpu_torch.ops.stft import true_div
from flan_tpu_torch.ops.windows import hann


def _null():
    from flan_tpu_torch.audio.audio import Audio
    return Audio.create_null()


def _audio(data: torch.Tensor, sample_rate: float):
    from flan_tpu_torch.audio.audio import Audio
    return Audio(data=data, sample_rate=float(sample_rate))


def _device(device) -> torch.device:
    return torch.device(DEFAULT_DEVICE if device is None else device)


def _scalar(fn, t: float) -> float:
    """A Function at one time (its float32), on the host, as the JAX
    package's scalar(fn, t) evaluates fn(jnp.float32(t))."""
    if fn.is_constant:
        return fn.constant_value
    v = fn(torch.tensor(t, dtype=torch.float32))
    return float(torch.as_tensor(v).reshape(()))


def _host_eval(fn, t: np.ndarray) -> np.ndarray:
    """A Function on a float32 host grid, as float64 [len(t)] (a callable
    may answer on another device: the values come back)."""
    out = fn(torch.from_numpy(np.ascontiguousarray(t, np.float32)))
    vals = torch.as_tensor(out, dtype=torch.float32).cpu().double()
    return np.broadcast_to(vals.reshape(-1).numpy(), t.shape)


def _sample_fn(fn, count: int, period: float) -> np.ndarray:
    """flan_tpu/audio/synthesis.py:26-32 on the host: a constant filled in
    float64, a callable on the float32 grid arange(count) * period."""
    f = as_function(fn)
    if f.is_constant:
        return np.full(count, f.constant_value, np.float64)
    grid = (float_iota(count) * period).numpy()
    return np.array(_host_eval(f, grid))


def synthesize_waveform(waveform, length: float, freq,
                        sample_rate: float = 48000.0, oversample: int = 16,
                        *, device=None):
    """Waveform synthesis: the phase is the exclusive mod-1 scan of the
    frequency at the oversampled rate (K2), the waveform is evaluated on
    it, then downsampled (reference AudioSynthesis.cpp:25-69). A constant
    frequency's increment is divided in float64 and rounded once, a swept
    one's in float32, as flan_tpu/audio/synthesis.py:48-55."""
    if oversample < 1 or length <= 0 or sample_rate <= 0:
        return _null()
    dev = _device(device)
    out_frames = int(length * sample_rate)
    in_rate = sample_rate * oversample
    n_in = out_frames * oversample
    f = as_function(freq)
    if f.is_constant:
        phases = cycle_scan(None, constant_increment(f.constant_value,
                                                     in_rate),
                            in_rate, n_in, dev)
    else:
        t = true_div(float_iota(n_in, device=dev), in_rate)
        phases = cycle_scan(broadcast_f32(f(t), (n_in,), dev).contiguous(),
                            None, in_rate, n_in)
        del t
    samples = broadcast_f32(as_function(waveform)(phases), (n_in,), dev)
    return _audio(samples[None, :], in_rate).resample(sample_rate)


def synthesize_white_noise(length: float, sample_rate: float = 48000.0,
                           oversample: int = 16, *, seed: int = 0,
                           device=None):
    """Uniform noise in [-1, 1) at the oversampled rate, JAX's draws of
    PRNGKey(seed) (K1), downsampled (reference AudioSynthesis.cpp:71-89)."""
    if oversample < 1 or length <= 0 or sample_rate <= 0:
        return _null()
    n = int(length * sample_rate * oversample)
    data = random.uniform(random.key(seed), n, -1.0, 1.0, _device(device))
    return _audio(data[None, :], sample_rate * oversample
                  ).resample(sample_rate)


def synthesize_pink_noise(length: float, sample_rate: float = 48000.0,
                          num_rows: int = 128, *, seed: int = 0,
                          device=None):
    """Voss-McCartney pink noise, normalised to a peak of 1 (reference
    AudioSynthesis.cpp:91-149): row r holds a draw for 2^(r + 1) frames
    (the draws repeated), log2(num_rows) rows and a white row added in
    order, the keys split as flan_tpu/audio/synthesis.py:92-103 splits
    them."""
    if length <= 0 or sample_rate <= 0 or num_rows < 1:
        return _null()
    dev = _device(device)
    n = int(length * sample_rate)
    k = random.key(seed)
    nbits = max(1, int(math.log2(max(num_rows, 2))))
    total = torch.zeros(n, dtype=torch.float32, device=dev)
    for r in range(nbits):
        stride = 1 << (r + 1)
        k, sub = random.split(k, 2, dev)
        vals = random.uniform(sub, n // stride + 2, -1.0, 1.0, dev)
        total = total + torch.repeat_interleave(vals, stride)[:n]
    k, sub = random.split(k, 2, dev)
    total = total + random.uniform(sub, n, -1.0, 1.0, dev)
    return _audio(total[None, :], sample_rate).set_volume(1.0)


def spectrum_table(fundamental_power: int = 8, spectrum_size_power: int = 20,
                   spread=None, harmonic_scale=None, peak_distribution=None,
                   *, seed: int = 0, sample_rate: float = 48000.0,
                   device=None):
    """synthesize_spectrum's wavetable: (table [2^spectrum_size_power],
    theta [nbins]) with theta JAX's uniform phases in [0, 2 pi) of
    PRNGKey(seed) (K1) and the table the irfft (cuFFT on the card) of the
    harmonic magnitudes at those phases, times its length
    (flan_tpu/audio/synthesis.py:123-159)."""
    dev = _device(device)
    fundamental = float(2 ** fundamental_power)
    wavelength = 2 ** spectrum_size_power
    nbins = wavelength // 2 + 1
    spread_fn = as_function(spread if spread is not None else (lambda h: h))
    scale_fn = as_function(harmonic_scale if harmonic_scale is not None
                           else (lambda h: 1.0 / torch.sqrt(h)))
    dist_fn = as_function(
        peak_distribution if peak_distribution is not None
        else (lambda x: torch.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)))

    bin_freqs = float_iota(nbins, device=dev) * (sample_rate / nbins)
    harmonic = torch.round(true_div(bin_freqs, fundamental)).to(torch.int64)
    num_harmonics = int(math.ceil(sample_rate / fundamental)) + 2
    h_idx = float_iota(1, num_harmonics + 1, device=dev)
    spread_s = broadcast_f32(spread_fn(h_idx), h_idx.shape, dev)
    scale_s = broadcast_f32(scale_fn(h_idx), h_idx.shape, dev)
    h_clamped = torch.clamp(harmonic, 1, num_harmonics) - 1
    sd = spread_s[h_clamped]
    sc = scale_s[h_clamped]
    mean = harmonic.to(torch.float32) * fundamental
    sd_safe = torch.clamp(sd, min=1e-9)
    peak = broadcast_f32(dist_fn((bin_freqs - mean) / sd_safe), sd.shape,
                         dev) / sd_safe
    r = torch.where(sd > 1e-3, peak, bin_freqs) * sc
    r = torch.where(harmonic == 0, 0.0, r)
    theta = random.uniform(random.key(seed), nbins, 0.0, 2.0 * math.pi, dev)
    spectrum = torch.complex(r * torch.cos(theta), r * torch.sin(theta))
    table = torch.fft.irfft(spectrum, n=wavelength) * wavelength
    return table, theta


def synthesize_spectrum(length: float, freq, spread=None,
                        harmonic_scale=None, peak_distribution=None,
                        fundamental_power: int = 8,
                        spectrum_size_power: int = 20,
                        num_channels: int = 2, granularity: float = 0.001,
                        *, seed: int = 0, sample_rate: float = 48000.0,
                        device=None):
    """A giant-IFFT wavetable of per-harmonic spectral peaks, played back at
    a variable rate (reference AudioSynthesis.cpp:151-268): read positions
    planned on the host in float64 per granularity block, each channel
    offset by channel / num_channels of the table, then a linear read."""
    if (length <= 0 or fundamental_power <= 0 or spectrum_size_power <= 0
            or fundamental_power > spectrum_size_power or granularity <= 0
            or spectrum_size_power >= 32):
        return _null()
    dev = _device(device)
    table, _ = spectrum_table(fundamental_power, spectrum_size_power, spread,
                              harmonic_scale, peak_distribution, seed=seed,
                              sample_rate=sample_rate, device=dev)
    fundamental = float(2 ** fundamental_power)
    wavelength = 2 ** spectrum_size_power

    out_frames = int(length * sample_rate)
    freq_fn = as_function(freq)
    gran = max(1, int(granularity * sample_rate))
    nblocks = -(-out_frames // gran)
    tgrid = np.arange(nblocks, dtype=np.float64) * gran / sample_rate
    if freq_fn.is_constant:
        f_blocks = np.full(nblocks, freq_fn.constant_value, np.float64)
    else:
        f_blocks = np.array(_host_eval(freq_fn, tgrid.astype(np.float32)))
    rate = f_blocks / fundamental
    starts = np.concatenate([[0.0], np.cumsum(rate * gran)])[:-1]
    local = np.arange(gran, dtype=np.float64)
    pos = (starts[:, None] + local[None, :] * rate[:, None]).reshape(-1)
    pos = pos[:out_frames]

    rows = []
    for channel in range(num_channels):
        jump = (channel / num_channels) * wavelength
        p = torch.from_numpy((pos + jump).astype(np.float32)).to(dev)
        p = torch.remainder(p, float(wavelength))
        base = torch.floor(p).to(torch.int64)
        frac = p - base
        lo = table[base]
        hi = table[torch.remainder(base + 1, wavelength)]
        rows.append(lo * (1 - frac) + hi * frac)
    return _audio(torch.stack(rows), sample_rate).set_volume(1.0)


def synthesize_impulse(base_freq: float, num_harmonics: int = 2 ** 14,
                       chroma: float = 1.0, sample_rate: float = 48000.0,
                       *, device=None):
    """A symmetric harmonic cosine-sum impulse (reference
    AudioSynthesis.cpp:270-303): the [harmonics, frames] cosine plane
    weighted by the harmonic powers and summed over harmonics."""
    dev = _device(device)
    num_frames = int(sample_rate / base_freq)
    if num_frames % 2 == 0:
        num_frames += 1
    half = (num_frames - 1) // 2
    max_h = min(int(num_harmonics), int(sample_rate / 2 / base_freq) + 1)
    max_h = max(max_h, 1)
    h = float_iota(1, max_h + 1, device=dev)
    if chroma == 1.0:
        norm = 1.0 / num_harmonics if num_harmonics < 2 ** 14 else 1.0 / max_h
        powers = torch.full((max_h,), norm, dtype=torch.float32, device=dev)
    else:
        norm = (1.0 - chroma) / (chroma - chroma ** (num_harmonics + 1)) \
            if num_harmonics < 60 else (1.0 - chroma) / chroma
        powers = norm * torch.pow(torch.tensor(chroma, dtype=torch.float32,
                                               device=dev), h)
    t = true_div(float_iota(num_frames - half, device=dev), sample_rate)
    waves = torch.cos(h[:, None] * (2.0 * math.pi * base_freq) * t[None, :])
    right = torch.sum(powers[:, None] * waves, dim=0)
    left = right[1:half + 1].flip(0)
    return _audio(torch.cat([left, right])[None, :], sample_rate)


# ===========================================================================
# Granular engine (reference AudioSynthesis.cpp:305-640)
# ===========================================================================
def integrate_event_rate(length: float, events_per_second, scatter,
                         sample_rate: float, *, seed: int = 0) -> np.ndarray:
    """Density -> event times (seconds): the rate integrated, an event at
    each integer crossing, then scattered by normal draws of
    np.random.default_rng(seed) (reference AudioSynthesis.cpp:310-374).
    Host numpy, copied from flan_tpu/audio/synthesis.py:221-275."""
    n = int(length * sample_rate)
    if n <= 0:
        return np.zeros((0,))
    eps_f = as_function(events_per_second)
    sc_f = as_function(scatter)

    if eps_f.is_constant and sc_f.is_constant:
        # analytic integer crossings of acc[k] = 1 + c (k + 1): O(events)
        c = max(float(eps_f.constant_value), 0.0) / sample_rate
        if c <= 0.0:
            events = np.array([0], np.int64)
        else:
            m_max = int(np.floor(1.0 + c * n))
            m = np.arange(2, m_max + 1, dtype=np.float64)
            ks = np.ceil((m - 1.0) / c - 1.0).astype(np.int64)
            ks = ks[(ks >= 0) & (ks < n)]
            events = np.unique(np.concatenate([[0], ks]))
        eps = np.broadcast_to(
            np.float64(max(float(eps_f.constant_value), 0.0)), (n,))
        sc = np.broadcast_to(
            np.float64(max(float(sc_f.constant_value), 0.0)), (n,))
    else:
        eps = np.maximum(_sample_fn(events_per_second, n,
                                    1.0 / sample_rate), 0.0)
        sc = np.maximum(_sample_fn(scatter, n, 1.0 / sample_rate), 0.0)
        # the accumulator starts at 1, so frame 0 always fires
        acc = 1.0 + np.cumsum(eps / sample_rate)
        crossings = np.floor(acc)
        events = np.nonzero(
            np.diff(np.concatenate([[0.0], crossings])) >= 1.0)[0]

    rng = np.random.default_rng(seed)
    if len(events):
        sc_e = sc[events]
        eps_e = eps[events]
        do = (sc_e > 0) & (eps_e > 0)
        std_frames = np.where(do, sc_e / np.maximum(eps_e, 1e-12)
                              * sample_rate, 0.0)
        scattered = np.where(
            do, rng.normal(events.astype(np.float64), std_frames), events)
        keep = (scattered >= 0) & (scattered < n)
        events = np.sort(scattered[keep])
    return events / sample_rate


def synthesize_grains(length: float, grains_per_second, time_scatter,
                      grain_source: Callable, sample_rate: float = 48000.0,
                      *, seed: int = 0):
    """grain_source(t) mixed at each event time (reference
    AudioSynthesis.cpp:376-398); null grains are dropped and the rest take
    the first event times in order, as the JAX package pairs them."""
    from flan_tpu_torch.audio.combination import mix
    if length <= 0:
        return _null()
    times = integrate_event_rate(length, grains_per_second, time_scatter,
                                 sample_rate, seed=seed)
    grains = [grain_source(float(t)) for t in times]
    grains = [g for g in grains if not g.is_null()]
    if not grains:
        return _null()
    return mix(grains, start_times=list(times[:len(grains)]))


def _mix_repeated(audio, times: np.ndarray, gains=None):
    """Copies of one clip summed at event times: one FFT convolution with an
    impulse train (flan_tpu/audio/synthesis.py:295-322). The train is built
    on the host's event list: gains landing on one frame are added there
    first, in event order and in float32 (the order of XLA's scatter on the
    CPU), so the card writes each frame once."""
    sr = audio.sample_rate
    dev = audio.device
    frames = np.asarray(np.round(np.asarray(times) * sr), np.int64)
    out_frames = int(frames.max()) + audio.num_frames
    g = (np.ones(len(frames), np.float32) if gains is None
         else np.asarray(gains, np.float32))
    uniq, inv = np.unique(frames, return_inverse=True)
    vals = np.zeros(len(uniq), np.float32)
    np.add.at(vals, inv, g)
    train = torch.zeros(out_frames, dtype=torch.float32, device=dev)
    train[torch.from_numpy(uniq).to(dev)] = torch.from_numpy(vals).to(dev)
    train = train[None, :].expand(audio.num_channels, out_frames)
    out = fft_convolve_full(train, audio.data)[:, :out_frames]
    return _audio(out.contiguous(), sr)


def _grain_meta(s0, lens, sf, ef, starts_out) -> torch.Tensor:
    """The per-grain rows K3 reads, int32 [6, G]: s0, lens, sf, ef, and the
    output start split into its offset in a block and its block."""
    starts_out = np.asarray(starts_out, np.int64)
    return torch.from_numpy(np.stack(
        [s0, lens, sf, ef, starts_out % BLOCK,
         starts_out // BLOCK]).astype(np.int32))


def _texture_mod_grains(self, times: np.ndarray, mod):
    """Independent modded grains (flan_tpu/audio/synthesis.py:361-421):
    mod(self, t) rendered for every event on the audio's device, stacked
    [G, C, g_n] and added into the output by K3 in grain order, the order
    in which the JAX package's chunked scatter adds them."""
    sr = self.sample_rate
    grains = [mod(self, float(np.float32(t))).data for t in times]
    shape = grains[0].shape
    if any(g.shape != shape for g in grains):
        raise ValueError("texture: a mod without feedback must give grains "
                         "of one shape for every time")
    stack = torch.stack(grains).to(torch.float32)
    g_c, g_n = shape
    starts = np.round(np.asarray(times) * sr).astype(np.int64)
    out_n = int(starts.max()) + g_n
    count = len(times)
    meta = _grain_meta(np.zeros(count), np.full(count, g_n), np.zeros(count),
                       np.zeros(count), starts)
    offsets, entries = grain_plan(starts // BLOCK, grain_blocks(g_n), out_n)
    data = grain_overlap_add(stack, meta, offsets, entries, out_n)
    return _audio(data, sr)


def texture(self, length: float, grains_per_second, time_scatter, mod=None,
            mod_feedback: bool = False, *, seed: int = 0):
    """Granular texture from one source (reference
    AudioSynthesis.cpp:423-473): without a mod, copies summed by
    _mix_repeated; with a mod and no feedback, the modded grains by K3;
    with feedback, each grain the mod of the one before, mixed in turn."""
    from flan_tpu_torch.audio.combination import mix
    if self.is_null():
        return _null()
    times = integrate_event_rate(length, grains_per_second, time_scatter,
                                 self.sample_rate, seed=seed)
    if len(times) == 0:
        return _null()
    if mod is None:
        return _mix_repeated(self, times)
    if not mod_feedback:
        return _texture_mod_grains(self, times, mod)
    grains = []
    current = self
    for i, t in enumerate(times):
        source = current if i > 0 else self
        g = mod(source, float(t))
        grains.append(g)
        current = g
    return mix(grains, start_times=list(times))


def texture_effect(self, effects_per_second, time_scatter, effect_length,
                   mod, fade_time: float = 16.0 / 48000.0, interp=None,
                   *, seed: int = 0):
    """An effect applied to crossfaded sections at event times (reference
    AudioSynthesis.cpp:475-537): each section is cut from the running
    output, modded and faded, and replaces its span there."""
    if self.is_null() or mod is None:
        return _null()
    if interp is None:
        interp = interpolators.linear
    fade_frames = max(0, self.time_to_frame(fade_time))
    times = integrate_event_rate(self.length, effects_per_second,
                                 time_scatter, self.sample_rate, seed=seed)
    eff_fn = as_function(effect_length)
    dev = self.device

    out = self.data.clone()
    for t in times:
        event_frame = self.time_to_frame(float(t))
        ln = max(_scalar(eff_fn, float(t)), 0.0)
        in_frames = self.time_to_frame(ln)
        piece = self._with(data=out).modify_boundaries_frames(
            event_frame, event_frame + in_frames - self.num_frames)
        piece = mod(piece, float(t))
        out_frames_c = piece.num_frames
        fade_c = min(int(self.time_to_frame(piece.length / 2)), fade_frames)
        piece = piece.fade_frames(fade_c, fade_c, interp)

        n = out.shape[-1]
        ramp = torch.as_tensor(interp(1.0 - true_div(
            float_iota(max(fade_c, 1), device=dev), max(fade_c, 1))),
            dtype=torch.float32, device=dev)
        if fade_c > 0:
            lo, hi = min(event_frame, n), min(event_frame + fade_c, n)
            if hi > lo:
                out[:, lo:hi] *= ramp[:hi - lo][None]
            lo2 = min(event_frame + out_frames_c - fade_c + 1, n)
            hi2 = min(event_frame + out_frames_c + 1, n)
            if hi2 > lo2:
                out[:, lo2:hi2] *= ramp.flip(0)[:hi2 - lo2][None]
        # zero the middle
        lo = min(event_frame + fade_c, n)
        hi = min(event_frame + out_frames_c - fade_c + 1, n)
        if hi > lo:
            out[:, lo:hi] = 0.0
        # add the piece
        lo, hi = max(event_frame, 0), min(event_frame + out_frames_c, n)
        if hi > lo:
            out[:, lo:hi] += piece.data[:out.shape[0], :hi - lo]
    return self._with(data=out)


def synthesize_pulsars(length: float, pulse_frequency, waveform,
                       waveform_frequency, pulsaret_envelope,
                       sample_rate: float = 48000.0, oversample: int = 4,
                       *, device=None):
    """Pulsar synthesis (Roads; flan_tpu/audio/synthesis.py:509-549): the
    pulse phase is the mod-1 cycle scan (K2) of the pulse rate; the
    pulsaret's own phase is that phase times wf / pf, the waveform and the
    envelope are evaluated on it, silent past one cycle; rendered
    oversampled, then downsampled."""
    if length <= 0 or sample_rate <= 0 or oversample < 1:
        return _null()
    dev = _device(device)
    out_frames = int(length * sample_rate)
    in_rate = sample_rate * oversample
    n_in = out_frames * oversample
    pf = torch.clamp(as_function(pulse_frequency).sample_device(
        n_in, 1.0 / in_rate, dev), min=1e-6)
    wf = as_function(waveform_frequency).sample_device(n_in, 1.0 / in_rate,
                                                       dev)
    phi = cycle_scan(pf, None, in_rate, n_in)
    local = phi * (wf / pf)
    del phi, wf
    live = local < 1.0
    x = (broadcast_f32(as_function(waveform)(local), (n_in,), dev)
         * broadcast_f32(as_function(pulsaret_envelope)(local), (n_in,),
                         dev))
    samples = torch.where(live, x, 0.0)[None, :]
    return _audio(samples, in_rate).resample(sample_rate)


def synthesize_trainlets(length: float, grains_per_second, time_scatter,
                         position, trainlet_gain_envelope, impulse_freq,
                         trainlet_length, num_harmonics=2 ** 14, chroma=1.0,
                         impulse_harmonic_frequency=32.0,
                         sample_rate: float = 48000.0, *, seed: int = 0,
                         device=None):
    """Trainlet synthesis per "Microsound" (reference
    AudioSynthesis.cpp:543-570): each grain an impulse train, its copies
    summed by _mix_repeated at their gains, spatialised."""
    dev = _device(device)
    pos_fn = position if callable(position) else (lambda t: position)
    env_fn = as_function(trainlet_gain_envelope)
    freq_fn = as_function(impulse_freq)
    tl_fn = as_function(trainlet_length)
    nh_fn = as_function(num_harmonics)
    ch_fn = as_function(chroma)
    ihf_fn = as_function(impulse_harmonic_frequency)

    def grain_source(t):
        impulse = synthesize_impulse(
            _scalar(ihf_fn, t), int(_scalar(nh_fn, t)), _scalar(ch_fn, t),
            sample_rate, device=dev)
        tl = _scalar(tl_fn, t)
        times = integrate_event_rate(tl, freq_fn, 0.0, sample_rate,
                                     seed=seed + int(t * 1000) + 1)
        if len(times) == 0:
            return _null()
        gains = [_scalar(env_fn, float(tt)) for tt in times]
        train = _mix_repeated(impulse, np.asarray(times),
                              gains=np.asarray(gains, np.float32))
        return train.stereo_spatialize(pos_fn(t))

    return synthesize_grains(length, grains_per_second, time_scatter,
                             grain_source, sample_rate, seed=seed)


def _granulate_batched(self, times: np.ndarray, sels: np.ndarray,
                       gls: np.ndarray, fts: np.ndarray, envelope=None):
    """Dense granulate (flan_tpu/audio/synthesis.py:594-654): cut_frames'
    clamps and nulls, the sqrt fades with fade_frames' proportional
    shrink, synthesize_grains' pairing of the surviving grains with the
    first times; the grains land by K3. An envelope (psola's hann) is
    evaluated into a [G, la] plane on the device, which K3 reads."""
    sr = self.sample_rate
    n = self.num_frames
    dev = self.device

    def t2f(v):
        return np.asarray(np.round(np.asarray(v, np.float64) * sr), np.int64)

    s0 = np.clip(t2f(sels), 0, n - 1)
    e0 = np.clip(t2f(sels + gls), 0, n - 1)
    live = e0 > s0                       # cut_frames -> null otherwise
    s0, e0 = s0[live], e0[live]
    ft_g = np.broadcast_to(t2f(fts), live.shape)[live]
    g = int(live.sum())
    if g == 0:
        return _null()
    lens = e0 - s0
    starts_out = t2f(np.asarray(times)[:g])

    sf = np.clip(ft_g, 0, lens)
    ef = np.clip(ft_g, 0, lens)
    over = sf + ef > lens
    scale = np.where(over, lens / np.maximum(sf + ef, 1), 1.0)
    sf = np.where(over, (sf * scale).astype(np.int64), sf)
    ef = np.where(over, lens - sf, ef)

    width = int(lens.max())
    out_n = int((starts_out + lens).max())
    nblk_g = grain_blocks(width)
    meta = _grain_meta(s0, lens, sf, ef, starts_out)
    envp = None
    if envelope is not None:
        la = nblk_g * BLOCK
        lane = (float_iota(la, device=dev)[None, :]
                - meta[4].to(dev, torch.float32)[:, None])
        lens_f = meta[1].to(dev, torch.float32)[:, None]
        envp = broadcast_f32(envelope(
            torch.clamp(lane, min=0.0) / torch.clamp(lens_f, min=1.0)),
            lane.shape, dev)
    offsets, entries = grain_plan(starts_out // BLOCK, nblk_g, out_n)
    data = grain_overlap_add(self.data, meta, offsets, entries, out_n, envp)
    return _audio(data, sr)


def granulate(self, length: float, grains_per_second, time_scatter,
              time_selection, grain_length, fade_time=0.0, mod=None,
              *, seed: int = 0, _envelope=None):
    """Granular synthesis reading grains from this audio (reference
    AudioSynthesis.cpp:572-609). Without a mod the grains land by K3; a mod
    takes the reference-shaped path, a grain cut and modded per event."""
    if self.is_null():
        return _null()
    sel_fn = as_function(time_selection)
    gl_fn = as_function(grain_length)
    ft_fn = as_function(fade_time)

    if mod is None:
        times = integrate_event_rate(length, grains_per_second,
                                     time_scatter, self.sample_rate,
                                     seed=seed)
        if len(times) == 0:
            return _null()
        tj = np.asarray(times, np.float32)
        sels = _host_eval(sel_fn, tj)
        gls = _host_eval(gl_fn, tj)
        fts = _host_eval(ft_fn, tj)
        return _granulate_batched(self, times, sels, gls, fts,
                                  envelope=_envelope)

    def grain_source(t):
        sel = _scalar(sel_fn, t)
        gl = _scalar(gl_fn, t)
        ft = _scalar(ft_fn, t)
        grain = self.cut(sel, sel + gl, ft, ft)
        if grain.is_null():
            return grain
        grain = mod(grain, t)
        if _envelope is not None and not grain.is_null():
            ln = grain.length
            grain = grain.modify_volume(lambda tt: _envelope(tt / ln))
        return grain

    return synthesize_grains(length, grains_per_second, time_scatter,
                             grain_source, self.sample_rate, seed=seed)


def psola(self, length: float, time_selection, mod=None, *, seed: int = 0):
    """Pitch-synchronous overlap-add (reference AudioSynthesis.cpp:611-638):
    the grain rate follows the source's pitch at the selected time, grains
    are two periods long under a hann window. The pitch is read on a whole
    grid at once: max(freq(sel(t)), 1e-3) elementwise, as the JAX package
    reads it one scalar at a time."""
    if self.is_null():
        return _null()
    freq = self.get_frequency_envelope()
    sel_fn = as_function(time_selection)

    def freq_at(t):
        t = torch.as_tensor(t, dtype=torch.float32)
        v = torch.as_tensor(freq(broadcast_f32(sel_fn(t), t.shape,
                                               t.device)),
                            dtype=torch.float32).to(t.device)
        return torch.clamp(v, min=1e-3)

    return granulate(
        self, length, lambda t: torch.clamp(freq_at(t), min=1.0), 0.0,
        lambda t: sel_fn(t),
        lambda t: 2.0 / torch.clamp(freq_at(t), min=1e-3),
        0.05, mod, seed=seed, _envelope=hann)
