"""Audio spatial methods: pan, widen, psychoacoustic stereo spatialisation
and the pinna filter (counterpart of flan_tpu/audio/spatial.py; reference:
src/flan/Audio/AudioSpatial.cpp). Bound onto Audio in audio/__init__.py.

The source's path and the WDL resampler's feed plan of the ITD and
doppler (_wdl_feed_plan, copied with its arithmetic unchanged: a Python
loop over blocks of 32 frames and their outputs) are worked out on the
host, as in the JAX package; the samples stay on the audio's device: the
ILD on the ported 1-pole lowpass, the doppler as one fractional-sinc gather
(ops/resample.py fractional_gather), the pinna on the ported band shelves.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops.resample import fractional_gather
from flan_tpu_torch.ops.stft import true_div

SOUND_MPS = 343.0   # the speed of sound (reference AudioSpatial.cpp:7)


def _null():
    from flan_tpu_torch.audio.audio import Audio
    return Audio.create_null()


def pan(self, pan_position):
    """Constant-power sin/cos stereo pan by a position in [-1, 1]
    (reference AudioSpatial.cpp:9-40); mono is made stereo first."""
    if self.is_null() or self.num_channels not in (1, 2):
        return _null()
    out = self.convert_to_stereo() if self.num_channels == 1 else self
    p = torch.broadcast_to(torch.as_tensor(
        as_function(pan_position)(out.time_grid()), dtype=torch.float32,
        device=out.device), (out.num_frames,)) / 2.0 + 0.5
    gains = torch.stack([interpolators.sine2(p), interpolators.sine2(1.0 - p)])
    return out._with(data=out.data * gains)


def widen(self, widen_amount):
    """Mid/side energy moved by a pan of the mid/side pair (reference
    AudioSpatial.cpp:42-45)."""
    return pan(self.convert_to_mid_side(),
               widen_amount).convert_to_left_right()


def _speed_limit_positions(ps: np.ndarray, limit_per_frame: np.ndarray
                           ) -> np.ndarray:
    """Each frame's movement clamped to the limit (reference
    AudioSpatial.cpp:237-257), on the host; untouched when no frame moves
    further."""
    mags = np.linalg.norm(np.diff(ps, axis=0), axis=-1)
    if not (mags > limit_per_frame[1:]).any():
        return ps
    out = ps.copy()
    for i in range(1, len(ps)):
        mv = ps[i] - out[i - 1]
        mag = float(np.linalg.norm(mv))
        lim = limit_per_frame[i]
        out[i] = out[i - 1] + mv / mag * lim if mag > lim else ps[i]
    return out


def _head_ild(audio, rel_pos: np.ndarray, ear_direction: float):
    """ILD: a 500 Hz 1-pole lowpass mixed in by the cosine of the angle
    away from the ear's axis (reference head_ild, AudioSpatial.cpp:116-131)."""
    angle = np.arctan2(rel_pos[:, 1], rel_pos[:, 0]) - ear_direction
    mix = torch.from_numpy((0.5 + 0.5 * np.cos(angle)).astype(np.float32)
                           ).to(audio.device)
    low = audio.filter_1pole_lowpass(500.0, 1)
    data = low.data * (1.0 - mix)[None, :] + audio.data * mix[None, :]
    return audio._with(data=data)


def _wdl_feed_plan(num_frames: int, gran: int, stretches, num_out: int):
    """Host simulation of the reference head_itd's feed-mode WDL loop
    (AudioSpatial.cpp:190-219 driving WDL resample.cpp, SetMode(true, 0,
    true, 32) and SetFeedMode(true)), copied from
    flan_tpu/audio/spatial.py:80-147 with its arithmetic unchanged; see the
    docstring there. Each block feeds `gran` input frames and emits up to
    ceil(gran stretch) outputs, reading global position win + srcpos + 15;
    an integer ratio quantises fracpos to the one table's grid.

    Returns (positions, rates) float64 [num_out]; -1e9 marks frames never
    written (the reference's zeroed output)."""
    SINC, HFS = 32, 16
    pos = np.full(num_out, -1e9, np.float64)
    rate = np.ones(num_out, np.float64)
    samples_in = 0
    fracpos = 0.0
    win = 0
    out_frame = 0
    for in_frame in range(0, num_frames, gran):
        stretch = float(stretches[in_frame // gran])
        ratio = 1.0 / stretch
        if samples_in < HFS - 1:
            win -= (HFS - 1) - samples_in
            samples_in = HFS - 1
        samples_in += gran
        filtlen = samples_in - SINC
        if ratio >= 1.0:
            ideal = float(int(ratio + 0.5)) == ratio
            oversize = 1 if ideal else 32
        else:
            drat = 1.0 / ratio
            irat = int(drat + 0.5)
            ideal = irat > 1 and float(irat) == drat and irat <= 64
            oversize = irat if ideal else 32
        srcpos = fracpos
        ret = 0
        for _ in range(int(math.ceil(gran * stretch))):
            ipos = int(srcpos)
            if ipos >= filtlen - 1:
                break
            if out_frame + ret < num_out:
                f = srcpos - ipos
                if ideal:
                    f = math.floor(f * oversize + 0.5) / oversize
                pos[out_frame + ret] = win + ipos + f + (HFS - 1)
                rate[out_frame + ret] = ratio
            srcpos += ratio
            ret += 1
        out_frame += ret
        isrcpos = int(srcpos)
        if isrcpos > samples_in:
            isrcpos = samples_in
        fracpos = srcpos - isrcpos
        if ideal:
            fracpos = math.floor(oversize * fracpos + 0.5) / oversize
        samples_in -= isrcpos
        if samples_in < 0:
            samples_in = 0
        win += isrcpos
    return pos, rate


def _head_itd(audio, rel_pos: np.ndarray):
    """ITD and doppler (reference head_itd, AudioSpatial.cpp:135-221), with
    the reference's two quirks the JAX package keeps: a moving source's
    initial delay is computed but never applied (only the doppler stretch
    from frame 0), a still one takes the integer delay; and the output
    keeps room for the unapplied delay, a zero tail. The stretch plan runs
    on the host (_wdl_feed_plan), then one 32-tap gather on the device."""
    sr = audio.sample_rate
    n = audio.num_frames
    dist = np.linalg.norm(rel_pos, axis=-1)
    if np.all(dist == dist[0]):
        d = int(dist[0] / SOUND_MPS * sr)
        return audio._with(data=torch.nn.functional.pad(audio.data, (d, 0)))
    GRAN = 32
    changes = [0.0]
    prev = float(dist[0])
    max_needed = 0.0
    for f in range(GRAN, n, GRAN):
        cur = float(dist[f])
        changes.append(cur - prev)
        prev = cur
        max_needed = max(max_needed, (f + GRAN) / sr + cur / SOUND_MPS)
    num_out = int(math.ceil(max_needed * sr))
    stretches = [1.0 / (1.0 - ch / GRAN / SOUND_MPS * sr) for ch in changes]
    pos, rate = _wdl_feed_plan(n, GRAN, stretches, num_out)
    cutoff = np.where(rate > 1.0, 1.0 / (1.03 * rate), 1.0)
    dev = audio.device
    out = fractional_gather(
        audio.data, torch.from_numpy(pos.astype(np.float32)).to(dev),
        torch.from_numpy(cutoff.astype(np.float32)).to(dev), num_taps=32)
    return audio._with(data=out)


def _host_sample(fn, count: int, period: float) -> np.ndarray:
    """A Function over (0 .. count - 1) period, float64 on the host."""
    if fn.is_constant:
        return np.full(count, fn.constant_value, np.float64)
    grid = float_iota(count) * period
    return torch.broadcast_to(torch.as_tensor(fn(grid), dtype=torch.float32),
                              (count,)).double().numpy()


def stereo_spatialize(self, position, head_width: float = 0.18,
                      speed_limit=None):
    """2-D spatialisation of a mono source at `position` (x, y) metres, or
    a callable of time giving it: per ear the ILD, a 1 / distance falloff
    and the ITD with doppler (reference AudioSpatial.cpp:223-281). The path
    is sampled at a control rate of up to 4096 points and lerped, speed
    limited below the speed of sound, on the host."""
    from flan_tpu_torch.audio.audio import Audio
    if self.num_channels != 1:
        return _null()
    n = self.num_frames
    sr = self.sample_rate
    if not callable(position):
        ps = np.tile(np.asarray(position, np.float64)[None, :], (n, 1))
    else:
        t = np.arange(n, dtype=np.float64) / sr
        ctrl_t = t[:: max(1, n // 4096)]
        ctrl = np.stack([np.asarray(position(float(tt)), np.float64)
                         for tt in ctrl_t])
        ps = np.stack([np.interp(t, ctrl_t, ctrl[:, d])
                       for d in range(ctrl.shape[1])], axis=-1)
        eps = 1.0
        if speed_limit is None:
            lim = np.full(n, (SOUND_MPS - eps) / sr)
        else:
            lim = np.clip(_host_sample(as_function(speed_limit), n, 1.0 / sr),
                          0.0, SOUND_MPS - eps) / sr
        ps = _speed_limit_positions(ps, lim)
    ears = []
    for is_left, direction in ((True, 75.0 * 2 * math.pi / 360.0),
                               (False, -75.0 * 2 * math.pi / 360.0)):
        ear_pos = np.array([0.0, (1.0 if is_left else -1.0)
                            * head_width / 2.0])
        rel = ps - ear_pos[None, :]
        buf = _head_ild(self, rel, direction)
        gain = torch.from_numpy((1.0 / (np.linalg.norm(rel, axis=-1) + 1e-5))
                                .astype(np.float32)).to(self.device)
        ears.append(_head_itd(buf._with(data=buf.data * gain[None, :]), rel))
    return Audio.combine_channels(ears)


def filter_pinna(self, height):
    """Pinna (outer ear) elevation filtering for a source one metre away,
    the reference's commented implementation as the JAX package activates
    it (AudioSpatial.cpp:69-84): the angle atan(height) sets an 8 kHz
    band shelf of -5 + angle / (pi / 2) 10 dB, a thin 10 kHz one at 0.8 of
    that and a broad 3.5 kHz one at 0.1."""
    from flan_tpu_torch.audio import filters
    if self.is_null():
        return _null()
    h_fn = as_function(height)
    if h_fn.is_constant:
        g = float(-5.0 + math.atan(float(h_fn.constant_value))
                  / (math.pi / 2) * 10.0)
        main, thin, broad = g, 0.8 * g, 0.1 * g
    else:
        def main(t):
            h = torch.as_tensor(h_fn(t), dtype=torch.float32)
            return -5.0 + true_div(torch.atan(h), math.pi / 2) * 10.0

        def thin(t):
            return main(t) * 0.8

        def broad(t):
            return main(t) * 0.1

    out = filters.filter_2pole_bandshelf(self, 8000.0, 0.25, main)
    out = filters.filter_2pole_bandshelf(out, 10000.0, 0.03, thin)
    return filters.filter_2pole_bandshelf(out, 3500.0, 0.7, broad)
