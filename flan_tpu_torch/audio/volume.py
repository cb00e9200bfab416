"""Audio dynamics: waveshaping, the compressor and the ADSR / AR envelopes
(counterpart of flan_tpu/audio/volume.py; reference:
src/flan/Audio/AudioVolume.cpp).

waveshape runs its shaper at an oversampled rate, through two passes of
ops/resample.py. The compressor's sequential peak detector is two scans
(ops/scan.py): a max-affine one and a linear one over the [N] control
signal. Bound onto Audio in flan_tpu_torch/audio/__init__.py.
"""
from __future__ import annotations

import torch

import math

from flan_tpu_torch.audio.filters import _sample_over_frames
from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func.function import adsr as adsr_fn, as_function
from flan_tpu_torch.ops.scan import linear_recurrence, max_affine_recurrence
from flan_tpu_torch.ops.stft import cpu_exact, true_div


def waveshape(self, shaper, oversample_factor: int = 4):
    """shaper(t, sample) applied at oversample_factor times the sample rate
    to keep its harmonics from aliasing (reference AudioVolume.cpp:146-166;
    flan_tpu/audio/volume.py:20-35). t is [1, frames] in seconds."""
    from flan_tpu_torch.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    over = self if oversample_factor <= 1 else self.resample(
        self.sample_rate * oversample_factor)
    t = true_div(float_iota(over.num_frames, device=over.device),
                 over.sample_rate)
    shaped = torch.as_tensor(shaper(t[None, :], over.data),
                             dtype=torch.float32, device=over.device)
    shaped = over._with(data=torch.broadcast_to(shaped, over.data.shape))
    if oversample_factor <= 1:
        return shaped
    return shaped.resample(self.sample_rate)


def add_moisture(self, amount=0.5, frequency=96.0, skew=4.0, waveform=None):
    """Bass "moisture": s + a s waveform(2 pi f sign(s) |s|^skew), shaped at
    4x oversampling (reference AudioVolume.cpp:168-188;
    flan_tpu/audio/volume.py:38-54). The waveform takes its argument in
    cycles and the reference hands it radians, so the default sine runs at
    2 pi f |s|^skew cycles: kept."""
    from flan_tpu_torch.func.function import waveforms
    if waveform is None:
        waveform = waveforms.sine
    amount_fn, freq_fn, skew_fn = (as_function(p)
                                   for p in (amount, frequency, skew))

    def shaper(t, s):
        a, f, k = (torch.as_tensor(fn(t), dtype=torch.float32,
                                   device=s.device)
                   for fn in (amount_fn, freq_fn, skew_fn))
        power = torch.sign(s) * torch.pow(torch.abs(s), k)
        return s + a * s * waveform(2.0 * math.pi * f * power)

    return waveshape(self, shaper)


def compress(self, threshold, ratio=3.0, attack=0.005, release=0.1,
             knee_width=0.0, sidechain_source=None):
    """Feed-forward dynamic range compressor, Giannoulis et al. design
    (reference AudioVolume.cpp:190-278; flan_tpu/audio/volume.py:57-115):
    soft-knee gain computer and smooth decoupled peak detector, whose two
    recurrences run as scans instead of the reference's per-sample loop."""
    if self.is_null():
        from flan_tpu_torch.audio.audio import Audio
        return Audio.create_null()
    source = sidechain_source if sidechain_source is not None else self
    n = self.num_frames
    sr = self.sample_rate

    # control signal: per-frame max over channels (AudioVolume.cpp:210-215).
    # The reference accumulates into a zero-initialized buffer with
    # `if (channel_max[f] < sample)` on SIGNED samples, so the detector
    # sees max(0, max_c x): negative half-waves detect as silence. Quirk
    # kept (golden-tested against the compiled reference).
    x = torch.clamp(torch.amax(source.data, dim=0), min=0.0)
    if x.shape[0] < n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[0]))
    x = x[:n]

    thresh, ratio_s, attack_s, release_s, knee = (
        _sample_over_frames(self, p)
        for p in (threshold, ratio, attack, release, knee_width))
    ratio_s = torch.clamp(ratio_s, min=1e-6)

    # gain computer (4) with soft knee
    x_G = 20.0 * cpu_exact(torch.log10, torch.clamp(x.abs(), min=1e-6))
    overshoot = x_G - thresh
    slope = 1.0 / ratio_s - 1.0
    z = overshoot + true_div(knee, 2.0)
    in_knee = torch.where(
        knee > 0.0,
        x_G + slope * z * z / (2.0 * torch.clamp(knee, min=1e-9)), x_G)
    y_G = torch.where(overshoot <= true_div(-knee, 2.0), x_G,
                      torch.where(overshoot >= true_div(knee, 2.0),
                                  x_G + overshoot * slope, in_knee))
    x_L = x_G - y_G

    # smooth decoupled peak detector (17) as two scans; a_R, a_A >= 0, as
    # the max-affine scan requires
    a_R = torch.exp(-1.0 / (torch.clamp(release_s, min=1e-9) * sr))
    a_A = torch.exp(-1.0 / (torch.clamp(attack_s, min=1e-9) * sr))
    y_1 = max_affine_recurrence(x_L, a_R, (1.0 - a_R) * x_L, y0=0.0)
    y_L = linear_recurrence(a_A, (1.0 - a_A) * y_1, y0=0.0)

    c = torch.pow(10.0, true_div(-y_L, 20.0))
    return self._with(data=self.data * c[None, :])


def apply_adsr_envelope(self, attack_time, decay_time, sustain_time,
                        release_time, sustain_level, attack_exponent=1.0,
                        decay_exponent=1.0, release_exponent=1.0):
    """(reference AudioVolume.cpp:280-301)"""
    env = adsr_fn(attack_time, decay_time, sustain_time, release_time,
                  sustain_level, attack_exponent, decay_exponent,
                  release_exponent)
    return self.modify_volume(env)


def apply_ar_envelope(self, attack_time, release_time,
                      attack_exponent=1.0, release_exponent=1.0):
    """(reference AudioVolume.cpp:304-321)"""
    return apply_adsr_envelope(self, attack_time, 0.0, 0.0, release_time,
                               1.0, attack_exponent, 1.0, release_exponent)
