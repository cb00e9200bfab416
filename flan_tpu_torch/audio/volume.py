"""Audio dynamics: the compressor and the ADSR / AR envelopes (counterpart
of flan_tpu/audio/volume.py; reference: src/flan/Audio/AudioVolume.cpp).

The compressor's sequential peak detector is two scans (ops/scan.py): a
max-affine one and a linear one over the [N] control signal. Bound onto
Audio in flan_tpu_torch/audio/__init__.py. waveshape and add_moisture wait
for ops/resample.py (ROADMAP A.12) and are not bound.
"""
from __future__ import annotations

import torch

from flan_tpu_torch.audio.filters import _sample_over_frames
from flan_tpu_torch.func.function import adsr as adsr_fn
from flan_tpu_torch.ops.scan import linear_recurrence, max_affine_recurrence
from flan_tpu_torch.ops.stft import cpu_exact, true_div


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
