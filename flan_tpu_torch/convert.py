"""State carried across from numpy (and so from flan_tpu).

The system has no learned weights: its state is the audio and spectral
buffers plus tables built on the host (the hann window, the SPV and SQPV
twiddles), which both packages build with the same float64 numpy
expressions. These functions put buffers given as numpy arrays, for
example `np.array(jax_pv.mag)`, on a device (the card unless the caller
names one), so both packages compute on identical state; `to_numpy()` on
each object goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.audio.audio import Audio
from flan_tpu_torch.core.types import DEFAULT_DEVICE
from flan_tpu_torch.pv.pv import PV
from flan_tpu_torch.spv.spv import SPV
from flan_tpu_torch.sqpv.sqpv import SQPV


def _planes(*arrays, device, dtypes=None):
    dtypes = dtypes or [np.float32] * len(arrays)
    out = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
           for a, dt in zip(arrays, dtypes)]
    if any(t.ndim != 3 or t.shape != out[0].shape for t in out):
        raise ValueError("the planes must be [channels, frames, bins] "
                         "arrays of one shape")
    return out


def audio_from_numpy(data, sample_rate: float,
                     device=DEFAULT_DEVICE) -> Audio:
    """[frames] or [channels, frames] samples -> Audio on `device`."""
    return Audio.create_from_array(np.asarray(data, np.float32), sample_rate,
                                   device=device)


def pv_from_numpy(mag, freq, sample_rate: float, hop: int, window: int,
                  device=DEFAULT_DEVICE) -> PV:
    """[C, F, B] magnitude and frequency planes -> PV on `device`."""
    m, f = _planes(mag, freq, device=device)
    return PV(mag=m, freq=f, sample_rate=float(sample_rate),
              hop_size=int(hop), window_size=int(window))


def spv_from_numpy(mag, freq, sample_rate: float,
                   device=DEFAULT_DEVICE) -> SPV:
    """[C, F, B] magnitude and frequency planes -> SPV on `device`."""
    m, f = _planes(mag, freq, device=device)
    return SPV(mag=m, freq=f, sample_rate=float(sample_rate))


def sqpv_from_numpy(mag, pitch, positive, sample_rate: float,
                    bins_per_octave: float, bandwidth,
                    device=DEFAULT_DEVICE) -> SQPV:
    """[C, F, B] magnitude, pitch and sign planes -> SQPV on `device`."""
    m, p, s = _planes(mag, pitch, positive, device=device,
                      dtypes=[np.float32, np.float32, np.bool_])
    return SQPV(mag=m, pitch=p, positive=s, sample_rate=float(sample_rate),
                bins_per_octave=float(bins_per_octave),
                bandwidth=(float(bandwidth[0]), float(bandwidth[1])))


def wavetable_from_numpy(table, waveform_starts, wavelength: int,
                         sample_rate: float, device=DEFAULT_DEVICE, *,
                         num_source_frames: int):
    """A Wavetable from its state as numpy: the table [channels, waves,
    wavelength] (np.array(jax_wavetable.table)), the waveform starts per
    channel, the wavelength, the sample rate and the source's length in
    frames, so both packages play one table."""
    from flan_tpu_torch.wavetable import Wavetable
    t = torch.from_numpy(np.ascontiguousarray(table, np.float32)).to(device)
    if t.ndim != 3 or t.shape[-1] != wavelength:
        raise ValueError(f"table must be [channels, waves, {wavelength}], "
                         f"got {tuple(t.shape)}")
    return Wavetable(_table=t, _starts=[list(map(int, s))
                                         for s in waveform_starts],
                     _num_source_frames=int(num_source_frames),
                     _sample_rate=float(sample_rate), wavelength=wavelength)
