"""State carried across from numpy (and so from flan_tpu).

The system has no learned weights: its state is the audio and spectral
buffers plus tables built on the host (the hann window, the SPV twiddles),
which both packages build with the same float64 numpy expressions. These
functions put buffers given as numpy arrays, for example
`np.asarray(jax_pv.mag)`, on a device, so both packages compute on
identical state; `to_numpy()` on each object goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.audio.audio import Audio
from flan_tpu_torch.pv.pv import PV
from flan_tpu_torch.spv.spv import SPV


def _planes(*arrays, device):
    out = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
           .to(device) for a in arrays]
    if any(t.ndim != 3 for t in out) or out[0].shape != out[1].shape:
        raise ValueError("mag and freq must be [channels, frames, bins] "
                         "arrays of one shape")
    return out


def audio_from_numpy(data, sample_rate: float, device=None) -> Audio:
    """[frames] or [channels, frames] samples -> Audio on `device`."""
    return Audio.create_from_array(np.asarray(data, np.float32), sample_rate,
                                   device=device)


def pv_from_numpy(mag, freq, sample_rate: float, hop: int, window: int,
                  device=None) -> PV:
    """[C, F, B] magnitude and frequency planes -> PV on `device`."""
    m, f = _planes(mag, freq, device=device)
    return PV(mag=m, freq=f, sample_rate=float(sample_rate),
              hop_size=int(hop), window_size=int(window))


def spv_from_numpy(mag, freq, sample_rate: float, device=None) -> SPV:
    """[C, F, B] magnitude and frequency planes -> SPV on `device`."""
    m, f = _planes(mag, freq, device=device)
    return SPV(mag=m, freq=f, sample_rate=float(sample_rate))
