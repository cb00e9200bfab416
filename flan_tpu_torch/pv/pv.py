"""PV: phase-vocoder algorithm surface (counterpart of flan_tpu/pv/pv.py:
27-202; reference: src/flan/PV/PV.h, PVModify.cpp:307-385).

PV is a frozen PVBuffer; every method returns a new PV on the same device.
This slice carries the conversion back to audio and the time remaps.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch

from flan_tpu_torch.core.pv_buffer import PVBuffer
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import as_function2d
from flan_tpu_torch.ops import pv_modify, stft


@dataclass(frozen=True)
class PV(PVBuffer):
    """Phase-vocoder data with algorithms (reference PV/PV.h)."""

    @staticmethod
    def create_null() -> "PV":
        return PV()

    def _with(self, **kwargs) -> "PV":
        return dataclasses.replace(self, **kwargs)

    def convert_to_audio(self):
        """Inverse phase vocoder + overlap-add (reference
        Conversions/AudioPV.cpp:86-139, incl. the 2.67 gain convention)."""
        from flan_tpu_torch.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        data = stft.pv_inverse(self.mag, self.freq,
                               window_size=self.window_size,
                               hop=self.hop_size,
                               sample_rate=float(self.sample_rate))
        return Audio(data=data, sample_rate=self.sample_rate)

    def _remap_time(self, time_map: torch.Tensor, interp: Callable) -> "PV":
        out_frames = int(math.ceil(float(time_map.max())))
        mag, freq = pv_modify.modify_time_gather(
            self.mag, self.freq, time_map, out_frames=out_frames,
            interp=interp)
        return self._with(mag=mag, freq=freq)

    def stretch(self, factor, interp: Callable = interpolators.linear,
                ) -> "PV":
        """Time stretch: partial time-integral of factor -> monotonic remap
        (reference PVModify.cpp:371-385). factor must be positive."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(factor)
        if fn.is_constant:
            sampled = torch.full((self.num_frames, 1), fn.constant_value,
                                 dtype=torch.float32, device=self.device)
        else:
            sampled = fn.sample_grid(self.num_frames, 1.0 / self.analysis_rate,
                                     self.num_bins, self.bin_width,
                                     device=self.device)
        # inclusive partial integral, in PV frames
        return self._remap_time(torch.cumsum(sampled, dim=0), interp)

    def modify_time(self, mod, interp: Callable = interpolators.linear,
                    ) -> "PV":
        """Arbitrary monotonic time remap (reference PVModify.cpp:364-369).
        mod maps (t, f) -> output seconds; must be increasing in t."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(mod)
        if fn.is_constant:
            raise ValueError("modify_time requires a time-dependent mod")
        # Reference grid: t = frame * (1.0f / analysis_rate) in float32
        # (Function.h:165-167), not frame / analysis_rate: the 1-ulp
        # difference flips the output-size ceil.
        mapped = fn.sample_grid(self.num_frames, 1.0 / self.analysis_rate,
                                self.num_bins, self.bin_width,
                                device=self.device)
        return self._remap_time(mapped * self.analysis_rate, interp)
