"""PV: phase-vocoder algorithm surface (counterpart of flan_tpu/pv/pv.py;
reference: src/flan/PV/PV.h, PV.cpp, PVModify.cpp:196-385).

PV is a frozen PVBuffer; every method returns a new PV on the same device.
Constructors that take host data (a format, a file) put it on the card
unless the caller names a device (core/types.py DEFAULT_DEVICE).
pv/__init__.py binds the algorithm group (pv/algorithms.py) onto the class.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from flan_tpu_torch.core.pv_buffer import PVBuffer, PVFormat
from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.func.function import (as_function, as_function2d,
                                          broadcast_f32)
from flan_tpu_torch.ops import pv_modify, stft


@dataclass(frozen=True)
class PV(PVBuffer):
    """Phase-vocoder data with algorithms (reference PV/PV.h)."""

    # --- Constructors -------------------------------------------------------
    @staticmethod
    def create_null() -> "PV":
        return PV()

    @staticmethod
    def create_from_format(fmt: PVFormat, device=DEFAULT_DEVICE) -> "PV":
        """Zero planes of `fmt`'s shape on `device`."""
        shape = (fmt.num_channels, fmt.num_frames, fmt.num_bins)
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        return PV(mag=zeros, freq=zeros.clone(), sample_rate=fmt.sample_rate,
                  hop_size=fmt.hop_size, window_size=fmt.window_size)

    @staticmethod
    def load_from_file(filename: str, device=DEFAULT_DEVICE) -> "PV":
        """Load a RIFF .flan file onto `device` (reference
        PVBuffer.cpp:216)."""
        from flan_tpu_torch.io.flan_format import read_flan
        mag, freq, sr, hop, window = read_flan(filename)
        return PV(mag=torch.from_numpy(mag).to(device),
                  freq=torch.from_numpy(freq).to(device), sample_rate=sr,
                  hop_size=hop, window_size=window)

    def save(self, filename: str) -> None:
        """Save as RIFF .flan (reference PVBuffer.cpp:99)."""
        from flan_tpu_torch.io.flan_format import write_flan
        mag, freq = self.to_numpy()
        write_flan(filename, mag, freq, self.sample_rate, self.hop_size,
                   self.window_size)

    def copy(self) -> "PV":
        return self._with(mag=self.mag.clone(), freq=self.freq.clone())

    def _with(self, **kwargs) -> "PV":
        return dataclasses.replace(self, **kwargs)

    # --- Function sampling (reference PV.h:31-48) ----------------------------
    def sample_function_over_domain(self, f):
        """Rasterise a Function over the frame x bin grid: time step
        1/analysis_rate, frequency step bin_width. Constants stay O(1)."""
        from flan_tpu_torch.func.function_sample import FunctionSample2d
        vals = as_function2d(f).sample_grid(
            self.num_frames, 1.0 / self.analysis_rate, self.num_bins,
            self.bin_width, device=self.device)
        return FunctionSample2d(vals, self.num_frames, self.num_bins,
                                self.device)

    def sample_function_over_time_domain(self, f):
        """Rasterise a Function over frame times."""
        from flan_tpu_torch.func.function_sample import FunctionSample
        vals = as_function(f).sample(0, self.num_frames,
                                     1.0 / self.analysis_rate,
                                     device=self.device)
        return FunctionSample(vals, self.num_frames, self.device)

    # --- Conversions --------------------------------------------------------
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

    def convert_to_lr_audio(self):
        """Inverse of Audio.convert_to_ms_PV (AudioPV.cpp:141-145)."""
        from flan_tpu_torch.audio.audio import Audio
        if self.num_channels != 2:
            return Audio.create_null()
        return self.convert_to_audio().convert_to_left_right()

    # --- Utility ------------------------------------------------------------
    def get_frame(self, time: float) -> "PV":
        """Linear interpolation of the frames around `time` (reference
        PV.cpp get_frame), as one frame."""
        if self.is_null():
            return PV.create_null()
        x = float(self.time_to_frame(time))
        lo = int(np.clip(np.floor(x), 0, self.num_frames - 1))
        hi = int(np.clip(lo + 1, 0, self.num_frames - 1))
        r = np.float32(x - lo)
        w_lo, w_hi = float(np.float32(1) - r), float(r)
        mag = w_lo * self.mag[:, lo:lo + 1] + w_hi * self.mag[:, hi:hi + 1]
        freq = w_lo * self.freq[:, lo:lo + 1] + w_hi * self.freq[:, hi:hi + 1]
        return self._with(mag=mag, freq=freq)

    def cut_frames(self, start: int, end: int) -> "PV":
        """Keep frames [start, end) (reference PV.cpp:643-668).

        Reference quirk (golden-tested via algo_pvjoin): BOTH bounds clamp
        to num_frames - 1, so the last frame is never included. The
        end <= start null check runs before the clamp."""
        start, end = int(start), int(end)
        if end <= start:
            return PV.create_null()
        start = int(np.clip(start, 0, self.num_frames - 1))
        end = int(np.clip(end, 0, self.num_frames - 1))
        return self._with(mag=self.mag[:, start:end],
                          freq=self.freq[:, start:end])

    def split_at_times(self, split_times: Sequence[float]) -> List["PV"]:
        """Split at frame boundaries (reference PV.cpp:670-697). Quirks
        kept: split frames truncate, duplicate times give null pieces, the
        final piece loses one frame to cut_frames' end clamp."""
        frames = sorted(int(self.time_to_frame(t)) for t in split_times)
        bounds = [0] + [f for f in frames if 0 < f < self.num_frames] \
            + [self.num_frames]
        return [self.cut_frames(a, b) for a, b in zip(bounds, bounds[1:])]

    @staticmethod
    def join(ins: Sequence["PV"]) -> "PV":
        """Concatenate along frames (reference PV.cpp:698)."""
        ins = [p for p in ins if not p.is_null()]
        if not ins:
            return PV.create_null()
        return ins[0]._with(mag=torch.cat([p.mag for p in ins], dim=1),
                            freq=torch.cat([p.freq for p in ins], dim=1))

    # --- Resampling (reference PVModify.cpp) --------------------------------
    def _sample_2d(self, f) -> torch.Tensor:
        """A Function2d over the (frame, bin) grid: [F, B], or [F, 1] for a
        constant."""
        fn = as_function2d(f)
        if fn.is_constant:
            return torch.full((self.num_frames, 1), fn.constant_value,
                              dtype=torch.float32, device=self.device)
        return fn.sample_grid(self.num_frames, 1.0 / self.analysis_rate,
                              self.num_bins, self.bin_width,
                              device=self.device)

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
        # inclusive partial integral, in PV frames
        return self._remap_time(torch.cumsum(self._sample_2d(factor), dim=0),
                                interp)

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

    def _sample_grid(self, fn) -> torch.Tensor:
        """_sample_2d broadcast to the full [F, B] grid."""
        return torch.broadcast_to(self._sample_2d(fn), (self.num_frames,
                                                        self.num_bins))

    def repitch(self, factor, interp: Callable = interpolators.linear,
                ) -> "PV":
        """Pitch scale: partial bin-integral of factor -> monotonic frequency
        remap (reference PVModify.cpp:273-305). factor must be positive. A
        constant factor with the linear interp takes the host-planned
        gather (pv_modify.modify_frequency_gather_const)."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(factor)
        if fn.is_constant and interp is interpolators.linear:
            mag, freq = pv_modify.modify_frequency_gather_const(
                self.mag, self.freq, float(fn.constant_value),
                self.bin_width)
            return self._with(mag=mag, freq=freq)
        # partial integral over bins, keeping bin 0 as its own factor
        bin_map = pv_modify.integrate_bins(self._sample_grid(fn))
        # each MF's own frequency through the integrated curve
        # (PVModify.cpp:287-302): linear interpolation of the map at the
        # MF's fractional bin
        freq_modified = pv_modify.map_through_bins(self.freq, bin_map,
                                                   self.bin_width)
        mag, freq = pv_modify.modify_frequency_gather(
            self.mag, freq_modified, bin_map, interp=interp)
        return self._with(mag=mag, freq=freq)

    def modify_frequency(self, mod, interp: Callable = interpolators.linear,
                         ) -> "PV":
        """Arbitrary monotonic frequency remap (reference
        PVModify.cpp:259-271): mod maps (t, f) -> output Hz."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(mod)
        bin_map = stft.true_div(self._sample_grid(fn), self.bin_width)
        # the mod of each MF's own frequency at its frame's time, on the
        # grid of Function2d.sample_grid
        t = float_iota(self.num_frames, device=self.device) * (
            1.0 / self.analysis_rate)
        freq_modified = broadcast_f32(
            fn(torch.broadcast_to(t[None, :, None], self.freq.shape),
               self.freq), self.freq.shape, self.device)
        mag, freq = pv_modify.modify_frequency_gather(
            self.mag, freq_modified, bin_map, interp=interp)
        return self._with(mag=mag, freq=freq)

