"""Audio: time-domain entry point (counterpart of flan_tpu/audio/audio.py:
32-250; reference: src/flan/Audio/Audio.h).

Audio is a frozen AudioBuffer; every method returns a new object on the
same device as its input. Host data goes to the card unless the caller
names a device (core/types.py DEFAULT_DEVICE). This module carries the
constructors, WAV file I/O, mid/side conversion, resampling, the
conversions to PV, SPV and SQPV, the frame time grid and the basic volume
methods; audio/__init__.py binds the filter, dynamics and combination
methods (audio/filters.py, audio/volume.py, audio/combination.py).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from flan_tpu_torch.core.audio_buffer import AudioBuffer, SndfileStrings
from flan_tpu_torch.core.types import DEFAULT_DEVICE
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.io.wav import read_wav, write_wav
from flan_tpu_torch.ops import stft

_SQRT2 = math.sqrt(2.0)


@dataclass(frozen=True)
class Audio(AudioBuffer):
    """Audio data with algorithms (reference Audio/Audio.h)."""

    def _with(self, **kwargs) -> "Audio":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def create_null() -> "Audio":
        return Audio()

    def copy(self) -> "Audio":
        return self._with()

    @staticmethod
    def create_from_array(array, sample_rate: float = 48000.0,
                          device=None) -> "Audio":
        """[frames] or [channels, frames] array or tensor -> Audio on
        `device`. When device is None a tensor keeps its own device and
        host data goes to DEFAULT_DEVICE, the card."""
        if device is None and not isinstance(array, torch.Tensor):
            device = DEFAULT_DEVICE
        data = torch.atleast_2d(torch.as_tensor(array, dtype=torch.float32,
                                                device=device))
        return Audio(data=data.contiguous(), sample_rate=float(sample_rate))

    @staticmethod
    def load_from_file(filename: str, return_strings: bool = False,
                       device=DEFAULT_DEVICE):
        """Load a WAV file onto `device`, the card unless named (reference
        AudioConstructors.cpp:35). Other codecs are not ported yet."""
        with open(filename, "rb") as f:
            head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{filename}: not a RIFF/WAVE file; "
                             "flan_tpu_torch reads WAV only")
        data, sr, strings = read_wav(filename)
        audio = Audio(data=torch.from_numpy(data).to(device), sample_rate=sr)
        return (audio, strings) if return_strings else audio

    def save_to_file(self, filename: str,
                     strings: Optional[SndfileStrings] = None) -> None:
        """Save as WAV float32 (reference AudioBuffer.cpp:139-190)."""
        write_wav(filename, self.to_numpy(), self.sample_rate, strings)

    def resample(self, new_sample_rate: float) -> "Audio":
        """Whole-buffer SRC, the r8brain equivalent (reference
        AudioConversions.cpp:14-30), by polyphase windowed sinc
        (ops/resample.py). The reference's quirk is kept (golden-tested):
        it feeds the whole channel-major buffer through one resampler, so
        the flat [C N] stream is resampled and cut into [C, floor(N
        ratio)] rows, later channels shifted by the fractional offset of
        c N ratio (flan_tpu/audio/audio.py:187-215)."""
        from flan_tpu_torch.ops.resample import resample as _resample
        if self.is_null():
            return Audio.create_null()
        if new_sample_rate == self.sample_rate:
            return self.copy()
        c = self.num_channels
        if c == 1:
            data = _resample(self.data, float(self.sample_rate),
                             float(new_sample_rate))
        else:
            ratio = float(new_sample_rate) / float(self.sample_rate)
            out_n = int(self.num_frames * ratio)
            flat = _resample(self.data.reshape(1, -1),
                             float(self.sample_rate), float(new_sample_rate))
            data = flat[0, :c * out_n].reshape(c, out_n)
        return Audio(data=data, sample_rate=float(new_sample_rate))

    def convert_to_PV(self, window_size: int = 2048, hop: int = 128,
                      dft_size: int = 4096):
        """STFT + phase vocode (reference Conversions/AudioPV.cpp:12-78)."""
        from flan_tpu_torch.pv.pv import PV
        if self.is_null():
            return PV.create_null()
        mag, freq = stft.pv_forward(
            self.data, window_size=window_size, hop=hop, dft_size=dft_size,
            sample_rate=float(self.sample_rate))
        return PV(mag=mag, freq=freq, sample_rate=float(self.sample_rate),
                  hop_size=hop, window_size=window_size)

    def convert_to_ms_PV(self, window_size: int = 2048, hop: int = 128,
                         dft_size: int = 4096):
        """Mid/side first, then PV (reference AudioPV.cpp:80-84); a null PV
        for anything but two channels."""
        from flan_tpu_torch.pv.pv import PV
        if self.num_channels != 2:
            return PV.create_null()
        return self.convert_to_mid_side().convert_to_PV(window_size, hop,
                                                        dft_size)

    def convert_to_SPV(self, dft_size: int = 1024):
        """Sliding-DFT phase vocoder (reference Conversions/AudioSPV.cpp).
        dft_size is the bin count, as in the reference's call convention."""
        from flan_tpu_torch.spv.spv import SPV, spv_forward
        if self.is_null():
            return SPV.create_null()
        mag, freq = spv_forward(self.data, dft_size, float(self.sample_rate))
        return SPV(mag=mag, freq=freq, sample_rate=float(self.sample_rate))

    def convert_to_ms_SPV(self, dft_size: int = 1024):
        """Mid/side first, then SPV (reference AudioSPV.cpp:108-111)."""
        return self.convert_to_mid_side().convert_to_SPV(dft_size)

    def convert_to_SQPV(self, bandwidth=(16.0, 24000.0),
                        bins_per_octave: float = 24.0):
        """Sliding constant-Q transform (reference Audio.h:197-205;
        AudioSQPV.cpp:64-121, dormant upstream and activated in the JAX
        package). See sqpv/transform.py."""
        from flan_tpu_torch.sqpv.sqpv import SQPV
        from flan_tpu_torch.sqpv.transform import sqpv_forward
        if self.is_null():
            return SQPV.create_null()
        bandwidth = (float(bandwidth[0]), float(bandwidth[1]))
        mag, pitch, positive = sqpv_forward(
            self.data, float(self.sample_rate), float(bins_per_octave),
            bandwidth)
        return SQPV(mag=mag, pitch=pitch, positive=positive,
                    sample_rate=float(self.sample_rate),
                    bins_per_octave=float(bins_per_octave),
                    bandwidth=bandwidth)

    def convert_to_ms_SQPV(self, bandwidth=(16.0, 24000.0),
                           bins_per_octave: float = 24.0):
        """Mid/side first, then SQPV (reference AudioSQPV.cpp:123-126)."""
        return self.convert_to_mid_side().convert_to_SQPV(bandwidth,
                                                          bins_per_octave)

    def convert_to_mid_side(self) -> "Audio":
        """L/R -> M/S with the reference's 1/sqrt(2) convention (reference
        AudioConversions.cpp:32-51); anything but two channels is copied."""
        if self.is_null():
            return Audio.create_null()
        if self.num_channels != 2:
            return self.copy()
        m = stft.true_div(self.data[0] + self.data[1], _SQRT2)
        s = stft.true_div(self.data[0] - self.data[1], _SQRT2)
        return self._with(data=torch.stack([m, s]))

    def convert_to_left_right(self) -> "Audio":
        """M/S -> L/R; self-inverse (reference AudioConversions.cpp:53-56)."""
        return self.convert_to_mid_side()

    def time_grid(self) -> torch.Tensor:
        """Each frame's time, arange(N) / sample_rate in float32 on the
        audio's device, as the JAX package builds it: the float32 count is
        exact up to 2^24 frames (349.5 s at 48 kHz) and rounds to even
        frame numbers above that."""
        n = self.num_frames
        return stft.true_div(torch.arange(n, dtype=torch.float32,
                                          device=self.device),
                             self.sample_rate)

    # =======================================================================
    # Basic volume ops (more in audio/volume.py)
    # =======================================================================
    def invert_phase(self) -> "Audio":
        """(reference AudioVolume.cpp)"""
        return self._with(data=-self.data)

    def modify_volume(self, gain) -> "Audio":
        """output(t) = input(t) * gain(t) (reference AudioVolume.cpp:5)."""
        g = as_function(gain)
        if g.is_constant:
            return self._with(data=self.data * g.constant_value)
        return self._with(data=self.data * g(self.time_grid())[None, :])

    def set_volume(self, level) -> "Audio":
        """Normalize then scale by level (reference AudioVolume.cpp)."""
        peak = torch.max(torch.abs(self.data))
        normalized = self._with(
            data=self.data / torch.where(peak > 0, peak, 1.0))
        return normalized.modify_volume(level)
