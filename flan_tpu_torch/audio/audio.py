"""Audio: time-domain entry point (counterpart of flan_tpu/audio/audio.py:
32-250; reference: src/flan/Audio/Audio.h).

Audio is a frozen AudioBuffer; every method returns a new object on the
same device as its input. Host data goes to the card unless the caller
names a device (core/types.py DEFAULT_DEVICE). This module carries the
constructors, file I/O (io/files.py), the channel and mid/side conversions,
resampling, the conversions to PV, SPV, SQPV and a Function, the energy
readings, the frame time grid, the basic volume methods and the reference's
*_in_place names; audio/__init__.py binds the filter, dynamics,
combination, temporal, information and spatial methods (audio/filters.py,
volume.py, combination.py, temporal.py, information.py, spatial.py).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from flan_tpu_torch.core.audio_buffer import (AudioBuffer, AudioFormat,
                                              SndfileStrings)
from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func.function import Function, as_function
from flan_tpu_torch.io.files import read_audio_file, write_audio_file
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
    def create_from_buffer(buffer, num_channels: int, sample_rate: float,
                           device=None) -> "Audio":
        """A channel-major flat buffer cut into num_channels rows; device as
        create_from_array's."""
        if device is None and not isinstance(buffer, torch.Tensor):
            device = DEFAULT_DEVICE
        data = torch.as_tensor(buffer, dtype=torch.float32, device=device)
        return Audio(data=data.reshape(num_channels, -1).contiguous(),
                     sample_rate=float(sample_rate))

    @staticmethod
    def create_from_format(fmt: AudioFormat, device=DEFAULT_DEVICE
                           ) -> "Audio":
        """Silence of the format's shape on `device`, the card unless
        named."""
        return Audio.create_empty_with_frames(fmt.num_frames, fmt.num_channels,
                                              fmt.sample_rate, device)

    @staticmethod
    def create_empty_with_length(length: float, num_channels: int = 1,
                                 sample_rate: float = 48000.0,
                                 device=DEFAULT_DEVICE) -> "Audio":
        """Silence of ceil(length sample_rate) frames."""
        frames = int(math.ceil(length * sample_rate))
        return Audio.create_empty_with_frames(frames, num_channels,
                                              sample_rate, device)

    @staticmethod
    def create_empty_with_frames(num_frames: int, num_channels: int = 1,
                                 sample_rate: float = 48000.0,
                                 device=DEFAULT_DEVICE) -> "Audio":
        return Audio(data=torch.zeros((num_channels, num_frames),
                                      dtype=torch.float32, device=device),
                     sample_rate=float(sample_rate))

    @staticmethod
    def match_sample_rates_or_return_null(ins) -> list:
        """[] if every input has one sample rate, else every input resampled
        to the highest (reference AudioCombination.cpp:17-35)."""
        ins = list(ins)
        if not ins:
            return []
        max_sr = max(a.sample_rate for a in ins)
        if all(a.sample_rate == max_sr for a in ins):
            return []
        return [a.resample(max_sr) for a in ins]

    def sample_function_over_domain(self, f):
        """A Function sampled at every frame's time, on the audio's device
        (reference Audio.h:34-38); a constant stays one number."""
        from flan_tpu_torch.func.function_sample import FunctionSample
        vals = as_function(f).sample(0, self.num_frames,
                                     1.0 / self.sample_rate, self.device)
        return FunctionSample(vals, self.num_frames, self.device)

    @staticmethod
    def load_from_file(filename: str, return_strings: bool = False,
                       device=DEFAULT_DEVICE):
        """Load WAV, FLAC, AIFF/AIFF-C, Ogg/Vorbis, AU, CAF, Wave64 or MP3,
        sniffed by stream magic as flan_tpu/audio/audio.py:76-120 does
        (reference AudioConstructors.cpp:35, AudioBuffer.cpp:86-117). The
        host codec decodes; the samples then go to `device`, the card
        unless named, staged through pinned memory there (on an H100 a
        600 s stereo clip's 230 MB took 21 ms to pin and copy against 45
        ms from pageable memory: chip_smoke.py phase 12, PERF.md §5).
        Only WAV carries metadata strings."""
        data, sr, strings = read_audio_file(filename)
        host = torch.from_numpy(data)
        if torch.device(device).type == "cuda":
            # the pinned block stays reserved until the copy has run
            # (torch's caching host allocator records the copy's event)
            host = host.pin_memory()
        audio = Audio(data=host.to(device, non_blocking=True),
                      sample_rate=sr)
        return (audio, strings) if return_strings else audio

    def save_to_file(self, filename: str,
                     strings: Optional[SndfileStrings] = None) -> None:
        """Save by extension as flan_tpu/audio/audio.py:122-157 does: FLAC
        for .flac, AIFF-C float32 for .aiff/.aif/.aifc, Ogg/Vorbis for
        .ogg/.oga, AU for .au/.snd, CAF for .caf, Wave64 for .w64, MP3 for
        .mp3, else WAV float32 (reference AudioBuffer.cpp:139-190)."""
        write_audio_file(filename, self.to_numpy(), self.sample_rate,
                         strings)

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

    def convert_to_stereo(self) -> "Audio":
        """1 or 2 channels -> 2, mono scaled by 1/sqrt(2) (reference
        AudioConversions.cpp:58-85); more channels raise."""
        if self.is_null():
            return Audio.create_null()
        if self.num_channels == 2:
            return self.copy()
        if self.num_channels == 1:
            mono = stft.true_div(self.data[0], _SQRT2)
            return self._with(data=torch.stack([mono, mono]))
        raise ValueError(
            f"can't convert {self.num_channels} channels to stereo")

    def convert_to_mono(self) -> "Audio":
        """The channels' mean (reference AudioConversions.cpp:87-104)."""
        if self.is_null():
            return Audio.create_null()
        return self._with(data=torch.mean(self.data, dim=0, keepdim=True))

    def convert_to_function(self) -> Function:
        """The mono mix as a Function of time, the sample at floor(t sr)
        and 0 outside the audio (reference AudioConversions.cpp:106-123);
        it answers on the audio's device."""
        if self.is_null():
            return Function(0.0)
        mono = self.convert_to_mono().data[0]
        sr, n = self.sample_rate, self.num_frames

        def fn(t):
            t = torch.as_tensor(t, dtype=torch.float32, device=mono.device)
            frame = (t * sr).to(torch.int32)
            valid = (frame >= 0) & (frame < n)
            return torch.where(valid, mono[frame.clamp(0, n - 1).long()], 0.0)

        return Function(fn)

    # =======================================================================
    # Channels (reference Audio.h:237-262, AudioChannels.cpp)
    # =======================================================================
    def split_channels(self) -> List["Audio"]:
        return [self._with(data=self.data[c:c + 1])
                for c in range(self.num_channels)]

    @staticmethod
    def combine_channels(channels: Sequence["Audio"]) -> "Audio":
        """Every channel of every input, stacked (reference
        AudioChannels.cpp:31); shorter inputs padded with zeros to the
        longest. The result lies on the first input's device."""
        ins = [a for a in channels if not a.is_null()]
        if not ins:
            return Audio.create_null()
        max_frames = max(a.num_frames for a in ins)
        rows = [torch.nn.functional.pad(a.data.to(ins[0].device),
                                        (0, max_frames - a.num_frames))
                for a in ins]
        return Audio(data=torch.cat(rows, dim=0),
                     sample_rate=ins[0].sample_rate)

    # =======================================================================
    # Information (reference Audio.h:266-373)
    # =======================================================================
    def get_total_energy(self) -> np.ndarray:
        """Per-channel sum of squares, on the host (reference
        AudioInformation.cpp)."""
        return torch.sum(torch.square(self.data), dim=-1).cpu().numpy()

    def get_energy_difference(self, other: "Audio") -> np.ndarray:
        """Per-channel energy of the sample-wise difference over the common
        channels and frames, the reference's unit-testing oracle
        (Audio.h:275-279)."""
        n = min(self.num_frames, other.num_frames)
        c = min(self.num_channels, other.num_channels)
        diff = self.data[:c, :n] - other.data[:c, :n].to(self.device)
        return torch.sum(torch.square(diff), dim=-1).cpu().numpy()

    def get_max_sample_magnitude(self, start_time: float = 0.0,
                                 end_time: float = 0.0) -> float:
        """The largest |sample| from start_time to end_time, an end of 0
        meaning the last frame (reference AudioBuffer.h:164)."""
        if self.is_null():
            return 0.0
        a = self.time_to_frame(start_time)
        b = self.time_to_frame(end_time) if end_time != 0 \
            else self.num_frames
        return float(torch.max(torch.abs(self.data[:, a:b])))

    def reverse(self) -> "Audio":
        """Reverse in time and in channel order (reference
        AudioTemporal.cpp:174-189: channel c is copied into the flat
        buffer's reversed view at c F, so its samples land in channel C - 1
        - c; golden-tested)."""
        return self._with(data=torch.flip(self.data, (0, 1)))

    def time_grid(self) -> torch.Tensor:
        """Each frame's time, arange(N) / sample_rate in float32 on the
        audio's device, as the JAX package builds it: the float32 count is
        exact up to 2^24 frames (349.5 s at 48 kHz) and rounds to even
        frame numbers above that."""
        n = self.num_frames
        return stft.true_div(float_iota(n, device=self.device),
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

    def ring_modulate(self, other: "Audio") -> "Audio":
        """The sample-wise product, the other audio repeated cyclically over
        channels and frames (reference AudioVolume.cpp:15-30)."""
        if self.is_null() or other.is_null():
            return Audio.create_null()
        dev = self.device
        ch = torch.arange(self.num_channels, device=dev) % other.num_channels
        fr = torch.arange(self.num_frames, device=dev) % other.num_frames
        return self._with(data=self.data * other.data.to(dev)[ch][:, fr])

    # The reference's *_in_place methods save a copy (Audio.h:541-592);
    # tensors here are not shared between Audio objects, so these return
    # the new object under the reference's names.
    def modify_volume_in_place(self, gain):
        return self.modify_volume(gain)

    def set_volume_in_place(self, level):
        return self.set_volume(level)

    def fade_in_place(self, start=16.0 / 48000.0, end=16.0 / 48000.0,
                      interp=None):
        from flan_tpu_torch.func import interpolators
        return self.fade(start, end, interp or interpolators.sqrt)

    def fade_frames_in_place(self, start=16, end=16, interp=None):
        from flan_tpu_torch.func import interpolators
        return self.fade_frames(start, end, interp or interpolators.sqrt)

    def pan_in_place(self, pan_position):
        return self.pan(pan_position)

    def mix_in_place(self, other, other_start_time: float = 0.0,
                     other_amplitude=1.0):
        """The other audio mixed in at a time and gain, this audio's
        channels and length kept (reference AudioCombination.cpp:181-203)."""
        mixed = Audio.mix([self, other], start_times=[0.0, other_start_time],
                          gains=[1.0, other_amplitude])
        return mixed._with(data=mixed.data[:self.num_channels,
                                           :self.num_frames])

    def play(self) -> None:
        """The reference plays audio on win32 only (AudioBuffer.h:220-222);
        as in the JAX package, there is no audio device here."""
        raise NotImplementedError(
            "Audio.play is not available (the reference supports it only "
            "on win32); save_to_file and play externally")
