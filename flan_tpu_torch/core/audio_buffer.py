"""AudioBuffer: the time-domain container (counterpart of
flan_tpu/core/audio_buffer.py; reference: src/flan/Audio/AudioBuffer.h).

A frozen dataclass holding one [channels, frames] float32 tensor and the
sample rate. The tensor's device is the buffer's device: every method that
makes a new tensor makes it there, and nothing in the package holds a
global device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class SndfileStrings:
    """Metadata block carried through WAV save/load (reference
    AudioBuffer.cpp:102-111)."""
    title: str = ""
    copyright: str = ""
    software: str = ""
    artist: str = ""
    comment: str = ""
    date: str = ""
    album: str = ""
    license: str = ""
    tracknumber: str = ""
    genre: str = ""


@dataclass(frozen=True)
class AudioFormat:
    """Static format info (reference AudioBuffer::Format)."""
    num_channels: int = 0
    num_frames: int = 0
    sample_rate: float = 48000.0


@dataclass(frozen=True)
class AudioBuffer:
    """[channels, frames] float32 tensor + sample rate."""
    data: torch.Tensor = field(
        default_factory=lambda: torch.zeros((0, 0), dtype=torch.float32))
    sample_rate: float = 48000.0

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def num_channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def num_frames(self) -> int:
        return int(self.data.shape[1])

    @property
    def length(self) -> float:
        """Length in seconds."""
        return self.num_frames / self.sample_rate

    def get_format(self) -> AudioFormat:
        return AudioFormat(self.num_channels, self.num_frames,
                           float(self.sample_rate))

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.sample_rate <= 0)

    def is_nan_or_inf(self) -> bool:
        if self.is_null():
            return False
        return bool((~torch.isfinite(self.data)).any())

    def time_to_frame(self, t: float) -> int:
        return int(round(t * self.sample_rate))

    def frame_to_time(self, f: int) -> float:
        return f / self.sample_rate

    def print_summary(self) -> None:
        print(f"Audio: channels={self.num_channels} frames={self.num_frames} "
              f"sample_rate={self.sample_rate} length={self.length:.3f}s")

    def get_sample(self, channel: int, frame: int) -> float:
        """One sample, read back to the host (not for hot paths)."""
        return float(self.data[channel, frame])

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()
