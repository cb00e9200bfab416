"""PVBuffer: phase-vocoder (time x frequency) container (counterpart of
flan_tpu/core/pv_buffer.py; reference: src/flan/PV/PVBuffer.h).

Structure of arrays: mag and freq are two [channels, frames, bins] float32
tensors on one device. The integer hop is stored (it is exact); the
analysis rate and dft size are derived.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class PVFormat:
    """Static format info (reference PVBuffer::Format, PVBuffer.h:43-52)."""
    num_channels: int = 0
    num_frames: int = 0
    num_bins: int = 0
    sample_rate: float = 48000.0
    hop_size: int = 128
    window_size: int = 2048

    @property
    def analysis_rate(self) -> float:
        return self.sample_rate / self.hop_size

    @property
    def dft_size(self) -> int:
        return 2 * (self.num_bins - 1)


def _empty_planes() -> torch.Tensor:
    return torch.zeros((0, 0, 0), dtype=torch.float32)


@dataclass(frozen=True)
class PVBuffer:
    """SoA phase-vocoder buffer: mag, freq [channels, frames, bins]."""
    mag: torch.Tensor = field(default_factory=_empty_planes)
    freq: torch.Tensor = field(default_factory=_empty_planes)
    sample_rate: float = 48000.0
    hop_size: int = 128
    window_size: int = 2048

    @property
    def device(self) -> torch.device:
        return self.mag.device

    @property
    def num_channels(self) -> int:
        return int(self.mag.shape[0])

    @property
    def num_frames(self) -> int:
        return int(self.mag.shape[1])

    @property
    def num_bins(self) -> int:
        return int(self.mag.shape[2])

    @property
    def analysis_rate(self) -> float:
        """PV frames per second (reference PVBuffer.h:49)."""
        return self.sample_rate / self.hop_size

    @property
    def dft_size(self) -> int:
        return 2 * (self.num_bins - 1)

    @property
    def length(self) -> float:
        return self.num_frames / self.analysis_rate

    @property
    def bin_width(self) -> float:
        """Hz per bin = sample_rate / dft_size."""
        return self.sample_rate / self.dft_size

    def get_format(self) -> PVFormat:
        return PVFormat(self.num_channels, self.num_frames, self.num_bins,
                        float(self.sample_rate), self.hop_size,
                        self.window_size)

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.num_bins == 0 or self.sample_rate <= 0)

    def is_nan_or_inf(self) -> bool:
        if self.is_null():
            return False
        return bool((~torch.isfinite(self.mag)).any()
                    | (~torch.isfinite(self.freq)).any())

    def frame_to_time(self, f) -> float:
        return f / self.analysis_rate

    def time_to_frame(self, t) -> float:
        return t * self.analysis_rate

    def bin_to_frequency(self, b) -> float:
        return b * self.bin_width

    def frequency_to_bin(self, f) -> float:
        return f / self.bin_width

    @property
    def max_frequency(self) -> float:
        return self.bin_to_frequency(self.num_bins - 1)

    def print_summary(self) -> None:
        print(f"PV: channels={self.num_channels} frames={self.num_frames} "
              f"bins={self.num_bins} sample_rate={self.sample_rate} "
              f"hop={self.hop_size} window={self.window_size}")

    def get_max_partial_magnitude(self, start_frame: int = 0,
                                  end_frame: int = 0, start_bin: int = 0,
                                  end_bin: int = 0) -> float:
        """Max |magnitude| over a window of frames and bins, an end of 0
        meaning the last (reference PVBuffer.h:164-171)."""
        if self.is_null():
            return 0.0
        ef = end_frame if end_frame != 0 else self.num_frames
        eb = end_bin if end_bin != 0 else self.num_bins
        return float(self.mag[:, start_frame:ef, start_bin:eb].abs().max())

    def get_MF(self, channel: int, frame: int, b: int):
        """(magnitude, frequency) of one bin, read back to the host."""
        return (float(self.mag[channel, frame, b]),
                float(self.freq[channel, frame, b]))

    def to_numpy(self):
        return (self.mag.detach().cpu().numpy(),
                self.freq.detach().cpu().numpy())
