"""SPV: sliding-DFT phase vocoder, one spectral frame per audio sample
(counterpart of flan_tpu/spv/spv.py; reference: src/flan/SPV/SPVBuffer.h,
Conversions/AudioSPV.cpp).

The transforms dispatch by device (ops/spv_kernels.py): the Hopper kernels
for CUDA tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func.function import as_function2d
from flan_tpu_torch.ops.spv_kernels import spv_forward, spv_inverse
from flan_tpu_torch.ops.stft import true_div


def _empty_planes() -> torch.Tensor:
    return torch.zeros((0, 0, 0), dtype=torch.float32)


@dataclass(frozen=True)
class SPV:
    """Per-sample spectral data, SoA mag/freq [C, F, B] float32."""
    mag: torch.Tensor = field(default_factory=_empty_planes)
    freq: torch.Tensor = field(default_factory=_empty_planes)
    sample_rate: float = 48000.0

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
        return self.sample_rate

    @property
    def bin_width(self) -> float:
        return self.sample_rate / (2 * self.num_bins)

    def bin_to_frequency(self, b) -> float:
        return b * self.bin_width

    def frequency_to_bin(self, f) -> float:
        return f / self.bin_width

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.num_bins == 0 or self.sample_rate <= 0)

    @staticmethod
    def create_null() -> "SPV":
        return SPV()

    def copy(self) -> "SPV":
        return dataclasses.replace(self)

    def to_numpy(self):
        return (self.mag.detach().cpu().numpy(),
                self.freq.detach().cpu().numpy())

    # --- Algorithms (reference SPV.cpp:21-44) -------------------------------
    def modify_frequency(self, mod) -> "SPV":
        """Map each frame's frequencies through mod(time, frequency)."""
        if self.is_null():
            return SPV.create_null()
        fn = as_function2d(mod)
        t = true_div(float_iota(self.num_frames,
                                device=self.device)[None, :, None],
                     self.sample_rate)
        tt = torch.broadcast_to(t, self.freq.shape)
        new_freq = torch.broadcast_to(
            torch.as_tensor(fn(tt, self.freq), dtype=torch.float32,
                            device=self.device), self.freq.shape)
        return dataclasses.replace(self, freq=new_freq.contiguous())

    def repitch(self, factor) -> "SPV":
        """Scale each frequency by factor(time, frequency) (SPV.cpp:41-44)."""
        fn = as_function2d(factor)
        return self.modify_frequency(lambda t, f: f * fn(t, f))

    # --- Conversions (reference AudioSPV.cpp:113-150) -----------------------
    def convert_to_audio(self):
        """Phase accumulation + alternating-sign real-part sum (reference
        AudioSPV.cpp:113-150)."""
        from flan_tpu_torch.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        data = spv_inverse(self.mag, self.freq, self.sample_rate)
        return Audio(data=data, sample_rate=self.sample_rate)

    def convert_to_lr_audio(self):
        """Inverse, then mid/side back to left/right."""
        return self.convert_to_audio().convert_to_left_right()


__all__ = ["SPV", "spv_forward", "spv_inverse"]
