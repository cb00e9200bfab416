"""SQPV: sliding constant-Q phase-vocoder buffer and algorithms
(counterpart of flan_tpu/sqpv/sqpv.py; reference: src/flan/SQPV/
SQPVBuffer.h:14-79, SQPVBuffer.cpp:17-31, and the dormant SQPV.cpp and
AudioSQPV.cpp, activated in the JAX package).

Data is SoA: magnitude and pitch (log2 |frequency|) planes, float32, and a
bool plane holding the sign of the frequency, each [C, F, B]. The
transforms dispatch by device (sqpv/transform.py): the Hopper kernels for
CUDA tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from flan_tpu_torch.core.types import DEFAULT_DEVICE, float_iota
from flan_tpu_torch.func.function import as_function2d
from flan_tpu_torch.ops.stft import cpu_exact, true_div
from flan_tpu_torch.sqpv.transform import sqpv_inverse


def _empty(dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((0, 0, 0), dtype=dtype)


@dataclass(frozen=True)
class SQPV:
    """Constant-Q spectral data: mag / pitch / positive [C, F, B]."""
    mag: torch.Tensor = field(default_factory=_empty)
    pitch: torch.Tensor = field(default_factory=_empty)
    positive: torch.Tensor = field(default_factory=lambda: _empty(torch.bool))
    sample_rate: float = 48000.0
    bins_per_octave: float = 24.0
    bandwidth: Tuple[float, float] = (16.0, 24000.0)

    # --- Info ----------------------------------------------------------------
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
    def q(self) -> float:
        """Cycles per analysis: 1 / (2^(1/bpo) - 1) (SQPVBuffer.cpp:22)."""
        return 1.0 / (2.0 ** (1.0 / self.bins_per_octave) - 1.0)

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.num_bins == 0 or self.sample_rate <= 0)

    # --- Unit conversions (reference SQPVBuffer.cpp) -------------------------
    def frequency_to_pitch(self, f) -> float:
        return math.log2(max(abs(f), 1e-12))

    def pitch_to_frequency(self, p) -> float:
        return 2.0 ** p

    @property
    def pitch_bandwidth(self) -> Tuple[float, float]:
        return (self.frequency_to_pitch(self.bandwidth[0]),
                self.frequency_to_pitch(self.bandwidth[1]))

    def pitch_to_bin(self, p) -> float:
        return (p - self.pitch_bandwidth[0]) * self.bins_per_octave

    def bin_to_pitch(self, b) -> float:
        return b / self.bins_per_octave + self.pitch_bandwidth[0]

    def frequency_to_bin(self, f) -> float:
        return self.pitch_to_bin(self.frequency_to_pitch(f))

    def bin_to_frequency(self, b) -> float:
        return self.pitch_to_frequency(self.bin_to_pitch(b))

    def bin_frequencies(self) -> np.ndarray:
        return np.asarray([self.bin_to_frequency(b)
                           for b in range(self.num_bins)])

    def get_period(self, b: int) -> int:
        """Frames per analysis at bin b (reference SQPVBuffer getPeriod)."""
        return int(math.ceil(self.q / self.bin_to_frequency(b)
                             * self.sample_rate))

    def time_to_frame(self, t) -> float:
        return t * self.sample_rate

    def frame_to_time(self, f) -> float:
        return f / self.sample_rate

    @staticmethod
    def num_bins_for(bandwidth: Tuple[float, float],
                     bins_per_octave: float) -> int:
        """ceil(frequency_to_bin(top)) (reference SQPVBuffer.cpp:21)."""
        lo = math.log2(bandwidth[0])
        hi = math.log2(bandwidth[1])
        return int(math.ceil((hi - lo) * bins_per_octave))

    @staticmethod
    def create(num_channels: int, num_frames: int,
               bins_per_octave: float = 24.0, sample_rate: float = 48000.0,
               bandwidth: Tuple[float, float] = (16.0, 24000.0),
               device=DEFAULT_DEVICE) -> "SQPV":
        """Zero magnitudes and pitches, positive signs, on `device`."""
        b = SQPV.num_bins_for(bandwidth, bins_per_octave)
        shape = (num_channels, num_frames, b)
        return SQPV(mag=torch.zeros(shape, device=device),
                    pitch=torch.zeros(shape, device=device),
                    positive=torch.ones(shape, dtype=torch.bool,
                                        device=device),
                    sample_rate=sample_rate,
                    bins_per_octave=bins_per_octave, bandwidth=bandwidth)

    @staticmethod
    def create_null() -> "SQPV":
        return SQPV()

    def _with(self, **kwargs) -> "SQPV":
        return dataclasses.replace(self, **kwargs)

    def copy(self) -> "SQPV":
        return self._with()

    def to_numpy(self):
        return tuple(a.detach().cpu().numpy()
                     for a in (self.mag, self.pitch, self.positive))

    def get_max_partial_magnitude(self) -> float:
        return 0.0 if self.is_null() else float(self.mag.abs().max())

    # --- Algorithms (activating the dormant reference SQPV/SQPV.cpp) ---------
    def _frame_times(self, num_frames: int) -> torch.Tensor:
        """Seconds of frames [0, num_frames) as float32 [1, F, 1]."""
        t = float_iota(num_frames, device=self.device)
        return true_div(t, self.sample_rate)[None, :, None]

    def modify_pitch(self, mod) -> "SQPV":
        """Replace each pitch with mod(time, pitch) (reference
        SQPV.cpp:71-89, dormant upstream)."""
        if self.is_null():
            return SQPV.create_null()
        fn = as_function2d(mod)
        tt = torch.broadcast_to(self._frame_times(self.num_frames),
                                self.pitch.shape)
        new_pitch = torch.broadcast_to(
            torch.as_tensor(fn(tt, self.pitch), dtype=torch.float32,
                            device=self.device), self.pitch.shape)
        return self._with(pitch=new_pitch.contiguous())

    def repitch(self, factor) -> "SQPV":
        """Scale each frequency by factor(time, pitch): a pitch offset of
        log2 |factor| (reference SQPV.h:24, dormant upstream; as the live
        SPV::repitch, SPV.cpp:41-44)."""
        fn = as_function2d(factor)
        return self.modify_pitch(
            lambda t, p: p + cpu_exact(torch.log2, torch.clamp(
                torch.as_tensor(fn(t, p), dtype=torch.float32,
                                device=p.device).abs(), min=1e-12)))

    def select(self, length: float, selector) -> "SQPV":
        """Gather frames through selector(time, pitch) -> selected time,
        interpolating magnitudes in time and keeping the dominant side's
        pitch and sign (reference SQPV.cpp:91-142, dormant upstream). As
        there, the pitch only chooses the source time (data stays in its
        bin), and selections out of range give zeros."""
        if self.is_null() or length <= 0:
            return SQPV.create_null()
        fn = as_function2d(selector)
        out_frames = int(length * self.sample_rate)
        shape = (1, out_frames, self.num_bins)
        pitches = torch.tensor(
            [self.bin_to_pitch(b) for b in range(self.num_bins)],
            dtype=torch.float32, device=self.device)[None, None, :]
        sel_t = torch.as_tensor(
            fn(torch.broadcast_to(self._frame_times(out_frames), shape),
               torch.broadcast_to(pitches, shape)),
            dtype=torch.float32, device=self.device)
        sel_frame = torch.broadcast_to(sel_t * self.sample_rate, shape)[0]
        lo = torch.floor(sel_frame)
        mix = sel_frame - lo
        valid = (sel_frame >= 0) & (sel_frame < self.num_frames - 1)
        lo_i = torch.clamp(lo, 0, self.num_frames - 1).to(torch.int64)
        hi_i = torch.clamp(lo_i + 1, max=self.num_frames - 1)
        size = (self.num_channels, out_frames, self.num_bins)

        def gather(plane, idx):
            return torch.gather(plane, 1, idx[None].expand(size))

        m_l, m_r = gather(self.mag, lo_i), gather(self.mag, hi_i)
        w1 = (1.0 - mix)[None] * m_l
        w2 = mix[None] * m_r
        vmask = valid[None].to(torch.float32)
        left_wins = w1 > w2
        pitch = torch.where(left_wins, gather(self.pitch, lo_i),
                            gather(self.pitch, hi_i)) * vmask
        positive = torch.where(left_wins, gather(self.positive, lo_i),
                               gather(self.positive, hi_i)) | ~valid[None]
        return self._with(mag=(w1 + w2) * vmask, pitch=pitch,
                          positive=positive)

    # --- Conversions (activating the dormant AudioSQPV.cpp inverse) ----------
    def convert_to_audio(self):
        from flan_tpu_torch.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        data = sqpv_inverse(self.mag, self.pitch, self.positive,
                            self.sample_rate, self.bins_per_octave,
                            self.bandwidth)
        return Audio(data=data, sample_rate=float(self.sample_rate))

    def convert_to_lr_audio(self):
        """Inverse, then mid/side back to left/right (reference
        AudioSQPV.cpp:167-170, dormant upstream)."""
        return self.convert_to_audio().convert_to_left_right()
