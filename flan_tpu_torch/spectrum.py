"""Spectrum: whole-signal complex-spectrum container (flan_tpu/spectrum.py).

The reference's Spectrum type is dormant (every line of
src/flan/Spectrum/Spectrum.h and SpectrumBuffer.cpp is commented out);
the JAX package activates the container and every method the commented
code sketches: convert_to_audio and multiply (Spectrum.h:14,18), the
bin/frequency maps and the max-magnitude query (SpectrumBuffer.h:33-36).
As there, convert_to_audio uses the normalized inverse (the sketch's FFTW
c2r is unnormalized, Spectrum.cpp:31), so from_audio round-trips to
identity. The transforms are torch.fft's on the data's device: the JAX
package computes them with jnp.fft outside any Pallas kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class Spectrum:
    """[channels, bins] complex64 spectrum of a whole signal."""
    data: torch.Tensor = field(
        default_factory=lambda: torch.zeros((0, 0), dtype=torch.complex64))
    sample_rate: float = 48000.0

    @property
    def num_channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def num_bins(self) -> int:
        return int(self.data.shape[1])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_null(self) -> bool:
        return self.num_channels == 0 or self.num_bins == 0

    @staticmethod
    def from_audio(audio) -> "Spectrum":
        if audio.is_null():
            return Spectrum(sample_rate=float(audio.sample_rate))
        return Spectrum(data=torch.fft.rfft(audio.data, dim=-1),
                        sample_rate=float(audio.sample_rate))

    def convert_to_audio(self):
        """Normalized inverse rFFT to 2*(bins-1) samples per channel
        (reference sketch: Spectrum.cpp:10-43)."""
        from flan_tpu_torch.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        return Audio(data=torch.fft.irfft(self.data, dim=-1).to(
            torch.float32).contiguous(), sample_rate=self.sample_rate)

    def frequency_to_bin(self) -> float:
        """Bins per Hz, exactly the sketched scalar num_bins/sample_rate
        (SpectrumBuffer.cpp:45-48)."""
        return float(self.num_bins) / float(self.sample_rate)

    def bin_to_frequency(self) -> float:
        """Hz per bin - reciprocal of frequency_to_bin
        (SpectrumBuffer.cpp:41-44)."""
        return 1.0 / self.frequency_to_bin()

    def get_max_spectra_magnitude(self) -> float:
        """Largest |bin| over all channels (SpectrumBuffer.cpp:49-54)."""
        if self.is_null():
            return 0.0
        return float(torch.max(torch.abs(self.data)))

    def multiply(self, filter: "Spectrum") -> "Spectrum":
        """Bin-wise complex product - spectral filtering, the algorithm
        sketched at Spectrum.h:18. A mono filter broadcasts over this
        spectrum's channels; bin counts must match. A filter given as
        host data goes to this spectrum's device."""
        if self.is_null() or filter.is_null():
            return Spectrum(sample_rate=self.sample_rate)
        if filter.num_bins != self.num_bins:
            raise ValueError(
                f"bin count mismatch: {self.num_bins} vs "
                f"{filter.num_bins}")
        if filter.num_channels not in (1, self.num_channels):
            raise ValueError(
                f"channel count mismatch: {self.num_channels} vs "
                f"{filter.num_channels}")
        return Spectrum(data=self.data * torch.as_tensor(filter.data,
                                                         device=self.device),
                        sample_rate=self.sample_rate)
