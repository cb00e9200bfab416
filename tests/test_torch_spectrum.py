"""flan_tpu_torch's Spectrum (spectrum.py) and Audio.convert_to_spectrum
against flan_tpu's on the CPU, on tones and noise made with numpy from a
seed at 8 kHz. Every tolerance names the reading it was set from.
"""
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.spectrum import Spectrum as JSpectrum
from flan_tpu_torch import Spectrum


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0

# the spectrum (and a filtered one) against flan_tpu's, times its peak: 0 to
# 1.0e-7 read (torch's and XLA's CPU FFTs round alike to within an ulp of
# the peak); bound 1e-6
TOL_SPECTRUM = 1e-6
# the inverse against flan_tpu's, times the signal's peak: 0 to 6.4e-7
# read (3,001 frames); bound 2e-6
TOL_INVERSE = 2e-6


def _signal(n, channels=2, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return np.stack([0.5 * np.sin(2 * np.pi * (440.0 + 300.0 * c) * t)
                     + 0.1 * rng.standard_normal(n)
                     for c in range(channels)]).astype(np.float32)


def _pair(x):
    return (flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
            flan_tpu.Audio.create_from_array(x, SR))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n,channels", [(4096, 2), (3001, 1), (2, 1)])
def test_spectrum_and_inverse_match_flan_tpu(n, channels):
    a, j = _pair(_signal(n, channels, seed=n))
    s, sj = a.convert_to_spectrum(), j.convert_to_spectrum()
    assert isinstance(s, Spectrum) and s.data.dtype == torch.complex64
    assert (s.num_channels, s.num_bins) == (sj.num_channels, sj.num_bins)
    assert s.sample_rate == sj.sample_rate == SR
    assert _rel(s.data.numpy(), np.array(sj.data)) < TOL_SPECTRUM
    back, back_j = s.convert_to_audio(), sj.convert_to_audio()
    assert back.data.dtype == torch.float32
    assert _rel(back.to_numpy(), np.array(back_j.data)) < TOL_INVERSE
    assert s.get_max_spectra_magnitude() == pytest.approx(
        sj.get_max_spectra_magnitude(), rel=1e-6)
    assert s.frequency_to_bin() == sj.frequency_to_bin()
    assert s.bin_to_frequency() == sj.bin_to_frequency()


def test_round_trip_is_identity_on_even_lengths():
    x = _signal(4096)
    a = flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu")
    np.testing.assert_allclose(
        a.convert_to_spectrum().convert_to_audio().to_numpy(), x, atol=1e-5)


@pytest.mark.parametrize("filter_channels", [1, 2])
def test_multiply_matches_flan_tpu(filter_channels):
    """A brick-wall mask (host numpy, as the CLI's eq builds it) and a
    random complex filter: the products are flan_tpu's."""
    a, j = _pair(_signal(2048, seed=5))
    s, sj = a.convert_to_spectrum(), j.convert_to_spectrum()
    rng = np.random.default_rng(filter_channels)
    f = (rng.standard_normal((filter_channels, s.num_bins))
         + 1j * rng.standard_normal((filter_channels, s.num_bins))
         ).astype(np.complex64)
    f[:, ::3] = 0
    got = s.multiply(Spectrum(data=f, sample_rate=SR))
    want = sj.multiply(JSpectrum(data=f, sample_rate=SR))
    assert _rel(got.data.numpy(), np.array(want.data)) < TOL_SPECTRUM
    got_t = s.multiply(Spectrum(data=torch.from_numpy(f), sample_rate=SR))
    np.testing.assert_array_equal(got_t.data.numpy(), got.data.numpy())


def test_multiply_refuses_what_flan_tpu_refuses():
    a, j = _pair(_signal(512))
    s, sj = a.convert_to_spectrum(), j.convert_to_spectrum()
    for shape in ((1, 7), (3, s.num_bins)):
        f = np.ones(shape, np.complex64)
        with pytest.raises(ValueError) as e:
            s.multiply(Spectrum(data=f, sample_rate=SR))
        with pytest.raises(ValueError) as ej:
            sj.multiply(JSpectrum(data=f, sample_rate=SR))
        assert str(e.value) == str(ej.value)


def test_null_spectra_propagate():
    a = flan_tpu_torch.Audio.create_from_array(_signal(512), SR,
                                               device="cpu")
    s = a.convert_to_spectrum()
    assert s.multiply(Spectrum()).is_null()
    assert Spectrum().multiply(s).is_null()
    assert flan_tpu_torch.Audio.create_null().convert_to_spectrum().is_null()
    assert Spectrum().convert_to_audio().is_null()
    assert Spectrum().get_max_spectra_magnitude() == 0.0
