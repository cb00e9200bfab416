"""The port's two user paths end to end against flan_tpu on the CPU:
the PV time-stretch class path and the SPV round trip, plus WAV file I/O
and the rule that the port never imports jax.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.io.wav import read_wav as jax_pkg_read_wav
from flan_tpu_torch.convert import audio_from_numpy, pv_from_numpy
from flan_tpu_torch.io.wav import write_wav
from flan_tpu_torch.ops import stft


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stereo(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / SR
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n),
        0.4 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n),
    ]).astype(np.float32)


def _aligned_snr(a, y, guard):
    """SNR of y against a after cross-correlation alignment (the SPV
    synthesis has a group delay); as tests/test_spv_pallas.py."""
    xa, ya = a[guard:-guard], y[guard:-guard]
    n2 = 1 << 12
    xc = np.fft.irfft(np.fft.rfft(xa, n2).conj() * np.fft.rfft(ya, n2), n2)
    lag = int(np.argmax(xc))
    if lag > n2 // 2:
        lag -= n2
    if lag >= 0:
        xa2, ya2 = xa[: len(xa) - lag], ya[lag:lag + len(xa)]
    else:
        xa2, ya2 = xa[-lag:], ya[: len(xa) + lag]
    m = min(len(xa2), len(ya2))
    err = ((xa2[:m] - ya2[:m]) ** 2).mean()
    return 10 * np.log10((xa2[:m] ** 2).mean() / max(err, 1e-30))


def test_stretch_class_path_matches_flan_tpu():
    x = _stereo(6000)
    want = np.array(flan_tpu.Audio.create_from_array(x, SR)
                    .convert_to_PV(512, 64, 512).stretch(2.0)
                    .convert_to_audio().data)
    pv = (flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu")
          .convert_to_PV(512, 64, 512).stretch(2.0))
    got = pv.convert_to_audio().to_numpy()
    assert got.shape == want.shape
    assert abs(got.shape[1] - 2 * x.shape[1]) <= 2 * 64
    assert np.isfinite(got).all()
    # Measured: 3.9e-4 of the peak. The difference is the JAX package's
    # float32 mod-1 cycle sums in the inverse: on the same stretched planes
    # they are 4.5e-4 of the peak off a float64 inverse, the port's 1.9e-5.
    # The input is seeded and both sides deterministic; bound 1.27x that.
    assert np.abs(got - want).max() < 5e-4 * np.abs(want).max()
    # the port against a float64 inverse of its own planes (measured
    # 1.9e-5; bound about 5x)
    exact = stft.pv_inverse(pv.mag.double(), pv.freq.double(),
                            window_size=512, hop=64, sample_rate=SR).numpy()
    assert np.abs(got - exact).max() < 1e-4 * np.abs(exact).max()


def test_spv_round_trip_matches_flan_tpu():
    x = _stereo(2048)[:1]
    ja = flan_tpu.Audio.create_from_array(x, SR).convert_to_SPV(128)
    jm, jf = (np.array(a) for a in (ja.mag, ja.freq))
    want = np.array(ja.convert_to_audio().data)
    spv = audio_from_numpy(x, SR, device="cpu").convert_to_SPV(128)
    got = spv.convert_to_audio().to_numpy()
    scale = np.abs(jm).max()
    assert np.abs(spv.to_numpy()[0] - jm).max() < 1e-5 * scale
    assert got.shape == want.shape == x.shape
    # forward frequencies differ by < 0.1 Hz on live bins and the inverse
    # integrates them into phase over every sample, so the whole round trip
    # is held looser than the inverse alone (1e-4, tests/test_torch_spv.py):
    # measured 1.1e-4 of the peak, bound 1.8x that
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()
    # the same round-trip quality as the JAX package (the representation's
    # own floor, not the port's)
    snr, snr_jax = (_aligned_snr(x[0], y[0], 2 * 128) for y in (got, want))
    assert snr > 10.0 and abs(snr - snr_jax) < 1.0


def test_state_carries_across_from_flan_tpu():
    x = _stereo(3000)
    jpv = flan_tpu.Audio.create_from_array(x, SR).convert_to_PV(256, 64, 512)
    pv = pv_from_numpy(np.array(jpv.mag), np.array(jpv.freq), SR, 64, 256,
                       device="cpu")
    assert (pv.num_channels, pv.num_frames, pv.num_bins) == (
        jpv.num_channels, jpv.num_frames, jpv.num_bins)
    assert pv.dft_size == 512 and pv.bin_width == jpv.bin_width
    want = np.array(jpv.stretch(1.5).convert_to_audio().data)
    got = pv.stretch(1.5).convert_to_audio().to_numpy()
    # the inverse's float32 cycle sums, as in the stretch test above:
    # measured 1.7e-4 of the peak, bound 1.8x that
    assert np.abs(got - want).max() < 3e-4 * np.abs(want).max()
    with pytest.raises(ValueError):
        pv_from_numpy(np.zeros((2, 3)), np.zeros((2, 3)), SR, 64, 256,
                      device="cpu")


def test_null_objects_propagate():
    null = flan_tpu_torch.Audio.create_null()
    assert null.is_null() and null.convert_to_PV().is_null()
    assert null.convert_to_SPV(16).is_null()
    assert flan_tpu_torch.PV.create_null().stretch(2.0).is_null()
    assert flan_tpu_torch.PV.create_null().convert_to_audio().is_null()
    assert flan_tpu_torch.SPV.create_null().convert_to_audio().is_null()


def test_wav_round_trip(tmp_path):
    x = _stereo(1000)
    strings = flan_tpu_torch.SndfileStrings(title="t", artist="a")
    path = str(tmp_path / "x.wav")
    flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu").save_to_file(
        path, strings)
    back, got_strings = flan_tpu_torch.Audio.load_from_file(
        path, return_strings=True, device="cpu")
    assert back.sample_rate == SR and got_strings == strings
    assert np.array_equal(back.to_numpy(), x)
    # the JAX package's codec reads the port's file to the same samples
    assert np.array_equal(jax_pkg_read_wav(path)[0], x)


@pytest.mark.parametrize("bits,step", [(16, 2.0 ** -15), (24, 2.0 ** -23),
                                       (32, 2.0 ** -31)])
def test_wav_pcm_round_trip(tmp_path, bits, step):
    x = np.clip(_stereo(500), -1.0, 1.0)
    path = str(tmp_path / f"pcm{bits}.wav")
    write_wav(path, x, SR, bits=bits, float_format=False)
    back = flan_tpu_torch.Audio.load_from_file(path, device="cpu").to_numpy()
    assert np.abs(back - x).max() <= step
    assert np.array_equal(back, jax_pkg_read_wav(path)[0])


def test_load_rejects_other_formats(tmp_path):
    """A file no codec reads is refused by the WAV reader, and a file
    whose magic names another codec by that codec (the port read WAV only
    until the codecs came: tests/test_torch_codecs.py holds them)."""
    path = tmp_path / "x.bin"
    path.write_bytes(b"NOPE" + bytes(64))
    with pytest.raises(ValueError, match="WAV"):
        flan_tpu_torch.Audio.load_from_file(str(path), device="cpu")
    path = tmp_path / "x.flac"
    path.write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(ValueError, match="flac"):
        flan_tpu_torch.Audio.load_from_file(str(path), device="cpu")


def test_create_from_array_keeps_a_tensor_device():
    t = torch.zeros(5)
    a = flan_tpu_torch.Audio.create_from_array(t, SR)
    assert a.device == t.device and a.data.shape == (1, 5)


def test_port_never_imports_jax():
    code = ("import sys, flan_tpu_torch, flan_tpu_torch.convert; "
            "a = flan_tpu_torch.Audio.create_from_array([0.1] * 900, "
            "8000.0, device='cpu'); "
            "a.convert_to_PV(256, 64, 256).stretch(2.0).convert_to_audio(); "
            "sq = a.convert_to_SQPV((100.0, 3000.0), 6.0); "
            "sq.repitch(1.5).select(0.05, lambda t, p: t)"
            ".convert_to_audio(); "
            "a.convert_to_ms_SPV(16).repitch(2.0).convert_to_lr_audio(); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'flan_tpu' or m.startswith('flan_tpu.') "
            "for m in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
