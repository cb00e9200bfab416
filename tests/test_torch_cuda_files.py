"""The file surface on the card: the codecs' reads onto the card, the
prefetching loader's stream hand-off (io/loader.py), the PV render's
device-independent pixels (graph/conversions.py) and C.21's case, a
swept frequency written as a division, card against CPU.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_files.py
"""
import math

import numpy as np
import pytest
import torch

from flan_tpu_torch import Audio, Function
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.io.loader import iter_audio_prefetched
from flan_tpu_torch.ops.stft import cpu_exact
from flan_tpu_torch.utils.geometry import Rect

SR = 48000.0
# C.21: a 10 s sine swept 220 -> 253 Hz at oversample 16, card against
# CPU, times the peak. Both sweeps must sit within the bound phase 11 of
# chip_smoke.py holds every synthesis call to; the division-written one
# read 1.3e-3 before Function handed its callables a TrueDivGrid (PERF.md
# §6, PR 15)
TOL_SWEEP = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _stereo(seconds, seed=0):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return np.stack([0.4 * np.sin(2 * np.pi * (330.0 + 110.0 * c) * t)
                     + 0.05 * rng.standard_normal(n)
                     for c in range(2)]).astype(np.float32)


def _sine(p):
    return cpu_exact(torch.sin, 2.0 * math.pi * p)


SWEEPS = {
    "divide": lambda t: 220.0 + 2000.0 * t / 600.0,
    "multiply": lambda t: 220.0 + t * (2000.0 / 600.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("written", sorted(SWEEPS))
def test_swept_sine_card_against_cpu(cuda_device, written):
    """C.21: the division-written sweep samples the CPU's frequencies on
    the card (Function's TrueDivGrid) and lands within the multiply-written
    sweep's distance."""
    f = SWEEPS[written]
    n = int(10.0 * SR * 16)
    grid_card = Function(f).sample_device(n, 1.0 / (SR * 16), cuda_device)
    grid_cpu = Function(f).sample_device(n, 1.0 / (SR * 16), "cpu")
    assert torch.equal(grid_card.cpu(), grid_cpu)
    card = Audio.synthesize_waveform(_sine, 10.0, f, SR, 16,
                                     device=cuda_device).to_numpy()
    cpu = Audio.synthesize_waveform(_sine, 10.0, f, SR, 16,
                                    device="cpu").to_numpy()
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"C.21 {written}: {err:.3e} of the peak")
    assert err < TOL_SWEEP


@pytest.mark.cuda
@pytest.mark.parametrize("ext", ["wav", "flac", "aiff", "au", "caf", "w64"])
def test_load_onto_the_card_gives_the_files_bits(cuda_device, tmp_path, ext):
    x = _stereo(2.0)
    p = str(tmp_path / f"x.{ext}")
    Audio.create_from_array(x, SR, device=cuda_device).save_to_file(p)
    card = Audio.load_from_file(p, device=cuda_device)
    cpu = Audio.load_from_file(p, device="cpu")
    assert card.device.type == "cuda"
    assert torch.equal(card.data.cpu(), cpu.data)


@pytest.mark.cuda
@pytest.mark.parametrize("consumer_stream", ["default", "side"])
def test_loader_hands_clips_over_between_streams(cuda_device, tmp_path,
                                                 consumer_stream):
    """Six 20 s clips, two staged ahead: each clip's first use on the
    consumer's stream (a sum, then a copy out) reads the whole copy. The
    consumer runs on the default stream or on a stream of its own."""
    paths, sums = [], []
    for i in range(6):
        x = _stereo(20.0, seed=i)
        p = str(tmp_path / f"c{i}.wav")
        Audio.create_from_array(x, SR, device="cpu").save_to_file(p)
        paths.append(p)
        sums.append(x)
    stream = (torch.cuda.current_stream(cuda_device)
              if consumer_stream == "default"
              else torch.cuda.Stream(cuda_device))
    got = []
    with torch.cuda.stream(stream):
        for p, clip in iter_audio_prefetched(paths, depth=2,
                                             device=cuda_device):
            assert clip.device.type == "cuda"
            total = clip.data.double().sum()
            got.append((p, total, clip.data.clone()))
    torch.cuda.synchronize()
    assert [p for p, _, _ in got] == paths
    for (_, total, data), x in zip(got, sums):
        assert torch.equal(data.cpu(), torch.from_numpy(x))
        assert float(total) == pytest.approx(float(x.astype(np.float64)
                                                   .sum()), abs=1e-6)


@pytest.mark.cuda
def test_an_abandoned_card_loader_joins(cuda_device, tmp_path):
    import threading
    p = str(tmp_path / "c.wav")
    Audio.create_from_array(_stereo(5.0), SR, device="cpu").save_to_file(p)
    before = {t.ident for t in threading.enumerate()}
    it = iter_audio_prefetched([p] * 6, depth=1, device=cuda_device)
    next(it)
    started = [t for t in threading.enumerate() if t.ident not in before]
    it.close()
    for t in started:
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.cuda
@pytest.mark.parametrize("domain,ticks", [(None, 0.0),
                                          (Rect(1.0, 100.0, 8.0, 6000.0),
                                           8.0)])
def test_pv_render_on_the_card_equals_the_cpus(cuda_device, domain, ticks):
    """A 10 s stereo PV on the card and the same planes on the CPU render
    the same pixels; only the gathered values cross to the host."""
    pv = Audio.create_from_array(_stereo(10.0), SR, device=cuda_device
                                 ).convert_to_PV(2048, 128, 4096)
    m, f = pv.to_numpy()
    pv_cpu = pv_from_numpy(m, f, SR, 128, 2048, device="cpu")
    got = pv.convert_to_graph(domain, 1024, 512, ticks).to_uint8()
    want = pv_cpu.convert_to_graph(domain, 1024, 512, ticks).to_uint8()
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_spectrum_graph_on_the_card_is_close_to_the_cpus(cuda_device):
    """The smoothed spectrum's rFFT and convolution run on the card: its
    pixels against the CPU's render (cuFFT and the CPU's FFT differ by
    ulps, which can move a column's level by a pixel; bound 1% of the
    pixels, as tests/test_algo_golden.py holds the JAX package's render to
    the reference's)."""
    x = _stereo(10.0)
    card = Audio.create_from_array(x, SR, device=cuda_device)
    cpu = Audio.create_from_array(x, SR, device="cpu")
    got = card.convert_to_spectrum_graph(1024, 512).to_uint8()
    want = cpu.convert_to_spectrum_graph(1024, 512).to_uint8()
    assert (got != want).any(axis=-1).mean() < 0.01
