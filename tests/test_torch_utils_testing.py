"""flan_tpu_torch.utils.testing, the reference's manual test oracles,
against flan_tpu.utils.testing on the same filters."""
import numpy as np
import pytest
import torch

from flan_tpu.graph.graph import Graph as JGraph
from flan_tpu.utils import testing as j_testing
from flan_tpu_torch import Audio
from flan_tpu_torch.graph.graph import Graph
from flan_tpu_torch.utils import testing


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements.
torch.set_num_threads(1)

PROBES = [100.0, 700.0, 1500.0, 3300.0]


def _lowpass(a):
    return a.filter_1pole_lowpass(1000.0, 2)


def test_frequency_response_1d_matches_flan_tpu():
    """A 2nd-order 1-pole lowpass at 1 kHz, probed at four frequencies:
    the gains within 1e-6 of the JAX package's (read 0 to 6e-8), falling
    through the cutoff."""
    got = testing.frequency_response_1d(_lowpass, freqs=PROBES, device="cpu")
    want = j_testing.frequency_response_1d(_lowpass, freqs=PROBES)
    assert got.shape == (4,)
    assert np.abs(got - want).max() <= 1e-6
    assert (np.diff(got) < 0).all()


def test_frequency_response_2d_matches_flan_tpu(monkeypatch):
    """White noise (the JAX package's draws) through the lowpass, rendered
    as a PV spectrogram, against the JAX package's render, its Graph given
    the port's C.1 repair (tests/test_torch_graph.py c1_repaired): the two
    filters part by float32 roundings, which move 62 of the 524,288 pixels
    by one level of 255; at most 0.1% may move, by one level."""
    monkeypatch.setattr(JGraph, "_row_float", Graph._row_float,
                        raising=False)
    for name in ("draw_horizontal_line", "draw_vertical_line",
                 "draw_line_segment"):
        monkeypatch.setattr(JGraph, name, getattr(Graph, name))
    got = testing.frequency_response_2d(_lowpass, seconds=0.5,
                                        device="cpu").to_uint8()
    want = j_testing.frequency_response_2d(_lowpass, seconds=0.5).to_uint8()
    assert got.shape == want.shape
    apart = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    assert apart.max() <= 1
    assert (apart > 0).sum() <= 1e-3 * apart.size


@pytest.mark.parametrize("hz", [220.0, 1000.0])
def test_spectrum_peak_hz_matches_flan_tpu(hz):
    import flan_tpu
    t = np.arange(8000, dtype=np.float32) / np.float32(8000.0)
    x = (0.5 * np.sin(2 * np.pi * hz * t))[None]
    got = testing.spectrum_peak_hz(
        Audio.create_from_array(x, 8000.0, device="cpu"), 1000, 4000)
    want = j_testing.spectrum_peak_hz(
        flan_tpu.Audio.create_from_array(x, 8000.0), 1000, 4000)
    assert got == want == hz
