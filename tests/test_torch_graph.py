"""flan_tpu_torch's renderer (graph/graph.py) and conversions (graph/
conversions.py and the convert_to_graph / save_to_bmp family of Audio,
PV, SQPV, Function and Wavetable) on the CPU: every graph_* fixture of
the compiled reference pixel for pixel, graph_ticks.bmp included (C.1:
the JAX package's renderer misses it by 125 pixels, the port's hits it),
and every conversion pixel-equal to flan_tpu's render of the same input.
Inputs are made with numpy from a seed at small sizes.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu_torch.graph import conversions
from flan_tpu_torch.graph.graph import ALL_PLANES, Graph, WaveformMode
from flan_tpu_torch.utils.geometry import Color, Interval, Rect


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _load_bmp(path):
    """A 24-bit bottom-up BMP as top-down [H, W, 3] uint8 RGB."""
    b = open(path, "rb").read()
    off = int.from_bytes(b[10:14], "little")
    w = int.from_bytes(b[18:22], "little")
    h = int.from_bytes(b[22:26], "little")
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(b[off:off + stride * h], np.uint8).reshape(h, stride)
    return rows[::-1, :3 * w].reshape(h, w, 3)[:, :, ::-1]


# --- the compiled reference's goldens (tests/test_algo_golden.py:872-1044,
# the same scenes) ------------------------------------------------------

def _composite():
    g = Graph(120, 80)
    g.add_full_split_view_y(Rect(0, 0, 4, 2), 1)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.draw_linear_grid(1, 0.5, 0, Color.from_hsv(0, 0, 0.7))
    g.draw_point((2.0, 1.0), 6, 0, Color.from_hsv(120, 1, 1))
    g.draw_axes(0, Color.from_hsv(200, 1, 1))
    return g


def _rich():
    g = Graph(160, 120)
    g.add_full_split_view_y(Rect(-2, 0.1, 2, 100), 1)
    g.fill_image(Color.from_hsv(30, 0.2, 0.9))
    g.draw_log_grid_y(1, 10, 0, Color.from_hsv(0, 0, 0.55))
    g.draw_function(lambda x: 10.0 + 40.0 * x * x, Interval(-2, 2), 0,
                    Color.from_hsv(0, 1, 0.8))
    g.draw_function([(-1.5, 80.0), (0.0, 20.0), (1.5, 60.0)], plane=0,
                    color=Color.from_hsv(260, 1, 0.9))
    g.draw_float((-1.8, 90.0), 6, 10, -3.25, 0, Color.from_hsv(0, 0, 0.1))
    return g


def _waveform():
    t = np.arange(700, dtype=np.float64) / 700
    sig = (0.8 * np.sin(2.0 * np.pi * 13.0 * t)
           + 0.35 * np.sin(2.0 * np.pi * 47.0 * t + 0.9)).astype(np.float32)
    g = Graph(128, 96)
    g.add_full_split_view_y(Rect(0, -1, 1, 1), 2)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.draw_waveform(sig, Rect(0, -1, 1, 1), 0, Color.from_hsv(0, 0.8, 0.65),
                    WaveformMode.DIRECT, 4)
    g.draw_waveform(sig, Rect(0, -1, 1, 1), 1,
                    Color.from_hsv(180, 0.8, 0.65), WaveformMode.SYMMETRIC, 4)
    return g


def _waveform_fn():
    def f(x):
        x = np.asarray(x, np.float32)
        return (np.float32(1.6) * x * x - np.float32(0.8)).astype(np.float32)
    g = Graph(112, 80)
    g.add_full_split_view_y(Rect(0, -1, 1, 1), 2)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.draw_waveform(f, Rect(0, -1, 1, 1), ALL_PLANES,
                    Color.from_hsv(40, 0.8, 0.65), WaveformMode.DIRECT, 4)
    return g


def _spectrogram_fn():
    g = Graph(80, 56)
    g.add_full_split_view_y(Rect(0, 0, 1, 1), 1)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.draw_spectrogram(lambda x, y: (np.asarray(x, np.float32)
                                     * np.asarray(y, np.float32)),
                       Rect(0, 0, 1, 1), 0, 95.0, 4)
    return g


def _spectrogram():
    i = np.arange(40, dtype=np.float64)[:, None]
    j = np.arange(24, dtype=np.float64)[None, :]
    spec = (0.5 + 0.5 * np.sin(0.37 * i) * np.cos(0.61 * j)).astype(
        np.float32)
    g = Graph(96, 64)
    g.add_full_split_view_y(Rect(0, 0, 1, 1), 1)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.draw_spectrogram(spec, Rect(0, 0, 1, 1), 0, 220.7, 4)
    return g


def _ticks():
    g = Graph(140, 100)
    g.add_full_split_view_y(Rect(-3, -2, 9, 6), 2)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.draw_x_ticks(2.0, 6.0, 2.0, 8, 3, -1, Color.from_hsv(0, 0, 0.9), 8.0)
    g.draw_y_ticks(2.0, -3.0, 10.0, 2, 30, 1,
                   Color.from_hsv(120, 0.7, 0.8), 0.0)
    return g


def _audio_conv_signal():
    sr, n = 4000.0, 2000
    t = np.arange(n, dtype=np.float64) / sr
    sig = np.stack([(0.7 * np.sin(2 * np.pi * (50.0 + 30.0 * c) * t)
                     + 0.2 * np.sin(2 * np.pi * 523.0 * t + 0.3 * c))
                    for c in range(2)]).astype(np.float32)
    return sig, sr


def _audio_conv():
    sig, sr = _audio_conv_signal()
    a = flan_tpu_torch.Audio.create_from_array(sig, sr, device="cpu")
    return a.convert_to_graph(Interval(0.1, 0.35), 180, 110,
                              timeline_scale=8.0)


def _spectrum_signal():
    sr, n = 4000.0, 1500
    t = np.arange(n, dtype=np.float64) / sr
    return (0.6 * np.sin(2 * np.pi * 220.0 * t)
            + 0.3 * np.sin(2 * np.pi * 700.0 * t)
            + 0.1 * np.sin(2 * np.pi * 1500.0 * t)).astype(np.float32)[None], sr


def _spectrum_conv():
    sig, sr = _spectrum_signal()
    return flan_tpu_torch.Audio.create_from_array(
        sig, sr, device="cpu").convert_to_spectrum_graph(150, 100, 64)


def _golden_pvs():
    """(port PV on the CPU, JAX PV) of tests/test_algo_golden.py:54
    _input_pv, the hashed 2 x 24 x 17 planes."""
    from test_torch_pv_methods import input_pvs
    return input_pvs()


def _pv_conv():
    return _golden_pvs()[0].convert_to_graph(
        Rect(0.002, 300.0, 0.02, 1800.0), 120, 90, 6.0)


def _pv_conv_full():
    return _golden_pvs()[0].convert_to_graph(Rect(0, 0, -1, -1), 120, 90, 0.0)


GOLDENS = {
    "graph_composite": _composite, "graph_rich": _rich,
    "graph_waveform": _waveform, "graph_waveform_fn": _waveform_fn,
    "graph_spectrogram_fn": _spectrogram_fn,
    "graph_spectrogram": _spectrogram, "graph_ticks": _ticks,
    "graph_audio_conv": _audio_conv, "graph_spectrum_conv": _spectrum_conv,
    "graph_pv_conv": _pv_conv, "graph_pv_conv_full": _pv_conv_full,
}


def test_every_graph_fixture_has_a_scene():
    names = {f[:-4] for f in os.listdir(FIXDIR)
             if f.startswith("graph_") and f.endswith(".bmp")}
    assert names == set(GOLDENS)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_graph_fixture_pixel_exact(name):
    """The port's render equals the compiled reference's BMP pixel for
    pixel (graph_ticks: C.1, repaired in the port's _row_float)."""
    ref = _load_bmp(os.path.join(FIXDIR, name + ".bmp"))
    ours = GOLDENS[name]().to_uint8()
    assert ours.shape == ref.shape
    bad = np.argwhere((ours != ref).any(axis=-1))
    assert len(bad) == 0, f"{len(bad)} pixels differ, rows " \
                          f"{sorted(set(bad[:, 0].tolist()))[:10]}"


def test_saved_bmp_reads_back(tmp_path):
    g = _ticks()
    p = str(tmp_path / "t.bmp")
    g.save_image(p)
    np.testing.assert_array_equal(_load_bmp(p), g.to_uint8())


# --- each conversion against flan_tpu's render of the same input ----------

@pytest.fixture
def c1_repaired(monkeypatch):
    """flan_tpu's Graph with the port's C.1 repair: its three line
    primitives take their rows from the port's Graph._row_float. Without
    it, a render whose tick labels sit on a float32 row boundary differs
    from the port's there only (60 pixels of
    test_audio_convert_to_graph_matches_flan_tpu[args2])."""
    from flan_tpu.graph.graph import Graph as JGraph
    monkeypatch.setattr(JGraph, "_row_float", Graph._row_float,
                        raising=False)
    for name in ("draw_horizontal_line", "draw_vertical_line",
                 "draw_line_segment"):
        monkeypatch.setattr(JGraph, name, getattr(Graph, name))


def _same_pixels(ours, theirs):
    a, b = ours.to_uint8(), theirs.to_uint8()
    assert a.shape == b.shape
    assert int((a != b).any(axis=-1).sum()) == 0


def _audios(x, sr):
    return (flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu"),
            flan_tpu.Audio.create_from_array(x, sr))


def _noise_tone(channels=2, seconds=0.6, sr=8000.0, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.5 * np.sin(2 * np.pi * (300.0 + 200.0 * c) * t)
                     + 0.1 * rng.standard_normal(len(t))
                     for c in range(channels)]).astype(np.float32)


@pytest.mark.parametrize("args", [
    (), (Interval(0.1, 0.4), 200, 120, WaveformMode.DIRECT, 6.0),
    (None, 160, 90, WaveformMode.SYMMETRIC, 8.0)])
def test_audio_convert_to_graph_matches_flan_tpu(args, c1_repaired):
    a, j = _audios(_noise_tone(), 8000.0)
    _same_pixels(a.convert_to_graph(*args), j.convert_to_graph(*args))


@pytest.mark.parametrize("smoothing", [16, 128])
def test_audio_spectrum_graph_matches_flan_tpu(smoothing, c1_repaired):
    a, j = _audios(_noise_tone(seed=1), 8000.0)
    _same_pixels(a.convert_to_spectrum_graph(200, 120, smoothing),
                 j.convert_to_spectrum_graph(200, 120, smoothing))


@pytest.mark.parametrize("domain", [
    None, Rect(0.01, 200.0, 0.4, 2500.0), Rect(0.1, 0, -1, -1)])
def test_pv_convert_to_graph_matches_flan_tpu(domain, c1_repaired):
    x = _noise_tone(seed=2)
    a, j = _audios(x, 8000.0)
    pa = a.convert_to_PV(256, 32, 256)
    pj = flan_tpu.PV(mag=jnp.asarray(pa.mag.numpy()),
                     freq=jnp.asarray(pa.freq.numpy()), sample_rate=8000.0,
                     hop_size=32, window_size=256)
    _same_pixels(pa.convert_to_graph(domain, 240, 140, 6.0),
                 pj.convert_to_graph(domain, 240, 140, 6.0))


def test_pv_render_gathers_only_what_it_reads(monkeypatch, c1_repaired):
    """The PV render copies to the host only the magnitudes its subsamples
    read: at most one value per subsample position, never the plane."""
    pa, pj = _golden_pvs()
    copied = []
    gather = conversions.gather_to_host

    def spy(plane, i, j):
        out = gather(plane, i, j)
        copied.append(len(np.unique(i)) * len(np.unique(j)))
        return out
    monkeypatch.setattr(conversions, "gather_to_host", spy)
    _same_pixels(pa.convert_to_graph(None, 120, 90),
                 pj.convert_to_graph(None, 120, 90))
    assert len(copied) == 2 * 4          # two planes, 2 x 2 subsamples
    assert max(copied) <= 24 * 17


def test_sqpv_convert_to_graph_matches_flan_tpu(c1_repaired):
    rng = np.random.default_rng(3)
    shape = (2, 40, 30)
    mag = rng.random(shape).astype(np.float32) ** 2
    pitch = (rng.random(shape) * 10).astype(np.float32)
    pos = rng.random(shape) > 0.5
    kw = dict(sample_rate=8000.0, bins_per_octave=6.0,
              bandwidth=(100.0, 3000.0))
    a = flan_tpu_torch.SQPV(mag=torch.from_numpy(mag),
                            pitch=torch.from_numpy(pitch),
                            positive=torch.from_numpy(pos), **kw)
    j = flan_tpu.SQPV(mag=jnp.asarray(mag), pitch=jnp.asarray(pitch),
                      positive=jnp.asarray(pos), **kw)
    _same_pixels(a.convert_to_graph(160, 96), j.convert_to_graph(160, 96))


@pytest.mark.parametrize("fn,view,domain", [
    (lambda x: 0.5 * x * x - 2.0, None, None),
    (lambda x: 3.0 * x / 7.0 + 0.25, Rect(-2, -3, 4, 3), Interval(-1, 2.5)),
    ("sin", Rect(-6, -2, 6, 2), None)])
def test_function_convert_to_graph_matches_flan_tpu(fn, view, domain,
                                                    c1_repaired):
    if fn == "sin":
        f_port = flan_tpu_torch.Function(torch.sin)
        f_jax = flan_tpu.Function(jnp.sin)
    else:
        f_port, f_jax = flan_tpu_torch.Function(fn), flan_tpu.Function(fn)
    _same_pixels(f_port.convert_to_graph(view, domain, 150, 110),
                 f_jax.convert_to_graph(view, domain, 150, 110))


def test_wavetable_graph_matches_flan_tpu(tmp_path, c1_repaired):
    def wave(t):
        return 0.8 * torch.sin(2 * np.pi * t) * (0.5 + 0.1 * t)

    def jwave(t):
        return 0.8 * jnp.sin(2 * np.pi * t) * (0.5 + 0.1 * t)
    a = flan_tpu_torch.Wavetable.from_function(wave, 6, 256, 8000.0,
                                               device="cpu")
    j = flan_tpu.Wavetable.from_function(jwave, 6, 256, 8000.0)
    table = np.array(j.table)
    a.table = torch.from_numpy(table)     # one table: the render is held
    _same_pixels(a.graph_waveform_range(0, 1, 4),
                 j.graph_waveform_range(0, 1, 4))
    p = str(tmp_path / "w.bmp")
    a.save_waveform_range_to_bmp(p, 0, 1, 4)
    np.testing.assert_array_equal(_load_bmp(p),
                                  j.graph_waveform_range(0, 1, 4).to_uint8())


@pytest.mark.parametrize("kind", ["audio", "spectrum", "pv", "sqpv",
                                  "function"])
def test_save_to_bmp_writes_the_render(tmp_path, kind):
    x = _noise_tone(seconds=0.3)
    a = flan_tpu_torch.Audio.create_from_array(x, 8000.0, device="cpu")
    p = str(tmp_path / f"{kind}.bmp")
    if kind == "audio":
        a.save_to_bmp(p, None, 100, 60)
        g = a.convert_to_graph(None, 100, 60)
    elif kind == "spectrum":
        a.save_spectrum_to_bmp(p, 100, 60, 32)
        g = a.convert_to_spectrum_graph(100, 60, 32)
    elif kind == "pv":
        pv = a.convert_to_PV(256, 64, 256)
        pv.save_to_bmp(p, None, 100, 60)
        g = pv.convert_to_graph(None, 100, 60)
    elif kind == "sqpv":
        rng = np.random.default_rng(4)
        s = flan_tpu_torch.SQPV(
            mag=torch.from_numpy(rng.random((2, 30, 20)).astype(np.float32)),
            pitch=torch.zeros(2, 30, 20),
            positive=torch.ones(2, 30, 20, dtype=torch.bool),
            sample_rate=8000.0, bins_per_octave=6.0,
            bandwidth=(100.0, 3000.0))
        s.save_to_bmp(p, 100, 60)
        g = s.convert_to_graph(100, 60)
    else:
        f = flan_tpu_torch.Function(lambda t: t * t)
        f.save_to_bmp(p, None, None, 100, 60)
        g = f.convert_to_graph(None, None, 100, 60)
    np.testing.assert_array_equal(_load_bmp(p), g.to_uint8())


def test_null_objects_render_blank_graphs():
    assert flan_tpu_torch.Audio.create_null().convert_to_graph(
        None, 40, 30).to_uint8().max() == 0
    assert flan_tpu_torch.PV.create_null().convert_to_graph(
        None, 40, 30).to_uint8().max() == 0
