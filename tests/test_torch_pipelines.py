"""flan_tpu_torch's streamed pipelines against flan_tpu's on the CPU: the
host remap plan bit for bit, the stretch / repitch / morph outputs against
both of the JAX package's remap modes (static rows and dynamic), against
the port's own class path, across chunk sizes, and the device default.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu.pipelines.streamed as jst
from flan_tpu.pipelines import (pv_morph_pipeline as j_morph,
                                pv_repitch_pipeline as j_repitch,
                                pv_stretch_pipeline as j_stretch)
from flan_tpu_torch import Audio
from flan_tpu_torch.pipelines import streamed as tst
from flan_tpu_torch.pipelines import (pv_morph_pipeline, pv_repitch_pipeline,
                                      pv_stretch_pipeline)


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
KW = dict(window_size=512, hop=64, dft_size=512, sample_rate=SR)


def _signal(n=6000, channels=2, seed=0):
    """Two tones, the first in white noise, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t)
                  + 0.05 * rng.standard_normal(n),
                  0.3 * np.sin(2 * np.pi * 220 * t)]).astype(np.float32)
    return np.ascontiguousarray(x[:channels])


# ---------------------------------------------------------- the remap plan

class _Captured(Exception):
    pass


def _jax_plan(monkeypatch, run):
    """What flan_tpu's streamed_pv_process hands _streamed_scan in its
    dynamic mode: (i0, li, mix, valid, out_frames, chunk_out, max_hops).
    The spy stops the call before anything compiles."""
    seen = {}

    def spy(xs, plan, mix_s, **k):
        seen.update(plan=np.array(plan), mix=np.array(mix_s), **k)
        raise _Captured

    monkeypatch.setattr(jst, "_FORCE_DYNAMIC_REMAP", True)
    monkeypatch.setattr(jst, "_streamed_scan", spy)
    with pytest.raises(_Captured):
        run()
    chunk = seen["chunk_out"]
    plan = seen["plan"]
    return (plan[:, 0], plan[:, 1 + chunk:], seen["mix"],
            plan[:, 1:1 + chunk] != 0, seen["out_frames"], chunk,
            seen["max_hops_per_chunk"])


def _port_plan(monkeypatch, run):
    """The RemapPlan the port's pipeline hands its chunk loop."""
    seen = {}

    def spy(xs, plan, chunk_op, **k):
        seen["plan"] = plan
        raise _Captured

    monkeypatch.setattr(tst, "_run_chunks", spy)
    with pytest.raises(_Captured):
        run()
    p = seen["plan"]
    return (p.i0, p.li, p.mix, p.valid, p.out_frames, p.chunk_out,
            p.max_hops)


@pytest.mark.parametrize("case,n,chunk", [
    ("stretch_2", 40000, 256),       # constant 2x over several chunks
    ("stretch_1.5", 40000, 256),     # incommensurate: patterns alternate
    ("stretch_var", 20000, 64),      # a variable factor
    ("identity", 20000, 100)])       # the repitch / morph map
def test_remap_plan_matches_jax_bit_for_bit(monkeypatch, case, n, chunk):
    x = _signal(n)
    factor = {"stretch_2": 2.0, "stretch_1.5": 1.5,
              "stretch_var": lambda t: 1.0 + 0.5 * t}.get(case)
    kw = dict(KW, chunk_out=chunk)
    if case == "identity":
        j_run = lambda: j_repitch(x, 1.5, **kw)              # noqa: E731
        t_run = lambda: pv_repitch_pipeline(x, 1.5, device="cpu",  # noqa
                                            **kw)
    else:
        j_run = lambda: j_stretch(x, factor, **kw)           # noqa: E731
        t_run = lambda: pv_stretch_pipeline(x, factor,       # noqa: E731
                                            device="cpu", **kw)
    want = _jax_plan(monkeypatch, j_run)
    got = _port_plan(monkeypatch, t_run)
    names = ("i0", "li", "mix", "valid")
    assert want[0].shape[0] > 2, "the case must span several chunks"
    for name, w, g in zip(names, want[:4], got[:4]):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[4:] == want[4:]


def test_remap_plan_rejects_a_map_that_does_not_increase():
    with pytest.raises(ValueError):
        tst.remap_plan(np.array([1.0, 2.0, 2.0, 3.0]), 4, 16)


# ------------------------------------------------- the pipelines vs flan_tpu

def _amount_j(t, f):
    return jnp.clip(t / 0.5, 0.0, 1.0)


def _amount_t(t, f):
    return torch.clamp(t / 0.5, 0.0, 1.0)


def _step_j(t, f):
    return 1.25 + 0.25 * (t > 0.3)


def _step_t(t, f):
    return 1.25 + 0.25 * (t > 0.3).float()


def _smooth_j(t, f):
    return 1.2 + 0.3 * jnp.clip(t / 2.0, 0.0, 1.0)


def _smooth_t(t, f):
    return 1.2 + 0.3 * torch.clamp(t / 2.0, 0.0, 1.0)


# name -> (JAX call, port call, channels, chunk). The stepped repitch
# factor takes values whose bin-map sums are exact in float32 in any order;
# the smooth one is test_repitch_smooth_factor_matches_jax's.
CASES = {
    "stretch_2_stereo": (lambda x, **k: j_stretch(x, 2.0, **k),
                         lambda x, **k: pv_stretch_pipeline(x, 2.0, **k),
                         2, 32),
    "stretch_1.5_mono": (lambda x, **k: j_stretch(x, 1.5, **k),
                         lambda x, **k: pv_stretch_pipeline(x, 1.5, **k),
                         1, 16),
    "stretch_var_mono": (
        lambda x, **k: j_stretch(x, lambda t: 1.0 + 0.5 * t, **k),
        lambda x, **k: pv_stretch_pipeline(x, lambda t: 1.0 + 0.5 * t, **k),
        1, 16),
    "repitch_1.5_stereo": (lambda x, **k: j_repitch(x, 1.5, **k),
                           lambda x, **k: pv_repitch_pipeline(x, 1.5, **k),
                           2, 32),
    "repitch_step_mono": (lambda x, **k: j_repitch(x, _step_j, **k),
                          lambda x, **k: pv_repitch_pipeline(x, _step_t,
                                                             **k),
                          1, 32),
    "morph_stereo": (
        lambda x, **k: j_morph(x, x[::-1, :4000] * 0.8, _amount_j, **k),
        lambda x, **k: pv_morph_pipeline(
            x, np.ascontiguousarray(x[::-1, :4000]) * 0.8, _amount_t, **k),
        2, 32),
}


@pytest.fixture(scope="module")
def jax_outputs():
    """Each case through flan_tpu once in its static-row mode and once in
    its dynamic mode (one compile each)."""
    out = {}
    for name, (j_run, _, ch, chunk) in CASES.items():
        x = _signal(channels=ch)
        for dynamic in (False, True):
            jst._FORCE_DYNAMIC_REMAP = dynamic
            try:
                out[name, dynamic] = np.array(j_run(x, chunk_out=chunk, **KW))
            finally:
                jst._FORCE_DYNAMIC_REMAP = False
    return out


def _port(name, chunk=None):
    _, t_run, ch, c = CASES[name]
    return t_run(_signal(channels=ch), chunk_out=chunk or c, device="cpu",
                 **KW).numpy()


# Read on these signals (max / RMS of the difference, times the JAX peak,
# the same in both JAX modes): stretches up to 2.2e-3 / 1.0e-4 (the last
# window's weak bins; JAX's own streamed and class paths differ by 1.9e-3
# there), repitches up to 7.1e-3 / 3.5e-4, the morph 3.0e-3 / 3.3e-4. The
# sources: JAX's float32 mod-1 cycle sums (the port's are float64), XLA's
# reciprocal multiply where the port divides, and the repitch's endpoint
# pick, which compares two weights and so amplifies a rounding on a weak
# bin. Bounds about three times the readings.
TOL_MAX = {"stretch": 6e-3, "repitch": 2e-2, "morph": 1e-2}
TOL_RMS = 1e-3


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(jax_outputs, name, dynamic):
    want = jax_outputs[name, dynamic]
    got = _port(name)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    d = np.abs(got - want)
    print(f"{name} {dynamic}: max {d.max() / peak:.3g}, "
          f"rms {np.sqrt((d ** 2).mean()) / peak:.3g}")
    assert d.max() <= TOL_MAX[name.split("_")[0]] * peak
    assert np.sqrt((d ** 2).mean()) <= TOL_RMS * peak


def test_jax_remap_modes_agree(jax_outputs):
    """The JAX package's static and dynamic modes, which the port follows
    as one, give the same bits on these cases."""
    for name in CASES:
        np.testing.assert_array_equal(jax_outputs[name, False],
                                      jax_outputs[name, True], err_msg=name)


def test_repitch_smooth_factor_matches_jax():
    """A smooth factor: JAX sums the bin map in float32 by a parallel scan,
    the port in float64 (integrate_bins), so a few bin-map values round
    apart and move an endpoint pick (the reference's max-weight policy) by
    one bin: 22 of 24,158 PV cells on this signal, and none with JAX's bin
    map (test_torch_pv_methods.py). The audio then differs where those
    cells sound; read 7.0e-2 max and 1.7e-2 RMS of the peak, bounds 0.2
    and 5e-2."""
    x = _signal(channels=1)
    want = np.array(j_repitch(x, _smooth_j, chunk_out=32, **KW))
    got = pv_repitch_pipeline(x, _smooth_t, chunk_out=32, device="cpu",
                              **KW).numpy()
    peak = np.abs(want).max()
    d = np.abs(got - want)
    rms = np.sqrt((d ** 2).mean()) / peak
    print(f"max {d.max() / peak:.3g}, rms {rms:.3g}")
    assert d.max() <= 0.2 * peak
    assert np.sqrt((d ** 2).mean()) <= 5e-2 * peak


def test_repitched_tone_lands_a_bin_up():
    """The constant repitch writes factor * (f + bin_width), the
    reference's +1-bin offset (PVModify.cpp:263-268, 287-302): a 440 Hz
    tone at 1.5x lands at 1.5 * (440 + 15.625) Hz, in both packages."""
    n = 16000
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    x = (0.5 * np.sin(2 * np.pi * 440 * t))[None].astype(np.float32)
    want = 1.5 * (440.0 + SR / KW["dft_size"])
    for y in (np.array(j_repitch(x, 1.5, **KW))[0],
              pv_repitch_pipeline(x, 1.5, device="cpu", **KW).numpy()[0]):
        seg = y[4000:12000] * np.hanning(8000)
        hz = np.argmax(np.abs(np.fft.rfft(seg))) * SR / 8000
        assert abs(hz - want) <= 1.0, hz


# --------------------------------------------------- within the port

def test_morph_with_a_shorter_source_has_a_silent_tail():
    """Past the shorter source's frames the planes are zero, as
    replace_amplitudes zero-fills beyond its overlap."""
    a = _signal(16000, channels=1)
    b = _signal(8000, channels=1, seed=1) * 0.8
    y = pv_morph_pipeline(a, b, 0.25, device="cpu", chunk_out=32,
                          **KW).numpy()
    assert np.abs(y[:, :7000]).max() > 0.1
    assert np.abs(y[:, 8000 + 2 * KW["window_size"]:]).max() < 1e-6


def _class(name, x):
    a = Audio.create_from_array(x, SR, device="cpu").convert_to_PV(512, 64,
                                                                   512)
    if name.startswith("stretch"):
        factor = {"stretch_2_stereo": 2.0, "stretch_1.5_mono": 1.5,
                  "stretch_var_mono": lambda t, f: 1.0 + 0.5 * t}[name]
        return a.stretch(factor).convert_to_audio().to_numpy()
    if name.startswith("repitch"):
        return a.repitch({"repitch_1.5_stereo": 1.5,
                          "repitch_step_mono": _step_t}[name]) \
            .convert_to_audio().to_numpy()
    b = Audio.create_from_array(np.ascontiguousarray(x[::-1, :4000]) * 0.8,
                                SR, device="cpu").convert_to_PV(512, 64, 512)
    return a.replace_amplitudes(b, _amount_t).convert_to_audio().to_numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_the_port_class_path(name):
    """The streamed output against Audio.convert_to_PV -> method ->
    convert_to_audio in the port. The stretches run the same remap and
    inverse (read 1.6e-7 to 3.3e-6 of the peak at these chunks; 0 with
    chunks of the class path's 2048 frames); repitch and morph pass the
    identity remap, which writes (m f) / m, an ulp off f, and the phase
    integrates it (read 2.7e-6 to 2.1e-5). Bounds 1e-5 and 1e-4."""
    x = _signal(channels=CASES[name][2])
    want = _class(name, x)
    got = _port(name)
    n = min(got.shape[1], want.shape[1])
    assert abs(got.shape[1] - want.shape[1]) <= KW["hop"] or \
        got.shape == want.shape
    err = np.abs(got[:, :n] - want[:, :n]).max() / np.abs(want).max()
    print(f"{name}: {err:.3g}")
    assert err <= (1e-5 if name.startswith("stretch") else 1e-4)


@pytest.mark.parametrize("name", ["stretch_1.5_mono", "repitch_step_mono",
                                  "morph_stereo"])
def test_pipeline_output_does_not_depend_on_the_chunk(name):
    """Chunks of 16 and 64 frames: the remap picks the same hops, the cycle
    carry and the overlap-add tail cross the boundaries; only the float64
    cycle sums' blocking moves the last float32 place (read up to 2e-7)."""
    a, b = _port(name, 16), _port(name, 64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()


def test_host_data_goes_to_the_card_unless_a_device_is_named():
    """numpy input without device= goes to "cuda" (which raises on a
    CPU-only torch); a tensor keeps its device; a named device wins."""
    x = _signal(2000)
    if torch.cuda.is_available():
        assert pv_stretch_pipeline(x, 2.0, **KW).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pv_stretch_pipeline(x, 2.0, **KW)
        with pytest.raises((AssertionError, RuntimeError)):
            pv_morph_pipeline(x, x, 0.5, **KW)
    assert pv_repitch_pipeline(torch.from_numpy(x), 1.5,
                               **KW).device.type == "cpu"
    assert pv_stretch_pipeline(x, 2.0, device="cpu", **KW).device.type \
        == "cpu"


def test_pipelines_reject_bad_input():
    x = _signal(2000)
    with pytest.raises(ValueError):
        pv_stretch_pipeline(x, lambda t: 0.1 - t, device="cpu", **KW)
    with pytest.raises(ValueError):
        pv_stretch_pipeline(x[0], 2.0, device="cpu", **KW)
    with pytest.raises(ValueError):
        pv_morph_pipeline(x, x[:1], 0.5, device="cpu", **KW)


def test_a_factor_function_returning_a_number_is_a_constant():
    """A factor function may return a plain number: the port broadcasts it
    over the hops (flan_tpu reshapes it to one hop and returns two frames
    of audio; ROADMAP C.9)."""
    x = _signal(4000, channels=1)
    want = pv_stretch_pipeline(x, 2.0, device="cpu", **KW)
    got = pv_stretch_pipeline(x, lambda t: 2.0, device="cpu", **KW)
    assert torch.equal(got, want)
