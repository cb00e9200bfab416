"""flan_tpu_torch's command line (cli.py, python -m flan_tpu_torch) and
prefetching loader (io/loader.py) on the CPU: every subcommand of
flan_tpu/cli.py against flan_tpu.cli.main on the same files, with a
tolerance stated per path, the cases of tests/test_cli.py (basename
collisions, mixed lengths not padded, the cancel token, an unreadable
input), the loader's order, errors and abandonment, and the entry point
in a subprocess that never imports jax. Inputs are made with numpy from a
seed at 8 kHz.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.cli import main as jax_main
from flan_tpu_torch.cli import main
from flan_tpu_torch.io.loader import iter_audio_prefetched
from flan_tpu_torch.utils.cancel import CancelToken, Cancelled


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, x, sr=SR):
    flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu").save_to_file(
        path)
    return path


def _stereo(seconds=0.6, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return np.stack([0.4 * np.sin(2 * np.pi * (330.0 + 110.0 * c) * t)
                     + 0.05 * rng.standard_normal(len(t))
                     for c in range(2)]).astype(np.float32)


def _harmonic(seconds=1.0):
    """tests/test_cli.py's drifting harmonic tone: a YIN-trackable input
    whose waves stay distinct, for the wavetable."""
    t = np.arange(int(seconds * SR), dtype=np.float32) / np.float32(SR)
    ph = 2 * np.pi * (220.0 * t + 10.0 * t * t)
    return (0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph) * t
            + 0.1 * np.sin(3 * ph + 1.0)).astype(np.float32)[None]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    rng = np.random.default_rng(1)
    ir = (rng.standard_normal((1, 400)) * np.exp(-np.arange(400) / 100.0)
          ).astype(np.float32)
    return {
        "a": _write(str(d / "a.wav"), _stereo(seed=2)),
        "b": _write(str(d / "b.wav"), _stereo(seed=3)),
        "ir": _write(str(d / "ir.wav"), ir),
        "tone": _write(str(d / "tone.wav"), _harmonic(0.6)),
    }


# subcommand -> (arguments before out_dir, inputs, outputs, bound): each
# output against flan_tpu's, its largest difference times flan_tpu's peak
# (the reading each bound was set from, on these inputs, in brackets)
CASES = {
    # the streamed pipelines at their default window 2048 / dft 4096: the
    # port's float64 cycle sums against JAX's float32 ones, largest in the
    # last window's weak bins [2.0e-3 stretch, 2.4e-4 repitch, 1.4e-4
    # morph]
    "stretch": (["--factor", "1.5"], ["a", "b"], ["a.wav", "b.wav"], 5e-3),
    "repitch": (["--factor", "1.5"], ["a"], ["a.wav"], 2e-3),
    "morph": (["--amount", "0.3"], ["a", "b"], ["a_morph.wav"], 2e-3),
    # the 2 x 2 scan [0]
    "filter-lowpass": (["--cutoff", "900"], ["a"], ["a.wav"], 1e-5),
    "resample": (["--rate", "12000"], ["a"], ["a.wav"], 1e-5),  # [4.1e-7]
    "convolve": (["--ir", "ir"], ["a", "b"], ["a.wav", "b.wav"],
                 1e-5),                                         # [1.4e-6]
    # K3's plain version, the JAX package's order [0]
    "granulate": (["--length", "0.8", "--seed", "3"], ["a"], ["a.wav"],
                  1e-5),
    "eq": (["--low", "200", "--high", "400"], ["a"], ["a.wav"],
           1e-5),                                               # [4.1e-7]
    "wavetable": (["--length", "0.25", "--freq", "110"], ["tone"],
                  ["tone.wav"], 1e-5),                          # [4.6e-7]
    # the linear scan's constant delay [0]
    "stereo-delay": (["--length", "1.0", "--l-time", "0.05", "--r-time",
                      "0.08", "--decay", "0.4"], ["a"], ["a.wav"], 1e-5),
}


def _run_both(tmp_path, cmd, head, names, inputs):
    head = [inputs.get(h, h) for h in head]
    paths = [inputs[n] for n in names]
    outs = (str(tmp_path / "port"), str(tmp_path / "jax"))
    assert main([cmd] + head + [outs[0]] + paths, device="cpu") == 0
    assert jax_main([cmd] + head + [outs[1]] + paths) == 0
    return outs


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_subcommand_matches_flan_tpu(tmp_path, inputs, cmd):
    head, names, outs, bound = CASES[cmd]
    port_dir, jax_dir = _run_both(tmp_path, cmd, head, names, inputs)
    assert sorted(os.listdir(port_dir)) == sorted(outs)
    for name in outs:
        got, gsr = (lambda a: (a.to_numpy(), a.sample_rate))(
            flan_tpu_torch.Audio.load_from_file(
                os.path.join(port_dir, name), device="cpu"))
        j = flan_tpu.Audio.load_from_file(os.path.join(jax_dir, name))
        want = np.array(j.data)
        assert gsr == j.sample_rate
        assert got.shape == want.shape, (got.shape, want.shape)
        assert np.isfinite(got).all()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err < bound, (name, err)


def test_spectrogram_matches_flan_tpu(tmp_path, inputs):
    """The BMP of each input: the port's PV render equals flan_tpu's pixel
    for pixel (no tick labels, so C.1 does not enter)."""
    port_dir, jax_dir = _run_both(tmp_path, "spectrogram", [], ["a", "b"],
                                  inputs)
    assert sorted(os.listdir(port_dir)) == ["a.bmp", "b.bmp"]
    from test_torch_graph import _load_bmp
    for name in ("a.bmp", "b.bmp"):
        got = _load_bmp(os.path.join(port_dir, name))
        want = _load_bmp(os.path.join(jax_dir, name))
        assert got.shape == want.shape == (512, 1024, 3)
        np.testing.assert_array_equal(got, want)


def test_basename_collisions_get_suffixes(tmp_path):
    paths = []
    for sub, freq in (("a", 300.0), ("b", 600.0)):
        (tmp_path / sub).mkdir()
        t = np.arange(int(0.3 * SR)) / SR
        paths.append(_write(str(tmp_path / sub / "loop.wav"),
                            (0.4 * np.sin(2 * np.pi * freq * t))[None]
                            .astype(np.float32)))
    out = str(tmp_path / "c")
    assert main(["resample", "--rate", "12000", out] + paths,
                device="cpu") == 0
    assert sorted(os.listdir(out)) == ["loop.wav", "loop_1.wav"]


def test_mixed_lengths_are_not_padded(tmp_path):
    paths = [_write(str(tmp_path / f"m{i}.wav"), _stereo(sec, seed=i))
             for i, sec in enumerate((0.2, 0.4))]
    out = str(tmp_path / "mixed")
    assert main(["stretch", "--factor", "2.0", out] + paths,
                device="cpu") == 0
    o0 = flan_tpu_torch.Audio.load_from_file(out + "/m0.wav", device="cpu")
    o1 = flan_tpu_torch.Audio.load_from_file(out + "/m1.wav", device="cpu")
    assert o0.num_frames < 0.6 * SR < 0.7 * SR < o1.num_frames


def test_cancel_token_stops_before_a_clip(tmp_path, inputs):
    tok = CancelToken()
    tok.cancel()
    with pytest.raises(Cancelled):
        main(["stretch", "--factor", "1.5", str(tmp_path / "out"),
              inputs["a"], inputs["b"]], cancel=tok, device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("argv,message", [
    (["stretch", "--factor", "2", "OUT", "MISSING"], "could not read"),
    (["stereo-delay", "--length", "1", "--l-time", "0.05", "--r-time",
      "0.08", "OUT", "MONO"], "stereo-delay requires stereo inputs"),
    (["morph", "OUT", "A", "RATE"], "must share a sample rate"),
    (["resample", "--rate", "12000", "OUT", "EMPTY"], "could not read")])
def test_bad_inputs_exit_with_flan_tpus_message(tmp_path, inputs, argv,
                                                message):
    files = {
        "OUT": str(tmp_path / "out"), "MISSING": str(tmp_path / "nope.wav"),
        "A": inputs["a"],
        "MONO": _write(str(tmp_path / "mono.wav"),
                       np.zeros((1, 1000), np.float32)),
        "RATE": _write(str(tmp_path / "r.wav"), _stereo(), 11025.0),
        "EMPTY": _write(str(tmp_path / "e.wav"),
                        np.zeros((1, 0), np.float32)),
    }
    argv = [files.get(a, a) for a in argv]
    with pytest.raises(SystemExit) as e:
        main(argv, device="cpu")
    with pytest.raises(SystemExit) as j:
        jax_main(argv)
    assert message in str(e.value.code)
    assert str(e.value.code).replace("flan_tpu_torch", "flan_tpu") == \
        str(j.value.code)


def test_loader_keeps_order_and_raises_at_the_bad_items_turn(tmp_path,
                                                             inputs):
    paths = [inputs["a"], inputs["tone"], inputs["b"]]
    got = list(iter_audio_prefetched(paths, depth=1, device="cpu"))
    assert [p for p, _ in got] == paths
    for p, clip in got:
        want = flan_tpu.Audio.load_from_file(p)
        assert clip.device.type == "cpu"
        np.testing.assert_array_equal(clip.to_numpy(), np.array(want.data))
    seen = []
    with pytest.raises(RuntimeError, match="failed to load .*nope.wav"):
        for p, _ in iter_audio_prefetched(
                [inputs["a"], str(tmp_path / "nope.wav"), inputs["b"]],
                device="cpu"):
            seen.append(p)
    assert seen == [inputs["a"]]


def test_an_abandoned_loader_joins_its_producer(inputs):
    before = {t.ident for t in threading.enumerate()}
    it = iter_audio_prefetched([inputs["a"]] * 8, depth=1, device="cpu")
    next(it)
    started = [t for t in threading.enumerate() if t.ident not in before]
    assert len(started) == 1
    it.close()
    started[0].join(timeout=5)
    assert not started[0].is_alive()


def test_help_runs_without_jax(tmp_path):
    """python -m flan_tpu_torch --help in a fresh process: it prints every
    subcommand and never imports jax."""
    code = ("import runpy, sys\n"
            "sys.argv = ['flan_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('flan_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules\n"
            "print('NO_JAX')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("stretch", "repitch", "morph", "filter-lowpass", "resample",
                "spectrogram", "convolve", "granulate", "eq", "wavetable",
                "stereo-delay"):
        assert cmd in out.stdout
    assert out.stdout.strip().endswith("NO_JAX")


JAX_NAMES = sorted(flan_tpu.__all__)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_the_port_exports_what_flan_tpu_exports(name):
    """flan_tpu_torch.__all__ covers flan_tpu.__all__, each name bound."""
    assert name in flan_tpu_torch.__all__
    assert getattr(flan_tpu_torch, name) is not None
