"""flan_tpu_torch.parallel in groups of spawned gloo ranks on the CPU:
the mesh's collectives, the CLI's sharded branch against a one-process
run, file for file, and the kernel build's lock.

This module imports no JAX: a spawned rank imports the module of the
function it runs, so the rank functions of tests/test_torch_parallel.py
live here too. Each file spawns one group per world size (a module
fixture) whose ranks run every check; the cases read the results.
"""
import contextlib
import io
import multiprocessing
import os

import numpy as np
import pytest
import torch

from flan_tpu_torch import Audio
from flan_tpu_torch.ops import build
from flan_tpu_torch.parallel import batch, conv_sp, mesh, scan_sp, stft_sp


# One intra-op thread, in the tests and in every rank: on an 8-core x86
# host torch 2.13's CPU kernels pay ~10 ms to wake their worker pool for a
# call of a few thousand elements, and the ranks' results are compared bit
# for bit with a run in the test's own process.
torch.set_num_threads(1)

SR = 8000.0
WINDOW, HOP, DFT = 256, 64, 256
PV = dict(window_size=WINDOW, hop=HOP, dft_size=DFT, sample_rate=SR)
CHUNK = 32


# ------------------------------------------------------ inputs and ranks

def make_inputs(d: int) -> dict:
    """The numpy inputs of every sharded function at d ranks, from seeds,
    at tests/test_multichip.py's shapes with d shards."""
    rng = np.random.default_rng(17)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)
    n = d * 32 * HOP
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    taps = np.arange(64, dtype=np.float32)
    k4 = 4
    return {
        "x": f32(rng.standard_normal((2, n)) * 0.3),
        "x_b": f32(rng.standard_normal((2, n)) * 0.3),
        "tone": f32((0.5 * np.sin(2 * np.pi * 440 * t))[None]),
        "ragged": f32(rng.standard_normal((1, n + 37)) * 0.3),
        "a": f32(rng.uniform(0.8, 0.999, (2, d * 1000 + 37))),
        "b": f32(rng.standard_normal((2, d * 1000 + 37)) * 0.1),
        "A2": f32(rng.standard_normal((2, d * 500 + 13, 2, 2)) * 0.3),
        "b2": f32(rng.standard_normal((2, d * 500 + 13, 2)) * 0.1),
        "y02": f32(rng.standard_normal((2, 2))),
        "A4": f32(rng.standard_normal((2, d * 300 + 7, k4, k4)) * 0.2),
        "b4": f32(rng.standard_normal((2, d * 300 + 7, k4)) * 0.1),
        "y04": f32(rng.standard_normal((2, k4))),
        "lp_x": f32(rng.standard_normal((2, d * 1024)) * 0.3),
        "cutoff": f32(800.0 + 600.0 * np.sin(np.linspace(0, 6.0, d * 1024))),
        "conv_x": f32(rng.standard_normal((2, d * 300 + 17))),
        "ir": f32(rng.standard_normal((2, 64)) * np.exp(-taps / 16)),
        "batch": f32(rng.standard_normal((2 * d, 1, 64))),
        "clips": [f32(rng.standard_normal((1, HOP * (40 + 8 * i))) * 0.3)
                  for i in range(3)],
    }


def ramp(t):
    """A stretch factor rising with time (test_multichip's)."""
    return 1.0 + t


def sharded_outputs(inp: dict) -> dict:
    """Every public function of flan_tpu_torch.parallel on this rank's
    mesh, on the CPU: the global results, and the mesh's facts."""
    torch.set_num_threads(1)
    sp = mesh.make_mesh(axis_name="sp", device="cpu")
    data = mesh.make_mesh(device="cpu")
    out = {}
    x = inp["x"]
    out["shard_time"] = mesh.shard_time(sp, torch.from_numpy(x))
    out["shard_batch"] = mesh.shard_batch(data, torch.from_numpy(
        inp["batch"]))
    out["linear_recurrence_sp"] = scan_sp.linear_recurrence_sp(
        inp["a"], inp["b"], sp, y0=0.25)
    out["matrix_affine_recurrence_sp_k2"] = \
        scan_sp.matrix_affine_recurrence_sp(inp["A2"], inp["b2"], inp["y02"],
                                            sp)
    out["matrix_affine_recurrence_sp_k4"] = \
        scan_sp.matrix_affine_recurrence_sp(inp["A4"], inp["b4"], inp["y04"],
                                            sp)
    out["filter_1pole_lowpass_sp"] = scan_sp.filter_1pole_lowpass_sp(
        inp["lp_x"], inp["cutoff"], SR, sp)
    out["convolve_sp"] = conv_sp.convolve_sp(inp["conv_x"], inp["ir"], sp)
    mag, freq = stft_sp.pv_forward_sp(x, sp, **PV)
    out["pv_forward_sp_mag"], out["pv_forward_sp_freq"] = mag, freq
    tmag, tfreq = stft_sp.pv_forward_sp(inp["tone"], sp, **PV)
    out["pv_forward_sp_tone"] = torch.stack([tmag, tfreq])
    out["pv_inverse_sp"] = stft_sp.pv_inverse_sp(
        tmag, tfreq, sp, window_size=WINDOW, hop=HOP, sample_rate=SR)
    out["stretch_sp"] = stft_sp.stretch_sp(x, sp, factor=2.0, **PV)
    out["streamed_sp_process"] = stft_sp.streamed_sp_process(
        [x], sp, None, chunk_out=CHUNK, **PV)
    out["stretch_sp_streamed"] = stft_sp.stretch_sp_streamed(
        x, sp, factor=2.0, chunk_out=CHUNK, **PV)
    out["stretch_sp_streamed_ramp"] = stft_sp.stretch_sp_streamed(
        x[:1], sp, factor=ramp, chunk_out=CHUNK, **PV)
    out["repitch_sp_streamed"] = stft_sp.repitch_sp_streamed(
        x, sp, factor=1.5, chunk_out=CHUNK, **PV)
    out["morph_sp_streamed"] = stft_sp.morph_sp_streamed(
        x, inp["x_b"], sp, amount=0.5, chunk_out=CHUNK, **PV)
    out["map_sharded"] = torch.stack(batch.map_sharded(
        lambda c: c * 2.0 + 1.0, inp["clips"], mesh=data))
    out["stretch_batch"] = torch.stack(batch.stretch_batch(
        inp["clips"], 2.0, mesh=data, **PV))
    out["mesh"] = {"rank": sp.rank, "size": sp.size, "backend": sp.backend,
                   "staged": sorted(sp.staged), "device": str(sp.device),
                   "moved": dict(sp.moved)}
    return out


def sharded_ragged(inp: dict) -> dict:
    """The d = 4 case: stretch_sp_streamed on a length no shard divides."""
    torch.set_num_threads(1)
    sp = mesh.make_mesh(axis_name="sp", device="cpu")
    return {"stretch_sp_streamed": stft_sp.stretch_sp_streamed(
        inp["ragged"], sp, factor=1.5, chunk_out=CHUNK, **PV)}


def collectives() -> dict:
    """The three collectives on ranks holding rank-numbered tensors."""
    torch.set_num_threads(1)
    m = mesh.make_mesh(device="cpu")
    x = torch.full((2, 3), float(m.rank + 1))
    return {"right": mesh.shift_right(m, x), "left": mesh.shift_left(m, x),
            "gather": mesh.all_gather(m, x), "last": mesh.from_last(m, x),
            "time": mesh.gather_time(m, x + torch.arange(3.0)),
            "size": m.size, "backend": m.backend}


def cli_run(argv: list) -> tuple:
    """The port's CLI on the CPU in this process: its exit code and the
    lines it printed."""
    torch.set_num_threads(1)
    from flan_tpu_torch.cli import main
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = main(argv, device="cpu")
    return code, printed.getvalue().split()


def cli_group(cases: list) -> list:
    """Every CLI case on this rank's group, then the collectives."""
    return [cli_run(argv) for argv in cases] + [collectives()]


def fail_on_rank_one() -> int:
    m = mesh.make_mesh(device="cpu")
    if m.rank == 1:
        raise KeyError("rank one fails")
    return m.rank


# ------------------------------------------------------------- the tests

def _write_clips(folder, lengths, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(lengths):
        p = os.path.join(folder, f"clip{i}.wav")
        Audio.create_from_array(
            (rng.standard_normal((2, n)) * 0.3).astype(np.float32), SR,
            device="cpu").save_to_file(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def cli_cases(tmp_path_factory):
    """Three clips of one shape and three of mixed lengths, each stretched
    and repitched by a 2-rank group and by one process."""
    root = tmp_path_factory.mktemp("cli")
    equal = _write_clips(str(root), [3000] * 3, 1)
    unequal_dir = root / "unequal"
    unequal_dir.mkdir()
    unequal = _write_clips(str(unequal_dir), [3000, 2500, 4100], 2)
    cases, singles = [], []
    for name, paths in (("equal", equal), ("unequal", unequal)):
        for cmd, flag in (("stretch", "2.0"), ("repitch", "1.5")):
            out = str(root / f"{name}_{cmd}")
            cases.append([cmd, "--factor", flag, out + "_ranks", *paths])
            singles.append([cmd, "--factor", flag, out + "_one", *paths])
    results = mesh.spawn_ranks(cli_group, 2, cases, device="cpu",
                               timeout=300)
    return cases, [cli_run(argv) for argv in singles], singles, results


def _files(folder):
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder))}


@pytest.mark.parametrize("clips", ["equal", "unequal"])
@pytest.mark.parametrize("cmd", ["stretch", "repitch"])
def test_cli_under_two_ranks_writes_the_one_process_files(cli_cases, clips,
                                                          cmd):
    """Clips of one shape go through map_sharded, mixed ones through rank
    0 alone: either way the written WAVs are a one-process run's, byte for
    byte, no other file is written, and rank 0 prints the one-process
    run's paths (in its own folder) while rank 1 prints nothing."""
    cases, one_process, singles, results = cli_cases
    i = ["equal", "unequal"].index(clips) * 2 + ["stretch",
                                                  "repitch"].index(cmd)
    (code0, printed0), (code1, printed1) = (r[i] for r in results)
    code, printed = one_process[i]
    assert code0 == code1 == code == 0
    ranks, one = _files(cases[i][3]), _files(singles[i][3])
    assert sorted(ranks) == ["clip0.wav", "clip1.wav", "clip2.wav"]
    assert ranks == one
    assert printed0 == [q.replace(singles[i][3], cases[i][3])
                        for q in printed] and len(printed) == 3
    assert printed1 == []


def test_collectives_on_two_gloo_ranks(cli_cases):
    """shift_right / shift_left are JAX's non-cyclic ppermutes (zeros at
    the ends), all_gather stacks in rank order, from_last is the psum of
    the last rank's value masked to it, gather_time concatenates spans."""
    results = cli_cases[-1]
    one, two = (r[-1] for r in results)
    for r in (one, two):
        assert r["size"] == 2 and r["backend"] == "gloo"
        np.testing.assert_array_equal(r["gather"],
                                      np.stack([np.full((2, 3), 1.0),
                                                np.full((2, 3), 2.0)]))
        np.testing.assert_array_equal(r["last"], np.full((2, 3), 2.0))
        np.testing.assert_array_equal(
            r["time"], np.concatenate([np.full((2, 3), 1.0) + np.arange(3),
                                       np.full((2, 3), 2.0) + np.arange(3)],
                                      axis=-1))
    np.testing.assert_array_equal(one["right"], np.zeros((2, 3)))
    np.testing.assert_array_equal(two["right"], np.full((2, 3), 1.0))
    np.testing.assert_array_equal(one["left"], np.full((2, 3), 2.0))
    np.testing.assert_array_equal(two["left"], np.zeros((2, 3)))


def test_a_world_of_one_needs_no_group():
    """Without a launcher make_mesh is one rank and the collectives are
    the identity's: nothing from neighbours, the value itself gathered."""
    m = mesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.backend, m.staged) == (1, 0, "none",
                                                     frozenset())
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(mesh.shift_right(m, x), torch.zeros_like(x))
    assert torch.equal(mesh.all_gather(m, x), x[None])
    assert torch.equal(mesh.from_last(m, x), x)
    with pytest.raises(ValueError):
        mesh.make_mesh(2, device="cpu")


def test_spawn_ranks_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*"
                                           "rank one fails"):
        mesh.spawn_ranks(fail_on_rank_one, 2, device="cpu", timeout=120)


def _build_in(build_dir: str, cuda_home: str) -> str:
    """build_library in a fresh process, its build directory and CUDA
    toolkit replaced by the test's."""
    from pathlib import Path

    from torch.utils import cpp_extension
    build.BUILD_DIR = Path(build_dir)
    cpp_extension.CUDA_HOME = cuda_home
    return str(build.build_library()[0])


def test_concurrent_builds_take_turns(tmp_path):
    """Two processes ask for the library at once with nvcc stubbed by a
    script that logs each call and sleeps: one build runs (one compile a
    source and one link), and both get its path."""
    toolkit = tmp_path / "cuda"
    (toolkit / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = toolkit / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "sleep 0.5\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; : > \"$1\"; fi\n"
        "  shift\n"
        "done\n")
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool:
        paths = pool.starmap(_build_in, [(str(out), str(toolkit))] * 2)
    calls = log.read_text().splitlines()
    assert len(calls) == len(build.sources()) + 1
    assert sum(" -shared " in f" {c} " for c in calls) == 1
    assert paths == [str(out / "libflan_kernels.so")] * 2
    assert (out / "libflan_kernels.sha256").read_text() == build._digest()
