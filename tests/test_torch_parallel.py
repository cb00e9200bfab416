"""flan_tpu_torch.parallel against flan_tpu.parallel at the same number of
shards, and against the port's own one-device functions.

The JAX side runs here on the virtual CPU mesh of tests/conftest.py (d = 2,
and d = 4 once on a ragged length). The port side runs in one spawned gloo
group per world size (module fixtures) whose ranks are jax-free
(tests/test_torch_parallel_ranks.py); every rank must return the same
global result, bit for bit. Shapes are tests/test_multichip.py's: sr 8000,
window 256, hop 64, dft 256.

Tolerances start from test_multichip.py's for the same pair and are
stated on each case with the reading they cover.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.ops import scan as j_scan
from flan_tpu.parallel import batch as j_batch
from flan_tpu.parallel import conv_sp as j_conv_sp
from flan_tpu.parallel import mesh as j_mesh
from flan_tpu.parallel import scan_sp as j_scan_sp
from flan_tpu.parallel import stft_sp as j_stft_sp
from flan_tpu_torch.ops import scan, stft
from flan_tpu_torch.ops.fft_conv import fft_convolve_full
from flan_tpu_torch.ops.filter_cores import onepole_core
from flan_tpu_torch.parallel import batch, conv_sp, stft_sp
from flan_tpu_torch.parallel.mesh import Mesh, spawn_ranks
from flan_tpu_torch.pipelines import (pv_morph_pipeline, pv_repitch_pipeline,
                                      pv_stretch_pipeline,
                                      streamed_pv_process)

import test_torch_parallel_ranks as ranks

# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements.
torch.set_num_threads(1)

PV = ranks.PV
CHUNK = ranks.CHUNK
D = 2


@pytest.fixture(scope="module")
def inputs():
    return ranks.make_inputs(D)


@pytest.fixture(scope="module")
def port(inputs):
    """The port's sharded results on 2 gloo ranks: rank 0's, after every
    rank's were found equal bit for bit."""
    results = spawn_ranks(ranks.sharded_outputs, D, inputs, device="cpu",
                          timeout=600)
    for name, value in results[0].items():
        if name in ("mesh", "shard_time", "shard_batch"):
            continue
        for other in results[1:]:
            np.testing.assert_array_equal(other[name], value, err_msg=name)
    return results


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return {"sp": j_mesh.make_mesh(D, axis_name="sp"),
            "data": j_mesh.make_mesh(D)}


def _j(a):
    return jnp.asarray(a)


def _np(a):
    return np.array(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# name -> (the JAX sharded function on (inputs, sp mesh, data mesh),
#          the port's one-device function on inputs, tolerance against
#          JAX, tolerance against the port's one device), both absolute
JAX_AND_ONE_DEVICE = {
    # the scans: test_multichip 1e-4; read 1.2e-7 against JAX and 6e-8
    # against one device, of peaks 0.56 to 0.8 (the tiled scan over a span,
    # then the fold of the totals)
    "linear_recurrence_sp": (
        lambda i, sp, _: j_scan_sp.linear_recurrence_sp(
            _j(i["a"]), _j(i["b"]), sp, y0=0.25),
        lambda i: scan.linear_recurrence(_t(i["a"]), _t(i["b"]), 0.25),
        1e-6, 1e-6),
    "matrix_affine_recurrence_sp_k2": (
        lambda i, sp, _: j_scan_sp.matrix_affine_recurrence_sp(
            _j(i["A2"]), _j(i["b2"]), _j(i["y02"]), sp),
        lambda i: scan.matrix_affine_recurrence(_t(i["A2"]), _t(i["b2"]),
                                                _t(i["y02"])),
        1e-6, 1e-6),
    # k = 4 runs the k x k kernel's passes on the card; the JAX package's
    # scan of 20 leaves takes ~20 s to compile here, so its leaves are held
    # one-device (test_matrix_affine_scanned_leaves_match_jax)
    "matrix_affine_recurrence_sp_k4": (
        None,
        lambda i: scan.matrix_affine_recurrence(_t(i["A4"]), _t(i["b4"]),
                                                _t(i["y04"])),
        None, 1e-6),
    # against one device the same g: onepole_core on tan(pi / sr * cutoff)
    "filter_1pole_lowpass_sp": (
        lambda i, sp, _: j_scan_sp.filter_1pole_lowpass_sp(
            _j(i["lp_x"]), _j(i["cutoff"]), ranks.SR, sp),
        lambda i: onepole_core(_t(i["lp_x"]), torch.tan(
            (np.pi / ranks.SR) * _t(i["cutoff"]))[None, :])[0],
        1e-6, 1e-6),
    # test_multichip 2e-4; read 2.9e-6 against JAX (its blocked transform)
    # and 1.9e-6 against one device (another transform size), of a peak 8.2
    "convolve_sp": (
        lambda i, sp, _: j_conv_sp.convolve_sp(_j(i["conv_x"]), _j(i["ir"]),
                                               sp),
        lambda i: fft_convolve_full(_t(i["conv_x"]), _t(i["ir"])),
        2e-5, 1e-5),
    # the phase vocoder: test_multichip 2e-3 for the inverse, 5e-3 between
    # the sharded stretches. Against JAX read 4.6e-5 (inverse) and 1.5e-4 to
    # 5.1e-4 (the stretches, repitch, morph), of peaks 0.5 to 1.2: the JAX
    # package sums its mod-1 cycles in float32 (a triangular matmul), the
    # port in float64, and the sharded prefix adds float32 totals on both;
    # against one device read 0 to 9e-8
    "pv_inverse_sp": (
        lambda i, sp, _: j_stft_sp.pv_inverse_sp(
            *j_stft_sp.pv_forward_sp(_j(i["tone"]), sp, **PV), sp,
            window_size=PV["window_size"], hop=PV["hop"],
            sample_rate=PV["sample_rate"]),
        None, 5e-4, None),
    "stretch_sp": (
        lambda i, sp, _: j_stft_sp.stretch_sp(_j(i["x"]), sp, factor=2.0,
                                              **PV),
        lambda i: pv_stretch_pipeline(i["x"], 2.0, device="cpu", **PV),
        2e-3, 1e-5),
    "streamed_sp_process": (
        lambda i, sp, _: j_stft_sp.streamed_sp_process(
            [_j(i["x"])], sp, None, chunk_out=CHUNK, **PV),
        lambda i: streamed_pv_process([i["x"]], chunk_out=CHUNK,
                                      device="cpu", **PV),
        2e-3, 1e-5),
    "stretch_sp_streamed": (
        lambda i, sp, _: j_stft_sp.stretch_sp_streamed(
            _j(i["x"]), sp, factor=2.0, chunk_out=CHUNK, **PV),
        lambda i: pv_stretch_pipeline(i["x"], 2.0, chunk_out=CHUNK,
                                      device="cpu", **PV),
        2e-3, 1e-5),
    # a ramp's time map falls between frames: the sharded plan is float64
    # (stft_sp.py:249-256), the one-device plan float32 (streamed.py), as
    # in the JAX package; read 4.5e-5
    "stretch_sp_streamed_ramp": (
        lambda i, sp, _: j_stft_sp.stretch_sp_streamed(
            _j(i["x"][:1]), sp, factor=ranks.ramp, chunk_out=CHUNK, **PV),
        lambda i: pv_stretch_pipeline(i["x"][:1], ranks.ramp,
                                      chunk_out=CHUNK, device="cpu", **PV),
        2e-3, 1e-4),
    "repitch_sp_streamed": (
        lambda i, sp, _: j_stft_sp.repitch_sp_streamed(
            _j(i["x"]), sp, factor=1.5, chunk_out=CHUNK, **PV),
        lambda i: pv_repitch_pipeline(i["x"], 1.5, chunk_out=CHUNK,
                                      device="cpu", **PV),
        2e-3, 1e-5),
    "morph_sp_streamed": (
        lambda i, sp, _: j_stft_sp.morph_sp_streamed(
            _j(i["x"]), _j(i["x_b"]), sp, amount=0.5, chunk_out=CHUNK,
            **PV),
        lambda i: pv_morph_pipeline(i["x"], i["x_b"], 0.5, chunk_out=CHUNK,
                                    device="cpu", **PV),
        2e-3, 1e-5),
    # the batch: JAX's jit(vmap) of the same elementwise map gives the same
    # bits; its stretch read 4.6e-4 (test_multichip: 1e-4 against JAX's own
    # clips alone)
    "map_sharded": (
        lambda i, _, data: jnp.stack(j_batch.map_sharded(
            lambda c: c * 2.0 + 1.0, [_j(c) for c in i["clips"]],
            mesh=data)),
        None, 0.0, None),
    "stretch_batch": (
        lambda i, _, data: jnp.stack(j_batch.stretch_batch(
            [_j(c) for c in i["clips"]], 2.0, mesh=data, **PV)),
        None, 2e-3, None),
}


EAGER = {"stretch_sp_streamed_ramp"}


def _clip_outputs(clips, fn):
    """fn on each clip zero-padded to the longest."""
    n = max(c.shape[-1] for c in clips)
    return np.stack([np.asarray(fn(np.pad(c, ((0, 0), (0, n - c.shape[-1])))))
                     for c in clips])


@pytest.mark.parametrize("name", sorted(
    k for k, v in JAX_AND_ONE_DEVICE.items() if v[0] is not None))
def test_sharded_matches_jax_at_the_same_d(port, meshes, inputs, name):
    """The port's result on 2 ranks against the JAX package's sharded
    function on 2 devices: the same shape, within the stated tolerance."""
    jax_fn, _, tol, _ = JAX_AND_ONE_DEVICE[name]

    def call():
        return jax_fn(inputs, meshes["sp"], meshes["data"])
    # jitted, the eager shard_maps take 10 to 250 s here; a factor function
    # is sampled on the host while the JAX package plans, so not under jit
    want = _np(call() if name in EAGER else jax.jit(call)())
    got = port[0][name]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


@pytest.mark.parametrize("name", sorted(
    k for k, v in JAX_AND_ONE_DEVICE.items() if v[1] is not None))
def test_sharded_matches_the_ports_one_device(port, inputs, name):
    """The port's result on 2 ranks against its own one-device function
    on the same inputs: the padding sliced off, within the tolerance."""
    _, one_fn, _, tol = JAX_AND_ONE_DEVICE[name]
    want = np.asarray(one_fn(inputs))
    got = port[0][name]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def test_pv_forward_sp_matches_jax_and_one_device(port, meshes, inputs):
    """The halo exchange: the padded rows JAX returns, the magnitudes
    within 1e-3 (test_multichip's pair) of JAX's and the frequencies
    within 0.5 Hz; the live rows equal the port's one-device pv_forward."""
    mag, freq = (port[0]["pv_forward_sp_mag"],
                 port[0]["pv_forward_sp_freq"])
    jm, jf = (_np(a) for a in jax.jit(lambda x: j_stft_sp.pv_forward_sp(
        x, meshes["sp"], **PV))(_j(inputs["x"])))
    assert mag.shape == jm.shape and freq.shape == jf.shape
    assert np.abs(mag - jm).max() <= 1e-3
    assert np.abs(freq - jf).max() <= 0.5
    m1, f1 = stft.pv_forward(_t(inputs["x"]), **PV)
    nh = m1.shape[1]
    np.testing.assert_array_equal(mag[:, :nh], m1.numpy())
    np.testing.assert_array_equal(freq[:, :nh], f1.numpy())


def test_pv_inverse_sp_matches_one_device_on_its_planes(port, inputs):
    """pv_inverse_sp of pv_forward_sp's planes against the port's
    one-device pv_inverse of the same planes (test_multichip: 2e-3; the
    prefix of 2 ranks' float64-summed cycles against one carry)."""
    mag, freq = (_t(p) for p in port[0]["pv_forward_sp_tone"])
    want = stft.pv_inverse(mag, freq, window_size=PV["window_size"],
                           hop=PV["hop"], sample_rate=PV["sample_rate"])
    assert np.abs(port[0]["pv_inverse_sp"] - want.numpy()).max() <= 1e-6


def test_batch_matches_each_clip_alone(port, inputs):
    """map_sharded and stretch_batch: each clip zero-padded to the longest
    and rendered alone gives the same bits."""
    np.testing.assert_array_equal(
        port[0]["map_sharded"],
        _clip_outputs(inputs["clips"], lambda c: c * 2.0 + 1.0))
    np.testing.assert_array_equal(
        port[0]["stretch_batch"],
        _clip_outputs(inputs["clips"], lambda c: pv_stretch_pipeline(
            c, 2.0, device="cpu", **PV)))


def test_shards_are_the_jax_shardings_blocks(port, meshes, inputs):
    """shard_time is seq_sharding's block and shard_batch batch_sharding's,
    rank by rank."""
    x = jax.device_put(_j(inputs["x"]),
                       j_mesh.seq_sharding(meshes["sp"], "sp"))
    clips = jax.device_put(_j(inputs["batch"]),
                           j_mesh.batch_sharding(meshes["data"]))
    for r, result in enumerate(port):
        np.testing.assert_array_equal(
            result["shard_time"],
            _np(x.addressable_shards[r].data))
        np.testing.assert_array_equal(
            result["shard_batch"], _np(clips.addressable_shards[r].data))
        assert result["mesh"]["rank"] == r
        assert result["mesh"]["size"] == D
        assert result["mesh"]["backend"] == "gloo"
        assert result["mesh"]["staged"] == []       # CPU tensors


def test_matrix_affine_scanned_leaves_match_jax(inputs):
    """The leaves from k + 1 recurrences against the JAX package's scan of
    the composed maps, at k = 2 (the 2 x 2 kernel's pass) and k = 4 (the
    k x k one's): within 1e-6, and y = AA y0 + bb the recurrence."""
    for key in ("2", "4"):
        A, b, y0 = inputs["A" + key], inputs["b" + key], inputs["y0" + key]
        got = scan.matrix_affine_scanned_leaves(_t(A), _t(b))
        want = j_scan.matrix_affine_scanned_leaves(_j(A), _j(b))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - _np(w)).max() <= 1e-6
        k = int(key)
        y = np.stack([sum(got[i * k + m].numpy() * y0[:, m, None]
                          for m in range(k)) + got[k * k + i].numpy()
                      for i in range(k)], axis=-1)
        want_y = scan.matrix_affine_recurrence(_t(A), _t(b), _t(y0)).numpy()
        assert np.abs(y - want_y).max() <= 1e-6


def test_four_ranks_on_a_ragged_length(meshes, inputs):
    """d = 4 once: stretch_sp_streamed on a length that no shard divides,
    against JAX's at 4 devices (test_multichip: 5e-3) and the port's one
    device (1e-5)."""
    x = inputs["ragged"]
    results = spawn_ranks(ranks.sharded_ragged, 4, inputs, device="cpu",
                          timeout=600)
    got = results[0]["stretch_sp_streamed"]
    for other in results[1:]:
        np.testing.assert_array_equal(other["stretch_sp_streamed"], got)
    mesh4 = j_mesh.make_mesh(4, axis_name="sp")
    want = _np(jax.jit(lambda x: j_stft_sp.stretch_sp_streamed(
        x, mesh4, factor=1.5, chunk_out=CHUNK, **PV))(_j(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-3
    one = pv_stretch_pipeline(x, 1.5, chunk_out=CHUNK, device="cpu", **PV)
    assert np.abs(got - one.numpy()).max() <= 1e-5


# the raised errors, on a mesh of 2 ranks seen from rank 0: each is raised
# before any collective, so no group is needed
RAISES = {
    "convolve_sp rejects an oversized tail": (
        lambda m: conv_sp.convolve_sp(np.zeros((1, 20), np.float32),
                                      np.zeros((1, 64), np.float32), m),
        lambda m: j_conv_sp.convolve_sp(jnp.zeros((1, 20)),
                                        jnp.zeros((1, 64)), m, axis="sp")),
    "pv_forward_sp rejects a shard shorter than its halo": (
        lambda m: stft_sp.pv_forward_sp(np.zeros((1, 100), np.float32), m,
                                        **PV),
        lambda m: j_stft_sp.pv_forward_sp(jnp.zeros((1, 100)), m, **PV)),
    "stretch_sp rejects a shard shorter than the tail": (
        lambda m: stft_sp.stretch_sp(np.zeros((1, 64), np.float32), m,
                                     factor=1.0, **PV),
        lambda m: j_stft_sp.stretch_sp(jnp.zeros((1, 64)), m, factor=1.0,
                                       **PV)),
    "stretch_sp_streamed rejects a factor of 0": (
        lambda m: stft_sp.stretch_sp_streamed(
            np.zeros((1, 4096), np.float32), m, factor=0.0, **PV),
        lambda m: j_stft_sp.stretch_sp_streamed(
            jnp.zeros((1, 4096)), m, factor=0.0, **PV)),
    "streamed_sp_process rejects unequal channels": (
        lambda m: stft_sp.streamed_sp_process(
            [np.zeros((1, 4096), np.float32),
             np.zeros((2, 4096), np.float32)], m, **PV),
        lambda m: j_stft_sp.streamed_sp_process(
            [jnp.zeros((1, 4096)), jnp.zeros((2, 4096))], m, **PV)),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_raises_as_jax_does(meshes, case):
    port_call, jax_call = RAISES[case]
    with pytest.raises(ValueError) as port_err:
        port_call(Mesh(0, D, torch.device("cpu"), "sp", "gloo", frozenset()))
    with pytest.raises(ValueError) as jax_err:
        jax_call(meshes["sp"])
    assert str(port_err.value) == str(jax_err.value)


def test_pv_inverse_sp_and_map_sharded_raise(meshes):
    """F not a multiple of the ranks: JAX asserts, the port raises a
    ValueError (an assert is stripped under python -O); unequal channels
    in map_sharded: both a ValueError."""
    m = Mesh(0, D, torch.device("cpu"), "sp", "gloo", frozenset())
    planes = np.zeros((1, 5, 129), np.float32)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        stft_sp.pv_inverse_sp(planes, planes, m, window_size=256, hop=64,
                              sample_rate=8000.0)
    with pytest.raises(AssertionError, match="multiple of the mesh size"):
        j_stft_sp.pv_inverse_sp(_j(planes), _j(planes), meshes["sp"],
                                window_size=256, hop=64, sample_rate=8000.0)
    clips = [np.zeros((1, 64), np.float32), np.zeros((2, 64), np.float32)]
    with pytest.raises(ValueError, match="equal channel counts"):
        batch.map_sharded(lambda c: c, clips, mesh=m)
    with pytest.raises(ValueError, match="equal channel counts"):
        j_batch.map_sharded(lambda c: c, [_j(c) for c in clips],
                            mesh=meshes["data"])
