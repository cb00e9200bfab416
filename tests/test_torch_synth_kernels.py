"""The plain versions of the synthesis kernels (flan_tpu_torch/ops/
random.py K1, cycle_scan.py K2, grain_mix.py K3) on the CPU: K1 against
jax.random's bits, floats and splits (exact); K2 against an exact scan and
against the JAX package's float32 associative scan; K3 against a literal
loop in its order and against the JAX package's planned and scatter
renders (flan_tpu/audio/synthesis.py:708-862). Inputs are made with numpy
from seeds; every tolerance is stated beside its test.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.audio import synthesis as j_synth
from flan_tpu_torch.ops import cycle_scan as cs
from flan_tpu_torch.ops import grain_mix as gm
from flan_tpu_torch.ops import random as rnd


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

N_DRAWS = (1 << 17) + 3
# K2's phases against the float64 scan of the same float32 increments, in
# cycles: one float32 rounding of a phase below 1 (2^-25 = 3.0e-8)
TOL_SCAN = 3e-8


def _cyclic(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return np.minimum(d, 1.0 - d)


@pytest.mark.parametrize("seed,lo,hi", [(0, -1.0, 1.0), (7, 0.0, 2 * math.pi),
                                        (123456, -1.0, 1.0)])
def test_uniform_is_jaxs_bits(seed, lo, hi):
    """2^17 + 3 draws, exact (the (1, n) shape draws the same flat
    sequence)."""
    want = np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                       (1, N_DRAWS), jnp.float32, lo, hi))
    got = rnd.uniform(rnd.key(seed), N_DRAWS, lo, hi, device="cpu").numpy()
    assert np.array_equal(got.view(np.uint32), want.reshape(-1)
                          .view(np.uint32))


def test_split_and_bits_are_jaxs():
    """Two splits deep, and 32-bit random bits, exact."""
    k = jax.random.PRNGKey(3)
    kt = rnd.key(3)
    for _ in range(2):
        k, sub = jax.random.split(k)
        kt, subt = rnd.split(kt, 2, "cpu")
        assert (kt, subt) == (tuple(np.array(k).tolist()),
                              tuple(np.array(sub).tolist()))
    keys = np.array(jax.random.split(jax.random.PRNGKey(11), 5))
    assert rnd.split(rnd.key(11), 5, "cpu") == [tuple(r) for r in
                                                 keys.tolist()]
    bits = np.array(jax.random.bits(sub, (4099,), jnp.uint32))
    assert np.array_equal(rnd.random_bits(subt, 4099, "cpu").numpy(),
                          bits.astype(np.int64))


def test_uniform_chunks_give_the_same_bits(monkeypatch):
    want = rnd.uniform(rnd.key(5), 70_001, -1.0, 1.0, "cpu")
    monkeypatch.setattr(rnd, "CHUNK", 1 << 12)
    assert torch.equal(rnd.uniform(rnd.key(5), 70_001, -1.0, 1.0, "cpu"),
                       want)


@jax.jit
def jax_mod1_scan(inc):
    """The JAX package's cycle tree (flan_tpu/audio/synthesis.py:57), under
    jit: eagerly it dispatches op by op, ~10 s a call on the CPU."""
    return jax.lax.associative_scan(lambda a, b: jnp.mod(a + b, 1.0), inc)


def _sweep(n, in_rate, f0=220.0, f1=2000.0):
    t = (np.arange(n, dtype=np.float32) / np.float32(in_rate))
    return (np.float32(f0) + np.float32(f1) * t).astype(np.float32)


def _exact_phases(inc):
    return np.concatenate([[0.0], np.cumsum(inc.astype(np.float64))[:-1]]
                          ) % 1.0


def test_cycle_scan_is_the_exact_scan_rounded():
    """A sweep that wraps every few samples and a negative frequency
    (jnp.mod's 1 - frac): within one float32 rounding of the float64 scan
    of the same increments."""
    in_rate = 32000.0
    f = _sweep(300_007, in_rate)
    f[1000:2000] *= -1.0
    ft = torch.from_numpy(f)
    got = cs.cycle_scan(ft, None, in_rate, len(f), "cpu").numpy()
    inc = cs.increments(ft, in_rate).numpy()
    assert _cyclic(got, _exact_phases(inc)).max() <= TOL_SCAN
    assert got[0] == 0.0


@pytest.mark.parametrize("block,chunk", [(1 << 10, 1 << 12), (7, 1 << 10)])
def test_cycle_scan_bits_do_not_depend_on_its_blocks(monkeypatch, block,
                                                     chunk):
    in_rate = 32000.0
    ft = torch.from_numpy(_sweep(50_001, in_rate))
    want = cs.cycle_scan(ft, None, in_rate, 50_001, "cpu")
    monkeypatch.setattr(cs, "BLOCK", block)
    monkeypatch.setattr(cs, "CHUNK", chunk - chunk % block)
    assert torch.equal(cs.cycle_scan(ft, None, in_rate, 50_001, "cpu"), want)
    inc = cs.constant_increment(440.0, in_rate)
    assert torch.equal(cs.cycle_scan(None, inc, in_rate, 50_001, "cpu"),
                       _const_want(inc, in_rate))


def _const_want(inc, in_rate):
    monkey = cs.BLOCK, cs.CHUNK
    cs.BLOCK, cs.CHUNK = 1 << 15, 1 << 24
    try:
        return cs.cycle_scan(None, inc, in_rate, 50_001, "cpu")
    finally:
        cs.BLOCK, cs.CHUNK = monkey


@pytest.mark.parametrize("case", ["constant", "sweep"])
def test_cycle_scan_within_jaxs_own_distance(case):
    """The JAX package's float32 tree (synthesis.py:55-58) against the
    exact scan: the port's phases are no farther than the tree's own
    distance plus TOL_SCAN; measured and printed."""
    in_rate, n = 32000.0, 1 << 20
    if case == "constant":
        inc32 = np.full(n, cs.constant_increment(440.0, in_rate), np.float32)
        got = cs.cycle_scan(None, inc32[0], in_rate, n, "cpu").numpy()
    else:
        f = _sweep(n, in_rate)
        inc32 = cs.increments(torch.from_numpy(f), in_rate).numpy()
        got = cs.cycle_scan(torch.from_numpy(f), None, in_rate, n,
                            "cpu").numpy()
    cycles = jax_mod1_scan(jnp.asarray(inc32))
    jax_ph = np.concatenate([[0.0], np.array(cycles)[:-1]])
    exact = _exact_phases(inc32)
    d_jax = _cyclic(jax_ph, exact).max()
    d_port = _cyclic(got, exact).max()
    print(f"{case}: JAX tree {d_jax:.3e} cycles from the exact scan, the "
          f"port {d_port:.3e}")
    assert d_port <= d_jax + TOL_SCAN


def _grains(seed, count, width, n, out_span, fade=True):
    """Per-grain rows for K3 made with numpy: starts in the source and in
    the output, lengths up to `width`, fades."""
    rng = np.random.default_rng(seed)
    s0 = rng.integers(0, n - width, count)
    lens = rng.integers(1, width + 1, count)
    lens[0] = width
    fts = rng.integers(0, width // 2, count) if fade else np.zeros(count,
                                                                  int)
    sf = np.minimum(fts, lens)
    ef = np.minimum(fts, lens)
    over = sf + ef > lens
    sf = np.where(over, (sf * (lens / np.maximum(sf + ef, 1))).astype(int),
                  sf)
    ef = np.where(over, lens - sf, ef)
    starts = np.sort(rng.integers(0, out_span, count))
    return s0, lens, sf, ef, starts


def _loop(x, s0, lens, sf, ef, starts, out_n, envp=None):
    """K3's function as a host loop in its order, float32: every output
    sample the sum from +0 of its grains in ascending order."""
    ch = x.shape[0]
    out = np.zeros((ch, out_n), np.float32)
    r_off = starts % 128
    la = gm.grain_blocks(int(lens.max())) * 128
    for g in range(len(s0)):
        for j in range(la):
            lane = j - r_off[g]
            pos = (starts[g] // 128) * 128 + j
            if not 0 <= lane < lens[g] or pos >= out_n:
                continue
            env = np.float32(1.0)
            if lane < sf[g]:
                env = np.sqrt(np.float32(max(lane, 0))
                              / np.float32(max(sf[g], 1)))
            if lane >= lens[g] - ef[g]:
                d = (np.float32(lens[g]) - np.float32(1)) - np.float32(lane)
                env = min(env, np.sqrt(np.float32(max(d, 0))
                                       / np.float32(max(ef[g], 1))))
            if envp is not None:
                env = np.float32(env * envp[g, j])
            idx = min(max(s0[g] + lane, 0), x.shape[1] - 1)
            out[:, pos] = out[:, pos] + x[:, idx] * np.float32(env)
    return out


def test_grain_overlap_add_is_its_loop():
    """Overlap up to 64 grains, fades, an envelope plane: exact against
    the loop."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    s0, lens, sf, ef, starts = _grains(1, 70, 300, 3000, 200)
    out_n = int((starts + lens).max())
    meta = torch.from_numpy(np.stack([s0, lens, sf, ef, starts % 128,
                                      starts // 128]).astype(np.int32))
    nblk_g = gm.grain_blocks(int(lens.max()))
    offsets, entries = gm.grain_plan(starts // 128, nblk_g, out_n)
    assert np.diff(offsets).max() >= 64
    envp = rng.uniform(0.0, 1.0, (70, nblk_g * 128)).astype(np.float32)
    for ep in (None, envp):
        got = gm.grain_overlap_add(
            torch.from_numpy(x), meta, offsets, entries, out_n,
            None if ep is None else torch.from_numpy(ep)).numpy()
        assert np.array_equal(got, _loop(x, s0, lens, sf, ef, starts,
                                         out_n, ep))


def test_grain_overlap_add_of_a_grain_stack():
    """texture's form: a [G, C, g_n] stack, each grain read whole."""
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((9, 2, 200)).astype(np.float32)
    starts = np.sort(rng.integers(0, 500, 9))
    out_n = int(starts.max()) + 200
    meta = torch.from_numpy(np.stack([np.zeros(9), np.full(9, 200),
                                      np.zeros(9), np.zeros(9), starts % 128,
                                      starts // 128]).astype(np.int32))
    offsets, entries = gm.grain_plan(starts // 128, gm.grain_blocks(200),
                                     out_n)
    got = gm.grain_overlap_add(torch.from_numpy(stack), meta, offsets,
                               entries, out_n).numpy()
    want = np.zeros((2, out_n), np.float32)
    for g in range(9):
        want[:, starts[g]:starts[g] + 200] += stack[g]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["planned", "scatter"])
def test_grain_overlap_add_is_jaxs_render(mode):
    """On the same per-grain rows: the planned render (K = 8 here) and the
    scatter render the JAX package falls back to (its plan's K above 32 or
    over 1.5 M entries) both add in grain order on the CPU, so the port
    gives their bits (tolerance 0)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    s0, lens, sf, ef, starts = _grains(5, 40, 250, 4000, 1500)
    out_n = int((starts + lens).max())
    width = int(lens.max())
    meta6 = np.stack([s0, lens, sf, ef, starts // 128,
                      starts % 128]).astype(np.int32)
    if mode == "planned":
        plan = j_synth._mix_plan(starts // 128, width, out_n)
        want = j_synth._granulate_render_planned(
            jnp.asarray(x), jnp.asarray(meta6[[0, 1, 2, 3, 5]]),
            jnp.asarray(plan), L=width, out_n=out_n, envelope=None)
    else:
        want = j_synth._granulate_render(jnp.asarray(x), jnp.asarray(meta6),
                                         L=width, out_n=out_n,
                                         envelope=None)
    meta = torch.from_numpy(np.stack([s0, lens, sf, ef, starts % 128,
                                      starts // 128]).astype(np.int32))
    offsets, entries = gm.grain_plan(starts // 128, gm.grain_blocks(width),
                                     out_n)
    got = gm.grain_overlap_add(torch.from_numpy(x), meta, offsets, entries,
                               out_n).numpy()
    assert np.array_equal(got, np.array(want))
