"""The plain versions of K2 (flan_tpu_torch/ops/cycle_scan.py) and K3
(ops/grain_mix.py) on the CPU at the edges their kernels meet: K2 on
increments below 2^-24 and at half-ulp ties of Q0.47, negative frequencies
and frequencies above the rate, and a remainder that rounds r + 1 to 1.0,
against the exact float64 scan and the JAX package's own float32 tree; its
two conversions (a float32 increment to Q0.47, a Q0.47 sum to a float32
phase) over every mantissa of several binades against exact integer
rounding, and against the 32-bit integer forms the kernel's variant
computes; K3 on a block covered by more grains than one shared list of
the kernel holds, grains of length 1, zero fades and fades that meet,
against a literal loop in its order and against the JAX package's
scatter render (flan_tpu/audio/synthesis.py _granulate_render). Inputs
are made with numpy from seeds; every tolerance is stated beside its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.audio import synthesis as j_synth
from flan_tpu_torch.ops import cycle_scan as cs
from flan_tpu_torch.ops import grain_mix as gm


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements,
# which the plain versions' many small calls multiply.
torch.set_num_threads(1)

# K2's phases against the float64 scan of the same float32 increments, in
# cycles: one float32 rounding of a phase below 1 (2^-25 = 3.0e-8), plus,
# for increments below 2^-24, each one's rounding to Q0.47 (at most 2^-48
# each, n of them: 2^16 x 2^-48 = 2.3e-10 here)
TOL_SCAN = 3e-8
# the plain K3 against its loop and the JAX scatter render: the same
# operations in the same order, so the same bits (tolerance 0)
SHARED_LIST = 256   # plan entries the kernel stages at once (kList)


@jax.jit
def jax_mod1_scan(inc):
    """The JAX package's cycle tree (flan_tpu/audio/synthesis.py:57)."""
    return jax.lax.associative_scan(lambda a, b: jnp.mod(a + b, 1.0), inc)


def _cyclic(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return np.minimum(d, 1.0 - d)


def _exact_phases(inc):
    return np.concatenate([[0.0], np.cumsum(inc.astype(np.float64))[:-1]]
                          ) % 1.0


def _check_scan(f, in_rate):
    """The plain scan of f at in_rate: within TOL_SCAN of the exact scan
    of its own float32 increments and no farther than the JAX tree's own
    distance plus TOL_SCAN; returns the increments."""
    ft = torch.from_numpy(np.asarray(f, np.float32))
    got = cs.cycle_scan(ft, None, in_rate, len(f), "cpu").numpy()
    inc = cs.increments(ft, in_rate).numpy()
    exact = _exact_phases(inc)
    jax_ph = np.concatenate([[0.0], np.array(jax_mod1_scan(
        jnp.asarray(inc)))[:-1]])
    d_port = _cyclic(got, exact).max()
    d_jax = _cyclic(jax_ph, exact).max()
    print(f"the port {d_port:.3e} cycles from the exact scan, the JAX tree "
          f"{d_jax:.3e}")
    assert got[0] == 0.0
    assert d_port <= TOL_SCAN
    assert d_port <= d_jax + TOL_SCAN
    return inc


def _round_shift(v, s):
    """v >> s rounded half to even (s >= 1), in int64."""
    half = np.int64(1) << (s - 1)
    rest = v & ((half << 1) - 1)
    q = v >> s
    return q + ((rest > half) | ((rest == half) & ((q & 1) == 1)))


def _q47_exact(inc):
    """rint(inc 2^47), half to even, in exact integer arithmetic on the
    float32's bits (inc in [0, 1])."""
    b = np.asarray(inc, np.float32).view(np.uint32).astype(np.int64)
    e = (b >> 23) & 0xFF
    m = (b & 0x7FFFFF) | np.where(e > 0, 0x800000, 0)
    sh = np.maximum(e, 1) - 103                 # inc 2^47 = m 2^sh
    up = m << np.clip(sh, 0, 24)
    down = _round_shift(m, np.clip(-sh, 1, 25))
    return np.where(sh >= 0, up, np.where(-sh <= 24, down, 0))


def _phase_exact(run):
    """float32(run 2^-47) for 0 <= run < 2^47, rounded to nearest even by
    a count of leading bits and one integer rounding (the 32-bit integer
    form of csrc/synth_kernels.cu's k2_integer_conversions variant)."""
    run = np.asarray(run, np.int64)
    nb = np.frexp(run.astype(np.float64))[1].astype(np.int64)   # exact
    mant = np.where(nb <= 24, run << np.clip(24 - nb, 0, 24),
                    _round_shift(run, np.clip(nb - 24, 1, 23)))
    bits = ((nb + 78) << 23) + mant
    return np.where(run == 0, 0, bits).astype(np.uint32).view(np.float32)


def test_increments_below_2_24_and_ties_of_q47():
    """in_rate 1, so f is its increment: values k 2^-48 below 2^-24 (odd k
    a tie of Q0.47, even and odd quotients both ways) and random ones
    below 2^-24 between ordinary ones."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    k = rng.integers(1, 1 << 22, n)
    tiny = (k * 2.0 ** -48).astype(np.float32)
    assert np.array_equal(tiny.astype(np.float64), k * 2.0 ** -48)
    f = np.where(rng.random(n) < 0.5, tiny,
                 rng.uniform(0, 2.0 ** -24, n).astype(np.float32))
    f[::97] = rng.uniform(0.0, 1.0, len(f[::97]))
    f = f.astype(np.float32)
    inc = _check_scan(f, 1.0)
    assert np.array_equal(inc, f)
    q = torch.round(torch.from_numpy(inc).double() * 2.0 ** 47).to(
        torch.int64).numpy()
    assert np.array_equal(q, _q47_exact(inc))
    ties = (k % 2 == 1)
    assert ties.sum() > 1000 and ((k[ties] // 2) % 2 == 0).any() and \
        ((k[ties] // 2) % 2 == 1).any()


def test_negative_frequencies_and_above_the_rate():
    """Frequencies from -3.5 to 3.5 times the rate: every increment
    wraps, negatives take 1 - frac."""
    rng = np.random.default_rng(1)
    in_rate = 48000.0
    f = (rng.uniform(-3.5, 3.5, 1 << 16) * in_rate).astype(np.float32)
    f[:100] = np.float32(-in_rate) * np.arange(100, dtype=np.float32)
    inc = _check_scan(f, in_rate)
    assert (inc >= 0).all() and (inc <= 1).all()


def test_remainder_that_rounds_to_one():
    """f / in_rate a tiny negative: the remainder r + 1 rounds to 1.0 in
    float32 (as jnp.mod's does), a whole cycle, which the scan takes as
    0 mod 1."""
    in_rate = 1.0
    f = np.full(4097, np.float32(0.3), np.float32)
    f[1::3] = -2.0 ** -30
    f[2::7] = -1e-12
    inc = _check_scan(f, in_rate)
    want = np.array(jnp.mod(jnp.asarray(f) / jnp.float32(in_rate), 1.0))
    assert np.array_equal(inc, want)
    assert (inc[1::3] == 1.0).all()
    assert int(cs.fixed(1.0)) == 1 << 47


@pytest.mark.parametrize("lo_exp", [-48, -25, -2])
def test_conversions_every_mantissa(lo_exp):
    """Every mantissa of the binade [2^lo_exp, 2^(lo_exp + 1)): the plain
    version's q (torch.round of the float64 product, half to even) is the
    exact integer rounding and the kernel variant's integer form; and a
    phase from every such q and from 3 q + 1 (odd, wider than 24 bits:
    rounded to float32) is the float64 route's rounding."""
    m = np.arange(1 << 23, dtype=np.int64)
    inc = ((m + (1 << 23)) * 2.0 ** (lo_exp - 23)).astype(np.float32)
    q = torch.round(torch.from_numpy(inc).double() * 2.0 ** 47).to(
        torch.int64).numpy()
    assert np.array_equal(q, _q47_exact(inc))
    run = np.concatenate([q, (q * 3 + 1) & cs.MASK])
    want = (torch.from_numpy(run).double() * 2.0 ** -47).to(
        torch.float32).numpy()
    assert np.array_equal(_phase_exact(run).view(np.uint32),
                          want.view(np.uint32))


def _plan_rows(s0, lens, sf, ef, starts):
    meta = torch.from_numpy(np.stack([s0, lens, sf, ef, starts % 128,
                                      starts // 128]).astype(np.int32))
    meta6 = np.stack([s0, lens, sf, ef, starts // 128,
                      starts % 128]).astype(np.int32)
    return meta, meta6


def _loop(x, s0, lens, sf, ef, starts, out_n):
    """K3's function as a host loop in its order, float32: every output
    sample the sum from +0 of its grains in ascending order."""
    out = np.zeros((x.shape[0], out_n), np.float32)
    for g in range(len(s0)):
        for lane in range(lens[g]):
            pos = starts[g] + lane
            env = np.float32(1.0)
            if lane < sf[g]:
                env = np.sqrt(np.float32(lane) / np.float32(max(sf[g], 1)))
            if lane >= lens[g] - ef[g]:
                d = (np.float32(lens[g]) - np.float32(1)) - np.float32(lane)
                env = min(env, np.sqrt(np.float32(max(d, 0))
                                       / np.float32(max(ef[g], 1))))
            idx = min(max(s0[g] + lane, 0), x.shape[1] - 1)
            out[:, pos] = out[:, pos] + x[:, idx] * np.float32(env)
    return out


def _check_k3(x, s0, lens, sf, ef, starts):
    """The plain K3 on these grains against the loop and the JAX scatter
    render, bit for bit; returns the plan's largest block count."""
    out_n = int((starts + lens).max())
    width = int(lens.max())
    meta, meta6 = _plan_rows(s0, lens, sf, ef, starts)
    offsets, entries = gm.grain_plan(starts // 128, gm.grain_blocks(width),
                                     out_n)
    got = gm.grain_overlap_add(torch.from_numpy(x), meta, offsets, entries,
                               out_n).numpy()
    assert np.array_equal(got, _loop(x, s0, lens, sf, ef, starts, out_n))
    want = np.array(j_synth._granulate_render(
        jnp.asarray(x), jnp.asarray(meta6), L=width, out_n=out_n,
        envelope=None))
    assert np.array_equal(got, want)
    return int(np.diff(offsets).max())


def test_grain_stack_deeper_than_the_shared_list():
    """320 grains starting in one 128-sample block: that block's list is
    longer than the kernel's shared list, which it walks in pieces."""
    rng = np.random.default_rng(2)
    g = 320
    x = rng.standard_normal((2, 2000)).astype(np.float32)
    s0 = rng.integers(0, 1800, g)
    lens = rng.integers(100, 200, g)
    sf = rng.integers(0, 50, g)
    ef = rng.integers(0, 50, g)
    starts = np.sort(rng.integers(0, 128, g))
    assert _check_k3(x, s0, lens, sf, ef, starts) > SHARED_LIST


@pytest.mark.parametrize("case", ["length_1", "zero_fades", "fades_meet"])
def test_grain_edges(case):
    """Grains of length 1 (fades of 0 or 1), zero fades, and fades that
    meet (sf + ef = lens, odd and even lengths)."""
    rng = np.random.default_rng(3)
    g = 90
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    s0 = rng.integers(-5, 1400, g)
    starts = np.sort(rng.integers(0, 700, g))
    if case == "length_1":
        lens = np.ones(g, np.int64)
        sf = rng.integers(0, 2, g)
        ef = np.where(sf == 1, 0, rng.integers(0, 2, g))
    elif case == "zero_fades":
        lens = rng.integers(1, 300, g)
        sf = ef = np.zeros(g, np.int64)
    else:
        lens = rng.integers(2, 300, g)
        sf = rng.integers(0, lens + 1)
        ef = lens - sf
    _check_k3(x, np.maximum(s0, 0), lens, sf, ef, starts)
