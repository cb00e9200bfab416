"""The swept stereo delay's backward on the wide kernel's rounds, on the
CPU (ops/sequential_kernels.py, csrc/sequential_kernels.cu
stereo_delay_wide): the host mirror of the kernel's planner
(stereo_delay_wide_back_starts) against the rule the rounds must keep and
the fewest rounds under the cap; the plain backward on those rounds against
the adjoint step by step (stereo_delay_backward_loop) and on the narrow
plan, bit for bit; the kernel's order of adds emulated step by step (its
planner on chunk maxima, its chunk marks, a round's sends summed by run
heads or by one warp's chunks); and the gradient through
Audio.stereo_delay on the wide rounds against jax.grad through flan_tpu's
loop. Inputs are made with numpy from a seed; the card's kernel is held to
the same plain version in tests/test_torch_cuda_stereo_delay.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu_torch.ops import sequential_kernels as seq


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements,
# which the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
W = seq.STEREO_WIDE_WIDTH
# gradients against jax.grad, times each gradient's peak: the same float32
# loop, its adjoint summed in another order by XLA (the plain backward on
# the default rounds read 0 to 9.0e-7, tests/test_torch_stereo_delay_grad);
# bound 1e-5
TOL_GRAD = 1e-5


def _delays(kind: str, n: int):
    """(dl, dr, lb, rb) int64 numpy, every read at least 128 frames back
    (rounds of hundreds of steps): "rising" a delay that grows by one
    frame a step in teeth of 300 (t - d constant along a tooth: runs of one
    target), "falling" one that shrinks by one a step (targets two apart),
    "step" a jump from 300 to 900 frames half way and back, "el0" the left
    delay at the ring's length for a stretch (el = 0: the step's own
    write, no send) and at 0 for another, "mixed" random."""
    t = np.arange(n)
    rng = np.random.default_rng(len(kind))
    if kind == "rising":
        dl, dr = 200 + t % 300, 250 + (t + 77) % 300
        lb, rb = 600, 600
    elif kind == "falling":
        dl, dr = 1200 - t % 1000, 1150 - (t + 31) % 1000
        lb, rb = 1300, 1200
    elif kind == "step":
        dl = np.where((t >= n // 2) & (t < 3 * n // 4), 900, 300)
        dr = np.where(t >= n // 3, 700, 300)
        lb, rb = 1000, 900
    elif kind == "el0":
        dl = 150 + (t // 7) % 200
        dl[n // 5:n // 5 + 400] = 500
        dl[n // 2:n // 2 + 300] = 0
        dr = 400 - (t // 3) % 150
        lb, rb = 500, 400
    else:
        dl, dr = rng.integers(130, 1500, n), rng.integers(128, 1300, n)
        lb, rb = 1500, 1300
    return dl.astype(np.int64), dr.astype(np.int64), lb, rb


KINDS = ("rising", "falling", "step", "el0", "mixed")


def _case(kind: str, n: int = 4000, seed: int = 3):
    """gout [2, n], g [n] float32 and the delays and reads of kind."""
    rng = np.random.default_rng(seed)
    gout = rng.standard_normal((2, n)).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    dl, dr, lb, rb = _delays(kind, n)
    el, er = seq.stereo_delay_distances(dl, dr, lb, rb)
    return gout, g, dl, dr, el, er, lb, rb


def _narrow_plan(el, er) -> np.ndarray:
    """The narrow backward's rounds (each's last frame, from the end) as
    every round's first frame in ascending order, then n."""
    lasts = seq.stereo_delay_narrow_starts(el, er, reverse=True)
    return np.array([0] + sorted(p + 1 for p in lasts[1:]) + [len(el)])


@pytest.mark.parametrize("kind", KINDS)
def test_wide_back_rounds_are_valid_and_fewest(kind):
    """Every round of the wide backward's plan reads nothing written in it
    and sends nothing into it (lim[t] < s on each frame after its first),
    holds at most STEREO_WIDE_WIDTH frames, and the plan is a partition of
    the call in the fewest such rounds: as many as the forward's greedy
    plan and as a dynamic program over every round end finds."""
    *_, el, er, _, _ = _case(kind)
    n = len(el)
    starts = seq.stereo_delay_wide_back_starts(el, er)
    assert starts[0] == 0 and starts[-1] == n
    assert np.all(np.diff(starts) >= 1)
    lim = seq._round_limits(el, er)
    for s, e in zip(starts[:-1], starts[1:]):
        assert e - s <= W
        assert np.all(lim[s + 1:e] < s), (s, e)
    # the least s of a round that ends at e is an interval's bottom: the
    # fewest rounds to cover frames 0 .. e - 1 by a dynamic program
    fewest = np.zeros(n + 1, np.int64)
    for e in range(1, n + 1):
        lo = max(e - W, 0)
        s = max(lo, int(lim[lo + 1:e].max()) + 1) if e - lo > 1 else lo
        fewest[e] = 1 + fewest[s:e].min()
    assert len(starts) - 1 == fewest[n]
    assert len(starts) == len(seq.stereo_delay_wide_starts(el, er))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_backward_on_wide_rounds_is_the_loops(kind):
    """The plain backward on the wide plan, on the narrow plan and on its
    default rounds, against the adjoint step by step on the host: the same
    bits (a slot's sends added the later step first whatever the
    rounds)."""
    gout, g, dl, dr, el, er, lb, rb = _case(kind)
    loop = seq.stereo_delay_backward_loop(gout, g, dl, dr, lb, rb)
    args = (torch.from_numpy(gout), torch.from_numpy(g), el, er, lb, rb)
    for starts in (seq.stereo_delay_wide_back_starts(el, er),
                   _narrow_plan(el, er), None):
        got = seq.stereo_delay_backward_ref(*args, starts=starts).numpy()
        np.testing.assert_array_equal(got, loop)


def _chunk_marks(el, er) -> np.ndarray:
    """The wide backward's producers' marks a 32-frame chunk: bit 0 (1)
    where a frame sends nothing to the left (right) row or its target
    there lies above its next frame's."""
    n = len(el)
    t = np.arange(n)
    tl, tr = t - el, t - er
    bad_l = (el == 0) | (tl < 0)
    bad_r = tr < 0
    bad_l[:-1] |= tl[:-1] > tl[1:]
    bad_r[:-1] |= tr[:-1] > tr[1:]
    chunks = -(-n // 32)
    pad = chunks * 32 - n
    bl = np.pad(bad_l, (0, pad)).reshape(chunks, 32).any(1)
    br = np.pad(bad_r, (0, pad)).reshape(chunks, 32).any(1)
    return bl.astype(np.int64) | (br.astype(np.int64) << 1)


def _planned_start(lim, chunk_max, e: int) -> int:
    """The kernel's planner: the chunk of e - 1 frame by frame, the 32
    chunks below it by their maxima."""
    lo = max(e - W, 0)
    if e - lo <= 1:
        return lo
    top = (e - 1) // 32
    most = max(int(lim[f]) for f in range(top * 32, e) if f > lo)
    for c in range(top - 1, top - 33, -1):
        if c >= 0 and c * 32 + 31 > lo:
            most = max(most, int(chunk_max[c]))
    return max(lo, most + 1)


def wide_backward_emulated(gout, g, el, er, lb: int, rb: int):
    """The wide backward kernel's order of operations on the host in
    float32, step by step: its planner's rounds from the end, each step's
    gw_R, sends, gw_L from its slots' sums, then each side's sends either
    by run heads (no mark on the round: every step sends, targets rising)
    or one warp's chunks of 32 from the top, the lanes that send to one
    slot added in lane order. Returns (gw, the rounds, how many rounds took
    the heads' way on each side)."""
    n = gout.shape[1]
    go = seq._shifted_gout(torch.from_numpy(gout), lb, rb).numpy()
    lim = seq._round_limits(el, er)
    chunks = -(-n // 32)
    chunk_max = np.pad(lim, (0, chunks * 32 - n),
                       constant_values=np.iinfo(np.int64).max).reshape(
        chunks, 32).max(1)
    marks = _chunk_marks(el, er)
    acc = np.zeros((2, n), np.float32)
    gw = np.zeros((2, n), np.float32)
    f32 = np.float32
    starts, heads = [], [0, 0]
    e = n
    while e > 0:
        s = _planned_start(lim, chunk_max, e)
        starts.append(s)
        sends = np.zeros((2, e - s), np.float32)
        rk = np.zeros((2, e - s), np.float32)
        for t in range(s, e):
            tl, tr = t - el[t], t - er[t]
            rk[0, t - s] = acc[0, tl] if tl >= 0 else 0
            rk[1, t - s] = acc[1, tr] if tr >= 0 else 0
            gr = f32(go[1, t] + acc[1, t])
            s_l = f32(g[t] * gr)
            gl = f32(go[0, t] + (f32(acc[0, t] + s_l) if el[t] == 0
                                 else acc[0, t]))
            sends[:, t - s] = (s_l, f32(g[t] * gl))
            gw[:, t] = (gl, gr)
        m = int(np.bitwise_or.reduce(marks[s // 32:(e - 1) // 32 + 1]))
        for side, dist in ((0, el), (1, er)):
            if not m & (1 << side):
                heads[side] += 1
                for t in range(s, e):
                    tg = t - dist[t]
                    if t + 1 == e or t + 1 - dist[t + 1] != tg:
                        total = rk[side, t - s]
                        u = t
                        while u >= s and u - dist[u] == tg:
                            total = f32(total + sends[side, u - s])
                            u -= 1
                        acc[side, tg] = total
                continue
            for top in range(e - 1, s - 1, -32):
                lanes = [top - j for j in range(32) if top - j >= s]
                targets = {}
                for t in lanes:       # lane order: the later step first
                    tg = t - dist[t]
                    if tg >= 0 and (side == 1 or dist[t] > 0):
                        targets.setdefault(tg, []).append(t)
                for tg, steps in targets.items():
                    total = acc[side, tg]
                    for t in steps:
                        total = f32(total + sends[side, t - s])
                    acc[side, tg] = total
        e = s
    return gw, np.array(starts[::-1] + [n]), heads


@pytest.mark.parametrize("kind", KINDS)
def test_kernels_order_of_adds_gives_the_loops_bits(kind):
    """The wide backward's order emulated on the host (its planner on the
    chunks' maxima, its chunk marks, each round's sends by run heads or by
    one warp's chunks): the loop's bits; its rounds the host planner's;
    the runs of one target on a rising delay and the marked rounds (no
    send at el = 0 or before the start, falling targets) both taken."""
    gout, g, dl, dr, el, er, lb, rb = _case(kind)
    gw, starts, heads = wide_backward_emulated(gout, g, el, er, lb, rb)
    np.testing.assert_array_equal(
        gw, seq.stereo_delay_backward_loop(gout, g, dl, dr, lb, rb))
    np.testing.assert_array_equal(starts,
                                  seq.stereo_delay_wide_back_starts(el, er))
    rounds = len(starts) - 1
    # the first rounds' targets lie before the start: marked
    assert max(heads) < rounds, heads
    if kind != "mixed":
        assert min(heads) > 0, heads


def test_gradient_on_wide_rounds_matches_jax_grad(monkeypatch):
    """The gradient in the signal and a 0-d decay through the port's swept
    Audio.stereo_delay, its backward's plain version on the wide kernel's
    rounds, against jax.grad through flan_tpu's loop: a sweep whose reads
    all lie 1,120 frames back or more (the wide regime), at 1 s of 8 kHz;
    TOL_GRAD of each peak."""
    def lt(m):
        return lambda t: 0.2 + 0.06 * m.sin(3.0 * t)

    def rt(m):
        return lambda t: 0.15 + 0.1 * t
    n = 8000
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, n)).astype(np.float32)
    weight = rng.standard_normal((2, n)).astype(np.float32)
    plans = []
    plain = seq.stereo_delay_backward_ref

    def on_wide_rounds(gout, g, el, er, lb, rb, **kw):
        near = seq._nearest_read(el, er)
        assert near >= seq.STEREO_BACK_WIDE_FROM
        starts = seq.stereo_delay_wide_back_starts(el, er)
        plans.append(len(starts) - 1)
        return plain(gout, g, el, er, lb, rb, starts=starts)
    monkeypatch.setattr(seq, "stereo_delay_backward_ref", on_wide_rounds)

    def jax_loss(xv, d):
        y = flan_tpu.Audio.create_from_array(xv, SR).stereo_delay(
            1.0, lt(jnp), rt(jnp), d).data
        return jnp.sum(y * weight)
    gx_j, gd_j = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.float32(0.6))
    xv = torch.from_numpy(x).requires_grad_()
    d = torch.tensor(0.6, requires_grad=True)
    y = flan_tpu_torch.Audio.create_from_array(xv, SR).stereo_delay(
        1.0, lt(torch), rt(torch), d).data
    gx_t, gd_t = torch.autograd.grad((y * torch.from_numpy(weight)).sum(),
                                     (xv, d))
    assert len(plans) == 1 and plans[0] >= 8
    for got, want in ((gx_t.numpy(), np.array(gx_j)),
                      (gd_t.numpy(), np.array(gd_j))):
        assert (np.abs(got - want).max()
                <= TOL_GRAD * max(np.abs(want).max(), 1e-30))
