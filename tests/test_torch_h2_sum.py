"""The invariant H2's cycle sums rest on (csrc/pv_stage_kernels.cu).

ops/phase_math.py cumsum_mod1_frames sums the increments of each block of
256 frames in float64, in frame order. H2 sums them in any order instead:
each warp sums its 16 frames, and the warps' sums are added in whatever
order. That gives the same bits wherever every increment of a column is a
multiple of 2^-45 (every float32 in [2^-22, 1], and 0): each partial sum of
a block, below 2^8, is then a whole number of 2^-45 under 2^53 of them,
which float64 holds exactly, so no order rounds. The same sums as an int64
fixed-point scan of q = inc 2^45 agree bit for bit. A column holding
another increment (0 < inc < 2^-22 with low bits set) is detected by the
kernel's test (inc 2^45 not whole) and summed in frame order.

On seeded numpy inputs, in torch on the CPU (one thread); nothing here
needs the card.
"""
import numpy as np
import pytest
import torch

from flan_tpu_torch.ops.phase_math import (_MOD1_BLOCK, clean_columns,
                                           cumsum_mod1_frames)

torch.set_num_threads(1)

SEG = 16                   # frames a warp of H2 sums
FIXED = 2.0 ** 45


def increments(shape, seed, *, tiny_columns=()):
    """float32 increments in [0, 1] from a seed: uniform values, zeros,
    1.0, values at and just above 2^-22 and small multiples of 2^-45; the
    columns (bin indices) in tiny_columns also get values below 2^-22 that
    are no multiple of 2^-45, early and late in each block (late, where
    the sum has grown, they round)."""
    rng = np.random.default_rng(seed)
    inc = rng.random(shape, dtype=np.float32)
    inc[rng.random(shape) < 0.05] = 0.0
    inc[rng.random(shape) < 0.02] = 1.0
    edge = np.float32(2.0 ** -22)
    near = rng.random(shape) < 0.03
    inc[near] = edge + rng.integers(0, 64, near.sum()).astype(
        np.float32) * np.spacing(edge)
    small = rng.random(shape) < 0.02
    inc[small] = (rng.integers(1, 2 ** 20, small.sum()).astype(np.float64)
                  / FIXED).astype(np.float32)
    for col in tiny_columns:
        for first in (7, 200, 231):
            frames = np.arange(first, shape[1], _MOD1_BLOCK)
            inc[:, frames, col] = np.float32(3.4e-8)
    return torch.from_numpy(inc)


def blocks(inc):
    c, f, b = inc.shape
    fpad = -(-f // _MOD1_BLOCK) * _MOD1_BLOCK
    x = torch.nn.functional.pad(inc, (0, 0, 0, fpad - f))
    return x.reshape(c, fpad // _MOD1_BLOCK, _MOD1_BLOCK, b)


def within_in_order(inc):
    """The plain version's within-block sums: float64, in frame order."""
    return torch.cumsum(blocks(inc).double(), dim=2)


def within_fixed_point(inc):
    """The within-block sums as an int64 scan of inc 2^45, back in float64."""
    q = (blocks(inc).double() * FIXED).to(torch.int64)
    return torch.cumsum(q, dim=2).double() / FIXED


def within_by_segments(inc, seed):
    """H2's order: each segment of SEG frames summed in order from its
    start, the start the earlier segments' sums added in a shuffled order
    (any order the warps' sums may meet in)."""
    x = blocks(inc).double()
    c, nb, blk, b = x.shape
    seg = x.reshape(c, nb, blk // SEG, SEG, b)
    sums = seg.sum(dim=3)           # a segment's own sum
    starts = torch.zeros_like(sums)
    rng = np.random.default_rng(seed)
    for s in range(1, blk // SEG):
        acc = torch.zeros_like(sums[:, :, 0])
        for t in rng.permutation(s):
            acc = acc + sums[:, :, t]
        starts[:, :, s] = acc
    run = starts.clone()
    out = torch.empty_like(seg)
    for u in range(SEG):
        run = run + seg[:, :, :, u]
        out[:, :, :, u] = run
    return out.reshape(c, nb, blk, b)


def cycles_from_within(within, f):
    """cumsum_mod1_frames' chain from the within-block sums: the blocks'
    totals mod 1 summed in order, each block's prefix that sum mod 1."""
    c, nb, blk, b = within.shape
    totals = torch.remainder(within[:, :, -1, :], 1.0)
    prefix = torch.zeros((c, nb, b), dtype=torch.float64)
    run = torch.zeros((c, b), dtype=torch.float64)
    for k in range(nb):
        prefix[:, k] = torch.remainder(run, 1.0)
        run = run + totals[:, k]
    out = torch.remainder(within + prefix[:, :, None, :], 1.0)
    return out.reshape(c, nb * blk, b)[:, :f].float()


def h2_route(inc, seed):
    """The cycles as H2 forms them: clean columns by segments in any
    order, the others in frame order, then the chain."""
    ordered = within_in_order(inc)
    clean = clean_columns(inc)[:, :, None, :]
    within = torch.where(clean, within_by_segments(inc, seed), ordered)
    return cycles_from_within(within, inc.shape[1])


@pytest.mark.parametrize("frames", [1, 255, 256, 300, 4096, 9001])
def test_fixed_point_scan_is_the_float64_sum_in_order(frames):
    inc = increments((2, frames, 37), frames)
    assert bool(clean_columns(inc).all())
    assert torch.equal(within_fixed_point(inc), within_in_order(inc))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frames", [256, 2048, 4100])
def test_segment_sums_in_any_order_are_the_sum_in_order(frames, seed):
    inc = increments((2, frames, 33), 100 + seed)
    assert torch.equal(within_by_segments(inc, seed), within_in_order(inc))


@pytest.mark.parametrize("frames", [700, 4096])
def test_h2_route_gives_cumsum_mod1_frames_bits(frames):
    inc = increments((2, frames, 35), frames, tiny_columns=(3, 20, 21))
    assert torch.equal(h2_route(inc, 7), cumsum_mod1_frames(inc))


def test_a_column_with_a_non_multiple_is_detected():
    inc = increments((1, 512, 40), 5, tiny_columns=(11,))
    clean = clean_columns(inc)
    assert not bool(clean[0, :, 11].any())
    assert bool(clean[0, :, :11].all()) and bool(clean[0, :, 12:].all())
    # values at 2^-22 and above, 1.0, 0 and multiples of 2^-45 pass
    edge = np.float32(2.0 ** -22)
    ok = torch.tensor([0.0, 1.0, edge, np.nextafter(edge, np.float32(1)),
                       0.5, 2.0 ** -45, 3 * 2.0 ** -45], dtype=torch.float32)
    bad = torch.tensor([np.nextafter(edge, np.float32(0)), 3.4e-8, 1e-30,
                        2.0 ** -46], dtype=torch.float32)
    for vals, want in ((ok, True), (bad, False)):
        q = vals * np.float32(FIXED)
        assert bool(((q == torch.trunc(q)) == want).all())


def test_a_non_multiple_breaks_the_orderless_sum():
    """Why the kernel walks such a column in frame order: where the sum
    has grown past 2^5, an increment of 3.4e-8 rounds, and summed by
    segments the column parts from the sequential bits; a column of the
    same values without it does not."""
    rng = np.random.default_rng(9)
    inc = (0.5 + 0.5 * rng.random((1, 256, 2))).astype(np.float32)
    inc[0, 150::3, 0] = np.float32(3.4e-8)
    inc = torch.from_numpy(inc)
    clean = clean_columns(inc)
    assert not bool(clean[0, 0, 0]) and bool(clean[0, 0, 1])
    by_segments, in_order = within_by_segments(inc, 3), within_in_order(inc)
    assert not torch.equal(by_segments[..., 0], in_order[..., 0])
    assert torch.equal(by_segments[..., 1], in_order[..., 1])
    assert torch.equal(h2_route(inc, 3), cumsum_mod1_frames(inc))
