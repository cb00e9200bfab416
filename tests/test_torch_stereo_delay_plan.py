"""The swept stereo delay's plan on the card, in its plain forms
(ops/sequential_kernels.py): the reads' distances worked out from the
float32 delay samples against flan_tpu/audio/temporal.py:457-461, and the
rounds each kernel works out for itself (the narrow kernels' producers'
rule, the wide forward's chunk search) against the host's planner,
stereo_delay_round_starts, with every round legal. Inputs are made with numpy from a seed; no tolerance: integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.func.function import as_function as jax_function
from flan_tpu_torch.audio import temporal
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops import sequential_kernels as seq

TILE, WIDTH, WIDE = seq.STEREO_TILE, seq.STEREO_WIDTH, seq.STEREO_WIDE_WIDTH


def _reads(n: int, kind: str, seed: int = 0):
    """(el, er) int64 [n] of a call: a flanger's few frames back
    ("narrow"), tens to hundreds ("medium"), more than a tile back
    ("wide"), anywhere in a ring of 300 / 40 ("random"), only the ends of
    the rings ("ends"), and steps mixing 1 and a tile and more ("mixed")."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "narrow":
        dl = (12 + 6 * np.sin(t / 300.0)).astype(np.int64)
        dr = (15 + 9 * np.cos(t / 170.0)).astype(np.int64)
        lb, rb = 19, 25
    elif kind == "medium":
        dl = (150 + 110 * np.sin(t / 500.0)).astype(np.int64)
        dr = (40 + 30 * np.cos(t / 90.0)).astype(np.int64)
        lb, rb = 261, 71
    elif kind == "wide":
        dl = (2000 + 800 * np.sin(t / 700.0)).astype(np.int64)
        dr = (1100 + 100 * np.cos(t / 400.0)).astype(np.int64)
        lb, rb = 2800, 1200
    elif kind == "random":
        lb, rb = 300, 40
        dl, dr = rng.integers(0, lb + 1, n), rng.integers(0, rb + 1, n)
    elif kind == "ends":
        lb, rb = 64, 3000
        dl, dr = rng.choice([0, 1, lb], n), rng.choice([0, 1, rb], n)
    else:
        lb, rb = 2047, 2048
        dl = rng.choice([0, 1, 3, 1023, 1024, 1025, 2047], n)
        dr = rng.choice([1, 2, 1024, 1500, 2048], n)
    return seq.stereo_delay_distances(dl, dr, lb, rb)


KINDS = ["narrow", "medium", "wide", "random", "ends", "mixed"]
LENGTHS = [1, 31, 1025, 4000]


def _lim(el, er):
    t = np.arange(len(el))
    return np.maximum(t - er, np.where(el > 0, t - el, -1))


def _check_legal(starts, el, er, width: int, tile: int):
    """Rounds of starts (then n) that cover the call in order, each at most
    `width` frames, within a tile when there are tiles, and each frame of a
    round reading only frames before its first."""
    lim = _lim(el, er)
    assert starts[0] == 0 and starts[-1] == len(el)
    assert np.all(np.diff(starts) > 0)
    for s, e in zip(starts[:-1], starts[1:]):
        assert e - s <= width
        if tile:
            assert s // tile == (e - 1) // tile
        assert np.all(lim[s:e] < s)


def _window_rounds(el, er, reverse: bool):
    """The narrow kernels' producers' rule, written out frame by frame: a
    round from frame p (backward: down from p) holds min(WIDTH, the least
    nearer read a = min(er, el > 0 ? el : inf) of the WIDTH frames from p
    on (down from p) within p's tile, the frames left in the tile)."""
    n = len(el)
    a = np.where(el > 0, np.minimum(el, er), er)
    out = []
    tops = range(-(-n // TILE) * TILE, 0, -TILE) if reverse else \
        range(0, n, TILE)
    for edge in tops:
        if reverse:
            p, lo = min(edge, n) - 1, edge - TILE
            while p >= lo:
                out.append(p)
                p -= min(WIDTH, a[max(p - WIDTH + 1, lo):p + 1].min(),
                         p - lo + 1)
        else:
            p, hi = edge, min(edge + TILE, n)
            while p < hi:
                out.append(p)
                p += min(WIDTH, a[p:min(p + WIDTH, hi)].min(), hi - p)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_narrow_forward_rounds_are_the_producers(kind, n):
    """The narrow forward's rounds (stereo_delay_narrow_starts, the comb's
    rule in tiles) as its producers' rule gives them frame by frame, each
    legal; never fewer than the fewest the same caps allow
    (stereo_delay_round_starts at the tile and a warp's width); on a
    sweep of reads 6 to 24 frames back within 5% of them (2.7% read; on
    phase 9's flanger at 600 s, 0.02%)."""
    el, er = _reads(n, kind)
    plan = np.array(seq.stereo_delay_narrow_starts(el, er) + [n])
    assert np.array_equal(plan[:-1], _window_rounds(el, er, False))
    _check_legal(plan, el, er, WIDTH, TILE)
    fewest = seq.stereo_delay_round_starts(el, er, TILE, WIDTH)
    _check_legal(fewest, el, er, WIDTH, TILE)
    assert len(plan) >= len(fewest)
    if kind == "narrow":
        assert len(plan) <= 1.05 * len(fewest)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_narrow_backward_rounds_run_from_the_end(kind, n):
    """stereo_delay_narrow_starts(.., reverse=True): each round's last
    frame, tiles from the last and each from its last frame down, as the
    producers' rule gives them; the rounds, reversed, cover the call, each
    legal (no step of it sends to another: the forward's condition),
    within a tile and a warp."""
    el, er = _reads(n, kind, seed=1)
    ends = seq.stereo_delay_narrow_starts(el, er, reverse=True)
    assert ends == _window_rounds(el, er, True)
    assert ends[0] == n - 1
    firsts = [e + 1 for e in ends[1:]] + [0]
    starts = np.array(sorted(firsts) + [n])
    assert np.array_equal(np.sort(np.array(ends)), starts[1:] - 1)
    _check_legal(starts, el, er, WIDTH, TILE)


def _wide_plan_emulated(el, er):
    """The wide kernel's planner (csrc/sequential_kernels.cu
    stereo_delay_wide, plan_end) step by step: the chunks of 32 frames'
    greatest lim (past the call: the largest int), a ballot over the 64
    chunks from the one after the round's first frame that start before
    min(first + WIDE, n), then one over the 32 frames of the first chunk
    found."""
    n = len(el)
    lim = _lim(el, er)
    chunks = -(-(n + 4 * TILE) // 32)
    padded = np.full(chunks * 32, np.iinfo(np.int32).max, np.int64)
    padded[:n] = lim
    most = padded.reshape(chunks, 32).max(1)
    starts, e = [0], 0
    while e < n:
        hi = min(e + WIDE, n)
        if e + 1 >= hi:
            e = hi
        else:
            c0 = (e + 1) // 32
            hits = [c for c in range(c0, c0 + 64)
                    if c * 32 < hi and most[c] >= e]
            if not hits:
                e = hi
            else:
                c = hits[0]
                f = [c * 32 + j for j in range(32)
                     if e < c * 32 + j < hi and padded[c * 32 + j] >= e]
                e = f[0] if f else hi
        starts.append(e)
    return np.array(starts)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_wide_rounds_are_the_fewest_of_a_tile_across_tiles(kind, n):
    """The wide kernel's chunk search gives the host planner's rounds with
    no tiles and its width's cap (stereo_delay_wide_starts), each legal;
    where every read lies more than a tile back, each round but the last
    holds the whole width."""
    el, er = _reads(n, kind, seed=2)
    plan = seq.stereo_delay_wide_starts(el, er)
    assert np.array_equal(_wide_plan_emulated(el, er), plan)
    _check_legal(plan, el, er, WIDE, 0)
    assert len(plan) <= len(seq.stereo_delay_round_starts(el, er, TILE,
                                                          WIDTH))
    assert len(plan) <= len(seq.stereo_delay_narrow_starts(el, er)) + 1
    near = np.where(el > 0, np.minimum(el, er), er)
    if near.min() > WIDE:
        assert np.all(np.diff(plan)[:-1] == WIDE)


@pytest.mark.parametrize("sr", [8000.0, 44100.0, 48000.0])
@pytest.mark.parametrize("kind", ["sweep", "integers", "clamped"])
def test_reads_from_float32_samples_match_flan_tpus_rule(sr, kind):
    """stereo_delay_frames and stereo_delay_reads (PyTorch, on the call's
    device) from float32 delay samples and from a constant, against the
    JAX package's numpy (flan_tpu/audio/temporal.py:457-461: the samples
    widened to float64, times sr, truncated, clamped to [0, ring]; then
    the distances): equal at every frame, the rings too; samples on whole
    frames (k / sr in float32, which truncate to k - 1 or k), and below 0
    and past the ring's sample."""
    n = 4000
    rng = np.random.default_rng(int(sr))
    if kind == "sweep":
        lt = (0.01 + 0.008 * np.sin(np.arange(n) / 97.0)).astype(np.float32)
        rt = rng.uniform(0.0, 0.02, n).astype(np.float32)
    elif kind == "integers":
        lt = (rng.integers(0, 300, n) / np.float32(sr)).astype(np.float32)
        rt = (rng.integers(1, 160, n) / np.float32(sr)).astype(np.float32)
    else:
        lt = rng.uniform(-0.01, 0.03, n).astype(np.float32)
        rt = np.where(rng.random(n) < 0.5, np.float32(0.0),
                      np.float32(0.02)).astype(np.float32)
    for rt_v in (rt, 0.0135):
        lt_s = lt.astype(np.float64)
        rt_s = (rt.astype(np.float64) if isinstance(rt_v, np.ndarray)
                else np.full(n, rt_v, np.float64))
        lb, rb = int(lt_s.max() * sr), int(rt_s.max() * sr)
        dl = np.minimum(np.maximum((lt_s * sr).astype(np.int64), 0), lb)
        dr = np.minimum(np.maximum((rt_s * sr).astype(np.int64), 0), rb)
        el_h, er_h = seq.stereo_delay_distances(dl, dr, lb, rb)
        lt_t = torch.from_numpy(lt)
        rt_t = torch.from_numpy(rt) if isinstance(rt_v, np.ndarray) else rt_v
        assert (temporal._ring_frames(lt_t, sr),
                temporal._ring_frames(rt_t, sr)) == (lb, rb)
        el, er = seq.stereo_delay_reads(
            seq.stereo_delay_frames(lt_t, sr, lb, n, "cpu"),
            seq.stereo_delay_frames(rt_t, sr, rb, n, "cpu"), lb, rb)
        assert el.dtype == er.dtype == torch.int32
        assert np.array_equal(el.numpy(), el_h)
        assert np.array_equal(er.numpy(), er_h)


@pytest.mark.parametrize("fn", [0.0213, lambda m: lambda t: 0.02 + 0.01 * t,
                                lambda m: lambda t: 0.005 + 0.0 * t])
def test_delay_samples_are_flan_tpus(fn):
    """sample_delay_times: a constant as the number (the JAX package fills
    float64 with it), a callable's float32 values on the float32 grid
    arange(n) / sr, what the JAX package widens (temporal.py:467-473), bit
    for bit."""
    n, sr = 3001, 8000.0
    got = temporal.sample_delay_times(
        as_function(fn if not callable(fn) else fn(torch)), n, sr)
    jfn = jax_function(fn if not callable(fn) else fn(jnp))
    if jfn.is_constant:
        assert got == float(jfn.constant_value)
        return
    t = jnp.arange(n, dtype=jnp.float32) / sr
    want = np.broadcast_to(np.asarray(jfn(t), np.float64).reshape(-1), (n,))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy().astype(np.float64), want)
