"""The salience histogram's order on colliding inputs, on the CPU: frames
whose peaks share one frequency or integer ratios of it, so that many
(k, h) contributions of a frame land on one bin and every chunk of 32
consecutive contributions (the kernel's, csrc/pv_info_kernels.cu: a lane
each) holds lanes that hit one cell. The port's get_salience against the
JAX package's own (flan_tpu/pv/information.py get_salience: its peaks,
scatter and spread) on a PV whose magnitude peaks sit at such
frequencies; and the plain version's rows before the spread against a
numpy loop that adds every contribution in (k, h) order one at a time:
the order the kernel keeps, to which the card test
(tests/test_torch_cuda_pv_info.py) holds the kernel bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from flan_tpu.pv import information as j_info
from flan_tpu.pv.pv import PV as JPV
from flan_tpu_torch.convert import pv_from_numpy
from flan_tpu_torch.ops import pv_info_kernels as pk
from flan_tpu_torch.pv import information
from test_torch_cuda_pv_info import colliding_peaks

# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements.
torch.set_num_threads(1)

LOG2_MIN = math.log2(55.0)
WIDTH = 620
# salience against JAX, times its peak: the same contributions added in
# the same order on the CPU, then XLA's cos taps (four an ulp off) and its
# convolution's sum order (1.2e-7 read on the tonal PV,
# tests/test_torch_pv_information.py); bound 1e-6
TOL_SAL = 1e-6

# The colliding PV's geometry: 8 kHz, a DFT of 1024 (7.8125 Hz bins) over
# a window of 32, so that a peak's frequency may lie up to 32 bins from
# its own bin and keep the amplitude correction's kernel above 0.5: 32
# peaks of a frame can carry one frequency
PV_SR, PV_DFT, PV_WIN, PV_HOP = 8000.0, 1024, 32, 8
PV_FRAMES = 8


def colliding_pv(seed: int = 4):
    """(port PV on the CPU, JAX PV) of one channel, 8 frames of
    PV_DFT / 2 + 1 bins, zero but at its peaks (strict local maxima,
    magnitudes in [0.1, 2]), each peak's frequency plane entry its chosen
    frequency: frames 0-2 32 peaks at one frequency (1500, 1200, 1111 Hz,
    every chunk of 32 contributions colliding), frame 3 16 peaks at 750
    and 16 at 1500 Hz, frame 4 a harmonic series on 110 Hz with every
    seventh peak dead (frequency 0), frame 5 integer ratios of 220 Hz,
    frame 6 no peak, frame 7 32 peaks at random bins and frequencies."""
    rng = np.random.default_rng(seed)
    bins = PV_DFT // 2 + 1
    bw = PV_SR / PV_DFT
    mag = np.zeros((1, PV_FRAMES, bins), np.float32)
    freq = np.tile(np.arange(bins, dtype=np.float32) * np.float32(bw),
                   (1, PV_FRAMES, 1))
    odd = np.arange(-31, 32, 2)

    def place(frame, at, hz):
        mag[0, frame, at] = rng.uniform(0.1, 2.0, len(at))
        freq[0, frame, at] = hz

    for frame, hz in enumerate((1500.0, 1200.0, 1111.0)):
        place(frame, round(hz / bw) + odd, hz)
    place(3, round(750.0 / bw) + odd[8:24], 750.0)
    place(3, round(1500.0 / bw) + odd[8:24], 1500.0)
    series = 110.0 * np.arange(1, 31)
    series[2::7] = 0.0
    place(4, np.rint(110.0 * np.arange(1, 31) / bw).astype(int), series)
    ratios = sorted({220.0 * a / b for a in range(1, 6) for b in range(1, 4)})
    taken, at = set(), []
    for hz in ratios:
        b = round(hz / bw)
        while {b - 1, b, b + 1} & taken:
            b += 2
        taken.add(b)
        at.append(b)
    place(5, np.array(at), np.array(ratios))
    at = np.sort(rng.choice(np.arange(4, 200), 32, replace=False)) * 2
    place(7, at, (at + rng.uniform(-0.4, 0.4, 32)) * bw)
    return (pv_from_numpy(mag, freq, PV_SR, PV_HOP, PV_WIN, device="cpu"),
            JPV(mag=jnp.asarray(mag), freq=jnp.asarray(freq),
                sample_rate=PV_SR, hop_size=PV_HOP, window_size=PV_WIN))


def rows_one_at_a_time(i_f, i_m, width: int, log2_min: float) -> np.ndarray:
    """Each frame's row before the spread: every contribution's bin from
    numpy (the float64 log2 rounded to float32, then float32 arithmetic),
    added in (k, h) order one at a time in float32 from zeros."""
    i_f, i_m = np.asarray(i_f, np.float32), np.asarray(i_m, np.float32)
    frames, k_cnt = i_f.shape
    h = np.arange(1, 21, dtype=np.float32)
    sub = np.maximum(i_f[..., None] / h, np.float32(1e-9))
    lg = np.log2(sub.astype(np.float64)).astype(np.float32)
    bins = np.rint(np.float32(120.0) * (lg - np.float32(log2_min)))
    vals = pk.alpha_powers()[None, None, :] * i_m[..., None]
    rows = np.zeros((frames, width), np.float32)
    for f in range(frames):
        for k in range(k_cnt):
            if not i_f[f, k] > 0 or i_m[f, k] == 0:
                continue
            for j in range(20):
                b = int(bins[f, k, j])
                if 0 <= b < width - 10:
                    rows[f, b + 10] = np.float32(rows[f, b + 10]
                                                 + vals[f, k, j])
    return rows


def _chunk_collisions(i_f, i_m, width: int, log2_min: float) -> list:
    """How many chunks of 32 consecutive contributions (the kernel's) of
    each frame hold two lanes that hit one cell, and how many chunks."""
    flat, contrib = pk.subharmonic_contributions(
        torch.from_numpy(i_f), torch.from_numpy(i_m), width, log2_min)
    out = []
    for f in range(i_f.shape[0]):
        cells = flat[f].reshape(-1).numpy()
        live = contrib[f].reshape(-1).numpy() != 0
        hits = 0
        chunks = -(-len(cells) // 32)
        for c in range(chunks):
            sl = slice(32 * c, 32 * c + 32)
            cl = cells[sl][live[sl]]
            hits += len(cl) != len(np.unique(cl))
        out.append((hits, chunks))
    return out


def test_colliding_peaks_collide_in_every_chunk():
    """The inputs do what the tests below need: in the frames built on one
    frequency, every chunk of 32 contributions has a collision."""
    i_f, i_m = (t.numpy() for t in colliding_peaks())
    per_frame = _chunk_collisions(i_f, i_m, WIDTH, LOG2_MIN)
    for hits, chunks in per_frame[:3]:
        assert hits == chunks
    assert sum(h for h, _ in per_frame) > len(per_frame)


def test_colliding_pv_peaks_collide_in_every_chunk():
    """The PV's peaks, as the port picks them, are the chosen ones: 32 a
    frame at one frequency in frames 0-2, whose every chunk of 32
    contributions has a collision; none in frame 6."""
    pv, _ = colliding_pv()
    i_f, i_m = information.salience_peaks(pv, 0)
    assert i_f.shape == (PV_FRAMES, 32)
    for frame, hz in enumerate((1500.0, 1200.0, 1111.0)):
        assert (i_f[frame] == hz).all() and (i_m[frame] > 0).all()
    assert (i_m[6] == 0).all()
    per_frame = _chunk_collisions(i_f.numpy(), i_m.numpy(), WIDTH, LOG2_MIN)
    for hits, chunks in per_frame[:3]:
        assert hits == chunks == 20


def test_plain_salience_matches_jax_on_colliding_peaks():
    """The port's get_salience against the JAX package's own on the
    colliding PV (its peaks, their amplitude correction, the scatter-add
    in flat order and the spread; the plain version on the CPU), TOL_SAL
    of the peak."""
    pv, jpv = colliding_pv()
    got = information.get_salience(pv, 0)
    want = j_info.get_salience(jpv, 0)
    assert (got.num_frames, got.num_bins) == (want.num_frames,
                                              want.num_bins)
    g, w = np.asarray(got.buffer), np.array(want.buffer)
    assert g.shape == w.shape == (PV_FRAMES, WIDTH - 20)
    assert np.abs(w).max() > 0
    assert np.abs(g - w).max() <= TOL_SAL * np.abs(w).max()


def test_plain_rows_are_the_one_at_a_time_sums():
    """The plain version's rows before the spread (index_add_ in flat
    order) against every contribution added in (k, h) order one at a time:
    the same bits; and the whole plain salience the spread of those
    rows."""
    i_f, i_m = colliding_peaks()
    flat, contrib = pk.subharmonic_contributions(i_f, i_m, WIDTH, LOG2_MIN)
    rows = pk.histogram_rows_ref(flat, contrib, i_f.shape[0], WIDTH).numpy()
    want = rows_one_at_a_time(i_f.numpy(), i_m.numpy(), WIDTH, LOG2_MIN)
    np.testing.assert_array_equal(rows, want)
    np.testing.assert_array_equal(
        pk.salience_histogram_ref(i_f, i_m, WIDTH, LOG2_MIN).numpy(),
        pk.spread_ref(torch.from_numpy(want)).numpy())
