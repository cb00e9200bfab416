"""flan_tpu_torch's temporal methods (audio/temporal.py) and the swept
stereo delay's plain version and round schedule (ops/sequential_kernels.py)
against flan_tpu on the CPU, against a literal ring-buffer loop, and
against the compiled reference's goldens (tests/test_algo_golden.py:
375-400) at their SNR floors. Inputs are made with numpy from a seed at
8 kHz; every tolerance names the reading it was set from (CPU).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.audio import temporal as jax_temporal
from flan_tpu_torch.audio import temporal
from flan_tpu_torch.func import interpolators
from flan_tpu_torch.ops import sequential_kernels as seq


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)


@pytest.fixture
def torch_thread_pool():
    """torch's intra-op pool (up to 8 threads) for one case, back to one
    after it: a CPU fault that shows only where a worker thread computes
    part of a call (C.17, torch's CPU sin on its first call) stays
    visible."""
    torch.set_num_threads(min(os.cpu_count() or 2, 8))
    yield
    torch.set_num_threads(1)


SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

# sample paths against flan_tpu, times the peak: the same operations on the
# same float32 values, up to XLA's and torch's own roundings (0 to 3e-7
# read); bound 1e-5
TOL = 1e-5


def _noise(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _audios(x, sr=SR):
    return (flan_tpu.Audio.create_from_array(x, sr),
            flan_tpu_torch.Audio.create_from_array(x, sr, device="cpu"))


def _rel(got, want):
    got = got.to_numpy() if hasattr(got, "to_numpy") else np.asarray(got)
    want = np.array(want.data) if hasattr(want, "data") else np.array(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fixture(name):
    dims = tuple(int(v) for v in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return np.fromfile(os.path.join(FIXDIR, name + ".f32"),
                       dtype="<f4").reshape(dims)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    n = min(len(ref), len(got))
    err = float(((ref[:n] - got[:n]) ** 2).mean())
    return 10.0 * np.log10(max(float((ref[:n] ** 2).mean()), 1e-300)
                           / max(err, 1e-300))


def _golden_input():
    return flan_tpu_torch.Audio.create_from_array(_fixture("filt_sig"), SR,
                                                  device="cpu")


@pytest.mark.parametrize("name,call,snr", [
    ("temp_reverse", lambda a: a.reverse(), 120.0),
    ("temp_cut", lambda a: a.cut(0.01, 0.05), 120.0),
    ("temp_repitch_c", lambda a: a.repitch(1.5, 0.001), 40.0),
    ("temp_repitch_v", lambda a: a.repitch(lambda t: 0.75 + 8.0 * t, 0.001),
     40.0),
    ("temp_iterate", lambda a: a.iterate(3), 120.0),
])
def test_temporal_goldens(name, call, snr):
    """The compiled reference's outputs, at tests/test_algo_golden.py's
    floors."""
    ref = _fixture(name)
    got = call(_golden_input()).to_numpy()
    assert got.shape == ref.shape
    assert _snr_db(ref, got) >= snr


INTERP = {"flan_tpu": flan_tpu.func.interpolators,
          "flan_tpu_torch": interpolators}
CALLS = {
    "modify_boundaries_pad": lambda a: a.modify_boundaries(-0.01, 0.02),
    "modify_boundaries_trim": lambda a: a.modify_boundaries_frames(40, -90),
    "cut": lambda a: a.cut(0.02, 0.2, 0.005, 0.01),
    "cut_frames_clamped": lambda a: a.cut_frames(-20, 5000, 7, 0),
    "fade": lambda a: a.fade(0.03, 0.05),
    "fade_frames_smooth": lambda a: a.fade_frames(100, 3000, INTERP[type(
        a).__module__.split(".")[0]].smoothstep),
    "fade_overlapping": lambda a: a.fade_frames(2000, 2500),
    "remove_edge_silence": lambda a: a.remove_edge_silence(0.3, 0.002),
    "iterate": lambda a: a.iterate(2, 0.01),
    "repitch_constant": lambda a: a.repitch(1.5, 0.001),
    "repitch_swept": lambda a: a.repitch(lambda t: 0.6 + 5.0 * t, 0.002),
    "repitch_slow": lambda a: a.repitch(0.45, 0.001),
    "repitch_linear": lambda a: a.repitch(1.3, 0.001, "linear"),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_temporal_methods_match_flan_tpu(name):
    """Each method on both packages, within TOL of the peak (the repitch
    gathers' taps are summed in other orders: up to 2e-7 read)."""
    x = _noise((2, 2500), seed=1)
    x[:, :300] *= 0.01          # a quiet head for remove_edge_silence
    ja, ta = _audios(x)
    assert _rel(CALLS[name](ta), CALLS[name](ja)) < TOL


def test_loud_chunks_and_remove_silence_match_flan_tpu():
    x = _noise((1, 4000), seed=2)
    x[:, 1000:1700] = 0.0
    x[:, 2600:3000] *= 0.01
    ja, ta = _audios(x)
    got = ta.get_loud_chunks(0.2, 0.01, 0.002)
    want = ja.get_loud_chunks(0.2, 0.01, 0.002)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL
    assert _rel(ta.remove_silence(0.2, 0.01, 0.002),
                ja.remove_silence(0.2, 0.01, 0.002)) < TOL


@pytest.mark.parametrize("how", ["times", "lengths", "equal"])
def test_splits_match_flan_tpu(how):
    ja, ta = _audios(_noise((2, 3000), seed=3))
    args = {"times": ("split_at_times", [0.05, 0.2, 0.1, 9.0], 0.004),
            "lengths": ("split_with_lengths", [0.04, -1.0, 0.1], 0.0),
            "equal": ("split_with_equal_lengths", 0.07, 0.003)}[how]
    got = getattr(ta, args[0])(*args[1:])
    want = getattr(ja, args[0])(*args[1:])
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_randomness_gives_flan_tpus_chunks(seed):
    """rearrange and random_chunks draw from np.random.default_rng(seed)
    on the host in both packages: the same chunks, joined the same way."""
    ja, ta = _audios(_noise((1, 4000), seed=4))
    assert _rel(ta.rearrange(0.05, 0.005, seed=seed),
                ja.rearrange(0.05, 0.005, seed=seed)) < TOL
    assert _rel(ta.random_chunks(0.4, 0.04, 0.004, seed=seed),
                ja.random_chunks(0.4, 0.04, 0.004, seed=seed)) < TOL


def test_iterate_with_mod_and_feedback_matches_flan_tpu():
    ja, ta = _audios(_noise((2, 1200), seed=5))
    want = ja.iterate(3, 0.01, lambda a, t: a.modify_volume(0.5 + t), True)
    got = ta.iterate(3, 0.01, lambda a, t: a.modify_volume(0.5 + t), True)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("factor,gran", [
    (1.5, 0.001), (0.7, 0.0005), (lambda t: 0.75 + 8.0 * t, 0.001),
    (lambda t: 2.0 - 3.0 * t, 0.004)])
def test_wdl_plan_is_flan_tpus_bit_for_bit(factor, gran):
    """The host feed plan is a copy: the same positions and rates."""
    n = 2100
    g = max(1, int(round(gran * SR)))
    nblocks = -(-n // g)
    if callable(factor):
        tgrid = (np.arange(nblocks) * gran).astype(np.float32)
        fvals = np.asarray(factor(jnp.asarray(tgrid)), np.float32)
        const = False
    else:
        fvals = np.full(nblocks, factor, np.float32)
        const = True
    rates = np.clip((np.float32(1.0) / fvals).astype(np.float32),
                    np.float32(1e-3), np.float32(1e3))
    got = temporal._wdl_sinc_plan(n, g, rates, const)
    want = jax_temporal._wdl_sinc_plan(n, g, rates, const)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _delay_case(lb, rb, kind, n=1900):
    """x [2, n], g [n] float32 and delays dl, dr [n]: anywhere in [0,
    ring], only 0, 1 and the ring size ("ends"), or all 1 ("ones")."""
    rng = np.random.default_rng(lb * 7 + rb)
    x = _noise((2, n), seed=lb)
    g = rng.uniform(-0.95, 0.95, n).astype(np.float32)
    if kind == "random":
        dl, dr = rng.integers(0, lb + 1, n), rng.integers(0, rb + 1, n)
    elif kind == "ends":
        dl = rng.choice([0, 1, lb], n)
        dr = rng.choice([0, 1, rb], n)
    else:
        dl, dr = np.ones(n, np.int64), np.ones(n, np.int64)
    return x, g, dl, dr


DELAY_RINGS = [(1, 1, "random"), (40, 3, "random"), (97, 250, "random"),
               (64, 64, "ends"), (300, 17, "ends"), (200, 150, "ones")]


@pytest.mark.parametrize("lb,rb,kind", DELAY_RINGS)
def test_stereo_delay_plain_is_the_ring_loop(lb, rb, kind):
    """The plain version against the literal loop, bit for bit, outputs
    and writes, with delays anywhere in [0, ring], at 0 and the ring size
    (the slot the step reads or writes itself), at 1, and its rounds wide
    (4096, no tiles) and one tile of the kernel's; every frame by one
    step."""
    x, g, dl, dr = _delay_case(lb, rb, kind)
    want, w_want = seq.stereo_delay_loop(x, g, dl, dr, lb, rb)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl), torch.from_numpy(dr),
                                    lb, rb)
    for tile in (4096, seq.STEREO_TILE, 5):
        got, w = seq.stereo_delay_ref(xt, gt, el, er, lb, rb, keep_w=True,
                                      tile=tile)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(w.numpy(), w_want)
    step = seq.stereo_delay_step_errors(xt, gt, el, er, lb, rb, w)
    assert max(step.values()) < 1e-6    # 4e-8 to 7e-8 read
    assert seq.LAUNCHES["stereo_delay_swept"] == 0


@pytest.mark.parametrize("lb,rb,kind", DELAY_RINGS)
def test_stereo_delay_loop_is_the_float64_ring_loop(lb, rb, kind):
    """The literal loop (the kernel's oracle on the card) against the
    float64 transcription of tests/test_dormant_activations.py, its model,
    within float32's rounding carried through the rings (4.6e-8 to
    9.2e-8 of the peak read; bound 1e-5); its writes, shifted by the
    rings, are its outputs."""
    from test_dormant_activations import _ring_reference
    x, g, dl, dr = _delay_case(lb, rb, kind)
    out, w = seq.stereo_delay_loop(x, g, dl, dr, lb, rb)
    want = _ring_reference(x, x.shape[1], dl, dr, g, lb, rb)
    assert np.abs(out - want).max() <= TOL * np.abs(want).max()
    shifted = seq.stereo_delay_outputs(torch.from_numpy(w), lb, rb)
    assert np.array_equal(shifted.numpy(), out)


@pytest.mark.parametrize("n,tile", [(1, 1024), (1023, 1024), (1025, 1024),
                                    (5000, 1024), (5000, 64)])
def test_stereo_delay_rounds_read_only_earlier_values(n, tile):
    """stereo_delay_round_starts: rounds start at every tile, never cross
    one, and each frame of a round reads only frames before the round's
    start (its own L write aside); each round is the longest such."""
    rng = np.random.default_rng(n)
    el = rng.integers(0, 300, n)
    er = rng.integers(1, 300, n)
    starts = seq.stereo_delay_round_starts(el, er, tile)
    assert starts[0] == 0 and starts[-1] == n
    assert np.all(np.diff(starts) > 0)
    assert set(range(0, n, tile)) <= set(starts[:-1].tolist())
    for s, e in zip(starts[:-1], starts[1:]):
        t = np.arange(s, e)
        assert (s // tile) == ((e - 1) // tile)
        assert np.all(t - er[t] < s)
        assert np.all((el[t] == 0) | (t - el[t] < s))
        if e < n and e % tile:
            # the round ends where the next frame would read inside it
            assert e - er[e] >= s or (el[e] > 0 and e - el[e] >= s)


@pytest.mark.parametrize("l_time,r_time,decay", [
    (0.05, 0.08, 0.5), (0.013, 0.004, lambda t: 0.9 - t)])
def test_stereo_delay_constant_matches_flan_tpu(l_time, r_time, decay):
    """The constant path: one linear recurrence down [ceil(n / rb), rb],
    then the shifts, against flan_tpu and the ring loop (3e-8 read)."""
    x = _noise((2, 1500), seed=6)
    ja, ta = _audios(x)
    got = ta.stereo_delay(0.4, l_time, r_time, decay)
    assert _rel(got, ja.stereo_delay(0.4, l_time, r_time, decay)) < TOL
    out_n = int(0.4 * SR)
    lb, rb = int(l_time * SR), int(r_time * SR)
    g = np.asarray(flan_tpu.func.function.as_function(decay).sample_device(
        out_n, 1.0 / SR), np.float32)
    xp = np.pad(x, ((0, 0), (0, out_n - x.shape[1])))
    ring = seq.stereo_delay_loop(xp, g, np.full(out_n, lb), np.full(out_n, rb),
                                  lb, rb)[0]
    assert _rel(got, ring) < TOL


@pytest.mark.parametrize("l_time,r_time", [
    (lambda t: 0.03 + 0.0 * t, lambda t: 0.05 + 0.0 * t),
    (lambda t: 0.02 + 0.015 * torch.sin(25.0 * t),
     lambda t: 0.03 - 0.02 * t),
    (lambda t: 0.0 * t + 0.01 * (t > 0.1), lambda t: 0.004 + 0.0 * t)])
@pytest.mark.usefixtures("torch_thread_pool")
def test_stereo_delay_swept_matches_flan_tpu(l_time, r_time):
    """The swept path (the plain version on the CPU) against flan_tpu's
    lax.scan, exactly (both are the loop's float32 operations), and
    against the ring loop on the port's own delays: constant-valued
    callables (0.03f 8000 truncating to 239), a sine sweep, and delays
    stepping from 0 up to the ring size. Each delay callable is evaluated
    once, on the port's grid, and both packages get those values (each
    asks for them on its own grid, which must be the same): torch's CPU
    sin can be wrong on its first call in a process, in the half of the
    call an intra-op worker thread computes (these 2,400 values' second
    half up to 2,522 ulps off, 7 delays a sample apart, in one fresh
    process in 96 and one in 192; the call repeated is right), so two
    evaluations of one callable could give the two packages other
    delays."""
    x = _noise((2, 1600), seed=8)
    ja, ta = _audios(x)
    out_n = int(0.3 * SR)
    fn = flan_tpu_torch.func.function.as_function
    lt_t, rt_t = (temporal.sample_delay_times(fn(f), out_n, SR)
                  for f in (l_time, r_time))
    grid = temporal.true_div(torch.arange(out_n, dtype=torch.float32),
                             SR).numpy()
    asked = []

    def handed(times, as_numpy):
        def g(t):
            asked.append(np.array(t))
            return times.numpy() if as_numpy else times
        return g
    got = ta.stereo_delay(0.3, handed(lt_t, False), handed(rt_t, False),
                          0.6)
    want = ja.stereo_delay(0.3, handed(lt_t, True), handed(rt_t, True), 0.6)
    assert len(asked) == 4
    for t in asked:
        np.testing.assert_array_equal(t, grid)
    lt, rt = (np.asarray(v, np.float64) for v in (lt_t, rt_t))
    err = _rel(got, want)
    if err >= TOL:
        apart = np.nonzero(np.any(got.to_numpy() != np.array(want.data),
                                  axis=0))[0]
        first = int(apart[0])
        pytest.fail(f"{err} of the peak apart from frame {first}; delays "
                    f"there l {(lt[first:first + 4] * SR).astype(np.int64)}"
                    f" r {(rt[first:first + 4] * SR).astype(np.int64)}")
    lb, rb = int(lt.max() * SR), int(rt.max() * SR)
    dl = np.clip((lt * SR).astype(np.int64), 0, lb)
    dr = np.clip((rt * SR).astype(np.int64), 0, rb)
    xp = np.pad(x, ((0, 0), (0, out_n - x.shape[1])))
    ring = seq.stereo_delay_loop(xp, np.full(out_n, 0.6, np.float32), dl, dr,
                                  lb, rb)[0]
    assert np.array_equal(got.to_numpy(), ring)


def test_stereo_delay_refuses_mono_and_zero_rings():
    mono = flan_tpu_torch.Audio.create_from_array(_noise((1, 100)), SR,
                                                  device="cpu")
    assert mono.stereo_delay(0.1, 0.01, 0.01, 0.5).is_null()
    st = flan_tpu_torch.Audio.create_from_array(_noise((2, 100)), SR,
                                                device="cpu")
    assert st.stereo_delay(0.1, 0.0, 0.01, 0.5).is_null()
    assert st.stereo_delay(0.0, 0.01, 0.01, 0.5).is_null()
