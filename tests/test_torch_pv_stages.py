"""flan_tpu_torch.ops.pv_stages on the CPU: the plain versions of the
analysis epilogue (H1) and the synthesis prologue (H2) against the PyTorch
compositions they replaced, bit for bit, and the paths through them
(pv_forward, pv_inverse, the streamed stretch) against flan_tpu at the
stages' edges: silence and DC (zero energy), the helper hop's dead rows
(i0 = 0 and 1), frames outside the map, pairs whose weight is 0, chunks
that are not whole blocks of 256 frames or shorter than one, a single hop
and odd bin counts. JAX runs on the CPU (conftest.py); the kernels
themselves are held to these plain versions on the card by
tests/test_torch_cuda_pv_stages.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.ops import stft as jstft
from flan_tpu.pipelines import streamed as jstreamed
from flan_tpu_torch.ops import build, pv_stages
from flan_tpu_torch.ops import stft as tstft
from flan_tpu_torch.ops.fastmath import atan2 as fast_atan2
from flan_tpu_torch.pipelines import streamed as tstreamed

# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements,
# which the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
TWO_PI = 2.0 * math.pi


def _np(a):
    """Copy a JAX result out (np.asarray can alias a reused buffer)."""
    return np.array(a)


# ---- the compositions the stages replaced, as the callers ran them

def parent_rfft_mag_phase(spec):
    re, im = spec.real, spec.imag
    energy = re * re + im * im
    dead = energy == 0.0
    phase = fast_atan2(torch.where(dead, 0.0, im), torch.where(dead, 1.0, re))
    return tstft.cpu_exact(torch.sqrt, energy), phase


def parent_streamed_analysis(spec, bin_freq, expected, rate, i0):
    """pipelines/streamed.py _analysis after its rFFT."""
    mag, phase = parent_rfft_mag_phase(spec)
    prev = torch.nn.functional.pad(phase[:, :, :-1], (0, 0, 1, 0))
    dead = max(0, 2 - i0)
    if dead > 1:
        prev[:, :, 1:dead] = 0.0
    delta = tstft._wrap_radians(phase - prev - expected)
    freq = bin_freq + delta * (rate / TWO_PI)
    return mag[:, :, 1:], freq[:, :, 1:]


def parent_forward_step(spec, prev_phase, bin_freq, expected, rate):
    """One chunk of ops/stft.py pv_forward after its rFFT."""
    m, phase = parent_rfft_mag_phase(spec)
    prev = torch.cat([prev_phase, phase[:, :-1]], dim=1)
    delta = tstft._wrap_radians(phase - prev - expected)
    return m, bin_freq + delta * (rate / TWO_PI), phase[:, -1:]


def parent_remap(mag, freq, li, mix, valid):
    """pipelines/streamed.py _remap."""
    mix = mix[:, None]
    w0 = (1.0 - mix) * mag.index_select(2, li)
    w1 = mix * mag.index_select(2, li + 1)
    total = w0 + w1
    fsum = w0 * freq.index_select(2, li) + w1 * freq.index_select(2, li + 1)
    v = valid[:, None]
    pos = total > 0.0
    return (torch.where(v, total, 0.0),
            torch.where(v & pos, fsum / torch.where(pos, total, 1.0), 0.0))


def parent_cycles(freq, rate):
    return tstft.cumsum_mod1_frames(
        torch.remainder(tstft.true_div(freq, rate), 1.0))


def parent_synthesis(mag, freq, cycle, rate):
    """pipelines/streamed.py _synthesis (and ops/stft.py pv_inverse's
    chunk) before the irFFT: the polar spectrum and the next offset."""
    cycles = torch.remainder(parent_cycles(freq, rate) + cycle, 1.0)
    phase = cycles * TWO_PI
    return (torch.complex(mag * torch.cos(phase), mag * torch.sin(phase)),
            cycles[:, -1:])


# ---- inputs from numpy seeds

def _spectrum(lead, frames, nbins, seed, silent=(), dc=()):
    """A complex64 spectrum [*lead, frames, nbins] from a seed; the frames
    in `silent` are 0, those in `dc` real and only in bin 0 (energy 0
    elsewhere), and one frame holds values whose squares underflow."""
    rng = np.random.default_rng(seed)
    shape = (*lead, frames, nbins)
    s = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 3.0
    for j in silent:
        s[..., j, :] = 0.0
    for j in dc:
        s[..., j, :] = 0.0
        s[..., j, 0] = 2.5
    if frames > 2:
        s[..., 2, ::3] *= 1e-24      # energy underflows to 0: phase 0
    return torch.from_numpy(s.astype(np.complex64))


def _bins(nbins, rate=SR / 64):
    return tstft.bin_frequencies(nbins, SR / (2 * (nbins - 1)), rate)


def _planes(c, frames, nbins, seed, zero_frames=()):
    """(mag, freq) [c, frames, nbins] float32 from a seed: magnitudes
    (0 on `zero_frames`) and frequencies around the bins' with negative
    and above-rate values among them."""
    rng = np.random.default_rng(seed)
    mag = rng.random((c, frames, nbins)).astype(np.float32) * 2.0
    for j in zero_frames:
        mag[:, j] = 0.0
    noise = rng.standard_normal((c, frames, nbins)).astype(np.float32)
    freq = np.arange(nbins, dtype=np.float32) * 15.625 + noise * 40.0
    freq[:, ::7, ::5] *= -3.0
    return torch.from_numpy(mag), torch.from_numpy(freq)


def _same(a, b):
    return a.shape == b.shape and torch.equal(a, b)


# ---- H1's plain version

@pytest.mark.parametrize("i0,frames,nbins", [
    (0, 40, 257), (1, 40, 257), (2, 40, 129), (5, 19, 2), (-3, 4, 3),
    (0, 1, 257)])
def test_analysis_ref_is_the_parent_streamed_analysis(i0, frames, nbins):
    """Helper mode: frame 0 seeds the difference; i0 <= 0 zeroes the
    previous phase of frames 1 .. 1 - i0, past the chunk when i0 < -H."""
    spec = _spectrum((1, 2), frames, nbins, seed=frames + nbins,
                     silent=(3,) if frames > 3 else (), dc=(5,)
                     if frames > 5 else ())
    bin_freq, expected = _bins(nbins)
    rate = SR / 64
    want = parent_streamed_analysis(spec, bin_freq, expected, rate, i0)
    got = pv_stages.analysis(spec, bin_freq, expected, rate,
                             dead=max(0, 2 - i0))
    assert all(_same(g, w) for g, w in zip(got[:2], want))


@pytest.mark.parametrize("frames,nbins", [(1, 257), (7, 129), (33, 2)])
def test_analysis_ref_is_the_parent_pv_forward_step(frames, nbins):
    spec = _spectrum((2,), frames, nbins, seed=frames, silent=(0,),
                     dc=(4,) if frames > 4 else ())
    bin_freq, expected = _bins(nbins)
    prev = torch.from_numpy(np.random.default_rng(9).uniform(
        -math.pi, math.pi, (2, 1, nbins)).astype(np.float32))
    want = parent_forward_step(spec, prev, bin_freq, expected, SR / 64)
    got = pv_stages.analysis(spec, bin_freq, expected, SR / 64, prev=prev)
    assert all(_same(g, w) for g, w in zip(got, want))


def test_analysis_writes_into_the_callers_rows():
    """pv_forward hands views of its planes: the chunk's rows are written
    and nothing else."""
    spec = _spectrum((2,), 9, 129, seed=3)
    bin_freq, expected = _bins(129)
    mag = torch.full((2, 30, 129), -7.0)
    freq = torch.full((2, 30, 129), -7.0)
    prev = torch.zeros((2, 1, 129))
    m, f, last = pv_stages.analysis(spec, bin_freq, expected, SR / 64,
                                    prev=prev,
                                    out=(mag[:, 11:20], freq[:, 11:20]))
    want = parent_forward_step(spec, prev, bin_freq, expected, SR / 64)
    assert _same(mag[:, 11:20], want[0]) and _same(freq[:, 11:20], want[1])
    assert _same(last, want[2])
    outside = torch.cat([mag[:, :11], mag[:, 20:], freq[:, :11],
                         freq[:, 20:]], dim=1)
    assert bool((outside == -7.0).all())


# ---- H2's plain version

@pytest.mark.parametrize("frames,nbins", [(1, 257), (100, 129), (256, 3),
                                          (300, 257), (513, 2)])
def test_synthesis_ref_is_the_parent_synthesis(frames, nbins):
    """Chunks below one cumsum block, of whole blocks and ragged; zero
    magnitudes on some frames."""
    mag, freq = _planes(2, frames, nbins, seed=frames,
                        zero_frames=(0,) if frames > 1 else ())
    cycle = torch.from_numpy(np.random.default_rng(1).random(
        (2, 1, nbins)).astype(np.float32))
    want = parent_synthesis(mag, freq, cycle, SR / 64)
    got = pv_stages.synthesis(mag, freq, cycle, SR / 64)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def _plan(frames_in, frames_out, seed):
    """A chunk's plan: monotone left frames, mixes with 0 and 1 among them,
    and frames outside the map at both ends."""
    rng = np.random.default_rng(seed)
    li = np.sort(rng.integers(0, frames_in - 1, frames_out))
    mix = rng.random(frames_out).astype(np.float32)
    mix[::5] = 0.0
    mix[1::7] = 1.0
    valid = np.ones(frames_out, bool)
    valid[:2] = False
    valid[-3:] = False
    return (torch.from_numpy(li), torch.from_numpy(mix),
            torch.from_numpy(valid))


@pytest.mark.parametrize("frames_out", [1, 77, 256, 300])
def test_synthesis_ref_with_a_plan_is_the_parent_remap(frames_out):
    """The fused remap: input frames of zero magnitude make pairs whose
    total is 0 (their frequency 0), invalid frames are 0."""
    frames_in = 40
    mag, freq = _planes(2, frames_in, 129, seed=frames_out,
                        zero_frames=range(10, 20))
    plan = _plan(frames_in, frames_out, seed=frames_out)
    cycle = torch.zeros((2, 1, 129))
    s_mag, s_freq = parent_remap(mag[None], freq[None], *plan)
    want = parent_synthesis(s_mag[0], s_freq[0], cycle, SR / 64)
    got = pv_stages.synthesis(mag, freq, cycle, SR / 64, plan=plan)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # remap is the parent's _remap on the stacked planes
    again = pv_stages.remap(mag[None], freq[None], *plan)
    assert _same(again[0], s_mag) and _same(again[1], s_freq)


@pytest.mark.parametrize("carried", [False, True])
def test_synthesis_without_writing_gives_the_last_cycle(carried):
    """The sharded paths' totals: the raw last cycle (pv_inverse_sp,
    stretch_sp) or the running total (streamed_sp_process's first pass)."""
    mag, freq = _planes(2, 600, 257, seed=4)
    total = torch.from_numpy(np.random.default_rng(2).random(
        (2, 1, 257)).astype(np.float32))
    spec, last = pv_stages.synthesis(mag, freq, total if carried else None,
                                     SR / 64, write=False)
    assert spec is None
    raw = parent_cycles(freq, SR / 64)[:, -1:]
    want = torch.remainder(total + raw, 1.0) if carried else raw
    assert _same(last, want)


def test_cumsum_block_is_the_librarys():
    assert build.PV_CUMSUM_BLOCK == tstft._MOD1_BLOCK
    assert build._LIMITS["flan_pv_cumsum_block"] == build.PV_CUMSUM_BLOCK


def test_cpu_tensors_launch_no_kernel():
    pv_stages.reset_launch_counts()
    x = np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32)
    mag, freq = tstft.pv_forward(torch.from_numpy(x), window_size=256,
                                 hop=64, dft_size=256, sample_rate=SR)
    tstft.pv_inverse(mag, freq, window_size=256, hop=64, sample_rate=SR)
    tstreamed.streamed_pv_process([x], time_map=np.arange(1, 48) * 2.0,
                                  window_size=256, hop=64, dft_size=256,
                                  sample_rate=SR, chunk_out=16,
                                  device="cpu")
    assert pv_stages.LAUNCHES == {"pv_analysis": 0, "pv_synthesis": 0}


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    spec = _spectrum((2,), 4, 9, seed=0)
    bin_freq, expected = _bins(9)
    with pytest.raises(ValueError, match="CUDA"):
        pv_stages.analysis_cuda(spec, bin_freq, expected, SR / 64)
    mag, freq = _planes(2, 4, 9, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        pv_stages.synthesis_cuda(mag, freq, torch.zeros((2, 1, 9)), SR / 64)
    with pytest.raises(ValueError, match="rows"):
        pv_stages._rows_view(torch.zeros((2, 4, 9)).transpose(0, 1), 4, 2,
                             9, "mag")


# ---- the paths through the stages against the JAX package

def _tone(n, seed=0, gap=None):
    """tests/test_torch_pipelines.py's two channels (a 440 Hz tone in
    noise, a 220 Hz sine), silent at `gap`."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t)
                  + 0.05 * rng.standard_normal(n),
                  0.3 * np.sin(2 * np.pi * 220 * t)])
    if gap is not None:
        x[:, gap[0]:gap[1]] = 0.0
    return x.astype(np.float32)


FORWARD_CASES = {
    # zero energy everywhere: phase 0, freq the bins' wrapped advance
    "silence": (np.zeros((2, 1500), np.float32), 256, 64, 256),
    # energy in bin 0 only away from the edges
    "dc": (np.full((2, 1500), 0.25, np.float32), 256, 64, 256),
    # one hop (and one frame for the inverse below)
    "single_hop": (_tone(40), 128, 64, 256),
    # odd bins (129, 257) and a gap of silence
    "odd_bins_gap": (_tone(4000, gap=(1200, 2600)), 512, 64, 512),
}


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_pv_forward_matches_jax_at_the_edges(name):
    x, window, hop, dft = FORWARD_CASES[name]
    kw = dict(window_size=window, hop=hop, dft_size=dft, sample_rate=SR,
              chunk_hops=16)
    jm, jf = (_np(a) for a in jstft.pv_forward(jnp.asarray(x), **kw))
    tm, tf = (a.numpy() for a in tstft.pv_forward(torch.from_numpy(x), **kw))
    assert tm.shape == jm.shape
    peak = max(float(jm.max()), 1e-30)
    # two float32 FFTs (pocketfft vs XLA's) agree to a few ulp of the peak
    assert np.abs(tm - jm).max() <= 1e-6 * peak
    ar = SR / hop
    live = jm > 1e-2 * peak
    # a phase difference at exactly +-pi may wrap to either end (XLA's
    # reciprocal multiply against the port's division): a whole rate apart
    df = np.abs(tf - jf)
    df = np.minimum(df, np.abs(df - ar))
    # where the energy is zero on both sides both compute phase 0, and the
    # frequency is bin_freq plus the bin's wrapped expected advance, a sum
    # that cancels: XLA's reciprocal multiply against the port's division
    # leaves up to two ulps of the largest term, the Nyquist frequency
    # (read 4.9e-4 Hz at 8 kHz); bound four
    quiet = (jm == 0) & (tm == 0)
    assert np.array_equal(jm == 0, tm == 0)
    assert df[quiet].max(initial=0.0) <= 4 * np.spacing(np.float32(SR / 2))
    assert df[live].max(initial=0.0) < 0.02


@pytest.mark.parametrize("frames,chunk,zero", [
    (1, 16, ()), (60, 16, (3, 4)), (300, 100, (50,)), (600, 300, ())])
def test_pv_inverse_matches_jax_at_the_edges(frames, chunk, zero):
    """One frame; chunks below 256 frames and not whole blocks; frames of
    zero magnitude; on the JAX package's PV of a signal."""
    x = _tone((frames - 1) * 64 + 10, seed=frames)
    mag, freq = (_np(a) for a in jstft.pv_forward(
        jnp.asarray(x), window_size=256, hop=64, dft_size=256,
        sample_rate=SR))
    mag[:, list(zero)] = 0.0
    kw = dict(window_size=256, hop=64, sample_rate=SR, chunk_hops=chunk)
    want = _np(jstft.pv_inverse(jnp.asarray(mag), jnp.asarray(freq), **kw))
    got = tstft.pv_inverse(torch.from_numpy(mag), torch.from_numpy(freq),
                           **kw).numpy()
    # the port's own distance under a one-ulp change of every frequency
    nudged = tstft.pv_inverse(
        torch.from_numpy(mag),
        torch.from_numpy(np.nextafter(freq, np.float32(np.inf))), **kw).numpy()
    assert got.shape == want.shape == (2, frames * 64)
    # JAX sums the mod-1 cycles in float32, the port in float64: 2.7e-5
    # cycles apart at 60 frames, 9.2e-4 at 600 (the float32 sums' error
    # grows with the frames), which moves the output as an ulp or two of
    # every frequency would. Read: the JAX distance 0.59-0.75x the one-ulp
    # one at the max (1.1e-4 to 1.4e-3 of the peak); bound twice.
    d, d_ulp = np.abs(got - want), np.abs(nudged - got)
    assert d.max() <= 2.0 * d_ulp.max()
    assert np.sqrt((d ** 2).mean()) <= 2.0 * np.sqrt((d_ulp ** 2).mean())


STREAM_CASES = {
    # chunks of 3 output frames: chunk 0 analyses from i0 = 0, chunk 1 from
    # i0 = 1 (the helper hop's dead rows); 2x maps frames 0, 1 outside
    "i0_0_1": (_tone(1500), 2.0, 3),
    # chunks of 100 (below a block) and 300 (ragged), with a gap of
    # silence: pairs whose weights are both 0
    "chunk_100_gap": (_tone(6000, gap=(2000, 3500)), 1.5, 100),
    "chunk_300": (_tone(12000, seed=3), 2.0, 300),
}


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_streamed_stretch_matches_jax_at_the_edges(name):
    x, factor, chunk = STREAM_CASES[name]
    kw = dict(window_size=512, hop=64, dft_size=512, sample_rate=SR,
              chunk_out=chunk)
    nh = tstft.num_hops(x.shape[1], 64)
    tm = np.cumsum(np.full(nh, factor))
    want = _np(jstreamed.streamed_pv_process([jnp.asarray(x)], time_map=tm,
                                             **kw))
    got = tstreamed.streamed_pv_process([x], time_map=tm, device="cpu",
                                        **kw).numpy()
    # the port's own distance under a one-ulp change of every input sample
    nudged = tstreamed.streamed_pv_process(
        [np.nextafter(x, np.float32(np.inf))], time_map=tm, device="cpu",
        **kw).numpy()
    assert got.shape == want.shape == nudged.shape
    d, d_ulp = np.abs(got - want), np.abs(nudged - got)
    # A wrapped phase difference near +-pi rounds to either side and moves
    # that bin's summed phase for the rest of the call (C.22), so the
    # stretch is defined only to its one-ulp sensitivity; JAX's float32
    # cycle sums and reciprocal multiplies sit inside it. Read: the JAX
    # distance 0.49-1.23x the one-ulp one at the max, 1.01-1.08x in RMS;
    # bound twice, as chip_smoke.py phase 13 holds the sharded stretch.
    assert d.max() <= 2.0 * d_ulp.max()
    assert np.sqrt((d ** 2).mean()) <= 2.0 * np.sqrt((d_ulp ** 2).mean())
