"""The phase vocoder's analysis epilogue (H1) and synthesis prologue (H2),
csrc/pv_stage_kernels.cu, on the card: each against its plain version
(ops/pv_stages.py analysis_ref, synthesis_ref) on the card, bit for bit,
over the stages' edges (zero energy, the helper hop's dead rows, frames
outside the map, pairs whose weight is 0, ragged chunks, one frame), bin
counts 2, 257, 2049 and 4097, chunks from 256 to 9001 frames, past what a
cluster of H2 chains in one turn, columns whose increments H2 sums in
frame order (frequencies below 2^-22 of the rate), and three calls for
the same bits; then the paths through them.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pv_stages.py
"""
import math

import numpy as np
import pytest
import torch

from flan_tpu_torch.ops import pv_stages, stft
from flan_tpu_torch.pipelines import pv_stretch_pipeline

SR = 48000.0
RATE = SR / 128
BINS = (2, 257, 2049, 4097)
# frames a cluster of H2 chains in one turn: 8 blocks of 256 frames
TURN_FRAMES = 8 * 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def spectrum(lead, frames, nbins, seed, dev):
    """A complex64 spectrum from a seed: frame 1 silent, frame 3 DC only,
    a third of frame 2's bins with squares that underflow (energy 0)."""
    rng = np.random.default_rng(seed)
    shape = (*lead, frames, nbins)
    s = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 40.0
    if frames > 1:
        s[..., 1, :] = 0.0
    if frames > 2:
        s[..., 2, ::3] *= 1e-24
    if frames > 3:
        s[..., 3, :] = 0.0
        s[..., 3, 0] = 7.0
    return torch.from_numpy(s.astype(np.complex64)).to(dev)


def bins(nbins, dev):
    return stft.bin_frequencies(nbins, SR / (2 * (nbins - 1)), RATE,
                                device=dev)


def planes(c, frames, nbins, seed, dev, zero=()):
    """(mag, freq) [c, frames, nbins] from a seed, frames in `zero` of zero
    magnitude, frequencies around the bins' with negative ones."""
    rng = np.random.default_rng(seed)
    mag = rng.random((c, frames, nbins)).astype(np.float32) * 3.0
    for j in zero:
        mag[:, j] = 0.0
    freq = (np.arange(nbins, dtype=np.float32) * np.float32(SR / 8192)
            + rng.standard_normal((c, frames, nbins)).astype(np.float32)
            * 200.0)
    freq[:, ::5, ::3] *= -2.0
    return torch.from_numpy(mag).to(dev), torch.from_numpy(freq).to(dev)


def plan(frames_in, frames_out, seed, dev):
    """A monotone chunk plan over frames_in input frames, mixes 0 and 1
    among its weights, frames outside the map at both ends."""
    rng = np.random.default_rng(seed)
    li = np.sort(rng.integers(0, frames_in - 1, frames_out))
    mix = rng.random(frames_out).astype(np.float32)
    mix[::5], mix[1::7] = 0.0, 1.0
    valid = np.ones(frames_out, bool)
    valid[:3] = False
    valid[-5:] = False
    return tuple(torch.from_numpy(a).to(dev) for a in (li, mix, valid))


def same(a, b):
    return a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------------------- H1

@pytest.mark.cuda
@pytest.mark.parametrize("nbins", BINS)
@pytest.mark.parametrize("frames,dead", [(1, 0), (1, 2), (17, 2), (40, 0),
                                         (5, 9), (2052, 2)])
def test_analysis_helper_mode_matches_plain(cuda_device, nbins, frames,
                                            dead):
    """Frame 0 a helper hop, not written; frames 1 .. dead - 1 take a
    previous phase of 0, past the chunk when dead > frames."""
    spec = spectrum((1, 2), frames, nbins, frames + nbins, cuda_device)
    bf, ex = bins(nbins, cuda_device)
    want = pv_stages.analysis_ref(spec, bf, ex, RATE, None, dead)
    pv_stages.reset_launch_counts()
    got = pv_stages.analysis_cuda(spec, bf, ex, RATE, None, dead)
    torch.cuda.synchronize()
    assert pv_stages.LAUNCHES["pv_analysis"] == 1
    assert all(same(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", BINS)
@pytest.mark.parametrize("frames", [1, 16, 33, 2048])
def test_analysis_carried_phase_matches_plain(cuda_device, nbins, frames):
    """pv_forward's chunk: the carried phase, written into the rows of a
    larger plane, nothing else touched."""
    spec = spectrum((2,), frames, nbins, frames, cuda_device)
    bf, ex = bins(nbins, cuda_device)
    prev = torch.from_numpy(np.random.default_rng(5).uniform(
        -math.pi, math.pi, (2, 1, nbins)).astype(np.float32)).to(cuda_device)
    want = pv_stages.analysis_ref(spec, bf, ex, RATE, prev)
    mag = torch.full((2, frames + 9, nbins), -3.0, device=cuda_device)
    freq = torch.full_like(mag, -3.0)
    got = pv_stages.analysis(spec, bf, ex, RATE, prev=prev,
                             out=(mag[:, 4:4 + frames], freq[:, 4:4 + frames]))
    torch.cuda.synchronize()
    assert same(mag[:, 4:4 + frames], want[0])
    assert same(freq[:, 4:4 + frames], want[1]) and same(got[2], want[2])
    rest = torch.cat([mag[:, :4], mag[:, 4 + frames:], freq[:, :4],
                      freq[:, 4 + frames:]], dim=1)
    assert bool((rest == -3.0).all())


@pytest.mark.cuda
def test_analysis_same_bits_on_three_calls(cuda_device):
    spec = spectrum((2,), 2052, 2049, 11, cuda_device)
    bf, ex = bins(2049, cuda_device)
    first = pv_stages.analysis_cuda(spec, bf, ex, RATE, None, 2)
    for _ in range(2):
        again = pv_stages.analysis_cuda(spec, bf, ex, RATE, None, 2)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# ------------------------------------------------------------------- H2

@pytest.mark.cuda
def test_cumsum_mod1_frames_is_the_cpus_on_the_card(cuda_device):
    """torch's CUDA cumsum along a dimension other than the last walks each
    column in order, so the plain version sums as on the CPU: one
    full-width chunk, bit for bit."""
    inc = torch.from_numpy(np.random.default_rng(3).random(
        (2, 4096, 2049)).astype(np.float32))
    want = stft.cumsum_mod1_frames(inc)
    got = stft.cumsum_mod1_frames(inc.to(cuda_device)).cpu()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", BINS)
@pytest.mark.parametrize("frames", [1, 255, 256, 257, TURN_FRAMES,
                                    TURN_FRAMES + 1, 4096, 4097, 8192])
def test_synthesis_matches_plain(cuda_device, nbins, frames):
    """pv_inverse's chunk and the chunk ops' path: no plan; frames of zero
    magnitude; a ragged last block; one frame; several turns."""
    mag, freq = planes(2, frames, nbins, frames + nbins, cuda_device,
                       zero=(0,) if frames > 1 else ())
    cycle = torch.rand((2, 1, nbins), device=cuda_device)
    want = pv_stages.synthesis_ref(mag, freq, cycle, RATE)
    pv_stages.reset_launch_counts()
    got = pv_stages.synthesis_cuda(mag, freq, cycle, RATE)
    torch.cuda.synchronize()
    assert pv_stages.LAUNCHES["pv_synthesis"] == 1
    assert same(got[1], want[1])
    assert same(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", (2, 257, 2049))
@pytest.mark.parametrize("frames_out", [1, 100, 256, 4096, 8192, 9001])
def test_synthesis_with_a_plan_matches_plain(cuda_device, nbins, frames_out):
    """The stretch's fused remap: input frames of zero magnitude give pairs
    whose total is 0, frames outside the map are 0."""
    frames_in = frames_out // 2 + 6
    mag, freq = planes(2, frames_in, nbins, frames_out, cuda_device,
                       zero=range(2, min(6, frames_in)))
    p = plan(frames_in, frames_out, frames_out, cuda_device)
    cycle = torch.rand((2, 1, nbins), device=cuda_device)
    want = pv_stages.synthesis_ref(mag, freq, cycle, RATE, p)
    got = pv_stages.synthesis_cuda(mag, freq, cycle, RATE, p)
    torch.cuda.synchronize()
    assert same(got[1], want[1]) and same(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("frames_out", [256, 1000, 4096])
def test_synthesis_with_a_wide_plan_matches_plain(cuda_device, frames_out):
    """A plan whose blocks of 256 output frames read input rows far apart
    (a 3x compression, and a block that jumps back and ahead), beside a
    first block that reads 129 rows."""
    nbins = 257
    frames_in = 3 * frames_out + 4
    mag, freq = planes(2, frames_in, nbins, frames_out + 5, cuda_device,
                       zero=(7, 8))
    li, mix, valid = plan(frames_in, frames_out, frames_out + 1, cuda_device)
    head = min(256, frames_out)
    li[:head] = torch.arange(head, device=cuda_device) // 2
    if frames_out > 300:
        li[256:300] = torch.arange(44, device=cuda_device)
        li[300:512] = frames_in - 2
    p = (li, mix, valid)
    cycle = torch.rand((2, 1, nbins), device=cuda_device)
    want = pv_stages.synthesis_ref(mag, freq, cycle, RATE, p)
    got = pv_stages.synthesis_cuda(mag, freq, cycle, RATE, p)
    torch.cuda.synchronize()
    assert same(got[1], want[1]) and same(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("frames", [1, 300, 12_345])
def test_synthesis_without_writing_matches_plain(cuda_device, carried,
                                                 frames):
    mag, freq = planes(2, frames, 2049, frames, cuda_device)
    cycle = torch.rand((2, 1, 2049), device=cuda_device) if carried else None
    want = pv_stages.synthesis_ref(mag, freq, cycle, RATE, write=False)
    got = pv_stages.synthesis_cuda(mag, freq, cycle, RATE, write=False)
    torch.cuda.synchronize()
    assert got[0] is None and same(got[1], want[1])


def tiny(mag, freq, frames, cols, seed, plan=None):
    """freq at (frames, cols) set to rate x u, u in (0, 2^-22) from a
    seed: increments below 2^-22 that are no multiple of 2^-45, so H2 sums
    those columns in frame order (with a plan, the input frames that the
    output frames read). Returns how many columns that gives."""
    rng = np.random.default_rng(seed)
    shape = (freq.shape[0], len(frames), len(cols))
    u = rng.uniform(0.05, 0.95, shape) * 2.0 ** -22
    idx = np.ix_(range(freq.shape[0]), frames, cols)
    f = freq.cpu().numpy()
    f[idx] = (u * RATE).astype(np.float32)
    freq.copy_(torch.from_numpy(f))
    return pv_stages.exact_path_columns(mag, freq, RATE, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("frames_out", [256, 2100, 9001])
def test_synthesis_exact_path_columns_match_plain(cuda_device, with_plan,
                                                  many, frames_out):
    """Columns whose increments hold values below 2^-22 (late in a block,
    where the float64 sum has grown and they round): H2 sums them in frame
    order and gives the plain version's bits; one column of one block, or
    a third of the bins in every block, past a cluster's turn."""
    nbins = 257
    frames_in = frames_out // 2 + 6 if with_plan else frames_out
    mag, freq = planes(2, frames_in, nbins, frames_out + 3, cuda_device)
    p = (plan(frames_in, frames_out, frames_out, cuda_device) if with_plan
         else None)
    step = 2 if with_plan else 1      # a plan reads input frames at half rate
    if many:
        frames = [j for j in range(100 // step, frames_in, 7)]
        cols = list(range(0, nbins, 3))
    else:
        frames = [j // step for j in range(200, 212)]
        cols = [37]
    n = tiny(mag, freq, frames, cols, frames_out, p)
    assert n >= 2
    cycle = torch.rand((2, 1, nbins), device=cuda_device)
    want = pv_stages.synthesis_ref(mag, freq, cycle, RATE, p)
    got = pv_stages.synthesis_cuda(mag, freq, cycle, RATE, p)
    torch.cuda.synchronize()
    assert same(got[1], want[1]) and same(got[0], want[0])
    total = pv_stages.synthesis_ref(mag, freq, None, RATE, p, write=False)
    got = pv_stages.synthesis_cuda(mag, freq, None, RATE, p, write=False)
    assert got[0] is None and same(got[1], total[1])


@pytest.mark.cuda
def test_synthesis_exact_path_same_bits_on_three_calls(cuda_device):
    mag, freq = planes(2, 4096, 2049, 8, cuda_device)
    assert tiny(mag, freq, list(range(150, 4096, 5)), list(range(1, 2049, 4)),
                8) > 0
    cycle = torch.rand((2, 1, 2049), device=cuda_device)
    first = pv_stages.synthesis_cuda(mag, freq, cycle, RATE)
    for _ in range(2):
        again = pv_stages.synthesis_cuda(mag, freq, cycle, RATE)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = pv_stages.synthesis_ref(mag, freq, cycle, RATE)
    assert same(first[0], want[0]) and same(first[1], want[1])


@pytest.mark.cuda
def test_synthesis_reads_views_of_a_plane(cuda_device):
    """pv_inverse hands mag[:, start:start + h] of the whole PV."""
    mag, freq = planes(2, 3000, 257, 1, cuda_device)
    cycle = torch.zeros((2, 1, 257), device=cuda_device)
    views = (mag[:, 700:1900], freq[:, 700:1900])
    want = pv_stages.synthesis_ref(*(v.contiguous() for v in views), cycle,
                                   RATE)
    got = pv_stages.synthesis_cuda(*views, cycle, RATE)
    assert same(got[0], want[0]) and same(got[1], want[1])


@pytest.mark.cuda
def test_synthesis_same_bits_on_three_calls(cuda_device):
    mag, freq = planes(2, 2052, 2049, 2, cuda_device, zero=(9,))
    p = plan(2052, 4096, 4, cuda_device)
    cycle = torch.rand((2, 1, 2049), device=cuda_device)
    first = pv_stages.synthesis_cuda(mag, freq, cycle, RATE, p)
    for _ in range(2):
        again = pv_stages.synthesis_cuda(mag, freq, cycle, RATE, p)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_the_kernels_refuse_bad_arguments(cuda_device):
    mag, freq = planes(2, 10, 9, 0, cuda_device)
    with pytest.raises(ValueError, match="carried cycle"):
        pv_stages.synthesis_cuda(mag, freq, None, RATE)
    with pytest.raises(ValueError, match="cycle"):
        pv_stages.synthesis_cuda(mag, freq, torch.zeros((2, 1, 8),
                                                        device=cuda_device),
                                 RATE)
    spec = spectrum((2,), 10, 9, 0, cuda_device)
    bf, ex = bins(9, cuda_device)
    with pytest.raises(ValueError, match="bins"):
        pv_stages.analysis_cuda(spec, bf[:8], ex, RATE)


# ------------------------------------------------------------ the paths

def tones(seconds, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([0.5 * np.sin(2 * np.pi * 220.0 * t),
                     0.3 * np.sin(2 * np.pi * 330.0 * t)]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 1000, 4096, 8192])
def test_streamed_stretch_launches_each_kernel_once_a_chunk(cuda_device,
                                                            chunk):
    """The 2x stretch of 2 s: H1 and H2 once a chunk (the remap fused),
    the output the one the plain stages give on the card, replayed."""
    x = torch.from_numpy(tones(2.0)).to(cuda_device)
    pv_stages.reset_launch_counts()
    y = pv_stretch_pipeline(x, 2.0, sample_rate=SR, chunk_out=chunk)
    nchunks = math.ceil(2 * (x.shape[1] // 128 + 1) / chunk)
    assert pv_stages.LAUNCHES == {"pv_analysis": nchunks,
                                  "pv_synthesis": nchunks}
    plain = {"analysis": pv_stages.analysis,
             "synthesis": pv_stages.synthesis}

    def analysis_plain(spec, *a, **k):
        return pv_stages.analysis_ref(spec, *a, k.get("prev"),
                                      k.get("dead", 0))

    def synthesis_plain(mag, freq, cycle, rate, plan=None, write=True):
        return pv_stages.synthesis_ref(mag, freq, cycle, rate, plan, write)
    try:
        pv_stages.analysis = analysis_plain
        pv_stages.synthesis = synthesis_plain
        want = pv_stretch_pipeline(x, 2.0, sample_rate=SR, chunk_out=chunk)
    finally:
        pv_stages.analysis = plain["analysis"]
        pv_stages.synthesis = plain["synthesis"]
    assert torch.equal(y, want)


@pytest.mark.cuda
def test_class_path_launches_and_bits(cuda_device):
    """pv_forward (chunks of 2048 hops) and pv_inverse (2048 frames) on the
    card: one H1 a chunk of hops, one H2 a chunk of frames, the plain
    stages' output on the card."""
    x = torch.from_numpy(tones(3.0)).to(cuda_device)
    pv_stages.reset_launch_counts()
    mag, freq = stft.pv_forward(x, sample_rate=SR)
    y = stft.pv_inverse(mag, freq, sample_rate=SR)
    nh = x.shape[1] // 128 + 1
    assert pv_stages.LAUNCHES == {"pv_analysis": math.ceil(nh / 2048),
                                  "pv_synthesis": math.ceil(nh / 2048)}
    # the plain stages chunk by chunk, as the parent's loops ran them
    bf, ex = stft.bin_frequencies(2049, SR / 4096, RATE, device=cuda_device)
    window = stft.hann_window(2048, cuda_device)
    prev = torch.zeros((2, 1, 2049), device=cuda_device)
    for start in range(0, nh, 2048):
        h = min(2048, nh - start)
        spec = torch.fft.rfft(stft._frame_signal(x, start, h, 128, 2048)
                              * window, n=4096, dim=-1)
        m, f, prev = pv_stages.analysis_ref(spec, bf, ex, RATE, prev)
        assert same(mag[:, start:start + h], m)
        assert same(freq[:, start:start + h], f)
    assert y.shape == (2, nh * 128) and bool(torch.isfinite(y).all())
