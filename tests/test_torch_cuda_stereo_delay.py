"""The swept stereo delay's kernel and the chunked fractional gather, on
the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_stereo_delay.py
"""
import numpy as np
import pytest
import torch

from flan_tpu_torch import Audio
from flan_tpu_torch.audio import temporal
from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops import resample
from flan_tpu_torch.ops import sequential_kernels as seq

# the kernel against its plain loop, times the peak: every step in the
# same float32 operations (no fused multiply-add), so 0 is expected; the
# bound leaves room for nothing else
TOL_DELAY = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _delay_inputs(n: int, lb: int, rb: int, kind: str, seed: int = 5):
    """x [2, n] and g [n] on the card, dl and dr [n] on the host: random in
    [0, ring], only 0, 1 and the ring size ("ends"), all 1 ("ones"), or
    sweeping through every distance up to the ring ("sweep")."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-0.9, 0.9, n).astype(np.float32))
    if kind == "random":
        dl, dr = rng.integers(0, lb + 1, n), rng.integers(0, rb + 1, n)
    elif kind == "ends":
        dl, dr = rng.choice([0, 1, lb], n), rng.choice([0, 1, rb], n)
    elif kind == "ones":
        dl = dr = np.ones(n, np.int64)
    else:
        ramp = np.abs(np.sin(np.linspace(0.0, 7.0, n)))
        dl = (ramp * lb).astype(np.int64)
        dr = (ramp[::-1] * rb).astype(np.int64)
    return x.cuda(), g.cuda(), dl, dr


# rings in shared memory (each a power of two of at least its distance +
# 1024 slots, 40 Ki floats together) and past it (the reads from device
# memory); lengths of one frame, around a tile of 1024 and past a few
# hundred rounds
DELAY_CASES = ([(n, 50, 70, "random", True) for n in (1, 1023, 1025, 3001)]
               + [(20_000, 1, 1, "ones", True), (20_000, 1, 5, "ends", True),
                  (20_000, 700, 1024, "ends", True),
                  (50_000, 1500, 2900, "sweep", True),
                  (30_000, 17, 4000, "random", True),
                  (100_000, 30_000, 3, "ends", True),
                  (100_003, 26_400, 45_600, "sweep", False),
                  (60_000, 1, 70_000, "random", False),
                  (70_000, 40_000, 9_000, "ends", False)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,lb,rb,kind,shared", DELAY_CASES)
def test_stereo_delay_kernel_matches_plain_loop(cuda_device, n, lb, rb,
                                                kind, shared):
    """The kernel against the plain version on the same inputs, TOL_DELAY
    of the peak; its writes over every frame by one step in float64, and
    over the first 5000 against the loop step by step; one launch; the
    ring variant by size; the same bits on three calls."""
    x, g, dl, dr = _delay_inputs(n, lb, rb, kind)
    plan = seq.stereo_delay_plan(dl, dr, lb, rb, x.device)
    before = seq.LAUNCHES["stereo_delay_swept"]
    out, w = seq.stereo_delay_swept_cuda(x, g, *plan, lb, rb, keep_w=True)
    assert seq.LAUNCHES["stereo_delay_swept"] == before + 1
    want, w_ref = seq.stereo_delay_ref(x, g, dl, dr, lb, rb, keep_w=True)
    peak = w_ref.abs().max().clamp(min=1e-30)
    assert (w - w_ref).abs().max() <= TOL_DELAY * peak
    assert torch.equal(out, seq.stereo_delay_outputs(w, lb, rb))
    assert (out - want).abs().max() <= TOL_DELAY * peak
    assert max(seq.stereo_delay_step_errors(x, g, dl, dr, lb, rb,
                                            w).values()) <= TOL_DELAY
    assert seq.stereo_delay_shared_ring(lb, rb) == shared
    # the first frames against the loop itself, step by step on the host
    m = min(n, 5000)
    _, w_loop = seq.stereo_delay_loop(x[:, :m].cpu().numpy(),
                                      g[:m].cpu().numpy(), dl[:m], dr[:m],
                                      lb, rb)
    assert (w[:, :m].cpu() - torch.from_numpy(w_loop)).abs().max() \
        <= TOL_DELAY * peak.cpu()
    for _ in range(2):
        again = seq.stereo_delay_swept_cuda(x, g, *plan, lb, rb)
        assert torch.equal(again, out)


@pytest.mark.cuda
def test_stereo_delay_rounds_cross_tiles_as_planned(cuda_device):
    """Delays that change at every round edge and tile edge: the kernel
    takes the host's rounds as they are, whatever their widths."""
    n = 40_000
    rng = np.random.default_rng(9)
    dl = rng.choice([0, 1, 3, 1023, 1024, 1025, 2047], n)
    dr = rng.choice([1, 2, 1024, 1500, 2048], n)
    lb, rb = 2047, 2048
    x, g, _, _ = _delay_inputs(n, lb, rb, "ones")
    el, er = seq.stereo_delay_distances(dl, dr, lb, rb)
    starts = seq.stereo_delay_round_starts(el, er, seq.STEREO_TILE)
    assert len(starts) > n // seq.STEREO_TILE * 2
    got = seq.stereo_delay_swept(x, g, dl, dr, lb, rb)
    want = seq.stereo_delay_ref(x, g, dl, dr, lb, rb)
    assert (got - want).abs().max() <= TOL_DELAY * want.abs().max()


@pytest.mark.cuda
def test_stereo_delay_10s_swept_call_by_one_step(cuda_device):
    """A 10 s stereo swept call at 48 kHz through Audio.stereo_delay (the
    kernel), every frame held by one step in float64 from its own writes,
    its first 48,000 frames to the plain version on the same inputs."""
    sr, seconds = 48000.0, 10.0
    n = int(sr * seconds)
    x = np.random.default_rng(2).standard_normal((2, n)).astype(np.float32)
    lt = lambda t: 0.30 + 0.25 * torch.sin(2 * np.pi * 0.05 * t)  # noqa
    rt = lambda t: 0.50 + 0.45 * torch.sin(2 * np.pi * 0.07 * t)  # noqa
    a = Audio.create_from_array(x, sr, device=cuda_device)
    before = seq.LAUNCHES["stereo_delay_swept"]
    out = a.stereo_delay(seconds, lt, rt, 0.5)
    assert seq.LAUNCHES["stereo_delay_swept"] == before + 1
    lt_s = temporal.sample_delay_times(as_function(lt), n, sr)
    rt_s = temporal.sample_delay_times(as_function(rt), n, sr)
    lb, rb = int(lt_s.max() * sr), int(rt_s.max() * sr)
    dl = np.clip((lt_s * sr).astype(np.int64), 0, lb)
    dr = np.clip((rt_s * sr).astype(np.int64), 0, rb)
    g = torch.full((n,), 0.5, device=cuda_device)
    xd = a.data.contiguous()
    got, w = seq.stereo_delay_swept_cuda(
        xd, g, *seq.stereo_delay_plan(dl, dr, lb, rb, xd.device), lb, rb,
        keep_w=True)
    assert torch.equal(got, out.data)
    assert max(seq.stereo_delay_step_errors(xd, g, dl, dr, lb, rb,
                                            w).values()) <= TOL_DELAY
    m = 48_000
    want = seq.stereo_delay_ref(xd[:, :m].contiguous(), g[:m], dl[:m],
                                dr[:m], lb, rb)
    assert (out.data[:, :m] - want).abs().max() <= (
        TOL_DELAY * want.abs().max())


@pytest.mark.cuda
def test_fractional_gather_chunks_give_the_same_bits(cuda_device,
                                                     monkeypatch):
    """The gather in chunks of outputs against one chunk on the card, bit
    for bit: each output's taps are summed in a fixed order."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 50_000)).astype(
        np.float32)).cuda()
    pos = torch.from_numpy(np.sort(rng.uniform(-40.0, 50_040.0, 70_001))
                           .astype(np.float32)).cuda()
    cut = torch.from_numpy(rng.uniform(0.3, 1.0, 70_001).astype(
        np.float32)).cuda()
    for taps in (32, 64):
        whole = resample.fractional_gather(x, pos, cut, taps)
        monkeypatch.setattr(resample, "_CHUNK_FLOATS", 2 * taps * 4099)
        chunked = resample.fractional_gather(x, pos, cut, taps)
        monkeypatch.undo()
        assert torch.equal(whole, chunked)
        cpu = resample.fractional_gather(x.cpu(), pos.cpu(), cut.cpu(), taps)
        assert (whole.cpu() - cpu).abs().max() <= 1e-5 * cpu.abs().max()
