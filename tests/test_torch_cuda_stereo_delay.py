"""The swept stereo delay's kernels (the forward in both regimes, the
backward) and the chunked fractional gather, on the card.

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

# the forward against its plain loop, times the peak: every step in the
# same float32 operations (no fused multiply-add), so 0 is expected (the
# same bits); the bound leaves room for nothing else
TOL_DELAY = 1e-6
# the backward against its plain version: the same operations, the sends
# to a slot in the same order (0 expected)
TOL_DELAY_BACK = 1e-6
# gradients on the card against the CPU's, times their peaks: the same
# adjoint on the same float32 values (the decay sampled on each device)
TOL_GRAD = 1e-4
VARIANTS = ("narrow_shared", "narrow_device", "wide_shared", "wide_device")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _delay_inputs(n: int, lb: int, rb: int, kind: str, seed: int = 5):
    """x [2, n] and g [n] on the card, dl and dr [n] on the host: random in
    [0, ring], only 0, 1 and the ring size ("ends"), all 1 ("ones"),
    sweeping through every distance up to the ring ("sweep"), or random
    but at least two wide rounds back ("far", as on phase 9's long sweep);
    and the reads' distances el, er on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-0.9, 0.9, n).astype(np.float32))
    if kind == "random":
        dl, dr = rng.integers(0, lb + 1, n), rng.integers(0, rb + 1, n)
    elif kind == "ends":
        dl, dr = rng.choice([0, 1, lb], n), rng.choice([0, 1, rb], n)
    elif kind == "ones":
        dl = dr = np.ones(n, np.int64)
    elif kind == "far":
        near = 2 * seq.STEREO_WIDE_WIDTH + 5
        dl, dr = rng.integers(near, lb, n), rng.integers(near, rb + 1, n)
    else:
        ramp = np.abs(np.sin(np.linspace(0.0, 7.0, n)))
        dl = (ramp * lb).astype(np.int64)
        dr = (ramp[::-1] * rb).astype(np.int64)
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl).cuda(),
                                    torch.from_numpy(dr).cuda(), lb, rb)
    return x.cuda(), g.cuda(), dl, dr, el, er


def _variants(lb: int, rb: int, backward: bool = False):
    """The variants a call with these rings can take: the shared ones
    where the rings fit."""
    lib = seq.load_library()
    return [v for v in VARIANTS
            if v.endswith("_device") or lib.flan_stereo_delay_shared_bytes(
                seq._delay_kind(v.startswith("wide"), backward), lb, rb)
            <= lib.flan_max_shared_bytes()]


# rings in shared memory and past it (the reads from device memory);
# lengths of one frame, around a tile of 1024 and past a few hundred
# rounds; the shared variants where their rings fit
DELAY_CASES = ([(n, 50, 70, "random") for n in (1, 1023, 1025, 3001)]
               + [(20_000, 1, 1, "ones"), (20_000, 1, 5, "ends"),
                  (20_000, 700, 1024, "ends"), (50_000, 1500, 2900, "sweep"),
                  (30_000, 17, 4000, "random"), (100_000, 30_000, 3, "ends"),
                  (100_003, 26_400, 45_600, "sweep"),
                  (60_000, 1, 70_000, "random"),
                  (70_000, 40_000, 9_000, "ends"),
                  (200_001, 200, 300, "sweep"),
                  (150_001, 30_000, 40_000, "far")])


@pytest.mark.cuda
@pytest.mark.parametrize("n,lb,rb,kind", DELAY_CASES)
def test_stereo_delay_kernel_matches_plain_loop(cuda_device, n, lb, rb,
                                                kind):
    """Each variant of the forward against the plain version on the same
    inputs, TOL_DELAY of the peak; its writes over every frame by one step
    in float64, and over the first 5000 against the loop step by step; one
    launch; the rounds it ran those of its regime's plan
    (stereo_delay_narrow_starts, stereo_delay_wide_starts); the same bits
    on three calls."""
    x, g, dl, dr, el, er = _delay_inputs(n, lb, rb, kind)
    want, w_ref = seq.stereo_delay_ref(x, g, el, er, lb, rb, keep_w=True)
    peak = w_ref.abs().max().clamp(min=1e-30)
    m = min(n, 5000)
    _, w_loop = seq.stereo_delay_loop(x[:, :m].cpu().numpy(),
                                      g[:m].cpu().numpy(), dl[:m], dr[:m],
                                      lb, rb)
    plans = {"narrow": seq.stereo_delay_narrow_starts(el, er) + [n],
             "wide": seq.stereo_delay_wide_starts(el, er)}
    for variant in _variants(lb, rb):
        rounds = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        before = seq.LAUNCHES["stereo_delay_swept"]
        out, w = seq.stereo_delay_swept_cuda(x, g, el, er, lb, rb,
                                             keep_w=True, variant=variant,
                                             rounds=rounds)
        assert seq.LAUNCHES["stereo_delay_swept"] == before + 1
        assert seq.VARIANTS["stereo_delay_swept"] == variant
        assert (w - w_ref).abs().max() <= TOL_DELAY * peak, variant
        assert torch.equal(out, seq.stereo_delay_outputs(w, lb, rb))
        assert (out - want).abs().max() <= TOL_DELAY * peak, variant
        assert max(seq.stereo_delay_step_errors(
            x, g, el, er, lb, rb, w).values()) <= TOL_DELAY, variant
        assert (w[:, :m].cpu() - torch.from_numpy(w_loop)).abs().max() \
            <= TOL_DELAY * peak.cpu(), variant
        assert int(rounds) == len(plans[variant.split("_")[0]]) - 1, variant
        for _ in range(2):
            again = seq.stereo_delay_swept_cuda(x, g, el, er, lb, rb,
                                                variant=variant)
            assert torch.equal(again, out), variant


@pytest.mark.cuda
@pytest.mark.parametrize("n,lb,rb,kind", DELAY_CASES)
def test_stereo_delay_backward_kernel_matches_plain(cuda_device, n, lb, rb,
                                                    kind):
    """Each variant of the backward against its plain version on the same
    inputs, TOL_DELAY_BACK of the peak, every frame by one step in float64
    from its own later values, its last 4000 frames against the adjoint
    step by step on the host (run on the call's last frames: nothing
    before them reaches them); the rounds it ran its regime's plan
    (stereo_delay_narrow_starts' from the end, stereo_delay_wide_back_starts);
    the same bits on three calls."""
    x, g, dl, dr, el, er = _delay_inputs(n, lb, rb, kind)
    gout = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, n)).astype(np.float32)).cuda()
    want = seq.stereo_delay_backward_ref(gout, g, el, er, lb, rb)
    peak = want.abs().max().clamp(min=1e-30)
    m = min(n, 4000)
    loop = torch.from_numpy(seq.stereo_delay_backward_loop(
        gout[:, n - m:].cpu().numpy(), g[n - m:].cpu().numpy(), dl[n - m:],
        dr[n - m:], lb, rb))
    for variant in _variants(lb, rb, backward=True):
        rounds = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        before = seq.LAUNCHES["stereo_delay_swept_backward"]
        gw = seq.stereo_delay_swept_backward_cuda(gout, g, el, er, lb, rb,
                                                  variant=variant,
                                                  rounds=rounds)
        assert seq.LAUNCHES["stereo_delay_swept_backward"] == before + 1
        assert (gw - want).abs().max() <= TOL_DELAY_BACK * peak, variant
        assert max(seq.stereo_delay_backward_step_error(
            gout, g, el, er, lb, rb, gw).values()) <= TOL_DELAY_BACK, variant
        assert (gw[:, n - m:].cpu() - loop).abs().max() <= \
            TOL_DELAY_BACK * peak.cpu(), variant
        assert int(rounds) == (
            len(seq.stereo_delay_wide_back_starts(el, er)) - 1
            if variant.startswith("wide") else
            len(seq.stereo_delay_narrow_starts(el, er, reverse=True))), \
            variant
        for _ in range(2):
            again = seq.stereo_delay_swept_backward_cuda(gout, g, el, er, lb,
                                                         rb, variant=variant)
            assert torch.equal(again, gw), variant


def _sweep_delays(kind: str, n: int):
    """(dl, dr, lb, rb) of a sweep whose every nearer read lies at least
    STEREO_BACK_WIDE_FROM frames back: "rising" delays that grow by one
    frame a step in teeth (runs of one target), "falling" ones that shrink
    by one a step, "stepped" jumps between two delays; each at a small
    scale (rings in shared memory) and a large one (in device memory)."""
    t = np.arange(n)
    near = seq.STEREO_BACK_WIDE_FROM
    scale = 1 if kind.endswith("_small") else 12
    kind = kind.rsplit("_", 1)[0]
    span = 300 * scale
    if kind == "rising":
        dl, dr = near + t % span, near + 40 + (t + 77) % span
    elif kind == "falling":
        dl, dr = near + span - t % span, near + span - (t + 31) % span
    else:
        dl = np.where((t // (5000 * scale)) % 2 == 1, near + span, near + 10)
        dr = np.where((t // (3000 * scale)) % 2 == 1, near + 5, near + span)
    lb, rb = int(dl.max()) + 1, int(dr.max())
    return dl.astype(np.int64), dr.astype(np.int64), lb, rb


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [f"{k}_{s}" for k in ("rising", "falling",
                                                       "stepped")
                                  for s in ("small", "large")])
def test_wide_backward_is_the_narrow_backwards_bits(cuda_device, kind):
    """The wide backward against the narrow backward on the same call
    (torch.equal) and against the adjoint step by step on the host over
    the call's last 4000 frames, on rising, falling and stepped sweeps of
    100,003 frames, with the sums in shared memory and in device memory
    (each variant the rings allow); the dispatch takes the wide regime
    there."""
    n = 100_003
    dl, dr, lb, rb = _sweep_delays(kind, n)
    rng = np.random.default_rng(13)
    gout = torch.from_numpy(rng.standard_normal((2, n)).astype(
        np.float32)).cuda()
    g = torch.from_numpy(rng.uniform(-0.9, 0.9, n).astype(np.float32)).cuda()
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl).cuda(),
                                    torch.from_numpy(dr).cuda(), lb, rb)
    narrow = [v for v in _variants(lb, rb, True) if v.startswith("narrow")]
    want = seq.stereo_delay_swept_backward_cuda(gout, g, el, er, lb, rb,
                                                variant=narrow[0])
    m = 4000
    loop = torch.from_numpy(seq.stereo_delay_backward_loop(
        gout[:, n - m:].cpu().numpy(), g[n - m:].cpu().numpy(), dl[n - m:],
        dr[n - m:], lb, rb))
    wide = [v for v in _variants(lb, rb, True) if v.startswith("wide")]
    assert wide[-1] == "wide_device"
    if kind.endswith("_small"):
        assert wide[0] == "wide_shared"
    for variant in wide:
        got = seq.stereo_delay_swept_backward_cuda(gout, g, el, er, lb, rb,
                                                   variant=variant)
        assert torch.equal(got, want), variant
        assert torch.equal(got[:, n - m:].cpu(), loop), variant
    seq.stereo_delay_swept_backward_cuda(gout, g, el, er, lb, rb)
    assert seq.VARIANTS["stereo_delay_swept_backward"] == wide[0]


@pytest.mark.cuda
def test_stereo_delay_rounds_cross_tiles_as_planned(cuda_device):
    """Delays that change at every round edge and tile edge: every variant
    runs its regime's plan, whatever the rounds' widths, and the dispatch
    takes the wide regime where every read is far back."""
    n = 40_000
    rng = np.random.default_rng(9)
    dl = rng.choice([0, 1, 3, 1023, 1024, 1025, 2047], n)
    dr = rng.choice([1, 2, 1024, 1500, 2048], n)
    lb, rb = 2047, 2048
    x, g, _, _, _, _ = _delay_inputs(n, lb, rb, "ones")
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl).cuda(),
                                    torch.from_numpy(dr).cuda(), lb, rb)
    want = seq.stereo_delay_ref(x, g, el, er, lb, rb)
    for variant in _variants(lb, rb):
        got = seq.stereo_delay_swept_cuda(x, g, el, er, lb, rb,
                                          variant=variant)
        assert (got - want).abs().max() <= TOL_DELAY * want.abs().max()
    far = seq.STEREO_WIDE_FROM + rng.integers(0, 3000, n)
    el, er = (torch.from_numpy(v.astype(np.int32)).cuda()
              for v in (far % 4000, far))
    seq.stereo_delay_swept(x, g, el, er, 4000, 4000)
    assert seq.VARIANTS["stereo_delay_swept"].startswith("wide")
    seq.stereo_delay_swept(x, g, el.clamp(max=seq.STEREO_WIDE_FROM - 1), er,
                           4000, 4000)
    assert seq.VARIANTS["stereo_delay_swept"].startswith("narrow")


def _sweeps():
    two_pi = 2.0 * np.pi
    return {"long": (lambda t: 0.30 + 0.25 * torch.sin(two_pi * 0.05 * t),
                     lambda t: 0.50 + 0.45 * torch.sin(two_pi * 0.07 * t)),
            "flanger": (
                lambda t: 0.0004 + 0.0002 * torch.sin(two_pi * 0.25 * t),
                lambda t: 0.0004 + 0.0002 * torch.cos(two_pi * 0.3 * t))}


def _host_reads(lt, rt, n: int, sr: float):
    """(dl, dr, el, er, lb, rb) on the host, as the JAX package takes them
    (flan_tpu/audio/temporal.py:457-461) from the sampled delay times."""
    lt_s, rt_s = (np.asarray(temporal.sample_delay_times(as_function(f), n,
                                                         sr), np.float64)
                  for f in (lt, rt))
    lb, rb = int(lt_s.max() * sr), int(rt_s.max() * sr)
    dl = np.minimum(np.maximum((lt_s * sr).astype(np.int64), 0), lb)
    dr = np.minimum(np.maximum((rt_s * sr).astype(np.int64), 0), rb)
    return (dl, dr) + seq.stereo_delay_distances(dl, dr, lb, rb) + (lb, rb)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["long", "flanger"])
def test_stereo_delay_10s_swept_call_by_one_step(cuda_device, sweep):
    """A 10 s stereo swept call at 48 kHz through Audio.stereo_delay (the
    kernel): the reads' distances the card worked out equal the host's
    over every frame, every frame held by one step in float64 from its own
    writes, its first 48,000 frames to the plain version on the same
    inputs."""
    sr, seconds = 48000.0, 10.0
    n = int(sr * seconds)
    x = np.random.default_rng(2).standard_normal((2, n)).astype(np.float32)
    lt, rt = _sweeps()[sweep]
    a = Audio.create_from_array(x, sr, device=cuda_device)
    before = seq.LAUNCHES["stereo_delay_swept"]
    kept = {}
    real = seq.stereo_delay_swept_cuda

    def spy(*args, **kwargs):
        kept["args"] = args
        return real(*args, **kwargs)
    seq.stereo_delay_swept_cuda = spy
    try:
        out = a.stereo_delay(seconds, lt, rt, 0.5)
    finally:
        seq.stereo_delay_swept_cuda = real
    assert seq.LAUNCHES["stereo_delay_swept"] == before + 1
    _, _, el_h, er_h, lb, rb = _host_reads(lt, rt, n, sr)
    xd, g, el, er, lb_c, rb_c = kept["args"]
    assert (lb_c, rb_c) == (lb, rb)
    assert np.array_equal(el.cpu().numpy(), el_h)
    assert np.array_equal(er.cpu().numpy(), er_h)
    got, w = seq.stereo_delay_swept_cuda(xd, g, el, er, lb, rb, keep_w=True)
    assert torch.equal(got, out.data)
    assert max(seq.stereo_delay_step_errors(xd, g, el, er, lb, rb,
                                            w).values()) <= TOL_DELAY
    m = 48_000
    want = seq.stereo_delay_ref(xd[:, :m].contiguous(), g[:m], el[:m],
                                er[:m], lb, rb)
    assert (out.data[:, :m] - want).abs().max() <= (
        TOL_DELAY * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["long", "flanger"])
def test_stereo_delay_gradient_on_the_card_is_the_cpus(cuda_device, sweep):
    """The gradient of a swept Audio.stereo_delay in the signal and in a
    0-d decay on the card (StereoDelaySwept: the forward kernel and the
    backward kernel, one launch each) against the CPU's (the plain
    versions), TOL_GRAD of each gradient's peak, at 2 s stereo 48 kHz."""
    sr, seconds = 48000.0, 2.0
    n = int(sr * seconds)
    x = np.random.default_rng(3).standard_normal((2, n)).astype(np.float32)
    lt, rt = _sweeps()[sweep]
    weight = np.random.default_rng(4).standard_normal((2, n)).astype(
        np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        v = torch.from_numpy(x).to(dev).requires_grad_()
        d = torch.tensor(0.6, device=dev, requires_grad=True)
        fwd = seq.LAUNCHES["stereo_delay_swept"]
        back = seq.LAUNCHES["stereo_delay_swept_backward"]
        y = Audio.create_from_array(v, sr).stereo_delay(seconds, lt, rt,
                                                        d).data
        grads[str(dev)] = [t.cpu() for t in torch.autograd.grad(
            (y * torch.from_numpy(weight).to(dev)).sum(), (v, d))]
        on_card = dev != "cpu"
        assert seq.LAUNCHES["stereo_delay_swept"] == fwd + on_card
        assert seq.LAUNCHES["stereo_delay_swept_backward"] == back + on_card
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        assert (got - want).abs().max() <= TOL_GRAD * want.abs().max()


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
