"""The swept comb on the CPU: the kernels' round schedule in its plain form,
the one-step checks that hold a whole call to its own earlier outputs
(chip_smoke.py phase 8), and the comb against flan_tpu's filter_comb on
delays shaped like phase 8's. Inputs are made with numpy from a seed."""
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu_torch.ops import sequential_kernels as seq


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0


def _delays(shape: str, n: int) -> torch.Tensor:
    """Delays [n] int32: random 1-40, random 1-400 with every 7th 1, or
    shaped like phase 8's calls (the filter sweep's 120 -> 12, the
    gradient's rising 12 -> 6012, cut to n frames)."""
    rng = np.random.default_rng(len(shape) + n)
    if shape == "random_1_40":
        d = rng.integers(1, 41, n)
    elif shape == "random_1_400":
        d = rng.integers(1, 401, n)
        d[::7] = 1
    elif shape == "falling_120_12":
        d = 120.0 / 10.0 ** (np.arange(n) / n)
    else:
        d = 12 + np.floor(6000.0 * np.arange(n) / n)
    return torch.from_numpy(np.asarray(d, dtype=np.int32))


SHAPES = ("random_1_40", "random_1_400", "falling_120_12", "rising_12_6011")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 31, 1024, 1025, 5000])
@pytest.mark.parametrize("shape", SHAPES)
def test_round_schedule_reads_only_earlier_outputs(shape, n, reverse):
    """The kernels' rounds in their plain form (comb_round_starts, from
    the round lengths every frame of a tile gets at once) are the rounds
    _comb_rounds takes one by one at the kernels' width and tile; they
    cover every frame once, in order, none crosses a tile, and no step of
    a round reads an output of its own round: forward, every frame's
    source lies before the round; reverse, every frame's target (the frame
    it reads, which its adjoint is sent to) lies below it."""
    d = _delays(shape, n)
    starts = seq.comb_round_starts(d, reverse)
    rounds = list(seq._comb_rounds(d.long(), n, reverse, seq.COMB_WIDTH,
                                   seq.COMB_TILE))
    assert starts == [int(r[-1] if reverse else r[0]) for r in rounds]
    assert len(starts) == len(rounds)
    frames = torch.cat([r.flip(0) if reverse else r for r in rounds])
    order = torch.arange(n)
    assert torch.equal(frames, order.flip(0) if reverse else order)
    for r in rounds:
        lo, hi = int(r.min()), int(r.max())
        assert hi - lo + 1 == r.numel() <= seq.COMB_WIDTH
        assert lo // seq.COMB_TILE == hi // seq.COMB_TILE
        assert bool((r - d[r].long() < lo).all())


def _comb_case(n=3000, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, n, generator=g)
    gy = torch.randn(2, n, generator=g)
    d = _delays("random_1_400", n)
    k = torch.rand(n, generator=g) * 1.4 - 0.7
    a = torch.rand(n, generator=g)
    return x, gy, d, k, a


def _bumped(t, frame, ch=0):
    out = t.clone()
    out[ch, frame] += 1e-4 * t.abs().max()
    return out


@pytest.mark.parametrize("frame", [0, 1700, 2999])
def test_comb_step_checks(frame):
    """comb_step_errors and comb_backward_step_error pass the plain loops'
    outputs within the tolerances chip_smoke.py holds the kernels to
    (1e-6 forward, 1e-5 backward: 5.6e-8 and 6.2e-8 read here) and fail an
    output with one frame moved by 1e-4 of its peak."""
    x, gy, d, k, a = _comb_case()
    y, u = seq.comb_swept_ref(x, d, k, a, -1.0, keep_u=True)
    gu = seq.comb_swept_backward_ref(gy, d, k, a, -1.0)
    assert max(seq.comb_step_errors(x, d, k, a, -1.0, y, u).values()) < 1e-6
    assert seq.comb_backward_step_error(gy, d, k, a, -1.0, gu) < 1e-5
    assert seq.comb_step_errors(x, d, k, a, -1.0, _bumped(y, frame), u)[
        "y"] > 5e-5
    assert seq.comb_step_errors(x, d, k, a, -1.0, y, _bumped(u, frame, 1))[
        "u"] > 5e-5
    assert seq.comb_backward_step_error(gy, d, k, a, -1.0,
                                        _bumped(gu, frame)) > 5e-5


def _saturator_case(two_pole: bool, n=400):
    rng = np.random.default_rng(2)
    t = torch.arange(n) / SR
    x = torch.from_numpy((0.8 * rng.standard_normal((2, n))).astype(
        np.float32))
    g = torch.tan(np.pi / SR * (300.0 + 300.0 * t))
    k, mix = torch.full((n,), 0.7), torch.full((n,), 0.5)
    if two_pole:
        R = torch.full((n,), 0.4)
        dd = 1.0 / (1.0 + 2.0 * R * g + g * g)
        return x, (g, dd * (1.0 - 2.0 * R * g + g * g), k, mix, R, dd)
    return x, (g, g / (1.0 + g), (g - 1.0) / (g + 1.0), k, mix)


@pytest.mark.parametrize("two_pole", [False, True])
@pytest.mark.parametrize("frame", [0, 200, 399])
def test_saturator_step_checks(two_pole, frame):
    """saturator_step_errors passes the plain loop's output and states
    within 1e-5 (chip_smoke.py's TOL_SATURATOR; 7.9e-8 to 1.1e-7 read
    here) and fails
    an output or a state with one frame moved by 1e-4 of its peak."""
    x, planes = _saturator_case(two_pole)
    ref = seq.saturator_2pole_ref if two_pole else seq.saturator_1pole_ref
    y, states = ref(x, *planes, 1.0, 2, keep_states=True)
    args = (x, planes, 1.0, 2, two_pole)
    assert max(seq.saturator_step_errors(*args, y, states).values()) < 1e-5
    assert seq.saturator_step_errors(*args, _bumped(y, frame),
                                     states)["y"] > 5e-5
    bumped = states.clone()
    bumped[1, 1, frame] += 1e-4 * states[:, 1].abs().max()
    assert seq.saturator_step_errors(*args, y, bumped)["states"] > 5e-5


def _rising(t):
    """A cutoff whose delays rise as phase 8's gradient call's, 10 + floor(
    200 t) samples and a half (10 -> 160 at 8 kHz): the half keeps either
    package's float32 w from rounding sr / (2 w) across an integer."""
    return SR / (2.0 * ((10.0 + 200.0 * t) // 1.0 + 0.5))


# the swept comb against the JAX package's ring-buffer scan, on cutoffs
# whose delays fall as phase 8's filter sweep's (20 -> 2 samples at 8
# kHz) and rise as its gradient's: 0, 0 and 1.0e-7 of the peak read (CPU);
# bound 1e-6, as tests/test_torch_multinotch.py's comb cases
COMB_SWEEPS = {
    "falling": (lambda t: 200.0 * 10.0 ** (t / 0.75), 0.5, 0.5),
    "rising": (_rising, 0.5, 0.5),
    "rising_inverted": (_rising, lambda t: 0.2 + 0.6 * t, 0.3, True),
}


@pytest.mark.parametrize("case", sorted(COMB_SWEEPS))
def test_swept_comb_matches_flan_tpu_on_phase8_shapes(case):
    rng = np.random.default_rng(9)
    n = 6000
    x = (0.5 * rng.standard_normal((2, n))).astype(np.float32)
    args = COMB_SWEEPS[case]
    want = np.array(flan_tpu.Audio.create_from_array(x, SR).filter_comb(
        *args).data)
    got = flan_tpu_torch.Audio.create_from_array(
        x, SR, device="cpu").filter_comb(*args).to_numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert seq.LAUNCHES == dict.fromkeys(seq.LAUNCHES, 0)
