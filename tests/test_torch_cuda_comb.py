"""The swept comb's kernels and the saturator's division range, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_comb.py
"""
import numpy as np
import pytest
import torch

from flan_tpu_torch.ops import build, sequential_kernels

# the comb kernel against its plain loop, times the peak: a step's
# arithmetic is the same in both, to fused multiply-adds (forward); the
# adjoints sent to one sample are summed in another order (backward)
TOL_COMB, TOL_COMB_BACK = 1e-6, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _comb_inputs(n: int, delays: str, seed: int = 3):
    """x and gy [2, n], delays [n] int32, k and a [n] on the card: random
    delays in lo..hi for "lo-hi", or a sweep falling from 1920 to 3."""
    rng = np.random.default_rng(seed)
    if delays == "sweep":
        d = np.linspace(1920.0, 3.0, n).astype(np.int32)
    else:
        lo, hi = (int(v) for v in delays.split("-"))
        d = rng.integers(lo, hi + 1, n).astype(np.int32)
    x, gy = (rng.standard_normal((2, n)).astype(np.float32) for _ in "xg")
    k = rng.uniform(-0.7, 0.7, n).astype(np.float32)
    a = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return tuple(torch.from_numpy(v).cuda() for v in (x, gy, d, k, a))


# delays of one step a round (1-40), of the filter path's sweep (12-120),
# past the shared-memory ring (30000-60000: the ring in device memory), a
# sweep through every round length (1920 -> 3); lengths off the tile of
# 1024 frames, one frame, one tile and one more
COMB_CASES = ([("1-40", n) for n in (1, 1023, 1025, 3001, 50_000)]
              + [("12-120", 50_000), ("12-120", 2048),
                 ("30000-60000", 100_000), ("sweep", 100_003)])


@pytest.mark.cuda
@pytest.mark.parametrize("delays,n", COMB_CASES)
def test_comb_kernels_match_plain_loops(cuda_device, delays, n):
    """The comb's forward (y and u) and backward kernels against their
    plain loops, TOL_COMB and TOL_COMB_BACK of the peak, and every frame by
    one step from the kernels' own outputs (comb_step_errors,
    comb_backward_step_error); one launch each; the same bits on three
    calls."""
    x, gy, d, k, a = _comb_inputs(n, delays)
    ring = int(d.max())
    before = dict(sequential_kernels.LAUNCHES)
    y, u = sequential_kernels.comb_swept_cuda(x, d, k, a, -1.0, ring,
                                              keep_u=True)
    gu = sequential_kernels.comb_swept_backward_cuda(gy, d, k, a, -1.0, ring)
    for key in ("comb_swept", "comb_swept_backward"):
        assert sequential_kernels.LAUNCHES[key] == before[key] + 1
    y_ref, u_ref = sequential_kernels.comb_swept_ref(x, d, k, a, -1.0,
                                                     keep_u=True)
    gu_ref = sequential_kernels.comb_swept_backward_ref(gy, d, k, a, -1.0)
    assert (y - y_ref).abs().max() <= TOL_COMB * y_ref.abs().max()
    assert (u - u_ref).abs().max() <= TOL_COMB * u_ref.abs().max()
    assert (gu - gu_ref).abs().max() <= TOL_COMB_BACK * gu_ref.abs().max()
    step = sequential_kernels.comb_step_errors(x, d, k, a, -1.0, y, u)
    assert max(step.values()) <= TOL_COMB
    assert sequential_kernels.comb_backward_step_error(
        gy, d, k, a, -1.0, gu) <= TOL_COMB_BACK
    for _ in range(2):
        again = sequential_kernels.comb_swept_cuda(x, d, k, a, -1.0, ring,
                                                   keep_u=True)
        assert torch.equal(y, again[0]) and torch.equal(u, again[1])
        assert torch.equal(y, sequential_kernels.comb_swept_cuda(
            x, d, k, a, -1.0, ring))
        assert torch.equal(gu, sequential_kernels.comb_swept_backward_cuda(
            gy, d, k, a, -1.0, ring))


@pytest.mark.cuda
def test_comb_rounds_are_the_library_s(cuda_device):
    """The plain round schedule (comb_round_lengths) takes the kernels'
    tile and width, as the library reports them."""
    lib = build.load_library()
    assert lib.flan_comb_tile() == sequential_kernels.COMB_TILE
    assert lib.flan_comb_width() == sequential_kernels.COMB_WIDTH


# C.14: the saturator's Newton division (div_fast: no range check) on
# inputs whose residuals are tiny: a signal at ~1e-30, and one that decays
# through the subnormal range (1e-36 to ~1e-45)
SAT_TINY = {"scaled_1e-30": lambda x, t: x * 1e-30,
            "decaying_subnormal": lambda x, t: x * 1e-36 * 2.0 ** (-30 * t)}


@pytest.fixture(scope="module")
def checked_division():
    """The saturator source with the compiler's IEEE division (its range
    check and slow path) in each Newton step (ops/spv_variants.py
    forward_checked_division), built on its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from flan_tpu_torch.ops import spv_variants
    name = "forward_checked_division"
    return spv_variants.build_variants(
        build.CSRC, "saturator",
        {name: spv_variants.SATURATOR_VARIANTS[name]}, build.SIGNATURES)[name]


@pytest.mark.cuda
@pytest.mark.parametrize("two_pole", [False, True])
@pytest.mark.parametrize("case", sorted(SAT_TINY))
def test_saturator_division_range(cuda_device, checked_division, case,
                                  two_pole):
    """The saturator kernel at order 2 on tiny inputs against its plain
    loop on the CPU (1e-5 of the peak, as at normal sizes) and against the
    same source with the checked division: the same bits."""
    n, order, inv = 2000, 2, 1.0
    rng = np.random.default_rng(11)
    t = np.arange(n) / n
    x = np.stack([rng.standard_normal(n), np.sin(0.05 * np.arange(n))])
    x = torch.from_numpy(SAT_TINY[case](x, t).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.uniform(0.02, 0.6, n).astype(np.float32)).cuda()
    k = torch.full((n,), 0.7, device="cuda")
    mix = torch.full((n,), 0.5, device="cuda")
    if two_pole:
        R = torch.full((n,), 0.4, device="cuda")
        d = 1.0 / (1.0 + 2.0 * R * g + g * g)
        planes = (g, d * (1.0 - 2.0 * R * g + g * g), k, mix, R, d)
    else:
        planes = (g, g / (1.0 + g), (g - 1.0) / (g + 1.0), k, mix)
    got = sequential_kernels.saturator_cuda(x, planes, inv, order, two_pole)
    ref = (sequential_kernels.saturator_2pole_ref if two_pole
           else sequential_kernels.saturator_1pole_ref)
    want = ref(x.cpu(), *(p.cpu() for p in planes), inv, order)
    assert bool(torch.isfinite(got).all())
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()
    checked = torch.empty_like(x)
    build.raise_on(checked_division.flan_saturator_multinotch(
        int(two_pole), x.data_ptr(), *(
            None if p is None else p.data_ptr()
            for p in sequential_kernels._kernel_planes(planes, two_pole)),
        checked.data_ptr(), None, 2, n, order, inv,
        torch.cuda.current_stream().cuda_stream), case)
    torch.cuda.synchronize()
    assert torch.equal(got, checked), float((got - checked).abs().max())
