"""The swept stereo delay's gradient (ops/sequential_kernels.py
StereoDelaySwept): through the port's Audio.stereo_delay against jax.grad
of flan_tpu's (its lax.scan), and its adjoint's plain version against the
adjoint step by step, against autograd through the plain forward in
float64, and by one step over every frame. Inputs are made with numpy from
a seed at 8 kHz; every tolerance names the reading it was set from (CPU).
The card's backward kernel is held to the same plain version in
tests/test_torch_cuda_stereo_delay.py.
"""
import jax
import jax.numpy as jnp
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
# gradients against jax.grad, times each gradient's peak: the same float32
# loop, its adjoint summed in another order by XLA (0 to 9.0e-7 read);
# bound 1e-5
TOL_GRAD = 1e-5


def _noise(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# delay times (seconds) as the same float32 formula in torch and in jnp:
# reads a few frames back (narrow rounds of ~4-13 steps), more than a warp
# back (rounds of 34 to 200), more than a tile of 1024 back (rounds
# across tiles), and one crossing 0 and the ring (el = 0, er = rb)
SWEEPS = {
    "narrow": (lambda m: lambda t: 0.0008 + 0.0004 * m.sin(9.0 * t),
               lambda m: lambda t: 0.001 + 0.0005 * m.cos(7.0 * t)),
    "medium": (lambda m: lambda t: 0.015 + 0.01 * m.sin(5.0 * t),
               lambda m: lambda t: 0.02 - 0.012 * t),
    "wide": (lambda m: lambda t: 0.2 + 0.06 * m.sin(3.0 * t),
             lambda m: lambda t: 0.15 + 0.1 * t),
    "ends": (lambda m: lambda t: 0.004 * (0.5 + 0.5 * m.sin(40.0 * t)),
             lambda m: lambda t: 0.003 * (t < 0.2)),
}


def _losses(x, weight, seconds, sweep):
    """The loss sum(weight * y) of a swept stereo_delay of x, as a function
    of (x, decay), in each package."""
    lt, rt = SWEEPS[sweep]

    def jax_loss(xv, d):
        a = flan_tpu.Audio.create_from_array(xv, SR)
        y = a.stereo_delay(seconds, lt(jnp), rt(jnp), d).data
        return jnp.sum(y * weight)

    def torch_loss(xv, d):
        a = flan_tpu_torch.Audio.create_from_array(xv, SR)
        y = a.stereo_delay(seconds, lt(torch), rt(torch), d).data
        return (y * torch.from_numpy(weight)).sum()
    return jax_loss, torch_loss


def _peak_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
@pytest.mark.parametrize("seconds", [0.3, 0.5])
def test_gradient_matches_jax_grad(sweep, seconds):
    """The gradient in the signal and in a 0-d decay through the port's
    swept Audio.stereo_delay (StereoDelaySwept on its plain versions)
    against jax.grad through flan_tpu's, TOL_GRAD of each peak; the output
    longer than the input (0.5 s of 0.375 s), so some steps read only the
    rings."""
    x = _noise((2, 3000), seed=len(sweep))
    out_n = int(seconds * SR)
    weight = _noise((2, out_n), seed=9)
    jax_loss, torch_loss = _losses(x, weight, seconds, sweep)
    gx_j, gd_j = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.float32(0.6))
    xv = torch.from_numpy(x).requires_grad_()
    d = torch.tensor(0.6, requires_grad=True)
    gx_t, gd_t = torch.autograd.grad(torch_loss(xv, d), (xv, d))
    assert _peak_rel(gx_t.numpy(), np.array(gx_j)) < TOL_GRAD
    assert _peak_rel(gd_t.numpy(), np.array(gd_j)) < TOL_GRAD
    assert seq.LAUNCHES["stereo_delay_swept_backward"] == 0


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_gradient_in_a_swept_decay_matches_jax_grad(sweep):
    """A decay Function of time that is itself a parameter's output (a 0-d
    tensor times a ramp): the decay's gradient summed through the ramp,
    against jax.grad."""
    x = _noise((2, 2400), seed=3)
    weight = _noise((2, 2400), seed=4)
    lt, rt = SWEEPS[sweep]

    def jax_loss(k):
        y = flan_tpu.Audio.create_from_array(x, SR).stereo_delay(
            0.3, lt(jnp), rt(jnp), lambda t: k * (0.5 + t)).data
        return jnp.sum(y * weight)

    k = torch.tensor(0.7, requires_grad=True)
    y = flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"
                                               ).stereo_delay(
        0.3, lt(torch), rt(torch), lambda t: k * (0.5 + t)).data
    (got,) = torch.autograd.grad((y * torch.from_numpy(weight)).sum(), (k,))
    want = float(jax.grad(jax_loss)(jnp.float32(0.7)))
    assert abs(float(got) - want) <= TOL_GRAD * max(abs(want), 1e-30)


def _delay_case(lb, rb, kind, n, seed=0):
    """x, gout [2, n] and g [n] float32 and delays dl, dr [n]: anywhere in
    [0, ring], only 0, 1 and the ring size ("ends"), all 1 ("ones"), or a
    sweep rising one frame a step (every second step sends to the slot
    the step before sends to)."""
    rng = np.random.default_rng(seed + lb * 7 + rb)
    x, gout = _noise((2, n), seed=lb), _noise((2, n), seed=rb + 1)
    g = rng.uniform(-0.95, 0.95, n).astype(np.float32)
    if kind == "random":
        dl, dr = rng.integers(0, lb + 1, n), rng.integers(0, rb + 1, n)
    elif kind == "ends":
        dl, dr = rng.choice([0, 1, lb], n), rng.choice([0, 1, rb], n)
    elif kind == "ones":
        dl, dr = np.ones(n, np.int64), np.ones(n, np.int64)
    else:
        dl = np.minimum(np.arange(n) // 2, lb)
        dr = np.minimum(np.arange(n) // 2 + 1, rb)
    return x, gout, g, dl, dr


BACK_CASES = [(1, 1, "random"), (40, 3, "random"), (97, 250, "random"),
              (64, 64, "ends"), (300, 17, "ends"), (200, 150, "ones"),
              (1500, 1200, "rise"), (2000, 2047, "random")]


@pytest.mark.parametrize("lb,rb,kind", BACK_CASES)
def test_backward_plain_is_the_adjoint_loop(lb, rb, kind):
    """stereo_delay_backward_ref, on the host planner's rounds (wide, at
    the kernels' tile, in rounds of 5), against the adjoint step by step
    (stereo_delay_backward_loop, which follows each read through the
    loop's rings), bit for bit: the same operations, a slot's sends
    summed the later step first; every frame by one step in float64
    (4e-8 to 8e-8 of the peak read)."""
    n = 2500
    x, gout, g, dl, dr = _delay_case(lb, rb, kind, n)
    want = seq.stereo_delay_backward_loop(gout, g, dl, dr, lb, rb)
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl), torch.from_numpy(dr),
                                    lb, rb)
    go, gt = torch.from_numpy(gout), torch.from_numpy(g)
    for tile in (4096, seq.STEREO_TILE, 5):
        got = seq.stereo_delay_backward_ref(go, gt, el, er, lb, rb, tile=tile)
        assert np.array_equal(got.numpy(), want)
    step = seq.stereo_delay_backward_step_error(go, gt, el, er, lb, rb, got)
    assert max(step.values()) < 1e-6


@pytest.mark.parametrize("lb,rb,kind", BACK_CASES)
def test_backward_plain_is_autograd_in_float64(lb, rb, kind):
    """The adjoint's plain version in float64 against torch's autograd
    through the plain forward in float64, in the signal and (with
    stereo_delay_decay_grad on the forward's w) in the decay at every
    step: the same sums in another order (~1e-15 of the peak read; bound
    1e-12); the float32 loop within float32's rounding of them (bound
    1e-5)."""
    n = 1800
    x, gout, g, dl, dr = _delay_case(lb, rb, kind, n, seed=1)
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl), torch.from_numpy(dr),
                                    lb, rb)
    x64 = torch.from_numpy(x).double().requires_grad_()
    g64 = torch.from_numpy(g).double().requires_grad_()
    go64 = torch.from_numpy(gout).double()
    out = seq.stereo_delay_ref(x64, g64, el, er, lb, rb)
    gx, gg = torch.autograd.grad((out * go64).sum(), (x64, g64))
    gw = seq.stereo_delay_backward_ref(go64, g64.detach(), el, er, lb, rb)
    _, w = seq.stereo_delay_ref(x64.detach(), g64.detach(), el, er, lb, rb,
                                keep_w=True)
    gd = seq.stereo_delay_decay_grad(gw, w, el, er)
    assert float((gw - gx).abs().max()) <= 1e-12 * float(gx.abs().max())
    assert float((gd - gg).abs().max()) <= 1e-12 * float(gg.abs().max())
    loop = seq.stereo_delay_backward_loop(gout, g, dl, dr, lb, rb)
    assert np.abs(loop - gx.numpy()).max() <= 1e-5 * np.abs(gx.numpy()).max()


@pytest.mark.parametrize("lb,rb,kind", BACK_CASES[:4])
def test_stereo_delay_swept_passes_gradcheck(lb, rb, kind):
    """StereoDelaySwept through the dispatch, in float64 on the CPU:
    torch.autograd.gradcheck in the signal and the decay."""
    n = 60
    x, _, g, dl, dr = _delay_case(lb, rb, kind, n, seed=2)
    el, er = seq.stereo_delay_reads(torch.from_numpy(dl), torch.from_numpy(dr),
                                    lb, rb)
    xv = torch.from_numpy(x).double().requires_grad_()
    gv = torch.from_numpy(g).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: seq.stereo_delay_swept(a, b, el, er, lb, rb), (xv, gv))


def test_delays_take_no_gradient_and_cpu_launches_nothing():
    """The delay times are integers on the host's grid: a delay Function of
    a tensor that wants a gradient gets none; no kernel launches on the
    CPU."""
    x = torch.from_numpy(_noise((2, 800))).requires_grad_()
    y = flan_tpu_torch.Audio.create_from_array(x, SR).stereo_delay(
        0.1, lambda t: 0.01 + 0.005 * torch.sin(20.0 * t), 0.02, 0.5).data
    (gx,) = torch.autograd.grad(y.sum(), (x,))
    assert torch.isfinite(gx).all() and gx.abs().max() > 0
    assert seq.LAUNCHES["stereo_delay_swept"] == 0
    assert seq.LAUNCHES["stereo_delay_swept_backward"] == 0
