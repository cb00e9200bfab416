"""flan_tpu_torch's Function extras (func/function.py: copy, periodize,
the seeded distributions with their camelCase names, the arithmetic) and
Pipe (func/pipe.py) against flan_tpu on the CPU: the same seeds give the
same draws, and a Pipe composes and applies to an Audio and a PV as the
JAX package's does. Inputs are made with numpy from a seed at 8 kHz.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu.func.function import Function as JFunction
from flan_tpu_torch import Pipe
from flan_tpu_torch.func.function import Function


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0


def _grid(n=257):
    return np.arange(n, dtype=np.float32) / np.float32(SR) * np.float32(40.0)


def _both(fn_t, fn_j, x):
    """A port Function on a tensor grid and a JAX one on the same grid."""
    got = fn_t(torch.from_numpy(x))
    want = fn_j(jnp.asarray(x))
    return np.asarray(got), np.array(want)


@pytest.mark.parametrize("period", [1.0, 0.37, 2.5])
def test_periodize_matches_jax(period):
    """f(t mod period) with the modulo taking the period's sign (jnp.mod),
    on a grid that crosses several periods: the same bits."""
    x = _grid() - np.float32(3.0)
    got, want = _both(Function(lambda t: t * t).periodize(period),
                      JFunction(lambda t: t * t).periodize(period), x)
    np.testing.assert_array_equal(got, want)
    assert Function(2.5).periodize(period).constant_value == 2.5


@pytest.mark.parametrize("name", ["uniform_distribution",
                                  "uniformDistribution"])
@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_distribution_draws_jax_values(name, seed):
    """The host draw from np.random.default_rng(seed): constant bounds,
    callable bounds and two calls in a row (the generator advances) give
    JAX's float32 values; a tensor grid gets a float32 tensor."""
    x = _grid()
    lo_t, hi_t = (lambda t: -1.0 - t), 2.0
    lo_j, hi_j = (lambda t: -1.0 - t), 2.0
    ft = getattr(Function, name)(lo_t, hi_t, seed=seed)
    fj = getattr(JFunction, name)(lo_j, hi_j, seed=seed)
    for _ in range(2):
        got = ft(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.array(fj(x)))
    assert ft(0.5) == fj(0.5)


@pytest.mark.parametrize("name", ["normal_distribution",
                                  "normalDistribution"])
def test_normal_distribution_draws_jax_values(name):
    """Normal draws with the sigma <= 0 short-circuit to the mean, on a
    sigma that changes sign over the grid: JAX's values."""
    x = _grid()
    ft = getattr(Function, name)(lambda t: 3.0 + t, lambda t: t - 2.0,
                                 seed=11)
    fj = getattr(JFunction, name)(lambda t: 3.0 + t, lambda t: t - 2.0,
                                  seed=11)
    got, want = ft(torch.from_numpy(x)).numpy(), np.array(fj(x))
    np.testing.assert_array_equal(got, want)
    neg = x - np.float32(2.0) <= 0
    np.testing.assert_array_equal(got[neg], (np.float32(3.0) + x)[neg])
    assert ft(0.25) == fj(0.25)


def test_distribution_sampled_through_a_pv_grid():
    """A seeded draw sampled over a PV's frame grid (Function.sample):
    the port's tensor equals JAX's array."""
    ft = Function.uniform_distribution(0.5, 1.5, seed=3)
    fj = JFunction.uniform_distribution(0.5, 1.5, seed=3)
    got = ft.sample(0, 50, 1.0 / 125.0)
    want = np.array(fj.sample(0, 50, 1.0 / 125.0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["mul", "add", "neg", "copy", "chain"])
def test_arithmetic_matches_jax(op):
    """__mul__, __add__, __neg__ and copy on callables and constants: the
    same bits; two constants fold to a constant."""
    x = _grid()
    f_t, g_t = Function(lambda t: 2.0 * t + 1.0), Function(0.75)
    f_j, g_j = JFunction(lambda t: 2.0 * t + 1.0), JFunction(0.75)
    make = {"mul": lambda f, g: f * g, "add": lambda f, g: f + g,
            "neg": lambda f, g: -f, "copy": lambda f, g: f.copy(),
            "chain": lambda f, g: -(f * f + g) * 3.0}[op]
    got, want = _both(make(f_t, g_t), make(f_j, g_j), x)
    np.testing.assert_array_equal(got, want)
    folded = make(Function(1.5), Function(-0.25))
    assert folded.is_constant
    assert folded.constant_value == make(JFunction(1.5),
                                         JFunction(-0.25)).constant_value


def _audio_pair(seed=0):
    x = (np.random.default_rng(seed).standard_normal((2, 2000)) * 0.3
         ).astype(np.float32)
    return (flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
            flan_tpu.Audio.create_from_array(x, SR))


def test_pipe_composes_and_applies_to_audio():
    """Pipe(f) >> g >> Pipe(h) runs f, g, h in order; `audio >> pipe`
    applies it; `callable >> pipe` prepends; both packages agree."""
    ta, ja = _audio_pair()
    t_pipe = (Pipe(lambda a: a.set_volume(0.5)) >> (lambda a: a.reverse())
              >> Pipe(lambda a: a.fade(0.01, 0.02)))
    j_pipe = (flan_tpu.Pipe(lambda a: a.set_volume(0.5))
              >> (lambda a: a.reverse())
              >> flan_tpu.Pipe(lambda a: a.fade(0.01, 0.02)))
    assert len(t_pipe.stages) == 3
    got = (ta >> t_pipe).to_numpy()
    want = np.array((ja >> j_pipe).data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(t_pipe(ta).to_numpy(), got)
    pre = (lambda a: a.set_volume(2.0)) >> t_pipe
    assert isinstance(pre, Pipe) and len(pre.stages) == 4
    np.testing.assert_allclose((ta >> pre).to_numpy(),
                               np.array((ja >> ((lambda a: a.set_volume(
                                   2.0)) >> j_pipe)).data),
                               rtol=0, atol=2e-7)


def test_pipe_applies_to_a_pv():
    """`pv >> pipe` on the port's PV (it has .mag): a stretch then a
    desample, against the JAX package's PV and Pipe."""
    ta, ja = _audio_pair(1)
    tp, jp = (a.convert_to_PV(256, 64, 256) for a in (ta, ja))
    steps = (lambda p: p.stretch(2.0), lambda p: p.desample(0.5))
    got = tp >> Pipe(*steps)
    want = jp >> flan_tpu.Pipe(*steps)
    assert isinstance(got, flan_tpu_torch.PV)
    gm, gf = got.to_numpy()
    np.testing.assert_allclose(gm, np.array(want.mag), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gf, np.array(want.freq), rtol=1e-6,
                               atol=1e-3)
