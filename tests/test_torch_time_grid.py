"""flan_tpu_torch's float32 time grids past 2^24 elements against
flan_tpu's on the CPU (ROADMAP C.18): core.types.float_iota against
jnp.arange(..., dtype=float32) and Function.sample / sample_device on a
grid of 600 s at 48 kHz plus one frame against the JAX package's. torch's
float32 arange steps by repeated adds and lands off the integers' rounding
past 2^24 (3,599,992 of 28,800,001 points, by +-2); every port grid whose
length follows the data goes through float_iota. All exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flan_tpu.func.function import Function as JFunction
from flan_tpu_torch.core.types import float_iota
from flan_tpu_torch.func.function import Function

LONG = 28_800_001           # 600 s at 48 kHz, plus one frame
SHORT = (1 << 24) + 1_000


@pytest.mark.parametrize("n", [SHORT, LONG])
@pytest.mark.parametrize("start", [0, 5])
def test_float_iota_is_jax_arange(n, start):
    want = np.array(jnp.arange(start, start + n, dtype=jnp.float32))
    got = float_iota(start, start + n).numpy()
    assert np.array_equal(got, want)


def test_float_iota_of_a_count_starts_at_zero():
    assert torch.equal(float_iota(4), torch.tensor([0.0, 1.0, 2.0, 3.0]))
    assert float_iota(3, device="cpu").dtype == torch.float32


def test_function_sample_on_600_s_is_jaxs():
    """Function(lambda t: t).sample(0, 28,800,001, 1 / 48000): each time
    the float32 frame times the float32 period, as flan_tpu's."""
    want = np.array(JFunction(lambda t: t).sample(0, LONG, 1 / 48000))
    got = Function(lambda t: t).sample(0, LONG, 1 / 48000,
                                       device="cpu").numpy()
    assert np.array_equal(got, want)


def test_sample_device_is_jaxs():
    """sample_device's grid arange(count) * period, past 2^24 samples, and
    a constant's fill."""
    want = np.array(JFunction(lambda t: t).sample_device(SHORT, 1 / 768000))
    got = Function(lambda t: t).sample_device(SHORT, 1 / 768000,
                                              "cpu").numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(Function(2.5).sample_device(7, 0.1, "cpu").numpy(),
                          np.array(JFunction(2.5).sample_device(7, 0.1)))
