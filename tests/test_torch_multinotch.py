"""flan_tpu_torch's multinotch filters, their saturator variant and the swept
comb (audio/filters.py, ops/sequential_kernels.py) against flan_tpu on the
CPU, and the multinotch filters against the compiled reference's goldens
(tests/test_algo_golden.py:293-301).

The multinotch filters run on the k x k scan (k = order for the 1-pole
cascade, 2 order for the 2-pole): at 512 frames and, with swept
parameters, at 5000 (two blocks of the tiled scan) on the scan path, and
at 20000 frames with constant parameters on the FIR path (its impulse
probe on the k x k scan). The saturator variants and the swept comb run in time
order: their plain loops are held to the JAX package's lax.scan. Inputs are
made with numpy from a seed; every tolerance names the reading it was set
from (CPU).
"""
import os

import numpy as np
import pytest
import torch

import flan_tpu
import flan_tpu_torch
from flan_tpu_torch.ops import scan_kernels, sequential_kernels


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

SR = 8000.0
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _signal(n, ch=2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 1500 * t)
         + 0.1 * rng.standard_normal(n))
    return np.stack([x, -0.7 * np.roll(x, 17)])[:ch].astype(np.float32)


def _rel_err(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(x, method, *args):
    want = np.array(getattr(flan_tpu.Audio.create_from_array(x, SR),
                            method)(*args).data)
    got = getattr(flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
                  method)(*args)
    assert got.device.type == "cpu"
    return got.to_numpy(), want


# the multinotch filters against flan_tpu: the k x k scan transcribes the
# JAX tiled scan: 0.0 read at 512 frames where the parameters are
# constant, up to 2.4e-7 with swept ones (5000 frames) and 9.0e-7 on the
# FIR path (20000 frames; CPU); bound 1e-5
TOL = 1e-5

MULTINOTCH = {
    "1p_o2_const": ("filter_1pole_multinotch", (2, 800.0, 0.3)),
    "1p_o4_swept": ("filter_1pole_multinotch",
                    (4, lambda t: 200.0 + 2000.0 * t, 0.5)),
    "1p_o3_inv_swept_feedback": ("filter_1pole_multinotch",
                                 (3, 600.0, lambda t: 0.2 + 0.3 * t, True,
                                  0.7)),
    "1p_o1": ("filter_1pole_multinotch", (1, 1200.0, -0.4, False, 0.4)),
    "2p_o2_const": ("filter_2pole_multinotch", (2, 800.0, 0.35, 0.3)),
    "2p_o3_swept": ("filter_2pole_multinotch",
                    (3, lambda t: 200.0 + 2000.0 * t, 0.3, 0.5)),
    "2p_o1_inv_swept_damping": ("filter_2pole_multinotch",
                                (1, 900.0, lambda t: 0.5 + 0.2 * t, 0.4, True,
                                 0.3)),
}


@pytest.mark.parametrize("case,n", [
    (case, n) for case in sorted(MULTINOTCH)
    for n in (512, 5000 if "swept" in case else 20000)])
def test_multinotch_matches_flan_tpu(case, n):
    name, args = MULTINOTCH[case]
    scan_kernels.reset_launch_counts()
    assert _rel_err(*_both(_signal(n), name, *args)) < TOL
    assert scan_kernels.LAUNCHES["scan_affine_kxk"] == 0


# the saturator variants (Newton on tanh, then the cascade) against the
# JAX package's lax.scan at 0.05 s: up to 4.5e-7 (1-pole) and 5.8e-7
# (2-pole) of the peak read (CPU; the two tanh differ by an ulp); bound
# 1e-5
SATURATOR = {
    "1p_o2": ("filter_1pole_multinotch",
              (2, lambda t: 300.0 + 3000.0 * t, 0.6, False, 0.5, True)),
    "1p_o3_inv": ("filter_1pole_multinotch",
                  (3, 700.0, lambda t: 0.4 + 2.0 * t, True, 0.3, True)),
    "2p_o2_inv": ("filter_2pole_multinotch",
                  (2, lambda t: 300.0 + 3000.0 * t, 0.4, 0.7, True, 0.5,
                   True)),
    "2p_o1": ("filter_2pole_multinotch",
              (1, 1000.0, lambda t: 0.2 + 2.0 * t, 0.9, False, 0.6, True)),
}


@pytest.mark.parametrize("case", sorted(SATURATOR))
def test_saturator_matches_flan_tpu(case):
    name, args = SATURATOR[case]
    assert _rel_err(*_both(_signal(int(0.05 * SR)), name, *args)) < TOL
    assert sequential_kernels.LAUNCHES == dict.fromkeys(
        sequential_kernels.LAUNCHES, 0)


# the swept comb against the JAX package's ring-buffer scan: 0.0 read for
# the rising sweep, up to 2.0e-7 of the peak for the others (CPU); bound
# 1e-6
COMB = {
    "rising": (lambda t: 200.0 + 2000.0 * t, 0.5),
    "falling_inv": (lambda t: 3000.0 - 2000.0 * t, lambda t: 0.3 + 0.3 * t,
                    0.3, True),
    # a cutoff under 1 Hz clamps to 1 Hz: a delay of sr / 2 and a ring that
    # fills before it is read
    "clamped_long_delay": (lambda t: 0.5 + 3000.0 * t * t, 0.7, 0.6),
}


@pytest.mark.parametrize("n", [512, 6000])
@pytest.mark.parametrize("case", sorted(COMB))
def test_swept_comb_matches_flan_tpu(case, n):
    assert _rel_err(*_both(_signal(n), "filter_comb", *COMB[case])) < 1e-6


def _loop_comb(x, d, k, a, f):
    """The swept comb as a sample-by-sample loop in float64."""
    u = np.zeros_like(x, dtype=np.float64)
    y = np.zeros_like(u)
    for t in range(x.shape[1]):
        ud = u[:, t - d[t]] if t - d[t] >= 0 else 0.0
        u[:, t] = x[:, t] + k[t] * f * ud
        y[:, t] = a[t] * u[:, t] + (1 - a[t]) * f * ud
    return y


def test_comb_plain_takes_its_rounds_without_reading_ahead():
    """comb_swept_ref's rounds of as many steps as the least delay ahead
    against a sample-by-sample loop, on delays that jump from 1 to 400:
    1e-6 of the peak (rounding of float32 against float64)."""
    rng = np.random.default_rng(4)
    n = 3000
    x = rng.standard_normal((2, n)).astype(np.float32)
    d = rng.integers(1, 400, n).astype(np.int32)
    d[::7] = 1
    k = rng.uniform(-0.7, 0.7, n).astype(np.float32)
    a = rng.uniform(0.0, 1.0, n).astype(np.float32)
    got = sequential_kernels.comb_swept_ref(
        *(torch.from_numpy(v) for v in (x, d, k, a)), -1.0).numpy()
    want = _loop_comb(x, d, k, a, -1.0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_integer_powers_follow_jax():
    """ipow multiplies as jax.lax.integer_pow does: the JAX package's
    `x ** e` and jnp.power(x, e) give the same bits."""
    import jax.numpy as jnp
    x = np.random.default_rng(5).uniform(-1.5, 1.5, 1000).astype(np.float32)
    for e in range(0, 9):
        want = np.array(jnp.asarray(x) ** e)
        got = sequential_kernels.ipow(torch.from_numpy(x), e).numpy()
        assert np.array_equal(got, want), e


def test_sequential_wrappers_refuse_cpu_tensors():
    x = torch.ones((1, 16))
    p = torch.ones(16)
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernels.saturator_cuda(x, (p,) * 5, 1.0, 2, False)
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernels.comb_swept_cuda(
            x, torch.ones(16, dtype=torch.int32), p, p, 1.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernels.saturator_backward_cuda(
            x, x, (p,) * 5, x, torch.ones((1, 2, 16)), 1.0, 2, False)
    with pytest.raises(ValueError, match="CUDA"):
        sequential_kernels.comb_swept_backward_cuda(
            x, torch.ones(16, dtype=torch.int32), p, p, 1.0, 1)


def _fixture(name):
    dims = tuple(int(v) for v in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return np.fromfile(os.path.join(FIXDIR, name + ".f32"),
                       dtype="<f4").reshape(dims)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    err = ((ref - got) ** 2).mean()
    return 10.0 * np.log10(max((ref ** 2).mean(), 1e-300) / max(err, 1e-300))


@pytest.mark.parametrize("golden,name,args", [
    ("filt_1p_mn", "filter_1pole_multinotch", (2, 800.0, 0.3, False, 0.5,
                                               False)),
    ("filt_2p_mn", "filter_2pole_multinotch", (2, 800.0, 0.35, 0.3, False,
                                               0.5, False))])
def test_multinotch_golden(golden, name, args):
    """tests/test_algo_golden.py's calls and 60 dB floor."""
    x = _fixture("filt_sig")
    out = getattr(flan_tpu_torch.Audio.create_from_array(x, SR, device="cpu"),
                  name)(*args).to_numpy()
    ref = _fixture(golden)
    assert out.shape == ref.shape
    assert _snr_db(ref, out) >= 60.0
