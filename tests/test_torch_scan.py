"""flan_tpu_torch's scans (ops/scan.py, the plain versions of the scan
kernels) and the T3 probe against flan_tpu on the CPU.

The plain scans are held to flan_tpu/ops/scan.py's functions of the same
name, the linear one also to T1/T2 (tools/pallas_scan_experiment.py) in
Pallas interpret mode, and its backward to jax.grad of T1/T2; the plain
probe to T3 (tools/probe_pallas_ops.py) in interpret mode.
tests/test_torch_cuda.py holds the CUDA kernels to the plain versions on
the card. Inputs are made with numpy from a seed; every tolerance names
the reading it was set from (CPU).
"""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flan_tpu.ops import scan as jax_scan
from flan_tpu_torch.ops import probe_kernels, scan, scan_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(a):
    return np.array(a)


def _planes(n, ch=2, seed=0):
    """Decay factors spread from 0.5 to 0.99999, inputs and maxima."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99999, (ch, n)).astype(np.float32)
    b = rng.standard_normal((ch, n)).astype(np.float32)
    m = rng.standard_normal((1, n)).astype(np.float32)
    A = rng.uniform(-0.6, 0.6, (ch, n, 2, 2)).astype(np.float32)
    bb = rng.standard_normal((ch, n, 2)).astype(np.float32)
    return a, b, m, A, bb


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1.0), err


# the plain scans transcribe the JAX tiled scan: 0.0 difference read at
# every length here (CPU), so the bound is a few float32 ulps
TOL_EXACT = 1e-6
LENGTHS = [1, 100, 4097, 9001]


@pytest.mark.parametrize("n", LENGTHS)
def test_linear_recurrence_matches_flan_tpu(n):
    a, b, *_ = _planes(n)
    y0 = np.float32([[0.3], [-0.2]])
    want = _np(jax_scan.linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                          y0=jnp.asarray(y0)))
    got = scan.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                 y0=torch.from_numpy(y0))
    _close(got, want, TOL_EXACT)


@pytest.mark.parametrize("n", LENGTHS)
def test_linear_scanned_maps_match_flan_tpu(n):
    a, b, *_ = _planes(n, seed=1)
    want = jax_scan.linear_scanned_maps(jnp.asarray(a[:1]), jnp.asarray(b))
    got = scan.linear_scanned_maps(torch.from_numpy(a[:1]),
                                   torch.from_numpy(b))
    for g, w in zip(got, want):
        _close(g, _np(w), TOL_EXACT)


@pytest.mark.parametrize("n", LENGTHS)
def test_max_affine_recurrence_matches_flan_tpu(n):
    a, b, m, *_ = _planes(n, seed=2)
    want = _np(jax_scan.max_affine_recurrence(
        jnp.asarray(m), jnp.asarray(a), jnp.asarray(b), y0=0.1))
    got = scan.max_affine_recurrence(torch.from_numpy(m), torch.from_numpy(a),
                                     torch.from_numpy(b), y0=0.1)
    _close(got, want, TOL_EXACT)


@pytest.mark.parametrize("n", LENGTHS)
def test_matrix_affine_recurrence_matches_flan_tpu(n):
    *_, A, bb = _planes(n, seed=3)
    y0 = np.float32([[0.1, -0.2], [0.3, 0.4]])
    want = _np(jax_scan.matrix_affine_recurrence(
        jnp.asarray(A), jnp.asarray(bb), jnp.asarray(y0)))
    got = scan.matrix_affine_recurrence(
        torch.from_numpy(A), torch.from_numpy(bb), torch.from_numpy(y0))
    _close(got, want, TOL_EXACT)


def test_scan_along_a_middle_axis_matches_flan_tpu():
    """The comb's layout: chains along axis 1 of [C, blocks, t]."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 0.99, (2, 700, 7)).astype(np.float32)
    b = rng.standard_normal((2, 700, 7)).astype(np.float32)
    want = _np(jax_scan.linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                          axis=1))
    got = scan.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                 axis=1)
    _close(got, want, TOL_EXACT)


@pytest.mark.parametrize("n", [100, 5000])
def test_float64_plain_scan_is_sequential_recurrence(n):
    """The float64 plain version, the yardstick of the card checks, against
    a float64 loop: 1e-12 of the peak (2.1e-16 read, CPU)."""
    a, b, *_ = _planes(n, ch=1, seed=5)
    a, b = a.astype(np.float64)[0], b.astype(np.float64)[0]
    y, want = 0.25, np.empty(n)
    for i in range(n):
        y = a[i] * y + b[i]
        want[i] = y
    got = scan_kernels.linear_ref(torch.from_numpy(a), torch.from_numpy(b),
                                  0.25)
    _close(got, want, 1e-12)


@pytest.fixture(scope="module")
def pallas_scan():
    return _load_tool("pallas_scan_experiment")


@pytest.mark.parametrize("n", [1000, 1024 * 3 + 17, 1024 * 300 + 5])
def test_linear_recurrence_matches_t1_t2_interpret(pallas_scan, n):
    """Against T1/T2 in Pallas interpret mode at tests/test_pallas_scan.py's
    lengths and tolerance (rtol/atol 2e-4)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.9, 0.9999, (2, n)).astype(np.float32)
    b = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    y0 = np.float32([0.3, -0.2])
    want = _np(pallas_scan.linear_recurrence_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(y0)))
    got = scan.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                 y0=torch.from_numpy(y0)[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_linear_gradient_matches_t1_t2_grad(pallas_scan):
    """LinearRecurrence's backward (the reversed recurrence) against
    jax.grad of T1/T2's custom_vjp, at tests/test_pallas_scan.py's 1e-3."""
    rng = np.random.default_rng(1)
    n = 4096
    a = rng.uniform(0.9, 0.999, (1, n)).astype(np.float32)
    b = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
    y0 = np.float32([0.1])

    def loss(a_, b_, y0_):
        y = pallas_scan.linear_recurrence_pallas(a_, b_, y0_)
        return jnp.sum(y * y)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(y0))
    ta, tb, ty0 = (torch.from_numpy(v).requires_grad_() for v in (a, b, y0))
    y = scan.linear_recurrence(ta, tb, y0=ty0[:, None])
    got = torch.autograd.grad((y * y).sum(), (ta, tb, ty0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-3, atol=1e-3)


def test_linear_gradient_with_shared_coefficients():
    """A coefficient row shared by the channels gets the sum of their
    gradients: the custom backward against autograd through the plain
    scan, 1e-5 of the peak (1.6e-7 read, CPU)."""
    rng = np.random.default_rng(2)
    a0 = rng.uniform(0.8, 0.99, (1, 600)).astype(np.float32)
    b0 = rng.standard_normal((3, 600)).astype(np.float32)
    grads = []
    for custom in (True, False):
        a = torch.from_numpy(a0).requires_grad_()
        b = torch.from_numpy(b0).requires_grad_()
        y = (scan.linear_recurrence(a, b) if custom
             else scan_kernels.linear_ref(a, b, 0.0))
        grads.append(torch.autograd.grad((y * y).sum(), (a, b)))
    for g, w in zip(*grads):
        _close(g, w, 1e-5)


def test_matrix_scan_of_higher_order_waits():
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        scan.matrix_affine_recurrence(torch.zeros((1, 8, 3, 3)),
                                      torch.zeros((1, 8, 3)),
                                      torch.zeros((1, 3)))


def test_start_state_must_not_vary_along_the_scan():
    with pytest.raises(ValueError, match="one start state per row"):
        scan.linear_recurrence(torch.ones((2, 8)), torch.ones((2, 8)),
                               y0=torch.ones((2, 8)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers check their inputs before the library is built, so a
    CPU tensor raises here, where there is no nvcc."""
    x = torch.ones((1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernels.scan_linear(x, x, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernels.scan_affine2x2(x, x, x, x, x, x, 0.0, 0.0)
    with pytest.raises(ValueError):
        probe_kernels.probe_cuda(torch.ones((4, 128, 512)),
                                 torch.ones((128, 512)))


def test_probe_plain_matches_t3_interpret():
    """The plain probe against T3 run by pl.pallas_call in interpret mode
    with main's specs and seeds. Outputs are compared modulo 1 (floor and
    mod 1 jump where rounding crosses an integer): 9.5e-6 read (CPU),
    bound 1e-4."""
    tool = _load_tool("probe_pallas_ops")
    f, b = tool.F, tool.B
    x, w = probe_kernels.probe_inputs()
    want = _np(pl.pallas_call(
        tool.kernel, grid=(4,),
        in_specs=[pl.BlockSpec((1, f, b), lambda t: (t, 0, 0),
                               memory_space=tool.pltpu.VMEM),
                  pl.BlockSpec((f, b), lambda t: (0, 0),
                               memory_space=tool.pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, f, b), lambda t: (t, 0, 0),
                               memory_space=tool.pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((4, f, b), jnp.float32),
        scratch_shapes=[tool.pltpu.VMEM((1, b), jnp.float32)],
        interpret=True)(jnp.asarray(x), jnp.asarray(w)))
    got = probe_kernels.probe(torch.from_numpy(x), torch.from_numpy(w))
    assert probe_kernels.LAUNCHES["probe"] == 0
    d = got.numpy().astype(np.float64) - want
    assert np.abs(d - np.round(d)).max() < 1e-4
    # no carried row jumped: every step's last row agrees outright
    assert np.abs(d[:, -1]).max() < 1e-4


def test_port_modules_import_without_jax():
    code = ("import flan_tpu_torch, flan_tpu_torch.audio.filters, "
            "flan_tpu_torch.audio.volume, flan_tpu_torch.ops.scan, "
            "flan_tpu_torch.ops.probe_kernels, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'flan_tpu' or m.startswith('flan_tpu.') "
            "for m in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
