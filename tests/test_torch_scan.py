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
import math
import os
import re
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


# One intra-op thread: on an 8-core x86 host torch 2.13's CPU kernels pay
# ~10 ms to wake their worker pool for a call of a few thousand elements
# (torch.round of 16,384 floats: 14 ms on 8 threads, 6 us on one), which
# the plain versions' many small calls multiply.
torch.set_num_threads(1)

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
    """The k x k scan no longer waits: k = 3 runs on the CPU, through the
    plain k x k version, and gives what k = 3 leaves of JAX's scan give
    (0.0 read, CPU)."""
    rng = np.random.default_rng(6)
    A = rng.uniform(-0.3, 0.3, (1, 8, 3, 3)).astype(np.float32)
    b = rng.standard_normal((1, 8, 3)).astype(np.float32)
    y0 = rng.standard_normal((1, 3)).astype(np.float32)
    got = scan.matrix_affine_recurrence(*(torch.from_numpy(v)
                                          for v in (A, b, y0)))
    want = _np(jax_scan.matrix_affine_recurrence(
        *(jnp.asarray(v) for v in (A, b, y0))))
    _close(got, want, TOL_EXACT)
    assert scan_kernels.LAUNCHES["scan_affine_kxk"] == 0


@pytest.mark.parametrize("k", [1, 3, 4, 6])
@pytest.mark.parametrize("n", [1, 100, 4097])
def test_kxk_recurrence_matches_flan_tpu(k, n):
    """matrix_affine_recurrence for k x k maps against the JAX package's
    (its tiled scan over k*k + k leaves, transcribed): 0.0 read at every k
    and length here (CPU), bound a few float32 ulps."""
    rng = np.random.default_rng(10 * k + n % 7)
    A = (rng.uniform(-1, 1, (2, n, k, k)) * 0.95 / k).astype(np.float32)
    b = rng.standard_normal((2, n, k)).astype(np.float32)
    y0 = rng.standard_normal((2, k)).astype(np.float32)
    want = _np(jax_scan.matrix_affine_recurrence(
        *(jnp.asarray(v) for v in (A, b, y0))))
    got = scan.matrix_affine_recurrence(*(torch.from_numpy(v)
                                          for v in (A, b, y0)))
    _close(got, want, TOL_EXACT)


def test_kxk_recurrence_shares_one_map_among_rows():
    """An A without the rows' leading axis is one map for every row (the
    multinotch's layout, [k, k, N] against b [C, k, N]): the result equals
    the run with A copied to every row, and the float64 plain version
    equals a sample-by-sample loop (1e-12 of the peak; 4.4e-16 read,
    CPU)."""
    rng = np.random.default_rng(12)
    k, n = 3, 500
    A = rng.uniform(-0.3, 0.3, (k, k, n))
    b = rng.standard_normal((2, k, n))
    shared = scan.affine_kxk_recurrence(torch.from_numpy(A),
                                        torch.from_numpy(b), 0.0)
    copied = scan.affine_kxk_recurrence(
        torch.from_numpy(np.broadcast_to(A, (2, k, k, n)).copy()),
        torch.from_numpy(b), 0.0)
    assert torch.equal(shared, copied)
    want = np.zeros((2, k, n))
    s = np.zeros((2, k))
    for t in range(n):
        s = np.einsum("ij,cj->ci", A[:, :, t], s) + b[:, :, t]
        want[:, :, t] = s
    _close(shared, want, 1e-12)


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
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernels.scan_affine_kxk(torch.ones((1, 9, 16)),
                                     torch.ones((1, 3, 16)),
                                     torch.ones((1, 3)))
    with pytest.raises(ValueError, match="do not fit"):
        scan_kernels.scan_affine_kxk(torch.ones((1, 4, 16)),
                                     torch.ones((1, 3, 16)),
                                     torch.ones((1, 3)))
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
            "flan_tpu_torch.ops.probe_kernels, "
            "flan_tpu_torch.ops.sequential_kernels, "
            "flan_tpu_torch.ops.resample, flan_tpu_torch.ops.fft_conv, "
            "flan_tpu_torch.audio.combination, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'flan_tpu' or m.startswith('flan_tpu.') "
            "for m in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr


# ------------------------- the kernel's fixed order of composition, emulated

THREADS = 256           # threads per block of the kernel (csrc: kThreads)
WINDOW_TILES = THREADS  # tiles per look-back window (csrc: kWindow)


def _apply_linear(m, s):
    return (m[0] * s[0] + m[1],)


def _apply_max_affine(m, s):
    return (torch.maximum(m[0], m[1] * s[0] + m[2]),)


def _apply_affine2x2(m, s):
    return (m[0] * s[0] + m[1] * s[1] + m[4],
            m[2] * s[0] + m[3] * s[1] + m[5])


_ORDER = {
    "scan_linear": (scan_kernels.combine_linear, _apply_linear,
                    scan_kernels.LINEAR_IDENTITY),
    "scan_max_affine": (scan_kernels.combine_max_affine, _apply_max_affine,
                        scan_kernels.MAX_AFFINE_IDENTITY),
    "scan_affine2x2": (scan_kernels.combine_affine2x2, _apply_affine2x2,
                       scan_kernels.kxk_identity(2))}


def _shift(leaves, identity, d: int):
    """The leaves moved d places up the last axis, the identity map let in."""
    n = leaves[0].shape[-1]
    return tuple(torch.nn.functional.pad(x[..., :n - d], (d, 0), value=ident)
                 for x, ident in zip(leaves, identity))


def _tree_reduce(combine, leaves):
    """The ordered composition over the last axis (THREADS maps) as the
    kernel's block_reduce takes it: pairs at distance 1, 2, ... 16 within
    each run of 32, then the runs' totals in order."""
    v = tuple(x.reshape(x.shape[:-1] + (THREADS // 32, 32)) for x in leaves)
    while v[0].shape[-1] > 1:
        v = combine(tuple(x[..., 0::2] for x in v),
                    tuple(x[..., 1::2] for x in v))
    out = tuple(x[..., 0, 0] for x in v)
    for w in range(1, THREADS // 32):
        out = combine(out, tuple(x[..., w, 0] for x in v))
    return out


def scan_emulated(name: str, planes, y0s, tile: int):
    """PyTorch emulation of kernel `name`'s fixed order of composition
    (csrc/scan_kernels.cu), in the planes' dtype; the states as a tuple.
    planes broadcast to [..., N], y0s to [..., 1]; `tile` elements per tile,
    a multiple of THREADS (the kernel's are 4096, and 2048 for the 2x2 map).

    Within a tile each of THREADS threads composes its run of consecutive
    elements in order, a doubling scan over each warp's 32 lanes and the warp
    totals in order give every thread's exclusive prefix. Tile k = w W + r
    (W = WINDOW_TILES) starts from the state at the start of window w,
    advanced by the tree-ordered composition of the r tile totals before it
    in the window; a window's start state is the window before's, advanced
    by the tree over all W of its totals. Rounding differs from the kernel
    where nvcc contracts a product and a sum into an FMA."""
    combine, apply, identity = _ORDER[name]
    per, win = tile // THREADS, WINDOW_TILES
    shape = torch.broadcast_shapes(*(p.shape for p in planes))
    planes = tuple(torch.broadcast_to(p, shape) for p in planes)
    n = shape[-1]
    nt = -(-n // tile)
    nw = -(-nt // win)
    rows = math.prod(shape[:-1])

    def ident_like(x, shp):
        return tuple(torch.full(shp, v, dtype=x.dtype, device=x.device)
                     for v in identity)

    # [rows, tiles, threads, per], the ragged tile filled with the identity
    e = tuple(torch.nn.functional.pad(x.reshape(rows, n), (0, nt * tile - n),
                                      value=ident).reshape(rows, nt, THREADS,
                                                           per)
              for x, ident in zip(planes, identity))
    m = ident_like(e[0], (rows, nt, THREADS))
    for j in range(per):
        m = combine(m, tuple(x[..., j] for x in e))
    # the warps' doubling scans, then the warp totals in order
    inc = tuple(x.reshape(rows, nt, THREADS // 32, 32) for x in m)
    lane = torch.arange(32, device=inc[0].device)
    d = 1
    while d < 32:
        both = combine(_shift(inc, identity, d), inc)
        inc = tuple(torch.where(lane >= d, b, x) for b, x in zip(both, inc))
        d *= 2
    lane_ex = _shift(inc, identity, 1)
    pre = ident_like(e[0], (rows, nt))
    ex = []
    for w in range(THREADS // 32):
        ex.append(combine(tuple(x[..., None] for x in pre),
                          tuple(x[..., w, :] for x in lane_ex)))
        pre = combine(pre, tuple(x[..., w, 31] for x in inc))
    ex = tuple(torch.stack(parts, dim=2).reshape(rows, nt, THREADS)
               for parts in zip(*ex))
    # look-back: totals [rows, windows, W], the identity past the last tile
    totals = tuple(torch.nn.functional.pad(x, (0, nw * win - nt),
                                           value=ident).reshape(rows, nw, win)
                   for x, ident in zip(pre, identity))
    idx = torch.arange(win, device=inc[0].device)
    before = idx[None, :] < idx[:, None]            # [r, tile of the window]
    partial = _tree_reduce(combine, tuple(
        torch.where(before, x[..., None, :], torch.full_like(x[:1, :1, :1],
                                                             ident))
        for x, ident in zip(totals, identity)))     # [rows, windows, r]
    whole = _tree_reduce(combine, totals)           # [rows, windows]
    state = tuple(torch.broadcast_to(torch.as_tensor(
        v, dtype=e[0].dtype, device=e[0].device), shape[:-1] + (1,)).reshape(
            rows) for v in y0s)
    starts = []
    for w in range(nw):
        starts.append(apply(tuple(x[:, w] for x in partial),
                            tuple(v[:, None] for v in state)))
        state = apply(tuple(x[:, w] for x in whole), state)
    s = tuple(torch.stack(parts, dim=1).reshape(rows, nw * win)[:, :nt, None]
              for parts in zip(*starts))
    s = apply(ex, s)                                # [rows, tiles, threads]
    out = []
    for j in range(per):
        s = apply(tuple(x[..., j] for x in e), s)
        out.append(s)
    return tuple(torch.stack(parts, dim=-1).reshape(rows, nt * tile)[:, :n]
                 .reshape(shape) for parts in zip(*out))


# the k x k kernel's own sizes (csrc/scan_kernels.cu kxk_tiling, kKxKWindow,
# kKxKGroup): (steps a tile, steps a sub-run) by k, tiles a window of its
# carry, rows of one shared A a block; tests/test_torch_cuda.py holds the
# pairs to the library's
KXK_KERNEL_TILING = {3: (512, 32), 4: (512, 32), 8: (256, 16), 12: (128, 8),
                     16: (64, 8), 20: (32, 8), 34: (16, 8), 40: (8, 8)}
KXK_KERNEL_WINDOW, KXK_KERNEL_GROUP = 8, 4


def kxk_emulated(A, b, y0, tile: int, subrun: int,
                 window: int = KXK_KERNEL_WINDOW,
                 group_rows: int = KXK_KERNEL_GROUP):
    """PyTorch emulation of the k x k kernel's order (csrc/scan_kernels.cu
    scan_kxk_chunked) in the inputs' dtype: A [rows or 1, k*k, N], b [rows,
    k, N], y0 [rows, k]; returns y [rows, k, N]. `tile` steps a tile,
    `subrun` a sub-run (the kernel's: KXK_KERNEL_TILING[k]) and `window`
    tiles a window of the carry.

    Rows that share A go in groups of `group_rows`, a row alone where each
    has its own A. Within a tile, each sub-run's map (the A-product from
    the identity, each row's b-part from 0) is carried step by step in time
    order; the sub-runs' maps compose in order into their prefixes, the
    last the tile's total. Across tiles: a whole window's total is its
    tiles' totals folded in order, and the window totals applied in order
    to y0 give each window's start; a tile starts from its window's start
    with the totals of the tiles before it in the window applied in order
    (what every path of the kernel's look-back computes). Each sub-run
    then steps from its prefix applied to the tile's start state. Rounding
    differs from the kernel's: matmul sums in another order than its
    column-order FMAs."""
    rows, k, n = b.shape
    subs = tile // subrun
    nt = -(-n // tile)
    pad = nt * tile - n
    eye = torch.eye(k, dtype=b.dtype)
    ap = torch.cat([A, eye.reshape(1, k * k, 1).expand(A.shape[0], k * k,
                                                       pad)], dim=-1)
    am = ap.reshape(A.shape[0], k, k, nt, subs, subrun).permute(
        0, 3, 4, 5, 1, 2)                           # [ra, tiles, S, R, k, k]
    bm = torch.nn.functional.pad(b, (0, pad)).reshape(
        rows, k, nt, subs, subrun).permute(0, 2, 3, 4, 1)   # [rows, ..., k]
    shared = A.shape[0] == 1
    groups = ([list(range(r, min(r + group_rows, rows)))
               for r in range(0, rows, group_rows)] if shared
              else [[r] for r in range(rows)])
    out = torch.empty(rows, nt, subs, subrun, k, dtype=b.dtype)
    for grp in groups:
        a = am[0 if shared else grp[0]]
        g = len(grp)
        bb = bm[grp].permute(1, 2, 3, 4, 0)          # [tiles, S, R, k, g]
        # each sub-run's map (Phi | beta), [tiles, S, k, k + g]
        v = torch.cat([eye.expand(nt, subs, k, k),
                       torch.zeros(nt, subs, k, g, dtype=b.dtype)], dim=-1)
        for t in range(subrun):
            v = a[:, :, t] @ v
            v = torch.cat([v[..., :k], v[..., k:] + bb[:, :, t]], dim=-1)
        pre = [v[:, 0]]
        for s in range(1, subs):
            m, p = v[:, s], pre[-1]
            pre.append(torch.cat([m[..., :k] @ p[..., :k],
                                  m[..., :k] @ p[..., k:] + m[..., k:]],
                                 dim=-1))
        pre = torch.stack(pre, dim=1)
        # the carry: windows of tiles
        tot = pre[:, -1]
        x = y0[grp].T
        starts = []
        for w0 in range(0, nt, window):
            xt = x
            for t in range(w0, min(w0 + window, nt)):
                starts.append(xt)
                xt = tot[t, :, :k] @ xt + tot[t, :, k:]
            if w0 + window <= nt:
                acc = tot[w0]
                for t in range(w0 + 1, w0 + window):
                    acc = torch.cat([tot[t, :, :k] @ acc[:, :k],
                                     tot[t, :, :k] @ acc[:, k:]
                                     + tot[t, :, k:]], dim=-1)
                x = acc[:, :k] @ x + acc[:, k:]
        x0 = torch.stack(starts)[:, None]           # [tiles, 1, k, g]
        st = torch.cat([x0, pre[:, :-1, :, :k] @ x0 + pre[:, :-1, :, k:]],
                       dim=1)
        ys = []
        for t in range(subrun):
            st = a[:, :, t] @ st + bb[:, :, t]
            ys.append(st)
        out[grp] = torch.stack(ys, dim=2).permute(4, 0, 1, 2, 3)
    return out.permute(0, 4, 1, 2, 3).reshape(rows, k, nt * tile)[..., :n]


def _kxk3_emulated(planes, y0s, tile):
    """kxk_emulated on the order test's 12 planes and 3 start states, in
    sub-runs of 32 steps."""
    y = kxk_emulated(torch.stack(planes[:9], dim=1),
                     torch.stack(planes[9:], dim=1), torch.cat(y0s, dim=1),
                     tile, 32)
    return tuple(y[:, i] for i in range(3))


def _kxk3_ref(*args):
    """affine_kxk_ref on the emulation's 12 planes and 3 start states."""
    planes = torch.broadcast_tensors(*args[:12])
    y = scan_kernels.affine_kxk_ref(torch.stack(planes[:9], dim=1),
                                    torch.stack(planes[9:], dim=1),
                                    torch.cat(args[12:], dim=1))
    return tuple(y[:, i] for i in range(3))


_EMULATED = {
    "scan_affine_kxk3": (_kxk3_ref, 12, 3),
    "scan_linear": (scan_kernels.linear_ref, 2, 1),
    "scan_max_affine": (scan_kernels.max_affine_ref, 3, 1),
    "scan_affine2x2": (scan_kernels.affine2x2_ref, 6, 2)}


def _emulation_planes(name, ch, n, seed, shared):
    """Planes and start states as the filters and the compressor build them:
    decays spread from 0.5 to 0.99999, rotations of up to 0.2 rad; with
    `shared` the coefficient planes are one row for all channels."""
    rng = np.random.default_rng(seed)
    rows = 1 if shared else ch
    a = rng.uniform(0.5, 0.99999, (rows, n))
    if name == "scan_linear":
        planes = (a, rng.standard_normal((ch, n)))
    elif name == "scan_max_affine":
        m = rng.standard_normal((ch, n))
        planes = (m, a, (1.0 - a) * m)
    elif name == "scan_affine_kxk3":
        # a decay times a rotation in the (0, 1) plane and a decay on 2,
        # coupled weakly: the multinotch's maps are this close to the unit
        th = rng.uniform(0.0, 0.2, (rows, n))
        c = rng.uniform(-0.01, 0.01, (rows, n))
        planes = (a * np.cos(th), -a * np.sin(th), c, a * np.sin(th),
                  a * np.cos(th), c, c, c, a,
                  *rng.standard_normal((3, ch, n)))
    else:
        th = rng.uniform(0.0, 0.2, (rows, n))
        planes = (a * np.cos(th), -a * np.sin(th), a * np.sin(th),
                  a * np.cos(th), rng.standard_normal((ch, n)),
                  rng.standard_normal((ch, n)))
    y0 = rng.standard_normal((_EMULATED[name][2], ch, 1))
    return ([torch.from_numpy(np.asarray(p, np.float32)) for p in planes],
            [torch.from_numpy(v.astype(np.float32)) for v in y0])


def _stacked(y):
    return torch.stack(y) if isinstance(y, tuple) else y[None]


# lengths around a tile of 256 and around a look-back window of 256 such
# tiles (65536), then the kernel's own tiles (4096; 2048 for the 2x2 map)
# around their boundaries
_EMULATION_CASES = [(1, 1, 256), (2, 255, 256), (2, 256, 256), (3, 257, 256),
                    (2, 65535, 256), (1, 65536, 256), (2, 65537, 256),
                    (1, 2 * 65536 + 300, 256), (2, 4095, 4096), (1, 4097, 2048)]


# the k x k map's 12 planes cost the emulation 6x the 2 x 2's: it takes the
# cases up to a few tiles
@pytest.mark.parametrize("name,ch,n,tile", [
    (name, *case) for name in _EMULATED for case in _EMULATION_CASES
    if name != "scan_affine_kxk3" or case[1] < 65535])
def test_kernel_order_of_composition(name, ch, n, tile):
    """The scan kernel's order of composition (runs of a thread, a warp's
    doubling scan, the warps in order; then, across tiles, a fixed tree
    over the tiles of a look-back window and a chain over the windows;
    for the k x k map, k = 3 here, its own kernel's order: kxk_emulated,
    in sub-runs of 32 steps), emulated in PyTorch, against the plain
    version: as close to the float64
    plain run as the float32 plain run is, to a factor of 2 and 1e-6 of the
    peak (what the card is held to; 1.7e-7 against 1.3e-7 of the peak read
    for the linear map at 65541 elements), and equal to rounding in
    float64."""
    plain, nplanes, _ = _EMULATED[name]
    planes, y0 = _emulation_planes(name, ch, n, seed=n % 97,
                                   shared=ch % 2 == 0)

    def emulated(ps, ys):
        if name == "scan_affine_kxk3":
            return torch.stack(_kxk3_emulated(ps, ys, tile))
        return torch.stack(scan_emulated(name, ps, ys, tile=tile))
    emu = emulated(planes, y0)
    p32 = _stacked(plain(*planes, *y0))
    p64 = _stacked(plain(*(t.double() for t in planes + y0)))
    emu64 = emulated([t.double() for t in planes], [t.double() for t in y0])
    assert emu.shape == p32.shape and emu.dtype == torch.float32
    peak = float(p64.abs().max())
    assert float((emu64 - p64).abs().max()) <= 1e-12 * max(peak, 1.0)
    err_emu = float((emu.double() - p64).abs().max())
    err_plain = float((p32.double() - p64).abs().max())
    assert err_emu <= 2.0 * err_plain + 1e-6 * peak


def test_kernel_order_is_a_function_of_the_tile_alone():
    """A row's states do not depend on what else is scanned with it: the
    same row alone, beside another row and with a longer tail gives the
    same bits up to its own length (the kernel composes by tile index,
    never by which blocks were done)."""
    planes, y0 = _emulation_planes("scan_linear", 2, 70000, seed=5,
                                   shared=False)
    both = scan_emulated("scan_linear", planes, y0, tile=256)[0]
    alone = scan_emulated(
        "scan_linear", [p[:1] for p in planes], [v[:1] for v in y0],
        tile=256)[0]
    assert torch.equal(both[:1], alone)
    shorter = scan_emulated(
        "scan_linear", [p[:, :66000] for p in planes], y0, tile=256)[0]
    assert torch.equal(both[:, :65536], shorter[:, :65536])


def test_scan_constants_match_the_emulation():
    """The emulation's threads per block, window and tile sizes are the
    kernel source's: the linear and max-affine maps' runs, then the 2 x 2
    map's (the k x k map's k = 2 instantiation)."""
    from flan_tpu_torch.ops import build
    cu = (build.CSRC / "scan_kernels.cu").read_text()
    assert f"constexpr int kThreads = {THREADS};" in cu
    assert "constexpr int kWindow = kThreads;" in cu
    assert "static constexpr int kLen = kThreads * Op::kPerThread;" in cu
    per_thread = [int(v) for v in re.findall(r"kPerThread = (\d+),", cu)]
    assert [THREADS * v for v in per_thread] == [4096, 4096, 2048]
    assert {t for _, _, t in _EMULATION_CASES} >= {4096, 2048}


# ------------------------- the k x k kernel's order (scan_kxk_chunked)

def _kxk_case(k, rows, n, shared, seed):
    """k x k maps near the multinotch's (a decay of 0.5 to 0.99999 on the
    diagonal, weak coupling off it), inputs and start states, float32: A
    [1 or rows, k*k, N], b [rows, k, N], y0 [rows, k]."""
    rng = np.random.default_rng(seed)
    ra = 1 if shared else rows
    A = rng.uniform(-1, 1, (ra, k, k, n)) * (0.3 / k)
    A[:, np.arange(k), np.arange(k)] = rng.uniform(0.5, 0.99999, (ra, k, n))
    b = rng.standard_normal((rows, k, n))
    y0 = rng.standard_normal((rows, k))
    return [torch.from_numpy(v.astype(np.float32))
            for v in (A.reshape(ra, k * k, n), b, y0)]


def _kxk_float64(A, b, y0):
    """The recurrence sample by sample in float64: the yardstick."""
    rows, k, n = b.shape
    a = np.broadcast_to(A.double().numpy().reshape(-1, k, k, n),
                        (rows, k, k, n))
    bb, s = b.double().numpy(), y0.double().numpy()
    out = np.empty((rows, k, n))
    for t in range(n):
        s = np.einsum("rij,rj->ri", a[..., t], s) + bb[..., t]
        out[..., t] = s
    return torch.from_numpy(out)


# the emulation's own small tile, sub-run and window, so that every
# boundary is reached at a few hundred steps: lengths of one step, around
# a sub-run, around a tile, and around one look-back window of tiles
KXK_EMU_TILE, KXK_EMU_SUBRUN, KXK_EMU_WINDOW = 16, 4, 4
KXK_EMU_LENGTHS = [1, KXK_EMU_SUBRUN - 1, KXK_EMU_SUBRUN + 1,
                   KXK_EMU_TILE - 1, KXK_EMU_TILE + 1,
                   KXK_EMU_WINDOW * KXK_EMU_TILE - 1,
                   KXK_EMU_WINDOW * KXK_EMU_TILE + 1,
                   9 * KXK_EMU_WINDOW * KXK_EMU_TILE + 3]
KXK_EMU_ROWS = [(1, True), (2, True), (3, True), (5, True), (1, False),
                (2, False), (3, False), (5, False)]
KXK_EMU_KS = (3, 4, 8, 12, 16, 20)


@pytest.mark.parametrize("k,rows,shared,n", [
    (k, *KXK_EMU_ROWS[(i + j) % len(KXK_EMU_ROWS)], n)
    for i, k in enumerate(KXK_EMU_KS)
    for j, n in enumerate(KXK_EMU_LENGTHS)])
def test_kxk_kernel_order(k, rows, shared, n):
    """The k x k kernel's order (sub-runs stepped in time order, their
    prefixes, the carry over windows of tiles, row groups of a shared A),
    emulated: its error against the float64 recurrence at most twice the
    float32 plain run's, plus 1e-6 of the peak (what the card is held
    to)."""
    A, b, y0 = _kxk_case(k, rows, n, shared, seed=100 * k + n)
    emu = kxk_emulated(A, b, y0, KXK_EMU_TILE, KXK_EMU_SUBRUN,
                       KXK_EMU_WINDOW)
    p32 = scan_kernels.affine_kxk_ref(A, b, y0)
    want = _kxk_float64(A, b, y0)
    assert emu.shape == b.shape and emu.dtype == torch.float32
    peak = float(want.abs().max())
    err_emu = float((emu.double() - want).abs().max())
    err_plain = float((p32.double() - want).abs().max())
    assert err_emu <= 2.0 * err_plain + 1e-6 * peak, (err_emu, err_plain)


@pytest.mark.parametrize("k", [4, 12, 34, 40])
def test_kxk_kernel_order_at_its_own_tiles(k):
    """The emulation at the kernel's own tile, sub-run and window over a
    window and a tile and a step, rows in two groups of a shared A (k = 34
    and 40: the maps in the scratch; 40: one sub-run a tile): as close to
    the float64 recurrence as the plain run, to a factor of 2 and 1e-6 of
    the peak."""
    tile, subrun = KXK_KERNEL_TILING[k]
    n = (KXK_KERNEL_WINDOW + 1) * tile + 1
    A, b, y0 = _kxk_case(k, 5, n, True, seed=k)
    emu = kxk_emulated(A, b, y0, tile, subrun)
    want = _kxk_float64(A, b, y0)
    peak = float(want.abs().max())
    err_plain = float((scan_kernels.affine_kxk_ref(A, b, y0).double()
                       - want).abs().max())
    assert float((emu.double() - want).abs().max()) <= (
        2.0 * err_plain + 1e-6 * peak)


@pytest.mark.parametrize("k", KXK_EMU_KS)
def test_kxk_kernel_order_matches_flan_tpu(k):
    """The emulated order against flan_tpu's matrix_affine_recurrence on
    the CPU (its tiled scan over k*k + k leaves), each row its own A, over
    two windows of tiles and three steps: within 1e-5 of the peak."""
    n = 2 * KXK_EMU_WINDOW * KXK_EMU_TILE + 3
    A, b, y0 = _kxk_case(k, 2, n, False, seed=7 * k)
    emu = kxk_emulated(A, b, y0, KXK_EMU_TILE, KXK_EMU_SUBRUN,
                       KXK_EMU_WINDOW)
    want = _np(jax_scan.matrix_affine_recurrence(
        jnp.asarray(A.numpy().reshape(2, k, k, n).transpose(0, 3, 1, 2)),
        jnp.asarray(b.numpy().transpose(0, 2, 1)), jnp.asarray(y0.numpy())))
    _close(emu.numpy().transpose(0, 2, 1), want, 1e-5)


def test_variants_fit_the_kernel_sources():
    """Every substitution set of ops/spv_variants.py (the tool that times a
    kernel source with one part taken out) applies to the source it was
    written for: a kernel edit that breaks one shows here, not on the card."""
    from flan_tpu_torch.ops import build, spv_variants
    cuh = (build.CSRC / "common.cuh").read_text()
    for source, (variants, _) in spv_variants.SOURCES.items():
        texts = {"cu": (build.CSRC / spv_variants.source_file(source))
                 .read_text(),
                 "cuh": cuh}
        for name, edits in variants.items():
            out = spv_variants.apply_variant(texts, edits)
            assert (out != texts) == (name != "as_shipped"), (source, name)


def test_first_version_variants_are_well_formed():
    """The sets kept for the sources a redesign started from
    (ops/spv_variants_first.py VERSIONS, by commit) fit no source of this
    tree, so only their form is checked here: every edit is (file, old,
    new[, count]) or (file, function) on "cu" or "cuh", every set names a
    source of the tool and has its as_shipped, and every source has one
    but the stereo delay's, whose diagnosis runs on today's source."""
    from flan_tpu_torch.ops import spv_variants, spv_variants_first
    versions = spv_variants_first.VERSIONS
    assert set(versions) == {"9089281", "9ad48d3", "91765eb", "1f4e009",
                             "4441291", "0f06bc7", "8c2a6b1", "68f457b",
                             "f50131e"}
    assert {src for v in versions.values() for src in v.variants} == set(
        spv_variants.SOURCES) - {"stereo_delay"}
    for version in versions.values():
        for source, variants in version.variants.items():
            assert source in spv_variants.SOURCES
            assert variants["as_shipped"] == []
            for edits in variants.values():
                for which, old, *rest in edits:
                    assert which in ("cu", "cuh")
                    if callable(old):
                        assert not rest
                    else:
                        assert isinstance(old, str) and isinstance(rest[0],
                                                                   str)
                        assert len(rest) == 1 or isinstance(rest[1], int)
    # the SQPV inverse of 91765eb and the saturator backward of 4441291 are
    # timed with their own entry points
    assert versions["91765eb"].sqpv_inverse_call is not None
    assert versions["4441291"].saturator_backward_call is not None
    # the comb of 0f06bc7 counts its own rounds (no tiles)
    assert versions["0f06bc7"].comb_rounds(
        torch.tensor([40, 3, 40, 40] * 20, dtype=torch.int32), False) > 0
    texts = {"cu": "a b a", "cuh": ""}
    assert spv_variants.apply_variant(
        texts, [("cu", "a", "c", 2), ("cu", str.upper)])["cu"] == "C B C"
    with pytest.raises(ValueError, match="not found as often"):
        spv_variants.apply_variant(texts, [("cu", "a", "c")])
