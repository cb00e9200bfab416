"""Linear-recurrence scans: Hopper kernels and plain versions.

Counterpart of tools/pallas_scan_experiment.py (TPU kernels T1
_compose_maps and T2 _apply_from) and of the recurrences of
flan_tpu/ops/scan.py. One CUDA source, csrc/scan_kernels.cu flan_scan,
runs T1's and T2's work in one launch (each tile's total map, a look-back
over the tiles before it in a fixed order, the rerun from the tile's
start state), instantiated for four families of maps along the last axis
of [..., N]:

  scan_linear      y = a y + b                       linear_ref
  scan_max_affine  y = max(m, a y + c), a >= 0       max_affine_ref
  scan_affine2x2   (s1, s2) = A (s1, s2) + (b1, b2)  affine2x2_ref
  scan_affine_kxk  s = A s + b, A k x k, any k       affine_kxk_ref

The 2 x 2 map is the k x k one's k = 2 instantiation (the SVF passes its
six planes unstacked), and the k x k map's k = 1 runs as the linear one.
For k >= 3 the k x k map runs its own kernel (csrc/scan_kernels.cu
scan_kxk_chunked): tiles of L steps for a group of rows that share A, S
sub-runs of R steps a tile, the carry over windows of tiles in a fixed
order; above k = 32 its maps live in the scratch, not in registers and
shared memory.

The plain versions transcribe flan_tpu/ops/scan.py's tiled scan: a
Hillis-Steele doubling scan within blocks of BLOCK = 4096 elements, then
the same over the block totals (scan.py:30-97; not the lane-scan branch,
which is off there). They compute in their inputs' dtype: float32 is what
the kernels are held to, float64 a yardstick of how far float32 drifts.

Dispatch by the tensors' device, and the scans' backward (the same
kernels run on reversed adjoint planes), live in ops/scan.py. The wrappers
here take CUDA tensors only and return results without a grad_fn.
LAUNCHES counts each wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on

BLOCK = 4096            # elements per block of the plain versions (as JAX)

LAUNCHES = {"scan_linear": 0, "scan_max_affine": 0, "scan_affine2x2": 0,
            "scan_affine_kxk": 0}

# name -> (kind in csrc, planes in, states out)
_KINDS = {"scan_linear": (0, 2, 1), "scan_max_affine": (1, 3, 1),
          "scan_affine2x2": (2, 6, 2)}

# The max-affine identity is finite: decay products underflow to exactly 0
# and 0 * -inf is NaN (flan_tpu/ops/scan.py:208-210).
LINEAR_IDENTITY = (1.0, 0.0)
MAX_AFFINE_IDENTITY = (-1e30, 1.0, 0.0)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions

def combine_linear(l, r):
    """y -> a y + b: l, then r."""
    return l[0] * r[0], l[1] * r[0] + r[1]


def combine_max_affine(l, r):
    """y -> max(m, a y + c): l, then r (valid for a >= 0)."""
    return (torch.maximum(r[0], r[1] * l[0] + r[2]), l[1] * r[1],
            r[1] * l[2] + r[2])


def combine_kxk(k: int):
    """The composition of s -> A s + b maps with (A row-major, b) as k*k + k
    leaves: l, then r, in the operation order of scan.py:245-257."""
    def combine(l, r):
        al, bl, ar, br = l[:k * k], l[k * k:], r[:k * k], r[k * k:]
        aa = tuple(sum(ar[i * k + m] * al[m * k + j] for m in range(k))
                   for i in range(k) for j in range(k))
        bb = tuple(sum(ar[i * k + m] * bl[m] for m in range(k)) + br[i]
                   for i in range(k))
        return aa + bb
    return combine


def kxk_identity(k: int):
    return tuple(1.0 if i == j else 0.0 for i in range(k)
                 for j in range(k)) + (0.0,) * k


# s -> A s + b with (a11, a12, a21, a22, b1, b2)
combine_affine2x2 = combine_kxk(2)


def _hillis_steele(combine, identity, leaves):
    """Inclusive scan along the last axis by shift-and-combine doubling
    (scan.py:30-54)."""
    n = leaves[0].shape[-1]
    d = 1
    while d < n:
        shifted = tuple(torch.nn.functional.pad(x[..., :n - d], (d, 0),
                                                value=ident)
                        for x, ident in zip(leaves, identity))
        leaves = combine(shifted, leaves)
        d *= 2
    return tuple(leaves)


def tiled_scan_ref(combine, identity, leaves):
    """Inclusive scan of maps along the last axis in two levels: a doubling
    scan within blocks of BLOCK, the same over the block totals, and each
    block's exclusive prefix composed in (scan.py:57-97). leaves: tensors
    of one shape [..., N]."""
    n = leaves[0].shape[-1]
    if n <= BLOCK:
        return _hillis_steele(combine, identity, leaves)
    nb = -(-n // BLOCK)
    blocked = tuple(torch.nn.functional.pad(x, (0, nb * BLOCK - n),
                                            value=ident).reshape(
                        x.shape[:-1] + (nb, BLOCK))
                    for x, ident in zip(leaves, identity))
    inner = _hillis_steele(combine, identity, blocked)
    totals = _hillis_steele(combine, identity,
                            tuple(x[..., -1] for x in inner))
    carry = tuple(torch.nn.functional.pad(x[..., :-1], (1, 0),
                                          value=ident)[..., None]
                  for x, ident in zip(totals, identity))
    out = combine(carry, inner)
    return tuple(x.reshape(x.shape[:-2] + (nb * BLOCK,))[..., :n]
                 for x in out)


def _full(planes):
    shape = torch.broadcast_shapes(*(p.shape for p in planes))
    return tuple(torch.broadcast_to(p, shape) for p in planes)


def linear_maps_ref(a: torch.Tensor, b: torch.Tensor):
    """(aa, bb): the prefix maps of y -> a y + b along the last axis, so
    that y[n] = aa[n] y[-1] + bb[n] (scan.py:158-176)."""
    return tiled_scan_ref(combine_linear, LINEAR_IDENTITY, _full((a, b)))


def linear_ref(a: torch.Tensor, b: torch.Tensor, y0) -> torch.Tensor:
    """y[n] = a[n] y[n-1] + b[n] along the last axis, y[-1] = y0
    (scan.py:179-186)."""
    aa, bb = linear_maps_ref(a, b)
    return aa * y0 + bb


def max_affine_ref(m, a, c, y0) -> torch.Tensor:
    """y[n] = max(m[n], a[n] y[n-1] + c[n]) along the last axis, y[-1] =
    y0, for a >= 0 (scan.py:189-220)."""
    mm, aa, cc = tiled_scan_ref(combine_max_affine, MAX_AFFINE_IDENTITY,
                                _full((m, a, c)))
    return torch.maximum(mm, aa * y0 + cc)


def affine2x2_ref(a11, a12, a21, a22, b1, b2, y01, y02):
    """(s1, s2)[n] = A[n] (s1, s2)[n-1] + (b1, b2)[n] along the last axis
    from (y01, y02) (scan.py:223-279 with k = 2)."""
    aa = tiled_scan_ref(combine_affine2x2, kxk_identity(2),
                        _full((a11, a12, a21, a22, b1, b2)))
    y0 = (y01, y02)
    return tuple(aa[i * 2] * y0[0] + aa[i * 2 + 1] * y0[1] + aa[4 + i]
                 for i in range(2))


def affine_kxk_ref(A, b, y0):
    """y[n] = A[n] y[n-1] + b[n] along the last axis for k x k maps
    (scan.py:223-279): A [rows or 1, k*k, N] row-major, b [rows, k, N], y0
    [rows, k]; returns y [rows, k, N]."""
    k = b.shape[1]
    leaves = tuple(A[:, p] for p in range(k * k)) + tuple(
        b[:, q] for q in range(k))
    aa = tiled_scan_ref(combine_kxk(k), kxk_identity(k), _full(leaves))
    return torch.stack([sum(aa[i * k + m] * y0[:, m, None] for m in range(k))
                        + aa[k * k + i] for i in range(k)], dim=1)


# ------------------------------------------------------------------ kernels

def _row_plane(p: torch.Tensor, shape, rows: int, n: int):
    """(tensor, row stride) of one plane broadcast to `shape`: a plane with
    one row for all rows (a broadcast view included) is passed once with
    stride 0."""
    if all(d == 1 or s == 0 for d, s in zip(p.shape[:-1], p.stride()[:-1])):
        row = p[(0,) * (p.ndim - 1)] if p.ndim > 1 else p
        return row.expand(n).contiguous(), 0
    return torch.broadcast_to(p, shape).reshape(rows, n).contiguous(), n


def _launch(name: str, planes, y0s):
    """Run scan `name` on float32 CUDA planes broadcastable to one shape
    [..., N] from the start states y0s (tensors broadcastable to
    [..., 1]); returns the states, each [..., N]."""
    kind, nplanes, nstates = _KINDS[name]
    assert len(planes) == nplanes and len(y0s) == nstates
    shape = torch.broadcast_shapes(*(p.shape for p in planes))
    if len(shape) == 0 or math.prod(shape) == 0:
        raise ValueError(f"{name}: nothing to scan in shape {tuple(shape)}")
    dev = planes[0].device
    for p in planes:
        if p.device != dev or dev.type != "cuda" or p.dtype != torch.float32:
            raise ValueError(f"{name}: the planes must be float32 tensors on "
                             f"one CUDA device, got {p.dtype} on {p.device}")
    n = shape[-1]
    rows = math.prod(shape[:-1])
    lib = load_library()
    with torch.cuda.device(dev):
        keep = [_row_plane(p, shape, rows, n) for p in planes]
        y0 = torch.stack([torch.broadcast_to(
            torch.as_tensor(v, dtype=torch.float32, device=dev),
            shape[:-1] + (1,)).reshape(rows) for v in y0s], dim=1)
        outs = [torch.empty(shape, dtype=torch.float32, device=dev)
                for _ in range(nstates)]
        # the ticket counter and the look-back descriptors: the entry point
        # zeroes them on the stream
        scratch = torch.empty(lib.flan_scan_scratch_bytes(kind, rows, n) // 8,
                              dtype=torch.int64, device=dev)
        arr = ctypes.c_longlong * 6
        err = lib.flan_scan(
            kind, arr(*(t.data_ptr() for t, _ in keep)),
            arr(*(s for _, s in keep)), arr(*(o.data_ptr() for o in outs)),
            y0.data_ptr(), scratch.data_ptr(), rows, n,
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    LAUNCHES[name] += 1
    return outs


def scan_linear(a, b, y0) -> torch.Tensor:
    """The linear kernel on float32 CUDA tensors, no autograd."""
    return _launch("scan_linear", (a, b), (y0,))[0]


def scan_max_affine(m, a, c, y0) -> torch.Tensor:
    """The max-affine kernel on float32 CUDA tensors. Requires a >= 0 (the
    composition law fails otherwise); not checked, which would cost a
    synchronisation."""
    return _launch("scan_max_affine", (m, a, c), (y0,))[0]


def scan_affine2x2(a11, a12, a21, a22, b1, b2, y01, y02):
    """The 2x2 matrix-affine kernel on float32 CUDA tensors."""
    planes = (a11, a12, a21, a22, b1, b2)
    return tuple(_launch("scan_affine2x2", planes, (y01, y02)))


def scan_affine_kxk(A, b, y0) -> torch.Tensor:
    """The k x k kernel on float32 CUDA tensors: A [rows or 1, k*k, N]
    row-major maps (one A for every row is read once for each group of
    rows that a block takes), b [rows, k, N], y0 [rows, k]; returns y
    [rows, k, N]."""
    if b.ndim != 3 or A.ndim != 3 or A.shape[0] not in (1, b.shape[0]) \
            or A.shape[1:] != (b.shape[1] ** 2, b.shape[2]) \
            or y0.shape != b.shape[:2]:
        raise ValueError(f"scan_affine_kxk: A {tuple(A.shape)}, b "
                         f"{tuple(b.shape)}, y0 {tuple(y0.shape)} do not "
                         "fit [rows or 1, k*k, N], [rows, k, N], [rows, k]")
    for name, t in (("A", A), ("b", b), ("y0", y0)):
        check_cuda(t, f"scan_affine_kxk {name}", t.ndim)
    rows, k, n = b.shape
    if A.device != b.device or y0.device != b.device:
        raise ValueError("scan_affine_kxk: A, b and y0 must be on one device")
    lib = load_library()
    shared = A.shape[0] == 1
    with torch.cuda.device(b.device):
        y = torch.empty_like(b)
        scratch = torch.empty(
            lib.flan_scan_kxk_scratch_bytes(k, rows, n, int(shared)) // 8,
            dtype=torch.int64, device=b.device)
        err = lib.flan_scan_kxk(
            k, A.data_ptr(), 0 if shared else k * k * n,
            b.data_ptr(), y.data_ptr(), y0.data_ptr(), scratch.data_ptr(),
            rows, n, torch.cuda.current_stream().cuda_stream)
    raise_on(err, "scan_affine_kxk")
    LAUNCHES["scan_affine_kxk"] += 1
    return y
