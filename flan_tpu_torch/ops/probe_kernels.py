"""The lowering probe T3: a Hopper kernel and its plain version.

Counterpart of tools/probe_pallas_ops.py, whose `kernel` (pallas_call in
`main`) checked that Mosaic lowers the operations of the SPV kernels: a
causal x-weighted prefix of w's rows (a triangular product), a polynomial
atan2 plus cos, a row shift with a carried row, a column shift with an
edge fill, a wrap and mod 1, over 4 sequential steps that carry the last
output row. It lies on no path of the library.

  probe_cuda  CUDA csrc/probe_kernels.cu flan_probe: the triangular
              product as a running float32 FMA sum down each column, for
              every step and column at once; the chain of carried rows
              alone in one block; then every output element at once.
  probe_ref   plain PyTorch, the TPU kernel's operations in their order
              (the triangular product as a matmul of tri * delta and w).

probe() dispatches by device: CPU to the plain version, CUDA to the kernel
or the call raises. LAUNCHES counts the kernel's launches.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flan_tpu_torch.ops.build import (PROBE_SHAPE, check_cuda, load_library,
                                      raise_on)
from flan_tpu_torch.ops.stft import cpu_exact

STEPS = 4               # grid steps of tools/probe_pallas_ops.py main

LAUNCHES = {"probe": 0}


def reset_launch_counts() -> None:
    LAUNCHES["probe"] = 0


def probe_inputs():
    """x [4, 128, 512] and w [128, 512] float32, from the seeds of
    tools/probe_pallas_ops.py main."""
    x = np.random.default_rng(0).normal(
        size=(STEPS,) + PROBE_SHAPE).astype(np.float32)
    w = np.random.default_rng(1).normal(size=PROBE_SHAPE).astype(np.float32)
    return x, w


def probe_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch probe: x [steps, F, B], w [F, B] -> [steps, F, B],
    computed in x's dtype (probe_pallas_ops.py:20-57)."""
    steps, f, b = x.shape
    i = torch.arange(f, device=x.device)
    tri = (i[:, None] >= i[None, :]).to(x.dtype)
    row0 = (i == 0)[:, None]
    col0 = (torch.arange(b, device=x.device) == 0)[None, :]
    x_ = cpu_exact(torch.sqrt, w.abs() + 1.0)
    carry = torch.zeros((1, b), dtype=x.dtype, device=x.device)
    outs = []
    for t in range(steps):
        delta = x[t, 0:1, :f]
        s = torch.matmul(tri * delta, w) + carry
        ay, ax = s.abs(), x_.abs()
        z = torch.minimum(ay, ax) / torch.clamp(torch.maximum(ay, ax),
                                                min=1e-30)
        at = z * (1.0 - 0.33 * (z * z))
        at = torch.where(ay > ax, (math.pi / 2) - at, at)
        at = torch.where(x_ < 0, math.pi - at, at)
        ph = torch.where(s < 0, -at, at) + torch.cos(z)
        prev = torch.where(row0, carry, torch.roll(ph, 1, 0))
        left = torch.where(col0, 2.0 * ph[:, 1:2], torch.roll(ph, 1, 1))
        wrapped = ph - prev - torch.floor(ph - prev + 0.5)
        out = wrapped + left + torch.remainder(s, 1.0)
        outs.append(out)
        carry = out[f - 1:f]
    return torch.stack(outs)


def probe_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The probe kernel on float32 CUDA tensors x [steps, 128, 512] and
    w [128, 512]."""
    check_cuda(x, "x", 3)
    check_cuda(w, "w", 2)
    if tuple(x.shape[1:]) != PROBE_SHAPE or tuple(w.shape) != PROBE_SHAPE:
        raise ValueError(f"the probe takes x [steps, *{PROBE_SHAPE}] and w "
                         f"{PROBE_SHAPE}, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    lib = load_library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        scratch = torch.empty(lib.flan_probe_scratch_floats(x.shape[0]),
                              dtype=torch.float32, device=x.device)
        err = lib.flan_probe(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             scratch.data_ptr(), x.shape[0],
                             torch.cuda.current_stream().cuda_stream)
    raise_on(err, "probe")
    LAUNCHES["probe"] += 1
    return out


def probe(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The probe on x's device: the plain version on the CPU, the kernel on
    the card."""
    return probe_ref(x, w) if x.device.type == "cpu" else probe_cuda(x, w)
