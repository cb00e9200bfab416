"""The exclusive mod-1 cycle scan: a Hopper kernel and its plain version.

It replaces no TPU kernel. synthesize_waveform and synthesize_pulsars
(flan_tpu/audio/synthesis.py:50-58, :534-540) take their phase from
jax.lax.associative_scan(lambda a, b: jnp.mod(a + b, 1.0), inc), a float32
tree whose order no other implementation shares. The port sums the same
float32 increments exactly instead: in Q0.47 fixed point in int64 (every
increment >= 2^-24 is a whole number of 2^-47), reduced mod 1 by a mask,
each phase rounded to float32 once through float64. Integer addition
associates, so every device and every call gives the same bits, and the
phases lie within the float32 tree's own distance from the exact scan.

  inc_i   = mod(f_i / in_rate, 1) in float32 (IEEE division, jnp.mod's
            sign), or one constant increment for every element
  phase_i = float32((sum_{j < i} rint(inc_j 2^47) mod 2^47) 2^-47)

  cycle_scan_cuda  CUDA csrc/synth_kernels.cu flan_cycle_scan: tile
                   totals, their prefix, then each tile rescanned and
                   written (three launches, one call).
  cycle_scan_ref   plain PyTorch: the same integers, cumsum within blocks
                   of BLOCK elements (short enough not to overflow),
                   masked, with the carries across blocks added.

cycle_scan() dispatches by device: the CPU takes the plain version, CUDA
the kernel or the call raises. LAUNCHES counts the kernel's calls.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on
from flan_tpu_torch.ops.stft import true_div

FRAC_BITS = 47
MASK = (1 << FRAC_BITS) - 1
BLOCK = 1 << 15         # elements a cumsum of the plain version spans
CHUNK = 1 << 24         # elements of one pass of the plain version

LAUNCHES = {"cycle_scan": 0}


def reset_launch_counts() -> None:
    LAUNCHES["cycle_scan"] = 0


def constant_increment(value: float, in_rate: float) -> np.float32:
    """A constant frequency's increment as flan_tpu/audio/synthesis.py:50
    and :55 make it: the quotient in float64 rounded once to float32, then
    mod 1 in float32."""
    return np.mod(np.float32(value / in_rate), np.float32(1.0))


def fixed(inc) -> int:
    """A float32 increment in Q0.47, rounded half to even."""
    return int(round(float(inc) * 2.0 ** FRAC_BITS))


def increments(f: torch.Tensor, in_rate: float) -> torch.Tensor:
    """mod(f / in_rate, 1) of a float32 plane, as float32."""
    return torch.remainder(true_div(f, in_rate), 1.0)


def cycle_scan_ref(f, inc, in_rate: float, n: int, device=None):
    """The plain version: phases [n] float32 of the float32 frequencies f
    [n] (f None: every increment the float32 inc)."""
    if f is not None:
        device = f.device
    out = torch.empty(n, dtype=torch.float32, device=device)
    carry = 0
    for a in range(0, n, CHUNK):
        m = min(n, a + CHUNK) - a
        if f is None:
            q = torch.full((m,), fixed(inc), dtype=torch.int64,
                           device=device)
        else:
            q = torch.round(increments(f[a:a + m], in_rate).double()
                            * 2.0 ** FRAC_BITS).to(torch.int64)
        pad = -m % BLOCK
        q = torch.nn.functional.pad(q, (0, pad)).view(-1, BLOCK)
        incl = torch.cumsum(q, dim=1) & MASK             # within blocks
        tot = incl[:, -1]
        pre = (torch.cumsum(tot, 0) - tot + carry) & MASK   # before blocks
        incl = ((incl + pre[:, None]) & MASK).reshape(-1)[:m]
        first = torch.full((1,), carry, dtype=torch.int64, device=device)
        excl = torch.cat([first, incl[:-1]])
        out[a:a + m] = (excl.double() * 2.0 ** -FRAC_BITS).to(torch.float32)
        carry = int(incl[-1])
    return out


def cycle_scan_cuda(f, inc, in_rate: float, n: int, device=None):
    """The kernel: phases [n] float32 on f's device (f None: on `device`,
    every increment the float32 inc)."""
    if f is not None:
        check_cuda(f, "f", 1)
        if f.shape[0] != n:
            raise ValueError(f"f has {f.shape[0]} elements, n is {n}")
        device = f.device
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"cycle_scan_cuda needs a CUDA device, got {device}")
    if n < 1:
        raise ValueError(f"cycle_scan_cuda: n must be positive, got {n}")
    lib = load_library()
    with torch.cuda.device(device):
        ntiles = -(-n // lib.flan_cycle_scan_tile())
        totals = torch.empty(ntiles, dtype=torch.int64, device=device)
        if totals.data_ptr() % 8:
            raise RuntimeError("cycle scan's totals are not 8-byte aligned")
        phase = torch.empty(n, dtype=torch.float32, device=device)
        err = lib.flan_cycle_scan(
            None if f is None else f.data_ptr(),
            fixed(inc) if f is None else 0, float(np.float32(in_rate)), n,
            totals.data_ptr(), phase.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "cycle_scan")
    LAUNCHES["cycle_scan"] += 1
    return phase


def cycle_scan(f, inc, in_rate: float, n: int, device=None):
    """Exclusive mod-1 phases [n] float32 of frequencies f [n] (or of one
    constant float32 increment inc, with f None) at in_rate, on f's device
    (or `device`): the plain version on the CPU, the kernel on the card."""
    dev = torch.device(f.device if f is not None else device)
    if n < 1:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return cycle_scan_ref(f, inc, in_rate, n, dev)
    return cycle_scan_cuda(None if f is None else f.contiguous(), inc,
                           in_rate, n, dev)
