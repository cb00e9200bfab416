"""JAX's threefry random bits, a Hopper kernel and its plain version.

The JAX package draws its noise from jax.random keys: white and pink noise
(flan_tpu/audio/synthesis.py:66-105) and synthesize_spectrum's phases
(:152-154). JAX 0.9 runs with jax_threefry_partitionable on, and then (jax
/_src/prng.py):

  key(seed)          (seed >> 32, seed & 0xFFFFFFFF), two uint32 words
  split(key, num)    row i is threefry2x32(key, (0, i)), both words
  random_bits(key, n) element i is x1 ^ x2 of threefry2x32(key, (hi(i),
                     lo(i))), the counter the flat index i of the whole
                     shape as two words
  uniform(key, n, lo, hi)
                     f = ((bits >> 9) | 0x3F800000) read as a float, minus
                     1; then f * (hi - lo) + lo, a product and a sum each
                     rounded (XLA's CPU result, numpy's order), clamped
                     below at lo

threefry2x32 is Random123's Threefry-2x32 with 20 rounds: rotations (13,
15, 26, 6) and (17, 29, 16, 24) in turn, a key injection every 4 rounds.
The same seed gives the JAX package's bits on every device, so the port's
noise equals it draw for draw.

  threefry_cuda   CUDA csrc/random_kernels.cu flan_threefry: a thread an
                  element, the 20 rounds in registers; writes the two words
                  of each counter (split, random_bits) or the uniform
                  float.
  threefry_ref    plain PyTorch: uint32 arithmetic in int64 masked to 32
                  bits, in chunks of CHUNK elements, so a 4.6e8-draw call
                  stays in memory.

split(), random_bits() and uniform() dispatch by device: the CPU takes
the plain version, CUDA the kernel or the call raises. LAUNCHES counts the
kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 1 << 22         # elements of one pass of the plain version

LAUNCHES = {"threefry_uniform": 0}


def reset_launch_counts() -> None:
    LAUNCHES["threefry_uniform"] = 0


def key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) as two uint32 words (threefry_seed)."""
    seed = int(seed)
    return ((seed >> 32) & M32, seed & M32)


def threefry2x32_ref(k1: int, k2: int, x1: torch.Tensor,
                     x2: torch.Tensor):
    """Threefry-2x32 of counter words x1, x2 (int64 tensors holding uint32
    values) under the key (k1, k2): two int64 tensors of uint32 values."""
    ks = (k1 & M32, k2 & M32, (k1 ^ k2 ^ PARITY) & M32)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & M32
            x2 = x2 ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def _float_of_bits(bits: torch.Tensor, lo: float, hi: float):
    """uniform's float from 32 random bits (int64 tensor): the mantissa
    filled, minus 1, times (hi - lo) plus lo in float32, clamped at lo."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo32, span = np.float32(lo), np.float32(np.float32(hi) - np.float32(lo))
    v = (f - 1.0) * float(span) + float(lo32)
    return torch.clamp(v, min=float(lo32))


def threefry_ref(k: tuple, n: int, lo: float = None, hi: float = None,
                 device=None) -> torch.Tensor:
    """The plain version: the uniform floats [n] in [lo, hi) of key k, or,
    with lo None, the two words of each counter (hi(i), lo(i)) as int64
    [n, 2] (split's keys; random_bits is their xor)."""
    words = lo is None
    out = torch.empty((n, 2) if words else (n,), device=device,
                      dtype=torch.int64 if words else torch.float32)
    for a in range(0, n, CHUNK):
        i = torch.arange(a, min(n, a + CHUNK), dtype=torch.int64,
                         device=device)
        x1, x2 = threefry2x32_ref(k[0], k[1], i >> 32, i & M32)
        out[a:a + i.shape[0]] = (torch.stack([x1, x2], dim=1) if words
                                 else _float_of_bits(x1 ^ x2, lo, hi))
    return out


def threefry_cuda(k: tuple, n: int, lo: float = None, hi: float = None,
                  device="cuda") -> torch.Tensor:
    """The kernel on `device`: what threefry_ref returns (the words as
    int64 [n, 2], widened from the kernel's uint32 pairs)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_cuda needs a CUDA device, got {device}")
    if n < 1:
        raise ValueError(f"threefry_cuda: n must be positive, got {n}")
    lib = load_library()
    words = lo is None
    with torch.cuda.device(device):
        out = torch.empty((n, 2) if words else (n,), device=device,
                          dtype=torch.int32 if words else torch.float32)
        check_cuda(out, "out", out.ndim, out.dtype)
        lo32 = np.float32(0.0 if words else lo)
        span = np.float32(0.0 if words else
                          np.float32(hi) - np.float32(lo))
        err = lib.flan_threefry(k[0] & M32, k[1] & M32, n, int(words),
                                float(lo32), float(span), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    raise_on(err, "threefry")
    LAUNCHES["threefry_uniform"] += 1
    if words:
        return out.to(torch.int64) & M32
    return out


def _threefry(k, n, lo, hi, device):
    if torch.device(device).type == "cpu":
        return threefry_ref(k, n, lo, hi, device)
    return threefry_cuda(k, n, lo, hi, device)


def split(k: tuple, num: int = 2, device=None) -> list:
    """jax.random.split(k, num): num keys, each two uint32 words, computed
    on `device` and read back to the host."""
    words = _threefry(k, num, None, None, device).cpu().tolist()
    return [(int(a), int(b)) for a, b in words]


def random_bits(k: tuple, n: int, device=None) -> torch.Tensor:
    """jax.random.bits(k, (n,), uint32) on `device`, as int64 values."""
    words = _threefry(k, n, None, None, device)
    return words[:, 0] ^ words[:, 1]


def uniform(k: tuple, n: int, lo: float = 0.0, hi: float = 1.0,
            device=None) -> torch.Tensor:
    """jax.random.uniform(k, (n,), float32, lo, hi) on `device`: the same
    bits as the JAX package's draws (any shape of n elements in C order,
    e.g. (1, n), draws the same flat sequence)."""
    return _threefry(k, n, lo, hi, device)
