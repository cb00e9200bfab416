"""Sequence-parallel FFT convolution: overlap-add across ranks
(counterpart of flan_tpu/parallel/conv_sp.py; reference
AudioCombination.cpp:299-353).

Each rank convolves its span of the signal with the whole impulse
response (ops/fft_conv.py fft_convolve_full, cuFFT on the card) and hands
the m - 1 samples that spill past its span to the rank on its right; the
last rank's spill is the end of the output and reaches every rank.
"""
from __future__ import annotations

import torch

from flan_tpu_torch.ops.fft_conv import fft_convolve_full
from flan_tpu_torch.ops.stft import _cdiv
from flan_tpu_torch.parallel.mesh import (Mesh, from_last, gather_time,
                                          shard_time, shift_right)


def convolve_sp(x, h, mesh: Mesh, axis: str = "sp") -> torch.Tensor:
    """Full linear convolution [C, n] conv [C, m] -> [C, n + m - 1], the
    time axis sharded over the mesh; fft_convolve_full's convention (the
    caller applies flan's 1 / sqrt(n), audio/combination.py convolve).
    Requires m - 1 <= ceil(n / ranks): the spill must fit in one
    neighbour's span. Called on every rank with the same arguments;
    returns the whole result on every rank, on the mesh's device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32)
    c, n = x.shape
    if h.shape[0] != c:
        raise ValueError(f"channel mismatch: {tuple(x.shape)} conv "
                         f"{tuple(h.shape)}")
    m = h.shape[-1]
    d = mesh.shape[axis]
    s = _cdiv(n, d)                     # each rank's span
    if m - 1 > s:
        raise ValueError(
            f"impulse response tail {m - 1} exceeds the {s}-sample shard; "
            "use fewer devices or a shorter response")
    x_l = shard_time(mesh, torch.nn.functional.pad(x, (0, s * d - n)))
    y = fft_convolve_full(x_l.to(mesh.device), h.to(mesh.device))
    main, tail = y[:, :s].clone(), y[:, s:]
    main[:, :m - 1] += shift_right(mesh, tail)
    last = from_last(mesh, tail)
    return torch.cat([gather_time(mesh, main), last], dim=-1)[:, :n + m - 1]
