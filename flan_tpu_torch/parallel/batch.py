"""Data-parallel batch processing of audio clips over ranks (counterpart
of flan_tpu/parallel/batch.py).

The reference renders one buffer per call on host threads
(src/flan/Utility/execution.h). Here a batch of clips is padded to one
shape, each rank renders a contiguous block of it (P("data")) clip by
clip, and one all_gather brings every result to every rank: no other
collective, so throughput scales with the ranks. The JAX package's
jit(vmap) cache answers TPU compile times and has no counterpart.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from flan_tpu_torch.parallel.mesh import (Mesh, gather_batch, make_mesh,
                                          shard_batch)
from flan_tpu_torch.pipelines import pv_stretch_pipeline


def map_sharded(fn: Callable, clips: Sequence,
                mesh: Optional[Mesh] = None) -> list:
    """Apply a [C, N] -> [...] torch transform to every clip, the batch
    sharded over the mesh's ranks.

    clips: [C, N] tensors or arrays with equal channel counts; shorter
    clips are zero-padded to the longest (callers slice results back if
    length matters). The batch is padded to a multiple of the mesh with
    zero clips, whose results are dropped. Called on every rank with the
    same clips; returns every clip's output, in order, on every rank."""
    if not clips:
        return []
    mesh = mesh if mesh is not None else make_mesh()
    c = int(clips[0].shape[0])
    n = max(int(x.shape[-1]) for x in clips)
    for x in clips:
        if int(x.shape[0]) != c:
            raise ValueError("map_sharded requires equal channel counts")
    batch = len(clips)
    bpad = -(-batch // mesh.size) * mesh.size
    padded = list(range(batch)) + [None] * (bpad - batch)
    outs = []
    for i in shard_batch(mesh, torch.arange(bpad)).tolist():
        x = (torch.zeros((c, n)) if padded[i] is None
             else torch.as_tensor(clips[i], dtype=torch.float32))
        x = x.to(mesh.device)
        outs.append(fn(torch.nn.functional.pad(x, (0, n - x.shape[-1]))))
    out = gather_batch(mesh, torch.stack(outs))
    return [out[i] for i in range(batch)]


def stretch_batch(clips: Sequence, factor: float, *,
                  mesh: Optional[Mesh] = None, window_size: int = 2048,
                  hop: int = 128, dft_size: int = 4096,
                  sample_rate: float = 48000.0) -> list:
    """Data-parallel streamed PV stretch of a batch of clips
    (pipelines/stretch.py pv_stretch_pipeline on each)."""
    fn = functools.partial(
        pv_stretch_pipeline, factor=float(factor), window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=float(sample_rate))
    return map_sharded(fn, clips, mesh=mesh)
