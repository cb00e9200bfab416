"""Streamed PV time-stretch: audio -> audio without materialising the PV
(counterpart of flan_tpu/pipelines/stretch.py).

The class path (Audio.convert_to_PV -> PV.stretch -> convert_to_audio)
holds PV planes that are overlap factor x 2 larger than the audio. This
plans the monotonic time map on the host and runs the chunk loop of
pipelines/streamed.py, so device memory beyond the input and output stays
O(chunk) whatever the file's length. Numerically the class path's for
monotonic maps (tests/test_torch_pipelines.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flan_tpu_torch.func.function import as_function
from flan_tpu_torch.ops.stft import num_hops
from flan_tpu_torch.pipelines.streamed import _as_inputs, streamed_pv_process


def pv_stretch_pipeline(x, factor, *, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0,
                        chunk_out: Optional[int] = None,
                        device=None) -> torch.Tensor:
    """Stretch audio x [C, N] by `factor`: a positive constant, or a
    Function of time returning positive factors, evaluated on the hop
    times as a float32 tensor on the data's device. A tensor keeps its
    device unless `device` is named; host data goes to `device` or the
    card."""
    (x,) = _as_inputs([x], device)
    nh = num_hops(int(x.shape[1]), hop)
    fn = as_function(factor)
    if fn.is_constant:
        factors = np.full(nh, fn.constant_value, np.float64)
    else:
        # sampled on float32 hop times, summed in float64 (as JAX does)
        t = np.arange(nh, dtype=np.float64) * (hop / sample_rate)
        out = fn(torch.from_numpy(t.astype(np.float32)).to(x.device))
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        factors = np.broadcast_to(np.asarray(out, np.float64), (nh,))
    if (factors <= 0).any():
        raise ValueError("stretch pipeline requires positive factors")
    return streamed_pv_process(
        [x], None, time_map=np.cumsum(factors), window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=float(sample_rate),
        chunk_out=chunk_out)
