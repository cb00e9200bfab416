"""The salience histogram: a Hopper kernel and its plain version.

It replaces no TPU kernel. flan_tpu/pv/information.py:121-138 leaves it to
XLA: a scatter-add of every frame's subharmonic contributions into a
per-frame histogram (`.at[flat].add`), then a 21-tap cosine spread along
the bins by a convolution at HIGHEST precision. On the CPU the scatter
adds in flat order; on the card torch's index_add_ adds by atomics in no
fixed order and conv1d may run in TF32, so salience bits would wander from
call to call and move whole contours (get_contours thresholds and picks
from this buffer). Both versions here add in one fixed order:

For frame f, peak k < K (i_f [F, K] Hz, i_m [F, K] amplitudes) and
harmonic h = 1..NH, the contribution alpha^(h-1) i_m[f, k] lands on bin
b = round(120 (log2(max(i_f / h, 1e-9)) - log2(min_frequency))) + 10 of
the frame's row of `width` bins when 0 <= b - 10 < width - 10 and i_f > 0,
the log2 taken in float64 and rounded to float32 on every device, the
contributions added in the order (k, then h) from 0. Then
sal[f, j] = sum_{i = 0..20} row[j + i] g[i], the taps added in order i,
for j < width - 20.

  salience_histogram_cuda  CUDA csrc/pv_info_kernels.cu
                           flan_salience_histogram: a thread a frame, its
                           row in shared memory, the block's threads then
                           spreading the rows; no float atomics.
  salience_histogram_ref   plain PyTorch: the subharmonic bins built as
                           [F, K, NH] planes, index_add_ into the flat rows
                           (sequential in flat order on the CPU, as JAX's
                           scatter), the spread as 21 shifted slices summed
                           in tap order.

salience_histogram() dispatches by device: CPU to the plain version, CUDA
to the kernel or the call raises. LAUNCHES counts the kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on

NH = 20                 # harmonics a peak feeds (PVInformation.cpp:41)
ALPHA = 0.8             # each harmonic's weight ratio
SPREAD = 10             # bins a contribution spreads to on each side

LAUNCHES = {"salience_histogram": 0}


def reset_launch_counts() -> None:
    LAUNCHES["salience_histogram"] = 0


def alpha_powers() -> np.ndarray:
    """alpha^(h-1) for h = 1..NH with alpha the float32 0.8, each the
    correctly rounded float32 of its float64 value (host)."""
    a = np.float64(np.float32(ALPHA))
    return (a ** np.arange(NH, dtype=np.float64)).astype(np.float32)


def spread_taps() -> np.ndarray:
    """The cosine spread g[i] = 0.5 (1 + cos(|i - 10| / 10 pi / 2)) for
    i = 0..20 (flan_tpu/pv/information.py:116-117), each the correctly
    rounded float32 of its float64 value (host)."""
    offs = np.abs(np.arange(-SPREAD, SPREAD + 1)).astype(np.float64)
    return (0.5 * (1.0 + np.cos(offs / SPREAD * np.pi / 2.0))).astype(
        np.float32)


def subharmonic_bins(i_f: torch.Tensor, log2_min: float) -> torch.Tensor:
    """The bins round(120 (log2(max(i_f / h, 1e-9)) - log2_min)) of h =
    1..NH, int64 [F, K, NH], before the row's offset of 10. The log2 is
    taken in float64 and rounded to float32 on every device, as the kernel
    takes it: the card's float32 log2 rounds the other way often enough to
    move a contribution a bin (10 cents) in a few of every million."""
    h = torch.arange(1, NH + 1, dtype=torch.float32, device=i_f.device)
    sub_f = torch.clamp(i_f[..., None] / h, min=1e-9)
    lg = torch.log2(sub_f.double()).float()
    return torch.round(120.0 * (lg - log2_min)).long()


def subharmonic_contributions(i_f: torch.Tensor, i_m: torch.Tensor,
                              width: int, log2_min: float):
    """(flat, contrib) [F, K, NH]: each contribution's index in the flat
    rows [F * width] and its value alpha^(h-1) i_m, an invalid one (i_f
    <= 0, or its bin outside the row) as +0.0 at index 0, which adds
    nothing. The log2 is correctly rounded on the CPU."""
    dev = i_f.device
    b_c = subharmonic_bins(i_f, log2_min)
    contrib = torch.from_numpy(alpha_powers()).to(dev) * i_m[..., None]
    valid = (b_c >= 0) & (b_c < width - SPREAD) & (i_f[..., None] > 0)
    frame = torch.arange(i_f.shape[0], device=dev)[:, None, None]
    flat = torch.where(valid, frame * width + b_c + SPREAD, 0)
    return flat, torch.where(valid, contrib, 0.0)


def histogram_rows_ref(flat: torch.Tensor, contrib: torch.Tensor,
                       frames: int, width: int) -> torch.Tensor:
    """The rows [frames, width]: contrib added at flat by index_add_, in
    flat order on the CPU (as JAX's .at[].add there)."""
    hist = torch.zeros(frames * width, dtype=torch.float32,
                       device=contrib.device)
    hist.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    return hist.reshape(frames, width)


def spread_ref(rows: torch.Tensor) -> torch.Tensor:
    """The rows' 21-tap cosine spread [F, width - 20]: 21 shifted slices
    summed in tap order."""
    g = spread_taps()
    n_out = rows.shape[1] - 2 * SPREAD
    sal = rows[:, 0:n_out] * float(g[0])
    for i in range(1, 2 * SPREAD + 1):
        sal = sal + rows[:, i:i + n_out] * float(g[i])
    return sal


def salience_histogram_ref(i_f: torch.Tensor, i_m: torch.Tensor,
                           width: int, log2_min: float) -> torch.Tensor:
    """Plain PyTorch salience histogram and spread: i_f, i_m [F, K]
    float32 -> [F, width - 20] float32 (see the module's docstring)."""
    flat, contrib = subharmonic_contributions(i_f, i_m, width, log2_min)
    return spread_ref(histogram_rows_ref(flat, contrib, i_f.shape[0],
                                         width))


def salience_histogram_cuda(i_f: torch.Tensor, i_m: torch.Tensor,
                            width: int, log2_min: float) -> torch.Tensor:
    """The salience histogram kernel on float32 CUDA tensors i_f, i_m
    [F, K]; returns [F, width - 20]."""
    check_cuda(i_f, "i_f", 2)
    check_cuda(i_m, "i_m", 2)
    if i_f.shape != i_m.shape or i_f.device != i_m.device:
        raise ValueError(f"i_f {tuple(i_f.shape)} and i_m "
                         f"{tuple(i_m.shape)} must match on one device")
    lib = load_library()
    if not 2 * SPREAD < width <= lib.flan_salience_max_width():
        raise ValueError(f"width {width} outside (20, "
                         f"{lib.flan_salience_max_width()}]")
    f_cnt, k = i_f.shape
    dev = i_f.device
    with torch.cuda.device(dev):
        alpha = torch.from_numpy(alpha_powers()).to(dev)
        g = torch.from_numpy(spread_taps()).to(dev)
        out = torch.empty((f_cnt, width - 2 * SPREAD), dtype=torch.float32,
                          device=dev)
        err = lib.flan_salience_histogram(
            i_f.data_ptr(), i_m.data_ptr(), alpha.data_ptr(), g.data_ptr(),
            out.data_ptr(), f_cnt, k, width, float(np.float32(log2_min)),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "salience_histogram")
    LAUNCHES["salience_histogram"] += 1
    return out


def salience_histogram(i_f: torch.Tensor, i_m: torch.Tensor, width: int,
                       log2_min: float) -> torch.Tensor:
    """The salience histogram on i_f's device: the plain version on the
    CPU, the kernel on the card."""
    if i_f.device.type == "cpu":
        return salience_histogram_ref(i_f, i_m, width, log2_min)
    return salience_histogram_cuda(i_f.contiguous(), i_m.contiguous(),
                                   width, log2_min)
