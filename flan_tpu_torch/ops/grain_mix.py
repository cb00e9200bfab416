"""The granular overlap-add: a Hopper kernel, its plain version and its
host plan.

It replaces no TPU kernel. The JAX package renders granulate and psola by
_granulate_render_planned (flan_tpu/audio/synthesis.py:708-756): each
grain gathered from the source at s0 + lane, shaped by its sqrt fades
(and an envelope), cut into 128-sample rows aligned to the output's
blocks, and the rows added into the output by K host-planned gathers in
grain order (_mix_plan, :677-705); texture's modded grains land the same
way (:361-421). On the card index_add_ would add by atomics in no fixed
order. Here every output sample is the sum, from +0, of its covering
grains in ascending grain order, written once:

  for output block o (BLOCK samples), lane l: for grain g covering o, in
  order, j = (o - q_g) BLOCK + l, lane = j - r_off_g; where 0 <= lane <
  lens_g: env = 1, sqrt(max(lane, 0) / max(sf_g, 1)) where lane < sf_g,
  min(env, sqrt(max(lens_g - 1 - lane, 0) / max(ef_g, 1))) where lane >=
  lens_g - ef_g, times envp[g, j] if an envelope plane is given; the sum
  adds src(g, c, clip(s0_g + lane, 0, n_clip - 1)) env.

src is x[c, i] of one source [C, n] (granulate), or grains[g, c, i] of a
[G, C, g_n] stack (texture). The plan is a CSR form of _mix_plan's order,
without its cap on the overlap K: offsets [nblk + 1] into entries (grain
indices, ascending within each block).

  grain_overlap_add_cuda  CUDA csrc/synth_kernels.cu
                          flan_grain_overlap_add: a block a 128-sample
                          output block and channel.
  grain_overlap_add_ref   plain PyTorch: K passes, pass k adding every
                          block's k-th grain (no index is repeated within
                          a pass), the roots through stft.cpu_exact.

grain_overlap_add() dispatches by device: the CPU takes the plain version,
CUDA the kernel or the call raises. LAUNCHES counts the kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from flan_tpu_torch.ops.build import check_cuda, load_library, raise_on
from flan_tpu_torch.ops.stft import cpu_exact

BLOCK = 128

LAUNCHES = {"grain_overlap_add": 0}


def reset_launch_counts() -> None:
    LAUNCHES["grain_overlap_add"] = 0


def grain_blocks(width: int) -> int:
    """Output blocks a grain of `width` samples spans once shifted right by
    up to BLOCK - 1 (nblk_g of flan_tpu/audio/synthesis.py:687)."""
    return -(-(width + BLOCK - 1) // BLOCK)


def grain_plan(q: np.ndarray, nblk_g: int, out_n: int):
    """The CSR plan: grain g (starting at output block q[g]) covers blocks
    q[g] .. q[g] + nblk_g - 1; offsets [nblk + 1] int64 and entries int32
    list each of the nblk = ceil(out_n / BLOCK) output blocks' grains in
    ascending order (_mix_plan's stable sort by block)."""
    nblk = -(-out_n // BLOCK)
    ids = (np.asarray(q, np.int64)[:, None]
           + np.arange(nblk_g, dtype=np.int64)[None, :]).reshape(-1)
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    keep = ids_s < nblk
    entries = (order[keep] // nblk_g).astype(np.int32)
    counts = np.bincount(ids_s[keep], minlength=nblk)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offsets, entries


def _source_geometry(x: torch.Tensor):
    """(channels, channel stride, grain stride, n_clip) of a source [C, n]
    or a grain stack [G, C, g_n]."""
    if x.ndim == 2:
        return x.shape[0], x.shape[1], 0, x.shape[1]
    return x.shape[1], x.shape[2], x.shape[1] * x.shape[2], x.shape[2]


def grain_overlap_add_ref(x: torch.Tensor, meta: torch.Tensor,
                          offsets: np.ndarray, entries: np.ndarray,
                          out_n: int, envp=None) -> torch.Tensor:
    """The plain version: [C, out_n] float32 from the source x ([C, n] or
    [G, C, g_n]), meta [6, G] int32 (rows s0, lens, sf, ef, r_off, q), the
    host plan and an optional envelope plane envp [G, la]."""
    dev = x.device
    ch, _, _, n_clip = _source_geometry(x)
    nblk = -(-out_n // BLOCK)
    out = torch.zeros((ch, nblk, BLOCK), dtype=torch.float32, device=dev)
    s0, lens, sf, ef, r_off, q = meta.to(device=dev, dtype=torch.int64)
    counts = np.diff(offsets)
    lanes = torch.arange(BLOCK, device=dev)
    for k in range(int(counts.max()) if len(counts) else 0):
        blocks = np.nonzero(counts > k)[0]
        o = torch.from_numpy(blocks).to(dev)
        g = torch.from_numpy(entries[offsets[blocks] + k].astype(np.int64)
                             ).to(dev)
        j = (o - q[g])[:, None] * BLOCK + lanes[None, :]
        lane = j - r_off[g][:, None]
        len_g = lens[g][:, None]
        live = (lane >= 0) & (lane < len_g)
        lane_f = lane.to(torch.float32)
        sf_g, ef_g = sf[g][:, None], ef[g][:, None]
        env = torch.ones(lane.shape, dtype=torch.float32, device=dev)
        rise = cpu_exact(torch.sqrt, torch.clamp(lane_f, min=0.0)
                         / torch.clamp(sf_g, min=1).to(torch.float32))
        env = torch.where(lane < sf_g, rise, env)
        d = (len_g.to(torch.float32) - 1.0) - lane_f
        fall = cpu_exact(torch.sqrt, torch.clamp(d, min=0.0)
                         / torch.clamp(ef_g, min=1).to(torch.float32))
        env = torch.where(lane >= len_g - ef_g, torch.minimum(env, fall),
                          env)
        if envp is not None:
            env = env * envp[g[:, None], j]
        idx = torch.clamp(s0[g][:, None] + lane, 0, n_clip - 1)
        if x.ndim == 2:
            vals = x[:, idx]                                 # [C, S, BLOCK]
        else:
            vals = x[g[:, None], :, idx].permute(2, 0, 1)
        contrib = torch.where(live[None], vals * env[None], 0.0)
        out[:, o] = out[:, o] + contrib
    return out.reshape(ch, nblk * BLOCK)[:, :out_n]


def grain_overlap_add_cuda(x: torch.Tensor, meta: torch.Tensor,
                           offsets: np.ndarray, entries: np.ndarray,
                           out_n: int, envp=None) -> torch.Tensor:
    """The kernel on x's device: what grain_overlap_add_ref returns."""
    check_cuda(x, "x", x.ndim)
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be [C, n] or [G, C, g_n], got "
                         f"{tuple(x.shape)}")
    dev = x.device
    ch, cstride, gstride, n_clip = _source_geometry(x)
    grains = meta.shape[1]
    if meta.shape[0] != 6 or grains < 1:
        raise ValueError(f"meta must be [6, G], got {tuple(meta.shape)}")
    if len(offsets) != -(-out_n // BLOCK) + 1:
        raise ValueError("the plan's offsets do not cover out_n")
    lib = load_library()
    with torch.cuda.device(dev):
        meta_d = meta.to(device=dev, dtype=torch.int32).contiguous()
        offs_d = torch.from_numpy(np.ascontiguousarray(offsets, np.int64)
                                  ).to(dev)
        ent_d = torch.from_numpy(np.ascontiguousarray(entries, np.int32)
                                 ).to(dev)
        if envp is not None:
            check_cuda(envp, "envp", 2)
            if envp.shape[0] != grains:
                raise ValueError("envp needs a row a grain")
        out = torch.empty((ch, out_n), dtype=torch.float32, device=dev)
        err = lib.flan_grain_overlap_add(
            x.data_ptr(), cstride, gstride, n_clip, meta_d.data_ptr(),
            grains, None if envp is None else envp.data_ptr(),
            0 if envp is None else envp.shape[1], offs_d.data_ptr(),
            ent_d.data_ptr(), out.data_ptr(), ch, out_n,
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, "grain_overlap_add")
    LAUNCHES["grain_overlap_add"] += 1
    return out


def grain_overlap_add(x, meta, offsets, entries, out_n: int, envp=None):
    """The overlap-add on x's device: the plain version on the CPU, the
    kernel on the card."""
    if x.device.type == "cpu":
        return grain_overlap_add_ref(x, meta, offsets, entries, out_n, envp)
    return grain_overlap_add_cuda(
        x.contiguous(), meta, offsets, entries, out_n,
        None if envp is None else envp.contiguous())
