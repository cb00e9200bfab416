"""Build and load the port's CUDA kernel library.

Every csrc/*.cu file is compiled by its own nvcc process for sm_90a, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ctypes. The build goes to
build/flan_tpu_torch/ in the checkout and is redone only when a source, a
header or a flag changes (one digest over all of them). Nothing here runs
when a module is imported: the first kernel launch builds the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flan_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TILE_FRAMES = 128       # frames per tile in every kernel (csrc/common.cuh)
MAX_BINS = 2048         # 256 threads x 8 bins each in the epilogues
SCAN_CHUNK_TILES = 256  # tiles per block of the prefix over tiles
SQPV_CARRY_CHUNK = 32   # tiles per chunk of the SQPV forward's carry
PROBE_SHAPE = (128, 512)  # rows and columns of the probe (probe_kernels.cu)
COMB_TILE, COMB_WIDTH = 1024, 32    # the comb kernels' tile and round width
STEREO_TILE = 1024      # the stereo delay kernels' staged tiles
STEREO_WIDTH = 32       # their narrow rounds' steps at most: a warp
STEREO_WIDE_WIDTH = 1024    # the wide forward's, across tiles
CYCLE_TILE = 4096       # elements a tile of the cycle scan (synth_kernels.cu)
CYCLE_FRAC_BITS = 47    # its fixed point's fraction bits
GRAIN_BLOCK = 128       # output samples a block of the grain overlap-add

_p, _i, _ll, _d, _f, _u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_double, ctypes.c_float, ctypes.c_uint)
_lla = ctypes.POINTER(ctypes.c_longlong)   # a host array of int64
# entry point -> argument types; every one returns a CUDA error code
SIGNATURES = {
    "flan_spv_forward": [_p, _p, _p, _p, _p, _p, _p, _i, _ll, _i, _d, _p],
    "flan_spv_inverse": [_p, _p, _p, _p, _i, _ll, _i, _d, _p],
    "flan_sqpv_forward": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _ll, _i,
                          _i, _f, _f, _d, _p],
    "flan_sqpv_inverse": [_p, _p, _p, _p, _p, _p, _i, _ll, _i, _d, _p],
    "flan_scan": [_i, _lla, _lla, _lla, _p, _p, _i, _ll, _p],
    "flan_scan_kxk": [_i, _p, _ll, _p, _p, _p, _p, _i, _ll, _p],
    "flan_probe": [_p, _p, _p, _p, _i, _p],
    "flan_saturator_multinotch": [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p,
                                  _i, _ll, _i, _f, _p],
    "flan_saturator_backward_maps": [_i] + [_p] * 13 + [_i, _ll, _ll, _ll,
                                                        _i, _f, _p],
    "flan_saturator_backward_readout": [_i] + [_p] * 15 + [_i, _ll, _ll,
                                                           _ll, _i, _f, _p],
    "flan_comb_swept": [_p, _p, _p, _p, _p, _p, _p, _i, _ll, _i, _f, _p],
    "flan_comb_swept_backward": [_p, _p, _p, _p, _p, _p, _i, _ll, _i, _f,
                                 _p],
    "flan_stereo_delay_swept": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                _p],
    "flan_stereo_delay_swept_backward": [_p, _p, _p, _p, _p, _p, _i, _i, _i,
                                         _i, _p],
    "flan_salience_histogram": [_p, _p, _p, _p, _p, _ll, _i, _i, _f, _p],
    "flan_threefry": [_u, _u, _ll, _i, _f, _f, _p, _p],
    "flan_cycle_scan": [_p, _ll, _f, _ll, _p, _p, _p],
    "flan_grain_overlap_add": [_p, _ll, _ll, _ll, _p, _i, _p, _i, _p, _p, _p,
                               _i, _ll, _p],
}
# functions of no argument that must return the constants the wrappers
# size their tensors by (TILE_FRAMES, MAX_BINS and SCAN_CHUNK_TILES from
# csrc/common.cuh, the SQPV carry's chunk from csrc/sqpv_kernels.cu, the
# probe's shape from csrc/probe_kernels.cu, the sequential kernels' tiles
# from csrc/sequential_kernels.cu, the synthesis kernels' tile, fixed point
# and block from csrc/synth_kernels.cu)
_LIMITS = {"flan_spv_tile_frames": TILE_FRAMES,
           "flan_spv_max_bins": MAX_BINS,
           "flan_scan_chunk_tiles": SCAN_CHUNK_TILES,
           "flan_sqpv_carry_chunk": SQPV_CARRY_CHUNK,
           "flan_probe_rows": PROBE_SHAPE[0],
           "flan_probe_cols": PROBE_SHAPE[1],
           "flan_comb_tile": COMB_TILE,
           "flan_comb_width": COMB_WIDTH,
           "flan_stereo_delay_tile": STEREO_TILE,
           "flan_stereo_delay_width": STEREO_WIDTH,
           "flan_stereo_delay_wide_width": STEREO_WIDE_WIDTH,
           "flan_cycle_scan_tile": CYCLE_TILE,
           "flan_cycle_scan_frac_bits": CYCLE_FRAC_BITS,
           "flan_grain_block": GRAIN_BLOCK}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def build_library() -> tuple[Path, str]:
    """Compile every csrc/*.cu for sm_90a and link them into
    BUILD_DIR/libflan_kernels.so, unless a build of the same sources and
    flags is there. Returns the library's path and the compilers' output
    (registers, shared memory and spills per kernel); raises if nvcc is
    missing or fails."""
    digest = _digest()
    lib = BUILD_DIR / "libflan_kernels.so"
    stamp = BUILD_DIR / "libflan_kernels.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, ""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the kernels need the CUDA "
                           "toolkit to build")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    srcs = sources()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    # wait for every compiler before raising, so none is left running
    outs = [proc.communicate()[0] for proc in procs]
    for src, proc, out in zip(srcs, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    logs = [f"{src.name}:\n{out}" for src, out in zip(srcs, outs)]
    tmp = BUILD_DIR / f"libflan_kernels.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, "\n".join(logs)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, want in _LIMITS.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}() is {fn()} in csrc, {want} in "
                               "ops/build.py")
    # the scans and the SQPV inverse size nothing on the host: elements per
    # tile of a kind, tiles per look-back window (for tests at their
    # boundaries), and the bytes of scratch one call needs: (kind, rows, n)
    lib.flan_scan_tile.argtypes = [_i]
    lib.flan_scan_tile.restype = ctypes.c_int
    lib.flan_scan_window_tiles.restype = ctypes.c_int
    lib.flan_scan_scratch_bytes.argtypes = [_i, _i, _ll]
    lib.flan_scan_scratch_bytes.restype = ctypes.c_longlong
    # the k x k map's: steps per tile and per sub-run (k), tiles per window
    # of its carry, bytes of scratch: (k, rows, n, one A shared by the rows)
    for name in ("flan_scan_kxk_tile", "flan_scan_kxk_subrun"):
        getattr(lib, name).argtypes = [_i]
        getattr(lib, name).restype = ctypes.c_int
    lib.flan_scan_kxk_window_tiles.restype = ctypes.c_int
    lib.flan_scan_kxk_scratch_bytes.argtypes = [_i, _i, _ll, _i]
    lib.flan_scan_kxk_scratch_bytes.restype = ctypes.c_longlong
    # the saturator backward's work memory (runtime orders): (two_pole,
    # order, channels, frames)
    lib.flan_saturator_backward_work_floats.argtypes = [_i, _i, _i, _ll]
    lib.flan_saturator_backward_work_floats.restype = ctypes.c_longlong
    # the swept comb's ring in device memory: (channels, ring length,
    # backward)
    lib.flan_comb_swept_ring_floats.argtypes = [_i, _i, _i]
    lib.flan_comb_swept_ring_floats.restype = ctypes.c_longlong
    # the probe's scratch: (steps)
    lib.flan_probe_scratch_floats.argtypes = [_i]
    lib.flan_probe_scratch_floats.restype = ctypes.c_longlong
    # the stereo delay's shared memory with its rings there: (wide, lb,
    # rb); what a block of the current device may take
    lib.flan_stereo_delay_shared_bytes.argtypes = [_i, _i, _i]
    lib.flan_stereo_delay_shared_bytes.restype = ctypes.c_longlong
    lib.flan_max_shared_bytes.restype = ctypes.c_int
    # the salience histogram's widest row
    lib.flan_salience_max_width.restype = ctypes.c_int
    # the SQPV inverse's scratch: (channels, frames, bins); its frames per
    # tile: (bins)
    lib.flan_sqpv_inverse_scratch_bytes.argtypes = [_i, _ll, _i]
    lib.flan_sqpv_inverse_scratch_bytes.restype = ctypes.c_longlong
    lib.flan_sqpv_inverse_tile_frames.argtypes = [_i]
    lib.flan_sqpv_inverse_tile_frames.restype = ctypes.c_int
    return lib


def tile_scratch(channels: int, frames: int, nbins: int, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An uninitialised scratch plane for tile totals and their prefix,
    flat: the totals [channels, ntiles, nbins] of the tiles of TILE_FRAMES
    frames, then [channels, nchunks, nbins] for the chunks of
    SCAN_CHUNK_TILES tiles (the prefix's second level, csrc/common.cuh)."""
    ntiles = -(-frames // TILE_FRAMES)
    rows = ntiles + -(-ntiles // SCAN_CHUNK_TILES)
    return torch.empty(channels * rows * nbins, dtype=dtype, device=device)


def check_cuda(t: torch.Tensor, name: str, ndim: int,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless t is a non-empty contiguous CUDA tensor of ndim
    dimensions and the given dtype: what every kernel wrapper takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty {ndim}-d tensor, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
