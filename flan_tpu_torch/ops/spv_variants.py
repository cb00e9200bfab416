"""What holds the SPV kernels: time each launch with one part taken out.

    python -m flan_tpu_torch.ops.spv_variants [--first-version CSRC_DIR]

Needs one CUDA card and nvcc. Copies csrc/spv_kernels.cu and common.cuh,
applies one textual substitution set per variant (stores removed, table
loads replaced by constants, cheap roundings put back to IEEE ones, ...),
builds each copy into build/flan_tpu_torch/variants/ and prints the card's
name and power limit, then per variant the device microseconds of every
launch of one forward and one inverse call at the SPV bench shape (30 s mono
48 kHz, 512 bins), from torch.profiler. A variant computes something else
than the kernel does: only its times mean anything.

With --first-version the source is read from CSRC_DIR instead, which must
hold the first version of the kernels (commit 9089281: `git archive 9089281
flan_tpu_torch/csrc | tar -x -C build/first`, then pass
build/first/flan_tpu_torch/csrc), and that version's variants are applied;
this is the diagnosis the redesign started from. A substitution whose text
is not found exactly once fails: the variants follow the source they were
written for.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from flan_tpu_torch.ops import build

SECONDS, SR, NBINS = 30.0, 48000.0, 512

# variant -> [(file, old, new)]; file is "cu" or "cuh"
_STORES = """        store_vec_streaming<VEC>(out_mag + b0[k], m);
        store_vec_streaming<VEC>(out_freq + b0[k], f);"""
VARIANTS = {
    "as_shipped": [],
    "forward_no_stores": [
        ("cu", _STORES, "        for (int j = 0; j < VEC; ++j) "
         "sink += m[j] + f[j];"),
        ("cu", "  const int table = two_b * nbins;\n  // i == -1",
         "  const int table = two_b * nbins;\n  float sink = 0.f;\n"
         "  // i == -1"),
        ("cu", "    if (row_next == table) row_next = 0;\n  }\n}",
         "    if (row_next == table) row_next = 0;\n  }\n"
         "  if (sink == 123.456f) mag[threadIdx.x] = sink;\n}")],
    "forward_constant_table": [
        ("cu", "      load_vec<VEC>(tw_re + row_next + b0[k], wnr);\n"
         "      load_vec<VEC>(tw_im + row_next + b0[k], wni);\n"
         "      const float hnr = tw_re[row_next + hb[k]];\n"
         "      const float hni = tw_im[row_next + hb[k]];",
         "      for (int j = 0; j < VEC; ++j) {\n"
         "        wnr[j] = 0.6f + 1e-9f * row_next;\n        wni[j] = 0.8f;\n"
         "      }\n      const float hnr = 0.6f, hni = 0.8f;")],
    "forward_ieee_math": [
        ("cu", "m[j] = sqrt_approx(energy);", "m[j] = sqrtf(energy);"),
        ("cu", "atan2_poly_fast(dead", "atan2_poly(dead"),
        ("cu", "rintf(dp * kInvTwoPi)", "rintf(dp / kTwoPi)"),
        ("cu", "scale * (2.f * fre[j] - left_re - right_re)",
         "0.25f * (2.f * fre[j] - left_re - right_re) / (float)two_b"),
        ("cu", "scale * (2.f * fim[j] - left_im - right_im)",
         "0.25f * (2.f * fim[j] - left_im - right_im) / (float)two_b")],
    "inverse_no_cosine": [
        ("cu", "  return cospif((float)(int)cycles * "
         "4.656612873077392578125e-10f);",
         "  return (float)(int)cycles * 4.656612873077392578125e-10f;")],
    "inverse_reciprocal": [
        ("cu", "  const float q = freq / sr;",
         "  const float q = freq * (1.f / sr);")],
}

_FIRST_STORES = """          out_mag[(long long)i * nbins + b] = sqrtf(energy);
          out_freq[(long long)i * nbins + b] = binf[k] + d * hz_per_radian;"""
_FIRST_FAST_MATH = [
    ("cu", "0.25f * (2.f * fre[b] - left_re - right_re) / two_b_f;",
     "(0.25f / two_b_f) * (2.f * fre[b] - left_re - right_re);"),
    ("cu", "0.25f * (2.f * fim[b] - left_im - right_im) / two_b_f;",
     "(0.25f / two_b_f) * (2.f * fim[b] - left_im - right_im);"),
    ("cu", "d = d - kTwoPi * rintf(d / kTwoPi);",
     "d = d - kTwoPi * rintf(d * 0.15915494309189535f);"),
    ("cuh", "atan_poly(lo / fmaxf(hi, 1e-37f))",
     "atan_poly(lo * __frcp_rn(fmaxf(hi, 1e-37f)))")]
_FIRST_NO_STORES = [
    ("cu", _FIRST_STORES,
     "          sink += sqrtf(energy) + (binf[k] + d * hz_per_radian);"),
    ("cu", "  int row_cur = 0;                       // (t0 + i) mod 2B",
     "  float sink = 0.f;\n  int row_cur = 0;"),
    ("cu", "    row_cur = row_next;\n    if (++row_next == two_b) row_next = 0;"
     "\n  }\n}",
     "    row_cur = row_next;\n    if (++row_next == two_b) row_next = 0;\n  }\n"
     "  if (sink == 123.456f) out_mag[threadIdx.x] = sink;\n}")]
_FIRST_CONSTANT_TABLE = [
    ("cu", "          lre[k] += d * tw_re[(long long)row_cur * nbins + b];",
     "          lre[k] += d * 0.6f;"),
    ("cu", "          lim[k] += d * tw_im[(long long)row_cur * nbins + b];",
     "          lim[k] += d * 0.8f;"),
    ("cu", "        const float wr = tw_re[(long long)row_next * nbins + b];",
     "        const float wr = 0.6f + 1e-9f * row_next;"),
    ("cu", "        const float wi = tw_im[(long long)row_next * nbins + b];",
     "        const float wi = 0.8f;")]
_FIRST_NO_BARRIER = [
    ("cu", "    __syncthreads();\n#pragma unroll\n    for (int k = 0; k < K; ++k)"
     " {\n      const int b = threadIdx.x + k * blockDim.x;\n      if (b < nbins)"
     " {\n        // 3-tap",
     "#pragma unroll\n    for (int k = 0; k < K; ++k) {\n      const int b = "
     "threadIdx.x + k * blockDim.x;\n      if (b < nbins) {\n        // 3-tap")]
_FIRST_NO_COSINE = [("cu", "mag[at] * cosf(cycles * kTwoPi);",
                     "mag[at] * (cycles * kTwoPi);")]
_FIRST_FLOOR_MOD = [
    ("cuh", "  float r = fmodf(x, 1.f);\n  if (r < 0.f) r += 1.f;\n  return r;",
     "  return x - floorf(x);")]
_FIRST_RECIPROCAL = [
    ("cu", "fr[(long long)i * nbins + b] / sample_rate",
     "fr[(long long)i * nbins + b] * (1.f / sample_rate)"),
    ("cu", "freq[at] / sample_rate", "freq[at] * (1.f / sample_rate)")]
_FIRST_NO_SHUFFLES = [
    ("cu", "      acc += __shfl_xor_sync(0xffffffffu, acc, off);",
     "      if (off == 77) acc += __shfl_xor_sync(0xffffffffu, acc, off);")]
FIRST_VERSION_VARIANTS = {
    "as_shipped": [],
    "forward_no_stores": _FIRST_NO_STORES,
    "forward_pass_through": "pass_through",
    "forward_constant_table": _FIRST_CONSTANT_TABLE,
    "forward_no_barrier": _FIRST_NO_BARRIER,
    "forward_fast_math": _FIRST_FAST_MATH,
    "forward_pass_through_constant_table": "pass_through+table",
    "forward_no_stores_fast_math": _FIRST_NO_STORES + _FIRST_FAST_MATH,
    "inverse_no_cosine": _FIRST_NO_COSINE,
    "inverse_cospif": [("cu", "mag[at] * cosf(cycles * kTwoPi);",
                        "mag[at] * cospif(2.f * cycles);")],
    "inverse_floor_mod": _FIRST_FLOOR_MOD,
    "inverse_reciprocal": _FIRST_RECIPROCAL,
    "inverse_no_shuffles": _FIRST_NO_SHUFFLES,
    "inverse_all": (_FIRST_NO_COSINE + _FIRST_FLOOR_MOD + _FIRST_RECIPROCAL
                    + _FIRST_NO_SHUFFLES),
}


def _first_pass_through(cu: str) -> str:
    """The first version's epilogue with everything after the rotation
    replaced by a store of the rotated sums."""
    a = cu.index("        const bool first = b == 0, last = b == nbins - 1;")
    end = "        prev[k] = phase;"
    return cu[:a] + """        if (i >= 0) {
          out_mag[(long long)i * nbins + b] = fre[b];
          out_freq[(long long)i * nbins + b] =
              fim[b] + prev[k] + expected[k] + binf[k] + two_b_f;
        }
""" + cu[cu.index(end) + len(end):]


def apply_variant(texts: dict, edits) -> dict:
    texts = dict(texts)
    if isinstance(edits, str):
        texts["cu"] = _first_pass_through(texts["cu"])
        edits = _FIRST_CONSTANT_TABLE if edits.endswith("+table") else []
    for which, old, new in edits:
        if texts[which].count(old) != 1:
            raise ValueError(f"substitution not found exactly once: {old!r}")
        texts[which] = texts[which].replace(old, new)
    return texts


def build_variants(csrc: Path, variants: dict) -> dict:
    """name -> ctypes library, every variant compiled at once."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found")
    texts = {"cu": (csrc / "spv_kernels.cu").read_text(),
             "cuh": (csrc / "common.cuh").read_text()}
    procs = {}
    for name, edits in variants.items():
        d = build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        out = apply_variant(texts, edits)
        (d / "spv_kernels.cu").write_text(out["cu"])
        (d / "common.cuh").write_text(out["cuh"])
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = subprocess.Popen(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), *flags, "-shared", "-o",
             str(d / "lib.so"), str(d / "spv_kernels.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    libs = {}
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(build.BUILD_DIR / "variants" / name / "lib.so"))
        for fn in ("flan_spv_forward", "flan_spv_inverse"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch_times(fn) -> dict:
    """Device microseconds per launch of each kernel fn() runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return {ev.key.replace("(anonymous namespace)::", "").split("(")[0]:
            round(ev.device_time_total / ev.count, 1)
            for ev in prof.key_averages() if ev.device_time_total > 0}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--first-version", type=Path, default=None,
                        metavar="CSRC_DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spv_variants: needs a CUDA card")
    first = args.first_version is not None
    libs = build_variants(args.first_version if first else build.CSRC,
                          FIRST_VERSION_VARIANTS if first else VARIANTS)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)

    from flan_tpu_torch.ops import spv_kernels
    dev = torch.device("cuda", 0)
    n = int(SECONDS * SR)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    x = torch.from_numpy((0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 *
                          rng.standard_normal(n)).astype(np.float32)[None]
                         ).to(dev)
    tw_re, tw_im = (torch.from_numpy(a).to(dev)
                    for a in spv_kernels.twiddle_table_np(NBINS))
    mag = torch.empty((1, n, NBINS), device=dev)
    freq = torch.empty_like(mag)
    scratch = [build.tile_scratch(1, n, NBINS, dev) for _ in range(2)]
    out = torch.empty((1, n), device=dev)
    planes = None
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        def forward():
            build.raise_on(lib.flan_spv_forward(
                x.data_ptr(), tw_re.data_ptr(), tw_im.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(), mag.data_ptr(),
                freq.data_ptr(), 1, n, NBINS, SR, stream), name)

        def inverse():
            build.raise_on(lib.flan_spv_inverse(
                planes[0].data_ptr(), planes[1].data_ptr(),
                scratch[0].data_ptr(), out.data_ptr(), 1, n, NBINS, SR,
                stream), name)

        if planes is None:      # the unchanged source's planes feed inverses
            forward()
            torch.cuda.synchronize()
            planes = (mag.clone(), freq.clone())
        times = {}
        if not name.startswith("inverse"):
            times["forward"] = launch_times(forward)
        if not name.startswith("forward"):
            times["inverse"] = launch_times(inverse)
        print(json.dumps({"variant": name, "us_per_launch": times}),
              flush=True)


if __name__ == "__main__":
    main()
