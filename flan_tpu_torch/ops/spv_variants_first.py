"""Substitution sets for the kernel sources that a redesign started from.

ops/spv_variants.py --first-version COMMIT CSRC_DIR applies the sets of
VERSIONS[COMMIT] instead of its own. They fit these sources and no later
one: csrc/spv_kernels.cu of commit 9089281 (before B1 and B2 were
redesigned); csrc/scan_kernels.cu and csrc/sqpv_kernels.cu of commit 9ad48d3
(the scan in three launches with blocks numbered row-major; B3 as tile
totals, a sequential carry and an epilogue that read every table entry from
L2); csrc/sqpv_kernels.cu of commit 91765eb (B4 as tile totals of float32
mod-1 cycles, a prefix over tiles and an epilogue with sincosf and a
reduction across the block every frame); the k x k map of
csrc/scan_kernels.cu of commit 1f4e009 (the one pass with maps in
registers for k <= 8, a block a row in time order above; its
flan_scan_kxk_scratch_bytes takes no fourth argument, which the call
ignores); csrc/sequential_kernels.cu of commit 4441291 (the saturator
multinotch one warp a channel with its states in shared memory and its
backward rerunning every step beside the adjoint, one launch); and
csrc/sequential_kernels.cu of commit 0f06bc7 (the swept comb and its
backward one warp a channel, each round's length a five-shuffle minimum
of its frames' delays; comb_rounds counts that version's rounds); and
csrc/pv_info_kernels.cu of commit 8c2a6b1 (the salience histogram a
thread a frame, its adds one chain); and csrc/synth_kernels.cu of commit
68f457b (K2 in three launches reading f twice through float64
conversions; K3 a block an output block and channel, its metadata read
by dependent loads); and csrc/pv_stage_kernels.cu of commit f50131e (H2
a block a channel and 32 bins, a warp a block of 256 frames walked twice:
once for the float64 total, once to write). `git archive
COMMIT
flan_tpu_torch/csrc | tar -x -C build/first` brings a source back. Beside
the sets stand the entry points, scratch and constants of those sources
where today's differ.
"""
from __future__ import annotations

import re
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from flan_tpu_torch.ops import build


# ---- B1 and B2 before their redesign (commit 9089281)
def _pass_through(cu: str) -> str:
    """The first version's SPV epilogue with everything after the rotation
    replaced by a store of the rotated sums."""
    a = cu.index("        const bool first = b == 0, last = b == nbins - 1;")
    end = "        prev[k] = phase;"
    return cu[:a] + """        if (i >= 0) {
          out_mag[(long long)i * nbins + b] = fre[b];
          out_freq[(long long)i * nbins + b] =
              fim[b] + prev[k] + expected[k] + binf[k] + two_b_f;
        }
""" + cu[cu.index(end) + len(end):]


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
SPV_FIRST_VARIANTS = {
    "as_shipped": [],
    "forward_no_stores": _FIRST_NO_STORES,
    "forward_pass_through": [("cu", _pass_through)],
    "forward_constant_table": _FIRST_CONSTANT_TABLE,
    "forward_no_barrier": _FIRST_NO_BARRIER,
    "forward_fast_math": _FIRST_FAST_MATH,
    "forward_pass_through_constant_table": ([("cu", _pass_through)]
                                            + _FIRST_CONSTANT_TABLE),
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

# ---- the scans as they stood before their redesign (commit 9ad48d3): three
# launches, blocks numbered row-major
_SCAN_FIRST_LOAD = "  load_tile<Op>(args, row, base, n, sm);\n"
_SCAN_FIRST_FILL = """  for (int p = 0; p < Op::kMap; ++p)
    for (int k = 0; k < Op::kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      sm[p * Tile<Op>::kPitch + padded(i)] =
          0.999f * Op::identity(p) + 1e-9f * (float)i;
    }
"""
_SCAN_FIRST_APPLY_HEAD = (
    _SCAN_FIRST_LOAD + "  __syncthreads();\n"
    "  float m[Op::kMap], ex[Op::kMap], total[Op::kMap];\n"
    "  compose_run<Op>(sm, m);\n"
    "  block_scan<Op>(m, ex, total, warp_tot);\n"
    "  float s[Op::kState];\n#pragma unroll\n"
    "  for (int q = 0; q < Op::kState; ++q) s[q] = starts[")
SCAN_FIRST_VARIANTS = {
    "as_shipped": [],
    "apply_no_stores": [
        ("cu", "      if (g < n) dst[g] = sm[q * Tile<Op>::kPitch + padded(i)];",
         "      if (g < n && sm[q * Tile<Op>::kPitch + padded(i)] == 123.456f)"
         " dst[g] = 0.f;")],
    "apply_no_second_read": [
        ("cu", _SCAN_FIRST_APPLY_HEAD,
         _SCAN_FIRST_APPLY_HEAD.replace(_SCAN_FIRST_LOAD, _SCAN_FIRST_FILL))],
    "no_reads": [("cu", _SCAN_FIRST_LOAD, _SCAN_FIRST_FILL, 2)],
    "tile_major_blocks": [
        ("cu", "  const long long blk = blockIdx.x;\n"
         "  const long long row = blk / ntiles;\n"
         "  const long long base = (blk % ntiles) * Tile<Op>::kLen;",
         "  const long long nrows = gridDim.x / ntiles;\n"
         "  const long long row = blockIdx.x % nrows;\n"
         "  const long long blk = row * ntiles + blockIdx.x / nrows;\n"
         "  const long long base = (blockIdx.x / nrows) * Tile<Op>::kLen;", 2)],
}

# ---- B3 as it stood before its redesign (commit 9ad48d3): tile totals, a
# sequential carry, an epilogue, every table entry read from L2
_SQPV_FIRST_STORES = """      mag[at] = sqrtf(hre * hre + him * him);
      pitch[at] = log2f(fmaxf(fabsf(f), 1e-12f));
      positive[at] = f >= 0.f;"""
_SQPV_FIRST_SINK = [
    ("cu", "  const long long out0 = (long long)c * n - w0;  "
     "// frame t -> row out0 + t",
     "  const long long out0 = (long long)c * n - w0;\n  float sink = 0.f;"),
    ("cu", "    prev = phase;\n  }\n}",
     "    prev = phase;\n  }\n  if (sink == 123.456f) mag[threadIdx.x] = sink;"
     "\n}")]
_SQPV_FIRST_NO_STORES = _SQPV_FIRST_SINK + [
    ("cu", _SQPV_FIRST_STORES,
     "      sink += sqrtf(hre * hre + him * him) + log2f(fmaxf(fabsf(f), "
     "1e-12f)) + (f >= 0.f ? 1.f : 0.f) + (float)(at & 1);")]
_SQPV_FIRST_CONSTANT_TABLE = [
    ("cu", "  return __ldg(tables + ((long long)(which * kLines + line) * "
     "kTile + i) *\n                            nbins + b);",
     "  return (which & 1) ? 0.8f : 0.6f + 1e-9f * (float)(i + line);")]
_SQPV_FIRST_NO_GATHERS = [
    ("cu", "(i_new >= 0 && i_new < n) ? __ldg(xc + i_new) : 0.f;",
     "(i_new >= 0 && i_new < n) ? 0.25f + 1e-9f * (float)i_new : 0.f;"),
    ("cu", "(i_old >= 0 && i_old < n) ? __ldg(xc + i_old) : 0.f;",
     "(i_old >= 0 && i_old < n) ? 0.125f + 1e-9f * (float)i_old : 0.f;")]
_SQPV_FIRST_FAST_MATH = [
    ("cu", "    const float phase = atan2_poly(him, hre);",
     "    const float phase = atan2_poly_fast(him, hre);"),
    ("cu", "rintf(d / kTwoPi)", "rintf(d * 0.15915494309189535f)"),
    ("cu", "mag[at] = sqrtf(hre * hre + him * him);",
     "{ float r_; asm(\"sqrt.approx.ftz.f32 %0, %1;\" : \"=f\"(r_) : "
     "\"f\"(hre * hre + him * him)); mag[at] = r_; }")]
_SQPV_FIRST_PASS_THROUGH = [
    ("cu", "    const float phase = atan2_poly(him, hre);",
     "    const float phase = him + hre;"),
    ("cu", "      d = d - kTwoPi * rintf(d / kTwoPi);\n", ""),
    ("cu", "mag[at] = sqrtf(hre * hre + him * him);",
     "mag[at] = hre * hre + him * him;"),
    ("cu", "pitch[at] = log2f(fmaxf(fabsf(f), 1e-12f));", "pitch[at] = f;")]
SQPV_FIRST_VARIANTS = {
    "as_shipped": [],
    "forward_no_stores": _SQPV_FIRST_NO_STORES,
    "forward_constant_table": _SQPV_FIRST_CONSTANT_TABLE,
    "forward_no_gathers": _SQPV_FIRST_NO_GATHERS,
    "forward_fast_math": _SQPV_FIRST_FAST_MATH,
    "forward_pass_through": _SQPV_FIRST_PASS_THROUGH,
    "forward_constant_table_no_gathers": (_SQPV_FIRST_CONSTANT_TABLE
                                          + _SQPV_FIRST_NO_GATHERS),
    "forward_constant_table_no_gathers_pass_through": (
        _SQPV_FIRST_CONSTANT_TABLE + _SQPV_FIRST_NO_GATHERS
        + _SQPV_FIRST_PASS_THROUGH),
    # the store side alone, without the byte plane and with only it
    "forward_stores_only_no_bytes": (
        _SQPV_FIRST_CONSTANT_TABLE + _SQPV_FIRST_NO_GATHERS
        + _SQPV_FIRST_PASS_THROUGH + _SQPV_FIRST_SINK + [
            ("cu", "      positive[at] = f >= 0.f;",
             "      sink += f >= 0.f ? 1.f : 0.f;")]),
    "forward_stores_only_bytes": (
        _SQPV_FIRST_CONSTANT_TABLE + _SQPV_FIRST_NO_GATHERS
        + _SQPV_FIRST_SINK + [
            ("cu", "    const float phase = atan2_poly(him, hre);",
             "    const float phase = him + hre;"),
            ("cu", "      d = d - kTwoPi * rintf(d / kTwoPi);\n", ""),
            ("cu", "      mag[at] = sqrtf(hre * hre + him * him);\n"
             "      pitch[at] = log2f(fmaxf(fabsf(f), 1e-12f));\n",
             "      sink += hre * hre + him * him + f;\n")]),
}

# ---- B4 as it stood before its redesign (commit 91765eb): float32 cycles
# reduced by fmodf, a tile-totals launch that reads pitch and sign a second
# time, sincosf, a warp reduction every frame
_B4_INCREMENT = ("  const float f = exp2f(p);\n"
                 "  return mod1((pos ? f : -f) / sample_rate);")
_B4_EPILOGUE_SUM = """        run[k] = mod1(run[k] +
                      cycle_increment(pitch[at], positive[at], sample_rate));
        const float cycles = mod1(run[k] + cyc0[k]);
        float sn, cs;
        sincosf(cycles * kTwoPi, &sn, &cs);
        acc += mag[at] * (cs * twr[k] - sn * twi[k]);"""
_B4_NO_TOTALS = [
    ("cu", "  sqpv_inv_tile_totals<<<grid, threads, 0, s>>>(pitch, positive, "
     "tot, n,\n                                                nbins, "
     "ntiles, sr);\n", "")]
_B4_NO_SINCOS = [("cu", "        sincosf(cycles * kTwoPi, &sn, &cs);",
                  "        sn = cycles;\n        cs = cycles * kTwoPi;")]
_B4_LOADS_ONLY = [
    ("cu", _B4_INCREMENT, "  return p + (float)pos + 0.f * sample_rate;"),
    ("cu", "      s = mod1(s + cycle_increment(pitch[at], positive[at], "
     "sample_rate));",
     "      s += cycle_increment(pitch[at], positive[at], sample_rate);"),
    ("cu", _B4_EPILOGUE_SUM,
     "        acc += mag[at] + cycle_increment(pitch[at], positive[at], "
     "sample_rate);")]
SQPV_INVERSE_FIRST_VARIANTS = {
    "as_shipped": [],
    "inverse_no_totals": _B4_NO_TOTALS,
    "inverse_no_fmod": _FIRST_FLOOR_MOD,
    "inverse_no_sincos": _B4_NO_SINCOS,
    "inverse_no_reduction": _FIRST_NO_SHUFFLES,
    "inverse_loads_only": _B4_LOADS_ONLY + _FIRST_NO_SHUFFLES,
    "inverse_no_division": [
        ("cu", "  return mod1((pos ? f : -f) / sample_rate);",
         "  return mod1((pos ? f : -f) * (1.f / sample_rate));")],
    "inverse_no_exp2": [("cu", "  const float f = exp2f(p);",
                         "  const float f = p;")],
    "inverse_no_totals_no_fmod_no_sincos": (_B4_NO_TOTALS + _FIRST_FLOOR_MOD
                                            + _B4_NO_SINCOS),
    "inverse_no_totals_loads_only": (_B4_NO_TOTALS + _B4_LOADS_ONLY
                                     + _FIRST_NO_SHUFFLES),
}

_p, _i, _ll, _d, _f, _lla = (build._p, build._i, build._ll, build._d,
                             build._f, build._lla)
# the entry points of commit 9ad48d3, where they differ from ops/build.py's
SIGNATURES_9AD48D3 = {
    "flan_scan": [_i, _lla, _lla, _lla, _p, _p, _p, _i, _ll, _p],
    "flan_sqpv_forward": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _ll, _i, _i,
                          _f, _f, _d, _p],
}
# the SQPV inverse of commits 9ad48d3 and 91765eb: mag, pitch, positive, the
# twiddle [2, B], the tile-totals scratch, out, C, N, B, sr, stream
_SQPV_INVERSE_FIRST = [_p, _p, _p, _p, _p, _p, _i, _ll, _i, _d, _p]


def scan_scratch(lib, kind: int, rows: int, n: int, nplanes: int,
                 nstates: int, dev) -> list:
    """The scratch planes of commit 9ad48d3's flan_scan: the tiles' total
    maps and their start states."""
    ntiles = -(-n // lib.flan_scan_tile(kind))
    return [torch.empty(rows * ntiles * nplanes, device=dev),
            torch.empty(rows * ntiles * nstates, device=dev)]


def sqpv_forward_consts(geo, frames: int, dev) -> tuple:
    """(constants, scratch) of commit 9ad48d3's flan_sqpv_forward: the four
    tables [4, 3, 128, B], the float and int rows per bin, the tile totals."""
    t1, t2 = geo.twiddle_tables(build.TILE_FRAMES)
    tables = torch.from_numpy(np.stack(
        [t1.real, t1.imag, t2.real, t2.imag]).astype(np.float32)).to(dev)
    bin_freq, expected = geo.bin_frequencies(np.float32)
    bin_f = torch.from_numpy(np.stack(
        [geo.scale.astype(np.float32),
         *(a.astype(np.float32) for a in geo.quirk_coefficients),
         bin_freq, expected])).to(dev)
    bin_i = torch.from_numpy(np.stack(
        [geo.off_p, geo.off_m, geo.t_new, geo.t_old]).astype(np.int32)).to(dev)
    ntiles = -(-(geo.w0 + frames) // build.TILE_FRAMES)
    return ((tables, bin_f, bin_i),
            torch.empty((1, ntiles, 6, geo.nbins), device=dev))


def sqpv_inverse_call(lib, planes, out, geo, stream):
    """A call of the SQPV inverse of commits 9ad48d3 and 91765eb on planes
    [1, N, B]: the float32 twiddle [2, B] and a tile-totals scratch."""
    _, n, nb = planes[0].shape
    dev = planes[0].device
    tw = geo.synthesis_twiddle
    tw = torch.from_numpy(np.stack([tw.real, tw.imag]).astype(
        np.float32)).to(dev)
    tot = build.tile_scratch(1, n, nb, dev)

    def call():
        build.raise_on(lib.flan_sqpv_inverse(
            *(t.data_ptr() for t in planes), tw.data_ptr(), tot.data_ptr(),
            out.data_ptr(), 1, n, nb, float(geo.sample_rate), stream),
            "sqpv_inverse")
    return call


# ---- the k x k map before its redesign (commit 1f4e009)
KXK_FIRST_VARIANTS = {
    "as_shipped": [],
    # the one pass (k <= 8) without its look-back
    "no_look_back": [
        ("cu", "  const int count = first ? kWindow : r;",
         "  const int count = 0 * (first ? kWindow : r);")],
}


# ---- the saturator multinotch before its redesign (commit 4441291): one
# warp a channel, the allpass states in shared memory, order known at run
# time, Newton held at one iteration a loop trip; the backward reruns every
# step on all 32 lanes beside the adjoint
def _forward_kernel(cu: str) -> tuple:
    """(start, end) of the forward kernel's text in commit 4441291's
    csrc/sequential_kernels.cu."""
    a = cu.index("template <bool kTwoPole>\n__global__ void __launch_bounds__"
                 "(32)\nsaturator_multinotch(")
    return a, cu.index("// The adjoint of saturator_multinotch", a)


def _forward_order2_registers(cu: str) -> str:
    """The forward with order fixed at 2 (the bench's), so that its loops
    unroll, and the allpass states in registers instead of shared memory
    (the snapshots stay there)."""
    a, b = _forward_kernel(cu)
    body = cu[a:b]
    body = body.replace("float* __restrict__ states, int order, float inv,",
                        "float* __restrict__ states, int order_, float inv,")
    body = body.replace("  extern __shared__ float st[];\n",
                        "  extern __shared__ float st_sh[];\n"
                        "  constexpr int order = 2;\n  float st_r[4];\n")
    body = body.replace("  float* snap = st + nstates * 32;",
                        "  float* snap = st_sh;")
    body = re.sub(r"st\[(\([^]]*?\)|\w+) \* 32 \+ lane\]", r"st_r[\1]", body)
    if "st[" in body or body.count("st_r[") != 12:
        raise ValueError("the forward's state indexing is not 4441291's")
    return cu[:a] + body + cu[b:]


_SAT_FIRST_UNROLLED = [("cu", "#pragma unroll 1\n  for (int it = 0; it < 8; "
                        "++it) {", "#pragma unroll\n  for (int it = 0; "
                        "it < 8; ++it) {")]


def _backward_no_rerun(cu: str) -> str:
    """The backward without its rerun of each step: the Newton iterates,
    tanh values, denominators and stage inputs the adjoint reads are cheap
    stand-ins."""
    a = cu.index("      // the step again, from its old states and the last "
                 "output\n")
    b = cu.index("      const float yv = v * inv;\n", a)
    b += len("      const float yv = v * inv;\n")
    return cu[:a] + """      const float msum0 = s[0], msum = s[0];
      const float gn = Gc * Gc;
      float us[9], ts[8], dens[8];
      bool guarded[8];
      us[0] = prevc;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        us[it + 1] = prevc + 0.125f * (float)it;
        ts[it] = 0.5f * xc;
        dens[it] = -1.f - 0.01f * (float)it;
        guarded[it] = false;
      }
      const float xbar = us[8];
      for (int jj = 0; jj < order; ++jj) ys[jj * 32 + lane] = xbar;
      const float yv = xbar * inv;
""" + cu[b:]


def _backward_no_adjoint(cu: str) -> str:
    """The backward without its adjoint: the rerun stays, the gradients are
    stand-ins read from it, and the carried adjoint a cheap chain."""
    a = cu.index("      // its adjoint: the mix, the cascade, Newton, the "
                 "feedback sum\n")
    b = cu.index("      if (lane == j) {\n        mine_gx = gxv;", a)
    return cu[:a] + """      const float pg_g = us[8] + ts[7], pg_G = dens[7];
      const float pg_k = msum0, pg_mix = gout * yv, pg_a = ys[lane];
      const float pg_d = guarded[3];
      const float gxv = yv + xbar;
      gprev = gout * 0.5f;
""" + cu[b:]


SATURATOR_FIRST_VARIANTS = {
    "as_shipped": [],
    # the forward's step: tanhf and the IEEE division of each Newton
    # iteration, the states in shared memory and the loops over a runtime
    # order, the powers of G recomputed every step, Newton not unrolled
    "forward_no_tanhf": [
        ("cu", "    const float t = tanhf(kc * (gn * u + msum));",
         "    const float t = 0.5f * (kc * (gn * u + msum));")],
    "forward_approx_division": [
        ("cu", "    u = u - (x + inv * t - u) / den;",
         "    u = u - __fdividef(x + inv * t - u, den);")],
    "forward_order2_registers": [("cu", _forward_order2_registers)],
    # the powers as at order 2 with no loop: G^0 = 1, G^1, G^2 one product
    "forward_ipow_hoisted": [
        ("cu", "          msum = msum + ipow(Gc, i) * (gc * st[(2 * jj + 1) "
         "* 32 + lane] -",
         "          msum = msum + (i == 0 ? 1.f : Gc) * (gc * st[(2 * jj + 1)"
         " * 32 + lane] -"),
        ("cu", "          msum = msum + ipow(Gc, i) * st[jj * 32 + lane];",
         "          msum = msum + (i == 0 ? 1.f : Gc) * st[jj * 32 + lane];"),
        ("cu", "      const float gn = ipow(Gc, order);\n      const float "
         "xbar = newton(",
         "      const float gn = Gc * Gc;\n      const float xbar = newton(")],
    "forward_newton_unrolled": _SAT_FIRST_UNROLLED,
    "forward_order2_registers_unrolled": [
        ("cu", _forward_order2_registers)] + _SAT_FIRST_UNROLLED,
    "backward_no_rerun": [("cu", _backward_no_rerun)],
    "backward_no_adjoint": [("cu", _backward_no_adjoint)],
}
# commit 4441291's backward: one launch (two_pole, gy, x, y, states, g, G,
# G_f or R, d, k, mix, gx, gplanes, C, N, order, inv, stream)
_SATURATOR_BACKWARD_FIRST = [_i] + [_p] * 12 + [_i, _ll, _i, _f, _p]


def _comb_warp_rounds(delays, reverse: bool) -> int:
    """The rounds commit 0f06bc7's comb kernels take over a call: from each
    round's first frame, min(32, the least delay of the 32 frames from it
    on, forward, or down from it, reverse), no tiles."""
    d = delays.long()
    n = d.shape[0]
    big = torch.iinfo(torch.int64).max
    pad = torch.full((31,), big, dtype=torch.int64, device=d.device)
    dd = d.flip(0) if reverse else d
    s = torch.cat([dd, pad]).unfold(0, 32, 1).amin(-1).clamp(max=32).tolist()
    pos = rounds = 0
    while pos < n:
        pos += s[pos]
        rounds += 1
    return rounds


def saturator_backward_call(lib, args, stream):
    """A call of commit 4441291's saturator backward: args = (two_pole, gy,
    x, y, states, kernel-order planes, gx, gplanes, order, inv)."""
    two_pole, gy, x, y, states, planes, gx, gp, order, inv = args
    c, n = x.shape

    def call():
        build.raise_on(lib.flan_saturator_multinotch_backward(
            int(two_pole), gy.data_ptr(), x.data_ptr(), y.data_ptr(),
            states.data_ptr(),
            *(None if p is None else p.data_ptr() for p in planes),
            gx.data_ptr(), gp.data_ptr(), c, n, order, inv, stream),
            "saturator_backward")
    return call


# ---- the swept comb before its redesign (commit 0f06bc7): one warp a
# channel, a round of min(32, the least delay of its 32 frames) steps by a
# five-shuffle minimum, the inputs kAhead = 4 chunks of 32 frames ahead by
# cp.async with a wait on entering each chunk, y and u (gu) stored by
# every round, two warp barriers a round (the backward's peers summed
# through shared memory after __match_any_sync)
_COMB_WAIT = ('      asm volatile("cp.async.wait_group %0;" ::"n"(kAhead - 2) '
              ': "memory");\n      __syncwarp();\n    }\n  }')
_COMB_AT_END = "    dv = reinterpret_cast<const int*>(q)[96];\n  }"
_COMB_GIVEN_AT = (
    "    dv = reinterpret_cast<const int*>(q)[96];\n"
    "    const int off0 = (int)(kDir * (pos - first));\n"
    "    int slot0 = head + (off0 >> 5);\n"
    "    if (slot0 >= kAhead) slot0 -= kAhead;\n"
    "    given = reinterpret_cast<const int*>(buf + slot0 * 128 + "
    "(off0 & 31))[96];\n  }")
_COMB_STEPS = "    const int steps = warp_min(dv < 32 ? dv : 32);\n"
_COMB_FWD_AT = "    q.at(base, xv, kv, av, dv);\n"
_COMB_BACK_AT = "    q.at(top, gyv, kv, av, dv);\n"


def _comb_given(cu: str) -> str:
    """The round's length read from shared memory (its first frame's
    delay, at most 32, one load every lane makes) in place of the
    five-shuffle minimum: another round where the delay falls within one
    (a round may then read a slot written in it; only its time means
    anything)."""
    cu = cu.replace("  __device__ __forceinline__ void at(long long pos, "
                    "float& sv, float& kv,\n"
                    "                                     float& av, int& dv) "
                    "const {",
                    "  __device__ __forceinline__ void at(long long pos, "
                    "float& sv, float& kv,\n"
                    "                                     float& av, int& dv, "
                    "int& given) const {")
    cu = cu.replace(_COMB_AT_END, _COMB_GIVEN_AT)
    for at in (_COMB_FWD_AT, _COMB_BACK_AT):
        cu = cu.replace(at, at.replace("dv);", "dv, given);").replace(
            "    q.at", "    int given;\n    q.at"))
    return cu.replace(_COMB_STEPS, "    const int steps = given < 32 ? "
                      "given : 32;\n")


COMB_FIRST_VARIANTS = {
    "as_shipped": [],
    # the copies 16 chunks ahead in place of 4: the chunk a round enters
    # was asked for 14 chunks before, so no round waits on device memory
    "no_wait_ahead_16": [
        ("cu", "constexpr int kAhead = 4; ", "constexpr int kAhead = 16;")],
    "no_stores": [
        ("cu", "      ring[slot] = u;\n      y[ch * n + t] = yv;\n"
         "      if (u_out) u_out[ch * n + t] = u;\n",
         "      ring[slot] = u;\n      if (yv == 123.456f) y[ch * n + t] "
         "= yv;\n"),
        ("cu", "      gu[ch * n + t] = g;\n",
         "      if (g == 123.456f) gu[ch * n + t] = g;\n")],
    "round_given": [("cu", _comb_given)],
    "backward_no_match": [
        ("cu", "    const unsigned peers = __match_any_sync(kFull, key);",
         "    const unsigned peers = 1u << lane;")],
    # the ring's read, the step's FMAs, the ring's write and the barriers
    # alone: every round 32 steps of delay 32, no loads, no stores
    "chain_only": [
        ("cu", "    q.reach(base, xr, delays, kf, af, n);\n", ""),
        ("cu", "    q.reach(top, gr, delays, kf, af, n);\n", ""),
        ("cu", _COMB_FWD_AT, "    xv = (float)lane; kv = 0.5f; av = 0.5f; "
         "dv = 32;\n"),
        ("cu", _COMB_BACK_AT, "    gyv = (float)lane; kv = 0.5f; av = 0.5f;"
         " dv = 32;\n"),
        ("cu", _COMB_STEPS, "    const int steps = 32;\n", 2),
        ("cu", "      ring[slot] = u;\n      y[ch * n + t] = yv;\n"
         "      if (u_out) u_out[ch * n + t] = u;\n",
         "      ring[slot] = u;\n      if (yv == 123.456f) y[ch * n + t] "
         "= yv;\n"),
        ("cu", "      gu[ch * n + t] = g;\n",
         "      if (g == 123.456f) gu[ch * n + t] = g;\n")],
}


# ---- the salience histogram before its redesign (commit 8c2a6b1): a
# thread a frame, 16 frames a block
SALIENCE_FIRST_VARIANTS = {
    "as_shipped": [],
    # the log2 in float32 (other bins: times only)
    "float32_log2": [("cu", "const float lg = (float)log2((double)sub);",
                      "const float lg = log2f(sub);")],
    # no spread: the rows only
    "no_spread": [("cu", "  for (int i = threadIdx.x; i < nf * n_out; "
                   "i += kThreads) {\n",
                   "  for (int i = threadIdx.x; i < 0; i += kThreads) {\n")],
}


# ---- K2 and K3 before their redesign (commit 68f457b): K2 in three
# launches (tile totals, their prefix, each tile rescanned and written),
# reading f twice, six conversions through float64 an element; K3 a block
# a 128-sample output block and channel, each grain's plan entry and
# metadata read from device memory by a chain of dependent loads
_K3_FIRST_HEAD = """__global__ void __launch_bounds__(kBlock)
grain_overlap_add(const float* __restrict__ x, long long chan_stride,
                  long long grain_stride, long long n_clip,
                  const int* __restrict__ meta, int grains,
                  const float* __restrict__ envp, int la,
                  const long long* __restrict__ offsets,
                  const int* __restrict__ entries, float* __restrict__ out,
                  long long out_n) {
"""
# a grain's contribution to this thread's sample of channel c0 (and c1),
# the first design's arithmetic
_K3_FIRST_GRAIN = """
    const long long j = (o - qg) * kBlock + l;
    const int lane = (int)(j - rg);
    if (lane < 0 || lane >= len) continue;
    const float lane_f = (float)lane;
    float env = 1.f;
    if (lane < sfg)
      env = __fsqrt_rn(__fdiv_rn(fmaxf(lane_f, 0.f), (float)max(sfg, 1)));
    if (lane >= len - efg) {
      const float d = __fsub_rn(__fsub_rn((float)len, 1.f), lane_f);
      env = fminf(env, __fsqrt_rn(__fdiv_rn(fmaxf(d, 0.f),
                                            (float)max(efg, 1))));
    }
    if (envp != nullptr)
      env = __fmul_rn(env, __ldg(envp + (long long)g * la + j));
    long long idx = (long long)s0g + lane;
    idx = idx < 0 ? 0 : (idx > n_clip - 1 ? n_clip - 1 : idx);
"""


def _k3_first_body(cu: str, body: str) -> str:
    """The first design's K3 kernel replaced by `body` (from its
    signature to its closing brace)."""
    start = cu.index(_K3_FIRST_HEAD)
    end = cu.index("}\n\n}  // namespace", start) + 2
    return cu[:start] + body + cu[end:]


def _k3_first_staged(cu: str) -> str:
    """The block's plan entries and their grains' metadata staged in
    shared memory, a block's worth at a time, before the grain loop."""
    return _k3_first_body(cu, _K3_FIRST_HEAD + """\
  __shared__ int sm[7][kBlock];
  const long long o = blockIdx.x;
  const int c = blockIdx.y;
  const int l = threadIdx.x;
  const float* xc = x + (long long)c * chan_stride;
  float acc = 0.f;
  const long long e0 = offsets[o], e1 = offsets[o + 1];
  for (long long p = e0; p < e1; p += kBlock) {
    const int cnt = (int)min((long long)kBlock, e1 - p);
    __syncthreads();
    if (l < cnt) {
      const int g = entries[p + l];
      sm[0][l] = g;
      for (int r = 0; r < 6; ++r) sm[r + 1][l] = meta[r * grains + g];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const int g = sm[0][i], s0g = sm[1][i], len = sm[2][i],
                sfg = sm[3][i], efg = sm[4][i], rg = sm[5][i], qg = sm[6][i];
""" + _K3_FIRST_GRAIN.replace("\n    ", "\n      ") + """\
      const float v = __ldg(xc + (long long)g * grain_stride + idx);
      acc = __fadd_rn(acc, __fmul_rn(v, env));
    }
  }
  const long long pos = o * kBlock + l;
  if (pos < out_n) out[(long long)c * out_n + pos] = acc;
}
""")


def _k3_first_channels(cu: str) -> str:
    """Both channels in one thread: the grid's second axis gone, the
    metadata and the envelope read and computed once for both."""
    head = _K3_FIRST_HEAD.replace("long long out_n) {",
                                  "long long out_n, int channels) {")
    cu = _k3_first_body(cu, head + """\
  const long long o = blockIdx.x;
  const int l = threadIdx.x;
  const int* s0 = meta;
  const int* lens = meta + grains;
  const int* sf = meta + 2 * grains;
  const int* ef = meta + 3 * grains;
  const int* r_off = meta + 4 * grains;
  const int* q = meta + 5 * grains;
  const bool pair = channels > 1;
  float acc0 = 0.f, acc1 = 0.f;
  const long long e1 = offsets[o + 1];
  for (long long e = offsets[o]; e < e1; ++e) {
    const int g = __ldg(entries + e);
    const int qg = __ldg(q + g), rg = __ldg(r_off + g), len = __ldg(lens + g);
    const int sfg = __ldg(sf + g), efg = __ldg(ef + g), s0g = __ldg(s0 + g);
""" + _K3_FIRST_GRAIN + """\
    const long long at = (long long)g * grain_stride + idx;
    acc0 = __fadd_rn(acc0, __fmul_rn(__ldg(x + at), env));
    if (pair)
      acc1 = __fadd_rn(acc1, __fmul_rn(__ldg(x + chan_stride + at), env));
  }
  const long long pos = o * kBlock + l;
  if (pos < out_n) {
    out[pos] = acc0;
    if (pair) out[out_n + pos] = acc1;
  }
}
""")
    return cu.replace("""  dim3 grid((unsigned)nblk, (unsigned)channels);
  grain_overlap_add<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      x, chan_stride, grain_stride, n_clip, meta, grains, envp, la, offsets,
      entries, out, out_n);""",
                      """  if (channels > 2) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)nblk, 1u);
  grain_overlap_add<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      x, chan_stride, grain_stride, n_clip, meta, grains, envp, la, offsets,
      entries, out, out_n, channels);""")


def _k2_first_one_read(cu: str) -> str:
    """cycle_write's increments made from the element's index instead of
    f (the division and conversions kept, the read gone)."""
    call = "  thread_incs(f, q_const, in_rate, n, i0, q);\n"
    at = cu.rindex(call)
    return cu[:at] + """\
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    q[j] = fixed_inc(__int_as_float(0x3f000000 + (int)((i0 + j) & 0xffff)),
                     in_rate);
""" + cu[at + len(call):]


SYNTH_FIRST_VARIANTS = {
    "as_shipped": [],
    # K2's write pass without its second read of f (other bits: times
    # only)
    "k2_no_second_read": [("cu", _k2_first_one_read)],
    # K2 without its six conversions through float64 (other bits)
    "k2_no_conversions": [
        ("cu", "  return __double2ll_rn((double)r * kScale);",
         "  return (long long)__float_as_uint(r);"),
        ("cu", "    out[j] = __double2float_rn((double)run * kInvScale);",
         "    out[j] = __int_as_float((int)run);")],
    # K3 with its plan entries and metadata staged (the same digest)
    "k3_staged": [("cu", _k3_first_staged)],
    # K3 with both channels in one thread (the same digest)
    "k3_channels_together": [("cu", _k3_first_channels)],
}



# ---- H2 before its redesign (commit f50131e): a block a (channel, 32
# bins), a warp a block of 256 frames walked twice
_H2_FIRST_SECOND_WALK = """\
      walk(true, [&](int r, float m, float v) {
        s2 = __dadd_rn(s2, (double)v);
        const float cyc = rem1f(__fadd_rn(
            __double2float_rn(rem1d(__dadd_rn(s2, pre))), c0));
        float sn, cs;           // sinf's and cosf's bits (the card tests)
        sincosf(__fmul_rn(cyc, two_pi), &sn, &cs);
        out[(j0 + r) * B] = make_float2(__fmul_rn(m, cs), __fmul_rn(m, sn));
      });
"""
PV_STAGES_FIRST_VARIANTS = {
    "as_shipped": [],
    # the second walk's loads, remap, increments and polar form gone, its
    # stores kept (other bits: times only)
    "no_second_walk": [("cu", _H2_FIRST_SECOND_WALK, """\
      for (int r = 0; r < (int)(j1 - j0); ++r)
        out[(j0 + r) * B] = make_float2((float)pre, (float)s2);
""")],
    # both correctly rounded divisions a product (other bits)
    "no_divisions": [
        ("cu", "__fdiv_rn(fsum, total) : 0.f;",
         "__fmul_rn(fsum, total) : 0.f;"),
        ("cu", "  return rem1f(__fdiv_rn(fv, rate));",
         "  return rem1f(__fmul_rn(fv, rate));")],
    # no sincosf: the cycle and its product by 2 pi stored (other bits)
    "no_sincos": [("cu", "        sincosf(__fmul_rn(cyc, two_pi), &sn, &cs);",
                   "        sn = cyc;\n        cs = __fmul_rn(cyc, two_pi);")],
    # the plan rows made from the frame's index, not loaded (other bits)
    "no_plan_staging": [("cu", """\
        s_li[warp][r] = (int)li[j0 + r];
        s_mix[warp][r] = mix[j0 + r];
        s_ok[warp][r] = valid[j0 + r];
""", """\
        s_li[warp][r] = (int)((j0 + r) >> 1);
        s_mix[warp][r] = 0.5f;
        s_ok[warp][r] = 1;
""")],
}

class Version(NamedTuple):
    """The substitution sets of one commit's sources (source -> variant ->
    edits), its entry points where they differ from ops/build.py's, and the
    hooks that build its arguments where they differ from today's."""
    variants: dict
    signatures: dict = {}
    scan_scratch: Optional[Callable] = None
    sqpv_forward_consts: Optional[Callable] = None
    sqpv_inverse_call: Optional[Callable] = None
    saturator_backward_call: Optional[Callable] = None
    comb_rounds: Optional[Callable] = None


VERSIONS = {
    "9089281": Version({"spv": SPV_FIRST_VARIANTS}),
    "9ad48d3": Version({"scan": SCAN_FIRST_VARIANTS,
                        "sqpv": SQPV_FIRST_VARIANTS},
                       {**SIGNATURES_9AD48D3,
                        "flan_sqpv_inverse": _SQPV_INVERSE_FIRST},
                       scan_scratch, sqpv_forward_consts, sqpv_inverse_call),
    "91765eb": Version({"sqpv": SQPV_INVERSE_FIRST_VARIANTS},
                       {"flan_sqpv_inverse": _SQPV_INVERSE_FIRST},
                       sqpv_inverse_call=sqpv_inverse_call),
    "1f4e009": Version({"kxk": KXK_FIRST_VARIANTS}),
    "4441291": Version({"saturator": SATURATOR_FIRST_VARIANTS},
                       {"flan_saturator_multinotch_backward":
                        _SATURATOR_BACKWARD_FIRST},
                       saturator_backward_call=saturator_backward_call),
    "0f06bc7": Version({"comb": COMB_FIRST_VARIANTS}, comb_rounds=(
        lambda d, reverse: _comb_warp_rounds(d, reverse))),
    "8c2a6b1": Version({"salience": SALIENCE_FIRST_VARIANTS}),
    "68f457b": Version({"synth": SYNTH_FIRST_VARIANTS}),
    "f50131e": Version({"pv_stages": PV_STAGES_FIRST_VARIANTS}),
}
