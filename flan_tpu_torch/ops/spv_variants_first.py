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
of its frames' delays; comb_rounds counts that version's rounds). `git archive
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
}
