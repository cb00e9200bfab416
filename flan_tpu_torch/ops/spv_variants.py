"""What holds the hand-written kernels: time each launch with one part taken
out.

    python -m flan_tpu_torch.ops.spv_variants [--source spv scan kxk sqpv
                                                        saturator comb
                                                        stereo_delay
                                                        salience synth
                                                        pv_stages]
                                              [--first-version COMMIT CSRC_DIR]
                                              [--variants NAME ...]
                                              [--ks K ...]

Needs one CUDA card and nvcc. For each source named (all ten by default:
csrc/spv_kernels.cu, scan_kernels.cu, the k x k kernel in scan_kernels.cu,
sqpv_kernels.cu, the saturator multinotch, the swept comb and the swept
stereo delay in sequential_kernels.cu, the salience histogram in
pv_info_kernels.cu, the cycle scan K2 and the grain overlap-add K3 in
synth_kernels.cu, H2 in pv_stage_kernels.cu) it
copies the source
and common.cuh, applies one textual substitution set per variant (stores
removed, table loads or gathers replaced by constants, cheap roundings put
back to IEEE ones, ...), builds each copy into
build/flan_tpu_torch/variants/ and prints the card's name and power limit,
then per variant the device microseconds of every launch, from
torch.profiler: one forward and one inverse call at the SPV bench shape
(30 s mono 48 kHz, 512 bins); one call of each scan map on planes of the
filter path's shapes at 600 s stereo 48 kHz (2x2: 4 planes shared by the
channels; linear: a shared; max-affine: one row); one k x k call at k = 2
(the SVF's planes), 4, 8 and 12 (or those of --ks) on phase 8's shapes (one
A for 2 rows of 28.8 M steps); one SQPV forward and one inverse at their
bench shape (10 s mono 48 kHz, 16-24000 Hz, 24 bins per
octave; a variant named forward_* runs only the forward, inverse_* only the
inverse, on the planes of the unchanged source); the saturator's forward and
backward at phase 8's shape (10 s stereo 48 kHz, order 2, 1-pole and
2-pole; backward_* runs only the backward, on the unchanged source's states),
and each forward's largest difference from the plain loop over the first
SAT_ERR_FRAMES frames, over the loop's peak; the comb's forward and
backward on phase 8's calls at 600 s stereo (bench_comb: the rounds, the
cycles a round and a digest of the outputs); the stereo delay's forward
and backward (each narrow and wide) on rounds of 32 steps, on reads a
constant 48 to 240 frames back (the regimes' crossovers) and on phase 9's
long and 5-40 ms sweeps at 600 s (bench_stereo_delay: the rounds, the
cycles a round, the chain alone, one block's copy rate and the wide
backward's parts among the variants); the salience histogram on phase
10's 600 s call (bench_salience: the float64 log2, the warp match, the
spread); K2 on phase 11's two 600 s waveform calls and K3 on its
granulate, psola and modded texture calls (bench_synth: K2's
conversions, look-back, tile, division, remainder, word ordering and
memory hints; K3's unrolling, run, channels a block and shared list); H2
on the first chunk of the 2x stretch of 12 s, streamed (4,096 frames, the
remap fused), the same chunk's last cycle alone and pv_inverse's first
2,048 frames (bench_pv_stages: the divisions, stores, batches, cluster
size, bins a block and parts taken out; the parent's second walk,
divisions, sincosf and plan staging under --first-version f50131e). A
variant
computes something
else than the kernel does: only its times mean anything, apart from that
error where a variant only rounds in another order.

With --first-version the sources are read from CSRC_DIR instead, which must
hold commit COMMIT's, and the variants written for that commit are applied
(ops/spv_variants_first.py VERSIONS), for the sources it has sets for: the
diagnosis each redesign started from. A substitution whose text is not
found as often as expected (once, unless it says otherwise) fails: the
variants follow the source they were written for.
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
SCAN_FRAMES, SCAN_ROWS = 28_800_000, 2      # 600 s stereo at 48 kHz
SQPV_SECONDS, SQPV_BAND, SQPV_BPO = 10.0, (16.0, 24000.0), 24.0
SAT_SECONDS, SAT_ORDER = 10.0, 2      # phase 8's saturator calls
SAT_ERR_FRAMES = 2000   # the saturator forward's frames against its loop

# variant -> [(file, old, new[, count])]; file is "cu" or "cuh", count how
# often old must occur (1 unless given)
_STORES = """        store_vec_streaming<VEC>(out_mag + b0[k], m);
        store_vec_streaming<VEC>(out_freq + b0[k], f);"""
SPV_VARIANTS = {
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

# ---- the scan: one pass with look-back
_SCAN_FILL = """  for (int p = 0; p < Op::kMap; ++p)
    for (int k = 0; k < Op::kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      sm[p * Tile<Op>::kPitch + padded(i)] =
          0.999f * Op::identity(p) + 1e-9f * (float)i;
    }
"""
_SCAN_LOAD = "  load_tile<Op>(args, row, base, n, sm);\n  copies_done();\n"
_SCAN_HALF_TILES = [("cu", "kPerThread = 8, kBlocks = 4;",
                     "kPerThread = 4, kBlocks = 4;"),
                    ("cu", "kPerThread = 16,", "kPerThread = 8,", 2)]
SCAN_VARIANTS = {
    "as_shipped": [],
    "no_look_back": [
        ("cu", "  const int count = first ? kWindow : r;",
         "  const int count = 0 * (first ? kWindow : r);")],
    "no_stores": [
        ("cu", "      if (g < n) dst[g] = sm[q * Tile<Op>::kPitch + padded(i)];",
         "      if (g < n && sm[q * Tile<Op>::kPitch + padded(i)] == 123.456f)"
         " dst[g] = 0.f;")],
    "no_reads": [("cu", _SCAN_LOAD, _SCAN_FILL + "  __syncthreads();\n")],
    "no_reads_no_stores_no_look_back": [
        ("cu", _SCAN_LOAD, _SCAN_FILL + "  __syncthreads();\n"),
        ("cu", "      if (g < n) dst[g] = sm[q * Tile<Op>::kPitch + padded(i)];",
         "      if (g < n && sm[q * Tile<Op>::kPitch + padded(i)] == 123.456f)"
         " dst[g] = 0.f;"),
        ("cu", "  const int count = first ? kWindow : r;",
         "  const int count = 0 * (first ? kWindow : r);")],
    "row_major_tickets": [
        ("cu", "  const int tile = (int)(ticket_sm / (unsigned)rows);\n"
         "  const long long row = ticket_sm - (unsigned)tile * (unsigned)rows;",
         "  const long long row = ticket_sm / (unsigned)ntiles;\n"
         "  const int tile = (int)(ticket_sm - (unsigned)row * "
         "(unsigned)ntiles);")],
    "half_tiles": _SCAN_HALF_TILES,
}

# ---- the k x k map's chunked kernel (scan_kernels.cu scan_kxk_chunked)
_KXK_NO_CARRY = [
    ("cu", "  if (r == kKxKWindow - 1) {", "  if (r == -1) {"),
    ("cu", "  if (warp == 0) {\n    for (;;) {",
     "  if (warp == -1) {\n    for (;;) {"),
    ("cu", "  const long long from_tile = from_sm[0];",
     "  const long long from_tile = first - 1;"),
    ("cu", "    if (warp == 0) {\n      long long j = bw - 1;",
     "    if (warp == -1) {\n      long long j = bw - 1;"),
    ("cu", "    const long long from = from_sm[1];",
     "    const long long from = -1;"),
    ("cu", "    apply_run(wins, ww, from + 1, bw);\n", ""),
    ("cu", "  apply_run(tiles, tw, from_tile + 1, tile);\n", "")]
_KXK_STAGE = ("    stage_plane(sm + (long long)p * L, src + base, base, n, "
              "L, fill, lane);")
_KXK_STORE = ("    store_plane(y + ((long long)(row0 + r) * k + q) * n + "
              "base,")
_KXK_NO_LOADS = [("cu", _KXK_STAGE, "    for (int j = lane; j < L; j += 32)\n"
                  "      sm[(long long)p * L + j] = fill + 1e-9f * (float)j;")]
_KXK_NO_STORES = [("cu", _KXK_STORE,
                   "    if (bs[0] == 123.456f)\n" + _KXK_STORE)]
KXK_VARIANTS = {
    "as_shipped": [],
    "no_carry": _KXK_NO_CARRY,
    "no_subruns": [
        ("cu", "task < (kWide ? 0 : S * per_sub);", "task < 0;")],
    "no_prefixes": [
        ("cu", "  for (int s = 1; s < S; ++s) {",
         "  for (int s = 1; s < 0; ++s) {")],
    "no_stepping": [
        ("cu", "task < (kWide ? 0 : S * g);", "task < 0;")],
    "no_loads": _KXK_NO_LOADS,
    "no_stores": _KXK_NO_STORES,
    "compute_only": _KXK_NO_CARRY + _KXK_NO_LOADS + _KXK_NO_STORES,
    # the tile's size: half and twice the steps (twice: 1 block a
    # multiprocessor above k = 5), and 8 sub-runs at most
    "half_tiles": [
        ("cu", "int L = pow2_floor(24576 / per);",
         "int L = pow2_floor(12288 / per);")],
    "double_tiles": [
        ("cu", "int L = pow2_floor(24576 / per);",
         "int L = pow2_floor(49152 / per);"),
        ("cu", "L = L < 8 ? 8 : (L > 512 ? 512 : L);",
         "L = L < 8 ? 8 : (L > 1024 ? 1024 : L);"),
        ("cu", "KC <= 5 ? 4 : (KC <= 16 ? 2 : 1))", "KC <= 5 ? 2 : 1)")],
    "subruns8": [("cu", "S = S > 16 ? 16 : S;", "S = S > 8 ? 8 : S;")],
    # k = 3 to 16 on the guarded instantiation of k <= 16 in place of
    # their own
    "generic16": [("cu", "return launch_kxk_chunked<K, true>(",
                   "return launch_kxk_chunked<16, false>(")],
    # k = 2 (the SVF's map) on the chunked kernel instead of the one pass
    "k2_chunked": [
        ("cu", "    case 2: return launch_kxk<2>(A, a_row, b, y, y0, w, rows, "
         "n, s);", "    case 2: return launch_kxk_chunked<2, true>(\n"
         "        A, a_row, b, y, y0, w, k, rows, n, s);"),
        ("cu", "  if (k == 2)\n    return 8 * scratch_words<AffineKxK<2>>("
         "rows, tiles_of<AffineKxK<2>>(n));\n  if (k < 3 ||",
         "  if (k < 2 ||")],
}
# the SVF's map (phase 6's 2 x 2 planes) and phase 8's multinotch maps;
# --ks names others
KXK_KS = (2, 4, 8, 12)

# ---- B3: tile totals, a chunked carry, an epilogue of whole rows
_SQPV_CONSTANT_TABLE = [
    ("cu", "  return __ldg(row + l);",
     "  return make_float2(0.6f + 1e-9f * (float)l, 0.8f + 0.f * row[0].x);")]
_SQPV_NO_GATHERS = [
    ("cu", "    for (int j = 0; j < kBatch; ++j) v[j] = __ldg(xc + s + j);",
     "    for (int j = 0; j < kBatch; ++j) v[j] = 0.25f + 1e-9f * "
     "(float)(s + j);"),
    ("cu", "(s + j >= 0 && s + j < n) ? __ldg(xc + s + j) : 0.f;",
     "(s + j >= 0 && s + j < n) ? 0.125f + 1e-9f * (float)(s + j) : 0.f;")]
_SQPV_PASS_THROUGH = [
    ("cu", "        const float phase = atan2_poly_fast(him, hre);",
     "        const float phase = him + hre;"),
    ("cu", "          d = d - kTwoPi * rintf(d * kInvTwoPi);\n", ""),
    ("cu", "__stcs(mp + at, sqrtf(hre * hre + him * him));",
     "__stcs(mp + at, hre * hre + him * him);"),
    ("cu", "__stcs(pp + at, log2f(fmaxf(fabsf(f), 1e-12f)));",
     "__stcs(pp + at, f);")]
_SQPV_NO_STORES = [
    ("cu", "  unsigned char* sp = positive + row0 * nbins + b;\n",
     "  unsigned char* sp = positive + row0 * nbins + b;\n"
     "  float sink = 0.f;\n"),
    ("cu", "          __stcs(mp + at, ", "          sink += (float)at + ("),
    ("cu", "          __stcs(pp + at, ", "          sink += ("),
    ("cu", "          __stcs(sp + at, ", "          sink += (float)("),
    ("cu", "        prev = phase;\n      }\n    }\n  }\n}",
     "        prev = phase;\n      }\n    }\n  }\n"
     "  if (sink == 123.456f) mp[0] = sink + (float)(sp - positive) + pp[0];"
     "\n}")]
_B4_NO_SINCOS = [
    ("cu", "  sincospif((float)(int)cycles * 4.656612873077392578125e-10f, "
     "sn, cs);",
     "  *sn = *cs = (float)(int)cycles * 4.656612873077392578125e-10f;")]


def _look_back_first(cu: str) -> str:
    """B4 with its look-back moved before the pass of sines and cosines."""
    a = cu.index("  // mag cos and mag sin of the cycles within the tile")
    b = cu.index("  // each bin's cycles before the tile: its prefix")
    c = cu.index("  // cos(carry + local) = cos carry cos local")
    return cu[:a] + cu[b:c] + cu[a:b] + cu[c:]


_B4_NO_INCREMENT_MATH = [
    ("cu", "  const float q = exp2f(p) / sample_rate;\n"
     "  const unsigned u =\n"
     "      (unsigned)__float2ll_rn((q - rintf(q)) * 4294967296.f);",
     "  const unsigned u = __float_as_uint(p) + (unsigned)sample_rate;")]
SQPV_VARIANTS = {
    "as_shipped": [],
    "forward_no_stores": _SQPV_NO_STORES,
    # the store side: without the byte plane, with it alone, with plain
    # instead of streaming stores, and with rows of 256 (the tool gives that
    # variant planes of 256 bins a row, so that every row starts on 1 KB)
    "forward_no_byte_stores": _SQPV_NO_STORES[:1] + _SQPV_NO_STORES[3:],
    "forward_only_byte_stores": _SQPV_NO_STORES[:3] + _SQPV_NO_STORES[4:],
    "forward_plain_stores": [("cu", "__stcs(mp + at, ", "*(mp + at) = ("),
                             ("cu", "__stcs(pp + at, ", "*(pp + at) = ("),
                             ("cu", "__stcs(sp + at, ", "*(sp + at) = (")],
    "forward_rows_of_256": [
        ("cu", "  float* mp = mag + row0 * nbins + b;",
         "  float* mp = mag + row0 * 256 + b;"),
        ("cu", "  float* pp = pitch + row0 * nbins + b;",
         "  float* pp = pitch + row0 * 256 + b;"),
        ("cu", "  unsigned char* sp = positive + row0 * nbins + b;",
         "  unsigned char* sp = positive + row0 * 256 + b;"),
        ("cu", "          const long long at = (long long)i * nbins;",
         "          const long long at = (long long)i * 256;")],
    # every store into the planes' first 16 MB, which stay in L2: what is
    # left is the multiprocessors' side of the stores
    "forward_stores_stay_in_l2": [
        ("cu", "          const long long at = (long long)i * nbins;",
         "          const long long at = (long long)i * nbins - "
         "(row0 / 4096) * 4096 * nbins;")],
    "forward_totals_3_blocks": [
        ("cu", "  sqpv_fwd_tile_totals<<<grid, kFwdThreads, 0, s>>>(",
         "  cudaFuncSetAttribute(sqpv_fwd_tile_totals, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, 72 * 1024);\n"
         "  sqpv_fwd_tile_totals<<<grid, kFwdThreads, 72 * 1024, s>>>(")],
    "forward_3_blocks": [
        ("cu", "  sqpv_fwd_epilogue<<<grid, kFwdThreads, 0, s>>>(",
         "  cudaFuncSetAttribute(sqpv_fwd_epilogue, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, 72 * 1024);\n"
         "  sqpv_fwd_epilogue<<<grid, kFwdThreads, 72 * 1024, s>>>(")],
    "forward_5_blocks": [
        ("cu", "__global__ void __launch_bounds__(kFwdThreads)\n"
         "sqpv_fwd_epilogue(",
         "__global__ void __launch_bounds__(kFwdThreads, 5)\n"
         "sqpv_fwd_epilogue(")],
    "forward_batches_of_4": [("cu", "constexpr int kBatch = 8;",
                              "constexpr int kBatch = 4;")],
    "forward_batches_of_16": [("cu", "constexpr int kBatch = 8;",
                               "constexpr int kBatch = 16;")],
    "forward_constant_table": _SQPV_CONSTANT_TABLE,
    "forward_no_gathers": _SQPV_NO_GATHERS,
    "forward_ieee_atan2": [
        ("cu", "        const float phase = atan2_poly_fast(him, hre);",
         "        const float phase = atan2_poly(him, hre);")],
    "forward_ieee_wrap": [("cu", "rintf(d * kInvTwoPi)",
                           "rintf(d / kTwoPi)")],
    "forward_fast_sqrt": [
        ("cu", "__stcs(mp + at, sqrtf(hre * hre + him * him));",
         "{ float r_; asm(\"sqrt.approx.ftz.f32 %0, %1;\" : \"=f\"(r_) : "
         "\"f\"(hre * hre + him * him)); __stcs(mp + at, r_); }")],
    "forward_ieee_math": [
        ("cu", "        const float phase = atan2_poly_fast(him, hre);",
         "        const float phase = atan2_poly(him, hre);"),
        ("cu", "rintf(d * kInvTwoPi)", "rintf(d / kTwoPi)")],
    "forward_pass_through": _SQPV_PASS_THROUGH,
    "forward_constant_table_no_gathers": (_SQPV_CONSTANT_TABLE
                                          + _SQPV_NO_GATHERS),
    "forward_constant_table_no_gathers_pass_through": (
        _SQPV_CONSTANT_TABLE + _SQPV_NO_GATHERS + _SQPV_PASS_THROUGH),
    "forward_constant_table_no_gathers_pass_through_no_stores": (
        _SQPV_CONSTANT_TABLE + _SQPV_NO_GATHERS + _SQPV_PASS_THROUGH
        + _SQPV_NO_STORES),
    # B4, one pass: the staged bytes per block (tile frames: 64 KB holds 28
    # frames of 254 bins, 3 blocks a multiprocessor), the look-back (none,
    # or before the sines and cosines), the sines and cosines, the
    # increments' math
    **{f"inverse_stage_{kb}k": [
        ("cu", "constexpr int kInvStageBytes = 64 * 1024;",
         f"constexpr int kInvStageBytes = {kb} * 1024;")]
       for kb in (32, 48, 96, 144)},
    "inverse_no_look_back": [
        ("cu", "      const int found = look_back_tiles(desc, tile, nbins);",
         "      const int found = tile - 1;"),
        ("cu", "      before = gather_prefix(desc + b, tile, found_sm, nbins);",
         "      before = 0u * found_sm;")],
    "inverse_gather_1": [("cu", "constexpr int kGather = 8;",
                          "constexpr int kGather = 1;")],
    "inverse_no_sincos": _B4_NO_SINCOS,
    "inverse_no_increment_math": _B4_NO_INCREMENT_MATH,
    "inverse_loads_only": _B4_NO_SINCOS + _B4_NO_INCREMENT_MATH,
    # the look-back right after the increments, before the sines and cosines
    "inverse_look_back_first": [("cu", _look_back_first)],
}

# ---- the saturator multinotch (sequential_kernels.cu): what holds the
# forward's chain (the Newton iteration's tanhf and division, the order of
# its operations) and the backward's passes (timed apart by the profiler)
_SAT_NEWTON = ("    const float t = tanhf(f.k * (f.gn * u + msum));\n"
               "    float den = inv * (1.f - t * t) * f.k * f.gn - 1.f;\n")
_SAT_DIVISION = ("      inexact |= !div_fast_exact(a, den);\n"
                 "      u = u - div_fast(a, den);\n")
SATURATOR_VARIANTS = {
    "as_shipped": [],
    # the division with the compiler's range check and slow path
    "forward_checked_division": [
        ("cu", _SAT_DIVISION, "      u = u - a / den;\n")],
    # the fast path alone, with no flag (the division before the flag)
    "forward_unchecked_division": [
        ("cu", _SAT_DIVISION, "      u = u - div_fast(a, den);\n")],
    "forward_approx_division": [
        ("cu", _SAT_DIVISION, "      u = u - __fdividef(a, den);\n")],
    # the out-of-range flag beside the chain with no rerun behind it
    "forward_flag_no_rerun": [
        ("cu", "  if (inexact) xbar = newton<true>(f, prev, msum, inv, tr, "
         "inexact);\n",
         "  if (inexact && xbar == 123.456f) xbar = 0.f;\n")],
    "forward_no_tanhf": [
        ("cu", "    const float t = tanhf(f.k * (f.gn * u + msum));",
         "    const float t = 0.5f * (f.k * (f.gn * u + msum));")],
    # the step's chain alone: no loads, no shuffles, each lane's first
    # frame's terms for every step
    "forward_chain_only": [
        ("cu", "    fetch(base + 32 + lane);     // the next 32 frames, read "
         "during these\n", ""),
        ("cu", "    FrameTerms<kTwoPole, kOrder> cur = bcast_frame(mine, 0);",
         "    FrameTerms<kTwoPole, kOrder> cur = mine;"),
        ("cu", "      const FrameTerms<kTwoPole, kOrder> next =\n"
         "          bcast_frame(mine, (j + 1) & 31);",
         "      const FrameTerms<kTwoPole, kOrder> next = mine;")],
    # the 1-pole's msum 2 / (1 + g) in the reference's order (filters.py:578,
    # msum * 2 / (1 + g)) in place of msum (2 / (1 + g)): a division on the
    # chain
    "forward_reference_order": [
        ("cu", "  if (!kTwoPole) msum = msum * f.c;",
         "  if (!kTwoPole) msum = msum * 2.f / (1.f + f.g);"),
        ("cu", "  o.g = kTwoPole ? bcast(f.g, j) : 0.f;",
         "  o.g = bcast(f.g, j);")],
    # k G^order and k msum taken out of each iteration: t = tanh(kgn u +
    # kms), den = (1 - t^2) (inv kgn) - 1 (another rounding)
    "forward_reassociated": [
        ("cu", _SAT_NEWTON,
         "    const float t = tanhf(kgn * u + kms);\n"
         "    float den = (1.f - t * t) * ikgn - 1.f;\n"),
        ("cu", "  float u = prev;\n#pragma unroll\n  for (int it = 0; "
         "it < 8; ++it) {",
         "  float u = prev;\n  const float kgn = f.k * f.gn, kms = f.k * "
         "msum, ikgn = inv * kgn;\n#pragma unroll\n  for (int it = 0; "
         "it < 8; ++it) {")],
}


def apply_variant(texts: dict, edits) -> dict:
    """texts with every edit applied: (file, old, new[, count]) replaces a
    text, (file, function) rewrites the file's text."""
    texts = dict(texts)
    for which, old, *rest in edits:
        if callable(old):
            texts[which] = old(texts[which])
            continue
        new, *count = rest
        if texts[which].count(old) != (count[0] if count else 1):
            raise ValueError(f"substitution not found as often as expected: "
                             f"{old!r}")
        texts[which] = texts[which].replace(old, new)
    return texts


def source_file(source: str) -> str:
    """The csrc file a source's variants edit (the k x k kernel's are in
    the scans' file, the saturator's in the sequential kernels')."""
    return {"kxk": "scan", "saturator": "sequential",
            "comb": "sequential", "stereo_delay": "sequential",
            "salience": "pv_info",
            "pv_stages": "pv_stage"}.get(source, source) + "_kernels.cu"


def build_variants(csrc: Path, source: str, variants: dict,
                   signatures: dict) -> dict:
    """name -> ctypes library of csrc/<source>_kernels.cu, every variant
    compiled at once."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found")
    cu = source_file(source)
    texts = {"cu": (csrc / cu).read_text(),
             "cuh": (csrc / "common.cuh").read_text()}
    # every substitution before the first compiler starts: a variant that
    # no longer fits its source fails here
    edited = {name: apply_variant(texts, edits)
              for name, edits in variants.items()}
    procs = {}
    for name, out in edited.items():
        d = build.BUILD_DIR / "variants" / source / name
        d.mkdir(parents=True, exist_ok=True)
        (d / cu).write_text(out["cu"])
        (d / "common.cuh").write_text(out["cuh"])
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = subprocess.Popen(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), *flags, "-shared", "-o",
             str(d / "lib.so"), str(d / cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    libs = {}
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(build.BUILD_DIR / "variants" / source / name
                              / "lib.so"))
        for fn, argtypes in signatures.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
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


def event_us(fn, reps: int = 3) -> float:
    """Device microseconds per call of fn by CUDA events, after one call:
    for a call of one long kernel (the profiler drops some of those)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) * 1e3 / reps, 1)


def report(source: str, name: str, times: dict) -> None:
    print(json.dumps({"source": source, "variant": name,
                      "us_per_launch": times}), flush=True)


def bench_spv(libs: dict, first) -> None:
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
        report("spv", name, times)


def scan_bench_planes(dev) -> dict:
    """kind -> (planes as (tensor, row stride), rows): random decays and
    inputs of the filter path's shapes, made on the card."""
    n, rows = SCAN_FRAMES, SCAN_ROWS
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(r, lo=0.0, hi=1.0):
        return torch.empty((r, n), device=dev).uniform_(lo, hi, generator=gen)

    a = rand(1, 0.5, 0.99999)
    th = rand(1, 0.0, 0.2)
    return {
        0: ([(a, 0), (rand(rows, -1.0), n)], rows),
        1: ([(rand(1, -1.0), n), (a, n), (rand(1, -0.01, 0.01), n)], 1),
        2: ([(a * th.cos(), 0), (-a * th.sin(), 0), (a * th.sin(), 0),
             (a * th.cos(), 0), (rand(rows, -1.0), n), (rand(rows, -1.0), n)],
            rows)}


def bench_scan(libs: dict, first) -> None:
    dev = torch.device("cuda", 0)
    n = SCAN_FRAMES
    cases = scan_bench_planes(dev)
    stream = torch.cuda.current_stream().cuda_stream
    arr = ctypes.c_longlong * 6
    for name, lib in libs.items():
        if not first:
            lib.flan_scan_scratch_bytes.argtypes = [build._i, build._i,
                                                    build._ll]
            lib.flan_scan_scratch_bytes.restype = ctypes.c_longlong
        times = {}
        for kind, (planes, rows) in cases.items():
            states = 2 if kind == 2 else 1
            outs = [torch.empty((rows, n), device=dev) for _ in range(states)]
            y0 = torch.zeros((rows, states), device=dev)
            if first:
                scratch = first.scan_scratch(lib, kind, rows, n, len(planes),
                                             states, dev)
            else:
                scratch = [torch.empty(
                    lib.flan_scan_scratch_bytes(kind, rows, n) // 8,
                    dtype=torch.int64, device=dev)]

            def call():
                build.raise_on(lib.flan_scan(
                    kind, arr(*(t.data_ptr() for t, _ in planes)),
                    arr(*(s for _, s in planes)),
                    arr(*(o.data_ptr() for o in outs)), y0.data_ptr(),
                    *(s.data_ptr() for s in scratch), rows, n, stream), name)

            times[("linear", "max_affine", "affine2x2")[kind]] = \
                launch_times(call)
            del outs, scratch
        report("scan", name, times)


def bench_kxk(libs: dict, first) -> None:
    """One call of the k x k kernel per variant at each of KXK_KS on planes
    of phase 8's shapes (A [1, k*k, N] shared by 2 rows, b [2, k, N]; a
    decay of 0.5 to 0.99999 on the diagonal, weak coupling off it; at k = 2
    the SVF's, a decay times a rotation of up to 0.2 rad, as
    scan_bench_planes makes the 2 x 2 kind's)."""
    dev = torch.device("cuda", 0)
    n, rows = SCAN_FRAMES, SCAN_ROWS
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    times = {name: {} for name in libs}
    for k in KXK_KS:
        A = torch.empty((1, k, k, n), device=dev).uniform_(
            -0.3 / k, 0.3 / k, generator=gen)
        A.diagonal(dim1=1, dim2=2).uniform_(0.5, 0.99999, generator=gen)
        if k == 2:
            a = torch.empty(n, device=dev).uniform_(0.5, 0.99999,
                                                   generator=gen)
            th = torch.empty(n, device=dev).uniform_(0.0, 0.2, generator=gen)
            A = torch.stack([a * th.cos(), -a * th.sin(), a * th.sin(),
                             a * th.cos()])[None]
        A = A.reshape(1, k * k, n)
        b = torch.empty((rows, k, n), device=dev).uniform_(-1.0, 1.0,
                                                           generator=gen)
        y = torch.empty_like(b)
        y0 = torch.zeros((rows, k), device=dev)
        for name, lib in libs.items():
            lib.flan_scan_kxk_scratch_bytes.argtypes = [build._i, build._i,
                                                        build._ll, build._i]
            lib.flan_scan_kxk_scratch_bytes.restype = ctypes.c_longlong
            scratch = torch.empty(
                lib.flan_scan_kxk_scratch_bytes(k, rows, n, 1) // 8,
                dtype=torch.int64, device=dev)

            def call():
                build.raise_on(lib.flan_scan_kxk(
                    k, A.data_ptr(), 0, b.data_ptr(), y.data_ptr(),
                    y0.data_ptr(), scratch.data_ptr(), rows, n, stream), name)
            times[name][f"k{k}"] = launch_times(call)
            del scratch
        del A, b, y
    for name in libs:
        report("kxk", name, times[name])


def sqpv_inverse_call(lib, planes, out, geo, stream):
    """A call of this tree's SQPV inverse entry point on planes [1, N, B]."""
    from flan_tpu_torch.ops import sqpv_kernels
    _, n, nb = planes[0].shape
    dev = planes[0].device
    offsets = sqpv_kernels.inverse_offsets(
        geo.sample_rate, SQPV_BPO, SQPV_BAND, dev)
    lib.flan_sqpv_inverse_scratch_bytes.argtypes = [build._i, build._ll,
                                                    build._i]
    lib.flan_sqpv_inverse_scratch_bytes.restype = ctypes.c_longlong
    scratch = torch.empty(lib.flan_sqpv_inverse_scratch_bytes(1, n, nb) // 8,
                          dtype=torch.int64, device=dev)

    def call():
        build.raise_on(lib.flan_sqpv_inverse(
            *(t.data_ptr() for t in planes), offsets.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), 1, n, nb,
            float(geo.sample_rate), stream), "sqpv_inverse")
    return call


def bench_sqpv(libs: dict, first) -> None:
    from flan_tpu_torch.ops import sqpv_kernels
    from flan_tpu_torch.sqpv.transform import cq_geometry
    dev = torch.device("cuda", 0)
    n = int(SQPV_SECONDS * SR)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    x = torch.from_numpy((0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 *
                          rng.standard_normal(n)).astype(np.float32)[None]
                         ).to(dev)
    geo = cq_geometry(SR, SQPV_BPO, SQPV_BAND)
    nb, w0 = geo.nbins, geo.w0
    fr, fi = np.float32(geo.fiddle.real), np.float32(geo.fiddle.imag)
    # room for rows of 256 bins, which one variant writes
    mag = torch.empty((1, n, max(nb, 256)), device=dev)
    pitch = torch.empty_like(mag)
    positive = torch.empty(mag.shape, dtype=torch.bool, device=dev)
    out = torch.empty((1, n), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if first and first.sqpv_forward_consts:
        consts, tot = first.sqpv_forward_consts(geo, n, dev)
    else:
        consts = sqpv_kernels.forward_consts(SR, SQPV_BPO, SQPV_BAND, dev)
        tot = sqpv_kernels.forward_scratch(1, n, geo, dev)
    inverse_call = (first.sqpv_inverse_call if first and
                    first.sqpv_inverse_call else sqpv_inverse_call)
    planes = None
    for name, lib in libs.items():
        def forward():
            build.raise_on(lib.flan_sqpv_forward(
                x.data_ptr(), *(c.data_ptr() for c in consts), tot.data_ptr(),
                mag.data_ptr(), pitch.data_ptr(), positive.data_ptr(), 1, n,
                nb, w0, float(fr), float(fi), float(SR), stream), name)

        if planes is None:      # the unchanged source's planes feed inverses
            forward()
            torch.cuda.synchronize()
            planes = tuple(p.flatten()[:n * nb].view(1, n, nb).clone()
                           for p in (mag, pitch, positive))
        times = {}
        if not name.startswith("inverse"):
            times["forward"] = launch_times(forward)
        if not name.startswith("forward"):
            times["inverse"] = launch_times(
                inverse_call(lib, planes, out, geo, stream))
        report("sqpv", name, times)


def saturator_bench_inputs(two_pole: bool, dev):
    """x [2, N] and the kernel-order planes (g, G, G_f or R, d or None, k,
    mix) of phase 8's saturator calls at SAT_SECONDS stereo: a cutoff swept
    300 -> 600 Hz, feedback 0.6 (1-pole) or damping 0.4 and feedback 0.7
    (2-pole), mix 0.5."""
    n = int(SAT_SECONDS * SR)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    tone = (0.4 * np.sin(2 * np.pi * 220.0 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)
    x = torch.from_numpy(np.stack([tone, -0.5 * tone])).to(dev)
    tt = torch.from_numpy(t).to(dev) / SAT_SECONDS
    g = torch.tan((np.pi / SR) * (300.0 + 300.0 * tt))
    mix = torch.full_like(g, 0.5)
    if two_pole:
        R = torch.full_like(g, 0.4)
        d = 1.0 / (1.0 + 2.0 * R * g + g * g)
        G = d * (1.0 - 2.0 * R * g + g * g)
        return x, (g, G, R, d, torch.full_like(g, 0.7), mix)
    return x, (g, (g - 1.0) / (g + 1.0), g / (1.0 + g), None,
               torch.full_like(g, 0.6), mix)


def saturator_backward_call(lib, args, stream):
    """A call of this tree's saturator backward on a variant's library, in
    one chunk as ops/sequential_kernels.py saturator_backward_cuda runs it:
    its per-step maps, the k x k scan of the main library in reverse time,
    its read-outs."""
    from flan_tpu_torch.ops import scan_kernels
    two_pole, gy, x, y, states, planes, gx, gp, order, inv = args
    c, n = x.shape
    k = states.shape[1] + 1
    lib.flan_saturator_backward_work_floats.argtypes = [build._i, build._i,
                                                        build._i, build._ll]
    lib.flan_saturator_backward_work_floats.restype = ctypes.c_longlong
    work = torch.empty(lib.flan_saturator_backward_work_floats(
        int(two_pole), order, c, n), device=x.device)
    work_ptr = work.data_ptr() if work.numel() else None
    A = torch.empty((c, k * k, n), device=x.device)
    b = torch.empty((c, k, n), device=x.device)
    carry = torch.zeros((c, k), device=x.device)
    head = (int(two_pole), gy.data_ptr(), x.data_ptr(), y.data_ptr(),
            states.data_ptr()) + tuple(None if p is None else p.data_ptr()
                                       for p in planes)

    def call():
        build.raise_on(lib.flan_saturator_backward_maps(
            *head, A.data_ptr(), b.data_ptr(), work_ptr, c, n, 0, n, order,
            inv, stream), "saturator_backward_maps")
        lam = scan_kernels.scan_affine_kxk(A, b, carry)
        build.raise_on(lib.flan_saturator_backward_readout(
            *head, lam.data_ptr(), carry.data_ptr(), gx.data_ptr(),
            gp.data_ptr(), work_ptr, c, n, 0, n, order, inv, stream),
            "saturator_backward_readout")
    return call


def saturator_forward_err(lib, two_pole, x, planes, stream) -> float:
    """A variant's forward over the first SAT_ERR_FRAMES frames against the
    plain loop (ops/sequential_kernels.py) on the card: its largest
    difference over the loop's peak."""
    from flan_tpu_torch.ops import sequential_kernels
    m = SAT_ERR_FRAMES
    xm = x[:, :m].contiguous()
    pm = tuple(None if p is None else p[:m].contiguous() for p in planes)
    y = torch.empty_like(xm)
    build.raise_on(lib.flan_saturator_multinotch(
        int(two_pole), xm.data_ptr(),
        *(None if p is None else p.data_ptr() for p in pm), y.data_ptr(),
        None, xm.shape[0], m, SAT_ORDER, 1.0, stream), "saturator")
    g, G, a, d, k, mix = pm      # the kernel's order -> the loop's
    if two_pole:
        want = sequential_kernels.saturator_2pole_ref(
            xm, g, G, k, mix, a, d, 1.0, SAT_ORDER)
    else:
        want = sequential_kernels.saturator_1pole_ref(
            xm, g, a, G, k, mix, 1.0, SAT_ORDER)
    return float((y - want).abs().max() / want.abs().max())


def bench_saturator(libs: dict, first) -> None:
    """The saturator's forward (no states kept, as the filter calls it; by
    CUDA events, one kernel a call) and its backward (each kernel by the
    profiler) at phase 8's shape: SAT_SECONDS stereo, order SAT_ORDER,
    1-pole and 2-pole, inv 1, and each forward against its plain loop
    (saturator_forward_err). The backward runs on the states and output of
    the unchanged source's forward. A variant named forward_* runs only the
    forward, backward_* only the backward."""
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    backward_call = (first.saturator_backward_call if first
                     else saturator_backward_call)
    times = {name: {} for name in libs}
    errs = {name: {} for name in libs}
    for two_pole in (False, True):
        pole = "2pole" if two_pole else "1pole"
        x, planes = saturator_bench_inputs(two_pole, dev)
        c, n = x.shape
        ns = (2 if two_pole else 1) * SAT_ORDER
        y = torch.empty_like(x)
        states = torch.empty((c, ns, n), device=dev)
        gy = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (c, n)).astype(np.float32)).to(dev)
        gx = torch.empty_like(x)
        gp = torch.empty((c, 6 if two_pole else 5, n), device=dev)
        kept = None
        for name, lib in libs.items():
            def forward(out=None, st=None):
                build.raise_on(lib.flan_saturator_multinotch(
                    int(two_pole), x.data_ptr(),
                    *(None if p is None else p.data_ptr() for p in planes),
                    (y if out is None else out).data_ptr(),
                    None if st is None else st.data_ptr(), c, n, SAT_ORDER,
                    1.0, stream), name)

            if kept is None:    # the unchanged source's states and output
                y_kept = torch.empty_like(x)
                forward(y_kept, states)
                torch.cuda.synchronize()
                kept = (y_kept, states)
            if not name.startswith("backward"):
                times[name][f"forward_{pole}"] = event_us(forward)
                errs[name][f"forward_{pole}"] = saturator_forward_err(
                    lib, two_pole, x, planes, stream)
            if not name.startswith("forward"):
                times[name][f"backward_{pole}"] = launch_times(backward_call(
                    lib, (two_pole, gy, x, kept[0], kept[1], planes, gx, gp,
                          SAT_ORDER, 1.0), stream))
        del x, planes, y, states, gy, gx, gp, kept
    for name in libs:
        report("saturator", name, times[name])
        if errs[name]:
            print(json.dumps({"source": "saturator", "variant": name,
                              "err_rel_vs_loop": errs[name],
                              "frames": SAT_ERR_FRAMES}), flush=True)


# ---- the swept comb (sequential_kernels.cu): phase 8's two calls
COMB_SECONDS = 600.0
_COMB_NO_STORES = [
    ("cu", "          o[off + lane] = __fmaf_rn(c1, ud, __fmul_rn(a, u));\n"
     "          o[2 * TP + off + lane] = u;\n", ""),
    ("cu", "          o[off - lane] = g;\n", "")]
# the chain alone: rounds of 32 steps on the tile's first inputs, no round
# starts, inputs or outputs read or written, no match: one dependent
# step's latency (chip_smoke.py's comb bound)
_COMB_CHAIN = _COMB_NO_STORES + [
    ("cu", "        int off = 0, noff = nq[0];",
     "        int off = 0, noff = kCombWidth;"),
    ("cu", "        int off = tl - 1, noff = nq[off];",
     "        int off = tl - 1, noff = off - kCombWidth;"),
    ("cu", "          const int nnoff = nq[noff];\n"
     "          const float4 nv = q[noff + lane];\n",
     "          const int nnoff = noff + kCombWidth;\n"
     "          const float4 nv = v;\n"),
    ("cu", "          const int nnoff = nq[noff];\n"
     "          const float4 nv = q[noff - lane];\n",
     "          const int nnoff = noff - kCombWidth;\n"
     "          const float4 nv = v;\n"),
    ("cu", "          if (!flag) {", "          if (true) {"),
    ("cu", "            *(send ? ring + tg : junk) = __fadd_rn(rk, gv);",
     "            *(send ? ring + (tg & mask) : junk) = __fadd_rn(rk, gv);")]
# the producers' work in the loop over tiles: copies, round starts,
# write-backs
_COMB_PRODUCERS = (
    "      copy_in(i + 2);\n"
    "      asm volatile(\"cp.async.wait_group 1;\" ::: \"memory\");\n"
    "      asm volatile(\"bar.sync 1, %0;\" ::\"n\"(kPT) : \"memory\");\n"
    "      if (i + 1 < tiles) prepare(i + 1);\n"
    "      if (i > 0) write_back(i - 1);\n")
COMB_VARIANTS = {
    "as_shipped": [],
    "no_stores": _COMB_NO_STORES,
    # every round of the backward on its fast path (no shuffle, vote or
    # warp match): what the collision check and the flagged rounds cost
    "backward_no_flag": [("cu", "          if (!flag) {", "          if (true) {")],
    "chain_only": _COMB_CHAIN,
    # the chain alone with the producers idle after the first tile: what
    # their copies, round starts and write-backs cost the chain
    "chain_only_idle_producers": _COMB_CHAIN + [("cu", _COMB_PRODUCERS, "")],
}


def comb_bench_calls(dev) -> dict:
    """call -> (x or gy [2, N], delays, k, a, whether backward) of phase
    8's comb calls at COMB_SECONDS stereo, the delays as Audio.filter_comb
    takes them, int(sr / (2 w)): the filter call's forward (cutoff 200 x
    10^(t / 600): delays 120 -> 12), the gradient call's forward (keeping
    u) and backward (cutoff sr / (2 (12 + floor(10 t) + 1/2)): delays 12 ->
    6012); feedback and mix 0.5."""
    n = int(COMB_SECONDS * SR)
    t = torch.arange(n, dtype=torch.float32, device=dev) / SR

    def delays(w):
        w = w.clamp(1.0, SR / 2.0)
        return torch.clamp((torch.tensor(SR, device=dev) / (2.0 * w)).to(
            torch.int32), 1, n)
    filt = delays(200.0 * 10.0 ** (t / COMB_SECONDS))
    grad = delays(SR / (2.0 * ((12.0 + 10.0 * t).floor() + 0.5)))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, n), device=dev, generator=gen)
    half = torch.full((n,), 0.5, device=dev)
    return {"forward_filter_call": (x, filt, half, half, False),
            "forward_gradient_call": (x, grad, half, half, False),
            "backward_gradient_call": (x, grad, half, half, True)}


def _digest(*outs) -> str:
    """The first 16 hex digits of the SHA-256 of the outputs' bytes: two
    builds' outputs on the same inputs compared across runs."""
    import hashlib
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _clock_during(run, calls: int = 8) -> str:
    """The SM clock nvidia-smi reads while `calls` calls of run() are on
    the card (the cycles a round above assume 1.98 GHz)."""
    for _ in range(calls):
        run()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def bench_comb(libs: dict, first) -> None:
    """One call of the comb's forward and backward per variant on phase 8's
    calls (comb_bench_calls), by CUDA events, with the rounds the
    version's schedule takes there and the cycles a round at the H100's
    1.98 GHz boost clock (the card's own clock may be lower: the line names
    its power limit), and a digest of its outputs (y, and u where kept;
    gu): another build's on the same inputs tells whether the bits agree.
    A variant named forward_* runs only the forwards, backward_* only the
    backward."""
    from flan_tpu_torch.ops import sequential_kernels
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    count = (first.comb_rounds if first and first.comb_rounds else
             lambda d, rev: len(sequential_kernels.comb_round_starts(d, rev)))
    calls = comb_bench_calls(dev)
    rounds = {name: count(d, back) for name, (_, d, _, _, back)
              in calls.items()}
    for name, lib in libs.items():
        lib.flan_comb_swept_ring_floats.argtypes = [build._i, build._i,
                                                    build._i]
        lib.flan_comb_swept_ring_floats.restype = ctypes.c_longlong
        times = {}
        for call, (x, d, k, a, back) in calls.items():
            if name.startswith("backward" if not back else "forward"):
                continue
            c, n = x.shape
            ring_len = int(d.max())
            ring = torch.empty(lib.flan_comb_swept_ring_floats(
                c, ring_len, int(back)), device=dev)
            rp = ring.data_ptr() if ring.numel() else None
            out = torch.empty_like(x)
            u = torch.empty_like(x) if call == "forward_gradient_call" \
                else None

            def run():
                if back:
                    build.raise_on(lib.flan_comb_swept_backward(
                        x.data_ptr(), d.data_ptr(), k.data_ptr(),
                        a.data_ptr(), out.data_ptr(), rp, c, n, ring_len,
                        1.0, stream), name)
                else:
                    build.raise_on(lib.flan_comb_swept(
                        x.data_ptr(), d.data_ptr(), k.data_ptr(),
                        a.data_ptr(), out.data_ptr(),
                        None if u is None else u.data_ptr(), rp, c, n,
                        ring_len, 1.0, stream), name)
            us = event_us(run, 2)
            mhz = _clock_during(run)
            # chain_only: rounds of 32 steps (n a multiple of the tile)
            r = -(-n // 32) if name.startswith("chain_only") else \
                rounds[call]
            times[call] = {"us": us, "rounds": r,
                           "cycles_per_round_at_1980MHz": round(
                               us * 1980.0 / r, 1),
                           "digest": _digest(out, u),
                           "clocks_sm_mhz_during": mhz}
            del ring, out, u
        print(json.dumps({"source": "comb", "variant": name, **times}),
              flush=True)


# ---- the swept stereo delay (sequential_kernels.cu): one dependent step,
# and what holds each regime
STEREO_FRAMES = 1 << 22
STEREO_WIDTH = 32
STEREO_SECONDS = 600.0
# reads a constant d frames back beside STEREO_WIDTH's: the narrow
# kernel's rounds of 32 against the wide one's of d (the regime's choice,
# sequential_kernels.STEREO_WIDE_FROM)
STEREO_CROSSOVER = (48, 64, 96, 128, 160, 192, 240)
# the narrow kernels' round with no round ends or inputs read a round
# ahead and no values stored: rounds of STEREO_WIDTH steps, each reading
# the round before (both distances STEREO_WIDTH, shared rings), on the
# inputs of the tile's first frames; the round's control, its votes and
# the backward's sends left
_STEREO_ROUND_BARE = [
    ("cu", "        int off = 0, nxt = nq[0];\n        In v = in(lane);\n",
     "        int off = 0, nxt = kDelayWidth;\n        In v = in(lane);\n"),
    ("cu", "          const int nnxt = nq[nxt];\n"
     "          const In nv = in(nxt + lane);\n",
     "          const int nnxt = nxt + kDelayWidth;\n"
     "          const In nv = v;\n"),
    ("cu", "              o[off + lane] = wl;\n"
     "              o[TP + off + lane] = wr;\n", ""),
    ("cu", "        int off = tl - 1, nxt = nq[off];\n"
     "        In v = in(off - lane);\n",
     "        int off = tl - 1, nxt = off - kDelayWidth;\n"
     "        In v = in(off - lane);\n"),
    ("cu", "          const int nnxt = nq[nxt];\n"
     "          const In nv = in(nxt - lane);\n",
     "          const int nnxt = nxt - kDelayWidth;\n"
     "          const In nv = v;\n"),
    ("cu", "            o[off - lane] = gl;\n"
     "            o[TP + off - lane] = gr;\n", "")]
_STEREO_FWD_LOOP = ("        int off = 0, nxt = nq[0];\n",
                    "        } while (off < tl);\n")
_STEREO_BACK_LOOP = ("        float* junk = sent + 64 + lane;\n",
                     "        } while (off >= 0);\n")


def _stereo_chain_loops(cu: str) -> str:
    """The narrow kernels' round loops replaced by the chain itself: one
    warp on rounds of STEREO_WIDTH steps, each reading the round before
    (both distances STEREO_WIDTH, unknown to the compiler), the inputs
    register constants, 32-bit indices; left on the chain the ring reads,
    the steps' multiplies and adds, the ring writes (the backward's: the
    slots zeroed and the two sends added into theirs) and a warp
    barrier."""
    loops = {
        _STEREO_FWD_LOOP: """\
        const int d = kDelayWidth + (n >> 31);
        for (int k = 0; k < T / kDelayWidth; ++k) {
          const int t = f0 + k * kDelayWidth + lane;
          const float rv = ring_r[(t - d) & mr];
          const float lo = ring_l[(t - d) & ml];
          ring_l[t & ml] = __fadd_rn(0.25f, __fmul_rn(rv, 0.5f));
          ring_r[t & mr] = __fadd_rn(0.5f, __fmul_rn(lo, 0.5f));
          ++rounds;
          __syncwarp();
        }
""",
        _STEREO_BACK_LOOP: """\
        const int d = kDelayWidth + (n >> 31);
        for (int k = 0; k < T / kDelayWidth; ++k) {
          const int t = f0 + T - 1 - k * kDelayWidth - lane;
          const float acc_r = ring_r[t & mr], acc_l = ring_l[t & ml];
          const float rk_l = ring_l[(t - d) & ml];
          const float rk_r = ring_r[(t - d) & mr];
          const float gr = __fadd_rn(0.5f, acc_r);
          const float gl = __fadd_rn(0.25f, acc_l);
          ring_l[t & ml] = 0.f;
          ring_r[t & mr] = 0.f;
          ring_l[(t - d) & ml] = __fadd_rn(rk_l, __fmul_rn(0.5f, gr));
          ring_r[(t - d) & mr] = __fadd_rn(rk_r, __fmul_rn(0.5f, gl));
          ++rounds;
          __syncwarp();
        }
"""}
    for (start, end), loop in loops.items():
        if cu.count(start) != 1 or end not in cu[cu.find(start):]:
            raise ValueError(f"round loop not found once: {start!r}")
        a = cu.index(start)
        b = cu.index(end, a) + len(end)
        cu = cu[:a] + loop + cu[b:]
    return cu


_STEREO_NO_STEPS = [("cu", "      if (t < lim) {\n",
                      "      if (t < lim && n < 0) {\n", 2)]
# the narrow kernels' producers idle after the first tiles
_STEREO_IDLE = [("cu", "      copy_in(i + 2);\n"
                 "      asm volatile(\"cp.async.wait_group 1;\" ::: \"memory\");\n"
                 "      arrived(i + 1);\n"
                 "      asm volatile(\"bar.sync 1, %0;\" ::\"n\"(kPT) : \"memory\");\n"
                 "      if (i + 1 < tiles) prepare(i + 1);\n"
                 "      if (kShared && i > 0) write_back(i - 1);\n", "")]
_STEREO_COPY_ONLY = _STEREO_NO_STEPS + [
    ("cu", "    if ((ba | bb) == 0) return hi;\n",
     "    if ((ba | bb | 1u) != 0) return hi;\n")]
STEREO_VARIANTS = {
    "as_shipped": [],
    "round_bare": _STEREO_ROUND_BARE,
    "round_bare_idle_producers": _STEREO_ROUND_BARE + _STEREO_IDLE,
    # the chain alone, one dependent step (chip_smoke.py's stereo delay
    # bounds): the round loops rewritten, the producers idle
    "chain_only": _STEREO_IDLE + [("cu", _stereo_chain_loops)],
    "no_steps": _STEREO_NO_STEPS,
    # and rounds a whole tile wide: the producers' copies and the epochs'
    # barriers, one block's copy rate
    "copy_only": _STEREO_COPY_ONLY,
    # without working out lim and the chunks' maxima
    "copy_only_no_process": _STEREO_COPY_ONLY + [
        ("cu", "      process(j + 4);\n", "")],
    # without the tiles asked into L2 ahead
    "no_prefetch": [("cu", "          if (jp < tiles) {\n",
                     "          if (jp < 0) {\n")],
    # no copies either: the epochs' barriers and the rounds alone
    "no_copies": _STEREO_COPY_ONLY + [
        ("cu", "      process(j + 4);\n", ""),
        ("cu", "      if (j < tiles) {\n        const int f0 = order(j) * T, "
         "tl = min(n - f0, T), o = (j % S) * T;\n",
         "      if (j < 0) {\n        const int f0 = order(j) * T, "
         "tl = min(n - f0, T), o = (j % S) * T;\n")],
    # the wide backward without its second step (a round's sends summed
    # into their slots): the first step, the planner and the copies
    "back_no_sends": [
        ("cu", "      sends(std::true_type{}, s, e, marks, L);\n"
         "      sends(std::false_type{}, s, e, marks, R);\n", "")],
    # the fast way's runs longer than one not summed (other bits)
    "back_no_runs": [("cu", "          const bool two = head && t > s && "
                      "TG[t - 1 - s] == tg;\n",
                      "          const bool two = false;\n")],
    # no consumer work: the planner, the copies and the barriers alone
    "back_rounds_empty": [("cu", "        back_round(s, e, marks);\n", "")],
    # the marked rounds' sides not summed (other bits)
    "back_no_ordered": [("cu", "      } else if (warp == (kLeft ? 0 : 1)) {\n",
                         "      } else if (n < 0) {\n")],
}


def stereo_bench_cases(dev) -> dict:
    """case -> (x, g, el, er, lb, rb): STEREO_FRAMES frames of reads
    STEREO_WIDTH back (rounds of STEREO_WIDTH steps, shared rings) and of
    reads each STEREO_CROSSOVER distance back, and phase 9's first two
    sweeps at STEREO_SECONDS stereo (0.05-0.55 s against 0.05-0.95 s:
    rings in device memory, its reads 2,400 to 45,600 frames back; 5-40
    ms against 5-40 ms: the rings in shared memory, 240 to 1,920 back),
    the distances as Audio.stereo_delay works them out."""
    from flan_tpu_torch.ops import sequential_kernels as seq
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    n = STEREO_FRAMES
    for d in (STEREO_WIDTH, *STEREO_CROSSOVER):
        full = torch.full((n,), d, dtype=torch.int32, device=dev)
        out[f"reads_{d}_back"] = (
            torch.randn((2, n), device=dev, generator=gen),
            torch.full((n,), 0.5, device=dev), full, full, d + 1, d)
    n = int(STEREO_SECONDS * SR)
    t = torch.arange(n, dtype=torch.float32) / SR
    lt = (0.30 + 0.25 * torch.sin(2 * np.pi * 0.05 * t)).to(dev)
    rt = (0.50 + 0.45 * torch.sin(2 * np.pi * 0.07 * t)).to(dev)
    lb, rb = int(float(lt.max()) * SR), int(float(rt.max()) * SR)
    el, er = seq.stereo_delay_reads(seq.stereo_delay_frames(lt, SR, lb, n, dev),
                                    seq.stereo_delay_frames(rt, SR, rb, n, dev),
                                    lb, rb)
    out["long_sweep_600s"] = (torch.randn((2, n), device=dev, generator=gen),
                              torch.full((n,), 0.5, device=dev), el, er, lb,
                              rb)
    lt = (0.0225 + 0.0175 * torch.sin(2 * np.pi * 0.05 * t)).to(dev)
    rt = (0.0225 + 0.0175 * torch.cos(2 * np.pi * 0.07 * t)).to(dev)
    lb, rb = int(float(lt.max()) * SR), int(float(rt.max()) * SR)
    el, er = seq.stereo_delay_reads(seq.stereo_delay_frames(lt, SR, lb, n, dev),
                                    seq.stereo_delay_frames(rt, SR, rb, n, dev),
                                    lb, rb)
    out["short_sweep_600s"] = (torch.randn((2, n), device=dev, generator=gen),
                               torch.full((n,), 0.5, device=dev), el, er, lb,
                               rb)
    return out


def stereo_bench_kernels(variant: str, case: str) -> tuple:
    """The kernels a variant runs on a case: the chain alone the narrow
    forward and the narrow backward on reads STEREO_WIDTH back; the
    crossover's cases both forwards and both backwards, as shipped; the
    wide backward's variants (back_*) the wide backward on the sweeps; the
    rest the narrow and the wide forward and both backwards."""
    if variant == "chain_only":
        return (("narrow", "backward") if case == f"reads_{STEREO_WIDTH}_back"
                else ())
    if variant.startswith("back_"):
        return ("wide_backward",) if "sweep" in case else ()
    if case in {f"reads_{d}_back" for d in STEREO_CROSSOVER}:
        return (("narrow", "wide", "backward", "wide_backward")
                if variant == "as_shipped" else ())
    return ("narrow", "wide", "backward", "wide_backward")


def bench_stereo_delay(libs: dict, first) -> None:
    """One call per variant, kernel and case (stereo_bench_cases,
    stereo_bench_kernels), by CUDA events: the forward and the backward in
    each regime (narrow and wide) and in the variant its rings allow
    (shared or device rings; both backwards take x as gout, so that their
    digests match);
    with the rounds the kernel ran, the cycles a round at the H100's 1.98
    GHz boost clock (the card's own clock during the calls beside it) and
    a digest of the output."""
    from flan_tpu_torch.ops import sequential_kernels as seq
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = stereo_bench_cases(dev)
    for name, lib in libs.items():
        lib.flan_stereo_delay_shared_bytes.argtypes = [build._i] * 3
        lib.flan_stereo_delay_shared_bytes.restype = ctypes.c_longlong
        lib.flan_max_shared_bytes.restype = ctypes.c_int
        limit = lib.flan_max_shared_bytes()
        times = {}
        for case, (x, g, el, er, lb, rb) in cases.items():
            n = x.shape[1]
            out = torch.empty_like(x)
            rounds = torch.zeros(1, dtype=torch.int32, device=dev)
            for kernel in stereo_bench_kernels(name, case):
                wide = kernel.startswith("wide")
                back = kernel.endswith("backward")
                shared = lib.flan_stereo_delay_shared_bytes(
                    seq._delay_kind(wide, back), lb, rb) <= limit
                go = torch.empty_like(x) if wide and back else None

                def run():
                    if back:
                        out.zero_()         # the device variant's sums
                        err = lib.flan_stereo_delay_swept_backward(
                            x.data_ptr(), g.data_ptr(), el.data_ptr(),
                            er.data_ptr(), out.data_ptr(), seq._ptr(go),
                            rounds.data_ptr(), n, lb, rb, int(wide),
                            int(shared), stream)
                    else:
                        err = lib.flan_stereo_delay_swept(
                            x.data_ptr(), g.data_ptr(), el.data_ptr(),
                            er.data_ptr(), out.data_ptr(), rounds.data_ptr(),
                            n, lb, rb, int(wide), int(shared), stream)
                    build.raise_on(err, name)
                us = event_us(run, 2)
                r = int(rounds)
                times[f"{case}/{kernel}_{'shared' if shared else 'device'}"] \
                    = {"us": us, "rounds": r,
                       "cycles_per_round_at_1980MHz": round(us * 1980.0 / r,
                                                            1),
                       "digest": _digest(out),
                       "clocks_sm_mhz_during": _clock_during(run)}
            del out
        print(json.dumps({"source": "stereo_delay", "variant": name,
                          **times}), flush=True)


# ---- the salience histogram (pv_info_kernels.cu): phase 10's 600 s call
SALIENCE_SECONDS = 600.0
SALIENCE_WIDTH = 620        # get_salience's 600 bins and the spread's 20
_SALIENCE_BINS = """\
        float lg = log2f(sub);
        float v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
        if (fabsf(v - floorf(v) - 0.5f) < kRecheck) {
          lg = (float)log2((double)sub);
          v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
        }
"""
SALIENCE_VARIANTS = {
    "as_shipped": [],
    # the log2 in float64 for every contribution (the first design's; the
    # same digest)
    "float64_log2": [("cu", _SALIENCE_BINS, """\
        const float lg = (float)log2((double)sub);
        const float v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
""")],
    # the log2 in float32 alone (other bins: times only)
    "float32_log2": [("cu", _SALIENCE_BINS, """\
        const float lg = log2f(sub);
        const float v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
""")],
    # the float64 path where v lies within 2^-7 of a half-integer (the
    # same digest; the share of rechecked warps against kRecheck's)
    "recheck_wider": [("cu", "constexpr float kRecheck = 0x1p-10f;",
                       "constexpr float kRecheck = 0x1p-7f;")],
    # no contended lanes: each lane adds its own contribution at once
    # (races where two meet: times only)
    "no_contention": [("cu", "    const unsigned contended = __ballot_sync("
                       "kFull, met);\n",
                       "    const unsigned contended = 0u * met;\n")],

    # no spread: the rows only
    "no_spread": [("cu", "  for (int j = lane; j < n_out; j += 32) {\n",
                   "  for (int j = lane; j < 0; j += 32) {\n")],
}


def salience_bench_inputs(dev):
    """(i_f, i_m) [F, K]: channel 0's peaks of the PV (window 2048, hop
    128, dft 4096) of SALIENCE_SECONDS of chip_smoke.py's stereo signal at
    48 kHz (0.4 sines at 220 and 330 Hz plus 0.1 white noise, seed 0), as
    get_salience takes them: phase 10's call."""
    from flan_tpu_torch import Audio
    from flan_tpu_torch.pv import information
    pv = Audio.create_from_array(stereo_signal(SALIENCE_SECONDS), SR,
                                 device=dev).convert_to_PV(2048, 128, 4096)
    return information.salience_peaks(pv, 0)


def stereo_signal(seconds: float) -> np.ndarray:
    """chip_smoke.py's stereo signal at 48 kHz: 0.4 sines at 220 and 330
    Hz plus 0.1 white noise, seed 0."""
    n = int(seconds * SR)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n),
        0.4 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n),
    ]).astype(np.float32)


def bench_salience(libs: dict, first) -> None:
    """One call per variant on phase 10's 600 s peaks, by CUDA events
    (three after one), with a digest of the output."""
    from flan_tpu_torch.ops import pv_info_kernels as pk
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    i_f, i_m = salience_bench_inputs(dev)
    alpha = torch.from_numpy(pk.alpha_powers()).to(dev)
    g = torch.from_numpy(pk.spread_taps()).to(dev)
    frames, k_cnt = i_f.shape
    out = torch.empty((frames, SALIENCE_WIDTH - 2 * pk.SPREAD), device=dev)
    log2_min = float(np.float32(np.log2(55.0)))
    for name, lib in libs.items():
        def run():
            build.raise_on(lib.flan_salience_histogram(
                i_f.data_ptr(), i_m.data_ptr(), alpha.data_ptr(),
                g.data_ptr(), out.data_ptr(), frames, k_cnt, SALIENCE_WIDTH,
                log2_min, stream), name)
        us = event_us(run, 3)
        print(json.dumps({"source": "salience", "variant": name,
                          "frames": frames, "peaks": k_cnt, "us": us,
                          "digest": _digest(out),
                          "clocks_sm_mhz_during": _clock_during(run)}),
              flush=True)


# ---- the synthesis kernels (synth_kernels.cu): K2 on phase 11's two
# waveform calls, K3 on its granulate, psola and modded texture calls
SYNTH_SECONDS, SYNTH_SHORT_SECONDS = 600.0, 30.0
_K2_FIXED = "  return __float2ll_rn(__fmul_rn(r, 0x1p47f));\n"
_K2_PHASE = "  return __fmul_rn(__ll2float_rn(run), 0x1p-47f);\n"
_K2_RECOMPUTE_Q = [
    ("cu", """\
  long long q[kSub][4], s[kSub], pre[kSub], total;
#pragma unroll
  for (int k = 0; k < kSub; ++k) s[k] = four_incs(v[k], in_rate, y, q[k]);
""", """\
  long long s[kSub], pre[kSub], total;
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    long long q[4];
    s[k] = four_incs(v[k], in_rate, y, q);
  }
"""),
    ("cu", """\
  for (int k = 0; k < kSub; ++k)
    store_phases(phase, n, i0 + (long long)k * kSubTile, vec,
                 (pre[k] + before) & kMask, q[k]);
""", """\
  for (int k = 0; k < kSub; ++k) {
    long long q[4];
    four_incs(v[k], in_rate, y, q);
    store_phases(phase, n, i0 + (long long)k * kSubTile, vec,
                 (pre[k] + before) & kMask, q);
  }
""")]


# K2's earlier grids: "one_tile", a block a tile on a grid of ntiles
# blocks; "prefetch", the persistent grid taking its next ticket and
# loading that tile before the current tile's look-back, and publishing
# its total only after it
_K2_PERSISTENT_HEAD = """\
__global__ void __launch_bounds__(kScanThreads)
cycle_scan_pass(const float* __restrict__ f, float in_rate, long long n,
                long long ntiles, unsigned long long* scratch,
                float* __restrict__ phase) {
  __shared__ unsigned ticket_sm[2];
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = scratch + 1;
  const bool vec = ((reinterpret_cast<uintptr_t>(f) |
                     reinterpret_cast<uintptr_t>(phase)) & 15) == 0;
  const float y = in_rate >= 0x1p-60f && in_rate <= 0x1p60f
                      ? __frcp_rn(in_rate) : 0.f;
  const long long lane0 = 4 * (long long)threadIdx.x;
  float v[kSub][4];
"""
_K2_PERSISTENT_BODIES = {
    "prefetch": """\
  if (threadIdx.x == 0) ticket_sm[0] = atomicAdd(ticket, 1u);
  __syncthreads();
  long long tile = ticket_sm[0];
  if (tile < ntiles)
    for (int k = 0; k < kSub; ++k)
      load_four(f, n, tile * kScanTile + k * kSubTile + lane0, vec, v[k]);
  for (int it = 1; tile < ntiles; ++it) {
    if (threadIdx.x == 0) ticket_sm[it & 1] = atomicAdd(ticket, 1u);
    long long q[kSub][4], s[kSub], pre[kSub], total;
    for (int k = 0; k < kSub; ++k) s[k] = four_incs(v[k], in_rate, y, q[k]);
    tile_prefixes(s, pre, &total);
    if (threadIdx.x == 0)
      store_word(status + tile, (tile == 0 ? kInclusive : kTotal) | total);
    const long long next = ticket_sm[it & 1];
    if (next < ntiles)
      for (int k = 0; k < kSub; ++k)
        load_four(f, n, next * kScanTile + k * kSubTile + lane0, vec, v[k]);
    const long long before = look_back(status, tile);
    if (threadIdx.x == 0 && tile > 0)
      store_word(status + tile,
                 kInclusive | (unsigned long long)((before + total) & kMask));
    for (int k = 0; k < kSub; ++k)
      store_phases(phase, n, tile * kScanTile + k * kSubTile + lane0, vec,
                   (pre[k] + before) & kMask, q[k]);
    tile = next;
  }
}
""",
}
_K2_ONE_TILE = """\
// scratch: a ticket word, then a published word a tile, all zero at the
// launch. A thread holds a float4 of each of the tile's kSub sub-tiles,
// so that a warp's loads and stores cover 512 contiguous bytes.
__global__ void __launch_bounds__(kScanThreads)
cycle_scan_pass(const float* __restrict__ f, float in_rate, long long n,
                unsigned long long* scratch, float* __restrict__ phase) {
  __shared__ unsigned tile_sm;
  if (threadIdx.x == 0)
    tile_sm = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const long long tile = tile_sm;
  unsigned long long* status = scratch + 1;
  const bool vec = ((reinterpret_cast<uintptr_t>(f) |
                     reinterpret_cast<uintptr_t>(phase)) & 15) == 0;
  const float y = in_rate >= 0x1p-60f && in_rate <= 0x1p60f
                      ? __frcp_rn(in_rate) : 0.f;
  const long long i0 = tile * kScanTile + 4 * (long long)threadIdx.x;
  float v[kSub][4];
#pragma unroll
  for (int k = 0; k < kSub; ++k)
    load_four(f, n, i0 + (long long)k * kSubTile, vec, v[k]);
  long long q[kSub][4], s[kSub], pre[kSub], total;
#pragma unroll
  for (int k = 0; k < kSub; ++k) s[k] = four_incs(v[k], in_rate, y, q[k]);
  tile_prefixes(s, pre, &total);
  if (threadIdx.x == 0)
    store_word(status + tile, (tile == 0 ? kInclusive : kTotal) | total);
  const long long before = look_back(status, tile);
  if (threadIdx.x == 0 && tile > 0)
    store_word(status + tile,
               kInclusive | (unsigned long long)((before + total) & kMask));
#pragma unroll
  for (int k = 0; k < kSub; ++k)
    store_phases(phase, n, i0 + (long long)k * kSubTile, vec,
                 (pre[k] + before) & kMask, q[k]);
}

"""
_K2_ONE_TILE_LAUNCH = """\
  cycle_scan_pass<<<(unsigned)ntiles, kScanThreads, 0, s>>>(
      f, in_rate, n, reinterpret_cast<unsigned long long*>(scratch), phase);
"""


def _k2_kernel(kind: str):
    """The K2 source with cycle_scan_pass replaced: "one_tile" (and its
    launch on ntiles blocks) or a persistent body of
    _K2_PERSISTENT_BODIES."""
    def edit(cu: str) -> str:
        start = cu.index("// scratch: a ticket word, then a published word")
        end = cu.index("// A constant increment q_const")
        if kind == "one_tile":
            cu = cu[:start] + _K2_ONE_TILE + cu[end:]
            a = cu.index("  // a persistent grid: as many blocks")
            b = cu.index("  return (int)cudaGetLastError();", a)
            return cu[:a] + _K2_ONE_TILE_LAUNCH + cu[b:]
        head = cu.index("__global__ void __launch_bounds__(kScanThreads)\n"
                        "cycle_scan_pass(", start)
        return (cu[:head] + _K2_PERSISTENT_HEAD + _K2_PERSISTENT_BODIES[kind]
                + "\n" + cu[end:])
    return edit


def _k2_block_look_back(cu: str) -> str:
    """K2's look-back by the whole block, each thread reading one of 256
    tiles' words at a time, the nearest inclusive prefix and the sum found
    by block reductions."""
    start = cu.index("// The sum of the tiles before `tile`")
    end = cu.index("// scratch: a ticket word")
    return cu[:start] + """\
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, long long tile) {
  __shared__ int nearest_sm[kScanWarps];
  __shared__ long long sum_sm[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long before = 0;
  for (long long top = tile - 1;; top -= kScanThreads) {
    const long long idx = top - threadIdx.x;
    unsigned long long w = idx >= 0 ? load_word(status + idx) : kInclusive;
    while ((w >> 62) == 0) w = load_word(status + idx);
    const unsigned incl = __ballot_sync(kFull, (w >> 62) == 2);
    if (lane == 0)
      nearest_sm[warp] = incl ? warp * 32 + __ffs(incl) - 1 : kScanThreads;
    __syncthreads();
    int nearest = kScanThreads;
#pragma unroll
    for (int k = 0; k < kScanWarps; ++k) nearest = min(nearest, nearest_sm[k]);
    long long v = (int)threadIdx.x <= nearest ? (long long)(w & kMask) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = (v + __shfl_xor_sync(kFull, v, d)) & kMask;
    if (lane == 0) sum_sm[warp] = v;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanWarps; ++k) before = (before + sum_sm[k]) & kMask;
    __syncthreads();                  // the shared words free for a next use
    if (nearest < kScanThreads) return before;
  }
}

""" + cu[end:]


SYNTH_VARIANTS = {
    "as_shipped": [],
    # K2's two conversions in 32-bit integer work: q from the float's
    # exponent and mantissa, rounded half to even by a shift; the phase by
    # a count of leading zeros and one rounding (the same digest)
    "k2_integer_conversions": [
        ("cu", _K2_FIXED, """\
  const unsigned b = __float_as_uint(r);
  const int e = (int)(b >> 23) & 0xff;
  if (e == 0xff) return 0;
  const unsigned m = (b & 0x7fffffu) | (e ? 0x800000u : 0u);
  const int sh = max(e, 1) - 103;       // r 2^47 = m 2^sh
  if (sh >= 0) return (long long)m << sh;
  const int s = -sh;
  if (s > 24) return 0;
  const unsigned half = 1u << (s - 1);
  const unsigned rest = m & ((half << 1) - 1u);
  const unsigned qv = m >> s;
  return qv + ((rest > half || (rest == half && (qv & 1u))) ? 1 : 0);
"""),
        ("cu", _K2_PHASE, """\
  if (run == 0) return 0.f;
  const unsigned long long u = (unsigned long long)run;
  const int nb = 64 - __clzll(run);     // 1 .. 47
  unsigned mant;
  if (nb <= 24) {
    mant = (unsigned)u << (24 - nb);
  } else {
    const int s = nb - 24;
    const unsigned long long half = 1ull << (s - 1);
    const unsigned long long rest = u & ((half << 1) - 1ull);
    mant = (unsigned)(u >> s);
    mant += (rest > half || (rest == half && (mant & 1u))) ? 1u : 0u;
  }
  return __uint_as_float(((unsigned)(nb + 79 - 1) << 23) + mant);
""")],
    # K2 with no conversion at all (other bits: times only)
    "k2_no_conversions": [
        ("cu", _K2_FIXED, "  return (long long)__float_as_uint(r);\n"),
        ("cu", _K2_PHASE, "  return __int_as_float((int)run);\n")],
    # K2 without the look-back: every tile's prefix 0 (other bits)
    "k2_no_look_back": [
        ("cu", "    const long long before = look_back(status, t);\n",
         "    const long long before = 0;\n")],
    # K2's tile: 8 sub-tiles (8,192 elements), 128 threads (2,048) (the
    # same digest)
    "k2_sub_8": [("cu", "constexpr int kSub = 4; ",
                  "constexpr int kSub = 8; ")],
    "k2_threads_128": [("cu", "constexpr int kScanThreads = 256;",
                        "constexpr int kScanThreads = 128;")],
    # K2's quotient by the library's division (a reciprocal an element),
    # its remainder by truncf, its published words by acquire loads and
    # release stores (the same digest)
    "k2_library_division": [
        ("cu", "    const float x = y != 0.f ? quotient(v[j], in_rate, y)\n"
         "                             : __fdiv_rn(v[j], in_rate);\n",
         "    const float x = __fdiv_rn(v[j], in_rate);\n")],
    "k2_trunc_remainder": [("cu", "  if (fabsf(x) < 0x1p22f) {",
                            "  if (false) {")],
    "k2_acquire_release": [
        ("cu", "ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
        ("cu", "st.relaxed.gpu.global.u64", "st.release.gpu.global.u64")],
    # K2's tile: 512 threads (8,192 elements), 2 sub-tiles (2,048) (the
    # same digest)
    "k2_threads_512": [("cu", "constexpr int kScanThreads = 256;",
                        "constexpr int kScanThreads = 512;")],
    "k2_sub_2": [("cu", "constexpr int kSub = 4; ",
                  "constexpr int kSub = 2; ")],
    # K2 a block a tile (the grid before the persistent one), without its
    # look-back, with its increments recomputed for the stores; the
    # persistent grid that publishes a loaded tile's total only after the
    # current look-back (the same digest but without the look-back)
    "k2_one_tile": [("cu", _k2_kernel("one_tile"))],
    "k2_one_tile_no_look_back": [
        ("cu", _k2_kernel("one_tile")),
        ("cu", "  const long long before = look_back(status, tile);\n",
         "  const long long before = 0;\n")],
    "k2_one_tile_recompute_q": [("cu", _k2_kernel("one_tile"))]
    + _K2_RECOMPUTE_Q,
    "k2_persistent_prefetch": [("cu", _k2_kernel("prefetch"))],
    # K2's look-back by the whole block, 256 tiles a read (the same
    # digest)
    "k2_block_look_back": [("cu", _k2_block_look_back)],
    # K2's loads and stores without the streaming hints (the same digest)
    "k2_cached_memory_ops": [("cu", "__ldcs(", "__ldg(", 2),
                             ("cu", "    __stcs(reinterpret_cast<float4*>("
                              "phase + i),\n           make_float4(",
                              "    *reinterpret_cast<float4*>(phase + i) ="
                              " (\n           make_float4(")],
    # K3 with 2 and 4 grains' loads in flight at a time (the same digest)
    "k3_unroll_2": [("cu", "constexpr int kUnroll = 1;",
                     "constexpr int kUnroll = 2;")],
    "k3_unroll_4": [("cu", "constexpr int kUnroll = 1;",
                     "constexpr int kUnroll = 4;")],
    # K3 with runs of 4 and 16 output blocks (128 and 512 threads; the
    # same digest)
    "k3_run_4": [("cu", "constexpr int kRun = 8; ",
                  "constexpr int kRun = 4; ")],
    "k3_run_16": [("cu", "constexpr int kRun = 8; ",
                   "constexpr int kRun = 16; ")],
    # K3 a channel a block (the envelope computed for each channel; the
    # same digest)
    "k3_one_channel": [("cu", "constexpr int kChans = 2; ",
                        "constexpr int kChans = 1; "),
                       ("cu", "  const bool pair = c0 + 1 < channels;\n",
                        "  const bool pair = false;\n")],
    # K3 held to 40 registers, so that 6 blocks fit an SM (the same
    # digest)
    "k3_six_blocks": [("cu", "__global__ void __launch_bounds__("
                       "kGrainThreads)",
                       "__global__ void __launch_bounds__(kGrainThreads, 6)")],
    # K3 with a shared list of 32 entries: long runs walked in pieces
    # (the same digest)
    "k3_list_32": [("cu", "constexpr int kList = 256; ",
                    "constexpr int kList = 32; ")],
}


def _capture(targets, run):
    """run() with module.<name> for each (module, name) of targets wrapped
    to keep each call's arguments (the calls still launch). Returns name ->
    the argument tuples in call order."""
    kept = {name: [] for _, name in targets}
    originals = [(m, name, getattr(m, name)) for m, name in targets]

    def recorder(name, fn):
        def call(*args, **kwargs):
            kept[name].append(args)
            return fn(*args, **kwargs)
        return call
    try:
        for m, name, fn in originals:
            setattr(m, name, recorder(name, fn))
        run()
    finally:
        for m, name, fn in originals:
            setattr(m, name, fn)
    return kept


def synth_bench_calls(dev) -> dict:
    """name -> the kernel wrapper's arguments of chip_smoke.py phase 11's
    calls at 48 kHz: the sine at oversample 16 at a constant 440 Hz and on
    a 220 + 2000 t / 600 Hz sweep (K2, 600 s), granulate (stereo, 100
    grains a second of 0.1 s, 600 s), psola (a gliding tone, 30 s) and a
    modded texture (30 s) (K3)."""
    import math
    from flan_tpu_torch import Audio
    from flan_tpu_torch.ops import cycle_scan as cs
    from flan_tpu_torch.ops import grain_mix as gm
    from flan_tpu_torch.ops.stft import cpu_exact
    long_s, short_s = SYNTH_SECONDS, SYNTH_SHORT_SECONDS

    def sine(p):
        return cpu_exact(torch.sin, 2.0 * math.pi * p)
    x_long = Audio.create_from_array(stereo_signal(long_s), SR, device=dev)
    n = int(short_s * SR)
    t = np.arange(n, dtype=np.float64) / SR
    ph = 2 * np.pi * (110.0 * t + 27.5 * t * t / short_s)
    glide = Audio.create_from_array(np.asarray(
        [sum(0.5 / k * np.sin(k * r * ph) for k in range(1, 5))
         for r in (1.0, 1.5)], np.float32), SR, device=dev)
    src = x_long.cut(0.0, 0.25)
    runs = {
        "waveform_sweep": lambda: Audio.synthesize_waveform(
            sine, long_s, lambda t: 220.0 + t * (2000.0 / long_s), SR, 16,
            device=dev),
        "waveform_const": lambda: Audio.synthesize_waveform(
            sine, long_s, 440.0, SR, 16, device=dev),
        "granulate": lambda: x_long.granulate(
            long_s, 100.0, 0.0, lambda t: 0.9 * t, 0.1, 0.01, seed=4),
        "psola": lambda: glide.psola(short_s, lambda t: 0.9 * t, seed=6),
        "texture_mod": lambda: src.texture(
            short_s, 20.0, 0.01,
            lambda a, t: a.modify_volume(0.5 + t * (0.5 / short_s)), seed=7),
    }
    calls = {}
    for name, run in runs.items():
        kept = _capture([(cs, "cycle_scan_cuda"),
                         (gm, "grain_overlap_add_cuda")], run)
        calls[name] = (kept["cycle_scan_cuda"] or
                       kept["grain_overlap_add_cuda"])[-1]
        torch.cuda.empty_cache()
    return calls


def bench_synth(libs: dict, first) -> None:
    """Each variant on phase 11's K2 and K3 calls: microseconds by CUDA
    events (three after one) and a digest of the output."""
    from flan_tpu_torch.ops import grain_mix as gm
    from flan_tpu_torch.ops.cycle_scan import fixed
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    calls = synth_bench_calls(dev)
    for name, lib in libs.items():
        for call, args in calls.items():
            if call.startswith("waveform"):
                f, inc, in_rate, n = args[:4]
                ntiles = -(-n // lib.flan_cycle_scan_tile())
                scratch = torch.zeros(ntiles + 1, dtype=torch.int64,
                                      device=dev)
                out = torch.empty(n, dtype=torch.float32, device=dev)

                def run():
                    scratch.zero_()
                    build.raise_on(lib.flan_cycle_scan(
                        None if f is None else f.data_ptr(),
                        fixed(inc) if f is None else 0,
                        float(np.float32(in_rate)), n, scratch.data_ptr(),
                        out.data_ptr(), stream), name)
            else:
                x, meta, offsets, entries, out_n = args[:5]
                envp = args[5] if len(args) > 5 else None
                ch, cstride, gstride, n_clip = gm._source_geometry(x)
                meta_d = meta.to(dev, torch.int32).contiguous()
                offs_d = torch.from_numpy(np.asarray(offsets, np.int64)).to(
                    dev)
                ent_d = torch.from_numpy(np.asarray(entries, np.int32)).to(
                    dev)
                out = torch.empty((ch, out_n), dtype=torch.float32,
                                  device=dev)

                def run():
                    build.raise_on(lib.flan_grain_overlap_add(
                        x.data_ptr(), cstride, gstride, n_clip,
                        meta_d.data_ptr(), meta.shape[1],
                        None if envp is None else envp.data_ptr(),
                        0 if envp is None else envp.shape[1],
                        offs_d.data_ptr(), ent_d.data_ptr(), out.data_ptr(),
                        ch, out_n, stream), name)
            us = event_us(run, 3)
            print(json.dumps({"source": "synth", "variant": name,
                              "call": call, "elements": out.numel(),
                              "us": us, "digest": _digest(out),
                              "clocks_sm_mhz_during": _clock_during(run)}),
                  flush=True)
            del out


# ---- H2, the remap and synthesis prologue (pv_stage_kernels.cu): chunks
# of chip_smoke.py's 2x stretch (window 2048 / hop 128 / dft 4096)
PV_SECONDS = 12.0       # three streamed chunks, two of pv_inverse
PV_STAGES_VARIANTS = {
    "as_shipped": [],
    # the division by the rate as K2's: a reciprocal a thread and two
    # corrections, the library's division outside quotient's range (the
    # same digest)
    "reciprocal_rate_division": [
        ("cu", "float rate, float* mag) {",
         "float rate, float y, float* mag) {"),
        ("cu", "  return rem1f(__fdiv_rn(fv, rate));",
         "  return rem1f(y != 0.f ? quotient(fv, rate, y) : "
         "__fdiv_rn(fv, rate));"),
        ("cu", "  const long long nblk = (F + kCum - 1) / kCum;\n  const int r0",
         "  const float y =\n      rate >= 0x1p-60f && rate <= 0x1p60f ? "
         "__frcp_rn(rate) : 0.f;\n  const long long nblk = (F + kCum - 1) / "
         "kCum;\n  const int r0"),
        ("cu", "kPlan ? s_ok[r] != 0 : true, rate, &mv);",
         "kPlan ? s_ok[r] != 0 : true, rate, y, &mv);")],
    # dirty's clear fenced by its own barrier only without a plan (with
    # one, the plan's staging barrier follows it; the same digest)
    "clear_barrier_without_plan": [
        ("cu", "  __syncthreads();       // cleared before any warp marks a "
         "column", "  if (!kPlan) __syncthreads();")],
    # the remap's division a reciprocal and two corrections (other bits
    # where a total leaves quotient's range: times, and the digest)
    "reciprocal_remap_division": [
        ("cu", "__fdiv_rn(fsum, total) : 0.f;",
         "quotient(fsum, total, __frcp_rn(total)) : 0.f;")],
    # the spectrum's stores marked streaming (the same digest)
    "streaming_stores": [
        ("cu", "        out[(f0 + r) * B] = polar(x, pre, c0, s_mag[r][lane], "
         "two_pi);", "        __stcs(out + (f0 + r) * B, polar(x, pre, c0, "
         "s_mag[r][lane], two_pi));")],
    # batches of 8 frames with a plan, of 4 without (the same digest)
    "batches_of_8": [("cu", "constexpr int kBatch = 4;",
                      "constexpr int kBatch = 8;")],
    "row_batches_of_4": [("cu", "constexpr int kRowBatch = 8;",
                          "constexpr int kRowBatch = 4;")],
    # clusters of 4 and 16 frame blocks (the same digest)
    "cluster_4": [("cu", "constexpr int kCluster = 8;",
                   "constexpr int kCluster = 4;")],
    "cluster_16": [("cu", "constexpr int kCluster = 8;",
                    "constexpr int kCluster = 16;"),
                   ("cu", "  if (err != cudaSuccess) return err;\n  cuda"
                    "LaunchAttribute", "  if (err != cudaSuccess) return err;"
                    "\n  if (ncl > 8)\n    cudaFuncSetAttribute(pv_synthesis"
                    "<kPlan>, cudaFuncAttributeNonPortableClusterSizeAllowed, "
                    "1);\n  cudaLaunchAttribute")],
    # the increments kept in float64 (no second conversion; the same
    # digest)
    "double_increments": [
        ("cu", "  float (*s_inc)[kBins] =\n      reinterpret_cast<float (*)"
         "[kBins]>(s_vals + kCum * kBins);",
         "  double (*s_inc)[kBins] =\n      reinterpret_cast<double (*)"
         "[kBins]>(s_vals + kCum * kBins);"),
        ("cu", "constexpr int kH2Smem = 2 * kCum",
         "constexpr int kH2Smem = 3 * kCum"),
        ("cu", "        s_inc[r][lane] = v;\n",
         "        s_inc[r][lane] = (double)v;\n")],
    # 16 bins a block (256 threads, four blocks an SM; the same digest)
    "bins_16": [("cu", "constexpr int kBins = 32;",
                 "constexpr int kBins = 16;")],
    # parts taken out (other bits: times only): the cluster's barrier and
    # chain (each block its own prefix), the plan's loads (rows from the
    # frame's index), the remap's division, the spectrum's stores (the
    # polar form kept), the polar form (the magnitude and the sum stored),
    # sincosf, the increments' arithmetic, the exact-path test
    "no_cluster_chain": [
        ("cu", "    cluster.sync();\n    if (sg == 0) {\n",
         "    __syncthreads();\n    if (sg == 0) {\n"),
        ("cu", "        t[q] = q < (int)ncl && base + q < nblk",
         "        t[q] = q == (int)rank")],
    "no_plan_loads": [("cu", """\
          s_li[r] = (int)li[f0 + r];
          s_mix[r] = mix[f0 + r];
          s_ok[r] = valid[f0 + r];
""", """\
          s_li[r] = (int)((f0 + r) >> 1);
          s_mix[r] = 0.5f;
          s_ok[r] = 1;
""")],
    "no_remap_division": [("cu", "__fdiv_rn(fsum, total) : 0.f;",
                           "__fmul_rn(fsum, total) : 0.f;")],
    "no_spectrum_stores": [
        ("cu", "        out[(f0 + r) * B] = polar(x, pre, c0, s_mag[r][lane], "
         "two_pi);", "        const float2 e = polar(x, pre, c0, "
         "s_mag[r][lane], two_pi);\n        if (e.x == 123.456f) "
         "out[(f0 + r) * B] = e;")],
    "no_polar_math": [
        ("cu", "polar(x, pre, c0, s_mag[r][lane], two_pi);",
         "make_float2(s_mag[r][lane], (float)x);")],
    "no_sincos": [("cu", "  sincosf(__fmul_rn(cyc, two_pi), &sn, &cs);",
                   "  sn = cyc;\n  cs = __fmul_rn(cyc, two_pi);")],
    "no_increment_math": [
        ("cu", """\
          v = increment<kPlan>(m0[u], m1[u], q0[u], q1[u],
                               kPlan ? s_mix[r] : 0.f,
                               kPlan ? s_ok[r] != 0 : true, rate, &mv);""",
         """\
          v = __fmul_rn(__fadd_rn(q0[u], q1[u]), rate), mv = m0[u] + m1[u];""")],
    "no_exact_test": [("cu", "        clean = clean && q == truncf(q);",
                       "        clean = clean && q == q;")],
}


def pv_stages_bench_calls(dev) -> dict:
    """name -> synthesis_cuda's arguments on PV_SECONDS of the stereo
    signal: the streamed 2x stretch's first chunk (4,096 frames remapped
    from 2,051, 2 x 2,049 bins), the same chunk's last cycle alone (write
    0, the sharded paths' totals) and pv_inverse's first chunk (2,048
    frames, no plan)."""
    from flan_tpu_torch.ops import pv_stages, stft
    from flan_tpu_torch.pipelines import pv_stretch_pipeline
    x = torch.from_numpy(stereo_signal(PV_SECONDS)).to(dev)
    streamed = _capture([(pv_stages, "synthesis_cuda")],
                        lambda: pv_stretch_pipeline(x, 2.0, sample_rate=SR)
                        )["synthesis_cuda"][0]
    mag, freq = stft.pv_forward(x, sample_rate=SR)
    whole = _capture([(pv_stages, "synthesis_cuda")],
                     lambda: stft.pv_inverse(mag, freq, sample_rate=SR)
                     )["synthesis_cuda"][0]
    return {"streamed": streamed,
            "streamed_totals": (*streamed[:5], False),
            "class": whole}


def h2_launcher(lib, args, stream):
    """(run, outputs): run() launches lib's flan_pv_synthesis on
    synthesis_cuda's arguments into outputs of its own."""
    from flan_tpu_torch.ops import pv_stages
    mag, freq, cycle, rate, plan, write = args
    c, frames, nbins = mag.shape
    n_out = frames if plan is None else plan[0].shape[0]
    spec = (torch.empty((c, n_out, nbins), dtype=torch.complex64,
                        device=mag.device) if write else None)
    last = torch.empty((c, 1, nbins), dtype=torch.float32, device=mag.device)
    ptrs = ((None, None, None) if plan is None else
            tuple(t.data_ptr() for t in plan))

    def run():
        build.raise_on(lib.flan_pv_synthesis(
            mag.data_ptr(), freq.data_ptr(), mag.stride(0), *ptrs,
            None if cycle is None else cycle.data_ptr(), last.data_ptr(),
            None if spec is None else spec.data_ptr(), int(write), c, n_out,
            nbins, float(np.float32(rate)), float(pv_stages._TWO_PI_F32),
            stream), "pv_synthesis")
    return run, (spec, last)


def bench_pv_stages(libs: dict, first) -> None:
    """Each variant of H2 on a streamed chunk, its totals alone and a class
    path chunk: device microseconds a launch (torch.profiler, three after
    one; CUDA events beside them) and a digest of the outputs."""
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    calls = pv_stages_bench_calls(dev)
    for name, lib in libs.items():
        for call, args in calls.items():
            run, outs = h2_launcher(lib, args, stream)
            prof = launch_times(run)
            print(json.dumps({"source": "pv_stages", "variant": name,
                              "call": call, "us_per_launch": prof,
                              "us_events": event_us(run, 3),
                              "digest": _digest(*outs),
                              "clocks_sm_mhz_during": _clock_during(run)}),
                  flush=True)
            del outs

SOURCES = {
    "spv": (SPV_VARIANTS, bench_spv),
    "scan": (SCAN_VARIANTS, bench_scan),
    "kxk": (KXK_VARIANTS, bench_kxk),
    "sqpv": (SQPV_VARIANTS, bench_sqpv),
    "saturator": (SATURATOR_VARIANTS, bench_saturator),
    "comb": (COMB_VARIANTS, bench_comb),
    "stereo_delay": (STEREO_VARIANTS, bench_stereo_delay),
    "salience": (SALIENCE_VARIANTS, bench_salience),
    "synth": (SYNTH_VARIANTS, bench_synth),
    "pv_stages": (PV_STAGES_VARIANTS, bench_pv_stages),
}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", nargs="+", choices=sorted(SOURCES),
                        default=None)
    parser.add_argument("--first-version", nargs=2, default=None,
                        metavar=("COMMIT", "CSRC_DIR"))
    parser.add_argument("--variants", nargs="+", default=None,
                        metavar="NAME", help="only these (and as_shipped)")
    parser.add_argument("--ks", nargs="+", type=int, default=None,
                        metavar="K", help="the k x k kernel at these k")
    args = parser.parse_args()
    global KXK_KS
    KXK_KS = tuple(args.ks) if args.ks else KXK_KS
    if not torch.cuda.is_available():
        sys.exit("spv_variants: needs a CUDA card")
    first = None    # the first version's sets and hooks, if asked for
    csrc = build.CSRC
    if args.first_version is not None:
        from flan_tpu_torch.ops import spv_variants_first
        first = spv_variants_first.VERSIONS[args.first_version[0]]
        csrc = Path(args.first_version[1])
    sources = args.source or sorted(first.variants if first else SOURCES)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    for source in sources:
        variants, bench = SOURCES[source]
        variants = first.variants[source] if first else variants
        if args.variants:
            variants = {name: edits for name, edits in variants.items()
                        if name == "as_shipped" or name in args.variants}
        libs = build_variants(
            csrc, source, variants,
            {**build.SIGNATURES, **(first.signatures if first else {})})
        bench(libs, first)


if __name__ == "__main__":
    main()
