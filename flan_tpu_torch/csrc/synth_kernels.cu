// The synthesis family's kernels on Hopper: K2, the exclusive mod-1 cycle
// scan, and K3, the granular overlap-add.
//
// Neither replaces a TPU kernel: the JAX package leaves both to XLA.
//
// K2 cycle_scan (flan_tpu/audio/synthesis.py:50-58 synthesize_waveform,
// :534-540 synthesize_pulsars). XLA computes the phase as a float32
// associative_scan of mod(a + b, 1) over inc = mod(f / in_rate, 1), a
// tree whose order no other implementation shares. Here the increments
// are summed exactly, in Q0.47 fixed point in int64 (every float32
// increment >= 2^-24 is a whole number of 2^-47), and the sum is reduced
// mod 1 by a mask. Integer addition associates, so the bits are the same
// in any order, on every device and every call; each phase is rounded to
// float32 once, which lies within the tree's own error.
// Function, for i < n:
//   inc_i  = f_i / in_rate (IEEE division) mod 1 (the remainder, +1 if
//            negative), or the host's constant increment
//   q_i    = rint(inc_i 2^47)
//   phase_i = float32((sum_{j < i} q_j mod 2^47) 2^-47); phase_0 = 0
// Bound: bytes. f read once and the phase written once, 8 bytes an
// element (4 for a constant frequency): 3.7 GB at 4.6e8, 1.1 ms.
// Design: one pass over f, in tiles of 4,096 elements (256 threads, each
// a float4 of each of its 4 sub-tiles of 1,024, so that a warp's loads
// and stores cover 512 contiguous bytes) taken by atomic tickets, so that
// every tile before a tile has been taken. A tile's block loads its f
// once into registers, forms the increments and its total, publishes the
// total, looks back over its predecessors' published words (a warp reads
// 32 at once) until it meets an inclusive prefix, publishes its own, and
// writes its phases from the increments it still holds. The grid is
// persistent and a block holds three tiles at once (cycle_scan_pass), so
// that its next loads fly while it waits in a look-back. A published word
// is the 47-bit sum with its status in bits 62-63, written and read
// whole, so no value sits beside a flag and relaxed accesses suffice
// (release and acquire ones measured slower). The increment: the quotient
// by a reciprocal and two corrections (no reciprocal an element), the
// remainder by two additions; q is the float times 2^47 (exact) rounded
// half to even by one float -> int64 conversion, the phase the int64
// rounded once to float32 times 2^-47 (exact): two conversions an element
// where the first design took six through float64 (their 32-bit integer
// form measured slower). A constant frequency needs no scan: the prefix
// of element i is i q mod 2^47, one multiply. The sums in int64 cannot
// overflow: a tile's total is below 2^59 before its mask. What holds it:
// the look-back's waits, not the pass, which alone runs at 90% of the
// bytes' rate.
//
// K3 grain_overlap_add (flan_tpu/audio/synthesis.py:708-756, the planned
// granulate render, and :361-421, texture's modded grains). XLA adds the
// grains' 128-sample rows into the output by K host-planned gathers, in
// grain order. On the card an index_add_ would add by atomics in no fixed
// order. Here every output sample is one thread's sum, in the host plan's
// order, written once.
// Function, for output block o (128 samples), channel c, lane l:
//   acc = +0; for g in entries[offsets[o] .. offsets[o + 1]) (grains in
//   ascending order): j = (o - q_g) 128 + l, lane = j - r_off_g; if
//   0 <= lane < lens_g:
//     env = 1; if lane < sf_g: env = sqrt(max(lane, 0) / max(sf_g, 1))
//     if lens_g - ef_g <= lane: env = min(env, sqrt(max(lens_g - 1 -
//       lane, 0) / max(ef_g, 1)))
//     env = env * envp[g, j] where an envelope plane is given
//     acc = acc + x[c, g, clip(s0_g + lane, 0, n_clip - 1)] env
//   out[c, 128 o + l] = acc
// each product, quotient, root and sum rounded on its own, as the plain
// version's separate operations are. A lane outside [0, lens) would add x
// times 0, which leaves a sum that starts at +0 unchanged for finite x: it
// is skipped.
// Bound: the larger of the bytes (the source read once, the plan read
// once and the output written once: the grains overlap K times, but the
// bound counts each input byte once) and the operations the plan needs (a
// multiply and an add a live lane and channel, a division and a root a
// fade lane); for granulate the bytes.
// Design: a block of 8 warps takes a run of 8 consecutive output blocks
// and two channels, a warp an output block, a lane 4 samples 32 apart
// (neighbouring lanes on neighbouring addresses). The run's CSR span is
// contiguous: the block stages it in shared memory once, coalesced, each
// entry with its grain's metadata, in pieces of kList entries in order
// when it is longer, so that the grain loop reads shared memory where the
// first design made two dependent global loads a grain. A lane computes
// each grain's envelope (and reads envp) once for both channels, and
// adds each grain into its 4 samples of both channels (8 loads in flight
// a grain), each channel's sum in ascending grain order. Unrolling over
// grains (kUnroll) keeps more loads in flight but costs registers and
// occupancy, and measured slower on granulate's call.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kSub = 4;                          // sub-tiles a tile
constexpr int kSubTile = 4 * kScanThreads;       // a float4 a thread
constexpr int kScanTile = kSub * kSubTile;       // 4096
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kFracBits = 47;
constexpr long long kMask = (1ll << kFracBits) - 1;
// a tile's published word: its sum, and in bits 62-63 whether the sum is
// the tile's own total or its inclusive prefix (0: nothing yet)
constexpr unsigned long long kTotal = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBlock = 128;                  // K3's output block
constexpr int kRun = 8;                      // output blocks a K3 block
constexpr int kGrainThreads = 32 * kRun;     // a warp an output block
constexpr int kLanePer = kBlock / 32;        // samples a lane
constexpr int kChans = 2;                    // channels a K3 block
constexpr int kList = 256;                   // plan entries staged at once
constexpr int kUnroll = 1;                   // grains whose loads fly at once

// float32 mod(x, 1) as jnp.mod / torch.remainder give it: RN(x -
// trunc(x)), + 1 (rounded) where negative, which is RN(x - floor(x)).
// For |x| < 2^22 the nearest integer t comes from two additions, x - t is
// exact and in [-1/2, 1/2], and + 1 where negative is that same rounding;
// larger (and NaN) x take truncf.
__device__ __forceinline__ float frac1(float x) {
  float r;
  if (fabsf(x) < 0x1p22f) {
    r = __fsub_rn(x, __fsub_rn(__fadd_rn(x, 0x1.8p23f), 0x1.8p23f));
  } else {
    r = __fsub_rn(x, truncf(x));
  }
  return r < 0.f ? __fadd_rn(r, 1.f) : r;
}

// rint(r 2^47), half to even: r 2^47 is exact in float32 (r in [0, 1]).
// A NaN gives 2^63, whose low 47 bits are 0, as the first design's
// __double2ll_rn gave.
__device__ __forceinline__ long long fixed_q(float r) {
  return __float2ll_rn(__fmul_rn(r, 0x1p47f));
}

// float32(run 2^-47) for 0 <= run < 2^47: one rounding to nearest even,
// the scaling exact (no result is subnormal).
__device__ __forceinline__ float phase_of(long long run) {
  return __fmul_rn(__ll2float_rn(run), 0x1p-47f);
}

// Loads the 4 elements i .. i + 3 a thread holds in a sub-tile (0 past
// n).
__device__ __forceinline__ void load_four(const float* __restrict__ f,
                                          long long n, long long i, bool vec,
                                          float (&v)[4]) {
  if (vec && i + 4 <= n) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(f + i));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < n ? __ldcs(f + i + j) : 0.f;
  }
}

// The fixed-point increments q of 4 frequencies v and their sum mod 2^47.
// y: RN(1 / in_rate) where in_rate is in quotient's range, else 0 (the
// library's division throughout).
__device__ __forceinline__ long long four_incs(const float (&v)[4],
                                               float in_rate, float y,
                                               long long (&q)[4]) {
  long long s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x = y != 0.f ? quotient(v[j], in_rate, y)
                             : __fdiv_rn(v[j], in_rate);
    q[j] = fixed_q(frac1(x));
    s += q[j];
  }
  return s & kMask;
}

// Writes the phases of elements i .. i + 3 (those below n) from the sum
// before them and their fixed-point increments.
__device__ __forceinline__ void store_phases(float* __restrict__ phase,
                                             long long n, long long i,
                                             bool vec, long long run,
                                             const long long (&q)[4]) {
  float out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = phase_of(run);
    run = (run + q[j]) & kMask;
  }
  if (vec && i + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(phase + i),
           make_float4(out[0], out[1], out[2], out[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) phase[i + j] = out[j];
  }
}

// Exclusive prefixes within a tile of each thread's kSub sub-tile sums s,
// mod 2^47, in the tile's element order (sub-tile by sub-tile, thread by
// thread); sets *total to the tile's sum. Called once by every thread of
// the block.
__device__ __forceinline__ void tile_prefixes(const long long (&s)[kSub],
                                              long long (&pre)[kSub],
                                              long long* total) {
  constexpr int kSums = kSub * kScanWarps;           // sub-tile-major
  constexpr int kPerLane = (kSums + 31) / 32;
  __shared__ long long sums[kSums];
  __shared__ long long total_sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl[kSub];
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    incl[r] = s[r];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, incl[r], d);
      if (lane >= d) incl[r] = (incl[r] + o) & kMask;
    }
    if (lane == 31) sums[r * kScanWarps + warp] = incl[r];
  }
  __syncthreads();
  if (warp == 0) {
    long long v[kPerLane], run = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = lane * kPerLane + k;
      v[k] = idx < kSums ? sums[idx] : 0;
      run = (run + v[k]) & kMask;
    }
    long long ex = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, ex, d);
      if (lane >= d) ex = (ex + o) & kMask;
    }
    ex = (ex - run + (1ll << kFracBits)) & kMask;      // exclusive
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = lane * kPerLane + k;
      if (idx < kSums) sums[idx] = ex;
      ex = (ex + v[k]) & kMask;
    }
    if (lane == 31) total_sm = ex;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSub; ++r)
    pre[r] = (sums[r * kScanWarps + warp] + incl[r] - s[r] +
              (1ll << kFracBits)) & kMask;
  *total = total_sm;
}

// A published word is read and written whole: its value and its status
// travel together, so no ordering beyond the word's own is needed.
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The sum of the tiles before `tile`, mod 2^47, by warp 0: it reads the
// words of the 32 tiles below a point at once, waits until each is
// published, and adds the totals down to the nearest inclusive prefix (or
// all 32 and moves down). Called by every thread of the block, which all
// get the sum.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, long long tile) {
  __shared__ long long before_sm;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long before = 0;
    for (long long top = tile - 1;; top -= 32) {
      const long long idx = top - lane;
      unsigned long long w = idx >= 0 ? load_word(status + idx) : kInclusive;
      while (__any_sync(kFull, (w >> 62) == 0))
        if ((w >> 62) == 0) w = load_word(status + idx);
      const unsigned incl = __ballot_sync(kFull, (w >> 62) == 2);
      const int last = incl ? __ffs(incl) - 1 : 31;
      long long v = lane <= last ? (long long)(w & kMask) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v = (v + __shfl_xor_sync(kFull, v, d)) & kMask;
      before = (before + v) & kMask;
      if (incl) break;
    }
    if (lane == 0) before_sm = before;
  }
  __syncthreads();
  const long long before = before_sm;
  __syncthreads();                       // before_sm free for a next use
  return before;
}

// scratch: a ticket word, then a published word a tile, all zero at the
// launch. A thread holds a float4 of each of a tile's kSub sub-tiles, so
// that a warp's loads and stores cover 512 contiguous bytes. The grid is
// persistent (as many blocks as the card holds at once), and a block
// holds three tiles taken by tickets in turn: t, in its look-back; t2,
// its increments held and its total already published; t3, loading. So a
// block waiting in a look-back keeps its next loads in flight, and no
// tile's total waits for its block's look-back (which, the other way
// round, made the look-backs wait on one another in convoy).
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
  if (threadIdx.x == 0) {
    ticket_sm[0] = atomicAdd(ticket, 1u);
    ticket_sm[1] = atomicAdd(ticket, 1u);
  }
  __syncthreads();
  long long t = ticket_sm[0], t2 = ticket_sm[1];
  long long q[kSub][4], pre[kSub], total = 0;
  if (t < ntiles) {
    long long s[kSub];
#pragma unroll
    for (int k = 0; k < kSub; ++k)
      load_four(f, n, t * kScanTile + k * kSubTile + lane0, vec, v[k]);
#pragma unroll
    for (int k = 0; k < kSub; ++k) s[k] = four_incs(v[k], in_rate, y, q[k]);
    tile_prefixes(s, pre, &total);
    if (threadIdx.x == 0)
      store_word(status + t, (t == 0 ? kInclusive : kTotal) | total);
  }
  if (t2 < ntiles) {
#pragma unroll
    for (int k = 0; k < kSub; ++k)
      load_four(f, n, t2 * kScanTile + k * kSubTile + lane0, vec, v[k]);
  }
  for (int it = 0; t < ntiles; ++it) {
    // t2: its increments and total, published before t's look-back; t3
    // taken and loading
    long long q2[kSub][4], pre2[kSub], total2 = 0, t3 = ntiles;
    if (t2 < ntiles) {
      long long s2[kSub];
#pragma unroll
      for (int k = 0; k < kSub; ++k)
        s2[k] = four_incs(v[k], in_rate, y, q2[k]);
      if (threadIdx.x == 0) ticket_sm[it & 1] = atomicAdd(ticket, 1u);
      tile_prefixes(s2, pre2, &total2);
      if (threadIdx.x == 0) store_word(status + t2, kTotal | total2);
      t3 = ticket_sm[it & 1];
      if (t3 < ntiles) {
#pragma unroll
        for (int k = 0; k < kSub; ++k)
          load_four(f, n, t3 * kScanTile + k * kSubTile + lane0, vec, v[k]);
      }
    }
    const long long before = look_back(status, t);
    if (threadIdx.x == 0 && t > 0)
      store_word(status + t,
                 kInclusive | (unsigned long long)((before + total) & kMask));
#pragma unroll
    for (int k = 0; k < kSub; ++k)
      store_phases(phase, n, t * kScanTile + k * kSubTile + lane0, vec,
                   (pre[k] + before) & kMask, q[k]);
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      pre[k] = pre2[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[k][j] = q2[k][j];
    }
    total = total2;
    t = t2;
    t2 = t3;
  }
}

// A constant increment q_const: the sum before element i is i q_const mod
// 2^47 (the product wraps mod 2^64, a multiple of 2^47).
__global__ void __launch_bounds__(kScanThreads)
cycle_scan_constant(long long q_const, long long n,
                    float* __restrict__ phase) {
  const bool vec = (reinterpret_cast<uintptr_t>(phase) & 15) == 0;
  const long long i0 = (long long)blockIdx.x * kScanTile +
                       4 * (long long)threadIdx.x;
  const long long q[4] = {q_const, q_const, q_const, q_const};
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const long long i = i0 + (long long)k * kSubTile;
    store_phases(phase, n, i, vec,
                 (long long)((unsigned long long)i *
                             (unsigned long long)q_const) & kMask, q);
  }
}

// One warp an output block of the run, a lane kLanePer samples kBlock / 32
// apart; the plan's entries of the run staged in shared memory kList at a
// time. Channels c0 and c0 + 1 (the second only if `pair`).
__global__ void __launch_bounds__(kGrainThreads)
grain_overlap_add(const float* __restrict__ x, long long chan_stride,
                  long long grain_stride, long long n_clip,
                  const int* __restrict__ meta, int grains,
                  const float* __restrict__ envp, int la,
                  const long long* __restrict__ offsets,
                  const int* __restrict__ entries, float* __restrict__ out,
                  int channels, long long out_n, long long nblk) {
  __shared__ long long offs[kRun + 1];
  __shared__ int s_g[kList], s_s0[kList], s_len[kList], s_sf[kList],
      s_ef[kList], s_roff[kList], s_jb[kList];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long o0 = (long long)blockIdx.x * kRun;
  const int c0 = blockIdx.y * kChans;
  const bool pair = c0 + 1 < channels;
  if (threadIdx.x <= kRun)
    offs[threadIdx.x] = offsets[min(o0 + threadIdx.x, nblk)];
  __syncthreads();
  const long long e_begin = offs[0], e_end = offs[kRun];
  const long long b0 = offs[warp], b1 = offs[warp + 1];
  const float* x0 = x + (long long)c0 * chan_stride;
  const float* x1 = pair ? x0 + chan_stride : x0;
  float acc0[kLanePer], acc1[kLanePer];
#pragma unroll
  for (int k = 0; k < kLanePer; ++k) acc0[k] = acc1[k] = 0.f;
  // j of this lane's first sample in an output block q_g, less (o0 - q_g)
  const int j_lane = warp * kBlock + lane;
  for (long long p = e_begin; p < e_end; p += kList) {
    const int cnt = (int)min((long long)kList, e_end - p);
    __syncthreads();                       // the last piece is read
    for (int i = threadIdx.x; i < cnt; i += kGrainThreads) {
      const int g = entries[p + i];
      s_g[i] = g;
      s_s0[i] = meta[g];
      s_len[i] = meta[grains + g];
      s_sf[i] = meta[2 * grains + g];
      s_ef[i] = meta[3 * grains + g];
      s_roff[i] = meta[4 * grains + g];
      s_jb[i] = (int)((o0 - meta[5 * grains + g]) * kBlock);
    }
    __syncthreads();
    const int lo = (int)(max(b0, p) - p), hi = (int)(min(b1, p + cnt) - p);
    for (int i = lo; i < hi; i += kUnroll) {
      float v0[kUnroll][kLanePer], v1[kUnroll][kLanePer];
      float env[kUnroll][kLanePer];
      bool live[kUnroll][kLanePer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool on = i + u < hi;
        const int e = on ? i + u : i;
        const int g = s_g[e], s0 = s_s0[e], len = s_len[e], sf = s_sf[e],
                  ef = s_ef[e], roff = s_roff[e];
        const int j0 = s_jb[e] + j_lane;
#pragma unroll
        for (int k = 0; k < kLanePer; ++k) {
          const int j = j0 + 32 * k;
          const int ln = j - roff;
          live[u][k] = on && ln >= 0 && ln < len;
          float ev = 1.f;
          v0[u][k] = v1[u][k] = 0.f;
          if (live[u][k]) {
            const float lane_f = (float)ln;
            if (ln < sf)
              ev = __fsqrt_rn(__fdiv_rn(fmaxf(lane_f, 0.f),
                                        (float)max(sf, 1)));
            if (ln >= len - ef) {
              const float d = __fsub_rn(__fsub_rn((float)len, 1.f), lane_f);
              ev = fminf(ev, __fsqrt_rn(__fdiv_rn(fmaxf(d, 0.f),
                                                  (float)max(ef, 1))));
            }
            if (envp != nullptr)
              ev = __fmul_rn(ev, __ldg(envp + (long long)g * la + j));
            long long idx = (long long)s0 + ln;
            idx = idx < 0 ? 0 : (idx > n_clip - 1 ? n_clip - 1 : idx);
            const long long at = (long long)g * grain_stride + idx;
            v0[u][k] = __ldg(x0 + at);
            if (pair) v1[u][k] = __ldg(x1 + at);
          }
          env[u][k] = ev;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kLanePer; ++k)
          if (live[u][k]) {
            acc0[k] = __fadd_rn(acc0[k], __fmul_rn(v0[u][k], env[u][k]));
            acc1[k] = __fadd_rn(acc1[k], __fmul_rn(v1[u][k], env[u][k]));
          }
    }
  }
  const long long o = o0 + warp;
  if (o >= nblk) return;
#pragma unroll
  for (int k = 0; k < kLanePer; ++k) {
    const long long pos = o * kBlock + lane + 32 * k;
    if (pos < out_n) {
      out[(long long)c0 * out_n + pos] = acc0[k];
      if (pair) out[(long long)(c0 + 1) * out_n + pos] = acc1[k];
    }
  }
}

}  // namespace

extern "C" {

int flan_cycle_scan_tile() { return kScanTile; }
int flan_cycle_scan_frac_bits() { return kFracBits; }
int flan_grain_block() { return kBlock; }

// f [n] float32 (or null: every increment q_const); scratch: for f, 1 +
// ceil(n / 4096) int64 words, 8-byte aligned and zero (null for a
// constant); phase [n] float32.
int flan_cycle_scan(const float* f, long long q_const, float in_rate,
                    long long n, long long* scratch, float* phase,
                    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kScanTile - 1) / kScanTile;
  if (ntiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f == nullptr) {
    cycle_scan_constant<<<(unsigned)ntiles, kScanThreads, 0, s>>>(q_const, n,
                                                                  phase);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  // a persistent grid: as many blocks as the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cycle_scan_pass, kScanThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * per_sm;
  const long long blocks = ntiles < resident ? ntiles : resident;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  cycle_scan_pass<<<(unsigned)blocks, kScanThreads, 0, s>>>(
      f, in_rate, n, ntiles, reinterpret_cast<unsigned long long*>(scratch),
      phase);
  return (int)cudaGetLastError();
}

// x: the source (channel c of grain g at x + c chan_stride + g
// grain_stride, n_clip samples); meta [6, grains] int32 rows s0, lens, sf,
// ef, r_off, q; envp [grains, la] float32 or null; offsets [nblk + 1]
// int64 and entries int32 the CSR plan over the output's nblk =
// ceil(out_n / 128) blocks; out [channels, out_n] float32.
int flan_grain_overlap_add(const float* x, long long chan_stride,
                           long long grain_stride, long long n_clip,
                           const int* meta, int grains, const float* envp,
                           int la, const long long* offsets,
                           const int* entries, float* out, int channels,
                           long long out_n, void* stream) {
  if (out_n < 1 || channels < 1 || n_clip < 1 || grains < 1)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (out_n + kBlock - 1) / kBlock;
  const long long runs = (nblk + kRun - 1) / kRun;
  const long long pairs = (channels + kChans - 1) / kChans;
  if (runs > 0x7fffffffll || pairs > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)runs, (unsigned)pairs);
  grain_overlap_add<<<grid, kGrainThreads, 0, (cudaStream_t)stream>>>(
      x, chan_stride, grain_stride, n_clip, meta, grains, envp, la, offsets,
      entries, out, channels, out_n, nblk);
  return (int)cudaGetLastError();
}

}  // extern "C"
