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
// float32 once, through float64, which lies within the tree's own error.
// Function, for i < n:
//   inc_i  = f_i / in_rate (IEEE division) mod 1 (fmod, +1 if negative),
//            or the host's constant increment
//   q_i    = rint(inc_i 2^47)
//   phase_i = float32((sum_{j < i} q_j mod 2^47) 2^-47); phase_0 = 0
// Bound: bytes. f read once and the phase written once, 8 bytes an
// element (4 for a constant frequency): 3.7 GB at 4.6e8, 1.1 ms.
// Design: three launches. Tiles of 4,096 elements (256 threads x 16):
// cycle_totals sums each tile; cycle_prefix, one block, turns the totals
// into their exclusive prefix; cycle_write rescans each tile (the
// thread's 16 increments, a block scan of the threads' sums) from its
// prefix and writes the phases. The sums in int64 cannot overflow: a
// tile's total is below 2^59 before its mask.
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
// Bound: bytes. The source read once and the output written once (the
// grains overlap K times, but the bound counts each input byte once).
// Design: a block of 128 threads an output block and channel; its CSR list
// of grains read by every thread (broadcast loads), the source read by
// neighbouring threads at neighbouring addresses.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kPerThread = 16;
constexpr int kScanTile = kScanThreads * kPerThread;   // 4096
constexpr int kPrefixThreads = 1024;
constexpr int kFracBits = 47;
constexpr long long kMask = (1ll << kFracBits) - 1;
constexpr double kScale = 140737488355328.0;           // 2^47
constexpr double kInvScale = 1.0 / 140737488355328.0;  // 2^-47
constexpr int kBlock = 128;                            // K3's output block

__device__ __forceinline__ long long fixed_inc(float fv, float in_rate) {
  const float x = __fdiv_rn(fv, in_rate);
  float r = fmodf(x, 1.f);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, 1.f);
  return __double2ll_rn((double)r * kScale);
}

// The thread's 16 fixed-point increments of elements i0 .. i0 + 15 (0 past
// n), from f or the constant.
__device__ __forceinline__ void thread_incs(const float* __restrict__ f,
                                            long long q_const, float in_rate,
                                            long long n, long long i0,
                                            long long* q) {
  if (f == nullptr) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) q[j] = i0 + j < n ? q_const : 0;
    return;
  }
  if (i0 + kPerThread <= n &&
      (reinterpret_cast<uintptr_t>(f + i0) & 15) == 0) {
    const float4* v = reinterpret_cast<const float4*>(f + i0);
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const float4 w = __ldg(v + k);
      q[4 * k] = fixed_inc(w.x, in_rate);
      q[4 * k + 1] = fixed_inc(w.y, in_rate);
      q[4 * k + 2] = fixed_inc(w.z, in_rate);
      q[4 * k + 3] = fixed_inc(w.w, in_rate);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    q[j] = i0 + j < n ? fixed_inc(__ldg(f + i0 + j), in_rate) : 0;
}

// Exclusive scan of one value a thread over a block of kThreadsT threads,
// mod 2^47; returns the thread's prefix and sets *total to the block's
// sum.
template <int kThreadsT>
__device__ __forceinline__ long long block_exclusive(long long v,
                                                     long long* total) {
  __shared__ long long warp_sums[kThreadsT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = (incl + o) & kMask;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kThreadsT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = (w + o) & kMask;
    }
    if (lane < kThreadsT / 32) warp_sums[lane] = w;   // inclusive
  }
  __syncthreads();
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kThreadsT / 32 - 1];
  __syncthreads();                       // warp_sums free for a next call
  return (before + incl - v + (1ll << kFracBits)) & kMask;
}

__global__ void __launch_bounds__(kScanThreads)
cycle_totals(const float* __restrict__ f, long long q_const, float in_rate,
             long long n, long long* __restrict__ totals) {
  long long q[kPerThread];
  const long long i0 =
      (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kPerThread;
  thread_incs(f, q_const, in_rate, n, i0, q);
  long long s = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) s += q[j];
  s &= kMask;
  long long total;
  block_exclusive<kScanThreads>(s, &total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// One block: totals[0 .. ntiles) -> their exclusive prefix mod 2^47.
__global__ void __launch_bounds__(kPrefixThreads)
cycle_prefix(long long* __restrict__ totals, long long ntiles) {
  const long long per = (ntiles + kPrefixThreads - 1) / kPrefixThreads;
  const long long a = min(ntiles, (long long)threadIdx.x * per);
  const long long b = min(ntiles, a + per);
  long long s = 0;
  for (long long i = a; i < b; ++i) s = (s + totals[i]) & kMask;
  long long total;
  long long run = block_exclusive<kPrefixThreads>(s, &total);
  for (long long i = a; i < b; ++i) {
    const long long t = totals[i];
    totals[i] = run;
    run = (run + t) & kMask;
  }
}

__global__ void __launch_bounds__(kScanThreads)
cycle_write(const float* __restrict__ f, long long q_const, float in_rate,
            long long n, const long long* __restrict__ prefix,
            float* __restrict__ phase) {
  long long q[kPerThread];
  const long long i0 =
      (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kPerThread;
  thread_incs(f, q_const, in_rate, n, i0, q);
  long long s = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) s += q[j];
  s &= kMask;
  long long total;
  long long run = (block_exclusive<kScanThreads>(s, &total) +
                   prefix[blockIdx.x]) & kMask;
  float out[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    out[j] = __double2float_rn((double)run * kInvScale);
    run = (run + q[j]) & kMask;
  }
  if (i0 + kPerThread <= n &&
      (reinterpret_cast<uintptr_t>(phase + i0) & 15) == 0) {
    float4* v = reinterpret_cast<float4*>(phase + i0);
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k)
      v[k] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                         out[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (i0 + j < n) phase[i0 + j] = out[j];
  }
}

__global__ void __launch_bounds__(kBlock)
grain_overlap_add(const float* __restrict__ x, long long chan_stride,
                  long long grain_stride, long long n_clip,
                  const int* __restrict__ meta, int grains,
                  const float* __restrict__ envp, int la,
                  const long long* __restrict__ offsets,
                  const int* __restrict__ entries, float* __restrict__ out,
                  long long out_n) {
  const long long o = blockIdx.x;
  const int c = blockIdx.y;
  const int l = threadIdx.x;
  const int* s0 = meta;
  const int* lens = meta + grains;
  const int* sf = meta + 2 * grains;
  const int* ef = meta + 3 * grains;
  const int* r_off = meta + 4 * grains;
  const int* q = meta + 5 * grains;
  const float* xc = x + (long long)c * chan_stride;
  float acc = 0.f;
  const long long e1 = offsets[o + 1];
  for (long long e = offsets[o]; e < e1; ++e) {
    const int g = __ldg(entries + e);
    const long long j = (o - __ldg(q + g)) * kBlock + l;
    const int lane = (int)(j - __ldg(r_off + g));
    const int len = __ldg(lens + g);
    if (lane < 0 || lane >= len) continue;
    const int sfg = __ldg(sf + g), efg = __ldg(ef + g);
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
    long long idx = (long long)__ldg(s0 + g) + lane;
    idx = idx < 0 ? 0 : (idx > n_clip - 1 ? n_clip - 1 : idx);
    const float v = __ldg(xc + (long long)g * grain_stride + idx);
    acc = __fadd_rn(acc, __fmul_rn(v, env));
  }
  const long long pos = o * kBlock + l;
  if (pos < out_n) out[(long long)c * out_n + pos] = acc;
}

}  // namespace

extern "C" {

int flan_cycle_scan_tile() { return kScanTile; }
int flan_cycle_scan_frac_bits() { return kFracBits; }
int flan_grain_block() { return kBlock; }

// f [n] float32 (or null: every increment q_const), totals: int64 scratch
// of ceil(n / 4096) elements, 8-byte aligned; phase [n] float32.
int flan_cycle_scan(const float* f, long long q_const, float in_rate,
                    long long n, long long* totals, float* phase,
                    void* stream) {
  if (n < 1 || (reinterpret_cast<uintptr_t>(totals) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kScanTile - 1) / kScanTile;
  if (ntiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cycle_totals<<<(unsigned)ntiles, kScanThreads, 0, s>>>(f, q_const, in_rate,
                                                         n, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cycle_prefix<<<1, kPrefixThreads, 0, s>>>(totals, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cycle_write<<<(unsigned)ntiles, kScanThreads, 0, s>>>(f, q_const, in_rate,
                                                        n, totals, phase);
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
  if (out_n < 1 || channels < 1 || channels > 65535 || n_clip < 1 ||
      grains < 1)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (out_n + kBlock - 1) / kBlock;
  if (nblk > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)nblk, (unsigned)channels);
  grain_overlap_add<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      x, chan_stride, grain_stride, n_clip, meta, grains, envp, la, offsets,
      entries, out, out_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
