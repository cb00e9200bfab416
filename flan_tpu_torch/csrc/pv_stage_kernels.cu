// The phase vocoder's analysis epilogue (H1) and synthesis prologue (H2),
// as Hopper kernels: the elementwise work around cuFFT on the stretch's
// main path (ops/stft.py pv_forward / pv_inverse, pipelines/streamed.py
// _analysis / _synthesis).
//
// They replace no TPU kernel: flan_tpu/ops/stft.py (rfft_mag_phase :92,
// _wrap_radians :71, cumsum_mod1_frames :134, pv_forward :172, pv_inverse
// :218) and flan_tpu/pipelines/streamed.py (_streamed_scan :74) leave this
// to XLA, which fuses it. In plain PyTorch the same work is some thirty
// elementwise passes a chunk over planes of 67-134 MB. The plain versions
// are flan_tpu_torch/ops/pv_stages.py analysis_ref and synthesis_ref; each
// kernel gives their bits on the card: every torch operation there is
// rounded on its own, so every product, sum, quotient and root here is an
// explicitly rounded intrinsic (nvcc would otherwise contract a product
// and a sum into an FMA), in the plain version's order.
//
// H1, for spectrum rows r, frames j < H, bins b < B (spec complex64):
//   e = re^2 + im^2, mag = sqrt(e), phase = atan2_poly(im, re) (0 where
//   e == 0); d = (phase - prev) - expected[b]; d -= 2pi rint(d / 2pi)
//   (the quotient as torch's CUDA takes it: d times float32(1) /
//   float32(2pi)); freq = bin_freq[b] + d * scale. prev is frame j - 1's
//   phase; frame 0's is the carried phase (prev given), or frame 0 is a
//   helper hop that is not written and frames 1 .. dead - 1 take 0.
// Bound: bytes. It reads the spectrum (8 bytes an element) and writes mag
// and freq (8): 134 MB a chunk of the 600 s stretch, 40 us at 3.35 TB/s;
// the function's 57 operations an element (chip_smoke.py H1_OPS) take
// 14 us at the H100's issue rate.
// Design: a thread walks a run of kRun frames of one bin in order, keeping
// the last phase in a register; the run's first frame recomputes its
// predecessor's phase from the spectrum (1 / kRun more reads). Lanes are
// consecutive bins, so every load and store of a warp is one coalesced
// line. The rows of complex64 are only 8-byte aligned at odd B (2049), so
// each lane loads one float2.
//
// H2, for channels c, output frames j < F, bins b < B:
//   (with a plan) the remap of ops/pv_stages.py remap: from input frames
//     li[j], li[j] + 1,
//     w0 = (1 - mix[j]) m0, w1 = mix[j] m1, mag = w0 + w1, freq = (w0 f0 +
//     w1 f1) / mag where mag > 0 (else 0); both 0 where valid[j] is false;
//   inc = remainder(freq / rate, 1) in float32 (an IEEE quotient);
//   cycles as ops/phase_math.py cumsum_mod1_frames: float64 sums in frame
//     order within blocks of kCum frames; the blocks' totals mod 1, summed in
//     order and each partial sum mod 1 (the exclusive prefix);
//     remainder(within + prefix, 1) rounded to float32; then remainder(. +
//     carried cycle, 1) in float32;
//   spec = (mag cos(cycles 2pi), mag sin(cycles 2pi)) complex64; the last
//     frame's cycle is carried.
// Bound: bytes. It reads the planes it touches (8 bytes an input element)
// and writes the spectrum (8 an output element): 201.5 MB a chunk of the
// 600 s stretch, 60.2 us at 3.35 TB/s (the class path's 2,048 frames
// 134 MB, 40.1 us). The function's operations an output element
// (chip_smoke.py H2_OPS, H2_REMAP_OPS, H2_F64_OPS: the remap, two
// correctly rounded divisions, the remainders, the float64 sums, sincos)
// take 40.6 us at the H100's rates.
// Design: every element read, computed and written once. A block a
// (channel, kBins bins, block of kCum frames), two blocks an SM: a thread
// a bin (lane) and a segment of kSeg frames (warp) taken in order, in
// batches of kBatch (kRowBatch without a plan) whose loads are all issued
// before their arithmetic (the plan rows staged in shared memory first);
// each frame's magnitude and increment stay in shared memory for the
// write.
// The float64 sums in any order: while every increment of a column is a
// multiple of 2^-45 (every float32 in [2^-22, 1], and 0), each partial sum
// of a block (at most 2^8) is exact in float64, so the sum in frame order
// is the warps' segment sums added in any order. A column holding another
// increment (0 < freq / rate < 2^-22 with low bits set: a flag in shared
// memory, then __syncthreads_or) is summed in frame order instead, the
// warps in turn from the sum the warp before left: the plain version's
// float64 additions. The blocks of a (channel, kBins bins) form one
// thread-block cluster of up to kCluster: after a cluster barrier, warp 0
// of every block reads the cluster's totals mod 1 from distributed shared
// memory and chains them in frame order (run += total, prefix =
// rem1d(run before)); a chunk of more blocks takes them in turns of
// kCluster, the chain carried. A call that wants only the last cycle
// (write == 0: the sharded paths' totals) writes nothing else.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 162.3 us a
// streamed chunk (37% of the byte bound) and 74-75 us on the class path's
// 2,048 frames (53-54%), from 315 and 165. No single part holds it
// (ops/spv_variants.py --source pv_stages): the increments' arithmetic
// ~26 us of the one walk, the spectrum's stores ~19, the cluster's
// barrier and chain ~5-10, sincosf ~6; staging the input rows in shared
// memory, a persistent grid that writes one item while it loads the
// next, 16 bins a block and clusters of 4 or 16 measured no faster. K2's
// reciprocal quotient by the rate read 4-9 us less a streamed chunk, not
// kept: one division, the library's.

#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kRun = 16;       // H1: frames a thread walks
constexpr int kH1Threads = 128;
constexpr int kCum = 256;      // H2: frames a block of the float64 cumsum
constexpr int kBins = 32;      // H2: bins a block
constexpr int kSeg = 16;       // H2: frames a thread takes, in order
constexpr int kSegs = kCum / kSeg;          // H2: segments a block
constexpr int kH2Threads = kBins * kSegs;
constexpr int kH2Blocks = 65536 / (64 * kH2Threads);  // at 64 registers
constexpr int kCluster = 8;    // H2: frame blocks a cluster chains at once
constexpr int kBatch = 4;      // H2: frames whose loads fly together
constexpr int kRowBatch = 8;   // H2: the same without a plan (2 loads)
// H2's dynamic shared memory: a block's magnitudes and increments
constexpr int kH2Smem = 2 * kCum * kBins * (int)sizeof(float);
constexpr float kFixed = 0x1p45f;  // an increment times this is whole: exact

__device__ __forceinline__ float atan_poly_rn(float z) {
  const float z2 = __fmul_rn(z, z);
  float p = -0.004668773f;
  p = __fadd_rn(__fmul_rn(p, z2), 0.02416619f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.0593671f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.09906097f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.14016585f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.19969235f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.3333196f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.9999999f);
  return __fmul_rn(z, p);
}

// ops/fastmath.py atan2 on one element, each operation rounded alone.
__device__ __forceinline__ float atan2_poly_rn(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float at = atan_poly_rn(__fdiv_rn(lo, fmaxf(hi, 1e-37f)));
  if (ay > ax) at = __fsub_rn(1.57079632679489661923f, at);
  if (x < 0.f) at = __fsub_rn(3.14159265358979323846f, at);
  return y < 0.f ? -at : at;
}

// (mag, phase) of one spectrum element, as ops/pv_stages.py analysis_ref.
__device__ __forceinline__ float phase_of(float2 v, float* mag) {
  const float e = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  *mag = __fsqrt_rn(e);
  return e == 0.f ? 0.f : atan2_poly_rn(v.y, v.x);
}

// torch.remainder(x, 1.0): fmod(x, 1), then + 1 (rounded) below 0. The
// fmod is x - trunc(x) with x's sign, exact for every finite x: the
// library's fmod loops over the exponents' difference.
__device__ __forceinline__ float rem1f(float x) {
  const float m = copysignf(__fsub_rn(x, truncf(x)), x);
  return m < 0.f ? __fadd_rn(m, 1.f) : m;
}
__device__ __forceinline__ double rem1d(double x) {
  const double m = copysign(__dsub_rn(x, trunc(x)), x);
  return m < 0.0 ? __dadd_rn(m, 1.0) : m;
}

__global__ void __launch_bounds__(kH1Threads)
pv_analysis(const float2* __restrict__ spec, int H, int B, int nruns,
            const float* __restrict__ prev, int dead,
            const float* __restrict__ bin_freq,
            const float* __restrict__ expected, float inv_two_pi,
            float two_pi, float scale, float* __restrict__ mag,
            float* __restrict__ freq, long long out_row,
            float* __restrict__ carry) {
  const int groups = (B + kH1Threads - 1) / kH1Threads;
  const int run = blockIdx.x / groups;
  const int b = (blockIdx.x % groups) * kH1Threads + threadIdx.x;
  if (b >= B || run >= nruns) return;
  const long long row = blockIdx.y;
  const int j0 = run * kRun, j1 = min(j0 + kRun, H);
  const int skip = prev ? 0 : 1;
  const float2* s = spec + row * H * B + b;
  float* m_out = mag + row * out_row + b;
  float* f_out = freq + row * out_row + b;
  float m, last;
  if (j0 > 0) last = phase_of(s[(long long)(j0 - 1) * B], &m);
  else last = prev ? prev[row * B + b] : 0.f;
  const float bf = bin_freq[b], ex = expected[b];
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const float ph = phase_of(s[(long long)j * B], &m);
    if (j >= skip) {
      const float p = j < dead ? 0.f : last;
      float d = __fsub_rn(__fsub_rn(ph, p), ex);
      d = __fsub_rn(d, __fmul_rn(two_pi, rintf(__fmul_rn(d, inv_two_pi))));
      const long long o = (long long)(j - skip) * B;
      m_out[o] = m;
      f_out[o] = __fadd_rn(bf, __fmul_rn(d, scale));
    }
    last = ph;
  }
  if (carry && j1 == H) carry[row * B + b] = last;
}

// One output frame's magnitude and float32 increment from its inputs: with
// a plan the remap of frames i (weight 1 - a) and i + 1 (weight a), zero
// outside the map; without, the frame itself (m0, q0).
template <bool kPlan>
__device__ __forceinline__ float increment(float m0, float m1, float q0,
                                           float q1, float a, bool ok,
                                           float rate, float* mag) {
  float mv = m0, fv = q0;
  if (kPlan) {
    const float w0 = __fmul_rn(__fsub_rn(1.f, a), m0);
    const float w1 = __fmul_rn(a, m1);
    const float total = __fadd_rn(w0, w1);
    const float fsum = __fadd_rn(__fmul_rn(w0, q0), __fmul_rn(w1, q1));
    mv = ok ? total : 0.f;
    fv = ok && total > 0.f ? __fdiv_rn(fsum, total) : 0.f;
  }
  *mag = mv;
  return rem1f(__fdiv_rn(fv, rate));
}

// One output frame's spectrum element from its float64 sum x within the
// block, the block's prefix and the carried cycle: the cycle mod 1, then
// mag (cos, sin)(2 pi cycle).
__device__ __forceinline__ float2 polar(double x, double pre, float c0,
                                        float m, float two_pi) {
  const float cyc = rem1f(__fadd_rn(
      __double2float_rn(rem1d(__dadd_rn(x, pre))), c0));
  float sn, cs;                 // sinf's and cosf's bits (the card tests)
  sincosf(__fmul_rn(cyc, two_pi), &sn, &cs);
  return make_float2(__fmul_rn(m, cs), __fmul_rn(m, sn));
}

template <bool kPlan>
__global__ void __launch_bounds__(kH2Threads, kH2Blocks)
pv_synthesis(const float* __restrict__ mag, const float* __restrict__ freq,
             long long in_row, const long long* __restrict__ li,
             const float* __restrict__ mix,
             const unsigned char* __restrict__ valid, long long F, int B,
             float rate, const float* cycle_in, float* cycle_out,
             float2* __restrict__ spec, float two_pi) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  // each frame's magnitude and increment, computed once, read to write
  extern __shared__ float s_vals[];
  float (*s_mag)[kBins] = reinterpret_cast<float (*)[kBins]>(s_vals);
  float (*s_inc)[kBins] =
      reinterpret_cast<float (*)[kBins]>(s_vals + kCum * kBins);
  __shared__ int s_li[kCum];          // the block's plan rows
  __shared__ float s_mix[kCum];
  __shared__ unsigned char s_ok[kCum];
  __shared__ double seg[kSegs][kBins];  // each segment's sum of its frames
  __shared__ double chain[kBins];     // a column's sum in frame order
  __shared__ double totals[2][kBins];  // the block's total mod 1, by turn
  __shared__ double prefix[kBins];
  __shared__ int dirty[kBins];        // a column summed in frame order
  // a thread a bin and a segment of kSeg frames
  const int lane = threadIdx.x % kBins, sg = threadIdx.x / kBins;
  const unsigned ncl = cluster.num_blocks(), rank = cluster.block_rank();
  const int c = blockIdx.y;
  const int b = (int)(blockIdx.x / ncl) * kBins + lane;
  const bool live = b < B;
  const int bb = live ? b : B - 1;
  const float* m_in = mag + c * in_row + bb;
  const float* f_in = freq + c * in_row + bb;
  const float c0 = (cycle_in && live) ? cycle_in[(long long)c * B + b] : 0.f;
  float2* out = spec ? spec + (long long)c * F * B + bb : nullptr;
  const long long nblk = (F + kCum - 1) / kCum;
  const int r0 = sg * kSeg;           // the thread's first row of a block
  if (threadIdx.x < kBins) dirty[threadIdx.x] = 0;
  __syncthreads();       // cleared before any warp marks a column
  double run = 0.0;      // segment 0: the totals mod 1 before the turn
  for (long long base = 0; base < nblk; base += ncl) {
    const long long k = base + rank;
    const int par = (int)((base / ncl) & 1);
    const long long f0 = k * kCum;                   // the block's frames
    const int n = k < nblk ? (int)min((long long)kSeg, max(0LL, F - f0 - r0))
                           : 0;
    if (kPlan) {
      for (int r = threadIdx.x; r < kCum; r += kH2Threads)
        if (k < nblk && f0 + r < F) {
          s_li[r] = (int)li[f0 + r];
          s_mix[r] = mix[f0 + r];
          s_ok[r] = valid[f0 + r];
        }
      __syncthreads();
    }
    double d = 0.0;      // the segment's sum: exact while `clean`
    bool clean = true;
    // the thread's frames in batches, each batch's loads issued first
    constexpr int batch = kPlan ? kBatch : kRowBatch;
#pragma unroll
    for (int u0 = 0; u0 < kSeg; u0 += batch) {
      float m0[batch], m1[batch], q0[batch], q1[batch];
      if (u0 < n) {
#pragma unroll
        for (int u = 0; u < batch; ++u) {
          const int r = r0 + min(u0 + u, n - 1);   // in bounds, unguarded
          const long long i = kPlan ? (long long)s_li[r] : f0 + r;
          m0[u] = kPlan || out ? m_in[i * B] : 0.f;
          q0[u] = f_in[i * B];
          m1[u] = kPlan ? m_in[(i + 1) * B] : 0.f;
          q1[u] = kPlan ? f_in[(i + 1) * B] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < batch; ++u) {
        const int r = r0 + u0 + u;
        float mv = 0.f, v = 0.f;
        if (u0 + u < n)
          v = increment<kPlan>(m0[u], m1[u], q0[u], q1[u],
                               kPlan ? s_mix[r] : 0.f,
                               kPlan ? s_ok[r] != 0 : true, rate, &mv);
        s_mag[r][lane] = mv;
        s_inc[r][lane] = v;
        d = __dadd_rn(d, (double)v);
        const float q = __fmul_rn(v, kFixed);
        clean = clean && q == truncf(q);
      }
    }
    seg[sg][lane] = d;
    if (!clean && live) dirty[lane] = 1;
    const bool any = __syncthreads_or(!clean && live) != 0;
    const bool mine = dirty[lane] != 0;
    double start = 0.0;  // the column's sum before the thread's frames
    if (any) {
      // the columns summed in frame order: the segments in turn
      for (int s = 0; s < kSegs; ++s) {
        if (sg == s && mine) {
          double x = s == 0 ? 0.0 : chain[lane];
          start = x;
#pragma unroll
          for (int u = 0; u < kSeg; ++u)
            x = __dadd_rn(x, (double)s_inc[r0 + u][lane]);
          chain[lane] = x;
        }
        __syncthreads();
      }
    }
    if (!mine)
      for (int s = 0; s < sg; ++s) start = __dadd_rn(start, seg[s][lane]);
    double total = 0.0;
    if (sg == 0) {
      if (mine) {
        total = chain[lane];
      } else {
#pragma unroll
        for (int s = 0; s < kSegs; ++s)
          total = __dadd_rn(total, seg[s][lane]);
      }
      totals[par][lane] = rem1d(total);
    }
    cluster.sync();
    if (sg == 0) {
      dirty[lane] = 0;
      // the cluster's totals, every load issued before the chain
      double t[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        t[q] = q < (int)ncl && base + q < nblk
                   ? cluster.map_shared_rank(&totals[par][0], q)[lane]
                   : 0.0;
      double pre = 0.0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        if (q < (int)ncl && base + q < nblk) {
          if (q == (int)rank) pre = rem1d(run);
          run = __dadd_rn(run, t[q]);
        }
      }
      prefix[lane] = pre;
      if (k == nblk - 1 && live) {
        // the last frame's cycle: its sum within the block is the total
        const float last = __double2float_rn(rem1d(__dadd_rn(total, pre)));
        cycle_out[(long long)c * B + b] =
            cycle_in ? rem1f(__fadd_rn(last, c0)) : last;
      }
    }
    __syncthreads();
    if (out && live) {
      const double pre = prefix[lane];
      double x = start;
#pragma unroll 4
      for (int u = 0; u < n; ++u) {
        const int r = r0 + u;
        x = __dadd_rn(x, (double)s_inc[r][lane]);
        out[(f0 + r) * B] = polar(x, pre, c0, s_mag[r][lane], two_pi);
      }
    }
  }
  cluster.sync();        // no block leaves while the cluster reads it
}

// pv_synthesis<kPlan>'s dynamic shared memory limit, set once a device:
// the attribute holds for the process, so later launches skip the call.
template <bool kPlan>
cudaError_t allow_synthesis_smem() {
  static std::atomic<unsigned long long> set{0};   // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (set.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(pv_synthesis<kPlan>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kH2Smem);
  if (err == cudaSuccess) set.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool kPlan>
cudaError_t launch_synthesis(dim3 grid, unsigned ncl, cudaStream_t stream,
                             const float* mag, const float* freq,
                             long long in_row, const long long* li,
                             const float* mix, const unsigned char* valid,
                             long long F, int B, float rate,
                             const float* cycle_in, float* cycle_out,
                             float2* spec, float two_pi) {
  const cudaError_t err = allow_synthesis_smem<kPlan>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kH2Threads);
  cfg.dynamicSmemBytes = kH2Smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pv_synthesis<kPlan>, mag, freq, in_row,
                            li, mix, valid, F, B, rate, cycle_in, cycle_out,
                            spec, two_pi);
}

}  // namespace

extern "C" {

int flan_pv_analysis_run() { return kRun; }
int flan_pv_cumsum_block() { return kCum; }

// spec [rows, H, B] complex64 (float2); prev [rows, B] or null (frame 0 a
// helper hop, not written; frames 1 .. dead - 1 take a previous phase of
// 0); bin_freq, expected [B]; mag, freq: frame j (from 1 with a helper)
// of row r at r * out_row + (j - skip) * B; carry [rows, B] or null, not
// prev.
int flan_pv_analysis(const void* spec, int rows, int H, int B,
                     const float* prev, int dead, const float* bin_freq,
                     const float* expected, float inv_two_pi, float two_pi,
                     float scale, float* mag, float* freq, long long out_row,
                     float* carry, void* stream) {
  if (rows < 1 || rows > 65535 || H < 1 || B < 1 || (carry && carry == prev))
    return (int)cudaErrorInvalidValue;
  const int nruns = (H + kRun - 1) / kRun;
  const long long blocks =
      (long long)nruns * ((B + kH1Threads - 1) / kH1Threads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pv_analysis<<<dim3((unsigned)blocks, rows), kH1Threads, 0,
                (cudaStream_t)stream>>>(
      (const float2*)spec, H, B, nruns, prev, dead, bin_freq, expected,
      inv_two_pi, two_pi, scale, mag, freq, out_row, carry);
  return (int)cudaGetLastError();
}

// mag, freq: channel c's frame i at c * in_row + i * B; li [F] int64, mix
// [F] float32, valid [F] bool: the plan (all null: frame j is input frame
// j); cycle_in [C, B] the carried cycle, or null with write == 0 (the raw
// last cycle); cycle_out [C, B] (may be cycle_in); spec [C, F, B]
// complex64 when write != 0.
int flan_pv_synthesis(const float* mag, const float* freq, long long in_row,
                      const long long* li, const float* mix,
                      const unsigned char* valid, const float* cycle_in,
                      float* cycle_out, void* spec, int write, int C,
                      long long F, int B, float rate, float two_pi,
                      void* stream) {
  if (C < 1 || C > 65535 || F < 1 || B < 1 || cycle_out == nullptr ||
      (write && (spec == nullptr || cycle_in == nullptr)) ||
      ((li == nullptr) != (mix == nullptr)) ||
      ((li == nullptr) != (valid == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long nblk = (F + kCum - 1) / kCum;
  const unsigned ncl = nblk < kCluster ? (unsigned)nblk : kCluster;
  const long long strips = (B + kBins - 1) / kBins;
  if (strips * ncl > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(strips * ncl), C);
  float2* out = write ? (float2*)spec : nullptr;
  const cudaError_t err =
      li ? launch_synthesis<true>(grid, ncl, (cudaStream_t)stream, mag, freq,
                                  in_row, li, mix, valid, F, B, rate,
                                  cycle_in, cycle_out, out, two_pi)
         : launch_synthesis<false>(grid, ncl, (cudaStream_t)stream, mag,
                                   freq, in_row, li, mix, valid, F, B, rate,
                                   cycle_in, cycle_out, out, two_pi);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
