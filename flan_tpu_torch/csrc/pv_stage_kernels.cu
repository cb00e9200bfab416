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
// and writes the spectrum (8 an output element): 201 MB a chunk of the
// 600 s stretch, 60 us at 3.35 TB/s. The function's operations an output
// element (chip_smoke.py H2_OPS, H2_REMAP_OPS, H2_F64_OPS: the remap, two
// correctly rounded divisions, the remainders, the float64 sums, sincos)
// take 41 us at the H100's rates. This design issues more: its second
// walk redoes the remap and the increment, and its loads, index
// arithmetic and shared-memory reads are its own.
// Design: a block a (channel, 32 bins), a warp a block of kCum frames,
// lanes the bins. Each warp stages its frames' plan rows in shared memory
// (lane-parallel loads), then walks its frames in float64 in order for
// the block's total, kUnroll frames at a time with every load of a batch
// issued before its arithmetic (a frame's loads issued alone cost a
// memory latency a frame, with only 16 warps an SM to hide it); warp 0
// prefixes the totals in shared memory (continuing the running sum from
// the pass before); each warp walks its frames again, recomputing the
// remap and the increment rather than storing them, and writes. A chunk
// of more than kWarps blocks goes in passes of kWarps. The last frame's
// cycle comes from the first walk's total and the prefix, so a call that
// only wants it (write == 0: the sharded paths' totals) makes one walk.

#include "common.cuh"

namespace {

constexpr int kRun = 16;       // H1: frames a thread walks
constexpr int kH1Threads = 128;
constexpr int kCum = 256;      // H2: frames a block of the float64 cumsum
constexpr int kWarps = 16;     // H2: frame blocks a pass walks at once
constexpr int kUnroll = 8;     // H2: frames whose loads fly together

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

// Whether a batch of H2's walk holds kUnroll frames (no guards).
template <bool kWhole>
struct Whole {
  static constexpr bool value = kWhole;
};

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

template <bool kPlan>
__global__ void __launch_bounds__(32 * kWarps)
pv_synthesis(const float* __restrict__ mag, const float* __restrict__ freq,
             long long in_row, const long long* __restrict__ li,
             const float* __restrict__ mix,
             const unsigned char* __restrict__ valid, long long F, int B,
             float rate, const float* cycle_in, float* cycle_out,
             float2* __restrict__ spec, float two_pi) {
  __shared__ double totals[kWarps][32];
  __shared__ double prefix[kWarps][32];
  // each warp's block of frames: its plan rows (input frame, mix, valid)
  __shared__ int s_li[kWarps][kCum];
  __shared__ float s_mix[kWarps][kCum];
  __shared__ unsigned char s_ok[kWarps][kCum];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int c = blockIdx.y;
  const int b = blockIdx.x * 32 + lane;
  const bool live = b < B;
  const int bb = live ? b : 0;
  const float* m_in = mag + c * in_row + bb;
  const float* f_in = freq + c * in_row + bb;
  const float c0 = (cycle_in && live) ? cycle_in[(long long)c * B + b] : 0.f;
  float2* out = spec ? spec + (long long)c * F * B + bb : nullptr;
  const long long nblk = (F + kCum - 1) / kCum;
  double run = 0.0;            // warp 0: the sum of the totals so far
  for (long long base = 0; base < nblk; base += nw) {
    const long long k = base + warp;
    const long long j0 = k * kCum, j1 = min(j0 + kCum, F);
    if (kPlan && k < nblk) {
      for (int r = lane; r < j1 - j0; r += 32) {
        s_li[warp][r] = (int)li[j0 + r];
        s_mix[warp][r] = mix[j0 + r];
        s_ok[warp][r] = valid[j0 + r];
      }
      __syncwarp();
    }
    // a batch of frames from row r0 (n of them; all kUnroll when `full`),
    // every load issued before the arithmetic: fn(row, m, inc) in order
    auto batch = [&](int r0, int n, auto full, bool want_mag, auto&& fn) {
      constexpr bool kFull = decltype(full)::value;
      float m0[kUnroll], m1[kUnroll], q0[kUnroll], q1[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + (kFull ? u : min(u, n - 1));
        const long long i = (kPlan ? (long long)s_li[warp][r] : j0 + r) * B;
        m0[u] = kPlan || want_mag ? m_in[i] : 0.f;
        q0[u] = f_in[i];
        m1[u] = kPlan ? m_in[i + B] : 0.f;
        q1[u] = kPlan ? f_in[i + B] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kFull || u < n) {
          float m;
          const float v = increment<kPlan>(
              m0[u], m1[u], q0[u], q1[u], kPlan ? s_mix[warp][r0 + u] : 0.f,
              kPlan ? s_ok[warp][r0 + u] != 0 : true, rate, &m);
          fn(r0 + u, m, v);
        }
      }
    };
    // the block's frames in order: whole batches unguarded, then the rest
    auto walk = [&](bool want_mag, auto&& fn) {
      const int n = (int)(j1 - j0);
      int r0 = 0;
      for (; r0 + kUnroll <= n; r0 += kUnroll)
        batch(r0, kUnroll, Whole<true>(), want_mag, fn);
      if (r0 < n) batch(r0, n - r0, Whole<false>(), want_mag, fn);
    };
    double s = 0.0;
    if (live && k < nblk)
      walk(false, [&](int, float, float v) { s = __dadd_rn(s, (double)v); });
    totals[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      for (int w = 0; w < nw && base + w < nblk; ++w) {
        prefix[w][lane] = rem1d(run);
        run = __dadd_rn(run, rem1d(totals[w][lane]));
      }
    }
    __syncthreads();
    const double pre = prefix[warp][lane];
    if (live && k == nblk - 1) {
      // the last frame's cycle: its within-block sum is the block's total
      const float last = __double2float_rn(rem1d(__dadd_rn(s, pre)));
      cycle_out[(long long)c * B + b] =
          cycle_in ? rem1f(__fadd_rn(last, c0)) : last;
    }
    if (out && live && k < nblk) {
      double s2 = 0.0;
      walk(true, [&](int r, float m, float v) {
        s2 = __dadd_rn(s2, (double)v);
        const float cyc = rem1f(__fadd_rn(
            __double2float_rn(rem1d(__dadd_rn(s2, pre))), c0));
        float sn, cs;           // sinf's and cosf's bits (the card tests)
        sincosf(__fmul_rn(cyc, two_pi), &sn, &cs);
        out[(j0 + r) * B] = make_float2(__fmul_rn(m, cs), __fmul_rn(m, sn));
      });
    }
    __syncthreads();
  }
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
  const int warps = nblk < kWarps ? (int)nblk : kWarps;
  const dim3 grid((B + 31) / 32, C);
  float2* out = write ? (float2*)spec : nullptr;
  if (li)
    pv_synthesis<true><<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
        mag, freq, in_row, li, mix, valid, F, B, rate, cycle_in, cycle_out,
        out, two_pi);
  else
    pv_synthesis<false><<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
        mag, freq, in_row, li, mix, valid, F, B, rate, cycle_in, cycle_out,
        out, two_pi);
  return (int)cudaGetLastError();
}

}  // extern "C"
