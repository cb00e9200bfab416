// The salience histogram of PV.get_salience, as a Hopper kernel.
//
// Replaces no TPU kernel: flan_tpu/pv/information.py:121-138 leaves this
// to XLA, a scatter-add of every frame's subharmonic contributions
// (.at[flat].add, sequential in flat order on the CPU) and a 21-tap cosine
// spread by a HIGHEST-precision convolution. On the card torch's
// index_add_ adds by float atomics in no fixed order and conv1d may run in
// TF32, so the bits would wander from call to call; get_contours
// thresholds and picks from this buffer, so a wandering bit can move a
// whole contour. This kernel adds in one fixed order and uses no float
// atomics. The plain PyTorch version is
// flan_tpu_torch/ops/pv_info_kernels.py salience_histogram_ref.
//
// Function, for frames f < F and peaks k < K (i_f, i_m [F, K] float32):
//   for k, then h = 1..20, in that order, from a row of zeros:
//     b = rint(120 (log2(max(i_f / h, 1e-9)) - log2_min)), the log2 taken
//         in float64 and rounded to float32
//     if i_f > 0 and 0 <= b < width - 10: row[b + 10] += alpha^(h-1) i_m
//   out[f, j] = sum_{i = 0..20} row[j + i] g[i]   (taps in order i), for
//   j < width - 20.
// Every product and sum is rounded on its own (no fused multiply-add), as
// the plain version's separate multiplies and adds are.
//
// Bound: the call reads i_f and i_m (8 F K bytes) and writes the output
// (4 F (width - 20) bytes); at 600 s (225,001 frames, K = 304 on the test
// signal) that is 1.09 GB, a third of a millisecond. What holds it is the
// order: a frame's contributions to one bin must be added in (k, h) order,
// so each frame's adds are one thread's chain (K x 20 steps of a division,
// a float64 log2, a rounding and a shared-memory add).
//
// Design: a block takes kFrames frames. Thread t < kFrames owns frame t's
// row of `width` floats in shared memory, zeroed by the block, and adds the
// frame's contributions in order (skipping those that add +0.0: i_f <= 0
// or i_m = 0, exact). Then all the block's threads spread the rows, one
// output element a thread at a time, its 21 taps in order.

#include "common.cuh"

namespace {

constexpr int kFrames = 16;        // frames (rows) a block holds
constexpr int kThreads = 128;
constexpr int kMaxWidth = 640;     // floats a row may hold (48 KB a block)
constexpr int kNH = 20;            // harmonics a peak feeds
constexpr int kSpread = 10;        // bins each side of the cosine spread

__global__ void __launch_bounds__(kThreads)
salience_histogram(const float* __restrict__ i_f,
                   const float* __restrict__ i_m,
                   const float* __restrict__ alpha,
                   const float* __restrict__ g, float* __restrict__ out,
                   long long frames, int K, int width, float log2_min) {
  __shared__ float rows[kFrames * kMaxWidth];
  __shared__ float s_alpha[kNH];
  __shared__ float s_g[2 * kSpread + 1];
  const long long f0 = (long long)blockIdx.x * kFrames;
  const int nf = (int)min((long long)kFrames, frames - f0);
  for (int i = threadIdx.x; i < kFrames * width; i += kThreads)
    rows[i] = 0.f;
  if (threadIdx.x < kNH) s_alpha[threadIdx.x] = alpha[threadIdx.x];
  if (threadIdx.x < 2 * kSpread + 1) s_g[threadIdx.x] = g[threadIdx.x];
  __syncthreads();

  if (threadIdx.x < nf) {
    float* row = rows + threadIdx.x * width;
    const long long base = (f0 + threadIdx.x) * (long long)K;
    for (int k = 0; k < K; ++k) {
      const float fk = i_f[base + k];
      const float mk = i_m[base + k];
      if (!(fk > 0.f) || mk == 0.f) continue;    // every add would be +0
      for (int h = 1; h <= kNH; ++h) {
        const float sub = fmaxf(__fdiv_rn(fk, (float)h), 1e-9f);
        // log2 in float64, rounded to float32: the correctly rounded
        // log2 the plain version takes on every device (log2f put 43 of
        // 20.4 M contributions a bin away at 10 s of the test signal)
        const float lg = (float)log2((double)sub);
        const float v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
        const int b = (int)rintf(v);
        if (b >= 0 && b < width - kSpread) {
          float* cell = row + b + kSpread;
          *cell = __fadd_rn(*cell, __fmul_rn(s_alpha[h - 1], mk));
        }
      }
    }
  }
  __syncthreads();

  const int n_out = width - 2 * kSpread;
  for (int i = threadIdx.x; i < nf * n_out; i += kThreads) {
    const int r = i / n_out, j = i - r * n_out;
    const float* src = rows + r * width + j;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t <= 2 * kSpread; ++t)
      acc = __fadd_rn(acc, __fmul_rn(src[t], s_g[t]));
    out[(f0 + r) * n_out + j] = acc;
  }
}

}  // namespace

extern "C" {

// The widest row (bins of the salience map plus 20) a call may take.
int flan_salience_max_width() { return kMaxWidth; }

// i_f, i_m [frames, K] float32; alpha [20] = 0.8^(h-1); g [21] the spread's
// taps; out [frames, width - 20] float32.
int flan_salience_histogram(const float* i_f, const float* i_m,
                            const float* alpha, const float* g, float* out,
                            long long frames, int K, int width,
                            float log2_min, void* stream) {
  if (frames < 1 || K < 1 || width <= 2 * kSpread || width > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (frames + kFrames - 1) / kFrames;
  salience_histogram<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(i_f, i_m, alpha, g, out,
                                               frames, K, width, log2_min);
  return (int)cudaGetLastError();
}

}  // extern "C"
