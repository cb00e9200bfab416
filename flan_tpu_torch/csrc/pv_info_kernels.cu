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
// (4 F (width - 20) bytes); at 600 s (225,001 frames, K = 320 on the test
// signal) that is 1.12 GB, a third of a millisecond. The work is the 20 F K
// contributions' bins, each a division, a log2 and a rounding, and their
// adds, which must stay in (k, h) order on each bin: the operations bound
// it (PERF.md, the salience row, counts them from the build's SASS).
//
// Design: a warp a frame, kWarps frames a block, each warp's row of
// `width` floats in shared memory. The warp first finds the frame's last
// live peak (i_f > 0 and i_m != 0: the slots past a frame's peaks are
// empty), then takes its contributions 32 at a time in (k, h) order, a
// lane each: every lane works out its bin and value at once (the log2 in
// float32, in float64 where the bin is in doubt). Lanes that
// hit one cell are found without __match_any_sync (~3 of 11 ms at 600 s
// on the card: its throughput held the kernel): each lane writes its
// number into a byte tag of its cell and reads it back; a lane that finds
// another's number marks the cell, and every lane on a marked cell is
// contended (one write of several to a byte survives, so a cell that two
// lanes hit always loses one of them, whichever). Uncontended lanes add
// their value straight into their cells; the contended ones add theirs
// one lane at a time in lane order, the (k, h) order. Each cell so sees
// the adds of one thread adding them one by one. One peak's 20
// harmonics lie at least 120 log2(21 / 20) ~ 8.4 bins apart, so lanes
// meet only across peaks. Contributions that add +0.0 (i_f <= 0, i_m = 0)
// are skipped, exact. Then the warp spreads its row, one output element a
// lane at a time, its 21 taps in order, and the next frame's row starts
// from zeros.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // frames a block: a warp a frame
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWidth = 640;     // floats a row may hold (20 KB a block)
constexpr unsigned char kMarked = 0xff;    // a tag: two lanes met here
constexpr float kRecheck = 0x1p-10f;       // the float64 log2 from here
constexpr int kNH = 20;            // harmonics a peak feeds
constexpr int kSpread = 10;        // bins each side of the cosine spread
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
salience_histogram(const float* __restrict__ i_f,
                   const float* __restrict__ i_m,
                   const float* __restrict__ alpha,
                   const float* __restrict__ g, float* __restrict__ out,
                   long long frames, int K, int width, float log2_min) {
  __shared__ float rows[kWarps][kMaxWidth];
  __shared__ unsigned char tags[kWarps][kMaxWidth];    // by cell
  __shared__ float s_alpha[kNH];
  __shared__ float s_g[2 * kSpread + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = rows[warp];
  unsigned char* tag = tags[warp];
  for (int i = lane; i < width; i += 32) row[i] = 0.f;
  if (threadIdx.x < kNH) s_alpha[threadIdx.x] = alpha[threadIdx.x];
  if (threadIdx.x < 2 * kSpread + 1) s_g[threadIdx.x] = g[threadIdx.x];
  __syncthreads();
  const long long f = (long long)blockIdx.x * kWarps + warp;
  if (f >= frames) return;     // no block barrier below
  const float* fr = i_f + f * K;
  const float* mr = i_m + f * K;

  // the frame's peaks up to its last live one
  int live = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const unsigned b = __ballot_sync(
        kFull, k < K && fr[k] > 0.f && mr[k] != 0.f);
    if (b) live = k0 + 32 - __clz(b);
  }

  // its contributions in (k, h) order, 32 at a time
  const int total = kNH * live;
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    int cell = -1;
    float c = 0.f;
    if (i < total) {
      const int k = i / kNH, h = i - k * kNH + 1;
      const float fk = fr[k], mk = mr[k];
      if (fk > 0.f && mk != 0.f) {      // else every add would be +0
        const float sub = fmaxf(__fdiv_rn(fk, (float)h), 1e-9f);
        // the bin of the log2 in float64 rounded to float32, the correctly
        // rounded log2 the plain version takes on every device (log2f
        // alone put 43 of 20.4 M contributions a bin away at 10 s of the
        // test signal). log2f is within 1 ulp of it (CUDA's bound), which
        // moves v by < 6e-4 for lg < 32 (the row's bins and its edges lie
        // within 5.3 of log2_min): v more than kRecheck from a
        // half-integer rounds as the float64 path's does, and the rest
        // take that path
        float lg = log2f(sub);
        float v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
        if (fabsf(v - floorf(v) - 0.5f) < kRecheck) {
          lg = (float)log2((double)sub);
          v = __fmul_rn(120.f, __fsub_rn(lg, log2_min));
        }
        const int b = (int)rintf(v);
        if (b >= 0 && b < width - kSpread) {
          cell = b + kSpread;
          c = __fmul_rn(s_alpha[h - 1], mk);
        }
      }
    }
    // the lanes that meet on a cell: a lane that finds another's number
    // in the cell's tag marks it
    if (cell >= 0) tag[cell] = (unsigned char)lane;
    __syncwarp();
    const bool lost = cell >= 0 && tag[cell] != lane;
    __syncwarp();
    if (lost) tag[cell] = kMarked;
    __syncwarp();
    const bool met = cell >= 0 && tag[cell] == kMarked;
    const unsigned contended = __ballot_sync(kFull, met);
    if (cell >= 0 && !met) row[cell] = __fadd_rn(row[cell], c);
    // the contended lanes one at a time, in lane order
    for (unsigned m = contended; m; m &= m - 1) {
      if (lane == __ffs(m) - 1) row[cell] = __fadd_rn(row[cell], c);
      __syncwarp();
    }
    __syncwarp();
  }

  const int n_out = width - 2 * kSpread;
  float* o = out + f * n_out;
  for (int j = lane; j < n_out; j += 32) {
    const float* src = row + j;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t <= 2 * kSpread; ++t)
      acc = __fadd_rn(acc, __fmul_rn(src[t], s_g[t]));
    o[j] = acc;
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
  const long long blocks = (frames + kWarps - 1) / kWarps;
  salience_histogram<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(i_f, i_m, alpha, g, out,
                                               frames, K, width, log2_min);
  return (int)cudaGetLastError();
}

}  // extern "C"
