// The lowering probe of tools/probe_pallas_ops.py, as a Hopper kernel.
//
// Replaces the TPU kernel
//   T3  tools/probe_pallas_ops.py main -> kernel (pallas_call at :65)
// which the JAX package used to check that Mosaic lowers the operations of
// the SPV kernels. It lies on no path of the library; the port keeps it as
// a card probe of the same operations. The plain PyTorch version is
// flan_tpu_torch/ops/probe_kernels.py probe_ref.
//
// Function, for x [steps, F, B] and w [F, B] (F = 128, B = 512), over the
// steps in order with a carried row c [B] (zero at the start):
//   s[i, b]  = sum_{j <= i} x[t, 0, j] w[j, b] + c[b]    (triangular product)
//   ph       = atan2-style polynomial of (s, sqrt(|w| + 1)) + cos(z)
//   prev     = ph of the row above, c on row 0
//   left     = ph of the column to the left, 2 ph[i, 1] on column 0
//   out      = (ph - prev) - floor(ph - prev + 0.5) + left + (s mod 1)
//   c        = out[F - 1, :]
//
// Bound: the probe must move 1.3 MB (w and the output; of x only row 0's
// first F columns per step) and does about 50 operations per element, so
// its bound is under a microsecond. Only the carried row is a chain: the
// triangular product's running sum acc[t, i, b] does not depend on it, and
// a step's output depends on the carry of columns b - 1, b (and 1) alone.
// So three launches:
//   probe_acc    acc for every step and column at once, one thread a
//                (step, column), the running float32 FMA sum down the
//                column in row order, into the scratch;
//   probe_carry  the chain of carried rows: one block, a thread a column,
//                a step a barrier, each computing only row F - 1 (from
//                acc's rows F - 2 and F - 1) and keeping it in the scratch;
//   probe_out    every output element at once from acc and the carry of
//                the step before, its neighbours' phases recomputed.
// Every element goes through the same operations in the same order as in
// the one-block kernel this design replaced, so the output keeps its bits.

#include "common.cuh"

namespace {

constexpr int kRows = 128;   // F
constexpr int kCols = 512;   // B
constexpr int kOutThreads = 256;

// The phase of a sum s over a weight w.
__device__ __forceinline__ float probe_phase(float s, float wv) {
  const float xx = sqrtf(fabsf(wv) + 1.f);
  const float ay = fabsf(s), ax = fabsf(xx);
  const float z = fminf(ay, ax) / fmaxf(fmaxf(ay, ax), 1e-30f);
  float at = z * (1.f - 0.33f * (z * z));
  if (ay > ax) at = 1.57079632679489661923f - at;
  if (xx < 0.f) at = 3.14159265358979323846f - at;
  return (s < 0.f ? -at : at) + cosf(z);
}

// An output from its phase, the phase above, the phase to its left and s.
__device__ __forceinline__ float probe_output(float ph, float prev,
                                              float left, float s) {
  const float d = ph - prev;
  return (d - floorf(d + 0.5f)) + left + mod1(s);
}

// acc [steps, F, B]: thread (t, b) runs down column b of step t.
__global__ void __launch_bounds__(kOutThreads)
probe_acc(const float* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ acc, int steps) {
  const int id = blockIdx.x * kOutThreads + threadIdx.x;
  if (id >= steps * kCols) return;
  const int t = id / kCols, b = id % kCols;
  const float* xt = x + (long long)t * kRows * kCols;   // row 0: the deltas
  float* at = acc + (long long)t * kRows * kCols + b;
  float a = 0.f;
#pragma unroll 16
  for (int i = 0; i < kRows; ++i) {
    a = fmaf(__ldg(xt + i), __ldg(w + i * kCols + b), a);
    at[i * kCols] = a;
  }
}

// carry [steps, B]: row F - 1 of each step's output, step by step.
__global__ void __launch_bounds__(kCols)
probe_carry(const float* __restrict__ w, const float* __restrict__ acc,
            float* __restrict__ carry, int steps) {
  __shared__ float ph_last[kCols];
  const int b = threadIdx.x;
  const float w1 = w[(kRows - 2) * kCols + b], w2 = w[(kRows - 1) * kCols + b];
  float c = 0.f;
  for (int t = 0; t < steps; ++t) {
    const float* at = acc + (long long)t * kRows * kCols;
    const float s = at[(kRows - 1) * kCols + b] + c;
    const float ph = probe_phase(s, w2);
    const float prev = probe_phase(at[(kRows - 2) * kCols + b] + c, w1);
    ph_last[b] = ph;
    __syncthreads();
    const float left = b == 0 ? 2.f * ph_last[1] : ph_last[b - 1];
    __syncthreads();
    c = probe_output(ph, prev, left, s);
    carry[t * kCols + b] = c;
  }
}

// out [steps, F, B]: one thread an element.
__global__ void __launch_bounds__(kOutThreads)
probe_out(const float* __restrict__ w, const float* __restrict__ acc,
          const float* __restrict__ carry, float* __restrict__ out,
          int steps) {
  const long long id = (long long)blockIdx.x * kOutThreads + threadIdx.x;
  if (id >= (long long)steps * kRows * kCols) return;
  const int b = (int)(id % kCols), i = (int)(id / kCols % kRows);
  const int t = (int)(id / ((long long)kRows * kCols));
  const float* at = acc + (long long)t * kRows * kCols;
  const float* ct = carry + (t - 1) * kCols;    // read only for t > 0
  const float c = t > 0 ? ct[b] : 0.f;
  const float s = at[i * kCols + b] + c;
  const float ph = probe_phase(s, w[i * kCols + b]);
  const float prev = i == 0 ? c
                            : probe_phase(at[(i - 1) * kCols + b] + c,
                                          w[(i - 1) * kCols + b]);
  const int lb = b == 0 ? 1 : b - 1;
  const float phl = probe_phase(at[i * kCols + lb] + (t > 0 ? ct[lb] : 0.f),
                                w[i * kCols + lb]);
  const float left = b == 0 ? 2.f * phl : phl;
  out[id] = probe_output(ph, prev, left, s);
}

}  // namespace

extern "C" {

int flan_probe_rows() { return kRows; }
int flan_probe_cols() { return kCols; }

// Floats of scratch a call of `steps` steps needs: acc and the carries.
long long flan_probe_scratch_floats(int steps) {
  return (long long)steps * (kRows + 1) * kCols;
}

// x [steps, 128, 512], w [128, 512], out [steps, 128, 512], float32;
// scratch: flan_probe_scratch_floats(steps) floats.
int flan_probe(const float* x, const float* w, float* out, float* scratch,
               int steps, void* stream) {
  if (steps < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* acc = scratch;
  float* carry = scratch + (long long)steps * kRows * kCols;
  probe_acc<<<(steps * kCols + kOutThreads - 1) / kOutThreads, kOutThreads, 0,
              s>>>(x, w, acc, steps);
  probe_carry<<<1, kCols, 0, s>>>(w, acc, carry, steps);
  const long long total = (long long)steps * kRows * kCols;
  probe_out<<<(unsigned)((total + kOutThreads - 1) / kOutThreads),
              kOutThreads, 0, s>>>(w, acc, carry, out, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
