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
// first F columns per step) and does about 50 operations per element,
// so its bound is under a microsecond; it is latency-bound instead. One
// block of B threads, one column each, walks the rows in order: the
// triangular product is a running float32 FMA sum down the column (row i
// adds x[t, 0, i] w[i, b], so the O(F^2 B) product costs O(F B)), and the
// left neighbour's phase goes through shared memory with a barrier per row.
// The carried row makes every step depend on the one before, column b on
// column b - 1 through `left`, so the steps run in one block, in order.

#include "common.cuh"

namespace {

constexpr int kRows = 128;   // F
constexpr int kCols = 512;   // B

__global__ void __launch_bounds__(kCols)
probe_kernel(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ out, int steps) {
  __shared__ float delta[kRows];
  __shared__ float ph_row[kCols];
  const int b = threadIdx.x;
  float carry = 0.f;
  for (int t = 0; t < steps; ++t) {
    const float* xt = x + (long long)t * kRows * kCols;
    if (b < kRows) delta[b] = xt[b];  // row 0, columns 0..F-1
    __syncthreads();
    float acc = 0.f, prev = carry, last = 0.f;
    for (int i = 0; i < kRows; ++i) {
      const float wv = w[i * kCols + b];
      acc = fmaf(delta[i], wv, acc);
      const float s = acc + carry;
      const float xx = sqrtf(fabsf(wv) + 1.f);
      const float ay = fabsf(s), ax = fabsf(xx);
      const float z = fminf(ay, ax) / fmaxf(fmaxf(ay, ax), 1e-30f);
      float at = z * (1.f - 0.33f * (z * z));
      if (ay > ax) at = 1.57079632679489661923f - at;
      if (xx < 0.f) at = 3.14159265358979323846f - at;
      const float ph = (s < 0.f ? -at : at) + cosf(z);
      ph_row[b] = ph;
      __syncthreads();
      const float left = b == 0 ? 2.f * ph_row[1] : ph_row[b - 1];
      __syncthreads();
      const float d = ph - prev;
      const float o = (d - floorf(d + 0.5f)) + left + mod1(s);
      out[((long long)t * kRows + i) * kCols + b] = o;
      prev = ph;
      last = o;
    }
    carry = last;
  }
}

}  // namespace

extern "C" {

int flan_probe_rows() { return kRows; }
int flan_probe_cols() { return kCols; }

// x [steps, 128, 512], w [128, 512], out [steps, 128, 512], float32.
int flan_probe(const float* x, const float* w, float* out, int steps,
               void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  probe_kernel<<<1, kCols, 0, (cudaStream_t)stream>>>(x, w, out, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
