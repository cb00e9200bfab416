// JAX's threefry random bits (jax_threefry_partitionable), as a Hopper
// kernel: K1, threefry_uniform.
//
// Replaces no TPU kernel: the JAX package draws white and pink noise and
// synthesize_spectrum's phases with jax.random (flan_tpu/audio/
// synthesis.py:73-74, 98-103, 152-154), which XLA compiles. torch.rand on
// the card is Philox and gives other numbers; this kernel gives JAX's, so
// the port's noise equals the JAX package's draw for draw. The plain
// PyTorch version is flan_tpu_torch/ops/random.py threefry_ref.
//
// Function, for elements i < n under the key (k1, k2):
//   (x1, x2) = Threefry-2x32, 20 rounds, of the counter (i >> 32, i & M)
//   words mode: out[i] = (x1, x2)                          (split's keys)
//   float mode: f = bits of ((x1 ^ x2) >> 9 | 0x3F800000) - 1
//               out[i] = max(lo, f * span + lo)  (span = hi - lo, float32)
// The product and the sum are rounded one at a time (__fmul_rn,
// __fadd_rn): nvcc would contract them into one fused multiply-add, which
// rounds once, and XLA's CPU result that the port follows rounds twice.
//
// Bound: 4 bytes written an element (1.84 GB for 4.6e8 draws, 0.55 ms at
// 3.35 TB/s) against 74 operations an element at the fewest instructions
// (20 rounds of an add, a funnel-shift rotate and a xor; 5 key injections,
// their round constants folded; the counter, the float's bits and its four
// float operations): at the card's issue rate of 33.5 T lane-operations a
// second (four schedulers an SM, one 32-lane instruction a cycle each, 132
// SMs at 1.98 GHz) that is 1.02 ms at 4.6e8, so the operations bound it.
//
// Design: one thread an element, a grid-stride loop over a grid that
// fills the card; each thread's key schedule in registers, the rounds
// unrolled.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kParity = 0x1BD11BDAu;

__device__ __forceinline__ void mix4(unsigned& x1, unsigned& x2, int r0,
                                     int r1, int r2, int r3) {
  x1 += x2; x2 = __funnelshift_l(x2, x2, r0); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, r1); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, r2); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, r3); x2 ^= x1;
}

__device__ __forceinline__ void threefry2x32(unsigned k1, unsigned k2,
                                             unsigned& x1, unsigned& x2) {
  const unsigned k3 = k1 ^ k2 ^ kParity;
  x1 += k1; x2 += k2;
  mix4(x1, x2, 13, 15, 26, 6);  x1 += k2; x2 += k3 + 1u;
  mix4(x1, x2, 17, 29, 16, 24); x1 += k3; x2 += k1 + 2u;
  mix4(x1, x2, 13, 15, 26, 6);  x1 += k1; x2 += k2 + 3u;
  mix4(x1, x2, 17, 29, 16, 24); x1 += k2; x2 += k3 + 4u;
  mix4(x1, x2, 13, 15, 26, 6);  x1 += k3; x2 += k1 + 5u;
}

__global__ void __launch_bounds__(kThreads)
threefry_uniform(unsigned k1, unsigned k2, long long n, int words, float lo,
                 float span, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    unsigned x1 = (unsigned)((unsigned long long)i >> 32);
    unsigned x2 = (unsigned)((unsigned long long)i & 0xFFFFFFFFull);
    threefry2x32(k1, k2, x1, x2);
    if (words) {
      reinterpret_cast<uint2*>(out)[i] = make_uint2(x1, x2);
    } else {
      const unsigned fb = ((x1 ^ x2) >> 9) | 0x3F800000u;
      const float f = __fsub_rn(__uint_as_float(fb), 1.f);
      const float v = __fadd_rn(__fmul_rn(f, span), lo);
      reinterpret_cast<float*>(out)[i] = fmaxf(lo, v);
    }
  }
}

}  // namespace

extern "C" {

// out: [n, 2] uint32 words (words != 0) or [n] float32 in [lo, lo + span).
int flan_threefry(unsigned k1, unsigned k2, long long n, int words, float lo,
                  float span, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  threefry_uniform<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      k1, k2, n, words, lo, span, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
