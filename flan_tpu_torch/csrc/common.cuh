// Device helpers shared by the kernels of flan_tpu_torch/csrc: the
// polynomial atan2 of flan_tpu/ops/fastmath.py, mod 1, the exclusive prefix
// over tiles, and the epilogue block shape. Everything sits in an anonymous
// namespace, so each .cu file that includes it gets its own copy and the
// files link into one library without clashing.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;        // frames per tile
constexpr int kMaxThreads = 256;  // threads per epilogue block
constexpr int kMaxBinsPerThread = 8;
constexpr int kScanSegments = 32;
constexpr float kTwoPi = 6.28318530717958647692f;

// atan(z) ~= z * P(z^2) on [0, 1]: the coefficients of
// flan_tpu/ops/fastmath.py, evaluated in the same order.
__device__ __forceinline__ float atan_poly(float z) {
  const float z2 = z * z;
  float p = -0.004668773f;
  p = p * z2 + 0.02416619f;
  p = p * z2 - 0.0593671f;
  p = p * z2 + 0.09906097f;
  p = p * z2 - 0.14016585f;
  p = p * z2 + 0.19969235f;
  p = p * z2 - 0.3333196f;
  p = p * z2 + 0.9999999f;
  return z * p;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float at = atan_poly(lo / fmaxf(hi, 1e-37f));
  if (ay > ax) at = 1.57079632679489661923f - at;
  if (x < 0.f) at = 3.14159265358979323846f - at;
  return y < 0.f ? -at : at;
}

// x mod 1 with the sign convention of torch.remainder and jnp.mod.
__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.f);
  if (r < 0.f) r += 1.f;
  return r;
}

// In place: plane[c, k, b] <- op-sum of plane[c, j, b] for j < k, where op
// is + (sums) or + mod 1 (cycles). Block (32 bins, 32 segments); each
// segment walks ceil(ntiles / 32) tiles twice.
template <bool kMod1>
__global__ void __launch_bounds__(32 * kScanSegments)
exclusive_scan_tiles(float* plane0, float* plane1, int ntiles, int nbins) {
  __shared__ float seg_total[kScanSegments][33];
  float* plane = blockIdx.z == 0 ? plane0 : plane1;
  const int lane = threadIdx.x, seg = threadIdx.y;
  const int b = blockIdx.x * 32 + lane;
  const int c = blockIdx.y;
  const int per = (ntiles + kScanSegments - 1) / kScanSegments;
  const int k0 = min(seg * per, ntiles), k1 = min(k0 + per, ntiles);
  float* p = plane + (long long)c * ntiles * nbins + b;
  float acc = 0.f;
  if (b < nbins) {
    for (int k = k0; k < k1; ++k) {
      acc += p[(long long)k * nbins];
      if (kMod1) acc = mod1(acc);
    }
  }
  seg_total[seg][lane] = acc;
  __syncthreads();
  float pre = 0.f;
  for (int s = 0; s < seg; ++s) {
    pre += seg_total[s][lane];
    if (kMod1) pre = mod1(pre);
  }
  if (b < nbins) {
    for (int k = k0; k < k1; ++k) {
      const float v = p[(long long)k * nbins];
      p[(long long)k * nbins] = pre;
      pre += v;
      if (kMod1) pre = mod1(pre);
    }
  }
}

// Bins per thread K and threads per block for an epilogue that holds all
// nbins bins of a frame in one block.
bool epilogue_shape(int nbins, int* k, int* threads) {
  for (int kk = 1; kk <= kMaxBinsPerThread; kk *= 2) {
    const int t = (nbins + kk - 1) / kk;
    if (t <= kMaxThreads) {
      *k = kk;
      *threads = (t + 31) / 32 * 32;
      return true;
    }
  }
  return false;
}

}  // namespace
