// Device helpers shared by the kernels of flan_tpu_torch/csrc: the
// polynomial atan2 of flan_tpu/ops/fastmath.py, mod 1, the exclusive prefix
// over tiles (of the SPV kernels), and the epilogue block shape. Everything
// sits in an anonymous namespace, so each .cu file that includes it gets its
// own copy and the files link into one library without clashing.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;        // frames per tile
constexpr int kMaxThreads = 256;  // threads per epilogue block
constexpr int kMaxBinsPerThread = 8;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvTwoPi = 0.15915494309189533577f;

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

// The polynomial atan2 with the quotient taken as lo * (1 / hi) through the
// card's fast reciprocal (2 ulp) instead of an IEEE division: the phase
// moves by ~1e-7 rad, far below what two float32 summation orders differ
// by. For phases that feed a wrapped difference, not an accumulator.
__device__ __forceinline__ float atan2_poly_fast(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float at = atan_poly(__fdividef(lo, fmaxf(hi, 1e-37f)));
  if (ay > ax) at = 1.57079632679489661923f - at;
  if (x < 0.f) at = 3.14159265358979323846f - at;
  return y < 0.f ? -at : at;
}

// The two sums a prefix over tiles can run in: plain float32 (running
// complex sums) and cycles as 32-bit fixed point, which wrap by themselves
// and associate exactly.
struct SumF32 {
  typedef float T;
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
struct SumU32 {
  typedef unsigned T;
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};

// The exclusive prefix over tiles, in place: plane[c, k, b] <- op-sum of
// plane[c, j, b] for j < k. The tiles are cut into chunks of kScanChunk, one
// block per (32 bins, chunk, channel and plane), so a long signal fills the
// card: 704 blocks per plane for 11,250 tiles of 512 bins, where one block
// per 32 bins gave 16. Two launches: scan_chunk_totals writes each chunk's
// total behind the plane's [channels, ntiles, nbins], as [channels, nchunks,
// nbins] (flan_scan_chunk_tiles() tells the wrappers the chunk size);
// scan_chunks_apply sums the totals of the chunks before its own (rows of
// threads take them in turns), then writes its chunk's exclusive prefix.
// Each thread holds its kScanPer tiles in registers, so a plane is read
// twice and written once, every load independent of the last.
constexpr int kScanChunk = 256;  // tiles per block
constexpr int kScanRows = 8;     // rows of 32 threads in a block
constexpr int kScanPer = kScanChunk / kScanRows;  // tiles per thread

template <class Op>
__device__ __forceinline__ typename Op::T scan_load_tiles(
    const typename Op::T* p, bool on, int k0, int ntiles, int nbins,
    typename Op::T (&v)[kScanPer]) {
#pragma unroll
  for (int j = 0; j < kScanPer; ++j)
    v[j] = (on && k0 + j < ntiles) ? p[(long long)j * nbins] : 0;
  typename Op::T acc = v[0];
#pragma unroll
  for (int j = 1; j < kScanPer; ++j) acc = Op::add(acc, v[j]);
  return acc;
}

template <class Op>
__global__ void __launch_bounds__(32 * kScanRows)
scan_chunk_totals(typename Op::T* plane0, typename Op::T* plane1,
                  int channels, int ntiles, int nbins, int nchunks) {
  typedef typename Op::T T;
  __shared__ T row_total[kScanRows][33];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int b = blockIdx.x * 32 + lane, chunk = blockIdx.y;
  const int c = blockIdx.z % channels;
  T* plane = (int)blockIdx.z < channels ? plane0 : plane1;
  const bool on = b < nbins;
  const int k0 = chunk * kScanChunk + row * kScanPer;
  T v[kScanPer];
  row_total[row][lane] = scan_load_tiles<Op>(
      plane + ((long long)c * ntiles + k0) * nbins + b, on, k0, ntiles, nbins,
      v);
  __syncthreads();
  if (row == 0 && on) {
    T t = row_total[0][lane];
    for (int r = 1; r < kScanRows; ++r) t = Op::add(t, row_total[r][lane]);
    T* chunks = plane + (long long)channels * ntiles * nbins;
    chunks[((long long)c * nchunks + chunk) * nbins + b] = t;
  }
}

template <class Op>
__global__ void __launch_bounds__(32 * kScanRows)
scan_chunks_apply(typename Op::T* plane0, typename Op::T* plane1,
                  int channels, int ntiles, int nbins, int nchunks) {
  typedef typename Op::T T;
  __shared__ T before[kScanRows][33];
  __shared__ T row_total[kScanRows][33];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int b = blockIdx.x * 32 + lane, chunk = blockIdx.y;
  const int c = blockIdx.z % channels;
  T* plane = (int)blockIdx.z < channels ? plane0 : plane1;
  const bool on = b < nbins;
  const T* chunks = plane + (long long)channels * ntiles * nbins +
                    (long long)c * nchunks * nbins + b;
  T part = 0;
  if (on)
    for (int q = row; q < chunk; q += kScanRows)
      part = Op::add(part, chunks[(long long)q * nbins]);
  before[row][lane] = part;
  const int k0 = chunk * kScanChunk + row * kScanPer;
  T* p = plane + ((long long)c * ntiles + k0) * nbins + b;
  T v[kScanPer];
  row_total[row][lane] = scan_load_tiles<Op>(p, on, k0, ntiles, nbins, v);
  __syncthreads();
  T pre = before[0][lane];
  for (int r = 1; r < kScanRows; ++r) pre = Op::add(pre, before[r][lane]);
  for (int r = 0; r < row; ++r) pre = Op::add(pre, row_total[r][lane]);
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    if (on && k0 + j < ntiles) p[(long long)j * nbins] = pre;
    pre = Op::add(pre, v[j]);
  }
}

// Both launches of the prefix over `planes` (1 or 2) scratch planes, each
// [channels, ntiles, nbins] followed by room for [channels, nchunks, nbins].
template <class Op>
void launch_tile_prefix(typename Op::T* plane0, typename Op::T* plane1,
                        int planes, int channels, int ntiles, int nbins,
                        cudaStream_t s) {
  const int nchunks = (ntiles + kScanChunk - 1) / kScanChunk;
  const dim3 grid((nbins + 31) / 32, nchunks, channels * planes);
  const dim3 block(32, kScanRows);
  if (nchunks > 1)
    scan_chunk_totals<Op><<<grid, block, 0, s>>>(plane0, plane1, channels,
                                                 ntiles, nbins, nchunks);
  scan_chunks_apply<Op><<<grid, block, 0, s>>>(plane0, plane1, channels,
                                               ntiles, nbins, nchunks);
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
