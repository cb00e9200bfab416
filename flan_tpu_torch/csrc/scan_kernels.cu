// Linear-recurrence scans for Hopper: y[n] = f_n(y[n-1]) along the last axis
// of [rows, N], for three families of maps f_n that are closed under
// composition:
//   linear      y -> a y + b                      (2 planes in, 1 state)
//   max_affine  y -> max(m, a y + c), a >= 0      (3 planes in, 1 state)
//   affine2x2   s -> A s + b, A 2x2, s = (s1, s2) (6 planes in, 2 states)
//
// Replaces the TPU kernels of tools/pallas_scan_experiment.py:
//   T1  _compose_maps -> kernel  (each chain's total affine map)
//   T2  _apply_from   -> kernel  (rerun each chain from its start state)
// and computes what flan_tpu/ops/scan.py linear_recurrence,
// max_affine_recurrence and matrix_affine_recurrence (k = 2) compute. The
// plain PyTorch versions are flan_tpu_torch/ops/scan_kernels.py
// linear_ref, max_affine_ref and affine2x2_ref.
//
// Bound: memory. Each element is read once per plane and written once per
// state: 12 bytes for linear, 16 for max_affine and 32 for affine2x2 when
// every plane is a full [rows, N] tensor (a plane that is one row shared by
// all rows is read once). The arithmetic is a few FMAs per element.
//
// Design. T1/T2 gave each of 8192 lanes one contiguous segment and advanced
// time along the leading axis after a full transpose. Here one row is split
// along time into tiles of kThreads * kPerThread elements, so one long row
// (the compressor's control signal is a single row of N samples) still fills
// the card, and nothing is transposed or padded:
//   1. tile totals (T1's counterpart): a block loads its tile coalesced into
//      shared memory (consecutive threads take consecutive elements, the
//      ragged last tile filled with the identity map), each thread composes
//      a run of kPerThread consecutive elements in registers, and a block
//      scan of the maps (warp shuffles, then the 8 warp totals) gives the
//      tile's total map;
//   2. fold: one block per row composes its tiles' totals in time order
//      (each thread a run of tiles, then a block scan) and applies them to
//      the row's start state y0, writing each tile's start state;
//   3. apply (T2's counterpart): a block reloads its tile, rebuilds each
//      thread's exclusive prefix map by the same block scan, applies it to
//      the tile's start state, reruns the recurrence over the thread's run
//      into shared memory, and stores the states coalesced.
// A plane may be one row shared by every row (row stride 0), so a
// coefficient computed once per frame is never broadcast in memory.
//
// The max_affine identity is m = -1e30, not -inf: decay products underflow
// to 0 and 0 * -inf is NaN (flan_tpu/ops/scan.py:208-210). Its composition
// law holds only for a >= 0.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 6;
constexpr int kMaxStates = 2;

struct ScanArgs {
  const float* in[kMaxPlanes];
  long long stride[kMaxPlanes];  // row stride in elements: 0 or N
  float* out[kMaxStates];        // [rows, N] each
};

// Each family: kMap components (the element map is its planes, in order),
// kState state components, the identity, the composition "l, then r", and
// the application of a map to a state.
struct Linear {
  static constexpr int kMap = 2, kState = 1, kPerThread = 8;
  __device__ static float identity(int p) { return p == 0 ? 1.f : 0.f; }
  __device__ static void compose(const float* l, const float* r, float* o) {
    o[0] = l[0] * r[0];
    o[1] = l[1] * r[0] + r[1];
  }
  __device__ static void apply(const float* m, float* s) {
    s[0] = m[0] * s[0] + m[1];
  }
};

struct MaxAffine {
  static constexpr int kMap = 3, kState = 1, kPerThread = 8;
  __device__ static float identity(int p) {
    return p == 0 ? -1e30f : (p == 1 ? 1.f : 0.f);
  }
  __device__ static void compose(const float* l, const float* r, float* o) {
    o[0] = fmaxf(r[0], r[1] * l[0] + r[2]);
    o[1] = l[1] * r[1];
    o[2] = r[1] * l[2] + r[2];
  }
  __device__ static void apply(const float* m, float* s) {
    s[0] = fmaxf(m[0], m[1] * s[0] + m[2]);
  }
};

// (a11, a12, a21, a22, b1, b2)
struct Affine2x2 {
  static constexpr int kMap = 6, kState = 2, kPerThread = 4;
  __device__ static float identity(int p) {
    return (p == 0 || p == 3) ? 1.f : 0.f;
  }
  __device__ static void compose(const float* l, const float* r, float* o) {
    o[0] = r[0] * l[0] + r[1] * l[2];
    o[1] = r[0] * l[1] + r[1] * l[3];
    o[2] = r[2] * l[0] + r[3] * l[2];
    o[3] = r[2] * l[1] + r[3] * l[3];
    o[4] = r[0] * l[4] + r[1] * l[5] + r[4];
    o[5] = r[2] * l[4] + r[3] * l[5] + r[5];
  }
  __device__ static void apply(const float* m, float* s) {
    const float s1 = s[0], s2 = s[1];
    s[0] = m[0] * s1 + m[1] * s2 + m[4];
    s[1] = m[2] * s1 + m[3] * s2 + m[5];
  }
};

template <class Op>
struct Tile {
  static constexpr int kLen = kThreads * Op::kPerThread;
  // one padding float per 32, so a thread's run of kPerThread elements and
  // the coalesced rows both fall on distinct banks
  static constexpr int kPitch = kLen + kLen / 32;
};

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <class Op>
__device__ __forceinline__ void set_identity(float* m) {
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p) m[p] = Op::identity(p);
}

template <class Op>
__device__ __forceinline__ void compose_into(float* acc, const float* r) {
  float t[Op::kMap];
  Op::compose(acc, r, t);
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p) acc[p] = t[p];
}

// Block-wide scan of the threads' maps in thread order: `ex` becomes the
// composition of the maps of all earlier threads and `total` that of all
// threads. warp_tot is kWarps * kMap floats of shared memory.
template <class Op>
__device__ void block_scan(const float* mine, float* ex, float* total,
                           float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc[Op::kMap];
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p) inc[p] = mine[p];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float up[Op::kMap];
#pragma unroll
    for (int p = 0; p < Op::kMap; ++p)
      up[p] = __shfl_up_sync(0xffffffffu, inc[p], d);
    if (lane >= d) {
      float t[Op::kMap];
      Op::compose(up, inc, t);
#pragma unroll
      for (int p = 0; p < Op::kMap; ++p) inc[p] = t[p];
    }
  }
  float lane_ex[Op::kMap];
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p)
    lane_ex[p] = __shfl_up_sync(0xffffffffu, inc[p], 1);
  if (lane == 0) set_identity<Op>(lane_ex);
  if (lane == 31) {
#pragma unroll
    for (int p = 0; p < Op::kMap; ++p) warp_tot[warp * Op::kMap + p] = inc[p];
  }
  __syncthreads();
  float pre[Op::kMap];
  set_identity<Op>(total);
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
#pragma unroll
      for (int p = 0; p < Op::kMap; ++p) pre[p] = total[p];
    }
    compose_into<Op>(total, warp_tot + w * Op::kMap);
  }
  Op::compose(pre, lane_ex, ex);
  __syncthreads();  // warp_tot may be reused after this
}

// The block's tile of every plane into shared memory, coalesced; elements
// past N are the identity map.
template <class Op>
__device__ void load_tile(const ScanArgs& args, long long row, long long base,
                          long long n, float* sm) {
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p) {
    const float* src = args.in[p] + row * args.stride[p];
    const float ident = Op::identity(p);
#pragma unroll
    for (int k = 0; k < Op::kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const long long g = base + i;
      sm[p * Tile<Op>::kPitch + padded(i)] = g < n ? __ldg(src + g) : ident;
    }
  }
}

// The map of element i of the tile in shared memory.
template <class Op>
__device__ __forceinline__ void element(const float* sm, int i, float* e) {
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p) e[p] = sm[p * Tile<Op>::kPitch + padded(i)];
}

// This thread's run of kPerThread consecutive elements, composed.
template <class Op>
__device__ void compose_run(const float* sm, float* m) {
  set_identity<Op>(m);
  const int i0 = threadIdx.x * Op::kPerThread;
#pragma unroll
  for (int j = 0; j < Op::kPerThread; ++j) {
    float e[Op::kMap];
    element<Op>(sm, i0 + j, e);
    compose_into<Op>(m, e);
  }
}

// Pass 1: totals[row, tile, :] = the tile's composed map.
template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_tile_totals(ScanArgs args, float* __restrict__ totals, long long n,
                 int ntiles) {
  __shared__ float sm[Op::kMap * Tile<Op>::kPitch];
  __shared__ float warp_tot[kWarps * Op::kMap];
  const long long blk = blockIdx.x;
  const long long row = blk / ntiles;
  const long long base = (blk % ntiles) * Tile<Op>::kLen;
  load_tile<Op>(args, row, base, n, sm);
  __syncthreads();
  float m[Op::kMap], ex[Op::kMap], total[Op::kMap];
  compose_run<Op>(sm, m);
  block_scan<Op>(m, ex, total, warp_tot);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < Op::kMap; ++p) totals[blk * Op::kMap + p] = total[p];
  }
}

// Pass 2, one block per row: starts[row, tile, :] = the state before the
// tile, folding the tile totals in time order from y0[row, :].
template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_fold(const float* __restrict__ totals, const float* __restrict__ y0,
          float* __restrict__ starts, int ntiles) {
  __shared__ float warp_tot[kWarps * Op::kMap];
  const long long row = blockIdx.x;
  const int per = (ntiles + kThreads - 1) / kThreads;
  const int k0 = min((int)threadIdx.x * per, ntiles);
  const int k1 = min(k0 + per, ntiles);
  const float* tot = totals + row * ntiles * Op::kMap;
  float m[Op::kMap], ex[Op::kMap], total[Op::kMap];
  set_identity<Op>(m);
  for (int k = k0; k < k1; ++k) compose_into<Op>(m, tot + k * Op::kMap);
  block_scan<Op>(m, ex, total, warp_tot);
  float s[Op::kState];
#pragma unroll
  for (int q = 0; q < Op::kState; ++q) s[q] = y0[row * Op::kState + q];
  Op::apply(ex, s);
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int q = 0; q < Op::kState; ++q)
      starts[(row * ntiles + k) * Op::kState + q] = s[q];
    Op::apply(tot + k * Op::kMap, s);
  }
}

// Pass 3: rerun each tile from its start state and write the states.
template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_apply(ScanArgs args, const float* __restrict__ starts, long long n,
           int ntiles) {
  __shared__ float sm[Op::kMap * Tile<Op>::kPitch];
  __shared__ float warp_tot[kWarps * Op::kMap];
  const long long blk = blockIdx.x;
  const long long row = blk / ntiles;
  const long long base = (blk % ntiles) * Tile<Op>::kLen;
  load_tile<Op>(args, row, base, n, sm);
  __syncthreads();
  float m[Op::kMap], ex[Op::kMap], total[Op::kMap];
  compose_run<Op>(sm, m);
  block_scan<Op>(m, ex, total, warp_tot);
  float s[Op::kState];
#pragma unroll
  for (int q = 0; q < Op::kState; ++q) s[q] = starts[blk * Op::kState + q];
  Op::apply(ex, s);
  // state q overwrites plane q of the element just read: only this thread
  // reads its run
  const int i0 = threadIdx.x * Op::kPerThread;
#pragma unroll
  for (int j = 0; j < Op::kPerThread; ++j) {
    float e[Op::kMap];
    element<Op>(sm, i0 + j, e);
    Op::apply(e, s);
#pragma unroll
    for (int q = 0; q < Op::kState; ++q)
      sm[q * Tile<Op>::kPitch + padded(i0 + j)] = s[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Op::kState; ++q) {
    float* dst = args.out[q] + row * n;
#pragma unroll
    for (int k = 0; k < Op::kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const long long g = base + i;
      if (g < n) dst[g] = sm[q * Tile<Op>::kPitch + padded(i)];
    }
  }
}

template <class Op>
int launch(const ScanArgs& args, const float* y0, float* totals,
           float* starts, int rows, long long n, cudaStream_t s) {
  const long long ntiles = (n + Tile<Op>::kLen - 1) / Tile<Op>::kLen;
  const long long blocks = rows * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_tile_totals<Op><<<(unsigned)blocks, kThreads, 0, s>>>(args, totals, n,
                                                             (int)ntiles);
  scan_fold<Op><<<rows, kThreads, 0, s>>>(totals, y0, starts, (int)ntiles);
  scan_apply<Op><<<(unsigned)blocks, kThreads, 0, s>>>(args, starts, n,
                                                       (int)ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile of each kind (0 linear, 1 max_affine, 2 affine2x2):
// the wrapper sizes the scratch from it.
int flan_scan_tile(int kind) {
  switch (kind) {
    case 0: return Tile<Linear>::kLen;
    case 1: return Tile<MaxAffine>::kLen;
    case 2: return Tile<Affine2x2>::kLen;
    default: return 0;
  }
}

// kind 0 linear, 1 max_affine, 2 affine2x2. in_ptrs, in_strides: host
// arrays of the kind's planes (2, 3 or 6) as device addresses and row
// strides (0 or n); out_ptrs: its 1 or 2 outputs [rows, n]. y0 [rows, kState];
// totals scratch [rows, ntiles, kMap]; starts scratch [rows, ntiles, kState],
// ntiles = ceil(n / flan_scan_tile(kind)). All float32 on the stream's
// device.
int flan_scan(int kind, const long long* in_ptrs, const long long* in_strides,
              const long long* out_ptrs, const float* y0, float* totals,
              float* starts, int rows, long long n, void* stream) {
  if (kind < 0 || kind > 2 || rows < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int planes = kind == 0 ? 2 : (kind == 1 ? 3 : 6);
  ScanArgs args = {};
  for (int p = 0; p < planes; ++p) {
    args.in[p] = reinterpret_cast<const float*>(in_ptrs[p]);
    args.stride[p] = in_strides[p];
  }
  for (int q = 0; q < (kind == 2 ? 2 : 1); ++q)
    args.out[q] = reinterpret_cast<float*>(out_ptrs[q]);
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<Linear>(args, y0, totals, starts, rows, n, s);
    case 1: return launch<MaxAffine>(args, y0, totals, starts, rows, n, s);
    default: return launch<Affine2x2>(args, y0, totals, starts, rows, n, s);
  }
}

}  // extern "C"
