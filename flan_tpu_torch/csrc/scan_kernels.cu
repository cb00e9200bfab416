// Linear-recurrence scans for Hopper: y[n] = f_n(y[n-1]) along the last axis
// of [rows, N], for four families of maps f_n that are closed under
// composition:
//   linear      y -> a y + b                      (2 planes in, 1 state)
//   max_affine  y -> max(m, a y + c), a >= 0      (3 planes in, 1 state)
//   affine_kxk  s -> A s + b, A k x k             (k*k + k planes, k states)
// Each map has one instantiation: the 2-pole SVF's 2 x 2 (flan_scan kind 2)
// is AffineKxK<2>, and the k x k entry point runs k = 1 as Linear.
//
// Replaces the TPU kernels of tools/pallas_scan_experiment.py:
//   T1  _compose_maps -> kernel  (each chain's total affine map)
//   T2  _apply_from   -> kernel  (rerun each chain from its start state)
// and computes what flan_tpu/ops/scan.py linear_recurrence,
// max_affine_recurrence and matrix_affine_recurrence (k = 2, and any k for
// the multinotch filters) compute. The plain PyTorch versions are
// flan_tpu_torch/ops/scan_kernels.py linear_ref, max_affine_ref,
// affine2x2_ref and affine_kxk_ref.
//
// Bound: memory. Each element is read once per plane and written once per
// state: 12 bytes for linear, 16 for max_affine and 32 for the 2 x 2 when
// every plane is a full [rows, N] tensor (a plane that is one row shared by
// all rows is read once). The arithmetic is a few FMAs per element. So the
// design moves each byte once: T1/T2's two passes (the chains' total maps,
// then a rerun from each start state) are one launch here, a scan with
// decoupled look-back (Merrill and Garland 2016) whose order of composition
// is fixed, so that a call gives the same bits every time.
//
// Design. One row is split along time into tiles of kThreads * kPerThread
// elements, so one long row (the compressor's control signal is a single
// row of N samples) still fills the card, and nothing is transposed or
// padded. One block per (tile, row):
//   1. it takes a ticket from a counter, and the ticket names its tile:
//      tile = ticket / rows, row = ticket % rows. Every tile a block will
//      wait for has a smaller ticket, so its block is running or done
//      (blockIdx promises no such order), and the rows of one tile run
//      together, so a plane shared by the rows (row stride 0) comes from
//      device memory once and from L2 for the other rows;
//   2. it loads its tile coalesced into shared memory by asynchronous
//      copies (the ragged last tile filled with the identity map); each
//      thread composes its run of
//      kPerThread consecutive elements in registers, and a block scan of
//      the maps (warp shuffles, then the 8 warp totals) gives each
//      thread's exclusive prefix and the tile's total map;
//   3. it publishes the total map in the tile's descriptor. A descriptor
//      word is 64 bits, a float beside a flag, stored at once: a reader
//      that sees the flag has the float, with no fence (the scratch is
//      zeroed on the stream before the launch);
//   4. look-back, in a fixed order. Tiles are grouped in windows of
//      kWindow = kThreads. Tile k = w * kWindow + r composes the totals of
//      the r tiles before it in its window, one per thread, by a fixed tree
//      (shuffles, then the warp totals in order), and applies the result to
//      the state at the window's start. That state is published by the
//      window's first tile, which composes all kWindow totals of the window
//      before it and applies them to that window's start state: a chain of
//      N / (kWindow * tile) hops, each a poll and one map application,
//      which runs ahead of the streaming. What a tile composes depends on
//      its index alone, never on which blocks happened to be done;
//   5. it applies each thread's exclusive prefix to the tile's start state,
//      reruns the recurrence over the thread's run into shared memory, and
//      stores the states coalesced.
// A plane may be one row shared by every row (row stride 0), so a
// coefficient computed once per frame is never broadcast in memory.
//
// What holds it (PERF.md has the readings): a block waits 2 to 4
// microseconds in step 4, two trips to L2 and a reduction, since the tile
// just before it finishes when it does. To keep the memory busy meanwhile a
// multiprocessor must hold some 200 KB of tiles in flight. So the tiles
// are large (16 elements a thread for the one-state maps, 8 for the 2x2),
// they wait in shared memory and not in registers (the asynchronous
// copies), and __launch_bounds__ asks for as many blocks as the shared
// memory holds. The 2x2 map is bound by its arithmetic besides: a block
// scan and a look-back reduction of 6-float maps, 20 operations a
// composition.
//
// The k x k map (entry point flan_scan_kxk) runs in this one-pass scan for
// k <= kMaxRegK: its map is k*k + k floats (72 at k = 8), composed in the
// operation order of flan_tpu/ops/scan.py:245-257. Its least time is its
// bytes, but what holds it is the k^3 FMAs of a composition, ~15 of them a
// thread a tile in the block scan and the look-back, and the registers
// that hold the maps (255 at k = 8): 6.5 ms at k = 4 and 85 ms at k = 8 for
// 600 s stereo on an H100 against 1.1 and 3.3 ms of bytes (PERF.md). The
// threads run 1 to 16 elements each so that the tile's planes still fit
// in shared memory. Above kMaxRegK a map no longer fits a
// thread's registers, and flan_scan_kxk runs scan_kxk_rows instead: one
// block per row steps through time, each thread one state component, the
// state in shared memory (k^2 FMAs a step, N dependent steps), the maps of
// the next chunk of steps staged in shared memory while a chunk runs. A
// variant chosen by k, for every k.
//
// The max_affine identity is m = -1e30, not -inf: decay products underflow
// to 0 and 0 * -inf is NaN (flan_tpu/ops/scan.py:208-210). Its composition
// law holds only for a >= 0.
//
// The entry point zeroes the scratch and launches on the stream it is
// given and returns cudaGetLastError(); it allocates nothing and does not
// synchronise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegK = 8;       // the largest k x k map of the one pass
constexpr int kMaxPlanes = kMaxRegK * kMaxRegK + kMaxRegK;
constexpr int kMaxStates = kMaxRegK;
constexpr int kWindow = kThreads;  // tiles per look-back window

typedef unsigned long long Word;   // a float (low half) beside its flag

struct ScanArgs {
  const float* in[kMaxPlanes];
  long long stride[kMaxPlanes];  // row stride of each plane: 0 for shared
  float* out[kMaxStates];        // each at out[q] + row * out_stride
  long long out_stride;
};

// Each family: kMap components (the element map is its planes, in order),
// kState state components, kPerThread elements of a tile per thread and
// kBlocks blocks a multiprocessor is to hold (their tiles fill its shared
// memory; the compiler keeps the registers within that), the identity, the
// composition "l, then r", and the application of a map to a state.
struct Linear {
  static constexpr int kMap = 2, kState = 1, kPerThread = 16, kBlocks = 5;
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
  static constexpr int kMap = 3, kState = 1, kPerThread = 16, kBlocks = 4;
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

// (A row-major, then b): k*k + k planes, k states; at k = 2 the SVF's
// (a11, a12, a21, a22, b1, b2). The threads' runs shrink with k so that the
// tile's planes fit in shared memory (76 KB at k = 8). k = 1 is the Linear
// map and runs as it.
template <int K>
struct AffineKxK {
  static constexpr int kMap = K * K + K, kState = K;
  static_assert(K >= 2, "k = 1 is the Linear map");
  static constexpr int kPerThread = K == 2 ? 8 : (K == 3 ? 4 : (K <= 5 ? 2 : 1));
  static constexpr int kBlocks = K == 2 ? 4 : (K <= 4 ? 2 : 1);
  __device__ static float identity(int p) {
    return (p < K * K && p / K == p % K) ? 1.f : 0.f;
  }
  __device__ static void compose(const float* l, const float* r, float* o) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float acc = r[i * K] * l[j];
#pragma unroll
        for (int m = 1; m < K; ++m) acc += r[i * K + m] * l[m * K + j];
        o[i * K + j] = acc;
      }
      float acc = r[i * K] * l[K * K];
#pragma unroll
      for (int m = 1; m < K; ++m) acc += r[i * K + m] * l[K * K + m];
      o[K * K + i] = acc + r[K * K + i];
    }
  }
  __device__ static void apply(const float* m, float* s) {
    float t[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float acc = m[i * K] * s[0];
#pragma unroll
      for (int j = 1; j < K; ++j) acc += m[i * K + j] * s[j];
      t[i] = acc + m[K * K + i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = t[i];
  }
};

template <class Op>
struct Tile {
  static constexpr int kLen = kThreads * Op::kPerThread;
  // one padding float per 32, so a thread's run of kPerThread elements and
  // the coalesced rows both fall on distinct banks
  static constexpr int kPitch = kLen + kLen / 32;
  static constexpr int kBytes = Op::kMap * kPitch * (int)sizeof(float);
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
// composition of the maps of all earlier threads and, in the last warp,
// `total` that of all threads. warp_tot is kWarps * kMap floats of shared
// memory.
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
  set_identity<Op>(pre);
  for (int w = 0; w < warp; ++w) compose_into<Op>(pre, warp_tot + w * Op::kMap);
  Op::compose(pre, lane_ex, ex);
  Op::compose(pre, warp_tot + warp * Op::kMap, total);
  __syncthreads();  // warp_tot may be reused after this
}

// The block's tile of every plane into shared memory, coalesced; elements
// past N are the identity map. The copies are asynchronous (cp.async, 4
// bytes each: the padded rows admit no wider one), so a tile in flight
// holds shared memory and no registers: how many bytes a multiprocessor
// keeps in flight is what bounds this kernel, since each block waits some
// microseconds on its look-back. The caller waits with copies_done().
template <class Op>
__device__ void load_tile(const ScanArgs& args, long long row, long long base,
                          long long n, float* sm) {
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p) {
    const float* src = args.in[p] + row * args.stride[p] + base;
    float* dst = sm + p * Tile<Op>::kPitch;
#pragma unroll 4
    for (int k = 0; k < Op::kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (base + i < n) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         (unsigned)__cvta_generic_to_shared(dst + padded(i))),
                     "l"(src + i));
      } else {
        dst[padded(i)] = Op::identity(p);
      }
    }
  }
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
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

// ----------------------------------------------------------- descriptors

__device__ __forceinline__ void publish(Word* p, float v) {
  *reinterpret_cast<volatile Word*>(p) = (1ull << 32) | __float_as_uint(v);
}

// Spin until all K words at p carry their flag; every round issues the K
// loads together.
template <int K>
__device__ __forceinline__ void poll(const Word* p, float* v) {
  const volatile Word* q = reinterpret_cast<const volatile Word*>(p);
  bool ready;
  do {
    Word w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = q[k];
    ready = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ready = ready && (w[k] >> 32) != 0;
      v[k] = __uint_as_float((unsigned)w[k]);
    }
  } while (!ready);
}

// The threads' maps composed in thread order by a fixed tree: pairs of
// lanes at distance 1, 2, ... 16, then the warp totals in order. Thread 0
// returns with the result in v; warp_tot is kWarps * kMap floats.
template <class Op>
__device__ void block_reduce(float* v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float other[Op::kMap];
#pragma unroll
    for (int p = 0; p < Op::kMap; ++p)
      other[p] = __shfl_down_sync(0xffffffffu, v[p], d);
    if ((lane & (2 * d - 1)) == 0) compose_into<Op>(v, other);
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < Op::kMap; ++p) warp_tot[warp * Op::kMap + p] = v[p];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      compose_into<Op>(v, warp_tot + w * Op::kMap);
  }
}

// Scratch, in words: the ticket counter; the tiles' total maps
// [rows, ntiles, kMap]; the windows' start states [rows, nwindows, kState]
// (window 0 starts from y0 and its entry is unused).
__host__ __device__ inline long long windows_of(long long ntiles) {
  return (ntiles + kWindow - 1) / kWindow;
}

template <class Op>
long long scratch_words(long long rows, long long ntiles) {
  return 1 + rows * ntiles * Op::kMap + rows * windows_of(ntiles) * Op::kState;
}

template <class Op>
__global__ void __launch_bounds__(kThreads, Op::kBlocks)
scan_one_pass(ScanArgs args, const float* __restrict__ y0, Word* scratch,
              long long n, int ntiles, int rows) {
  extern __shared__ float sm[];      // Tile<Op>::kBytes: the tile's planes
  __shared__ float warp_tot[kWarps * Op::kMap];
  __shared__ float start[Op::kState];
  __shared__ unsigned ticket_sm;
  if (threadIdx.x == 0)
    ticket_sm = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int tile = (int)(ticket_sm / (unsigned)rows);
  const long long row = ticket_sm - (unsigned)tile * (unsigned)rows;
  const long long base = (long long)tile * Tile<Op>::kLen;
  Word* totals = scratch + 1;
  Word* states = totals + (long long)rows * ntiles * Op::kMap;

  load_tile<Op>(args, row, base, n, sm);
  copies_done();
  float m[Op::kMap], ex[Op::kMap], total[Op::kMap];
  compose_run<Op>(sm, m);
  block_scan<Op>(m, ex, total, warp_tot);
  // only the last warp holds the total: lane 31 - p % 32 stores word p
#pragma unroll
  for (int p = 0; p < Op::kMap; ++p)
    if (threadIdx.x == kThreads - 1 - p % 32)
      publish(totals + (row * ntiles + tile) * Op::kMap + p, total[p]);

  // look-back: the first tile of a window takes the whole window before
  // it, every other tile the tiles of its own window before it
  const int window = tile / kWindow, r = tile - window * kWindow;
  const bool first = r == 0 && window > 0;
  const int from = first ? window - 1 : window;     // the window composed
  const int count = first ? kWindow : r;            // and how many tiles
  if (count > 0) {
    float before[Op::kMap];
    if ((int)threadIdx.x < count)
      poll<Op::kMap>(totals + (row * ntiles + (long long)from * kWindow +
                               threadIdx.x) * Op::kMap, before);
    else
      set_identity<Op>(before);
    block_reduce<Op>(before, warp_tot);
    if (threadIdx.x == 0) {
      Word* at = states + row * windows_of(ntiles) * Op::kState;
      float s[Op::kState];
      if (from == 0) {
#pragma unroll
        for (int q = 0; q < Op::kState; ++q) s[q] = y0[row * Op::kState + q];
      } else {
        poll<Op::kState>(at + (long long)from * Op::kState, s);
      }
      Op::apply(before, s);
#pragma unroll
      for (int q = 0; q < Op::kState; ++q) {
        if (first) publish(at + (long long)window * Op::kState + q, s[q]);
        start[q] = s[q];
      }
    }
  } else if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < Op::kState; ++q) start[q] = y0[row * Op::kState + q];
  }
  __syncthreads();

  float s[Op::kState];
#pragma unroll
  for (int q = 0; q < Op::kState; ++q) s[q] = start[q];
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
    float* dst = args.out[q] + row * args.out_stride;
#pragma unroll 4
    for (int k = 0; k < Op::kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const long long g = base + i;
      if (g < n) dst[g] = sm[q * Tile<Op>::kPitch + padded(i)];
    }
  }
}

template <class Op>
long long tiles_of(long long n) {
  return (n + Tile<Op>::kLen - 1) / Tile<Op>::kLen;
}

template <class Op>
int launch(const ScanArgs& args, const float* y0, Word* scratch, int rows,
           long long n, cudaStream_t s) {
  const long long ntiles = tiles_of<Op>(n);
  const long long blocks = rows * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t zeroed = cudaMemsetAsync(
      scratch, 0, sizeof(Word) * scratch_words<Op>(rows, ntiles), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  // a tile is more than the 48 KB a block may use without asking (asked
  // on every call: the attribute belongs to the current device)
  const cudaError_t allowed = cudaFuncSetAttribute(
      scan_one_pass<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<Op>::kBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  scan_one_pass<Op><<<(unsigned)blocks, kThreads, Tile<Op>::kBytes, s>>>(
      args, y0, scratch, n, (int)ntiles, rows);
  return (int)cudaGetLastError();
}

// The k x k map in the one pass: A [rows or 1, k*k, N] (a_row its row
// stride, 0 when one A serves every row), b and y [rows, k, N], y0
// [rows, k], all contiguous. k = 1 is the Linear map.
template <int K>
int launch_kxk(const float* A, long long a_row, const float* b, float* y,
               const float* y0, Word* scratch, int rows, long long n,
               cudaStream_t s) {
  ScanArgs args = {};
  if constexpr (K == 1) {
    args.in[0] = A;
    args.stride[0] = a_row;
    args.in[1] = b;
    args.stride[1] = n;
    args.out[0] = y;
    args.out_stride = n;
    return launch<Linear>(args, y0, scratch, rows, n, s);
  } else {
    for (int p = 0; p < K * K; ++p) {
      args.in[p] = A + p * n;
      args.stride[p] = a_row;
    }
    for (int q = 0; q < K; ++q) {
      args.in[K * K + q] = b + q * n;
      args.stride[K * K + q] = (long long)K * n;
      args.out[q] = y + q * n;
    }
    args.out_stride = (long long)K * n;
    return launch<AffineKxK<K>>(args, y0, scratch, rows, n, s);
  }
}

// The k x k map for k > kMaxRegK, in time order: one block per row, thread
// i computes state component i (and i + blockDim.x, ...) of every step
// from the last step's state in shared memory, y[n] = A[n] y[n-1] + b[n]
// with each row of A[n] summed in column order: N dependent steps of a
// k-long chain of FMAs and a barrier. A step reads k*k + k planes, each N
// floats apart, so the block stages chunks of L steps of them in shared
// memory (a warp copies a plane's L consecutive floats, asynchronously,
// while the chunk before is computed), and a step reads shared memory
// only. Where one step's maps do not fit twice (k > ~110), L is 0 and the
// steps read the planes from device memory. y overwrites b in the chunk's
// buffer and is stored coalesced after the chunk.
constexpr int kRowsThreads = 256;
constexpr int kRowsChunk = 128;
constexpr long long kRowsSharedFloats = 50 * 1024;   // 200 KB

__host__ int rows_chunk(int k) {
  const long long per = 2LL * ((long long)k * k + k);   // two buffers
  const long long fit = (kRowsSharedFloats - 2LL * k) / per - 1;
  return fit >= kRowsChunk ? kRowsChunk : (fit < 1 ? 0 : (int)fit);
}

// The planes of steps t0 .. t0 + L - 1 into buf ([k*k + k][L + 1]: A's,
// then b's), past n the identity's zeros; asynchronous, committed.
__device__ void stage_rows(float* buf, const float* ar, const float* br,
                           int k, int L, long long t0, long long n) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < k * k + k; p += warps) {
    const float* src = p < k * k ? ar + (long long)p * n
                                 : br + (long long)(p - k * k) * n;
    for (int j = lane; j < L; j += 32) {
      float* dst = buf + p * (L + 1) + j;
      if (t0 + j < n) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         (unsigned)__cvta_generic_to_shared(dst)),
                     "l"(src + t0 + j));
      } else {
        *dst = 0.f;
      }
    }
  }
  asm volatile("cp.async.commit_group;");
}

// K > 0: k == K, a step's products unrolled, so that all its loads are
// issued before its FMAs (half the time of the loop at k = 12 on an H100);
// 0: any k, in a loop.
template <int K>
__global__ void __launch_bounds__(kRowsThreads)
scan_kxk_rows(const float* __restrict__ A, long long a_row,
              const float* __restrict__ b, float* __restrict__ y,
              const float* __restrict__ y0, int k, long long n, int L) {
  extern __shared__ float sm[];
  const long long row = blockIdx.x;
  const float* ar = A + row * a_row;
  const float* br = b + row * k * n;
  float* yr = y + row * k * n;
  const bool staged = L > 0;
  const int len_max = staged ? L : 1;
  const int P = L + 1;
  float* st = sm;                     // two states of k floats, in turns
  // two buffers of a chunk's planes, in turns
  const int buf_floats = (k * k + k) * P;
  for (int i = threadIdx.x; i < k; i += blockDim.x) st[i] = y0[row * k + i];
  if (staged) stage_rows(sm + 2 * k, ar, br, k, L, 0, n);
  int cur = 0;
  for (long long t0 = 0, c = 0; t0 < n; t0 += len_max, ++c) {
    const int len = (int)(n - t0 < len_max ? n - t0 : len_max);
    float* as = sm + 2 * k + (c & 1) * buf_floats;
    float* bs = as + k * k * P;
    if (staged) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();   // this chunk landed; the last chunk's y stored
      if (t0 + L < n)
        stage_rows(sm + 2 * k + ((c + 1) & 1) * buf_floats, ar, br, k, L,
                   t0 + L, n);
    } else {
      __syncthreads();
    }
    for (int j = 0; j < len; ++j) {
      const float* s = st + cur * k;
      float* next = st + (1 - cur) * k;
      for (int i = threadIdx.x; i < k; i += blockDim.x) {
        float acc;
        if (staged) {
          const float* ai = as + i * k * P + j;
          acc = ai[0] * s[0];
          if constexpr (K > 0) {
#pragma unroll
            for (int m = 1; m < K; ++m) acc += ai[m * P] * s[m];
          } else {
#pragma unroll 4
            for (int m = 1; m < k; ++m) acc += ai[m * P] * s[m];
          }
          acc += bs[i * P + j];
          bs[i * P + j] = acc;
        } else {
          const float* ai = ar + (long long)i * k * n + t0;
          acc = ai[0] * s[0];
          for (int m = 1; m < k; ++m) acc += ai[(long long)m * n] * s[m];
          acc += br[(long long)i * n + t0];
          yr[(long long)i * n + t0] = acc;
        }
        next[i] = acc;
      }
      __syncthreads();
      cur = 1 - cur;
    }
    if (staged) {
      const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
      for (int q = threadIdx.x >> 5; q < k; q += warps)
        for (int j = lane; j < len; j += 32)
          yr[(long long)q * n + t0 + j] = bs[q * P + j];
    }
  }
}

int launch_kxk_rows(const float* A, long long a_row, const float* b,
                    float* y, const float* y0, int k, int rows, long long n,
                    cudaStream_t s) {
  const int L = rows_chunk(k);
  const int threads = k <= kRowsThreads ? kRowsThreads
                                        : (k >= 1024 ? 1024 : (k + 31) / 32 * 32);
  const size_t bytes = sizeof(float) *
      (2 * (size_t)k + (L > 0 ? 2 * ((size_t)k * k + k) * (L + 1) : 0));
  // the unrolled steps for the k of the multinotch filters of order up to
  // 16 (1-pole) and 8 (2-pole) above the one pass
  decltype(&scan_kxk_rows<0>) kernel = scan_kxk_rows<0>;
  switch (k) {
#define FLAN_KXK_ROWS(K) \
    case K: kernel = scan_kxk_rows<K>; break;
    FLAN_KXK_ROWS(9) FLAN_KXK_ROWS(10) FLAN_KXK_ROWS(11) FLAN_KXK_ROWS(12)
    FLAN_KXK_ROWS(13) FLAN_KXK_ROWS(14) FLAN_KXK_ROWS(15) FLAN_KXK_ROWS(16)
#undef FLAN_KXK_ROWS
    default: break;
  }
  const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (allowed != cudaSuccess) return (int)allowed;
  kernel<<<rows, threads, bytes, s>>>(A, a_row, b, y, y0, k, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile of each kind (0 linear, 1 max_affine, 2 the 2 x 2) and
// tiles per look-back window: the wrappers check their constants by them.
int flan_scan_tile(int kind) {
  switch (kind) {
    case 0: return Tile<Linear>::kLen;
    case 1: return Tile<MaxAffine>::kLen;
    case 2: return Tile<AffineKxK<2>>::kLen;
    default: return 0;
  }
}

int flan_scan_window_tiles() { return kWindow; }

// Bytes of scratch one call of flan_scan needs; 0 for a bad kind.
long long flan_scan_scratch_bytes(int kind, int rows, long long n) {
  switch (kind) {
    case 0: return 8 * scratch_words<Linear>(rows, tiles_of<Linear>(n));
    case 1: return 8 * scratch_words<MaxAffine>(rows, tiles_of<MaxAffine>(n));
    case 2:
      return 8 * scratch_words<AffineKxK<2>>(rows, tiles_of<AffineKxK<2>>(n));
    default: return 0;
  }
}

// The k x k map: elements per tile of the one pass (0 above kMaxRegK,
// where scan_kxk_rows runs), and the bytes of scratch a call needs (8 for
// scan_kxk_rows, which uses none).
int flan_scan_kxk_tile(int k) {
  switch (k) {
#define FLAN_KXK_TILE(K) \
    case K: return Tile<AffineKxK<K>>::kLen;
    case 1: return Tile<Linear>::kLen;
    FLAN_KXK_TILE(2) FLAN_KXK_TILE(3) FLAN_KXK_TILE(4)
    FLAN_KXK_TILE(5) FLAN_KXK_TILE(6) FLAN_KXK_TILE(7) FLAN_KXK_TILE(8)
#undef FLAN_KXK_TILE
    default: return 0;
  }
}

int flan_scan_max_reg_k() { return kMaxRegK; }

long long flan_scan_kxk_scratch_bytes(int k, int rows, long long n) {
  switch (k) {
#define FLAN_KXK_SCRATCH(K)                                  \
    case K:                                                  \
      return 8 * scratch_words<AffineKxK<K>>(                \
                     rows, tiles_of<AffineKxK<K>>(n));
    case 1: return 8 * scratch_words<Linear>(rows, tiles_of<Linear>(n));
    FLAN_KXK_SCRATCH(2) FLAN_KXK_SCRATCH(3)
    FLAN_KXK_SCRATCH(4) FLAN_KXK_SCRATCH(5) FLAN_KXK_SCRATCH(6)
    FLAN_KXK_SCRATCH(7) FLAN_KXK_SCRATCH(8)
#undef FLAN_KXK_SCRATCH
    default: return k > kMaxRegK ? 8 : 0;
  }
}

// y[n] = A[n] y[n-1] + b[n] for k x k maps: A [rows or 1, k*k, n] row-major
// maps with row stride a_row (0: one A for every row), b and y [rows, k,
// n], y0 [rows, k]; scratch: flan_scan_kxk_scratch_bytes(k, rows, n)
// bytes, 8-byte aligned. All float32, contiguous, on the stream's device.
int flan_scan_kxk(int k, const float* A, long long a_row, const float* b,
                  float* y, const float* y0, void* scratch, int rows,
                  long long n, void* stream) {
  if (k < 1 || rows < 1 || n < 1 ||
      reinterpret_cast<unsigned long long>(scratch) % sizeof(Word) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Word* w = reinterpret_cast<Word*>(scratch);
  switch (k) {
#define FLAN_KXK_LAUNCH(K) \
    case K: return launch_kxk<K>(A, a_row, b, y, y0, w, rows, n, s);
    FLAN_KXK_LAUNCH(1) FLAN_KXK_LAUNCH(2) FLAN_KXK_LAUNCH(3)
    FLAN_KXK_LAUNCH(4) FLAN_KXK_LAUNCH(5) FLAN_KXK_LAUNCH(6)
    FLAN_KXK_LAUNCH(7) FLAN_KXK_LAUNCH(8)
#undef FLAN_KXK_LAUNCH
    default: return launch_kxk_rows(A, a_row, b, y, y0, k, rows, n, s);
  }
}

// kind 0 linear, 1 max_affine, 2 the 2 x 2 map (a11, a12, a21, a22, b1, b2).
// in_ptrs, in_strides: host
// arrays of the kind's planes (2, 3 or 6) as device addresses and row
// strides (0 or n); out_ptrs: its 1 or 2 outputs [rows, n]. y0 [rows, kState];
// scratch: flan_scan_scratch_bytes(kind, rows, n) bytes, 8-byte aligned. All
// float32 on the stream's device.
int flan_scan(int kind, const long long* in_ptrs, const long long* in_strides,
              const long long* out_ptrs, const float* y0, void* scratch,
              int rows, long long n, void* stream) {
  // a descriptor word is one 64-bit store and load: the scratch must be
  // aligned to it
  if (kind < 0 || kind > 2 || rows < 1 || n < 1 ||
      reinterpret_cast<unsigned long long>(scratch) % sizeof(Word) != 0)
    return (int)cudaErrorInvalidValue;
  const int planes = kind == 0 ? 2 : (kind == 1 ? 3 : 6);
  ScanArgs args = {};
  for (int p = 0; p < planes; ++p) {
    args.in[p] = reinterpret_cast<const float*>(in_ptrs[p]);
    args.stride[p] = in_strides[p];
  }
  for (int q = 0; q < (kind == 2 ? 2 : 1); ++q)
    args.out[q] = reinterpret_cast<float*>(out_ptrs[q]);
  args.out_stride = n;
  cudaStream_t s = (cudaStream_t)stream;
  Word* w = reinterpret_cast<Word*>(scratch);
  switch (kind) {
    case 0: return launch<Linear>(args, y0, w, rows, n, s);
    case 1: return launch<MaxAffine>(args, y0, w, rows, n, s);
    default: return launch<AffineKxK<2>>(args, y0, w, rows, n, s);
  }
}

}  // extern "C"
