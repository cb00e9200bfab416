// Linear-recurrence scans for Hopper: y[n] = f_n(y[n-1]) along the last axis
// of [rows, N], for four families of maps f_n that are closed under
// composition:
//   linear      y -> a y + b                      (2 planes in, 1 state)
//   max_affine  y -> max(m, a y + c), a >= 0      (3 planes in, 1 state)
//   affine_kxk  s -> A s + b, A k x k             (k*k + k planes, k states)
// The one pass below runs the linear, max_affine and 2 x 2 maps (the 2-pole
// SVF's, flan_scan kind 2, AffineKxK<2>); the k x k entry point runs k = 1
// as Linear, k = 2 as AffineKxK<2> and k >= 3 in a kernel of its own.
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
// The k x k map for k >= 3 (entry point flan_scan_kxk)
// replaces the same TPU pair, T1/T2, for the multinotch filters' maps
// (flan_tpu/ops/scan.py:245-262 matrix_affine_recurrence) and runs its own
// kernel, scan_kxk_chunked. Its least time is its bytes: a step reads k*k
// floats of A (once for all rows that share it: the multinotch passes one
// A for both channels) and k of b per row and writes k of y per row, 22 GB
// at k = 12 for 600 s stereo, 6.6 ms on an H100. A parallel scan of it
// also needs k^3 FMAs a step for A's part (once per shared A) and k^2 per
// row: ~1.5 ms of float32 at k = 12, below the bytes up to k = 16. What
// the one pass does with a whole map in a thread's registers (compose maps
// ~15 times a thread a tile, k^3 FMAs each) would cost k^3 per element and
// row, 255 registers at k = 8. So the design keeps maps out of registers
// and composes them once per sub-run:
//   1. one block per (tile of L steps, group of up to kKxKGroup rows that
//      share A; a row alone where each row has its own A) stages the
//      tile's planes in shared memory, a plane's L steps one contiguous
//      span (16-byte cp.async), A once for the group;
//   2. the tile is S sub-runs of R steps. For each, threads carry the
//      columns of its A-product from e_c and one vector a row its b-part
//      from 0, v <- A[t] v (+ b[t]) in time order, 2 to 4 vectors a
//      thread so each A entry read (a broadcast: a sub-run's lanes read
//      the same step; the steps' 16-byte chunks are permuted so sub-runs
//      fall on distinct banks) serves several products; k^2 FMAs a vector
//      a step, no exchange;
//   3. the sub-runs' maps are composed in order into their prefixes; the
//      last is the tile's total, published in 64-bit (flag | float)
//      descriptor words as the one pass does;
//   4. the carry across tiles, in windows of kKxKWindow tiles: the last
//      tile of a window folds the window's totals in order into its total
//      (one composition, k^3 FMAs, a tile); a window's start state is the
//      window totals before it applied in order to y0, found by a
//      decoupled look-back (the nearest published window state, the
//      totals after it read in batches and applied, k^2 FMAs a row each)
//      and published; a tile's start state is its window's with the totals
//      of the tiles before it in the window applied, or the end state of
//      an earlier tile of its window (the same fold) where one is
//      published. A chain of one state a tile would cost ~80 cycles a tile
//      in a row, 9 ms at k = 12. Every application and composition runs
//      the same rounded operations (apply_one, compose_one) whichever
//      block does it, so a state is the same bits on every call;
//   5. each (sub-run, row) thread takes its start state through the prefix
//      before it and steps its R steps in time order, y over b in shared
//      memory, then the tile is stored coalesced.
// Above k = 32 (kKxKRegK) a thread's vectors no longer fit its registers
// and a tile's planes and maps outgrow shared memory (a map alone is 4 KB
// at k = 32, 40 KB at k = 100): the same steps run with one thread an
// output, a round a step, the planes read from device memory and the maps
// and states in the scratch (scan_kxk_chunked<0>).
// No tensor cores: TF32 keeps ~3 digits. What holds it on an H100
// (PERF.md, by python -m flan_tpu_torch.ops.spv_variants --source kxk): a
// few warps a block in steps 2, 3 and 5, their loads from shared memory
// and their latency, and the carry's trips to L2; 25-38% of the byte bound
// at k = 4 to 12. k = 1 and k = 2 keep the one pass: the linear map's state
// is one float, and the SVF's 2 x 2 map (flan_scan kind 2, also k = 2
// here) is 6 floats, composed at 20 operations, at half its byte bound;
// this kernel took about three times as long at k = 2.
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
constexpr int kMaxPlanes = 6;     // the 2 x 2 map's
constexpr int kMaxStates = 2;
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

// (A row-major, then b): k*k + k planes, k states. Only k = 2, the SVF's
// (a11, a12, a21, a22, b1, b2), runs in the one pass.
template <int K>
struct AffineKxK {
  static constexpr int kMap = K * K + K, kState = K;
  static_assert(K == 2, "k = 1 is the Linear map, k >= 3 scan_kxk_chunked");
  static constexpr int kPerThread = 8, kBlocks = 4;
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

// The k x k map for k = 1 and 2 in the one pass: A [rows or 1, k*k, N]
// (a_row its row stride, 0 when one A serves every row), b and y [rows, k,
// N], y0 [rows, k], all contiguous. k = 1 is the Linear map, k = 2 the
// SVF's AffineKxK<2>.
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

// ------------------------------------------- the k x k map, k >= 3: chunked
//
// One block per (tile of L steps, group of rows). Where one A serves every
// row the group is up to kKxKGroup rows and the block loads the tile's A
// once for all of them; where each row has its own A a row is a group.
// The tile is S sub-runs of R steps. Maps are (Phi k x k row-major, beta
// k x g): the state [k][g] of the group's g rows goes to Phi x + beta.
constexpr int kKxKGroup = 4;     // rows of one shared A per block
constexpr int kKxKWindow = 8;    // tiles per window of the carry
constexpr int kKxKRegK = 32;     // the largest k whose vectors are registers

struct KxKTiling {
  int L, S, R;    // steps per tile, sub-runs per tile, steps per sub-run
};

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// Steps per tile: the planes of kKxKGroup rows (k*k + 4k floats a step)
// within ~96 KB, 8 to 512 steps; sub-runs: their maps twice (the sub-runs'
// and the prefixes) within ~24 KB, at most 16.
__host__ __device__ constexpr KxKTiling kxk_tiling(int k) {
  const int per = k * k + kKxKGroup * k;
  int L = pow2_floor(24576 / per);
  L = L < 8 ? 8 : (L > 512 ? 512 : L);
  int S = 3072 / per > 1 ? pow2_floor(3072 / per) : 1;
  S = S > 16 ? 16 : S;
  S = S > L ? L : S;
  return KxKTiling{L, S, L / S};
}

// Totals read at once in the carry: as many as ~8 KB holds, 1 to 8.
__host__ __device__ inline int kxk_batch(int k, int g) {
  const int b = 2048 / (k * k + k * g);
  return b < 1 ? 1 : (b > 8 ? 8 : b);
}

// The maps and states of a block of g rows: the sub-runs' maps (two at
// least: the carry folds a window in them), their prefixes, a batch of
// totals read in the carry, the state twice.
__host__ __device__ inline long long kxk_work_floats(int k, int g) {
  const KxKTiling t = kxk_tiling(k);
  const long long map = (long long)k * k + (long long)k * g;
  return (long long)((t.S > 2 ? t.S : 2) + t.S + kxk_batch(k, g)) * map +
         2LL * k * g;
}

// Shared memory of a block of g rows for k <= kKxKRegK: the tile's planes
// (A, then b, which y overwrites), then its maps and states. Above
// kKxKRegK the block reads the planes from device memory and keeps its
// maps and states in the scratch (kxk_work_floats each), since a k x k map
// outgrows shared memory as k grows.
__host__ __device__ inline long long kxk_smem_floats(int k, int g) {
  return ((long long)k * k + (long long)k * g) * kxk_tiling(k).L +
         kxk_work_floats(k, g);
}

// Scratch of a group, in 64-bit (flag | float) words: a record for each
// tile, then one for each window of kKxKWindow tiles, each its total map
// (Phi, then beta [k][g], g up to gmax) and the state after it [k][g].
__host__ __device__ inline long long kxk_record_words(int k, int gmax) {
  return (long long)k * k + 2LL * k * gmax;
}

__host__ __device__ inline long long kxk_group_words(int k, int gmax,
                                                     long long ntiles) {
  const long long nwin = (ntiles + kKxKWindow - 1) / kKxKWindow;
  return (ntiles + nwin) * kxk_record_words(k, gmax);
}

struct KxKLaunch {
  int gmax, ngroups;
  long long ntiles;
};

__host__ inline KxKLaunch kxk_launch_shape(int k, int rows, long long n,
                                           bool shared) {
  KxKLaunch s;
  s.gmax = shared ? (rows < kKxKGroup ? rows : kKxKGroup) : 1;
  s.ngroups = shared ? (rows + kKxKGroup - 1) / kKxKGroup : rows;
  s.ntiles = (n + kxk_tiling(k).L - 1) / kxk_tiling(k).L;
  return s;
}

// The descriptors (zeroed by every call), then above kKxKRegK each block's
// maps and states, kxk_work_floats(k, gmax) floats a block in ticket order.
__host__ inline long long kxk_scratch_words(int k, int rows, long long n,
                                            bool shared) {
  const KxKLaunch s = kxk_launch_shape(k, rows, n, shared);
  return 1 + s.ngroups * kxk_group_words(k, s.gmax, s.ntiles);
}

__host__ inline long long kxk_work_words(int k, int rows, long long n,
                                         bool shared) {
  if (k <= kKxKRegK) return 0;
  const KxKLaunch s = kxk_launch_shape(k, rows, n, shared);
  return (s.ntiles * s.ngroups * kxk_work_floats(k, s.gmax) + 1) / 2;
}

// Output o = (i, r) of the map T applied to the state x: row i of Phi
// against column r of x in column order, then beta. Every use of this
// function (a tile's own end state, a look-back's step) runs the same
// rounded operations, so a state is the same bits whoever computes it.
__device__ __forceinline__ float apply_one(const float* T, const float* x,
                                           int o, int k, int g) {
  const int i = o / g, r = o - (o / g) * g;
  const float* phi = T + i * k;
  float acc = __fmul_rn(phi[0], x[r]);
  for (int m = 1; m < k; ++m) acc = __fmaf_rn(phi[m], x[m * g + r], acc);
  return __fadd_rn(acc, T[k * k + o]);
}

// Output o of "P, then M" (maps of the same layout): Phi = Phi_M Phi_P,
// beta = Phi_M beta_P + beta_M, each sum in column order.
__device__ __forceinline__ float compose_one(const float* M, const float* P,
                                             int o, int k, int g) {
  const int kk = k * k;
  if (o < kk) {
    const int i = o / k, j = o - (o / k) * k;
    float acc = __fmul_rn(M[i * k], P[j]);
    for (int m = 1; m < k; ++m)
      acc = __fmaf_rn(M[i * k + m], P[m * k + j], acc);
    return acc;
  }
  const int q = o - kk, i = q / g, r = q - (q / g) * g;
  float acc = __fmul_rn(M[i * k], P[kk + r]);
  for (int m = 1; m < k; ++m)
    acc = __fmaf_rn(M[i * k + m], P[kk + m * g + r], acc);
  return __fadd_rn(acc, M[o]);
}

// Maps [t0, t0 + cnt) of `recs` (a map every `stride` words, `map` words
// each) into dst, as they are published: every round issues a thread's
// loads together (up to 8 words a thread at once) and repeats only while a
// flag is missing, so a batch costs one trip to L2, not one a word.
__device__ void load_maps(const Word* recs, long long stride, long long t0,
                          int cnt, int map, float* dst) {
  constexpr int kPer = 8;
  const int count = cnt * map;
  for (int o0 = threadIdx.x; o0 < count; o0 += kThreads * kPer) {
    bool ready;
    do {
      Word w[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int o = o0 + j * kThreads;
        if (o < count)
          w[j] = *reinterpret_cast<const volatile Word*>(
              recs + (t0 + o / map) * stride + o % map);
      }
      ready = true;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int o = o0 + j * kThreads;
        if (o < count) {
          if ((w[j] >> 32) == 0)
            ready = false;
          else
            dst[o] = __uint_as_float((unsigned)w[j]);
        }
      }
    } while (!ready);
  }
}

// Where step j of a plane's tile lies in shared memory: the 16-byte
// chunks of each 128-byte row are permuted by the row's index, so the
// sub-runs that a warp reads at one step (R apart) fall on distinct banks;
// a chunk stays whole for the 16-byte copies.
__device__ __forceinline__ int swz(int j) {
  const int c = j >> 2;
  return (((c & ~7) | ((c ^ (c >> 3)) & 7)) << 2) | (j & 3);
}

// A plane's L steps from base into shared memory (at swz), asynchronously:
// 16-byte copies where the chunk is whole and aligned, else 4-byte ones,
// and `fill` (the identity's entry) past n.
__device__ __forceinline__ void stage_plane(float* dst, const float* src,
                                            long long base, long long n,
                                            int L, float fill, int lane) {
  if (base + L <= n && (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    for (int j = lane * 4; j < L; j += 128)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst + swz(j))),
                   "l"(src + j));
  } else {
    for (int j = lane; j < L; j += 32) {
      if (base + j < n)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         (unsigned)__cvta_generic_to_shared(dst + swz(j))),
                     "l"(src + j));
      else
        dst[swz(j)] = fill;
    }
  }
}

__device__ __forceinline__ void store_plane(float* dst, const float* src,
                                            long long base, long long n,
                                            int L, int lane) {
  if (base + L <= n && (reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
    for (int j = lane * 4; j < L; j += 128)
      *reinterpret_cast<float4*>(dst + j) =
          *reinterpret_cast<const float4*>(src + swz(j));
  } else {
    for (int j = lane; j < L; j += 32)
      if (base + j < n) dst[j] = src[swz(j)];
  }
}

// KC: the k the registers hold; kExact: k == KC (every size known to the
// compiler), else any k <= KC, the loops guarded. A thread of the
// sub-runs' pass carries V vectors, so each A entry read from shared
// memory serves V products: what bounds the kernel at k >= 8 is its loads
// from shared memory, one a warp a cycle. KC = 0 (k > kKxKRegK): the same
// steps with no vector in registers. The block reads the planes from
// device memory where it needs them, writes y there, and keeps its maps
// and states in `work` (its share of the scratch); steps 2 and 5 advance
// every sub-run's (k + g) x k map or k x g state one step a round, one
// output a thread, in the register path's rounded operations.
template <int KC, bool kExact>
__global__ void __launch_bounds__(kThreads,
                                  KC <= 5 ? 4 : (KC <= 16 ? 2 : 1))
scan_kxk_chunked(const float* __restrict__ A, long long a_row,
                 const float* __restrict__ b, float* __restrict__ y,
                 const float* __restrict__ y0, Word* scratch,
                 float* work, int k_arg, int rows, int gmax, long long n,
                 long long ntiles, int ngroups) {
  constexpr bool kWide = KC == 0;
  constexpr int V = KC <= 8 ? 4 : (KC <= 12 ? 3 : 2);
  constexpr int KR = kWide ? 1 : KC;   // register arrays' size
  constexpr KxKTiling kTl = kxk_tiling(kWide ? 3 : KC);
  const int k = kExact ? KC : k_arg;
  const KxKTiling tl = kExact ? kTl : kxk_tiling(k_arg);
  const int L = tl.L, S = tl.S, R = tl.R;
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned ticket_sm;
  __shared__ long long from_sm[2];   // the carry's starts: tile, window
  if (threadIdx.x == 0)
    ticket_sm = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  // tile-major tickets: the groups of one tile run together, so a shared A
  // comes from device memory once and from L2 for the other groups
  const long long tile = ticket_sm / (unsigned)ngroups;
  const int grp = (int)(ticket_sm - (unsigned)tile * (unsigned)ngroups);
  const bool shared_a = a_row == 0;
  const int row0 = shared_a ? grp * kKxKGroup : grp;
  const int g = shared_a ? min(kKxKGroup, rows - row0) : 1;
  const float* ag = A + (shared_a ? 0 : (long long)row0 * a_row);
  const long long base = tile * L;
  const int kk = k * k, map = kk + k * g, kg = k * g;
  const long long tw = kxk_record_words(k, gmax);   // a tile's or window's
  const long long ww = tw;
  const long long map_off = kk + (long long)k * gmax;  // its state's words
  Word* tiles = scratch + 1 + grp * kxk_group_words(k, gmax, ntiles);
  Word* wins = tiles + ntiles * tw;
  const int batch = kxk_batch(k, g);
  float* As = sm;                          // [k*k][L]
  float* bs = As + (long long)kk * L;      // [g][k][L]: b, then y
  float* Ms = kWide ? work + ticket_sm * kxk_work_floats(k, gmax)
                    : bs + (long long)kg * L;   // S maps: the sub-runs'
  float* Ps = Ms + (S > 2 ? S : 2) * map;  // S maps: prefixes P_1 .. P_S
  float* lb = Ps + S * map;                // totals read in the carry
  float* x = lb + batch * map;             // the state [k][g], twice
  float* x2 = x + kg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the planes in device memory (KC = 0): A's entry (i, m), b's and y's
  // component i of the group's row r, at step t of the tile
  auto a_at = [&](int i, int m, long long t) {
    return ag[(long long)(i * k + m) * n + base + t];
  };
  auto b_off = [&](int r, int i, long long t) {
    return ((long long)(row0 + r) * k + i) * n + base + t;
  };

  // 1. the tile's planes into shared memory, one warp a plane
  for (int p = warp; p < (kWide ? 0 : kk + kg); p += kWarps) {
    const float* src =
        p < kk ? ag + (long long)p * n
               : b + ((long long)(row0 + (p - kk) / k) * k + (p - kk) % k) * n;
    const float fill = (p < kk && p / k == p % k) ? 1.f : 0.f;
    stage_plane(sm + (long long)p * L, src + base, base, n, L, fill, lane);
  }
  asm volatile("cp.async.commit_group;");
  copies_done();

  // 2. each sub-run's map: k threads' worth of vectors carry the columns of
  // its A-product from e_c, one more a row carries its b-part from 0, each
  // step v <- A[t] v (+ b[t]) in time order
  if constexpr (kWide) {
    // in turns between the prefixes' room and Ms, ending in Ms
    float* cur = (R & 1) ? Ps : Ms;
    float* nxt = (R & 1) ? Ms : Ps;
    for (int o = threadIdx.x; o < S * map; o += kThreads) {
      const int q = o % map;
      cur[o] = (q < kk && q / k == q % k) ? 1.f : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < R; ++t) {
      for (int o = threadIdx.x; o < S * map; o += kThreads) {
        const int s = o / map, q = o - s * map;
        const long long at = (long long)s * R + t;
        const float* m0 = cur + s * map;
        float v = cur[o];
        if (base + at < n) {
          // column c of Phi (q < kk) or of beta: A[t] times it (+ b[t])
          const bool phi = q < kk;
          const int i = phi ? q / k : (q - kk) / g;
          const int c = phi ? q - i * k : q - kk - i * g;
          const float* col = phi ? m0 + c : m0 + kk + c;
          const int step = phi ? k : g;
          float acc = __fmul_rn(a_at(i, 0, at), col[0]);
          for (int m = 1; m < k; ++m)
            acc = __fmaf_rn(a_at(i, m, at), col[m * step], acc);
          v = phi ? acc : __fadd_rn(acc, b[b_off(c, i, at)]);
        }
        nxt[o] = v;
      }
      __syncthreads();
      float* swap = cur;
      cur = nxt;
      nxt = swap;
    }
  }
  const int per_sub = (k + g + V - 1) / V;
  for (int task = threadIdx.x; task < (kWide ? 0 : S * per_sub);
       task += kThreads) {
    const int s = task / per_sub, c0 = (task - s * per_sub) * V;
    float v[V][KR];
    const float* bsrc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = c0 + u;
      bsrc[u] = (c >= k && c < k + g) ? bs + (long long)(c - k) * k * L
                                      : nullptr;
#pragma unroll
      for (int i = 0; i < KC; ++i) v[u][i] = (i == c) ? 1.f : 0.f;
    }
    const int t0 = s * R;
    for (int t = t0; t < t0 + R; ++t) {
      const int at = swz(t);
      float nv[V][KR];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (kExact || i < k) {
          const float* ai = As + (long long)i * k * L + at;
          float a = ai[0];
#pragma unroll
          for (int u = 0; u < V; ++u) nv[u][i] = __fmul_rn(a, v[u][0]);
#pragma unroll
          for (int m = 1; m < KC; ++m) {
            if (kExact || m < k) {
              a = ai[(long long)m * L];
#pragma unroll
              for (int u = 0; u < V; ++u)
                nv[u][i] = __fmaf_rn(a, v[u][m], nv[u][i]);
            }
          }
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (bsrc[u])
              nv[u][i] = __fadd_rn(nv[u][i], bsrc[u][i * L + at]);
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u)
#pragma unroll
        for (int i = 0; i < KC; ++i) v[u][i] = nv[u][i];
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = c0 + u;
      if (c >= k + g) continue;
      float* out = Ms + s * map + (c < k ? c : kk + (c - k));
      const int stride = c < k ? k : g;
#pragma unroll
      for (int i = 0; i < KC; ++i)
        if (kExact || i < k) out[i * stride] = v[u][i];
    }
  }
  __syncthreads();

  // 3. the prefixes P_1 = M_0, P_{s+1} = M_s after P_s, in order; P_S is
  // the tile's total, published at once
  for (int o = threadIdx.x; o < map; o += kThreads) Ps[o] = Ms[o];
  __syncthreads();
  for (int s = 1; s < S; ++s) {
    for (int o = threadIdx.x; o < map; o += kThreads)
      Ps[s * map + o] = compose_one(Ms + s * map, Ps + (s - 1) * map, o, k, g);
    __syncthreads();
  }
  const float* total = Ps + (S - 1) * map;
  for (int o = threadIdx.x; o < map; o += kThreads)
    publish(tiles + tile * tw + o, total[o]);

  // 4. the carry. Windows of kKxKWindow tiles: the last tile of a whole
  // window folds its tiles' totals in order into the window's total
  // (before it waits on anything); the state at a window's start is the
  // window totals before it applied to y0 in order, and a tile's start
  // state the totals of the tiles before it in its window applied to
  // that. Every application and composition runs the same rounded
  // operations (apply_one, compose_one) whichever block computes it, so
  // the states are the same bits on every call.
  const long long win = tile / kKxKWindow;
  const int r = (int)(tile - win * kKxKWindow);
  const long long first = win * kKxKWindow;
  if (r == kKxKWindow - 1) {
    float* acc = Ms;                       // the sub-runs' maps are spent
    float* nxt = Ms + map;
    for (long long t0 = first; t0 < tile; t0 += batch) {
      const int cnt = (int)(tile - t0 < batch ? tile - t0 : batch);
      load_maps(tiles, tw, t0, cnt, map, lb);
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        for (int o = threadIdx.x; o < map; o += kThreads)
          nxt[o] = t0 + j == first ? lb[j * map + o]
                                   : compose_one(lb + j * map, acc, o, k, g);
        __syncthreads();
        float* swap = acc;
        acc = nxt;
        nxt = swap;
      }
    }
    for (int o = threadIdx.x; o < map; o += kThreads)
      publish(wins + win * ww + o, compose_one(total, acc, o, k, g));
  }
  // totals [t0, t1) of `recs` (stride `stride` words) applied to x in
  // order; where the state fits a warp (k * g <= 32) warp 0 alone applies
  // them, with warp barriers
  auto apply_run = [&](const Word* recs, long long stride, long long t0,
                       long long t1) {
    for (; t0 < t1; t0 += batch) {
      const int cnt = (int)(t1 - t0 < batch ? t1 - t0 : batch);
      __syncthreads();    // lb and x are free
      load_maps(recs, stride, t0, cnt, map, lb);
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        if (kg <= 32) {
          if (warp == 0) {
            if (lane < kg) x2[lane] = apply_one(lb + j * map, x, lane, k, g);
            __syncwarp();
          }
        } else {
          if ((int)threadIdx.x < kg)
            x2[threadIdx.x] = apply_one(lb + j * map, x, threadIdx.x, k, g);
          __syncthreads();
        }
        float* swap = x;
        x = x2;
        x2 = swap;
      }
    }
    __syncthreads();
  };
  // A tile starts from the state at its window's start with the totals
  // of the tiles before it in the window applied in order. Warp 0 finds the
  // nearest earlier tile of the window whose end state is published (that
  // same fold), else takes the window's start, waiting where a tile between
  // has published nothing yet. Both words a lane tests are loaded at once.
  if (warp == 0) {
    for (;;) {
      int st = 2;     // at or past the window's start (r < 32)
      if (lane < r) {
        const volatile Word* d =
            reinterpret_cast<const volatile Word*>(tiles + (tile - 1 - lane)
                                                   * tw);
        const Word state = d[map_off], total = d[0];
        st = (state >> 32) ? 2 : ((total >> 32) ? 1 : 0);
      }
      const unsigned has = __ballot_sync(0xffffffffu, st == 2);
      const unsigned none = __ballot_sync(0xffffffffu, st == 0);
      const int f = __ffs(has) - 1;
      if ((none & ((1u << f) - 1u)) == 0) {
        if (lane == 0) from_sm[0] = tile - 1 - f;
        break;
      }
    }
  }
  __syncthreads();
  const long long from_tile = from_sm[0];
  if (from_tile < first) {
    // the state after window bw - 1: warp 0 finds the nearest earlier
    // window whose end state is published (window -1: y0), waiting where a
    // window between has published nothing yet
    const long long bw = (from_tile + 1) / kKxKWindow;
    if (warp == 0) {
      long long j = bw - 1;
      for (;;) {
        const long long w = j - lane;
        int st = 2;
        if (w >= 0) {
          const volatile Word* d =
              reinterpret_cast<const volatile Word*>(wins + w * ww);
          const Word state = d[map_off], total = d[0];
          st = (state >> 32) ? 2 : ((total >> 32) ? 1 : 0);
        }
        const unsigned has = __ballot_sync(0xffffffffu, st == 2);
        const unsigned none = __ballot_sync(0xffffffffu, st == 0);
        if (has) {
          const int f = __ffs(has) - 1;
          if ((none & ((1u << f) - 1u)) == 0) {
            j -= f;
            break;
          }
        } else if (!none) {
          j -= 32;
        }
      }
      if (lane == 0) from_sm[1] = j;
    }
    __syncthreads();
    const long long from = from_sm[1];
    if ((int)threadIdx.x < kg) {
      const int i = threadIdx.x / g, rr = threadIdx.x - (threadIdx.x / g) * g;
      float v;
      if (from < 0)
        v = y0[(long long)(row0 + rr) * k + i];
      else
        poll<1>(wins + from * ww + map_off + threadIdx.x, &v);
      x[threadIdx.x] = v;
    }
    __syncthreads();
    apply_run(wins, ww, from + 1, bw);
    if (from + 1 < bw && (int)threadIdx.x < kg)
      publish(wins + (bw - 1) * ww + map_off + threadIdx.x, x[threadIdx.x]);
  } else {
    if ((int)threadIdx.x < kg)
      poll<1>(tiles + from_tile * tw + map_off + threadIdx.x,
              x + threadIdx.x);
    __syncthreads();
  }
  apply_run(tiles, tw, from_tile + 1, tile);
  if ((int)threadIdx.x < kg)
    publish(tiles + tile * tw + map_off + threadIdx.x,
            apply_one(total, x, threadIdx.x, k, g));

  // 5. one thread a (sub-run, row): its start state through the prefix
  // before it, then its R steps in time order, y over b
  if constexpr (kWide) {
    // one thread an output (sub-run, component, row), the states in turns
    // in Ms (spent): S*k*g floats each
    float* cur = Ms;
    float* nxt = Ms + S * kg;
    for (int o = threadIdx.x; o < S * kg; o += kThreads) {
      const int s = o / kg, q = o - s * kg;
      cur[o] = s == 0 ? x[q] : apply_one(Ps + (s - 1) * map, x, q, k, g);
    }
    __syncthreads();
    for (int t = 0; t < R; ++t) {
      for (int o = threadIdx.x; o < S * kg; o += kThreads) {
        const int s = o / kg, q = o - s * kg, i = q / g, r = q - i * g;
        const long long at = (long long)s * R + t;
        const float* st = cur + s * kg + r;
        float v = cur[o];
        if (base + at < n) {
          float acc = __fmul_rn(a_at(i, 0, at), st[0]);
          for (int m = 1; m < k; ++m)
            acc = __fmaf_rn(a_at(i, m, at), st[m * g], acc);
          v = __fadd_rn(acc, b[b_off(r, i, at)]);
          y[b_off(r, i, at)] = v;
        }
        nxt[o] = v;
      }
      __syncthreads();
      float* swap = cur;
      cur = nxt;
      nxt = swap;
    }
  }
  for (int task = threadIdx.x; task < (kWide ? 0 : S * g); task += kThreads) {
    const int s = task / g, r = task - (task / g) * g;
    float st[KR];
#pragma unroll
    for (int i = 0; i < KC; ++i)
      if (kExact || i < k)
        st[i] = s == 0 ? x[i * g + r]
                       : apply_one(Ps + (s - 1) * map, x, i * g + r, k, g);
    float* br = bs + (long long)r * k * L;
    for (int t = s * R; t < s * R + R; ++t) {
      const int at = swz(t);
      float nv[KR];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (kExact || i < k) {
          const float* ai = As + (long long)i * k * L + at;
          float acc = __fmul_rn(ai[0], st[0]);
#pragma unroll
          for (int m = 1; m < KC; ++m)
            if (kExact || m < k)
              acc = __fmaf_rn(ai[(long long)m * L], st[m], acc);
          nv[i] = __fadd_rn(acc, br[i * L + at]);
        }
      }
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (kExact || i < k) {
          st[i] = nv[i];
          br[i * L + at] = nv[i];
        }
      }
    }
  }
  __syncthreads();

  // 6. the states out, one warp a plane
  for (int p = warp; p < (kWide ? 0 : kg); p += kWarps) {
    const int r = p / k, q = p - (p / k) * k;
    store_plane(y + ((long long)(row0 + r) * k + q) * n + base,
                bs + (long long)p * L, base, n, L, lane);
  }
}

template <int KC, bool kExact>
int launch_kxk_chunked(const float* A, long long a_row, const float* b,
                       float* y, const float* y0, Word* scratch, int k,
                       int rows, long long n, cudaStream_t s) {
  const KxKLaunch shape = kxk_launch_shape(k, rows, n, a_row == 0);
  const long long blocks = shape.ntiles * shape.ngroups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long words = kxk_scratch_words(k, rows, n, a_row == 0);
  const cudaError_t zeroed =
      cudaMemsetAsync(scratch, 0, sizeof(Word) * words, s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  const int bytes =
      KC == 0 ? 0 : (int)(sizeof(float) * kxk_smem_floats(k, shape.gmax));
  const cudaError_t allowed = cudaFuncSetAttribute(
      scan_kxk_chunked<KC, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (allowed != cudaSuccess) return (int)allowed;
  scan_kxk_chunked<KC, kExact><<<(unsigned)blocks, kThreads, bytes, s>>>(
      A, a_row, b, y, y0, scratch, reinterpret_cast<float*>(scratch + words),
      k, rows, shape.gmax, n, shape.ntiles, shape.ngroups);
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

// The k x k map: steps per tile (elements of the one pass for k = 1 and
// 2), steps per sub-run (0 below 3), tiles per window of the carry, and
// the bytes of scratch a call needs.
int flan_scan_kxk_tile(int k) {
  if (k == 1) return Tile<Linear>::kLen;
  if (k == 2) return Tile<AffineKxK<2>>::kLen;
  return k >= 3 ? kxk_tiling(k).L : 0;
}

int flan_scan_kxk_subrun(int k) { return k >= 3 ? kxk_tiling(k).R : 0; }

int flan_scan_kxk_window_tiles() { return kKxKWindow; }

long long flan_scan_kxk_scratch_bytes(int k, int rows, long long n,
                                      int shared) {
  if (k == 1) return 8 * scratch_words<Linear>(rows, tiles_of<Linear>(n));
  if (k == 2)
    return 8 * scratch_words<AffineKxK<2>>(rows, tiles_of<AffineKxK<2>>(n));
  if (k < 3 || rows < 1 || n < 1) return 0;
  return 8 * (kxk_scratch_words(k, rows, n, shared != 0) +
              kxk_work_words(k, rows, n, shared != 0));
}

// y[n] = A[n] y[n-1] + b[n] for k x k maps, k >= 1: A [rows or 1, k*k, n]
// row-major maps with row stride a_row (0: one A for every row), b and y
// [rows, k, n], y0 [rows, k]; scratch: flan_scan_kxk_scratch_bytes(k,
// rows, n, a_row == 0) bytes, 8-byte aligned. All float32, contiguous, on
// the stream's device. The chunked kernel's instantiation goes by k: k
// itself to 16 (on an H100 the guarded one took 3 to 10 times as long at
// every k measured), a guarded one to kKxKRegK, and above that the one
// whose maps are in the scratch.
int flan_scan_kxk(int k, const float* A, long long a_row, const float* b,
                  float* y, const float* y0, void* scratch, int rows,
                  long long n, void* stream) {
  if (k < 1 || rows < 1 || n < 1 ||
      reinterpret_cast<unsigned long long>(scratch) % sizeof(Word) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Word* w = reinterpret_cast<Word*>(scratch);
  switch (k) {
    case 1: return launch_kxk<1>(A, a_row, b, y, y0, w, rows, n, s);
    case 2: return launch_kxk<2>(A, a_row, b, y, y0, w, rows, n, s);
#define FLAN_KXK_LAUNCH(K)                                                \
    case K:                                                               \
      return launch_kxk_chunked<K, true>(A, a_row, b, y, y0, w, k, rows,  \
                                         n, s);
    FLAN_KXK_LAUNCH(3) FLAN_KXK_LAUNCH(4) FLAN_KXK_LAUNCH(5)
    FLAN_KXK_LAUNCH(6) FLAN_KXK_LAUNCH(7) FLAN_KXK_LAUNCH(8)
    FLAN_KXK_LAUNCH(9) FLAN_KXK_LAUNCH(10) FLAN_KXK_LAUNCH(11)
    FLAN_KXK_LAUNCH(12) FLAN_KXK_LAUNCH(13) FLAN_KXK_LAUNCH(14)
    FLAN_KXK_LAUNCH(15) FLAN_KXK_LAUNCH(16)
#undef FLAN_KXK_LAUNCH
    default:
      if (k <= kKxKRegK)
        return launch_kxk_chunked<kKxKRegK, false>(A, a_row, b, y, y0, w, k,
                                                   rows, n, s);
      return launch_kxk_chunked<0, false>(A, a_row, b, y, y0, w, k, rows, n,
                                          s);
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
