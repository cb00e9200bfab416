// Sliding-DFT phase vocoder (SPV) forward and inverse kernels for Hopper.
//
// Replaces the TPU kernels of flan_tpu/ops/spv_pallas.py:
//   B1  spv_forward_fused -> _fwd_kernel  (sliding-DFT forward + polar + PV)
//   B2  spv_inverse_fused -> _inv_kernel  (mod-1 phase accumulation + sum)
// and computes what flan_tpu/spv/spv.py _spv_forward_scan and
// _spv_inverse_scan compute (reference: AudioSPV.cpp:13-145,
// phase_vocoder.cpp:37). The plain PyTorch versions are
// flan_tpu_torch/ops/spv_kernels.py spv_forward_ref / spv_inverse_ref.
//
// Bound: both kernels are memory-bound. The forward reads x (C*N floats)
// and writes mag and freq (2*C*N*B floats); the inverse reads mag and freq
// (2*C*N*B floats) and writes C*N. At 3.35 TB/s the floor is those output
// (forward) or input (inverse) bytes; for 30 s mono at 48 kHz and B=512
// that is 5.9 GB, about 1.8 ms, each way. The inverse reads freq a second
// time for the tile totals (8.85 GB moved); the forward's first pass reads
// only x and the twiddle table, which stays in L2. What kept the first
// version at a quarter of the bound was not memory but instructions per
// frame-bin and L2 latency: IEEE divisions, fmodf, four scalar table loads
// with 64-bit index arithmetic, and a barrier per frame.
//
// Design. The TPU runs its grid in order and carries the running sums in
// VMEM from one 128-frame tile to the next. Hopper runs blocks in
// parallel, so the sequential frame axis is split into tiles of kTile
// frames and each kernel runs in three steps:
//   1. tile totals: one block per (tile, channel) sums the tile's
//      contributions. The forward sums a tile's rows in order, as its
//      epilogue and the plain version's 128-frame blocks do (splitting the
//      rows among threads left its magnitudes as close to float64 but 2.4
//      times further from the plain version's, whose rounding it then no
//      longer shared); the inverse's sums are integers, so where the bins
//      need fewer than 256 threads its spare threads take the rows in
//      turns and the partial sums meet in shared memory;
//   2. the exclusive prefix of the tile totals along tiles, per (channel,
//      bin), in place (common.cuh: chunks of 256 tiles, two launches);
//   3. the epilogue: one block per (tile, channel) re-runs the tile's
//      running sum from its carried offset and emits every frame.
// A thread owns 4 adjacent bins wherever B is a multiple of 4 and the
// planes are 16-byte aligned, and then loads and stores 16 bytes at a time;
// otherwise it owns single bins (up to 8, strided by the block) and the
// same code runs with scalar accesses.
//
// Forward epilogue. The +-1-bin hann stencil takes its neighbours from the
// thread's own registers, from the next lane by warp shuffle, and at a
// warp's two ends from one halo bin on each side that the warp carries
// itself (lanes 0-15 the left one, lanes 16-31 the right one): the frame
// loop has no barrier and no frame buffer in shared memory, and warps run
// independently. The twiddles of row t+1, loaded to rotate frame t, are
// kept in registers as row t+1's for the next frame's accumulation, so each
// frame-bin costs two table loads, not four. The previous frame's phase at
// the tile's first frame is recomputed from the carry at t0-1, so no phase
// is carried between blocks (frame 0's previous phase comes out 0, as in
// the JAX package). Roundings that feed no accumulator are the cheap ones:
// the stencil's scale 0.25 / 2B is one hoisted factor (exact when 2B is a
// power of two, else within one ulp of the plain version's division), the
// phase wrap multiplies by 1 / 2pi, atan2 takes its quotient through the
// fast reciprocal, and the magnitude is sqrt.approx (2^-23 relative).
//
// Inverse. Cycles are 32-bit fixed point: a frame-bin's increment is
// frac(freq / sr) * 2^32 with a true division (it feeds an accumulator),
// sums wrap by themselves and associate exactly, so totals, prefix and
// epilogue agree bit for bit whatever the tiling, at 2.3e-10 cycles a step
// where float32 cycles near 0.5 hold 3e-8. The cosine is cospif of the
// phase as a signed fraction of a half turn (the conversion rounds the
// 32-bit phase to 24 bits: 9.4e-8 rad, the plain version's own float32
// phase holds 1.9e-7). The signed bins of a frame are summed per thread,
// then across each warp four frames at a time by a transposing butterfly
// (6 shuffles for 4 frames, not 20), then across warps once per tile.
//
// The twiddle table [2B, B] is built on the host by the same integer-exact
// numpy code as the JAX package (angle index (j*b) mod 2B), so the kernel
// and the plain version read identical twiddles; at B=1024 it is 16 MB and
// stays in the 50 MB L2. The planes are written and read with streaming
// hints so that they do not push it out.
//
// Summation order: the forward sums each tile in float32 and chains tiles
// through the prefix, which associates differently from the plain version
// (128-frame cumsum blocks inside 1024-frame chunks), so the two drift
// apart with length as any two float32 orders do (ROADMAP C.2).
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <stdint.h>

#include "common.cuh"

namespace {

// VEC adjacent floats at p: one 16-byte access for VEC == 4. The streaming
// forms are for the planes, read or written once; the plain load is for
// the twiddle table and the carries.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec_streaming(const float* p,
                                                   float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec_streaming(float* p,
                                                    const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------- forward

// delta[i] = x[t0+i] - x[t0+i-2B] (zero before the signal and past its end)
__device__ __forceinline__ void load_comb_deltas(
    const float* __restrict__ xc, long long t0, long long n, int two_b,
    float* delta) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const long long t = t0 + i;
    float d = 0.f;
    if (t < n) {
      d = xc[t];
      if (t >= two_b) d -= xc[t - two_b];
    }
    delta[i] = d;
  }
}

// One thread per group of VEC adjacent bins (strided by the block where
// there are more groups than threads) sums the tile's rows in order: the
// order of the epilogue's own running sum and of the plain version's
// 128-frame blocks, so the three round alike.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
fwd_tile_totals(const float* __restrict__ x, const float* __restrict__ tw_re,
                const float* __restrict__ tw_im, float* __restrict__ tot_re,
                float* __restrict__ tot_im, long long n, int nbins,
                int ntiles) {
  __shared__ float delta[kTile];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int two_b = 2 * nbins;
  const long long t0 = (long long)tile * kTile;
  load_comb_deltas(x + (long long)c * n, t0, n, two_b, delta);
  __syncthreads();
  const int rows = (int)min((long long)kTile, n - t0);
  const int groups = nbins / VEC;
  const int table = two_b * nbins;
  const long long out = ((long long)c * ntiles + tile) * nbins;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int b = g * VEC;
    float sre[VEC], sim[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sre[j] = sim[j] = 0.f;
    int row = (int)(t0 % two_b) * nbins;   // offset of row t mod 2B
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float d = delta[i];
      float wr[VEC], wi[VEC];
      load_vec<VEC>(tw_re + row + b, wr);
      load_vec<VEC>(tw_im + row + b, wi);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sre[j] += d * wr[j];
        sim[j] += d * wi[j];
      }
      row += nbins;
      if (row == table) row = 0;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      tot_re[out + b + j] = sre[j];
      tot_im[out + b + j] = sim[j];
    }
  }
}

// Thread t owns the bin groups t, t + blockDim, ... (K of them), each VEC
// adjacent bins. A thread past the last group repeats the last group's work
// and stores nothing, so every lane takes part in the shuffles.
template <int VEC, int K>
__global__ void __launch_bounds__(kMaxThreads)
fwd_epilogue(const float* __restrict__ x, const float* __restrict__ tw_re,
             const float* __restrict__ tw_im,
             const float* __restrict__ carry_re,
             const float* __restrict__ carry_im, float* __restrict__ mag,
             float* __restrict__ freq, long long n, int nbins, int ntiles,
             float bin_hz, float sample_rate, float hz_per_radian) {
  __shared__ float delta[kTile];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int two_b = 2 * nbins;
  const int groups = nbins / VEC;
  // the stencil's 0.25 / 2B as one factor
  const float scale = 0.25f / (float)two_b;
  const long long t0 = (long long)tile * kTile;
  load_comb_deltas(x + (long long)c * n, t0, n, two_b, delta);

  const long long carry = ((long long)c * ntiles + tile) * nbins;
  int b0[K], hb[K];
  bool on[K];
  float cre[K][VEC], cim[K][VEC], lre[K][VEC], lim[K][VEC], prev[K][VEC];
  float binf[K][VEC], expected[K][VEC], wcr[K][VEC], wci[K][VEC];
  // the warp's halo bin: its left neighbour in lanes 0-15, its right one
  // in lanes 16-31 (clamped into the bins; an edge bin never reads it)
  float hcre[K], hcim[K], hlre[K], hlim[K], hwr[K], hwi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int g = threadIdx.x + k * blockDim.x;
    on[k] = g < groups;
    b0[k] = min(g, groups - 1) * VEC;
    const int warp_b0 = (g - lane) * VEC;
    hb[k] = min(max(lane < 16 ? warp_b0 - 1 : warp_b0 + 32 * VEC, 0),
                nbins - 1);
    hcre[k] = carry_re[carry + hb[k]];
    hcim[k] = carry_im[carry + hb[k]];
    hlre[k] = hlim[k] = hwr[k] = hwi[k] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int b = b0[k] + j;
      cre[k][j] = carry_re[carry + b];
      cim[k][j] = carry_im[carry + b];
      lre[k][j] = lim[k][j] = prev[k][j] = 0.f;
      wcr[k][j] = wci[k][j] = 0.f;
      binf[k][j] = (float)b * bin_hz;
      // expected per-sample phase advance of bin b (phase_vocoder.cpp:47)
      expected[k][j] = binf[k][j] / sample_rate * kTwoPi;
    }
  }
  __syncthreads();

  const int rows = (int)min((long long)kTile, n - t0);
  float* out_mag = mag + ((long long)c * n + t0) * nbins;
  float* out_freq = freq + ((long long)c * n + t0) * nbins;
  int row_next = (int)(t0 % two_b) * nbins;   // offset of row (t + 1) mod 2B
  const int table = two_b * nbins;
  // i == -1 recomputes frame t0-1 from the carry alone, for its phase.
  for (int i = -1; i < rows; ++i) {
    const float d = i >= 0 ? delta[i] : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // this row's twiddles are those loaded as the last frame's next row
      float fre[VEC], fim[VEC], wnr[VEC], wni[VEC];
      load_vec<VEC>(tw_re + row_next + b0[k], wnr);
      load_vec<VEC>(tw_im + row_next + b0[k], wni);
      const float hnr = tw_re[row_next + hb[k]];
      const float hni = tw_im[row_next + hb[k]];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        lre[k][j] += d * wcr[k][j];
        lim[k][j] += d * wci[k][j];
        const float sre = lre[k][j] + cre[k][j];
        const float sim = lim[k][j] + cim[k][j];
        // rotate to the frame's reference phase: * conj(twiddle[t+1])
        fre[j] = sre * wnr[j] + sim * wni[j];
        fim[j] = sim * wnr[j] - sre * wni[j];
        wcr[k][j] = wnr[j];
        wci[k][j] = wni[j];
      }
      hlre[k] += d * hwr[k];
      hlim[k] += d * hwi[k];
      const float hsre = hlre[k] + hcre[k], hsim = hlim[k] + hcim[k];
      const float hre = hsre * hnr + hsim * hni;
      const float him = hsim * hnr - hsre * hni;
      hwr[k] = hnr;
      hwi[k] = hni;
      // bins b0-1 and b0+VEC: the neighbour lanes', or the warp's halo
      const float up_re = __shfl_up_sync(0xffffffffu, fre[VEC - 1], 1);
      const float up_im = __shfl_up_sync(0xffffffffu, fim[VEC - 1], 1);
      const float dn_re = __shfl_down_sync(0xffffffffu, fre[0], 1);
      const float dn_im = __shfl_down_sync(0xffffffffu, fim[0], 1);
      const float below_re = lane == 0 ? hre : up_re;
      const float below_im = lane == 0 ? him : up_im;
      const float above_re = lane == 31 ? hre : dn_re;
      const float above_im = lane == 31 ? him : dn_im;
      float m[VEC], f[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        // 3-tap hann spectral convolution (AudioSPV.cpp:65-92): at bin 0
        // both neighbour taps collapse to 2*Re(f[1]) and at bin B-1 to
        // 2*Re(f[B-2]); the imaginary edge taps are zero. Bin 0 is a
        // group's first bin and bin B-1 a group's last.
        const float lo_re = j > 0 ? fre[j > 0 ? j - 1 : 0] : below_re;
        const float lo_im = j > 0 ? fim[j > 0 ? j - 1 : 0] : below_im;
        const float hi_re = j < VEC - 1 ? fre[j < VEC - 1 ? j + 1 : 0] : above_re;
        const float hi_im = j < VEC - 1 ? fim[j < VEC - 1 ? j + 1 : 0] : above_im;
        const bool first = j == 0 && b0[k] == 0;
        const bool last = j == VEC - 1 && b0[k] + j == nbins - 1;
        const float left_re = first ? 2.f * hi_re : (last ? 0.f : lo_re);
        const float right_re = last ? 2.f * lo_re : (first ? 0.f : hi_re);
        const float left_im = (first || last) ? 0.f : lo_im;
        const float right_im = (first || last) ? 0.f : hi_im;
        const float conv_re = scale * (2.f * fre[j] - left_re - right_re);
        const float conv_im = scale * (2.f * fim[j] - left_im - right_im);
        const float energy = conv_re * conv_re + conv_im * conv_im;
        const bool dead = energy == 0.f;
        const float phase =
            atan2_poly_fast(dead ? 0.f : conv_im, dead ? 1.f : conv_re);
        // wrapped phase difference -> frequency; the wrap is deliberate
        // (flan_tpu/spv/spv.py:252-258), round-half-even as jnp.round
        float dp = phase - prev[k][j] - expected[k][j];
        dp = dp - kTwoPi * rintf(dp * kInvTwoPi);
        m[j] = sqrt_approx(energy);
        f[j] = binf[k][j] + dp * hz_per_radian;
        prev[k][j] = phase;
      }
      if (i >= 0 && on[k]) {
        store_vec_streaming<VEC>(out_mag + b0[k], m);
        store_vec_streaming<VEC>(out_freq + b0[k], f);
      }
    }
    if (i >= 0) {
      out_mag += nbins;
      out_freq += nbins;
    }
    row_next += nbins;
    if (row_next == table) row_next = 0;
  }
}

// ---------------------------------------------------------------- inverse

// frac(freq / sr) as 32-bit fixed point. q - rint(q) is exact in float32
// and lies in [-0.5, 0.5]; the conversion saturates +0.5 to 2^31 - 1, one
// unit (2.3e-10 cycles) short.
__device__ __forceinline__ unsigned cycle_increment(float freq, float sr) {
  const float q = freq / sr;
  return (unsigned)__float2int_rn((q - rintf(q)) * 4294967296.f);
}

// cos(2 pi cycles) of fixed-point cycles
__device__ __forceinline__ float cos_cycles(unsigned cycles) {
  return cospif((float)(int)cycles * 4.656612873077392578125e-10f);  // 2^-31
}

// Block of tpr * nrow threads: thread (r, l) sums rows r, r + nrow, ... of
// the tile for the bin groups l, l + tpr, ... (nrow > 1 only where one pass
// over the groups covers them all). The rows' partial sums meet by integer
// atomics in shared memory, exact in any order.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
inv_tile_totals(const float* __restrict__ freq, unsigned* __restrict__ tot,
                long long n, int nbins, int ntiles, float sample_rate,
                int tpr, int nrow) {
  extern __shared__ unsigned sums[];   // [nbins] where nrow > 1
  const int tile = blockIdx.x, c = blockIdx.y;
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, n - t0);
  const float* fr = freq + ((long long)c * n + t0) * nbins;
  const long long out = ((long long)c * ntiles + tile) * nbins;
  const int groups = nbins / VEC;
  const int r = threadIdx.x / tpr, l = threadIdx.x % tpr;
  if (nrow > 1) {
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) sums[b] = 0u;
    __syncthreads();
  }
  for (int g = l; g < groups; g += tpr) {
    const int b = g * VEC;
    unsigned s[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = 0u;
#pragma unroll 4
    for (int i = r; i < rows; i += nrow) {
      float v[VEC];
      load_vec<VEC>(fr + (long long)i * nbins + b, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] += cycle_increment(v[j], sample_rate);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (nrow == 1)
        tot[out + b + j] = s[j];
      else
        atomicAdd(&sums[b + j], s[j]);
    }
  }
  if (nrow > 1) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += blockDim.x)
      tot[out + b] = sums[b];
  }
}

// Bin groups per thread as in fwd_epilogue; four frames per turn.
template <int VEC, int K>
__global__ void __launch_bounds__(kMaxThreads)
inv_epilogue(const float* __restrict__ mag, const float* __restrict__ freq,
             const unsigned* __restrict__ carry, float* __restrict__ out,
             long long n, int nbins, int ntiles, float sample_rate) {
  __shared__ float partial[kMaxThreads / 32][kTile];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, n - t0);
  const long long base = ((long long)c * n + t0) * nbins;
  const long long cbase = ((long long)c * ntiles + tile) * nbins;
  const int groups = nbins / VEC;

  unsigned cycles[K][VEC];   // the carry, then the running cycles
  int b0[K];
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int g = threadIdx.x + k * blockDim.x;
    on[k] = g < groups;
    b0[k] = min(g, groups - 1) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) cycles[k][j] = carry[cbase + b0[k] + j];
  }
  const bool hi16 = lane & 16, hi8 = lane & 8;
  for (int i0 = 0; i0 < rows; i0 += 4) {
    float acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u] = 0.f;
      if (i0 + u < rows) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (on[k]) {
            const long long at = base + (long long)(i0 + u) * nbins + b0[k];
            float fv[VEC], mv[VEC];
            load_vec_streaming<VEC>(freq + at, fv);
            load_vec_streaming<VEC>(mag + at, mv);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              cycles[k][j] += cycle_increment(fv[j], sample_rate);
              const float real = mv[j] * cos_cycles(cycles[k][j]);
              // (-1)^b: a group of 4 starts at an even bin
              acc[u] += ((b0[k] + j) & 1) ? -real : real;
            }
          }
        }
      }
    }
    // the warp's sums of the four frames, transposed as they are reduced:
    // lanes 16-31 keep frames 2 and 3, then lanes with bit 3 set keep the
    // odd frame, and lane 8*f ends with frame f
    const float send0 = hi16 ? acc[0] : acc[2], send1 = hi16 ? acc[1] : acc[3];
    float keep0 = hi16 ? acc[2] : acc[0], keep1 = hi16 ? acc[3] : acc[1];
    keep0 += __shfl_xor_sync(0xffffffffu, send0, 16);
    keep1 += __shfl_xor_sync(0xffffffffu, send1, 16);
    float v = hi8 ? keep1 : keep0;
    v += __shfl_xor_sync(0xffffffffu, hi8 ? keep0 : keep1, 8);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((lane & 7) == 0) partial[warp][i0 + (lane >> 3)] = v;
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += partial[w][i];
    out[(long long)c * n + t0 + i] = 2.f * s;
  }
}

// ------------------------------------------------------------ block shapes

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Bin groups per thread K and threads per block of an epilogue whose
// threads own groups of vec bins: 4-bin groups take up to 2 per thread (B
// <= 2048), single bins up to kMaxBinsPerThread.
bool spv_epilogue_shape(int nbins, int vec, int* k, int* threads) {
  const int groups = nbins / vec;
  for (int kk = 1; kk <= (vec == 4 ? 2 : kMaxBinsPerThread); kk *= 2) {
    const int t = (groups + kk - 1) / kk;
    if (t <= kMaxThreads) {
      *k = kk;
      *threads = (t + 31) / 32 * 32;
      return true;
    }
  }
  return false;
}

// Threads per row of bin groups and rows in flight of a block of the
// inverse's tile totals.
void spv_totals_shape(int nbins, int vec, int* tpr, int* nrow) {
  const int groups = nbins / vec;
  *tpr = groups < kMaxThreads ? groups : kMaxThreads;
  *nrow = kMaxThreads / *tpr;
  if (*nrow > kTile) *nrow = kTile;
}

}  // namespace

extern "C" {

int flan_spv_tile_frames() { return kTile; }

int flan_spv_max_bins() { return kMaxThreads * kMaxBinsPerThread; }

// tiles per chunk of the prefix over tiles: a scratch plane holds one more
// row per channel for each chunk
int flan_scan_chunk_tiles() { return kScanChunk; }

// x [C, N]; tw_re, tw_im [2B, B]; tot_re, tot_im scratch of C * (ntiles +
// nchunks) * B floats, ntiles = ceil(N / kTile), nchunks = ceil(ntiles /
// kScanChunk): the tile totals [C, ntiles, B], then the prefix's chunk
// totals; mag, freq [C, N, B]. All float32, contiguous, on the stream's
// device.
int flan_spv_forward(const float* x, const float* tw_re, const float* tw_im,
                     float* tot_re, float* tot_im, float* mag, float* freq,
                     int channels, long long n, int nbins, double sample_rate,
                     void* stream) {
  const bool vec = nbins % 4 == 0 && aligned16(tw_re) && aligned16(tw_im) &&
                   aligned16(mag) && aligned16(freq);
  int k, threads;
  if (channels < 1 || n < 1 || nbins < 2 ||
      !spv_epilogue_shape(nbins, vec ? 4 : 1, &k, &threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(ntiles, channels);
  const int groups = nbins / (vec ? 4 : 1);
  const int tthreads = groups < kMaxThreads ? (groups + 31) / 32 * 32
                                            : kMaxThreads;
  if (vec)
    fwd_tile_totals<4><<<grid, tthreads, 0, s>>>(x, tw_re, tw_im, tot_re,
                                                 tot_im, n, nbins, ntiles);
  else
    fwd_tile_totals<1><<<grid, tthreads, 0, s>>>(x, tw_re, tw_im, tot_re,
                                                 tot_im, n, nbins, ntiles);
  launch_tile_prefix<SumF32>(tot_re, tot_im, 2, channels, ntiles, nbins, s);
  const float bin_hz = (float)(sample_rate / (2.0 * nbins));
  const float hz_per_radian = (float)(sample_rate / (2.0 * 3.14159265358979323846));
  const float sr = (float)sample_rate;
#define FLAN_FWD(VEC, K)                                                    \
  fwd_epilogue<VEC, K><<<grid, threads, 0, s>>>(x, tw_re, tw_im, tot_re,    \
                                                tot_im, mag, freq, n, nbins, \
                                                ntiles, bin_hz, sr,          \
                                                hz_per_radian)
  if (vec) {
    if (k == 1) FLAN_FWD(4, 1); else FLAN_FWD(4, 2);
  } else {
    switch (k) {
      case 1: FLAN_FWD(1, 1); break;
      case 2: FLAN_FWD(1, 2); break;
      case 4: FLAN_FWD(1, 4); break;
      default: FLAN_FWD(1, 8); break;
    }
  }
#undef FLAN_FWD
  return (int)cudaGetLastError();
}

// mag, freq [C, N, B] float32; tot scratch of C * (ntiles + nchunks) * B
// 32-bit integers, laid out as the forward's; out [C, N] float32.
int flan_spv_inverse(const float* mag, const float* freq, unsigned* tot,
                     float* out, int channels, long long n, int nbins,
                     double sample_rate, void* stream) {
  const bool vec = nbins % 4 == 0 && aligned16(mag) && aligned16(freq);
  int k, threads, tpr, nrow;
  if (channels < 1 || n < 1 || nbins < 1 ||
      !spv_epilogue_shape(nbins, vec ? 4 : 1, &k, &threads))
    return (int)cudaErrorInvalidValue;
  spv_totals_shape(nbins, vec ? 4 : 1, &tpr, &nrow);
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(ntiles, channels);
  const float sr = (float)sample_rate;
  const size_t smem = nrow > 1 ? nbins * sizeof(unsigned) : 0;
  if (vec)
    inv_tile_totals<4><<<grid, tpr * nrow, smem, s>>>(freq, tot, n, nbins,
                                                      ntiles, sr, tpr, nrow);
  else
    inv_tile_totals<1><<<grid, tpr * nrow, smem, s>>>(freq, tot, n, nbins,
                                                      ntiles, sr, tpr, nrow);
  launch_tile_prefix<SumU32>(tot, tot, 1, channels, ntiles, nbins, s);
#define FLAN_INV(VEC, K)                                                     \
  inv_epilogue<VEC, K><<<grid, threads, 0, s>>>(mag, freq, tot, out, n,      \
                                                nbins, ntiles, sr)
  if (vec) {
    if (k == 1) FLAN_INV(4, 1); else FLAN_INV(4, 2);
  } else {
    switch (k) {
      case 1: FLAN_INV(1, 1); break;
      case 2: FLAN_INV(1, 2); break;
      case 4: FLAN_INV(1, 4); break;
      default: FLAN_INV(1, 8); break;
    }
  }
#undef FLAN_INV
  return (int)cudaGetLastError();
}

}  // extern "C"
