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
// that is 5.9 GB, about 1.8 ms, each way. This first version re-reads x and
// freq once more for the tile totals.
//
// Design. The TPU runs its grid in order and carries the running sums in
// VMEM from one 128-frame tile to the next. Hopper runs blocks in
// parallel, so the sequential frame axis is split into tiles of kTile
// frames and each kernel runs in three launches:
//   1. tile totals: one block per (tile, channel), one thread per bin,
//      sums the tile's contributions;
//   2. an exclusive prefix of the tile totals along tiles, per (channel,
//      bin), in place: 32 segments per bin, two passes;
//   3. the epilogue: one block per (tile, channel) re-runs the tile's
//      running sum from its carried offset and emits every frame. The
//      forward keeps one frame of all B bins in shared memory for the
//      +-1-bin hann stencil, and recomputes the previous frame's phase at
//      the tile's first frame from the carry at t0-1, so no phase is
//      carried between blocks (frame 0's previous phase comes out 0, as
//      in the JAX package). The inverse reduces the signed bins of each
//      frame with warp shuffles and one shared-memory pass per tile.
// The twiddle table [2B, B] is built on the host by the same integer-exact
// numpy code as the JAX package (angle index (j*b) mod 2B), so the kernel
// and the plain version read identical twiddles; at B=1024 it is 16 MB and
// stays in the 50 MB L2.
//
// Summation order: the forward sums each tile sequentially in float32 and
// chains tiles through the prefix, which associates differently from the
// plain version (128-frame cumsum blocks inside 1024-frame chunks), so the
// two drift apart with length as any two float32 orders do (ROADMAP C.2).
// The inverse keeps its running cycles reduced mod 1 after every frame, so
// they never leave [0, 1) and keep ~1e-7 cycles of precision; a float32 sum
// over a whole tile would reach 128 cycles and keep only ~1e-5.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "common.cuh"

namespace {

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
  const int row0 = (int)(t0 % two_b);
  const long long out = ((long long)c * ntiles + tile) * nbins;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    float sre = 0.f, sim = 0.f;
    int row = row0;
    for (int i = 0; i < rows; ++i) {
      const float d = delta[i];
      sre += d * tw_re[(long long)row * nbins + b];
      sim += d * tw_im[(long long)row * nbins + b];
      if (++row == two_b) row = 0;
    }
    tot_re[out + b] = sre;
    tot_im[out + b] = sim;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
fwd_epilogue(const float* __restrict__ x, const float* __restrict__ tw_re,
             const float* __restrict__ tw_im,
             const float* __restrict__ carry_re,
             const float* __restrict__ carry_im, float* __restrict__ mag,
             float* __restrict__ freq, long long n, int nbins, int ntiles,
             float bin_hz, float sample_rate, float hz_per_radian) {
  extern __shared__ float smem[];
  float* delta = smem;                 // [kTile]
  float* frame = smem + kTile;         // [2 buffers][re, im][nbins]
  const int tile = blockIdx.x, c = blockIdx.y;
  const int two_b = 2 * nbins;
  const float two_b_f = (float)two_b;
  const long long t0 = (long long)tile * kTile;
  load_comb_deltas(x + (long long)c * n, t0, n, two_b, delta);

  const long long carry = ((long long)c * ntiles + tile) * nbins;
  float cre[K], cim[K], lre[K], lim[K], prev[K], binf[K], expected[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    const bool on = b < nbins;
    cre[k] = on ? carry_re[carry + b] : 0.f;
    cim[k] = on ? carry_im[carry + b] : 0.f;
    lre[k] = 0.f;
    lim[k] = 0.f;
    prev[k] = 0.f;
    binf[k] = (float)b * bin_hz;
    // expected per-sample phase advance of bin b (phase_vocoder.cpp:47)
    expected[k] = binf[k] / sample_rate * kTwoPi;
  }
  __syncthreads();

  const int rows = (int)min((long long)kTile, n - t0);
  float* out_mag = mag + ((long long)c * n + t0) * nbins;
  float* out_freq = freq + ((long long)c * n + t0) * nbins;
  int row_cur = 0;                       // (t0 + i) mod 2B
  int row_next = (int)(t0 % two_b);      // (t0 + i + 1) mod 2B
  // i == -1 recomputes frame t0-1 from the carry alone, for its phase.
  for (int i = -1; i < rows; ++i) {
    float* fre = frame + ((i + 1) & 1) * 2 * nbins;
    float* fim = fre + nbins;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = threadIdx.x + k * blockDim.x;
      if (b < nbins) {
        if (i >= 0) {
          const float d = delta[i];
          lre[k] += d * tw_re[(long long)row_cur * nbins + b];
          lim[k] += d * tw_im[(long long)row_cur * nbins + b];
        }
        const float sre = lre[k] + cre[k];
        const float sim = lim[k] + cim[k];
        // rotate to the frame's reference phase: * conj(twiddle[t+1])
        const float wr = tw_re[(long long)row_next * nbins + b];
        const float wi = tw_im[(long long)row_next * nbins + b];
        fre[b] = sre * wr + sim * wi;
        fim[b] = sim * wr - sre * wi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = threadIdx.x + k * blockDim.x;
      if (b < nbins) {
        // 3-tap hann spectral convolution (AudioSPV.cpp:65-92): at bin 0
        // both neighbour taps collapse to 2*Re(f[1]) and at bin B-1 to
        // 2*Re(f[B-2]); the imaginary edge taps are zero.
        const bool first = b == 0, last = b == nbins - 1;
        const float left_re = first ? 2.f * fre[1] : (last ? 0.f : fre[b - 1]);
        const float right_re =
            last ? 2.f * fre[nbins - 2] : (first ? 0.f : fre[b + 1]);
        const float left_im = (first || last) ? 0.f : fim[b - 1];
        const float right_im = (first || last) ? 0.f : fim[b + 1];
        const float conv_re =
            0.25f * (2.f * fre[b] - left_re - right_re) / two_b_f;
        const float conv_im =
            0.25f * (2.f * fim[b] - left_im - right_im) / two_b_f;
        const float energy = conv_re * conv_re + conv_im * conv_im;
        const bool dead = energy == 0.f;
        const float phase =
            atan2_poly(dead ? 0.f : conv_im, dead ? 1.f : conv_re);
        if (i >= 0) {
          // wrapped phase difference -> frequency; the wrap is deliberate
          // (flan_tpu/spv/spv.py:252-258), round-half-even as jnp.round
          float d = phase - prev[k] - expected[k];
          d = d - kTwoPi * rintf(d / kTwoPi);
          out_mag[(long long)i * nbins + b] = sqrtf(energy);
          out_freq[(long long)i * nbins + b] = binf[k] + d * hz_per_radian;
        }
        prev[k] = phase;
      }
    }
    row_cur = row_next;
    if (++row_next == two_b) row_next = 0;
  }
}

// ---------------------------------------------------------------- inverse

__global__ void __launch_bounds__(kMaxThreads)
inv_tile_totals(const float* __restrict__ freq, float* __restrict__ tot,
                long long n, int nbins, int ntiles, float sample_rate) {
  const int tile = blockIdx.x, c = blockIdx.y;
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, n - t0);
  const float* fr = freq + ((long long)c * n + t0) * nbins;
  const long long out = ((long long)c * ntiles + tile) * nbins;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i)
      s = mod1(s + mod1(fr[(long long)i * nbins + b] / sample_rate));
    tot[out + b] = s;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
inv_epilogue(const float* __restrict__ mag, const float* __restrict__ freq,
             const float* __restrict__ carry, float* __restrict__ out,
             long long n, int nbins, int ntiles, float sample_rate) {
  __shared__ float partial[kMaxThreads / 32][kTile];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, n - t0);
  const long long base = ((long long)c * n + t0) * nbins;
  const long long cbase = ((long long)c * ntiles + tile) * nbins;

  float cyc0[K], run[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    cyc0[k] = b < nbins ? carry[cbase + b] : 0.f;
    run[k] = 0.f;
  }
  for (int i = 0; i < rows; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = threadIdx.x + k * blockDim.x;
      if (b < nbins) {
        const long long at = base + (long long)i * nbins + b;
        run[k] = mod1(run[k] + mod1(freq[at] / sample_rate));
        const float cycles = mod1(run[k] + cyc0[k]);
        const float real = mag[at] * cosf(cycles * kTwoPi);
        acc += (b & 1) ? -real : real;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) partial[warp][i] = acc;
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += partial[w][i];
    out[(long long)c * n + t0 + i] = 2.f * s;
  }
}

}  // namespace

extern "C" {

int flan_spv_tile_frames() { return kTile; }

int flan_spv_max_bins() { return kMaxThreads * kMaxBinsPerThread; }

// x [C, N]; tw_re, tw_im [2B, B]; tot_re, tot_im scratch [C, ceil(N/kTile),
// B]; mag, freq [C, N, B]. All float32, contiguous, on the stream's device.
int flan_spv_forward(const float* x, const float* tw_re, const float* tw_im,
                     float* tot_re, float* tot_im, float* mag, float* freq,
                     int channels, long long n, int nbins, double sample_rate,
                     void* stream) {
  int k, threads;
  if (channels < 1 || n < 1 || nbins < 2 || !epilogue_shape(nbins, &k, &threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(ntiles, channels);
  fwd_tile_totals<<<grid, threads, 0, s>>>(x, tw_re, tw_im, tot_re, tot_im,
                                           n, nbins, ntiles);
  exclusive_scan_tiles<false>
      <<<dim3((nbins + 31) / 32, channels, 2), dim3(32, kScanSegments), 0, s>>>(
          tot_re, tot_im, ntiles, nbins);
  const size_t smem = (kTile + 4 * (size_t)nbins) * sizeof(float);
  const float bin_hz = (float)(sample_rate / (2.0 * nbins));
  const float hz_per_radian = (float)(sample_rate / (2.0 * 3.14159265358979323846));
  const float sr = (float)sample_rate;
#define FLAN_FWD(K)                                                        \
  fwd_epilogue<K><<<grid, threads, smem, s>>>(x, tw_re, tw_im, tot_re,     \
                                              tot_im, mag, freq, n, nbins, \
                                              ntiles, bin_hz, sr,          \
                                              hz_per_radian)
  switch (k) {
    case 1: FLAN_FWD(1); break;
    case 2: FLAN_FWD(2); break;
    case 4: FLAN_FWD(4); break;
    default: FLAN_FWD(8); break;
  }
#undef FLAN_FWD
  return (int)cudaGetLastError();
}

// mag, freq [C, N, B]; tot scratch [C, ceil(N/kTile), B]; out [C, N].
int flan_spv_inverse(const float* mag, const float* freq, float* tot,
                     float* out, int channels, long long n, int nbins,
                     double sample_rate, void* stream) {
  int k, threads;
  if (channels < 1 || n < 1 || nbins < 1 || !epilogue_shape(nbins, &k, &threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(ntiles, channels);
  const float sr = (float)sample_rate;
  inv_tile_totals<<<grid, threads, 0, s>>>(freq, tot, n, nbins, ntiles, sr);
  exclusive_scan_tiles<true>
      <<<dim3((nbins + 31) / 32, channels, 1), dim3(32, kScanSegments), 0, s>>>(
          tot, tot, ntiles, nbins);
#define FLAN_INV(K)                                                          \
  inv_epilogue<K><<<grid, threads, 0, s>>>(mag, freq, tot, out, n, nbins,    \
                                           ntiles, sr)
  switch (k) {
    case 1: FLAN_INV(1); break;
    case 2: FLAN_INV(2); break;
    case 4: FLAN_INV(4); break;
    default: FLAN_INV(8); break;
  }
#undef FLAN_INV
  return (int)cudaGetLastError();
}

}  // extern "C"
