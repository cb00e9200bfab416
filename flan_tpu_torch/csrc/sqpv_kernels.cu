// Sliding constant-Q phase vocoder (SQPV) forward and inverse kernels for
// Hopper.
//
// Replaces the TPU kernels of flan_tpu/ops/sqpv_pallas.py:
//   B3  sqpv_forward_fused / _forward_fused_core -> _fwd_kernel
//       (comb operand, three twiddle lines, carried modulated prefix,
//       spectral hann, polar, PV frequency, pitch and sign)
//   B4  sqpv_inverse_fused / _inverse_fused_core -> _inv_kernel
//       (pitch decode, mod-1 phase accumulation, twiddle-rotated sum)
// and computes what flan_tpu/sqpv/transform.py _sqpv_forward_scan and
// _sqpv_inverse_scan compute (reference: AudioSQPV.cpp:64-165). The plain
// PyTorch versions are flan_tpu_torch/ops/sqpv_kernels.py sqpv_forward_ref
// and sqpv_inverse_ref.
//
// Bound: both kernels are memory-bound. The forward reads x (C*N floats)
// and writes mag and pitch (2*C*N*B floats) and positive (C*N*B bytes);
// the inverse reads those 9 bytes per element and writes C*N floats. For
// 10 s mono at 48 kHz, 16-24000 Hz and 24 bins per octave (B = 254) that is
// 1.10 GB each way, 0.33 ms at 3.35 TB/s.
//
// Forward. Per bin b and twiddle line j in {-1, 0, +1}, with
// a = exp(2 pi i (Q + j) / N_b), the transform runs F[t] = a (F[t-1] + u[t])
// over a timeline of w0 + N frames (w0 frames of warm-up before the first
// output), where u[t] = (fiddle * x[t - w0 + P_b] - x[t - w0 - M_b]) / N_b.
// The TPU kernel read u from a staged [B, C, T] plane (1.09 GB at 10 s),
// because no VMEM ring could hold per-bin delays of up to 100k samples.
// Here x (1.9 MB at 10 s) stays in L2 and every kernel gathers u from x
// itself, toward-zero truncation quirk included (AudioSQPV.cpp:100-103: an
// odd-period bin reads x[0] once on each side), so u is never stored.
// Bins are independent (the hann runs across the three lines of one bin),
// so one thread owns one bin and lanes run along bins: the plane stores
// coalesce and the x gathers are scattered, served by L1/L2 as each
// thread's reads walk forward one sample per frame. Three launches:
//   1. tile totals S_k = sum_i a^-i u[t0+i] per 128-frame tile, line, bin;
//   2. the carry C_{k+1} = a^128 (C_k + S_k), sequential over tiles, one
//      thread per (channel, line, bin) chain, in place over the totals;
//      a^128 is the last row of the host table t2 = a^(i+1), so the carry
//      is the value the epilogue computes at the tile's last frame;
//   3. the epilogue re-runs each tile from C_k with the host tables
//      t1 = a^-i and t2 = a^(i+1) (float64 on the host, stored float32),
//      combines the lines 0.5 F_0 - 0.25 (F_-1 + F_+1), takes the polar
//      form and the phase-difference frequency, and writes pitch =
//      log2(max(|f|, 1e-12)) and positive = f >= 0 for the frames of the
//      output. The previous frame's phase at a tile start comes from the
//      carry C_k, which is the frame before it. Warm-up tiles are skipped.
//
// Inverse: B2's design. Tile totals of the mod-1 cycle increments
// frac(+-2^pitch / sr) (true division), a mod-1 prefix over tiles, and an
// epilogue that keeps each bin's cycles reduced mod 1 every frame and
// reduces sum_b mag * Re(e^{2 pi i cycles} tw_b) per frame across the block.
// The frequency is decoded from pitch and sign in the kernel, so no
// frequency plane is built. Sine and cosine are sincosf (not the fast
// intrinsics) of cycles * 2 pi, as the plain version's torch.cos/torch.sin.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "common.cuh"

namespace {

constexpr int kLines = 3;          // twiddle lines j = -1, 0, +1
constexpr int kBinsPerBlock = 128; // forward: one bin per thread
constexpr int kCarryBatch = 32;    // tile totals in flight per carry thread

// Per-bin constants of the forward, read once per thread.
struct BinConsts {
  int off_p, off_m;     // half-period offsets P_b = N_b / 2, M_b = (N_b+1)/2
  int t_new, t_old;     // timeline frames of the quirk, -1 where none
  float scale;          // 1 / N_b
  float q_new_re, q_new_im, q_old_re;  // quirk coefficients
  float bin_hz, expected;
};

// bin_f rows: scale, q_new_re, q_new_im, q_old_re, bin_hz, expected;
// bin_i rows: off_p, off_m, t_new, t_old. Both [rows, nbins].
__device__ __forceinline__ BinConsts load_bin(const float* __restrict__ bin_f,
                                              const int* __restrict__ bin_i,
                                              int b, int nbins) {
  BinConsts k;
  k.off_p = bin_i[b];
  k.off_m = bin_i[nbins + b];
  k.t_new = bin_i[2 * nbins + b];
  k.t_old = bin_i[3 * nbins + b];
  k.scale = bin_f[b];
  k.q_new_re = bin_f[nbins + b];
  k.q_new_im = bin_f[2 * nbins + b];
  k.q_old_re = bin_f[3 * nbins + b];
  k.bin_hz = bin_f[4 * nbins + b];
  k.expected = bin_f[5 * nbins + b];
  return k;
}

// The comb operand u[t] of one bin, rounded as the plain version rounds it:
// ((fr * x_new - x_old) * scale, (fi * x_new) * scale), plus x[0] times the
// quirk coefficient at the quirk frames. The _rn intrinsics keep nvcc from
// contracting these steps into FMAs.
__device__ __forceinline__ void comb_operand(
    const float* __restrict__ xc, long long t, long long n, int w0,
    const BinConsts& k, float fr, float fi, float x0, float* ure,
    float* uim) {
  const long long i_new = t - w0 + k.off_p, i_old = t - w0 - k.off_m;
  const float xn = (i_new >= 0 && i_new < n) ? __ldg(xc + i_new) : 0.f;
  const float xo = (i_old >= 0 && i_old < n) ? __ldg(xc + i_old) : 0.f;
  float re = __fmul_rn(__fsub_rn(__fmul_rn(fr, xn), xo), k.scale);
  float im = __fmul_rn(__fmul_rn(fi, xn), k.scale);
  if (t == k.t_new) {
    re = __fadd_rn(re, __fmul_rn(x0, k.q_new_re));
    im = __fadd_rn(im, __fmul_rn(x0, k.q_new_im));
  }
  if (t == k.t_old) re = __fadd_rn(re, __fmul_rn(x0, k.q_old_re));
  *ure = re;
  *uim = im;
}

// tables: [4][kLines][kTile][nbins] = t1_re, t1_im, t2_re, t2_im
__device__ __forceinline__ float table(const float* __restrict__ tables,
                                       int which, int line, int i, int b,
                                       int nbins) {
  return __ldg(tables + ((long long)(which * kLines + line) * kTile + i) *
                            nbins + b);
}

// ---------------------------------------------------------------- forward

// tot: [C][ntiles][2 * kLines][nbins], rows re of the lines then im.
__global__ void __launch_bounds__(kBinsPerBlock)
sqpv_fwd_tile_totals(const float* __restrict__ x,
                     const float* __restrict__ tables,
                     const float* __restrict__ bin_f,
                     const int* __restrict__ bin_i, float* __restrict__ tot,
                     long long n, int nbins, int ntiles, int w0, float fr,
                     float fi) {
  const int tile = blockIdx.x, c = blockIdx.z;
  const int b = blockIdx.y * kBinsPerBlock + threadIdx.x;
  if (b >= nbins) return;
  const BinConsts k = load_bin(bin_f, bin_i, b, nbins);
  const float* xc = x + (long long)c * n;
  const float x0 = xc[0];
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, w0 + n - t0);
  float sre[kLines] = {0.f, 0.f, 0.f}, sim[kLines] = {0.f, 0.f, 0.f};
  for (int i = 0; i < rows; ++i) {
    float ure, uim;
    comb_operand(xc, t0 + i, n, w0, k, fr, fi, x0, &ure, &uim);
#pragma unroll
    for (int l = 0; l < kLines; ++l) {
      const float wr = table(tables, 0, l, i, b, nbins);
      const float wi = table(tables, 1, l, i, b, nbins);
      sre[l] += ure * wr - uim * wi;
      sim[l] += ure * wi + uim * wr;
    }
  }
  float* out = tot + ((long long)c * ntiles + tile) * 2 * kLines * nbins + b;
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    out[l * nbins] = sre[l];
    out[(kLines + l) * nbins] = sim[l];
  }
}

// In place over tot: the totals S_k become the carries C_k, with C_0 = 0
// and C_{k+1} = a^128 (C_k + S_k). One thread per (channel, line, bin).
__global__ void __launch_bounds__(kBinsPerBlock)
sqpv_fwd_carry(const float* __restrict__ tables, float* tot, int nbins,
               int ntiles) {
  const int b = blockIdx.x * kBinsPerBlock + threadIdx.x;
  const int l = blockIdx.y, c = blockIdx.z;
  if (b >= nbins) return;
  const float ar = table(tables, 2, l, kTile - 1, b, nbins);
  const float ai = table(tables, 3, l, kTile - 1, b, nbins);
  const long long stride = 2LL * kLines * nbins;
  float* pre = tot + (long long)c * ntiles * stride + l * nbins + b;
  float* pim = pre + kLines * nbins;
  float cre = 0.f, cim = 0.f;
  for (int k0 = 0; k0 < ntiles; k0 += kCarryBatch) {
    const int cnt = min(kCarryBatch, ntiles - k0);
    float sr[kCarryBatch], si[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      if (j < cnt) {
        sr[j] = pre[(k0 + j) * stride];
        si[j] = pim[(k0 + j) * stride];
      }
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      if (j < cnt) {
        pre[(k0 + j) * stride] = cre;
        pim[(k0 + j) * stride] = cim;
        const float zr = cre + sr[j], zi = cim + si[j];
        cre = zr * ar - zi * ai;
        cim = zr * ai + zi * ar;
      }
    }
  }
}

// 0.5 F_0 - 0.25 (F_-1 + F_+1): the spectral hann over the lines
// (AudioSQPV.cpp:110-112).
__device__ __forceinline__ float hann_lines(const float* f) {
  return 0.5f * f[1] - 0.25f * (f[0] + f[2]);
}

__global__ void __launch_bounds__(kBinsPerBlock)
sqpv_fwd_epilogue(const float* __restrict__ x,
                  const float* __restrict__ tables,
                  const float* __restrict__ bin_f,
                  const int* __restrict__ bin_i,
                  const float* __restrict__ carry, float* __restrict__ mag,
                  float* __restrict__ pitch,
                  unsigned char* __restrict__ positive, long long n,
                  int nbins, int ntiles, int w0, float fr, float fi,
                  float hz_per_radian) {
  const int tile = blockIdx.x, c = blockIdx.z;
  const int b = blockIdx.y * kBinsPerBlock + threadIdx.x;
  const long long t0 = (long long)tile * kTile;
  if (b >= nbins || t0 + kTile <= w0) return;  // warm-up tiles emit nothing
  const BinConsts k = load_bin(bin_f, bin_i, b, nbins);
  const float* xc = x + (long long)c * n;
  const float x0 = xc[0];
  const int rows = (int)min((long long)kTile, w0 + n - t0);

  const float* cp = carry + ((long long)c * ntiles + tile) * 2 * kLines * nbins
                    + b;
  float cre[kLines], cim[kLines], run_re[kLines], run_im[kLines];
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    cre[l] = cp[l * nbins];
    cim[l] = cp[(kLines + l) * nbins];
    run_re[l] = 0.f;
    run_im[l] = 0.f;
  }
  // the frame before the tile is F = C_k, on every line
  float prev = atan2_poly(hann_lines(cim), hann_lines(cre));
  const long long out0 = (long long)c * n - w0;  // frame t -> row out0 + t

  for (int i = 0; i < rows; ++i) {
    const long long t = t0 + i;
    float ure, uim;
    comb_operand(xc, t, n, w0, k, fr, fi, x0, &ure, &uim);
    float fre[kLines], fim[kLines];
#pragma unroll
    for (int l = 0; l < kLines; ++l) {
      const float w1r = table(tables, 0, l, i, b, nbins);
      const float w1i = table(tables, 1, l, i, b, nbins);
      run_re[l] += ure * w1r - uim * w1i;
      run_im[l] += ure * w1i + uim * w1r;
      const float sre = cre[l] + run_re[l], sim = cim[l] + run_im[l];
      const float w2r = table(tables, 2, l, i, b, nbins);
      const float w2i = table(tables, 3, l, i, b, nbins);
      fre[l] = sre * w2r - sim * w2i;
      fim[l] = sre * w2i + sim * w2r;
    }
    const float hre = hann_lines(fre), him = hann_lines(fim);
    const float phase = atan2_poly(him, hre);
    if (t >= w0) {
      // wrapped phase difference -> frequency (transform.py:197-202),
      // round-half-even as jnp.round
      float d = phase - prev - k.expected;
      d = d - kTwoPi * rintf(d / kTwoPi);
      const float f = k.bin_hz + d * hz_per_radian;
      const long long at = (out0 + t) * nbins + b;
      mag[at] = sqrtf(hre * hre + him * him);
      pitch[at] = log2f(fmaxf(fabsf(f), 1e-12f));
      positive[at] = f >= 0.f;
    }
    prev = phase;
  }
}

// ---------------------------------------------------------------- inverse

// frac(+-2^pitch / sr): one frame's cycle increment, decoded from the planes
__device__ __forceinline__ float cycle_increment(float p, unsigned char pos,
                                                 float sample_rate) {
  const float f = exp2f(p);
  return mod1((pos ? f : -f) / sample_rate);
}

__global__ void __launch_bounds__(kMaxThreads)
sqpv_inv_tile_totals(const float* __restrict__ pitch,
                     const unsigned char* __restrict__ positive,
                     float* __restrict__ tot, long long n, int nbins,
                     int ntiles, float sample_rate) {
  const int tile = blockIdx.x, c = blockIdx.y;
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, n - t0);
  const long long base = ((long long)c * n + t0) * nbins;
  const long long out = ((long long)c * ntiles + tile) * nbins;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i) {
      const long long at = base + (long long)i * nbins + b;
      s = mod1(s + cycle_increment(pitch[at], positive[at], sample_rate));
    }
    tot[out + b] = s;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
sqpv_inv_epilogue(const float* __restrict__ mag,
                  const float* __restrict__ pitch,
                  const unsigned char* __restrict__ positive,
                  const float* __restrict__ tw, const float* __restrict__ carry,
                  float* __restrict__ out, long long n, int nbins, int ntiles,
                  float sample_rate) {
  __shared__ float partial[kMaxThreads / 32][kTile];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, n - t0);
  const long long base = ((long long)c * n + t0) * nbins;
  const long long cbase = ((long long)c * ntiles + tile) * nbins;

  float cyc0[K], run[K], twr[K], twi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    const bool on = b < nbins;
    cyc0[k] = on ? carry[cbase + b] : 0.f;
    twr[k] = on ? tw[b] : 0.f;
    twi[k] = on ? tw[nbins + b] : 0.f;
    run[k] = 0.f;
  }
  for (int i = 0; i < rows; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = threadIdx.x + k * blockDim.x;
      if (b < nbins) {
        const long long at = base + (long long)i * nbins + b;
        run[k] = mod1(run[k] +
                      cycle_increment(pitch[at], positive[at], sample_rate));
        const float cycles = mod1(run[k] + cyc0[k]);
        float sn, cs;
        sincosf(cycles * kTwoPi, &sn, &cs);
        acc += mag[at] * (cs * twr[k] - sn * twi[k]);
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
    out[(long long)c * n + t0 + i] = s;
  }
}

}  // namespace

extern "C" {

// x [C, N]; tables [4, 3, kTile, B]; bin_f [6, B] float; bin_i [4, B] int;
// tot scratch [C, ceil((w0 + N) / kTile), 6, B]; mag, pitch [C, N, B]
// float; positive [C, N, B] bytes. Contiguous, on the stream's device.
int flan_sqpv_forward(const float* x, const float* tables, const float* bin_f,
                      const int* bin_i, float* tot, float* mag, float* pitch,
                      unsigned char* positive, int channels, long long n,
                      int nbins, int w0, float fr, float fi,
                      double sample_rate, void* stream) {
  if (channels < 1 || n < 1 || nbins < 1 || w0 < 0 ||
      nbins > kMaxThreads * kMaxBinsPerThread)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((w0 + n + kTile - 1) / kTile);
  const int bin_blocks = (nbins + kBinsPerBlock - 1) / kBinsPerBlock;
  const dim3 grid(ntiles, bin_blocks, channels);
  sqpv_fwd_tile_totals<<<grid, kBinsPerBlock, 0, s>>>(
      x, tables, bin_f, bin_i, tot, n, nbins, ntiles, w0, fr, fi);
  sqpv_fwd_carry<<<dim3(bin_blocks, kLines, channels), kBinsPerBlock, 0, s>>>(
      tables, tot, nbins, ntiles);
  const float hz_per_radian =
      (float)(sample_rate / (2.0 * 3.14159265358979323846));
  sqpv_fwd_epilogue<<<grid, kBinsPerBlock, 0, s>>>(
      x, tables, bin_f, bin_i, tot, mag, pitch, positive, n, nbins, ntiles,
      w0, fr, fi, hz_per_radian);
  return (int)cudaGetLastError();
}

// mag, pitch [C, N, B] float; positive [C, N, B] bytes; tw [2, B] (re, im);
// tot scratch of C * (ntiles + nchunks) * B floats, ntiles = ceil(N /
// kTile), nchunks = ceil(ntiles / kScanChunk): the tile totals [C, ntiles,
// B], then the prefix's chunk totals; out [C, N].
int flan_sqpv_inverse(const float* mag, const float* pitch,
                      const unsigned char* positive, const float* tw,
                      float* tot, float* out, int channels, long long n,
                      int nbins, double sample_rate, void* stream) {
  int k, threads;
  if (channels < 1 || n < 1 || nbins < 1 ||
      !epilogue_shape(nbins, &k, &threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(ntiles, channels);
  const float sr = (float)sample_rate;
  sqpv_inv_tile_totals<<<grid, threads, 0, s>>>(pitch, positive, tot, n,
                                                nbins, ntiles, sr);
  launch_tile_prefix<SumMod1>(tot, tot, 1, channels, ntiles, nbins, s);
#define FLAN_INV(K)                                                         \
  sqpv_inv_epilogue<K><<<grid, threads, 0, s>>>(mag, pitch, positive, tw,   \
                                                tot, out, n, nbins, ntiles, \
                                                sr)
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
