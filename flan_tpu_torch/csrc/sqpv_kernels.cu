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
// so one thread owns one bin and a block of 256 threads a run of frames of
// up to 256 bins: whole rows of the planes for a constant-Q bin count.
// What held the first version (one part of its source taken out at a time,
// PERF.md): the instructions of the frame loop (~170 a frame-bin), twelve
// table floats a frame-bin from L2, two gathers a frame that miss L1 once a
// multiprocessor runs thousands of them, stores in rows of B floats that
// start on no 32-byte sector (and single bytes), and a carry on 6 blocks.
// What this version does about each:
//   - the frame loop runs in batches of 8 frames: each thread first loads
//     its 8 + 8 samples of x (the same one or two sectors, whatever L1
//     keeps), then computes 8 frames from registers with 32-bit indices;
//   - within a tile the running sum is rotated by the host tables t1 = a^-i
//     and t2 = a^(i+1) (float64 on the host, stored float32). t1[i+1] is
//     the conjugate of t2[i] bit for bit, so only t2 is stored and a thread
//     carries it into the next frame: 6 table floats a frame-bin in the
//     epilogue and in the totals, not 12 and 6, laid out so that they are
//     three 8-byte loads from one pointer;
//   - the phase's division and the wrap's are the card's fast ones (they
//     feed no accumulator); the magnitude keeps sqrtf, with which the
//     epilogue measured 10% faster than with sqrt.approx (PERF.md); the
//     running sums, the carry and the comb operand keep their arithmetic;
//   - a block of 256 threads holds whole rows of a constant-Q bin count
//     (the first version's 128 left every row to two blocks), so a frame's
//     stores fill whole sectors but the row's first and last. Staging
//     batches of rows in shared memory for 16-byte stores was measured and
//     bought nothing on top of that (PERF.md), so each thread stores its
//     own values, streaming;
//   - the carry over tiles C_{k+1} = a^128 (C_k + S_k) is cut into chunks
//     of kCarryChunk tiles with the host's powers a^(128 i), as the real
//     sums of the other kernels are (common.cuh).
// Four launches:
//   1. tile totals S_k = sum_i a^-i u[t0+i] per 128-frame tile, line, bin;
//   2. the carry within each chunk from 0, in place over the totals: L_k,
//      and each chunk's carry out D_q, one thread per (bin, chunk, line);
//   3. the carry over chunks X_{q+1} = a^(128 m) X_q + D_q, in place over
//      D, one thread per (channel, line, bin) chain of N / (128 m) steps;
//   4. the epilogue forms C_k = a^(128 i) X_q + L_k (k = q m + i), re-runs
//      the tile from it, combines the lines 0.5 F_0 - 0.25 (F_-1 + F_+1),
//      takes the polar form and the phase-difference frequency, and writes
//      pitch = log2(max(|f|, 1e-12)) and positive = f >= 0 for the frames
//      of the output. The previous frame's phase at a tile start comes from
//      C_k, which is the frame before it. Warm-up tiles are skipped.
// Every order of operations is fixed: a call gives the same bits each time.
//
// Inverse: B2's first design. Tile totals of the mod-1 cycle increments
// frac(+-2^pitch / sr) (true division), a mod-1 prefix over tiles, and an
// epilogue that keeps each bin's cycles reduced mod 1 every frame and
// reduces sum_b mag * Re(e^{2 pi i cycles} tw_b) per frame across the block.
// The frequency is decoded from pitch and sign in the kernel, so no
// frequency plane is built. Sine and cosine are sincosf (not the fast
// intrinsics) of cycles * 2 pi, as the plain version's torch.cos/torch.sin.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kLines = 3;          // twiddle lines j = -1, 0, +1
constexpr int kFwdThreads = 256;   // forward: one bin per thread
constexpr int kBatch = 8;          // frames per batch of the forward loops
constexpr int kCarryChunk = 32;    // tiles per chunk of the forward's carry
constexpr int kCarryBatch = 32;    // chunk totals in flight per chain

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

// One bin's walk over one tile: where its two reads of x start, and the
// tile rows of its quirk frames (-1: not in this tile).
struct TileWalk {
  long long s_new, s_old;   // x index of row 0's new and old sample
  int i_new, i_old;
};

__device__ __forceinline__ TileWalk tile_walk(const BinConsts& k, long long t0,
                                              int w0) {
  TileWalk w;
  w.s_new = t0 - w0 + k.off_p;
  w.s_old = t0 - w0 - k.off_m;
  const long long dn = k.t_new - t0, dk = k.t_old - t0;
  w.i_new = (k.t_new >= 0 && dn >= 0 && dn < kTile) ? (int)dn : -1;
  w.i_old = (k.t_old >= 0 && dk >= 0 && dk < kTile) ? (int)dk : -1;
  return w;
}

// kBatch consecutive samples of x from index s on, zero outside [0, n).
__device__ __forceinline__ void load_batch(const float* __restrict__ xc,
                                           long long s, long long n,
                                           float (&v)[kBatch]) {
  if (s >= 0 && s + kBatch <= n) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = __ldg(xc + s + j);
  } else {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = (s + j >= 0 && s + j < n) ? __ldg(xc + s + j) : 0.f;
  }
}

// The comb operand u of one bin at tile row i, rounded as the plain version
// rounds it: ((fr * x_new - x_old) * scale, (fi * x_new) * scale), plus x[0]
// times the quirk coefficient at the quirk rows. The _rn intrinsics keep
// nvcc from contracting these steps into FMAs.
__device__ __forceinline__ void comb_operand(float xn, float xo, int i,
                                             const TileWalk& w,
                                             const BinConsts& k, float fr,
                                             float fi, float x0, float* ure,
                                             float* uim) {
  float re = __fmul_rn(__fsub_rn(__fmul_rn(fr, xn), xo), k.scale);
  float im = __fmul_rn(__fmul_rn(fi, xn), k.scale);
  if (i == w.i_new) {
    re = __fadd_rn(re, __fmul_rn(x0, k.q_new_re));
    im = __fadd_rn(im, __fmul_rn(x0, k.q_new_im));
  }
  if (i == w.i_old) re = __fadd_rn(re, __fmul_rn(x0, k.q_old_re));
  *ure = re;
  *uim = im;
}

// t2: [kTile][nbins][kLines] pairs (re, im) of a^(i+1), so that the six
// floats of one row and bin lie together: three 8-byte loads from one
// pointer, which moves by a row a frame.
__device__ __forceinline__ const float2* t2_row(const float* t2, int i, int b,
                                                int nbins) {
  return reinterpret_cast<const float2*>(t2) +
         ((long long)i * nbins + b) * kLines;
}
__device__ __forceinline__ float2 t2_line(const float2* row, int l) {
  return __ldg(row + l);
}

// ---------------------------------------------------------------- forward

// tot: [C][ntiles][2 * kLines][nbins], rows re of the lines then im.
__global__ void __launch_bounds__(kFwdThreads)
sqpv_fwd_tile_totals(const float* __restrict__ x,
                     const float* __restrict__ t2,
                     const float* __restrict__ bin_f,
                     const int* __restrict__ bin_i, float* __restrict__ tot,
                     long long n, int nbins, int ntiles, int w0, float fr,
                     float fi) {
  const int tile = blockIdx.x, c = blockIdx.z;
  const int b = blockIdx.y * kFwdThreads + threadIdx.x;
  if (b >= nbins) return;
  const BinConsts k = load_bin(bin_f, bin_i, b, nbins);
  const float* xc = x + (long long)c * n;
  const float x0 = xc[0];
  const long long t0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, w0 + n - t0);
  const TileWalk w = tile_walk(k, t0, w0);
  float sre[kLines] = {0.f, 0.f, 0.f}, sim[kLines] = {0.f, 0.f, 0.f};
  // a^-i, carried from the row before: a^0, then conj(t2[i - 1])
  float wr[kLines] = {1.f, 1.f, 1.f}, wi[kLines] = {0.f, 0.f, 0.f};
  const float2* tp = t2_row(t2, 0, b, nbins);
  for (int i0 = 0; i0 < rows; i0 += kBatch) {
    float xn[kBatch], xo[kBatch];
    load_batch(xc, w.s_new + i0, n, xn);
    load_batch(xc, w.s_old + i0, n, xo);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j;
      if (i < rows) {
        float ure, uim;
        comb_operand(xn[j], xo[j], i, w, k, fr, fi, x0, &ure, &uim);
#pragma unroll
        for (int l = 0; l < kLines; ++l) {
          sre[l] += ure * wr[l] - uim * wi[l];
          sim[l] += ure * wi[l] + uim * wr[l];
          const float2 w2 = t2_line(tp, l);
          wr[l] = w2.x;
          wi[l] = -w2.y;
        }
        tp += kLines * nbins;
      }
    }
  }
  float* out = tot + ((long long)c * ntiles + tile) * 2 * kLines * nbins + b;
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    out[l * nbins] = sre[l];
    out[(kLines + l) * nbins] = sim[l];
  }
}

// apow: [2][kLines][kCarryChunk + 1][nbins] = re, im of a^(128 i).
__device__ __forceinline__ void load_apow(const float* __restrict__ apow,
                                          int l, int i, int b, int nbins,
                                          float* re, float* im) {
  const long long at = ((long long)l * (kCarryChunk + 1) + i) * nbins + b;
  *re = __ldg(apow + at);
  *im = __ldg(apow + at + (long long)kLines * (kCarryChunk + 1) * nbins);
}

// In place over tot: within each chunk of kCarryChunk tiles the totals S
// become the carries from 0, L_0 = 0 and L_{i+1} = a^128 (L_i + S_i); the
// carry out of the chunk goes to chunks [C][nchunks][2 * kLines][nbins].
// One thread per (bin, chunk, line and channel).
__global__ void __launch_bounds__(kFwdThreads)
sqpv_fwd_carry_local(const float* __restrict__ apow, float* tot,
                     float* __restrict__ chunks, int nbins, int ntiles,
                     int nchunks) {
  const int b = blockIdx.y * kFwdThreads + threadIdx.x;
  const int q = blockIdx.x, l = blockIdx.z % kLines, c = blockIdx.z / kLines;
  if (b >= nbins) return;
  float ar, ai;
  load_apow(apow, l, 1, b, nbins, &ar, &ai);
  const long long stride = 2LL * kLines * nbins;
  const int k0 = q * kCarryChunk;
  const int cnt = min(kCarryChunk, ntiles - k0);
  float* pre = tot + ((long long)c * ntiles + k0) * stride + l * nbins + b;
  float* pim = pre + kLines * nbins;
  float sr[kCarryChunk], si[kCarryChunk];
#pragma unroll
  for (int j = 0; j < kCarryChunk; ++j) {
    if (j < cnt) {
      sr[j] = pre[j * stride];
      si[j] = pim[j * stride];
    }
  }
  float cre = 0.f, cim = 0.f;
#pragma unroll
  for (int j = 0; j < kCarryChunk; ++j) {
    if (j < cnt) {
      pre[j * stride] = cre;
      pim[j * stride] = cim;
      const float zr = cre + sr[j], zi = cim + si[j];
      cre = zr * ar - zi * ai;
      cim = zr * ai + zi * ar;
    }
  }
  float* out = chunks + ((long long)c * nchunks + q) * stride + l * nbins + b;
  out[0] = cre;
  out[kLines * nbins] = cim;
}

// In place over chunks: the carries out D_q become the carries into the
// chunks, X_0 = 0 and X_{q+1} = a^(128 m) X_q + D_q, m = kCarryChunk. One
// thread per (channel, line, bin) chain.
__global__ void __launch_bounds__(kFwdThreads)
sqpv_fwd_carry_chunks(const float* __restrict__ apow, float* chunks,
                      int nbins, int nchunks) {
  const int b = blockIdx.x * kFwdThreads + threadIdx.x;
  const int l = blockIdx.y, c = blockIdx.z;
  if (b >= nbins) return;
  float ar, ai;
  load_apow(apow, l, kCarryChunk, b, nbins, &ar, &ai);
  const long long stride = 2LL * kLines * nbins;
  float* pre = chunks + (long long)c * nchunks * stride + l * nbins + b;
  float* pim = pre + kLines * nbins;
  float cre = 0.f, cim = 0.f;
  for (int q0 = 0; q0 < nchunks; q0 += kCarryBatch) {
    const int cnt = min(kCarryBatch, nchunks - q0);
    float dr[kCarryBatch], di[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      if (j < cnt) {
        dr[j] = pre[(q0 + j) * stride];
        di[j] = pim[(q0 + j) * stride];
      }
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      if (j < cnt) {
        pre[(q0 + j) * stride] = cre;
        pim[(q0 + j) * stride] = cim;
        const float zr = cre * ar - cim * ai, zi = cre * ai + cim * ar;
        cre = zr + dr[j];
        cim = zi + di[j];
      }
    }
  }
}

// 0.5 F_0 - 0.25 (F_-1 + F_+1): the spectral hann over the lines
// (AudioSQPV.cpp:110-112).
__device__ __forceinline__ float hann_lines(const float* f) {
  return 0.5f * f[1] - 0.25f * (f[0] + f[2]);
}

__global__ void __launch_bounds__(kFwdThreads)
sqpv_fwd_epilogue(const float* __restrict__ x, const float* __restrict__ t2,
                  const float* __restrict__ apow,
                  const float* __restrict__ bin_f,
                  const int* __restrict__ bin_i,
                  const float* __restrict__ local,
                  const float* __restrict__ chunks, float* __restrict__ mag,
                  float* __restrict__ pitch,
                  unsigned char* __restrict__ positive, long long n,
                  int nbins, int ntiles, int nchunks, int w0, float fr,
                  float fi, float hz_per_radian) {
  const int tile = blockIdx.x, c = blockIdx.z;
  const int b = blockIdx.y * kFwdThreads + threadIdx.x;
  const long long t0 = (long long)tile * kTile;
  if (b >= nbins || t0 + kTile <= w0) return;  // warm-up tiles emit nothing
  const BinConsts k = load_bin(bin_f, bin_i, b, nbins);
  const float* xc = x + (long long)c * n;
  const float x0 = xc[0];
  const int rows = (int)min((long long)kTile, w0 + n - t0);
  const TileWalk w = tile_walk(k, t0, w0);

  // C_k = a^(128 i) X_q + L_k for tile k = q * kCarryChunk + i
  const int q = tile / kCarryChunk;
  const long long stride = 2LL * kLines * nbins;
  const float* lp = local + ((long long)c * ntiles + tile) * stride + b;
  const float* xp = chunks + ((long long)c * nchunks + q) * stride + b;
  float cre[kLines], cim[kLines], run_re[kLines], run_im[kLines];
  float wr[kLines], wi[kLines];
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    float pr, pi;
    load_apow(apow, l, tile - q * kCarryChunk, b, nbins, &pr, &pi);
    const float xr = xp[l * nbins], xi = xp[(kLines + l) * nbins];
    cre[l] = (xr * pr - xi * pi) + lp[l * nbins];
    cim[l] = (xr * pi + xi * pr) + lp[(kLines + l) * nbins];
    run_re[l] = 0.f;
    run_im[l] = 0.f;
    wr[l] = 1.f;
    wi[l] = 0.f;
  }
  // the frame before the tile is F = C_k, on every line
  float prev = atan2_poly_fast(hann_lines(cim), hann_lines(cre));
  const long long row0 = (long long)c * n + t0 - w0;  // tile row i -> row0 + i
  const float2* tp = t2_row(t2, 0, b, nbins);
  float* mp = mag + row0 * nbins + b;          // tile row 0 of each plane
  float* pp = pitch + row0 * nbins + b;
  unsigned char* sp = positive + row0 * nbins + b;

  for (int i0 = 0; i0 < rows; i0 += kBatch) {
    float xn[kBatch], xo[kBatch];
    load_batch(xc, w.s_new + i0, n, xn);
    load_batch(xc, w.s_old + i0, n, xo);
    // rows from lo on are frames of the output
    const int lo = (int)max(0LL, min((long long)kBatch, w0 - t0 - i0));
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j;
      if (i < rows) {
        float ure, uim;
        comb_operand(xn[j], xo[j], i, w, k, fr, fi, x0, &ure, &uim);
        float fre[kLines], fim[kLines];
#pragma unroll
        for (int l = 0; l < kLines; ++l) {
          run_re[l] += ure * wr[l] - uim * wi[l];
          run_im[l] += ure * wi[l] + uim * wr[l];
          const float sre = cre[l] + run_re[l], sim = cim[l] + run_im[l];
          const float2 w2 = t2_line(tp, l);
          fre[l] = sre * w2.x - sim * w2.y;
          fim[l] = sre * w2.y + sim * w2.x;
          wr[l] = w2.x;      // a^-(i+1) = conj(a^(i+1))
          wi[l] = -w2.y;
        }
        tp += kLines * nbins;
        const float hre = hann_lines(fre), him = hann_lines(fim);
        const float phase = atan2_poly_fast(him, hre);
        if (j >= lo) {
          // wrapped phase difference -> frequency (transform.py:197-202),
          // round-half-even as jnp.round
          float d = phase - prev - k.expected;
          d = d - kTwoPi * rintf(d * kInvTwoPi);
          const float f = k.bin_hz + d * hz_per_radian;
          const long long at = (long long)i * nbins;
          __stcs(mp + at, sqrtf(hre * hre + him * him));
          __stcs(pp + at, log2f(fmaxf(fabsf(f), 1e-12f)));
          __stcs(sp + at, (unsigned char)(f >= 0.f));
        }
        prev = phase;
      }
    }
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

// Tiles per chunk of the forward's carry: the wrapper sizes the powers
// table and the scratch by it.
int flan_sqpv_carry_chunk() { return kCarryChunk; }

// x [C, N]; t2 [kTile, B, 3, 2] (re, im of a^(i+1), 8-byte aligned); apow [2, 3,
// kCarryChunk + 1, B] (re, im of a^(128 i)); bin_f [6, B] float; bin_i
// [4, B] int; tot scratch: [C, ntiles, 6, B] then [C, nchunks, 6, B]
// floats, ntiles = ceil((w0 + N) / kTile), nchunks = ceil(ntiles /
// kCarryChunk); mag, pitch [C, N, B] float and positive [C, N, B] bytes.
// Contiguous, on the stream's device.
int flan_sqpv_forward(const float* x, const float* t2, const float* apow,
                      const float* bin_f, const int* bin_i, float* tot,
                      float* mag, float* pitch, unsigned char* positive,
                      int channels, long long n, int nbins, int w0, float fr,
                      float fi, double sample_rate, void* stream) {
  if (channels < 1 || n < 1 || nbins < 1 || w0 < 0 ||
      nbins > kMaxThreads * kMaxBinsPerThread || (uintptr_t)t2 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((w0 + n + kTile - 1) / kTile);
  const int nchunks = (ntiles + kCarryChunk - 1) / kCarryChunk;
  const int bin_blocks = (nbins + kFwdThreads - 1) / kFwdThreads;
  float* chunks = tot + (long long)channels * ntiles * 2 * kLines * nbins;
  const dim3 grid(ntiles, bin_blocks, channels);
  sqpv_fwd_tile_totals<<<grid, kFwdThreads, 0, s>>>(
      x, t2, bin_f, bin_i, tot, n, nbins, ntiles, w0, fr, fi);
  sqpv_fwd_carry_local<<<dim3(nchunks, bin_blocks, channels * kLines),
                         kFwdThreads, 0, s>>>(apow, tot, chunks, nbins,
                                              ntiles, nchunks);
  sqpv_fwd_carry_chunks<<<dim3(bin_blocks, kLines, channels), kFwdThreads, 0,
                          s>>>(apow, chunks, nbins, nchunks);
  const float hz_per_radian =
      (float)(sample_rate / (2.0 * 3.14159265358979323846));
  sqpv_fwd_epilogue<<<grid, kFwdThreads, 0, s>>>(
      x, t2, apow, bin_f, bin_i, tot, chunks, mag, pitch, positive, n, nbins,
      ntiles, nchunks, w0, fr, fi, hz_per_radian);
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
