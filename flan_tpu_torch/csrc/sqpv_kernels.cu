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
// Inverse: one launch, reading each plane once. What held the first
// version (one part of its source taken out at a time, PERF.md): a
// tile-totals launch that read pitch and sign a second time, float32 cycles
// reduced by fmodf three times a frame-bin, full-range sincosf, one-float
// and one-byte loads, and a warp reduction every frame. Here:
//   - cycles are 32-bit fixed point, as in B2: a frame-bin's increment is
//     frac(2^pitch / sr) * 2^32 from exp2f and a true division (it feeds an
//     accumulator), negated as an integer where the sign is negative, so
//     sums wrap by themselves and associate exactly;
//   - the synthesis twiddle e^{2 pi i Q / N_b} is folded into each bin's
//     starting cycles as a 32-bit offset (host, float64):
//     Re(e^{2 pi i c} tw_b) = cos(2 pi (c + Q / N_b)). A 32-bit phase turns
//     into float32 half turns with 24 bits (9.4e-8 rad at most where the
//     cosine moves);
//   - one block per tile of T frames and one channel takes a ticket, and the
//     ticket names its tile, tile-major, so that every tile it waits for is
//     running or done. It stages the tile's three planes (each one
//     contiguous run of T * B elements) flat into shared memory with 16-byte
//     cp.async copies that bypass L1, whatever the run's alignment (no
//     table is left in L2 for the planes to evict: the twiddle is 4 bytes
//     a bin, read once a block): the staging area is shifted to the run's
//     address modulo 16, and the ragged bytes at its two ends are copied
//     one by one. T is as many frames, a multiple of 4 and at most 128, as
//     fill kInvStageBytes (28 frames of 254 bins: 3 blocks a multiprocessor);
//   - each thread turns its bins' pitch and sign into increments in place
//     and sums them: the tile's aggregate per bin, which it publishes at
//     once for the tiles after it (decoupled look-back, Merrill and Garland
//     2016). A descriptor per tile and bin is a 64-bit word, the u32 sum
//     beside a flag (1 aggregate, 2 inclusive prefix), stored at once, so a
//     reader that sees the flag has the sum, with no fence (a fence before
//     a status per tile waits for the magnitudes' copies in flight: 1191
//     us). The sums associate exactly, so whichever descriptors a
//     look-back finds ready, the prefix has the same bits;
//   - the look-back waits on tiles that started just before, so it comes
//     after the work that needs no prefix: each bin's cycles within the
//     tile, and mag * cos and mag * sin of them (sincospif of the phase as
//     a signed fraction of a half turn), in place of the magnitude and the
//     increment. Then the prefix, this tile's inclusive prefix, and the
//     cosine and sine of each bin's cycles before the tile (prefix plus the
//     twiddle's offset) once a tile;
//   - cos(before + local) = cos before * cos local - sin before * sin
//     local is summed across the thread's bins, then across each warp four
//     frames at a time by B2's transposing butterfly (6 shuffles for 4
//     frames), then across warps once per tile, in a fixed order.
// What holds it (PERF.md): 722 us a launch at 1 x 480 k x 254, 491 without
// the look-back, against a 330 us bound. Tiles start ~35 a microsecond and
// a trip to L2 takes about one, so the nearest inclusive prefix lies many
// tiles back and each bin sums that many aggregates (8 bytes a tile and
// bin): the look-back reads its 8 words at a time (one at a time: 1038 us),
// and one warp finds the range by polling 32 tiles at once. Where it runs
// (before or after the sines and cosines) and how tiles are sized (64 KB
// staged, 3 blocks a multiprocessor; 96 KB, 2 blocks: 756) move it little.
// The frequency is decoded from pitch and sign in the kernel, so no
// frequency plane is built.
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

constexpr int kInvMaxFrames = 128;          // frames per tile at most
constexpr int kInvStageBytes = 64 * 1024;   // bytes of the planes staged

// Frames per tile of the inverse for nbins bins: a multiple of 4 (the
// epilogue takes four frames a turn) whose 9 bytes a frame-bin fit
// kInvStageBytes, from 4 to kInvMaxFrames.
__host__ __device__ inline int inv_tile_frames(int nbins) {
  const int t = kInvStageBytes / (9 * nbins) / 4 * 4;
  return t < 4 ? 4 : (t > kInvMaxFrames ? kInvMaxFrames : t);
}

// Shared memory of one staged plane of `bytes`: 16 bytes of room for the
// shift to the plane's address modulo 16, rounded up to 16.
__host__ __device__ inline int stage_room(int bytes) {
  return (bytes + 15) / 16 * 16 + 16;
}

__host__ __device__ inline int inv_stage_bytes(int frames, int nbins) {
  return 2 * stage_room(4 * frames * nbins) + stage_room(frames * nbins);
}

// The `bytes` bytes at src into shared memory from room on, at the same
// address modulo 16: 16-byte asynchronous copies that bypass L1, the ragged
// ends byte by byte. Returns where src[0] lands. The caller commits and
// waits.
__device__ __forceinline__ char* stage(const void* src, int bytes,
                                       char* room) {
  const char* g = static_cast<const char*>(src);
  const int shift = (int)((uintptr_t)g & 15);
  char* dst = room + shift;
  const int head = min(bytes, (16 - shift) & 15);
  const int body = (bytes - head) & ~15;
  const int tail = bytes - head - body;
  for (int i = head + 16 * (int)threadIdx.x; i < head + body;
       i += 16 * (int)blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst + i)),
                 "l"(g + i));
  // fewer than 16 bytes at each end, one thread a byte
  const int t = threadIdx.x;
  if (t < head) {
    dst[t] = g[t];
  } else if (t < head + tail) {
    const int i = body + t;
    dst[i] = g[i];
  }
  return dst;
}

// frac(+-2^pitch / sr) as 32-bit fixed point. q - rint(q) is exact in
// float32 and lies in [-0.5, 0.5]; times 2^32 it converts to a 64-bit
// integer exactly where it is one (half a cycle is 2^31, not saturated),
// and its low 32 bits are the increment. A negative frequency's increment
// is the negation, exactly.
__device__ __forceinline__ unsigned cycle_increment(float p, unsigned char pos,
                                                    float sample_rate) {
  const float q = exp2f(p) / sample_rate;
  const unsigned u =
      (unsigned)__float2ll_rn((q - rintf(q)) * 4294967296.f);
  return pos ? u : 0u - u;
}

// sin and cos of 2 pi cycles / 2^32
__device__ __forceinline__ void sincos_cycles(unsigned cycles, float* sn,
                                              float* cs) {
  sincospif((float)(int)cycles * 4.656612873077392578125e-10f, sn, cs);
}

typedef unsigned long long Word;   // a u32 sum (low half) beside its flag
constexpr unsigned kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ void publish(Word* p, unsigned flag, unsigned v) {
  *reinterpret_cast<volatile Word*>(p) = ((Word)flag << 32) | v;
}

// Warp 0 walks back from the tile before `tile` to the nearest tile whose
// bin-0 descriptor holds its inclusive prefix, with every tile between
// holding at least its aggregate, reading the descriptors of 32 tiles at
// once: desc0 points at this tile's descriptor of bin 0, and the tiles lie
// nbins words apart. Returns that tile's index (tile 0 publishes its
// inclusive prefix at once, so there is one).
__device__ __forceinline__ int look_back_tiles(const Word* desc0, int tile,
                                               int nbins) {
  const volatile Word* q = reinterpret_cast<const volatile Word*>(desc0);
  const int lane = threadIdx.x & 31;
  int nearest = tile - 1;            // the nearest tile not yet passed
  while (true) {
    const int k = nearest - lane;
    const unsigned flag =
        k >= 0 ? (unsigned)(q[(long long)(k - tile) * nbins] >> 32)
               : kInclusive;
    const unsigned incl = __ballot_sync(0xffffffffu, flag == kInclusive);
    const unsigned zero = __ballot_sync(0xffffffffu, flag == 0);
    if (incl != 0) {
      const int first = __ffs(incl) - 1;
      const unsigned upto = first == 31 ? 0xffffffffu : (2u << first) - 1u;
      if ((zero & upto) == 0) return nearest - first;
    } else if (zero == 0) {
      nearest -= 32;                 // 32 aggregates: walk on
    }
  }
}

// One bin's prefix over the tiles before `tile`: its aggregates back to
// tile `found` and that tile's inclusive prefix, read kGather words at a
// time (desc points at this tile's descriptor of the bin). A word that is
// not yet what the walk found is read again; one that already holds its
// tile's inclusive prefix ends the sum there.
constexpr int kGather = 8;

__device__ __forceinline__ unsigned gather_prefix(const Word* desc, int tile,
                                                  int found, int nbins) {
  const volatile Word* q = reinterpret_cast<const volatile Word*>(desc);
  unsigned sum = 0;
  int k = tile - 1;                  // the nearest tile not yet summed
  while (true) {
    Word w[kGather];
#pragma unroll
    for (int j = 0; j < kGather; ++j)
      w[j] = k - j >= found ? q[(long long)(k - j - tile) * nbins] : 0ull;
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      const unsigned flag = (unsigned)(w[j] >> 32);
      if (flag == 0 || (k == found && flag != kInclusive)) break;
      sum += (unsigned)w[j];
      if (flag == kInclusive) return sum;
      --k;
    }
  }
}

// One block per (tile, channel), named by a ticket. Thread t owns bins t,
// t + blockDim, ... (K of them). scratch: the ticket counter, then the
// descriptors [C][ntiles][nbins], zeroed before the launch.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
sqpv_inv_one_pass(const float* __restrict__ mag,
                  const float* __restrict__ pitch,
                  const unsigned char* __restrict__ positive,
                  const unsigned* __restrict__ offset, Word* scratch,
                  float* __restrict__ out, long long n, int nbins,
                  int frames, int ntiles, int channels, float sample_rate) {
  extern __shared__ uint4 staged[];
  __shared__ float partial[kMaxThreads / 32][kInvMaxFrames];
  __shared__ unsigned ticket_sm;
  __shared__ int found_sm;
  if (threadIdx.x == 0)
    ticket_sm = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int tile = (int)(ticket_sm / (unsigned)channels);
  const int c = (int)(ticket_sm - (unsigned)tile * (unsigned)channels);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)tile * frames;
  const int rows = (int)min((long long)frames, n - t0);
  const long long first = ((long long)c * n + t0) * nbins;
  const int count = rows * nbins;

  // pitch and sign first, then the magnitudes, which stay in flight
  // through the increments
  char* room = reinterpret_cast<char*>(staged);
  const int room_f = stage_room(4 * frames * nbins);
  float* sp = reinterpret_cast<float*>(
      stage(pitch + first, 4 * count, room));
  const unsigned char* ss = reinterpret_cast<const unsigned char*>(
      stage(positive + first, count, room + room_f));
  asm volatile("cp.async.commit_group;");
  float* sm = reinterpret_cast<float*>(
      stage(mag + first, 4 * count, room + room_f +
            stage_room(frames * nbins)));
  asm volatile("cp.async.commit_group;");
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();

  // the increments, in place of the pitch, and each bin's aggregate, which
  // the tiles after this one wait for
  unsigned* inc = reinterpret_cast<unsigned*>(sp);
  unsigned total[K];
  Word* desc = scratch + 1 + ((long long)c * ntiles + tile) * nbins;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    total[k] = 0;
    if (b < nbins) {
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        const int at = i * nbins + b;
        const unsigned u = cycle_increment(sp[at], ss[at], sample_rate);
        inc[at] = u;
        total[k] += u;
      }
      publish(desc + b, tile == 0 ? kInclusive : kAggregate, total[k]);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // mag cos and mag sin of the cycles within the tile, in place of the
  // magnitude and the increment, while the tiles before publish
  float* xs = sm;
  float* ys = sp;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    if (b < nbins) {
      unsigned local = 0;
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        const int at = i * nbins + b;
        local += inc[at];
        float sn, cs;
        sincos_cycles(local, &sn, &cs);
        const float m = sm[at];
        xs[at] = m * cs;
        ys[at] = m * sn;
      }
    }
  }
  // each bin's cycles before the tile: its prefix over the tiles before and
  // its twiddle; this tile's inclusive prefix for the tiles after
  if (tile > 0) {
    if (warp == 0) {
      const int found = look_back_tiles(desc, tile, nbins);
      if (lane == 0) found_sm = found;
    }
    __syncthreads();
  }
  float cc[K], sc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    unsigned before = 0;
    if (b < nbins && tile > 0) {
      before = gather_prefix(desc + b, tile, found_sm, nbins);
      publish(desc + b, kInclusive, before + total[k]);
    }
    sincos_cycles(before + (b < nbins ? offset[b] : 0u), &sc[k], &cc[k]);
  }

  // cos(carry + local) = cos carry cos local - sin carry sin local, summed
  // over the thread's bins, then across each warp four frames at a time by
  // a transposing butterfly (spv_kernels.cu inv_epilogue): lane 8 * f ends
  // with frame f; each thread reads only what it wrote above
  const bool hi16 = lane & 16, hi8 = lane & 8;
  for (int i0 = 0; i0 < rows; i0 += 4) {
    float acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u] = 0.f;
      if (i0 + u < rows) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int b = threadIdx.x + k * blockDim.x;
          if (b < nbins) {
            const int at = (i0 + u) * nbins + b;
            acc[u] += cc[k] * xs[at] - sc[k] * ys[at];
          }
        }
      }
    }
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
    out[(long long)c * n + t0 + i] = s;
  }
}

long long inv_tiles(int channels, long long n, int nbins) {
  const long long frames = inv_tile_frames(nbins);
  return channels * ((n + frames - 1) / frames);
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

// Frames per tile of the inverse for `nbins` bins (ops/sqpv_kernels.py
// mirrors it for the CPU emulation of the tests).
int flan_sqpv_inverse_tile_frames(int nbins) {
  return inv_tile_frames(nbins);
}

// Bytes of scratch one call of flan_sqpv_inverse needs.
long long flan_sqpv_inverse_scratch_bytes(int channels, long long n,
                                          int nbins) {
  return (long long)sizeof(Word) * (1 + inv_tiles(channels, n, nbins) * nbins);
}

// mag, pitch [C, N, B] float; positive [C, N, B] bytes; offset [B] u32, each
// bin's starting cycles (its synthesis twiddle's angle); scratch:
// flan_sqpv_inverse_scratch_bytes(C, N, B) bytes, 8-byte aligned (a
// descriptor word is one 64-bit store and load), zeroed here on the stream;
// out [C, N].
int flan_sqpv_inverse(const float* mag, const float* pitch,
                      const unsigned char* positive, const unsigned* offset,
                      void* scratch, float* out, int channels, long long n,
                      int nbins, double sample_rate, void* stream) {
  int k, threads;
  if (channels < 1 || n < 1 || nbins < 1 ||
      !epilogue_shape(nbins, &k, &threads) ||
      reinterpret_cast<uintptr_t>(scratch) % sizeof(Word) != 0)
    return (int)cudaErrorInvalidValue;
  const int frames = inv_tile_frames(nbins);
  const long long tiles = inv_tiles(channels, n, nbins);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t zeroed = cudaMemsetAsync(
      scratch, 0, flan_sqpv_inverse_scratch_bytes(channels, n, nbins), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  const int smem = inv_stage_bytes(frames, nbins);
  const float sr = (float)sample_rate;
  const int ntiles = (int)(tiles / channels);
  cudaError_t allowed = cudaSuccess;
  // the staged planes are more than the 48 KB a block may use without
  // asking (asked on every call: the attribute belongs to the device)
#define FLAN_INV(K)                                                         \
  allowed = cudaFuncSetAttribute(                                           \
      sqpv_inv_one_pass<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
      smem);                                                                \
  if (allowed == cudaSuccess)                                               \
    sqpv_inv_one_pass<K><<<(unsigned)tiles, threads, smem, s>>>(            \
        mag, pitch, positive, offset, static_cast<Word*>(scratch), out, n,  \
        nbins, frames, ntiles, channels, sr)
  switch (k) {
    case 1: FLAN_INV(1); break;
    case 2: FLAN_INV(2); break;
    case 4: FLAN_INV(4); break;
    default: FLAN_INV(8); break;
  }
#undef FLAN_INV
  if (allowed != cudaSuccess) return (int)allowed;
  return (int)cudaGetLastError();
}

}  // extern "C"
