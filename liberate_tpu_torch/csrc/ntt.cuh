// Forward butterfly stages of the fused key-switch core (ntt_mulacc.cu):
// Cooley-Tukey with natural-order input and bit-reversed output, Shoup-form
// twiddles, lazy [0, 2q) words, the twiddle of stage s and block b at bank
// entry 2^s + b; the same network as the forward NTT (ntt.cu).
//
// A channel of more than 2^12 words does not fit one block's shared memory,
// so the long-span stages (span above a 2^12-word tile) run first through
// global memory, up to three per launch with one butterfly group in each
// thread's registers (fwd_top); the last 12 stages run on shared-memory
// tiles (fwd_tile).
#pragma once

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace bfly {

constexpr int kLogTile = 12;
constexpr int kRegThreads = 256;
constexpr int kSmemThreads = 512;

// Forward stages s0 .. s0+LOGR-1. At stage s0 the data is 2^s0 independent
// blocks of L = N >> s0 words; thread (g, j) holds words g*L + j + k*(L/R).
template <int LOGR>
__global__ void fwd_regs(const u64* in, long long in_sb, long long in_sc,
                         u64* out, int logN, int s0,
                         const u64* __restrict__ w, const u64* __restrict__ wp,
                         const u64* __restrict__ qv,
                         const u64* __restrict__ ew,
                         const u64* __restrict__ ewp) {
  constexpr int R = 1 << LOGR;
  const int c = blockIdx.y, b = blockIdx.z, C = gridDim.y;
  const long long N = 1LL << logN;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (N >> LOGR)) return;
  const int logS = logN - s0 - LOGR;
  const long long S = 1LL << logS;
  const long long g = idx >> logS;
  const long long base = (g << (logN - s0)) + (idx & (S - 1));
  const u64 q = qv[c], q2 = 2 * q;
  const u64* src = in + b * in_sb + c * in_sc;
  u64* dst = out + ((long long)b * C + c) * N;
  const u64* wc = w + c * N;
  const u64* wpc = wp + c * N;

  u64 x[R];
#pragma unroll
  for (int k = 0; k < R; ++k) x[k] = src[base + k * S];
  if (ew != nullptr) {
    const u64 a = ew[c], ap = ewp[c];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = shoup_mul(x[k], a, ap, q);
  }
#pragma unroll
  for (int i = 0; i < LOGR; ++i) {
    const int half = R >> (i + 1);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k & half) continue;
      const long long tw = (1LL << (s0 + i)) + (g << i) + (k >> (LOGR - i));
      const u64 U = x[k];
      const u64 V = shoup_mul(x[k + half], wc[tw], wpc[tw], q);
      x[k] = csub(U + V, q2);
      x[k + half] = csub(U + q2 - V, q2);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) dst[base + k * S] = x[k];
}

// Forward stages logN-logL .. logN-1 of tile g (sh: its 2^logL words),
// run by all threads of the block. wc, wpc: the channel's twiddle bank and
// quotients. Starts and ends with a barrier.
__device__ __forceinline__ void fwd_tile(u64* sh, int logN, int logL, int g,
                                         const u64* __restrict__ wc,
                                         const u64* __restrict__ wpc, u64 q) {
  const int L = 1 << logL, s0 = logN - logL;
  const u64 q2 = 2 * q;
  for (int i = 0; i < logL; ++i) {
    __syncthreads();
    const int logt = logL - i - 1, t = 1 << logt;
    const long long twbase = (1LL << (s0 + i)) + ((long long)g << i);
    for (int j = threadIdx.x; j < L / 2; j += blockDim.x) {
      const int blk = j >> logt;
      const int u = (blk << (logt + 1)) + (j & (t - 1));
      const long long tw = twbase + blk;
      const u64 U = sh[u];
      const u64 V = shoup_mul(sh[u + t], wc[tw], wpc[tw], q);
      sh[u] = csub(U + V, q2);
      sh[u + t] = csub(U + q2 - V, q2);
    }
  }
  __syncthreads();
}

inline dim3 regs_grid(int logN, int r, int C, int B) {
  const long long threads = 1LL << (logN - r);
  return dim3((unsigned)((threads + kRegThreads - 1) / kRegThreads), C, B);
}

inline int launch_fwd_regs(int r, dim3 grid, cudaStream_t st, const u64* in,
                           long long sb, long long sc, u64* out, int logN,
                           int s0, const u64* w, const u64* wp, const u64* q,
                           const u64* ew, const u64* ewp) {
  switch (r) {
    case 1:
      fwd_regs<1><<<grid, kRegThreads, 0, st>>>(in, sb, sc, out, logN, s0, w,
                                                wp, q, ew, ewp);
      break;
    case 2:
      fwd_regs<2><<<grid, kRegThreads, 0, st>>>(in, sb, sc, out, logN, s0, w,
                                                wp, q, ew, ewp);
      break;
    default:
      fwd_regs<3><<<grid, kRegThreads, 0, st>>>(in, sb, sc, out, logN, s0, w,
                                                wp, q, ew, ewp);
  }
  return (int)cudaGetLastError();
}

// log2 of the shared-memory tile, and its thread count.
inline int tile_log(int logN) { return logN < kLogTile ? logN : kLogTile; }
inline int tile_threads(int logL) {
  return (1 << logL) / 2 < kSmemThreads ? (1 << logL) / 2 : kSmemThreads;
}

// The long-span stages 0 .. logN-logL-1 of x [B, C, N] (element strides
// (sb, sc, 1)) into the contiguous out [B, C, N], with the optional entry
// multiply (ew, ewp) folded into the first launch. On return src, sb, sc
// and ew, ewp describe what the tile stages read next: out once a stage
// ran, else x as given.
inline int fwd_top(const u64*& src, long long& sb, long long& sc, u64* out,
                   int B, int C, int logN, const u64* w, const u64* wp,
                   const u64* q, const u64*& ew, const u64*& ewp,
                   cudaStream_t st) {
  const int s_top = logN - tile_log(logN);
  for (int s0 = 0; s0 < s_top;) {
    const int r = (s_top - s0) < 3 ? (s_top - s0) : 3;
    const int rc = launch_fwd_regs(r, regs_grid(logN, r, C, B), st, src, sb,
                                   sc, out, logN, s0, w, wp, q, ew, ewp);
    if (rc != 0) return rc;
    src = out;
    sb = (long long)C << logN;
    sc = 1LL << logN;
    ew = ewp = nullptr;
    s0 += r;
  }
  return 0;
}

}  // namespace bfly
