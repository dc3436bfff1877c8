// Forward and inverse negacyclic NTT over a batch [B, C, N] of 62-bit words.
//
// Replaces: liberate_tpu/ntt/pallas_ntt.py `_ntt_kernel` (:534) and
// `_intt_kernel` (:577) with Shoup-form twiddles (the Pallas plan's default,
// use_shoup_twiddles). Same butterfly network, same lazy [0, 2q)
// representatives: Cooley-Tukey forward with natural-order input and
// bit-reversed output, Gentleman-Sande inverse, twiddle of stage s and
// block b at bank entry 2^s + b.
//
// What bounds it on the H100: bytes, with the integer multiplies close
// behind. Each butterfly is one Shoup product (a 64x64 high half plus two
// 64-bit low products, about ten 32-bit multiplies). Per silver channel
// (N = 2^15) a transform reads and writes 256 KB of data plus 512 KB of
// twiddles and quotients (shared by the batch): 0.31 us at 3.35 TB/s for
// one polynomial, 0.16 us per further one, against 15 * 2^14 products =
// 2.5e6 32-bit multiplies, 0.15 us at the INT32 rate.
//
// Design: one channel (256 KB at silver) does not fit a block's 227 KB of
// shared memory. The stages whose butterfly span is larger than a tile of
// 2^12 words (32 KB) run first (inverse: last) in global memory, up to
// three stages per launch: each thread keeps 2^r words of one butterfly
// group in registers and runs r stages on them. The remaining 12 stages run
// in one launch where each block finishes one 2^12-word sub-transform in
// shared memory. Silver is therefore two launches per transform. The
// optional Shoup multiply by R mod q (forward entry), by N^-1 or N^-1 R^-1
// (inverse exit) and the final reduce to [0, q) are folded into the first
// or last launch. The forward stages are in ntt.cuh, shared with the
// unsplit switch core (ntt_mulacc.cu).
#include "ntt.cuh"

namespace {

using bfly::kRegThreads;
using bfly::regs_grid;
using bfly::tile_log;
using bfly::tile_threads;

__device__ __forceinline__ u64 reduce_q(u64 v, u64 q) { return csub(v, q); }

// Inverse stages s0+LOGR-1 down to s0, same thread layout as fwd_regs.
// nw/nwp (the N^-1 normalisation) are given only to the last launch.
template <int LOGR>
__global__ void inv_regs(u64* data, int logN, int s0,
                         const u64* __restrict__ w, const u64* __restrict__ wp,
                         const u64* __restrict__ qv,
                         const u64* __restrict__ nw,
                         const u64* __restrict__ nwp, int post_reduce) {
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
  u64* p = data + ((long long)b * C + c) * N;
  const u64* wc = w + c * N;
  const u64* wpc = wp + c * N;

  u64 x[R];
#pragma unroll
  for (int k = 0; k < R; ++k) x[k] = p[base + k * S];
#pragma unroll
  for (int i = LOGR - 1; i >= 0; --i) {
    const int half = R >> (i + 1);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k & half) continue;
      const long long tw = (1LL << (s0 + i)) + (g << i) + (k >> (LOGR - i));
      const u64 U = x[k], V = x[k + half];
      const u64 O = csub(U + q2 - V, q2);
      x[k + half] = shoup_mul(O, wc[tw], wpc[tw], q);
      x[k] = csub(U + V, q2);
    }
  }
  if (nw != nullptr) {
    const u64 a = nw[c], ap = nwp[c];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x[k] = shoup_mul(x[k], a, ap, q);
      if (post_reduce) x[k] = reduce_q(x[k], q);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) p[base + k * S] = x[k];
}

// Forward stages logN-logL .. logN-1: block g owns words [g*L, (g+1)*L).
__global__ void fwd_smem(const u64* in, long long in_sb, long long in_sc,
                         u64* out, int logN, int logL,
                         const u64* __restrict__ w, const u64* __restrict__ wp,
                         const u64* __restrict__ qv,
                         const u64* __restrict__ ew,
                         const u64* __restrict__ ewp, int post_reduce) {
  extern __shared__ u64 sh[];
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z, C = gridDim.y;
  const long long N = 1LL << logN;
  const int L = 1 << logL;
  const u64 q = qv[c];
  const u64* src = in + b * in_sb + c * in_sc + (long long)g * L;
  u64* dst = out + ((long long)b * C + c) * N + (long long)g * L;
  const u64* wc = w + c * N;
  const u64* wpc = wp + c * N;

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    u64 v = src[i];
    if (ew != nullptr) v = shoup_mul(v, ew[c], ewp[c], q);
    sh[i] = v;
  }
  bfly::fwd_tile(sh, logN, logL, g, wc, wpc, q);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    u64 v = sh[i];
    if (post_reduce) v = reduce_q(v, q);
    dst[i] = v;
  }
}

// Inverse stages logN-1 down to logN-logL on shared-memory tiles.
__global__ void inv_smem(const u64* in, long long in_sb, long long in_sc,
                         u64* out, int logN, int logL,
                         const u64* __restrict__ w, const u64* __restrict__ wp,
                         const u64* __restrict__ qv,
                         const u64* __restrict__ nw,
                         const u64* __restrict__ nwp, int post_reduce) {
  extern __shared__ u64 sh[];
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z, C = gridDim.y;
  const long long N = 1LL << logN;
  const int L = 1 << logL, s0 = logN - logL;
  const u64 q = qv[c], q2 = 2 * q;
  const u64* src = in + b * in_sb + c * in_sc + (long long)g * L;
  u64* dst = out + ((long long)b * C + c) * N + (long long)g * L;
  const u64* wc = w + c * N;
  const u64* wpc = wp + c * N;

  for (int i = threadIdx.x; i < L; i += blockDim.x) sh[i] = src[i];
  for (int i = logL - 1; i >= 0; --i) {
    __syncthreads();
    const int logt = logL - i - 1, t = 1 << logt;
    const long long twbase = (1LL << (s0 + i)) + ((long long)g << i);
    for (int j = threadIdx.x; j < L / 2; j += blockDim.x) {
      const int blk = j >> logt;
      const int u = (blk << (logt + 1)) + (j & (t - 1));
      const long long tw = twbase + blk;
      const u64 U = sh[u], V = sh[u + t];
      const u64 O = csub(U + q2 - V, q2);
      sh[u + t] = shoup_mul(O, wc[tw], wpc[tw], q);
      sh[u] = csub(U + V, q2);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    u64 v = sh[i];
    if (nw != nullptr) {
      v = shoup_mul(v, nw[c], nwp[c], q);
      if (post_reduce) v = reduce_q(v, q);
    }
    dst[i] = v;
  }
}

int launch_inv_regs(int r, dim3 grid, cudaStream_t st, u64* data, int logN,
                    int s0, const u64* w, const u64* wp, const u64* q,
                    const u64* nw, const u64* nwp, int post_reduce) {
  switch (r) {
    case 1:
      inv_regs<1><<<grid, kRegThreads, 0, st>>>(data, logN, s0, w, wp, q, nw,
                                                nwp, post_reduce);
      break;
    case 2:
      inv_regs<2><<<grid, kRegThreads, 0, st>>>(data, logN, s0, w, wp, q, nw,
                                                nwp, post_reduce);
      break;
    default:
      inv_regs<3><<<grid, kRegThreads, 0, st>>>(data, logN, s0, w, wp, q, nw,
                                                nwp, post_reduce);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, C, N] with element strides (sb, sc, 1). y: contiguous [B, C, N].
// w, wp: twiddle bank and Shoup quotients, [C, N] contiguous. q: [C].
// ew, ewp: [C] Shoup constant for the entry multiply, or null.
extern "C" int ltt_ntt_fwd(const void* x, long long sb, long long sc, void* y,
                           int B, int C, int logN, const void* w,
                           const void* wp, const void* q, const void* ew,
                           const void* ewp, int post_reduce, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int logL = tile_log(logN);
  const u64* src = (const u64*)x;
  u64* out = (u64*)y;
  const u64* enter_w = (const u64*)ew;
  const u64* enter_wp = (const u64*)ewp;
  const int rc = bfly::fwd_top(src, sb, sc, out, B, C, logN, (const u64*)w,
                               (const u64*)wp, (const u64*)q, enter_w,
                               enter_wp, st);
  if (rc != 0) return rc;
  fwd_smem<<<dim3(1u << (logN - logL), C, B), tile_threads(logL),
             sizeof(u64) << logL, st>>>(
      src, sb, sc, out, logN, logL, (const u64*)w, (const u64*)wp,
      (const u64*)q, enter_w, enter_wp, post_reduce);
  return (int)cudaGetLastError();
}

// nw, nwp: [C] Shoup constant of the final normalisation (N^-1, or
// N^-1 R^-1 for the fused Montgomery exit). post_reduce: [0, 2q) -> [0, q).
extern "C" int ltt_ntt_inv(const void* x, long long sb, long long sc, void* y,
                           int B, int C, int logN, const void* w,
                           const void* wp, const void* q, const void* nw,
                           const void* nwp, int post_reduce, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int logL = tile_log(logN);
  const int s_top = logN - logL;
  u64* out = (u64*)y;
  const bool last = s_top == 0;
  inv_smem<<<dim3(1u << s_top, C, B), tile_threads(logL), sizeof(u64) << logL,
             st>>>(
      (const u64*)x, sb, sc, out, logN, logL, (const u64*)w, (const u64*)wp,
      (const u64*)q, last ? (const u64*)nw : nullptr,
      last ? (const u64*)nwp : nullptr, post_reduce);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  for (int s_hi = s_top; s_hi > 0;) {
    const int r = s_hi < 3 ? s_hi : 3;
    const int s0 = s_hi - r;
    rc = launch_inv_regs(r, regs_grid(logN, r, C, B), st, out, logN, s0,
                         (const u64*)w, (const u64*)wp, (const u64*)q,
                         s0 == 0 ? (const u64*)nw : nullptr,
                         s0 == 0 ? (const u64*)nwp : nullptr, post_reduce);
    if (rc != 0) return rc;
    s_hi = s0;
  }
  return 0;
}
