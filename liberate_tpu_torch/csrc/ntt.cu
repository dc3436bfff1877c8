// Forward and inverse negacyclic NTT over a batch [B, C, N] of 62-bit words.
//
// Replaces: liberate_tpu/ntt/pallas_ntt.py `_ntt_kernel` (:534) and
// `_intt_kernel` (:577) in both twiddle forms (the plan's: Shoup-form
// twiddles, use_shoup_twiddles, or Montgomery-form ones, `_tw_mul` :124),
// the forward's pre_enter and pre_canon modes (:541-563) and the
// inverse's no_norm mode (:1112) among them. Same butterfly network, same
// lazy [0, 2q) representatives: Cooley-Tukey forward with natural-order
// input and bit-reversed output, Gentleman-Sande inverse, twiddle of stage
// s and block b at bank entry 2^s + b. Only the order in which independent
// butterflies run differs from the twins (ntt/cuda_ntt.py).
//
// What bounds it on the H100: the 64-bit integer arithmetic on the CUDA
// cores. Each butterfly is one Shoup product (sixteen 32-bit
// multiply-adds; a Montgomery product with Montgomery twiddles) and two
// conditional subtracts, N/2 * logN of them per polynomial; a transform
// moves each word through device memory once (16 bytes a word) plus the
// channel's twiddles and quotients (16 bytes a word, 8 with Montgomery
// twiddles, shared by the batch). Measured (bfly_variants.py): the same
// butterflies with every load and store of words and twiddles removed
// take about 80 % of the kernel's time at gold.
//
// Design (Hopper): one thread-block cluster of K CTAs per (b, c) channel,
// as the Pallas kernel holds one channel in VMEM per grid step. CTA k
// holds the contiguous chunk k of M = N / K words in shared memory, so a
// transform passes through device memory once: K = 1 up to logN 14
// (at most 2^14 words, 128 KB, a CTA), 2 at 15, and 8 from 16 on (64 KB
// chunks and two CTAs per SM at 16, 128 KB at 17).
//
// - The cross-chunk phase works on columns: log2 K stages combine only
//   the K words N / K apart, and the first few local stages (`fold`) only
//   the 2^fold words of a column within a chunk, so a column of at most
//   8 words runs them all in one thread's registers. Forward: a thread
//   reads its columns (coalesced across the warp) in batches of 8 words,
//   applies the entry multiply, runs the column's stages and writes each
//   word to its CTA's shared memory, through the cluster's distributed
//   shared memory; one cluster barrier.
// - The remaining local stages run on the CTA's chunk in register passes
//   of four stages: 16 words a group, one stage's twiddle pairs at a
//   time. After the first pass (or the folded stages) the chunk falls
//   apart into independent blocks, and teams of 128 threads each finish
//   their own blocks between named barriers. The forward then stores the
//   chunk in coalesced 16-byte stores, reduced if asked.
// - Inverse, the mirror: its first pass reads the 16 neighbouring words of
//   a group straight from device memory (16-byte loads, so the input must
//   be 16-byte aligned), the passes run down to the folded stages, one
//   cluster barrier, then each thread reads its columns across the
//   cluster, runs their stages, the N^-1 (or N^-1 R^-1) multiply and the
//   reduce, and stores coalesced. A last cluster barrier keeps every CTA's
//   shared memory alive until its peers have read it.
// - Shared memory holds word i at swz(i), i with bits 4-7 XORed into bits
//   0-3: every half-warp access of the passes, of the columns and of the
//   forward's store falls on 16 distinct 8-byte bank pairs (without it
//   the gold forward is 25 % slower).
// - Grid (K * B, C): the B polynomials of a channel are neighbours, so the
//   channel's twiddles come from device memory about once and then from
//   L2.
//
// - The twiddle form is a template policy (bfly.cuh ShoupTw, MontTw): each
//   kernel is built in both, and the launch picks the plan's; the
//   forward's canon pre-stage is a template flag too. The Montgomery
//   entry and the inverse's Montgomery exit are per-launch modes outside
//   the butterflies.
//
// The device code of the transform is in bfly.cuh, which the unsplit
// switch core (ntt_mulacc.cu) shares: this file holds the kernels, their
// epilogues and their launches.
#include "bfly.cuh"

namespace {

using namespace bfly;

// x: [B, C, N] with element strides (sb, sc, 1); y: contiguous [B, C, N].
// Block (b * K + k, c) is CTA k of the cluster of channel (b, c). CANON:
// the canon pre-stage by s; else the Montgomery entry by s (and sp for a
// Shoup entry) where `enter`.
template <int LOGK, int FOLD, class TW, bool CANON>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ntt_fwd_cluster(const u64* __restrict__ x, long long sb, long long sc,
                    u64* __restrict__ y, int logN, const u64* __restrict__ w,
                    const u64* __restrict__ wp, const u64* __restrict__ qv,
                    const u64* __restrict__ kv, const u64* __restrict__ s,
                    const u64* __restrict__ sp, int enter, int post_reduce) {
  extern __shared__ __align__(16) u64 sh[];
  constexpr int K = 1 << LOGK;
  const Geometry geo = geometry(logN);
  const int M = 1 << geo.logM;
  const int rank = blockIdx.x & (K - 1);
  const int b = blockIdx.x >> LOGK, c = blockIdx.y;
  const long long N = 1LL << logN;
  const u64 q = qv[c];
  const TW tw = twiddles<TW>(w, wp, c * N, q, kv[c]);
  const Entry e{enter != 0, s ? s[c] : 0, CANON ? kv[c] : sp ? sp[c] : 0};
  fwd_chunk<LOGK, FOLD, CANON>(geo, sh, x + b * sb + c * sc, rank, tw, e,
                               false);

  // The chunk to device memory in coalesced 16-byte stores, reduced if
  // asked.
  u64* dst = y + ((long long)b * gridDim.y + c) * N + (long long)rank * M;
  for (int p = threadIdx.x; 2 * p < M; p += blockDim.x) {
    u64 lo, hi;
    word_pair(sh, p, lo, hi);
    if (post_reduce) {
      lo = cond_sub(lo, q);
      hi = cond_sub(hi, q);
    }
    *reinterpret_cast<ulonglong2*>(dst + 2 * p) = make_ulonglong2(lo, hi);
  }
}

// x: [B, C, N] with element strides (sb, sc, 1), 16-byte aligned rows;
// y: contiguous [B, C, N]. nw, nwp: the final normalisation multiply (TW's
// scale), or null for none (the no-normalise mode: lazy [0, 2q) words of
// the last stage); post_exit: a Montgomery reduce after it.
template <int LOGK, int FOLD, class TW>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ntt_inv_cluster(const u64* __restrict__ x, long long sb, long long sc,
                    u64* __restrict__ y, int logN, const u64* __restrict__ w,
                    const u64* __restrict__ wp, const u64* __restrict__ qv,
                    const u64* __restrict__ kv, const u64* __restrict__ nw,
                    const u64* __restrict__ nwp, int post_exit,
                    int post_reduce) {
  extern __shared__ __align__(16) u64 sh[];
  using X = Cross<LOGK, FOLD>;
  constexpr int K = 1 << LOGK, W = X::W;
  const Geometry geo = geometry(logN);
  const int logM = geo.logM, M = 1 << logM, t = M >> FOLD;
  const int rank = blockIdx.x & (K - 1);
  const int b = blockIdx.x >> LOGK, c = blockIdx.y;
  const long long N = 1LL << logN;
  const u64 q = qv[c];
  const TW tw = twiddles<TW>(w, wp, c * N, q, kv[c]);
  const u64* src = x + b * sb + c * sc + (long long)rank * M;
  u64* dst = y + ((long long)b * gridDim.y + c) * N;

  // Local stages logN-1 .. LOGK+FOLD: the passes of four, each team on
  // its part, the first from device memory; then a last pass over the CTA
  // for the stages the columns do not run.
  int r0 = logM - kPass;
  local<kPass, false, kFromGlobal>(geo.teams, sh, logM, r0, LOGK, rank, tw,
                                   src);
  for (r0 -= kPass; r0 >= geo.first; r0 -= kPass) {
    team_sync(geo.teams);
    local<kPass, false, kShared>(geo.teams, sh, logM, r0, LOGK, rank, tw,
                                 nullptr);
  }
  if constexpr (FOLD == 0) {
    __syncthreads();
    local_first<false>(geo.first, sh, logM, LOGK, rank, tw);
  }

  if constexpr (LOGK > 0)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // The cross-chunk phase, in batches of a thread's columns (32 words):
  // each batch read first from its CTAs, through stages LOGK+FOLD-1 .. 0,
  // the normalisation and the reduce; coalesced stores.
  const int cols = (t >> LOGK) / blockDim.x;
  const int j0 = rank * (t >> LOGK) + threadIdx.x;
  const bool norm = nw != nullptr;
  const u64 a = norm ? nw[c] : 0, ap = nwp ? nwp[c] : 0;
  constexpr int kBatch = 4 * kMaxColumn / W;
#pragma unroll 1
  for (int h = 0; h < cols; h += kBatch) {
    u64 v[kBatch][W];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      if (h + it >= cols) break;
#pragma unroll
      for (int i = 0; i < W; ++i)
        v[it][i] = X::load(sh, j0 + (h + it) * blockDim.x, i, t);
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      if (h + it >= cols) break;
      if constexpr (W > 1)
        network<LOGK + FOLD, false>(v[it], 0, 0, tw);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        u64 o = norm ? tw.scale(v[it][i], a, ap) : v[it][i];
        // A Shoup plan's normalisation constant carries the exit.
        if constexpr (TW::kMont) {
          if (post_exit) o = montmul(o, 1, q, tw.k);
        }
        if (post_reduce) o = cond_sub(o, q);
        dst[j0 + (h + it) * blockDim.x + (long long)i * t] = o;
      }
    }
  }
  if constexpr (LOGK > 0) cg::this_cluster().sync();
}

typedef void (*Kernel)(const u64*, long long, long long, u64*, int,
                       const u64*, const u64*, const u64*, const u64*,
                       const u64*, const u64*, int, int);

template <int LOGK, int FOLD, class TW, bool CANON>
Kernel kernel(bool fwd) {
  return fwd ? ntt_fwd_cluster<LOGK, FOLD, TW, CANON>
             : ntt_inv_cluster<LOGK, FOLD, TW>;
}

// The kernels of the (logK, fold) pairs of logN 8-17 in the twiddle form
// TW (the forward with the canon pre-stage where CANON).
template <class TW, bool CANON>
Kernel kernel_of(const Geometry& g, bool fwd) {
  switch (g.logK * 8 + g.fold) {
    case 0: return kernel<0, 0, TW, CANON>(fwd);
    case 1: return kernel<0, 1, TW, CANON>(fwd);
    case 2: return kernel<0, 2, TW, CANON>(fwd);
    case 3: return kernel<0, 3, TW, CANON>(fwd);
    case 8 + 2: return kernel<1, 2, TW, CANON>(fwd);
    case 24 + 0: return kernel<3, 0, TW, CANON>(fwd);
    default: return nullptr;
  }
}

// One cluster launch: checks once per kernel and logN that a cluster of K
// CTAs with the chunk's shared memory can be scheduled. wp null:
// Montgomery twiddles. mode: the forward's entry (0 none, 1 the Montgomery
// entry, 2 the canon pre-stage) or the inverse's Montgomery exit.
int launch(bool fwd, const void* x, long long sb, long long sc, void* y,
           int B, int C, int logN, const void* w, const void* wp,
           const void* q, const void* k, const void* s, const void* sp,
           int mode, int post_reduce, void* stream) {
  if (logN < kMinLogN || logN > kMaxLogN) return -1;
  static bool checked[2][2][2][kMaxLogN + 1];
  const bool mont = wp == nullptr, canon = fwd && mode == 2;
  const Geometry g = geometry(logN);
  const Kernel kern =
      mont ? (canon ? kernel_of<MontTw, true>(g, fwd)
                    : kernel_of<MontTw, false>(g, fwd))
           : (canon ? kernel_of<ShoupTw, true>(g, fwd)
                    : kernel_of<ShoupTw, false>(g, fwd));
  if (kern == nullptr) return -1;
  ClusterLaunch l;
  int rc = l.init((const void*)kern, g, (unsigned)B, (unsigned)C, stream,
                  checked[mont][canon][fwd][logN]);
  if (rc != 0) return rc;
  rc = (int)cudaLaunchKernelEx(
      &l.cfg, kern, (const u64*)x, sb, sc, (u64*)y, logN, (const u64*)w,
      (const u64*)wp, (const u64*)q, (const u64*)k, (const u64*)s,
      (const u64*)sp, canon ? 0 : mode, post_reduce);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, C, N] with element strides (sb, sc, 1). y: contiguous [B, C, N].
// w, wp: twiddle bank and Shoup quotients, [C, N] contiguous; wp null for
// a Montgomery-form bank. q, k: [C] modulus and -q^-1 mod 2^62.
// pre: 0, or 1 for the Montgomery entry by (s, sp) ([C]: R mod q and its
// quotient; R^2 mod q with Montgomery twiddles, sp null), or 2 for the
// canon pre-stage (s: R mod q).
// Returns 0, a CUDA error, -1 for logN outside 8-17, or -2 when the
// cluster cannot be scheduled.
extern "C" int ltt_ntt_fwd(const void* x, long long sb, long long sc, void* y,
                           int B, int C, int logN, const void* w,
                           const void* wp, const void* q, const void* k,
                           const void* s, const void* sp, int pre,
                           int post_reduce, void* stream) {
  return launch(true, x, sb, sc, y, B, C, logN, w, wp, q, k, s, sp, pre,
                post_reduce, stream);
}

// nw, nwp: [C] constant of the final normalisation, or null to skip it
// (the coefficient-sharded inverse normalises after its cross-shard
// stages): a Shoup pair (N^-1, or N^-1 R^-1 for the fused Montgomery
// exit), or with Montgomery twiddles N^-1 R mod q (nwp null) and then
// `post_exit` for a Montgomery reduce after it. post_reduce: [0, 2q) ->
// [0, q).
// x must be 16-byte aligned with even strides.
extern "C" int ltt_ntt_inv(const void* x, long long sb, long long sc, void* y,
                           int B, int C, int logN, const void* w,
                           const void* wp, const void* q, const void* k,
                           const void* nw, const void* nwp, int post_exit,
                           int post_reduce, void* stream) {
  return launch(false, x, sb, sc, y, B, C, logN, w, wp, q, k, nw, nwp,
                post_exit, post_reduce, stream);
}

// The launch geometry at logN into out (at least 16 ints, as
// bfly.cuh's geometry_out lays them out). -1 outside logN 8-17.
extern "C" int ltt_ntt_geometry(int logN, int* out) {
  if (logN < kMinLogN || logN > kMaxLogN) return -1;
  geometry_out(geometry(logN), out);
  return 0;
}
