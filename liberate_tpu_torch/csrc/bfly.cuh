// The butterfly cluster transform's device code, shared by the forward
// and inverse transforms (ntt.cu, kernels #1 and #2) and the unsplit
// switch core (ntt_mulacc.cu, kernel #4): the launch geometry, the
// butterflies with their twiddle multiply as a compile-time policy (Shoup
// or Montgomery twiddles), the register passes of four stages over a CTA's
// chunk in swizzled shared memory, the cross-chunk columns through the
// cluster's distributed shared memory, and the forward transform of one
// channel's chunk (fwd_chunk) with its entry multiply or canon pre-stage,
// whose caller decides what becomes of the words it leaves in shared
// memory. ntt.cu's header comment gives the design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

#include "modarith.cuh"

namespace bfly {

namespace cg = cooperative_groups;

constexpr int kLogChunk = 14;  // log2 of the most words of a CTA's chunk
constexpr int kMinLogN = 8;
constexpr int kMaxLogN = 17;
constexpr int kMaxLogK = 3;    // K = 8, the portable cluster limit
// From this logN on K = 8: at logN 16 chunks of 2^13 words (64 KB), two
// CTAs per SM, measured faster than K = 4 with one (bfly_variants.py).
constexpr int kFullClusterLogN = 16;
constexpr int kLogWords = 5;   // a thread per 2^5 words of the chunk
constexpr int kMaxThreads = 512;
constexpr int kPass = 4;       // stages of a register pass
constexpr int kTeamThreads = 128;
constexpr int kMaxColumn = 8;  // most words of a column (16 spill)
constexpr int kUnschedulable = -2;

// The launch of one transform at logN with clusters of 2^logK CTAs (as
// ntt/cuda_ntt.py's bfly_geometry computes it): log2 of the CTAs per
// cluster and of the chunk, threads per CTA (one per 32 words of the
// chunk), dynamic shared memory, the local stages before the first pass of
// kPass (1 to kPass), how many of them the cross-chunk phase runs in its
// registers (all of them, when a column of K << fold words stays within
// kMaxColumn and a thread's share of the chunk, else none: a first local
// pass runs them), the local passes, and the teams of 128 threads that run
// the passes of kPass each on its own part of the chunk.
struct Geometry {
  int logK, logM, threads, smem, first, fold, passes, teams;
};

__host__ __device__ constexpr Geometry geometry_k(int logN, int logK) {
  const int logM = logN - logK;
  const int threads =
      (1 << logM) >> kLogWords < 32 ? 32 : (1 << logM) >> kLogWords;
  const int first = logM - kPass * ((logM - 1) / kPass);
  const int teams = threads / kTeamThreads < 1 ? 1 : threads / kTeamThreads;
  const int column = 1 << (logK + first);
  const int fold =
      column <= kMaxColumn && column <= (1 << logM) / threads ? first : 0;
  return Geometry{logK,
                  logM,
                  threads,
                  8 << logM,
                  first,
                  fold,
                  (logM - first) / kPass + (fold == first ? 0 : 1),
                  teams > 1 << first ? 1 << first : teams};
}

// The transforms' own clusters: chunks of at most 2^kLogChunk words, and
// K = 2^kMaxLogK from kFullClusterLogN on.
__host__ __device__ constexpr Geometry geometry(int logN) {
  return geometry_k(logN, logN >= kFullClusterLogN ? kMaxLogK
                          : logN < kLogChunk      ? 0
                                                  : logN - kLogChunk);
}

// The columns of the cross-chunk phase each thread of a CTA runs (every
// thread as many; the phase's cluster wait follows a thread's first loads,
// so a launch needs at least one).
__host__ __device__ constexpr int columns(const Geometry& g) {
  return ((1 << g.logM) >> g.fold >> g.logK) / g.threads;
}

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

// The word arithmetic of modarith.cuh in fewer instructions, the same
// words: the kernel is bound by its integer instructions.
//
// shoup_mul(x, w, wp, q) = x*w - floor(x*wp / 2^64)*q mod 2^64 for any x,
// with nq = 2^64 - q, in sixteen 32-bit multiply-adds and no moves: the
// high half of x*wp through a carry chain, then the low 64 bits of
// x*w + hi*nq.
__device__ __forceinline__ u64 shoup(u64 x, u64 w, u64 wp, u64 nq) {
  u64 r;
  asm("{\n"
      ".reg .u32 x0, x1, w0, w1, p0, p1, n0, n1, t, a, b, c, h0, h1, r0, r1;\n"
      "mov.b64 {x0, x1}, %1;\n"
      "mov.b64 {w0, w1}, %2;\n"
      "mov.b64 {p0, p1}, %3;\n"
      "mov.b64 {n0, n1}, %4;\n"
      "mul.hi.u32 t, x0, p0;\n"
      "mad.lo.cc.u32 a, x0, p1, t;\n"
      "madc.hi.u32 b, x0, p1, 0;\n"
      "mad.lo.cc.u32 a, x1, p0, a;\n"
      "madc.hi.cc.u32 b, x1, p0, b;\n"
      "addc.u32 c, 0, 0;\n"
      "mad.lo.cc.u32 h0, x1, p1, b;\n"
      "madc.hi.u32 h1, x1, p1, c;\n"
      "mul.lo.u32 r0, x0, w0;\n"
      "mul.hi.u32 r1, x0, w0;\n"
      "mad.lo.cc.u32 r0, h0, n0, r0;\n"
      "madc.hi.u32 r1, h0, n0, r1;\n"
      "mad.lo.u32 r1, x0, w1, r1;\n"
      "mad.lo.u32 r1, x1, w0, r1;\n"
      "mad.lo.u32 r1, h0, n1, r1;\n"
      "mad.lo.u32 r1, h1, n0, r1;\n"
      "mov.b64 %0, {r0, r1};\n"
      "}\n"
      : "=l"(r)
      : "l"(x), "l"(w), "l"(wp), "l"(nq));
  return r;
}

// csub(v, m) for v, m < 2^63: the signed compare v < m is the sign of
// v - m, which the subtract computes anyway.
__device__ __forceinline__ u64 cond_sub(u64 v, u64 m) {
  const u64 d = v - m;
  return (long long)d < 0 ? v : d;
}

// The twiddle multiply of the butterflies, a compile-time policy of every
// kernel (no branch on the form inside a butterfly). ShoupTw: plain
// twiddles and their Shoup quotients, two words a twiddle (the JAX
// package's use_shoup_twiddles); MontTw: Montgomery-form twiddles, one word
// a twiddle, multiplied as the reference's chain does (montmul(twiddle,
// word)). Each holds one channel's bank and constants; scale() is the
// entry or normalisation multiply by a per-channel constant (a, ap) in the
// same form (ap unused by MontTw).
struct ShoupTw {
  static constexpr bool kMont = false;
  const u64* __restrict__ w;
  const u64* __restrict__ wp;
  u64 q, nq;
  struct T {
    u64 w, wp;
  };
  // The bank and quotients of the channel at element offset off.
  __device__ ShoupTw(const u64* w_, const u64* wp_, long long off, u64 q_)
      : w(w_ + off), wp(wp_ + off), q(q_), nq(0 - q_) {}
  __device__ __forceinline__ T at(int e) const {
    return T{__ldg(w + e), __ldg(wp + e)};
  }
  // Entries e + kk and e + kk + 1 (even) in 16-byte loads; kk, a
  // compile-time constant, goes into the loads' address offsets.
  __device__ __forceinline__ void two(int e, int kk, T& a, T& b) const {
    const ulonglong2 v =
        __ldg(reinterpret_cast<const ulonglong2*>(w + e + kk));
    const ulonglong2 vp =
        __ldg(reinterpret_cast<const ulonglong2*>(wp + e + kk));
    a = T{v.x, vp.x};
    b = T{v.y, vp.y};
  }
  __device__ __forceinline__ u64 mul(u64 x, const T& t) const {
    return shoup(x, t.w, t.wp, nq);
  }
  __device__ __forceinline__ u64 scale(u64 x, u64 a, u64 ap) const {
    return shoup(x, a, ap, nq);
  }
};

struct MontTw {
  static constexpr bool kMont = true;
  const u64* __restrict__ w;
  u64 q, k;
  typedef u64 T;
  __device__ MontTw(const u64* w_, const u64*, long long off, u64 q_, u64 k_)
      : w(w_ + off), q(q_), k(k_) {}
  __device__ __forceinline__ T at(int e) const { return __ldg(w + e); }
  __device__ __forceinline__ void two(int e, int kk, T& a, T& b) const {
    const ulonglong2 v =
        __ldg(reinterpret_cast<const ulonglong2*>(w + e + kk));
    a = v.x;
    b = v.y;
  }
  __device__ __forceinline__ u64 mul(u64 x, const T& t) const {
    return montmul(t, x, q, k);
  }
  __device__ __forceinline__ u64 scale(u64 x, u64 a, u64) const {
    return montmul(x, a, q, k);
  }
};

// The policy of channel c (k = -q^-1 mod 2^62 for the Montgomery form).
template <class TW>
__device__ __forceinline__ TW twiddles(const u64* w, const u64* wp,
                                       long long off, u64 q, u64 k) {
  if constexpr (TW::kMont)
    return TW(w, wp, off, q, k);
  else
    return TW(w, wp, off, q);
}

// Words below 4q < 2^63 throughout (q < 2^61).
template <class TW>
__device__ __forceinline__ void ct(u64& a, u64& b, const typename TW::T& t,
                                   const TW& tw) {
  const u64 U = a, V = tw.mul(b, t);
  a = cond_sub(U + V, 2 * tw.q);
  b = cond_sub(U + 2 * tw.q - V, 2 * tw.q);
}

template <class TW>
__device__ __forceinline__ void gs(u64& a, u64& b, const typename TW::T& t,
                                   const TW& tw) {
  const u64 U = a, V = b;
  b = tw.mul(cond_sub(U + 2 * tw.q - V, 2 * tw.q), t);
  a = cond_sub(U + V, 2 * tw.q);
}

// The entry of a forward transform, applied to each word as it is read:
// with CANON the canon pre-stage (a = R mod q, ap = k = -q^-1 mod 2^62:
// the basis extension's signed words to [0, 2q) by a signed Montgomery
// product and + 2q where negative; the JAX kernel's pre_canon, in either
// twiddle form), else the Montgomery entry where `enter` (x R: TW's scale
// by (a, ap), R mod q and its quotient, or R^2 mod q).
struct Entry {
  bool enter;
  u64 a, ap;
};

template <bool CANON, class TW>
__device__ __forceinline__ u64 entry(u64 x, const Entry& e, const TW& tw) {
  if constexpr (CANON) {
    const u64 r = montmul_signed(x, e.a, tw.q, e.ap);
    return (long long)r < 0 ? r + 2 * tw.q : r;
  } else {
    return e.enter ? tw.scale(x, e.a, e.ap) : x;
  }
}

// Stage s+I of the 2^R words x of one butterfly group of block g (its
// index at stage s): word k is in sub-block k >> (R - I), whose twiddle
// is entry 2^(s+I) + (g << I) + (k >> (R - I)) of the bank. The stage's
// 2^I twiddles are neighbours, read just before it (16 bytes at a time
// from I = 1 on), so one stage's twiddles are in registers at a time.
template <int R, bool FWD, int I, class TW>
__device__ __forceinline__ void stage(u64 (&x)[1 << R], int s, int g,
                                      const TW& tw) {
  constexpr int W = 1 << R, kHalf = W >> (I + 1), kT = 1 << I;
  const int e = (1 << (s + I)) + (g << I);
  typename TW::T t[kT];
  if constexpr (I == 0) {
    t[0] = tw.at(e);
  } else {
#pragma unroll
    for (int kk = 0; kk < kT; kk += 2) tw.two(e, kk, t[kk], t[kk + 1]);
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k & kHalf) continue;
    if (FWD)
      ct(x[k], x[k + kHalf], t[k >> (R - I)], tw);
    else
      gs(x[k], x[k + kHalf], t[k >> (R - I)], tw);
  }
}

template <int R, bool FWD, class TW, int... I>
__device__ __forceinline__ void stages(u64 (&x)[1 << R], int s, int g,
                                       const TW& tw,
                                       std::integer_sequence<int, I...>) {
  (stage<R, FWD, FWD ? I : R - 1 - I>(x, s, g, tw), ...);
}

// Stages s .. s+R-1 (forward, Cooley-Tukey) or s+R-1 .. s (inverse,
// Gentleman-Sande) on the 2^R words of one butterfly group of block g.
template <int R, bool FWD, class TW>
__device__ __forceinline__ void network(u64 (&x)[1 << R], int s, int g,
                                        const TW& tw) {
  stages<R, FWD>(x, s, g, tw, std::make_integer_sequence<int, R>{});
}

enum Io { kShared = 0, kFromGlobal = 1 };

// Barrier of the team of this thread (named barrier 1 + team), or of the
// whole CTA when there is one team. teams and blockDim.x are powers of
// two.
__device__ __forceinline__ void team_sync(int teams) {
  if (teams == 1) {
    __syncthreads();
  } else {
    const int size = blockDim.x >> (__ffs(teams) - 1);
    asm volatile("bar.sync %0, %1;\n" ::"r"(
                     1 + (int)(threadIdx.x >> (__ffs(size) - 1))),
                 "r"(size)
                 : "memory");
  }
}

// One register pass of R stages on the CTA's chunk in shared memory,
// local stages r0 .. r0+R-1 (global s = logK + r0), rank the CTA's chunk,
// over the groups of this thread's team (of `teams`, each on its 1/teams
// of the chunk: its threads and groups found with shifts, teams and
// blockDim.x being powers of two). kFromGlobal (inverse, first pass)
// reads the 2^R neighbouring words of a group (r0 = logM - R) from device
// memory.
template <int R, bool FWD, int IO, class TW>
__device__ __forceinline__ void local(int teams, u64* sh, int logM, int r0,
                                      int logK, int rank, const TW& tw,
                                      const u64* src) {
  constexpr int W = 1 << R;
  const int logt = logM - r0 - R;
  const int lt = __ffs(teams) - 1, size = blockDim.x >> lt;
  const int lo = (threadIdx.x >> (__ffs(size) - 1)) << (logM - R - lt);
  const int end = lo + (1 << (logM - R - lt));
#pragma unroll 1
  for (int g = lo + (threadIdx.x & (size - 1)); g < end; g += size) {
    const int blk = g >> logt;
    const int base = (blk << (logt + R)) | (g & ((1 << logt) - 1));
    // swz is linear over XOR and base has no bit where k << logt has one:
    // swz(base + (k << logt)) = swz(base) ^ swz(k << logt).
    u64 x[W];
    if (IO == kFromGlobal) {
      const ulonglong2* p = reinterpret_cast<const ulonglong2*>(src + base);
#pragma unroll
      for (int k = 0; k < W / 2; ++k) {
        const ulonglong2 v = p[k];
        x[2 * k] = v.x;
        x[2 * k + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) x[k] = sh[swz(base) ^ swz(k << logt)];
    }
    network<R, FWD>(x, logK + r0, (rank << r0) + blk, tw);
#pragma unroll
    for (int k = 0; k < W; ++k) sh[swz(base) ^ swz(k << logt)] = x[k];
  }
}

// The first local pass (R = 1 .. kPass stages from local stage 0) over
// the whole CTA.
template <bool FWD, class TW>
__device__ __forceinline__ void local_first(int R, u64* sh, int logM,
                                            int logK, int rank,
                                            const TW& tw) {
  switch (R) {
    case 1:
      local<1, FWD, kShared>(1, sh, logM, 0, logK, rank, tw, nullptr);
      break;
    case 2:
      local<2, FWD, kShared>(1, sh, logM, 0, logK, rank, tw, nullptr);
      break;
    case 3:
      local<3, FWD, kShared>(1, sh, logM, 0, logK, rank, tw, nullptr);
      break;
    default:
      local<4, FWD, kShared>(1, sh, logM, 0, logK, rank, tw, nullptr);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cross-chunk phase works on columns: column j < t = M >> FOLD holds
// the W = K << FOLD words j + i * t of the channel, which the first
// LOGK + FOLD stages combine among themselves only. Word i lives in CTA
// i >> FOLD's chunk at offset j + (i % 2^FOLD) * t. CTA k runs the
// columns [k * t / K, (k + 1) * t / K), a thread those j0 + it * blockDim.
template <int LOGK, int FOLD>
struct Cross {
  static constexpr int W = 1 << (LOGK + FOLD);
  // The shared-memory address of word i of column j, in its CTA's window
  // of the cluster when K > 1 (32-bit addresses, mapped at each access).
  __device__ static uint32_t at(const u64* sh, int j, int i, int t) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(
        sh + swz(j + (i & ((1 << FOLD) - 1)) * t));
    if constexpr (LOGK == 0) return a;
    uint32_t r;
    asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
        : "=r"(r)
        : "r"(a), "r"(i >> FOLD));
    return r;
  }
  __device__ static void store(const u64* sh, int j, int i, int t, u64 v) {
    asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(at(sh, j, i, t)),
                 "l"(v)
                 : "memory");
  }
  __device__ static u64 load(const u64* sh, int j, int i, int t) {
    u64 v;
    asm volatile("ld.shared::cluster.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "r"(at(sh, j, i, t))
                 : "memory");
    return v;
  }
};

// The forward transform of one channel's N words at src (natural order,
// Cooley-Tukey, bit-reversed lazy [0, 2q) output), each word through the
// entry `pre` first: CTA `rank` of the cluster is left
// with words rank * M .. rank * M + M - 1 of the output in its shared
// memory sh, word i at swz(i), behind a CTA barrier. `again`: the CTAs
// ran a transform before into the same shared memory and may still be
// reading its words; the first cluster barrier then releases those reads
// before any peer writes (at K = 1, a CTA barrier).
template <int LOGK, int FOLD, bool CANON, class TW>
__device__ __forceinline__ void fwd_chunk(const Geometry& geo, u64* sh,
                                          const u64* src, int rank,
                                          const TW& tw, const Entry& pre,
                                          bool again) {
  using X = Cross<LOGK, FOLD>;
  constexpr int W = X::W;
  const int logM = geo.logM, M = 1 << logM, t = M >> FOLD;

  // A peer's shared memory may be written once every CTA has started (and
  // has read its last transform's words).
  if constexpr (LOGK > 0) {
    if (again)
      cluster_arrive();
    else
      cluster_arrive_relaxed();
  } else if (again) {
    __syncthreads();
  }

  // The cross-chunk phase, in batches of a thread's columns (8 words):
  // each batch's words loaded first, entered, through stages
  // 0 .. LOGK+FOLD-1, each word to its CTA. (All 32 of a thread's words
  // at once spill registers.)
  const int cols = (t >> LOGK) / blockDim.x;
  const int j0 = rank * (t >> LOGK) + threadIdx.x;
  constexpr int kBatch = kMaxColumn / W;
#pragma unroll 1
  for (int h = 0; h < cols; h += kBatch) {
    u64 v[kBatch][W];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      if (h + it >= cols) break;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        v[it][i] = entry<CANON>(
            src[j0 + (h + it) * blockDim.x + (long long)i * t], pre, tw);
      }
    }
    if constexpr (W > 1) {
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        if (h + it >= cols) break;
        network<LOGK + FOLD, true>(v[it], 0, 0, tw);
      }
    }
    if constexpr (LOGK > 0) {
      if (h == 0) cluster_wait();
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      if (h + it >= cols) break;
#pragma unroll
      for (int i = 0; i < W; ++i)
        X::store(sh, j0 + (h + it) * blockDim.x, i, t, v[it][i]);
    }
  }
  if constexpr (LOGK > 0)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // Local stages LOGK+FOLD .. logN-1: a first pass over the CTA for the
  // stages the columns did not run, then the passes of four, each team on
  // its part.
  if constexpr (FOLD == 0) {
    local_first<true>(geo.first, sh, logM, LOGK, rank, tw);
    __syncthreads();
  }
  for (int r0 = geo.first; r0 < logM; r0 += kPass) {
    if (r0 > geo.first) team_sync(geo.teams);
    local<kPass, true, kShared>(geo.teams, sh, logM, r0, LOGK, rank, tw,
                                nullptr);
  }
  __syncthreads();
}

// Words 2p and 2p + 1 of a chunk left by fwd_chunk: one aligned pair of
// shared memory, swapped when swz flips bit 0 (bit 4 of 2p set).
__device__ __forceinline__ void word_pair(const u64* sh, int p, u64& lo,
                                          u64& hi) {
  const int at = swz(2 * p);
  const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(sh + (at & ~1));
  lo = at & 1 ? v.y : v.x;
  hi = at & 1 ? v.x : v.y;
}

// The launch of a cluster kernel of geometry g over the grid
// (blocks << g.logK, C): its dynamic shared memory set and, until
// `checked`, checked that a cluster of K CTAs can be scheduled (then
// `checked` is set). init returns 0, a CUDA error or kUnschedulable;
// launch with cudaLaunchKernelEx(&cfg, ...).
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  int init(const void* kern, const Geometry& g, unsigned blocks, unsigned C,
           void* stream, bool& checked) {
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (rc != 0) return rc;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1u << g.logK;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(blocks << g.logK, C, 1);
    cfg.blockDim = dim3((unsigned)g.threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)g.smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (!checked) {
      int clusters = 0;
      rc = (int)cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (rc != 0) return rc;
      if (clusters < 1) return kUnschedulable;
      checked = true;
    }
    return 0;
  }
};

// The geometry g into out (at least 16 ints): CTAs per cluster, threads
// per CTA, shared memory bytes, cross-chunk stages (run in registers
// before the local passes), the number of local register passes, the
// teams of the passes of four, then (first stage, stages) of each pass in
// forward order.
inline void geometry_out(const Geometry& g, int* out) {
  out[0] = 1 << g.logK;
  out[1] = g.threads;
  out[2] = g.smem;
  out[3] = g.logK + g.fold;
  out[4] = g.passes;
  out[5] = g.teams;
  int* p = out + 6;
  if (g.fold != g.first) {
    *p++ = g.logK;
    *p++ = g.first;
  }
  for (int r0 = g.first; r0 < g.logM; r0 += kPass) {
    *p++ = g.logK + r0;
    *p++ = kPass;
  }
}

}  // namespace bfly
