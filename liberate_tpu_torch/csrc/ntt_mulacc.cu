// The butterfly domain's unsplit key-switch core: the forward NTT of every
// gadget part, both key products and the sum over the parts,
//   d0 = sum_p montmul(NTT(x[p])[c, n], k0[part_off + p, level + c, n])
//   d1 = sum_p montmul(NTT(x[p])[c, n], k1[part_off + p, level + c, n])
// with a conditional subtract of 2q after each add (lazy [0, 2q) output).
//
// Replaces: liberate_tpu/ntt/pallas_ntt.py `_ntt_mulacc_kernel` (:614),
// launched by `ntt_ksk_accum` (:782, :810) when config.use_split_switch is
// off, at logN <= 15, in both twiddle forms (bfly.cuh's policies) and
// with or without its canon pre-stage: canon=False after the Shoup basis
// extension (already unsigned [0, 2q)), canon=True after the Montgomery
// one (signed words, config.use_shoup_extend off). Same words as
// ltt_ntt_fwd (in the same entry mode) followed by ltt_ksk_mulacc (the
// split route).
//
// What bounds it on the H100: the P forward transforms' 64-bit integer
// arithmetic (as ltt_ntt_fwd at B = P, bfly_variants.py), then the bytes
// of the products: both key halves read and two sums written a word, at
// the memory rate, with little overlap between the two.
//
// Design (Hopper): the forward kernel of ntt.cu with another epilogue. A
// thread-block cluster of K CTAs holds one (part, channel) transform in
// its shared memory and runs it with the transform's own device code
// (bfly.cuh fwd_chunk: cross-chunk columns through distributed shared
// memory, register passes of four, the swizzle). Where the forward kernel
// stores the chunk, each thread here reads its word pairs, the two key
// halves' pairs in 16-byte streaming loads, takes the four Montgomery
// products and adds them to its part sums.
// - Part groups: the grid is (G * K, C); cluster (g, c) runs parts
//   [g P / G, (g + 1) P / G) of channel c, `held` at a time: each CTA
//   transforms them one after the other into chunks of its shared memory
//   of their own, then adds all their products to its sums in one pass
//   (ntt/cuda_ntt.py's mulacc_geometry chooses K, G and held, measured
//   with bfly_variants.py --mulacc: at silver clusters of 8 holding two
//   parts, G = 5; at bronze clusters of 4, a part a cluster, G = P). Every
//   product and sum is in [0, 2q) and each step csub(s + p, 2q) is
//   (s + p) mod 2q exactly (q < 2^61), so any grouping and order of the
//   parts gives the split route's words.
// - The sums live in device memory, a thread's 16-byte pairs read and
//   written once per part by the thread that owns them: a chunk's 2 x 32
//   sums a thread do not fit its registers beside the transform's (128 a
//   thread), nor its CTA's shared memory beside the chunk at 4 CTAs an SM.
//   Group 0 sums into d0/d1, group g > 0 into part[g - 1]; a second launch
//   adds the G - 1 partial sums to d0/d1 when G > 1, launched early as a
//   programmatic dependent (1-2 % faster, bfly_variants.py --mulacc).
// - Between parts, the next transform's cross-chunk stores go to peers'
//   shared memory that may still be read for the products: fwd_chunk's
//   first cluster barrier then releases those reads (again = true).
//
// Where the time goes at silver (bfly_variants.py --mulacc, H100 80GB
// HBM3 at 700 W): of about 0.17 ms, the transforms about 0.107, the key
// loads and the sums' stores about 0.046 (132 MB, near the memory rate,
// little of it under the transforms), the combine 0.017 (47 MB). The
// Pallas kernel keeps the sums in VMEM; here they go through memory, so
// the kernel moves about as many bytes as the split route, whose time it
// matches (and beats at bronze, where its clusters fill the card).
#include "bfly.cuh"

namespace {

using namespace bfly;

constexpr int kMaxMulaccLogN = 15;   // engine.FUSED_SWITCH_MAX_LOGN
constexpr int kCombineThreads = 256;
constexpr int kMaxHeld = 4;          // parts' chunks a CTA holds at once
constexpr int kMaxSmem = 232448;     // shared memory a CTA may use

// x: [P, C, N] with element strides (x_sp, x_sc, 1). k0, k1: key element
// (part_off, level, 0), element strides (k_sp, k_sc, 1), 16-byte aligned.
// q, kv: [C] modulus and -q^-1 mod 2^62; ident: [C] R mod q for the canon
// pre-stage, or null for none. Block (g * K + k, c) is CTA k of
// the cluster of channel c and part group g (of G = gridDim.x / K).
// d0, d1: contiguous [C, N]; part: contiguous [G - 1, 2, C, N]. A CTA
// holds `held` parts' chunks in its shared memory, transforms that many
// parts one after the other, then adds all their products to the sums.
template <int LOGK, int FOLD, class TW, bool CANON>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ntt_mulacc_cluster(const u64* __restrict__ x, long long x_sp,
                       long long x_sc, int P, int logN,
                       const u64* __restrict__ w, const u64* __restrict__ wp,
                       const u64* __restrict__ qv,
                       const u64* __restrict__ kv,
                       const u64* __restrict__ ident,
                       const u64* __restrict__ k0,
                       const u64* __restrict__ k1, long long k_sp,
                       long long k_sc, u64* d0, u64* d1, u64* part,
                       int held) {
  extern __shared__ __align__(16) u64 sh[];
  constexpr int K = 1 << LOGK;
  const Geometry geo = geometry_k(logN, LOGK);
  const int M = 1 << geo.logM;
  const int rank = blockIdx.x & (K - 1), g = blockIdx.x >> LOGK;
  const int G = gridDim.x >> LOGK;
  const int c = blockIdx.y, C = gridDim.y;
  const long long N = 1LL << logN, CN = C * N;
  const long long off = c * N + (long long)rank * M;
  const u64 q = qv[c], kq = kv[c], q2 = 2 * q;
  const TW tw = twiddles<TW>(w, wp, c * N, q, kq);
  const Entry pre{false, CANON ? ident[c] : 0, kq};
  ulonglong2* s0 =
      reinterpret_cast<ulonglong2*>((g ? part + 2 * (g - 1) * CN : d0) + off);
  ulonglong2* s1 = reinterpret_cast<ulonglong2*>(
      (g ? part + (2 * (g - 1) + 1) * CN : d1) + off);
  const int p0 = g * P / G, p1 = (g + 1) * P / G;
  const u64* kc0 = k0 + c * k_sc + (long long)rank * M;
  const u64* kc1 = k1 + c * k_sc + (long long)rank * M;
#pragma unroll 1
  for (int p = p0; p < p1; p += held) {
    const int r = p1 - p < held ? p1 - p : held;
    for (int j = 0; j < r; ++j)
      fwd_chunk<LOGK, FOLD, CANON>(geo, sh + j * M,
                                   x + (p + j) * x_sp + c * x_sc, rank, tw,
                                   pre, p > p0 && j == 0);
#pragma unroll 2
    for (int i = threadIdx.x; 2 * i < M; i += blockDim.x) {
      ulonglong2 r0, r1;
      for (int j = 0; j < r; ++j) {
        u64 lo, hi;
        word_pair(sh + j * M, i, lo, hi);
        const ulonglong2 e0 =
            __ldcs(reinterpret_cast<const ulonglong2*>(kc0 + (p + j) * k_sp) +
                   i);
        const ulonglong2 e1 =
            __ldcs(reinterpret_cast<const ulonglong2*>(kc1 + (p + j) * k_sp) +
                   i);
        const ulonglong2 t0 = make_ulonglong2(montmul(lo, e0.x, q, kq),
                                              montmul(hi, e0.y, q, kq));
        const ulonglong2 t1 = make_ulonglong2(montmul(lo, e1.x, q, kq),
                                              montmul(hi, e1.y, q, kq));
        if (j == 0) {
          r0 = t0;
          r1 = t1;
        } else {
          r0 = make_ulonglong2(cond_sub(r0.x + t0.x, q2),
                               cond_sub(r0.y + t0.y, q2));
          r1 = make_ulonglong2(cond_sub(r1.x + t1.x, q2),
                               cond_sub(r1.y + t1.y, q2));
        }
      }
      if (p > p0) {
        const ulonglong2 f0 = __ldcg(s0 + i), f1 = __ldcg(s1 + i);
        r0 = make_ulonglong2(cond_sub(f0.x + r0.x, q2),
                             cond_sub(f0.y + r0.y, q2));
        r1 = make_ulonglong2(cond_sub(f1.x + r1.x, q2),
                             cond_sub(f1.y + r1.y, q2));
      }
      __stcg(s0 + i, r0);
      __stcg(s1 + i, r1);
    }
  }
  // The combine may start its CTAs as this grid's retire (it waits for the
  // whole grid's stores before it reads).
  asm volatile("griddepcontrol.launch_dependents;");
}

// d0, d1 [C, N] plus the G1 partial sums part [G1, 2, C, N], mod 2q, a
// thread per 16-byte pair; launched as a programmatic dependent of the
// main kernel, it waits for that grid's completion first.
__global__ void mulacc_combine(u64* d0, u64* d1, const u64* __restrict__ part,
                               int G1, int logN, long long CN,
                               const u64* __restrict__ qv) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (2 * i >= CN) return;
  const u64 q2 = 2 * qv[(2 * i) >> logN];
  ulonglong2* a0 = reinterpret_cast<ulonglong2*>(d0) + i;
  ulonglong2* a1 = reinterpret_cast<ulonglong2*>(d1) + i;
  ulonglong2 s0 = *a0, s1 = *a1;
  for (int g = 0; g < G1; ++g) {
    const ulonglong2 f0 =
        __ldcs(reinterpret_cast<const ulonglong2*>(part + 2 * g * CN) + i);
    const ulonglong2 f1 = __ldcs(
        reinterpret_cast<const ulonglong2*>(part + (2 * g + 1) * CN) + i);
    s0 = make_ulonglong2(cond_sub(s0.x + f0.x, q2), cond_sub(s0.y + f0.y, q2));
    s1 = make_ulonglong2(cond_sub(s1.x + f1.x, q2), cond_sub(s1.y + f1.y, q2));
  }
  *a0 = s0;
  *a1 = s1;
}

typedef void (*Kernel)(const u64*, long long, long long, int, int,
                       const u64*, const u64*, const u64*, const u64*,
                       const u64*, const u64*, const u64*, long long,
                       long long, u64*, u64*, u64*, int);

// The kernels of the (logK, fold) pairs of logN 8-15 and K = 1-8 in the
// twiddle form TW (with the canon pre-stage where CANON).
template <class TW, bool CANON>
Kernel kernel_of(const Geometry& g) {
  switch (g.logK * 8 + g.fold) {
    case 0: return ntt_mulacc_cluster<0, 0, TW, CANON>;
    case 1: return ntt_mulacc_cluster<0, 1, TW, CANON>;
    case 2: return ntt_mulacc_cluster<0, 2, TW, CANON>;
    case 3: return ntt_mulacc_cluster<0, 3, TW, CANON>;
    case 8 + 0: return ntt_mulacc_cluster<1, 0, TW, CANON>;
    case 8 + 1: return ntt_mulacc_cluster<1, 1, TW, CANON>;
    case 8 + 2: return ntt_mulacc_cluster<1, 2, TW, CANON>;
    case 16 + 0: return ntt_mulacc_cluster<2, 0, TW, CANON>;
    case 16 + 1: return ntt_mulacc_cluster<2, 1, TW, CANON>;
    case 24 + 0: return ntt_mulacc_cluster<3, 0, TW, CANON>;
    default: return nullptr;
  }
}

// The geometry of clusters of 2^logK CTAs at logN, if the kernel takes it:
// logN 8-15, K at most 8, a chunk in one CTA's shared memory and at least
// one cross-chunk column a thread.
bool takes(int logN, int logK) {
  if (logN < kMinLogN || logN > kMaxMulaccLogN || logK < 0 ||
      logK > kMaxLogK)
    return false;
  const Geometry g = geometry_k(logN, logK);
  return g.logM <= kLogChunk && columns(g) >= 1 &&
         kernel_of<ShoupTw, false>(g) != nullptr;
}

}  // namespace

// x: [P, C, N] with element strides (x_sp, x_sc, 1). w, wp: the layout's
// twiddle bank and quotients [C, N], wp null for a Montgomery-form bank;
// q, k: [C] modulus and -q^-1 mod 2^62; ident: [C] R mod q for the canon
// pre-stage of signed input words, or null. k0, k1: pointers to key
// element (part_off, level, 0) of the full stacks, element strides (k_sp,
// k_sc, 1), 16-byte aligned with even strides. d0, d1: contiguous [C, N],
// 16-byte aligned. Clusters of 2^logK CTAs, G part groups (1 <= G <= P),
// `held` parts' chunks a CTA (1 to kMaxHeld); part: contiguous
// [G - 1, 2, C, N], 16-byte aligned (unused when G = 1). Returns 0, a CUDA
// error, -1 for a logN, K, G or held the kernel does not take, or -2 when
// the cluster cannot be scheduled.
extern "C" int ltt_ntt_mulacc(const void* x, long long x_sp, long long x_sc,
                              void* part, int P, int G, int held, int C,
                              int logN, int logK, const void* w,
                              const void* wp, const void* q, const void* k,
                              const void* ident, const void* k0,
                              const void* k1, long long k_sp,
                              long long k_sc, void* d0, void* d1,
                              void* stream) {
  if (!takes(logN, logK) || G < 1 || G > P || (G > 1 && part == nullptr) ||
      held < 1 || held > kMaxHeld)
    return -1;
  static bool
      checked[2][2][kMaxMulaccLogN + 1][kMaxLogK + 1][kMaxHeld + 1];
  const bool mont = wp == nullptr, canon = ident != nullptr;
  Geometry g = geometry_k(logN, logK);
  const Kernel kern =
      mont ? (canon ? kernel_of<MontTw, true>(g) : kernel_of<MontTw, false>(g))
           : (canon ? kernel_of<ShoupTw, true>(g)
                    : kernel_of<ShoupTw, false>(g));
  g.smem *= held;
  if (g.smem > kMaxSmem) return -1;
  ClusterLaunch l;
  int rc = l.init((const void*)kern, g, (unsigned)G, (unsigned)C, stream,
                  checked[mont][canon][logN][logK][held]);
  if (rc != 0) return rc;
  rc = (int)cudaLaunchKernelEx(&l.cfg, kern, (const u64*)x, x_sp, x_sc, P,
                               logN, (const u64*)w, (const u64*)wp,
                               (const u64*)q, (const u64*)k,
                               (const u64*)ident, (const u64*)k0,
                               (const u64*)k1, k_sp, k_sc, (u64*)d0,
                               (u64*)d1, (u64*)part, held);
  if (rc != 0) return rc;
  if (G > 1) {
    const long long CN = (long long)C << logN;
    const long long blocks = (CN / 2 + kCombineThreads - 1) / kCombineThreads;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(kCombineThreads, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(&cfg, mulacc_combine, (u64*)d0, (u64*)d1,
                                 (const u64*)part, G - 1, logN, CN,
                                 (const u64*)q);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

// The launch geometry of clusters of 2^logK CTAs at logN into out (at
// least 16 ints, as bfly.cuh's geometry_out lays them out). -1 where the
// kernel does not take them.
extern "C" int ltt_ntt_mulacc_geometry(int logN, int logK, int* out) {
  if (!takes(logN, logK)) return -1;
  geometry_out(geometry_k(logN, logK), out);
  return 0;
}
