// The special-prime mod-down of the key switch, standalone (ltt_mod_down):
// the switch's words over the with-special channels in, the ordinary
// channels out, every special prime removed.
//
// Replaces no Pallas kernel: the JAX package's mod-down
// (liberate_tpu/fhe/engine.py `_mod_down_shoup`) is XLA pointwise code.
// It replaces the chain of PyTorch ops over u64.py words that the port's
// engine ran after the unfolded switch (#10, #9, the composed and the
// butterfly routes, and the gathered rows on a mesh): about 150 full-size
// launches per special prime. ntt/cuda_mxu.py `mod_down_plain` is that
// chain, kept as the kernel's twin; both give the same words.
//
// What bounds it on the H100: each input word read once and each output
// word written once, and about as much in 32-bit multiplies (the n_sp
// removal steps of every ordinary word).
//
// Design: one thread per (row l, coefficient n) column, as the fold of
// csrc/mxu_switch.cu. The thread walks the n_sp dropped rows in drop
// order, last channel first: each goes through the steps of the rows
// dropped before it (md_iter) and is made canonical in [0, q), and stays
// in registers (n_sp a template parameter, so the rows are registers and
// the steps unrolled). Then every ordinary channel takes the n_sp steps and
// the final conditional subtract. Loads and stores are coalesced along n.
// The block first stages the per-channel constants in shared memory, one
// 16-byte load per pair, and works out each ordinary channel's borrow
// corrections 2^64 P_j^-1 mod q: a step is then the wrapped difference
// v - s times P_j^-1 (one Shoup product, no Barrett reduction of s),
// corrected where the subtract borrowed. Each step leaves [0, 2q) and the
// last is made canonical, so the words are the chain's.
#include "modarith.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpecial = 8;
constexpr int kThreads = 256;

// Words of shared constants per channel: q, bp, then (w_j, wp_j) per step.
__host__ __device__ constexpr int stride(int nsp) { return 2 + 2 * nsp; }

// d: [L][C_sp][N] plain words; out: [L][C_ord][N] in [0, q). piw:
// [NSP][2][C_sp] (P_j^-1 and its Shoup quotient per step and channel); qv,
// bpv: [C_sp] the moduli and Barrett reciprocals. Grid (N / kThreads, L).
template <int NSP>
__global__ void __launch_bounds__(kThreads, NSP <= 4 ? 4 : 2)
    mod_down(const u64* __restrict__ d, u64* __restrict__ out, int N,
             int C_sp, int C_ord, const u64* __restrict__ piw,
             const u64* __restrict__ qv, const u64* __restrict__ bpv) {
  constexpr int S = stride(NSP);
  extern __shared__ __align__(16) u64 sh[];
  u64* corr = sh + C_sp * S;  // [C_ord][NSP]
  for (int i = threadIdx.x; i < C_sp * S; i += blockDim.x) {
    const int ch = i / S, k = i % S;
    sh[i] = k == 0 ? qv[ch] : k == 1 ? bpv[ch] : piw[(k - 2) * C_sp + ch];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C_ord * NSP; i += blockDim.x) {
    const int ch = i / NSP, j = i % NSP;
    const u64* c = sh + ch * S;
    const u64 q = c[0];
    // 2^64 mod q = 2^64 - bp q, times P_j^-1, made canonical.
    const u64 t = shoup_mul(0ULL - c[1] * q, c[2 + 2 * j], c[3 + 2 * j], q);
    corr[i] = t >= q ? t - q : t;
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long l = blockIdx.y;
  const u64* x = d + l * C_sp * N + n;
  u64* y = out + l * C_ord * N + n;
  u64 src[NSP];
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk) {
    const int ch = C_sp - 1 - kk;
    const u64* c = sh + ch * S;
    const u64 q = c[0], bp = c[1];
    u64 v = x[(long long)ch * N];
#pragma unroll
    for (int j = 0; j < kk; ++j)
      v = md_iter(v, src[j], c[2 + 2 * j], c[3 + 2 * j], q, bp);
    // The row is subtracted as an integer: its canonical representative
    // (the first dropped row is the plain input word itself).
    if (kk) v = v < q ? v : v - q;
    src[kk] = v;
  }
#pragma unroll 4
  for (int ch = 0; ch < C_ord; ++ch) {
    const ulonglong2* c = (const ulonglong2*)(sh + ch * S);
    const u64 q = c[0].x;
    u64 v = x[(long long)ch * N];
#pragma unroll
    for (int j = 0; j < NSP; ++j) {
      const ulonglong2 w = c[1 + j];
      const u64 t = shoup_mul(v - src[j], w.x, w.y, q);
      if (v < src[j]) {
        // v - src wrapped: t is 2^64 P_j^-1 too high.
        const u64 u = t + q - corr[ch * NSP + j];
        v = u >= 2 * q ? u - 2 * q : u;
      } else {
        v = t;
      }
    }
    y[(long long)ch * N] = csub(v, q);
  }
}

// The shared constants and corrections: [C_sp][stride] and [C_ord][NSP]
// words (12 KB at platinum's level 1).
template <int NSP>
void launch(const void* d, void* out, int L, int C_sp, int C_ord, int N,
            const void* piw, const void* q, const void* bp, cudaStream_t s) {
  const size_t smem = 8 * (C_sp * stride(NSP) + C_ord * NSP);
  mod_down<NSP><<<dim3((unsigned)((N + kThreads - 1) / kThreads),
                       (unsigned)L),
                  kThreads, smem, s>>>((const u64*)d, (u64*)out, N, C_sp,
                                       C_ord, (const u64*)piw, (const u64*)q,
                                       (const u64*)bp);
}

}  // namespace

// d: [L][C_sp][N] dense plain words of the with-special channels (the
// special primes last); out: [L][C_ord][N], the first C_ord channels with
// the last n_sp removed (C_ord + n_sp <= C_sp). piw: [n_sp][2][C_sp]; q,
// bp: [C_sp]. Returns -1 for an n_sp the kernel is not built for, else the
// launch's CUDA error.
extern "C" int ltt_mod_down(const void* d, void* out, int L, int C_sp,
                            int C_ord, int N, int n_sp, const void* piw,
                            const void* q, const void* bp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_sp) {
    case 1: launch<1>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case 2: launch<2>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case 3: launch<3>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case 4: launch<4>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case 5: launch<5>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case 6: launch<6>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case 7: launch<7>(d, out, L, C_sp, C_ord, N, piw, q, bp, s); break;
    case kMaxSpecial:
      launch<kMaxSpecial>(d, out, L, C_sp, C_ord, N, piw, q, bp, s);
      break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
