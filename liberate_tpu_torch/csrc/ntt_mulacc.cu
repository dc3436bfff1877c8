// The butterfly domain's unsplit key-switch core: the forward NTT of every
// gadget part, both key products and the sum over the parts,
//   d0 = sum_p montmul(NTT(x[p])[c, n], k0[part_off + p, level + c, n])
//   d1 = sum_p montmul(NTT(x[p])[c, n], k1[part_off + p, level + c, n])
// with a conditional subtract of 2q after each add (lazy [0, 2q) output).
//
// Replaces: liberate_tpu/ntt/pallas_ntt.py `_ntt_mulacc_kernel` (:614),
// launched by `ntt_ksk_accum` (:782, :810) when config.use_split_switch is
// off, at logN <= 15. Without its canon pre-stage (canon=False): the
// port's basis extension is the Shoup one, already unsigned [0, 2q). Same
// words as ltt_ntt_fwd followed by ltt_ksk_mulacc (the split route), op for
// op.
//
// What bounds it on the H100: bytes. Per channel and coefficient it reads
// P extension words and 2P key words and writes 2 words, plus the
// channel's twiddles and quotients once; the P transforms' Shoup products
// (about ten 32-bit multiplies per butterfly) come behind. Against the
// split route it saves the write and the re-read of the [P, C, N]
// transform output and one launch.
//
// Design: a silver channel (256 KB) does not fit one block, so as in
// ntt.cu the long-span stages of every part run first in global memory
// (fwd_top over the batch of P parts, into a scratch [P, C, N]). Then one
// launch, grid (2^s_top tiles, C): each block loops over the P parts; for
// each it loads the part's 2^12-word tile into shared memory, runs the 12
// short-span stages, and multiplies each word by both key halves, summing
// the products in registers (each thread owns the same 8 words of every
// part's tile). The block writes d0 and d1 once. The Pallas kernel carries
// the sums across its sequential part axis in VMEM; here the part loop is
// inside the block, as Hopper blocks run in no order.
#include "ntt.cuh"

namespace {

constexpr int kItems = (1 << bfly::kLogTile) / bfly::kSmemThreads;

// x: [P, C, N] with element strides (x_sp, x_sc, 1): the parts after the
// long-span stages (or as given when there are none). k0, k1: key element
// (part_off, level, 0), element strides (k_sp, k_sc, 1).
__global__ void fwd_smem_mulacc(const u64* x, long long x_sp, long long x_sc,
                                int P, int logN, int logL,
                                const u64* __restrict__ w,
                                const u64* __restrict__ wp,
                                const u64* __restrict__ qv,
                                const u64* __restrict__ kv,
                                const u64* __restrict__ k0,
                                const u64* __restrict__ k1, long long k_sp,
                                long long k_sc, u64* __restrict__ d0,
                                u64* __restrict__ d1) {
  extern __shared__ u64 sh[];
  const int g = blockIdx.x, c = blockIdx.y;
  const long long N = 1LL << logN;
  const int L = 1 << logL;
  const long long off = (long long)g * L;
  const u64 q = qv[c], k = kv[c], q2 = 2 * q;
  const u64* wc = w + c * N;
  const u64* wpc = wp + c * N;
  const u64* k0c = k0 + c * k_sc + off;
  const u64* k1c = k1 + c * k_sc + off;

  u64 a0[kItems], a1[kItems];
  for (int p = 0; p < P; ++p) {
    const u64* src = x + p * x_sp + c * x_sc + off;
    __syncthreads();  // the previous part's products have read the tile
    for (int i = threadIdx.x; i < L; i += blockDim.x) sh[i] = src[i];
    bfly::fwd_tile(sh, logN, logL, g, wc, wpc, q);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i < L) {
        const u64 v = sh[i];
        const u64 p0 = montmul(v, k0c[p * k_sp + i], q, k);
        const u64 p1 = montmul(v, k1c[p * k_sp + i], q, k);
        a0[it] = p ? csub(a0[it] + p0, q2) : p0;
        a1[it] = p ? csub(a1[it] + p1, q2) : p1;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = threadIdx.x + it * blockDim.x;
    if (i < L) {
      d0[c * N + off + i] = a0[it];
      d1[c * N + off + i] = a1[it];
    }
  }
}

}  // namespace

// x: [P, C, N] with element strides (x_sp, x_sc, 1). scratch: contiguous
// [P, C, N] (unused when logN <= 12). w, wp: the layout's twiddle bank
// and quotients [C, N]; q, k: [C] modulus and -q^-1 mod 2^62. k0, k1:
// pointers to key element (part_off, level, 0) of the full stacks, element
// strides (k_sp, k_sc, 1). d0, d1: contiguous [C, N].
extern "C" int ltt_ntt_mulacc(const void* x, long long x_sp, long long x_sc,
                              void* scratch, int P, int C, int logN,
                              const void* w, const void* wp, const void* q,
                              const void* k, const void* k0, const void* k1,
                              long long k_sp, long long k_sc, void* d0,
                              void* d1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int logL = bfly::tile_log(logN);
  const u64* src = (const u64*)x;
  const u64* ew = nullptr;
  const u64* ewp = nullptr;
  const int rc = bfly::fwd_top(src, x_sp, x_sc, (u64*)scratch, P, C, logN,
                               (const u64*)w, (const u64*)wp, (const u64*)q,
                               ew, ewp, st);
  if (rc != 0) return rc;
  fwd_smem_mulacc<<<dim3(1u << (logN - logL), C), bfly::tile_threads(logL),
                    sizeof(u64) << logL, st>>>(
      src, x_sp, x_sc, P, logN, logL, (const u64*)w, (const u64*)wp,
      (const u64*)q, (const u64*)k, (const u64*)k0, (const u64*)k1, k_sp,
      k_sc, (u64*)d0, (u64*)d1);
  return (int)cudaGetLastError();
}
