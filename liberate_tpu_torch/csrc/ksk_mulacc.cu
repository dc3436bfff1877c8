// Key-switch multiply-accumulate: for each channel c and coefficient n,
//   d0 = sum_p montmul(x[p, c, n], k0[part_off + p, level + c, n])
//   d1 = sum_p montmul(x[p, c, n], k1[part_off + p, level + c, n])
// with a conditional subtract of 2q after each add (lazy [0, 2q) output).
//
// Replaces: liberate_tpu/ntt/pallas_ntt.py `_ksk_mulacc_kernel` (:693), the
// tail of `_ntt_ksk_accum_split` (:725). There the part axis is the
// sequential inner grid axis and the two output blocks stay resident in
// VMEM across it; here one thread owns one (channel, coefficient) pair and
// loops over the P parts with both sums in registers, so nothing is carried
// between blocks.
//
// What bounds it on the H100: bytes. Per output pair it reads 3P words
// (x, k0, k1) and writes 2, for 2P Montgomery products, which is below
// the card's INT32-to-bandwidth balance. The design does what bytes allow:
// every word is read once, consecutive threads read consecutive
// coefficients, and the full key stacks are addressed through their
// strides at (part_off, level), so no sliced copy of the key is made.
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void ksk_mulacc_kernel(const u64* __restrict__ x, long long x_sp,
                                  long long x_sc, const u64* __restrict__ k0,
                                  const u64* __restrict__ k1, long long k_sp,
                                  long long k_sc, int P, int logN,
                                  const u64* __restrict__ qv,
                                  const u64* __restrict__ kv,
                                  u64* __restrict__ d0,
                                  u64* __restrict__ d1) {
  const long long N = 1LL << logN;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int c = blockIdx.y;
  const u64 q = qv[c], k = kv[c], q2 = 2 * q;
  const u64* xc = x + c * x_sc + n;
  const u64* k0c = k0 + c * k_sc + n;
  const u64* k1c = k1 + c * k_sc + n;
  const u64 x0 = xc[0];
  u64 a0 = montmul(x0, k0c[0], q, k);
  u64 a1 = montmul(x0, k1c[0], q, k);
  for (int p = 1; p < P; ++p) {
    const u64 xp = xc[p * x_sp];
    a0 = csub(a0 + montmul(xp, k0c[p * k_sp], q, k), q2);
    a1 = csub(a1 + montmul(xp, k1c[p * k_sp], q, k), q2);
  }
  d0[c * N + n] = a0;
  d1[c * N + n] = a1;
}

}  // namespace

// x: [P, C, N] with element strides (x_sp, x_sc, 1). k0, k1: pointers to
// key element (part_off, level, 0) of the full stacks, element strides
// (k_sp, k_sc, 1). q, k: [C] modulus and -q^-1 mod 2^62. d0, d1:
// contiguous [C, N].
extern "C" int ltt_ksk_mulacc(const void* x, long long x_sp, long long x_sc,
                              const void* k0, const void* k1, long long k_sp,
                              long long k_sc, int P, int C, int logN,
                              const void* q, const void* k, void* d0,
                              void* d1, void* stream) {
  const long long N = 1LL << logN;
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), C);
  ksk_mulacc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)x, x_sp, x_sc, (const u64*)k0, (const u64*)k1, k_sp, k_sc,
      P, logN, (const u64*)q, (const u64*)k, (u64*)d0, (u64*)d1);
  return (int)cudaGetLastError();
}
