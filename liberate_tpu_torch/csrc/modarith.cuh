// Modular word arithmetic shared by the port's CUDA kernels.
//
// A residue is one 64-bit word (the port's int64 tensors hold the same
// bits). q < 2^61 for every prime of the presets, so 4q < R = 2^62 and the
// lazy [0, 2q) sums below never reach bit 63.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

// w*x mod q in [0, 2q) for any 64-bit x, with wp = floor(w * 2^64 / q).
__device__ __forceinline__ u64 shoup_mul(u64 x, u64 w, u64 wp, u64 q) {
  const u64 hi = __umul64hi(x, wp);
  return x * w - hi * q;
}

// One step of the special-prime mod-down: (v + 2q - (src mod q)) * P_j^-1
// mod q as a [0, 2q) representative, the Shoup pair (w, wp) being P_j^-1
// and its quotient, bp = floor(2^64 / q) the Barrett reciprocal that
// reduces the dropped row's word src to [0, 2q).
__device__ __forceinline__ u64 md_iter(u64 v, u64 src, u64 w, u64 wp, u64 q,
                                       u64 bp) {
  const u64 tile = src - __umul64hi(src, bp) * q;
  return shoup_mul(v + 2 * q - tile, w, wp, q);
}

// v - m when v >= m. The compare is SIGNED, as in the reference's
// conditional subtract and final reduce; all operands here are < 2^63, so
// it agrees with the unsigned compare.
__device__ __forceinline__ u64 csub(u64 v, u64 m) {
  return ((long long)v < (long long)m) ? v : v - m;
}

// (a*b + m*q) / 2^62 with m = a*b*k mod 2^62, given the high half hi of
// the 128-bit product a*b.
__device__ __forceinline__ u64 redc_of(u64 a, u64 b, u64 hi, u64 q, u64 k) {
  const u64 lo = a * b;
  const u64 m = (lo * k) & ((1ULL << 62) - 1);
  const u64 mlo = m * q;
  const u64 mhi = __umul64hi(m, q);
  const u64 slo = lo + mlo;
  const u64 shi = hi + mhi + (slo < lo ? 1ULL : 0ULL);
  return (shi << 2) | (slo >> 62);
}

// Montgomery product a*b*2^-62 mod q for a, b < 2^62, lazy in [0, 2q).
// k = -q^-1 mod 2^62. This is the exact REDC (a*b + m*q) / 2^62 with
// m = a*b*k mod 2^62, which is the value the reference's 31-bit half-limb
// chain computes, bit for bit.
__device__ __forceinline__ u64 montmul(u64 a, u64 b, u64 q, u64 k) {
  return redc_of(a, b, __umul64hi(a, b), q, k);
}

// The same for a two's-complement a (|a| < 2^62, wrapped negatives among
// them) and 0 <= b < 2^62: the exact signed REDC, (a*b + m*q) / 2^62 with
// the product signed, which is what the reference's half-limb chain gives
// with its arithmetic shifts (liberate_tpu/ntt/u64.py montmul_signed). The
// result may be negative.
__device__ __forceinline__ u64 montmul_signed(u64 a, u64 b, u64 q, u64 k) {
  return redc_of(a, b, (u64)__mul64hi((long long)a, (long long)b), q, k);
}
