// Shared device code of the tensor-core ("MXU") NTT kernels: one stage of
// the four-step transform as an int8 x int8 -> int32 matrix product on the
// tensor cores, with the data digitised on the way in and the planes
// recombined to a 62-bit residue on the way out.
//
// A stage computes, per batch element b and channel c,
//
//   E_u[o, j] = sum_{v, k} T[u*O + o, v*K + k] * (digit_v(X[k, j]) - 128)
//               + rs[u*O + o]                                 (u < DA)
//   Y[o, j]   = recombine(E_0..E_{DA-1})                       in [0, 2q)
//
// where T is the channel's balanced-digit table (int8, row-major
// [DA*O, DB*K]), digit_v the v-th byte of the 64-bit word and rs the table
// row's offset correction. |E_u| < 2^28, so int32 accumulation is exact.
// The recombination is the Shoup form of liberate_tpu/ntt/mxu_pallas.py
// `_recombine_k(shoup_rec=True)`: Horner over the planes, a Barrett
// reduction of the low part and a Shoup product of the high part (both
// offset by 2^63), a per-channel correction and two conditional
// subtracts; the same words as the Pallas kernels, bit for bit.
//
// Tensor cores: mma.sync.m16n8k32 s8 with the table as the row-major A
// operand and the digits as the column-major B operand, both from shared
// memory. A block owns 16 output rows (all DA planes of them) and up to 64
// columns, one warp per 16 columns, so every thread holds all DA planes of
// its 8 outputs and recombines them in registers. Per chunk of 32 rows of
// X, the block copies the table tile it needs into shared memory
// (cp.async, 16 bytes per request) while it digitises the chunk, so one
// memory latency is exposed per chunk and not one per mma depth. The
// batch and the column tiles of one channel run next to each other in the
// grid, so the table comes from device memory about once and then from L2.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "modarith.cuh"

namespace mxu {

constexpr int kSplit = 5;     // low part: planes 0..4 (weights < 2^40)
constexpr int kMaxCols = 64;  // columns per block
constexpr int kDepth = 32;    // k depth of one int8 mma
constexpr int kPitch = 36;    // bytes per column of a staged digit chunk
constexpr u64 kTop = 1ULL << 63;

enum In { kRows = 0, kCols = 1 };
// kKsk: Shoup products with (value, quotient) key pairs; kKskMont:
// Montgomery products with single Montgomery-form key stacks.
enum Epi { kTwiddle = 0, kOut = 1, kKsk = 2, kKskMont = 3 };

// Arguments of one stage. Word tensors are int64 on the device; channel
// arrays are already offset to the channel set of the launch.
struct Stage {
  const u64* x;  // input words; element (b, c, k, j) below
  long long x_sb, x_sc;
  u64* y;        // output words at y[b*y_sb + c*y_sc + o*J + j]
  long long y_sb, y_sc;
  int K, J, O, N;
  const int8_t* table;  // [C, DA*O, DB*K]
  const int* rs;        // [C, DA*O]
  const u64* tw;        // [C, N] Montgomery-form twiddles (kTwiddle)
  int tw_t;             // twiddle of (o, j) at tw[j*O + o] (else o*J + j)
  const u64 *q, *k, *bp, *whi, *wphi, *corr;  // [C]
  int post_reduce;      // kOut: [0, 2q) -> [0, q)
  // kKsk / kKskMont: key products with both key halves, summed over P
  // parts (k0wp, k1wp: the Shoup quotients, kKsk only)
  const u64 *k0w, *k0wp, *k1w, *k1wp;
  long long k_sp, k_sc;
  int P;
};

__device__ __forceinline__ u64 csub_u(u64 v, u64 m) { return v >= m ? v - m : v; }

// x mod q in [0, 2q) for any 64-bit x, with bp = floor(2^64 / q).
__device__ __forceinline__ u64 barrett_2q(u64 x, u64 bp, u64 q) {
  return x - __umul64hi(x, bp) * q;
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Planes e[0..DA) (int32, offset corrections included) -> V mod q in [0, 2q).
template <int DA>
__device__ __forceinline__ u64 recombine(const int (&e)[DA], u64 q, u64 bp,
                                         u64 whi, u64 wphi, u64 corr) {
  constexpr int L = DA < kSplit ? DA : kSplit;
  u64 v = (u64)(long long)e[L - 1];
#pragma unroll
  for (int u = L - 2; u >= 0; --u) v = (v << 8) + (u64)(long long)e[u];
  u64 r = barrett_2q(v + kTop, bp, q);
  if (DA > kSplit) {
    u64 h = (u64)(long long)e[DA - 1];
#pragma unroll
    for (int u = DA - 2; u >= kSplit; --u) h = (h << 8) + (u64)(long long)e[u];
    r += shoup_mul(h + kTop, whi, wphi, q);
  }
  r += corr;  // < 5q
  r = csub_u(r, 4 * q);
  return csub_u(r, 2 * q);
}

template <int IN>
__device__ __forceinline__ u64 load_x(const Stage& a, int b, int c, int k,
                                      int j) {
  const u64* x = a.x + b * a.x_sb + c * a.x_sc;
  return IN == kRows ? x[(long long)k * a.J + j] : x[(long long)j * a.K + k];
}

// Byte v of four words, offset by -128 into int8, packed into one word
// (word i in byte i): three byte permutes and one xor.
template <int V>
__device__ __forceinline__ uint32_t digit4(const u64 (&w)[4]) {
  constexpr unsigned b = V & 3;
  const auto half = [](u64 x) { return (uint32_t)(V < 4 ? x : x >> 32); };
  const uint32_t t01 = __byte_perm(half(w[0]), half(w[1]), b | ((b + 4) << 4));
  const uint32_t t23 = __byte_perm(half(w[2]), half(w[3]), b | ((b + 4) << 4));
  return __byte_perm(t01, t23, 0x5410) ^ 0x80808080u;
}

template <int DB, int V = 0>
__device__ __forceinline__ void stage_digits(unsigned char* dz, const u64 (&w)[4],
                                             int KC, int kq, int j) {
  if constexpr (V < DB) {
    const int z = V * KC + kq * 4;
    *reinterpret_cast<uint32_t*>(dz + ((z >> 5) * kMaxCols + j) * kPitch +
                                 (z & 31)) = digit4<V>(w);
    stage_digits<DB, V + 1>(dz, w, KC, kq, j);
  }
}

// Dynamic shared memory of a stage: the digit chunks, then the table tile
// (DA*16 rows of DB*KC bytes, padded by 16 so the fragment reads of the 8
// row groups fall in distinct banks).
inline int stage_smem(int DA, int DB, int K) {
  const int KC = K < kDepth ? K : kDepth;
  return DB * kMaxCols * kPitch + DA * 16 * (DB * KC + 16);
}

// One stage. Grid: (B * J/TJ, O/16, C); block: TJ/16 warps.
template <int DA, int DB, int IN, int EPI>
__global__ void __launch_bounds__(128) stage(const Stage a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* dz = smem;
  const int TJ = a.J < kMaxCols ? a.J : kMaxCols;
  const int jt = a.J / TJ;
  const int b = blockIdx.x / jt;
  const int j0 = (blockIdx.x % jt) * TJ;
  const int o0 = blockIdx.y * 16;
  const int c = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KC = a.K < kDepth ? a.K : kDepth;  // k rows digitised per step
  const int steps = DB * KC / kDepth;           // mma depths per step
  const int ldt = DB * a.K;
  const int apitch = DB * KC + 16;
  unsigned char* at = smem + DB * kMaxCols * kPitch;
  const int8_t* T = a.table + (size_t)c * DA * a.O * ldt;
  const int* rs = a.rs + (size_t)c * DA * a.O;
  const u64 q = a.q[c], bp = a.bp[c];
  const u64 whi = a.whi[c], wphi = a.wphi[c], corr = a.corr[c];
  constexpr bool kSum = EPI == kKsk || EPI == kKskMont;
  const int nparts = kSum ? a.P : 1;

  u64 sum0[2][2][2], sum1[2][2][2];  // kSum: [n-fragment][row half][col]
  for (int p = 0; p < nparts; ++p) {
    const int bb = kSum ? p : b;
    int acc[DA][2][4];
#pragma unroll
    for (int u = 0; u < DA; ++u)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[u][f][i] = 0;

    for (int k0 = 0; k0 < a.K; k0 += KC) {
      __syncthreads();
      // The table tile of this chunk: plane u, row o0 + r, digit v holds
      // columns v*K + k0 .. + KC; in shared memory row u*16 + r, bytes
      // v*KC .., so depth s of the chunk is bytes s*32 .. s*32 + 31.
      const int pieces = DA * 16 * DB * (KC / 16);
      for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
        const int piece = i % (KC / 16), rest = i / (KC / 16);
        const int v = rest % DB, row = rest / DB;
        cp_async16(at + row * apitch + v * KC + piece * 16,
                   T + (size_t)((row >> 4) * a.O + o0 + (row & 15)) * ldt +
                       v * a.K + k0 + piece * 16);
      }
      // Digitise X[k0 .. k0+KC, j0 .. j0+TJ): four consecutive k of one
      // column per item, packed per digit into one 32-bit word. Digit v of
      // row k lands at depth z = v*KC + k - k0 of the step, i.e. in chunk
      // z / 32 at byte z % 32 (column-major B operand).
      const int items = TJ * (KC / 4);
      for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int j = it % TJ, kq = it / TJ;
        u64 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = load_x<IN>(a, bb, c, k0 + kq * 4 + i, j0 + j);
        stage_digits<DB>(dz, w, KC, kq, j);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int s = 0; s < steps; ++s) {
        uint32_t bf[2][2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const unsigned char* col =
              dz + (s * kMaxCols + warp * 16 + f * 8 + g) * kPitch + t * 4;
          bf[f][0] = *reinterpret_cast<const uint32_t*>(col);
          bf[f][1] = *reinterpret_cast<const uint32_t*>(col + 16);
        }
#pragma unroll
        for (int u = 0; u < DA; ++u) {
          const unsigned char* row = at + (u * 16 + g) * apitch + s * 32 + t * 4;
          const uint32_t a0 = lds32(row), a1 = lds32(row + 8 * apitch);
          const uint32_t a2 = lds32(row + 16), a3 = lds32(row + 8 * apitch + 16);
          mma_s8(acc[u][0], a0, a1, a2, a3, bf[0][0], bf[0][1]);
          mma_s8(acc[u][1], a0, a1, a2, a3, bf[1][0], bf[1][1]);
        }
      }
    }

#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + g + 8 * h;
          const int j = j0 + warp * 16 + f * 8 + t * 2 + e;
          int ev[DA];
#pragma unroll
          for (int u = 0; u < DA; ++u) ev[u] = acc[u][f][h * 2 + e] + rs[u * a.O + o];
          u64 val = recombine<DA>(ev, q, bp, whi, wphi, corr);
          const long long n = (long long)o * a.J + j;
          if (EPI == kTwiddle) {
            const long long ti = a.tw_t ? (long long)j * a.O + o : n;
            val = montmul(val, a.tw[(long long)c * a.N + ti], q, a.k[c]);
            a.y[bb * a.y_sb + c * a.y_sc + n] = val;
          } else if (EPI == kOut) {
            if (a.post_reduce) val = csub_u(val, q);
            a.y[bb * a.y_sb + c * a.y_sc + n] = val;
          } else {
            const long long ki = p * a.k_sp + c * a.k_sc + n;
            u64 p0, p1;
            if (EPI == kKsk) {
              p0 = shoup_mul(val, a.k0w[ki], a.k0wp[ki], q);
              p1 = shoup_mul(val, a.k1w[ki], a.k1wp[ki], q);
            } else {
              p0 = montmul(val, a.k0w[ki], q, a.k[c]);
              p1 = montmul(val, a.k1w[ki], q, a.k[c]);
            }
            sum0[f][h][e] = p ? csub_u(sum0[f][h][e] + p0, 2 * q) : p0;
            sum1[f][h][e] = p ? csub_u(sum1[f][h][e] + p1, 2 * q) : p1;
          }
        }
  }
  if (kSum) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long n = (long long)(o0 + g + 8 * h) * a.J + j0 +
                              warp * 16 + f * 8 + t * 2 + e;
          a.y[c * a.y_sc + n] = sum0[f][h][e];
          a.y[a.y_sb + c * a.y_sc + n] = sum1[f][h][e];
        }
  }
}

template <int D, int IN, int EPI>
int launch_d(const Stage& a, int B, int C, cudaStream_t st) {
  const int TJ = a.J < kMaxCols ? a.J : kMaxCols;
  const dim3 grid(B * (a.J / TJ), a.O / 16, C);
  const int smem = stage_smem(D, D, a.K);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        stage<D, D, IN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != 0) return rc;
  }
  stage<D, D, IN, EPI><<<grid, (TJ / 16) * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Digit counts with kernels: (4, 4) for 30-bit primes, (6, 6) for 40-bit,
// (8, 8) for 60-bit. -1 for any other.
template <int IN, int EPI>
int launch(int d, const Stage& a, int B, int C, cudaStream_t st) {
  switch (d) {
    case 4: return launch_d<4, IN, EPI>(a, B, C, st);
    case 6: return launch_d<6, IN, EPI>(a, B, C, st);
    case 8: return launch_d<8, IN, EPI>(a, B, C, st);
    default: return -1;
  }
}

// The shape part of a stage: O output rows, K rows contracted, J columns.
inline Stage shape(int O, int K, int J, int N) {
  Stage a{};
  a.O = O;
  a.K = K;
  a.J = J;
  a.N = N;
  return a;
}

}  // namespace mxu
