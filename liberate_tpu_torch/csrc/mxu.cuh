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
// row's offset correction. The sides S, R of the transform (O, K and J of
// its stages) are 16 to 512 (logN 8 to 17). |E_u| <= DB*K * 128^2 plus
// |rs| of the same size: 2^27 at platinum's K = 512 and 8 digits, inside
// "|E_u| < 2^28", so int32 accumulation is exact in any order. Word,
// twiddle and key offsets are formed in 64-bit integers (at logN 17 a key
// stack is 1.3e8 words, 1.1 GB, and a switch's scratch as large); table
// row and column indices, TMA coordinates and grid dimensions stay far
// below 2^31. The recombination is the Shoup form of
// liberate_tpu/ntt/mxu_pallas.py `_recombine_k(shoup_rec=True)`: Horner
// over the planes, a Barrett reduction of the low part and a Shoup product
// of the high part (both offset by 2^63), a per-channel correction and two
// conditional subtracts; the same words as the Pallas kernels, bit for bit.
// The transform stages also take its Montgomery form (shoup_rec=False, and
// liberate_tpu/ntt/mxu_ntt.py `_recombine` :440 of the XLA composition), a
// compile-time choice (MR): a signed Montgomery product of each part by
// c_lo = R mod q and c_hi = 2^(8 kSplit) R mod q, their sum and one
// conditional subtract of 2q.
//
// What bounds a stage on the H100: by the operation count, the int8
// multiply-accumulates (O*J*K*DA*DB per channel and batch element, against
// 1979e12 int8 operations per second). Measured (stage_variants.py), the
// epilogue: the recombination, twiddle or key products and stores of the
// tile's outputs, in 64-bit integer arithmetic on the CUDA cores, take
// about as long as the tile's products, and the two do not overlap. The
// operand traffic is not the limit: dropping every TMA copy left the time
// within 4 %.
//
// Design (Hopper): a block owns an output tile of TO rows (all DA planes)
// by 128 columns of one batch element, and its shared memory one SM; its
// threads are two consumer warpgroups (64 columns each) and a producer
// warpgroup (one thread of which issues the copies; setmaxnreg gives its
// registers to the consumers). Per ring
// stage (32 table columns: one wgmma depth; 32 consecutive k of one digit
// plane, or two planes of all 16 k when K = 16) the producer asks the TMA
// for the table tile (a 3-D tensor map over the canonical [C, DA*O, DB*K]
// table: 32 bytes x TO rows x DA planes, 32-byte swizzle, K-major), and
// per window of 32 rows of X for the tile's X words (a 4-D tensor map over
// the words, either orientation), each on the `full` mbarrier of its ring
// slot. A consumer thread reads the X words of its wgmma A fragment once
// per window and turns them into the digit fragments of every plane of the
// window in registers (byte permutes), so each word is digitised once per
// tile and its digits serve all TO rows and DA planes. Per stage it issues
// one `wgmma.mma_async m64nTOk32 s32.s8.s8` per table plane u (the digits
// as the register A operand, the table tile as the shared-memory B
// operand), keeps one stage in flight and releases the stage before on its
// `empty` mbarrier; after the last stage it recombines the DA accumulators
// in registers and runs the epilogue, its loads batched per fragment. The
// digits never go through shared memory: written there by the threads and
// fenced to the tensor cores' proxy, they bounded a first version (A =
// table, B = digits) at half the rate of the same kernel without them. In
// the switch's stage 2 the part loop runs inside the tile: the table
// streams through the ring once per part, and both key-product sums stay
// in registers. A ct-batched switch runs B segments of P parts (bp = b*P +
// p): the block of segment b walks parts b*P .. b*P + P - 1, reads the key
// at part p (one key for every ciphertext) and writes segment b's sums.
// The tiles of one channel and row tile, every segment's among them, are
// neighbours in the grid, so the table comes from device memory about once
// and then from L2. Rows past O and columns past J (logN 8) are computed
// on whatever shared memory holds and never written.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace mxu {

constexpr int kSplit = 5;          // low part: planes 0..4 (weights < 2^40)
constexpr int kZ = 32;             // table columns per ring stage (bytes)
constexpr int kTileJ = 128;        // columns per block: two wgmma M tiles
constexpr int kThreads = 384;      // two consumer warpgroups, a producer one
constexpr int kXSlots = 2;         // X tiles in flight
constexpr int kMaxRing = 16;
constexpr int kSmemBudget = 200 * 1024;
// Registers a thread holds: ptxas gives each of the 384 threads 168 (the
// register file of an SM sub-partition shared by three warps); setmaxnreg
// then moves them from the producer warpgroup, which issues the copies
// from one thread, to the consumers (128 * 40 + 256 * 232 = 384 * 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr u64 kTop = 1ULL << 63;

enum In { kRows = 0, kCols = 1 };
// kKsk: Shoup products with (value, quotient) key pairs; kKskMont:
// Montgomery products with single Montgomery-form key stacks.
enum Epi { kTwiddle = 0, kOut = 1, kKsk = 2, kKskMont = 3 };

template <int EPI>
__host__ __device__ constexpr bool key_sums() {
  return EPI == kKsk || EPI == kKskMont;
}

// Output rows per tile (the wgmma N): a consumer thread holds D * TO / 2
// accumulators (96 at D = 6, 128 at D = 8), and the switch's stage 2 two
// key sums of TO / 2 outputs (2 * TO registers) beside them.
template <int D, int EPI>
__host__ __device__ constexpr int tile_o() {
  return key_sums<EPI>() && D == 8 ? 16 : 32;
}

// Bytes of one ring stage's table tile and of one X tile.
template <int D, int EPI>
__host__ __device__ constexpr int t_bytes() {
  return D * tile_o<D, EPI>() * kZ;
}
constexpr int kXBytes = kTileJ * kZ * 8;

// Ring stages: as many as the shared-memory budget holds beside the X
// tiles, at most kMaxRing.
template <int D, int EPI>
__host__ __device__ constexpr int ring() {
  return (kSmemBudget - 1024 - kXSlots * kXBytes) / (t_bytes<D, EPI>() + 16) <
                 kMaxRing
             ? (kSmemBudget - 1024 - kXSlots * kXBytes) /
                   (t_bytes<D, EPI>() + 16)
             : kMaxRing;
}

// Dynamic shared memory of a stage: 1 KB of alignment slack, the X tiles,
// the ring's table tiles and all mbarriers.
template <int D, int EPI>
__host__ __device__ constexpr int stage_smem() {
  return 1024 + kXSlots * (kXBytes + 16) +
         ring<D, EPI>() * (t_bytes<D, EPI>() + 16);
}

// Arguments of one stage. Word tensors are int64 on the device; channel
// arrays are already offset to the channel set of the launch.
struct Stage {
  CUtensorMap tmap;  // the table, set by launch()
  CUtensorMap xmap;  // the input words, set by launch()
  const u64* x;      // input words; element (b, c, k, j) below
  long long x_sb, x_sc;
  u64* y;            // output words at y[b*y_sb + c*y_sc + o*J + j]
  long long y_sb, y_sc;
  long long y_ss;    // key sums: segment b's at y[b*y_ss + ...], both
                     // halves y_sb apart
  int K, J, O, N;
  const int8_t* table;  // [C, DA*O, DB*K]
  const int* rs;        // [C, DA*O]
  const u64* tw;        // [C, N] Montgomery-form twiddles (kTwiddle)
  int tw_t;             // twiddle of (o, j) at tw[j*O + o] (else o*J + j)
  const u64 *q, *k, *bp, *whi, *wphi, *corr;  // [C]
  const u64 *clo, *chi;  // [C] the Montgomery recombination's weights
  int post_reduce;      // kOut: [0, 2q) -> [0, q)
  // kKsk / kKskMont: key products with both key halves, summed over P
  // parts of each segment (k0wp, k1wp: the Shoup quotients, kKsk only)
  const u64 *k0w, *k0wp, *k1w, *k1wp;
  long long k_sp, k_sc;
  int P;
};

__device__ __forceinline__ u64 csub_u(u64 v, u64 m) { return v >= m ? v - m : v; }

// x mod q in [0, 2q) for any 64-bit x, with bp = floor(2^64 / q).
__device__ __forceinline__ u64 barrett_2q(u64 x, u64 bp, u64 q) {
  return x - __umul64hi(x, bp) * q;
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

// The same in the Montgomery form: V_lo c_lo R^-1 + V_hi c_hi R^-1 in
// [0, 2q) by two signed Montgomery products (one when DA <= kSplit, and
// then no subtract, as the reference).
template <int DA>
__device__ __forceinline__ u64 recombine_mont(const int (&e)[DA], u64 q,
                                              u64 k, u64 clo, u64 chi) {
  constexpr int L = DA < kSplit ? DA : kSplit;
  u64 v = (u64)(long long)e[L - 1];
#pragma unroll
  for (int u = L - 2; u >= 0; --u) v = (v << 8) + (u64)(long long)e[u];
  u64 r = montmul_signed(v, clo, q, k);
  if (DA > kSplit) {
    u64 h = (u64)(long long)e[DA - 1];
#pragma unroll
    for (int u = DA - 2; u >= kSplit; --u)
      h = (h << 8) + (u64)(long long)e[u];
    r = csub_u(r + montmul_signed(h, chi, q, k), 2 * q);
  }
  return r;
}

// The recombination of a stage: recombine, or with MR recombine_mont with
// (k, c_lo, c_hi) in the places of (bp, whi, wphi).
template <int DA, bool MR>
__device__ __forceinline__ u64 rec(const int (&e)[DA], u64 q, u64 bp, u64 whi,
                                   u64 wphi, u64 corr) {
  if constexpr (MR)
    return recombine_mont<DA>(e, q, bp, whi, wphi);
  else
    return recombine<DA>(e, q, bp, whi, wphi, corr);
}

// Byte v of four words, offset by -128 into int8, packed into one word
// (word i in byte i): three byte permutes and one xor.
__device__ __forceinline__ uint32_t digit4(const u64 (&w)[4], int v) {
  const unsigned b = v & 3;
  const unsigned sel = b | ((b + 4) << 4);
  const int sh = v < 4 ? 0 : 32;
  const uint32_t t01 =
      __byte_perm((uint32_t)(w[0] >> sh), (uint32_t)(w[1] >> sh), sel);
  const uint32_t t23 =
      __byte_perm((uint32_t)(w[2] >> sh), (uint32_t)(w[3] >> sh), sel);
  return __byte_perm(t01, t23, 0x5410) ^ 0x80808080u;
}

// -- Hopper primitives (PTX) ----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds bytes to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA tile of a 3-D or 4-D tensor map into shared memory, completing
// on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Descriptor of a K-major operand tile of 32-byte rows in the 32-byte
// swizzle (rows r at r*32, 8-row groups 256 bytes apart; base 256-aligned).
__device__ __forceinline__ uint64_t desc_sw32(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ULL << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Keeps the compiler from moving accesses of registers that asynchronous
// products read or write (accumulators, digit fragments) across them, and
// from giving their registers to other values while the products run.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A x B for one 64 x N x 32 s8 tile pair, A (the digits) in
// registers in the mma fragment layout, B from shared memory: acc = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma<16>(int (&d)[8], const uint32_t (&a)[4],
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<32>(int (&d)[16], const uint32_t (&a)[4],
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// -- the stage kernel -----------------------------------------------------

// Rows of X per window: min(K, 32). A window is D / (32 / KW) ring stages.
__device__ __forceinline__ int window_rows(int K) { return K < kZ ? K : kZ; }

// Shared memory of one block: the X tiles, the ring of table tiles, the
// mbarriers (full and empty per table stage and per X tile).
template <int D, int EPI>
struct Smem {
  unsigned char* xt;  // [kXSlots][kXBytes]
  unsigned char* tt;  // [ring][t_bytes]
  uint64_t *full, *empty, *xfull, *xempty;
  __device__ explicit Smem(unsigned char* raw) {
    unsigned char* s = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    constexpr int R = ring<D, EPI>();
    xt = s;
    tt = xt + kXSlots * kXBytes;
    full = reinterpret_cast<uint64_t*>(tt + R * t_bytes<D, EPI>());
    empty = full + R;
    xfull = empty + R;
    xempty = xfull + kXSlots;
  }
};

// The producer warpgroup's first thread: per window the block's X tile,
// per ring stage the table tile, each by TMA on its full barrier once its
// slot is free.
template <int D, int IN, int EPI>
__device__ __forceinline__ void produce(const Stage& a, const Smem<D, EPI>& sm,
                                        int b, int j0, int o0, int c) {
  constexpr int R = ring<D, EPI>();
  constexpr int TO = tile_o<D, EPI>();
  const int KW = window_rows(a.K);
  const int vps = kZ / KW;  // digit planes per stage
  const int spw = D / vps;  // stages per window
  const int PJ = a.J < kTileJ ? a.J : kTileJ;
  const int tx = D * (a.O < TO ? a.O : TO) * kZ;
  const int nparts = key_sums<EPI>() ? a.P : 1;
  int it = 0, win = 0;
  for (int p = 0; p < nparts; ++p) {
    const int bb = key_sums<EPI>() ? b * a.P + p : b;
    for (int k0 = 0; k0 < a.K; k0 += KW, ++win) {
      const int xs = win % kXSlots;
      mbar_wait(&sm.xempty[xs], ((win / kXSlots) & 1) ^ 1);
      mbar_arrive_tx(&sm.xfull[xs], KW * PJ * 8);
      if (IN == kRows)
        tma_load_4d(sm.xt + xs * kXBytes, &a.xmap, j0, k0, c, bb,
                    &sm.xfull[xs]);
      else
        tma_load_4d(sm.xt + xs * kXBytes, &a.xmap, k0, j0, c, bb,
                    &sm.xfull[xs]);
      for (int s = 0; s < spw; ++s, ++it) {
        const int slot = it % R;
        mbar_wait(&sm.empty[slot], ((it / R) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[slot], tx);
        tma_load_3d(sm.tt + slot * t_bytes<D, EPI>(), &a.tmap,
                    s * vps * a.K + k0, o0, c * D, &sm.full[slot]);
      }
    }
  }
}

// A consumer warpgroup (wg 0 or 1: columns wg*64.. of the tile): per
// window the digit fragments of its X words, per ring stage one wgmma per
// table plane, then per part the recombination (MR: its Montgomery form)
// and the epilogue.
template <int D, int IN, int EPI, bool MR = false>
__device__ __forceinline__ void consume(const Stage& a, const Smem<D, EPI>& sm,
                                        int b, int j0, int o0, int c, int wg) {
  constexpr int R = ring<D, EPI>();
  constexpr int TO = tile_o<D, EPI>();
  constexpr int NF = TO / 8;  // 8-row fragments of the output a thread
  constexpr bool kSum = key_sums<EPI>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KW = window_rows(a.K);
  const int vps = kZ / KW;
  const int spw = D / vps;
  const int PJ = a.J < kTileJ ? a.J : kTileJ;
  const int rows = a.O < TO ? a.O : TO;
  const bool signal = (threadIdx.x & 127) == 0;
  const int jl = wg * 64 + warp * 16 + g;  // tile column of fragment row 0
  const int nparts = kSum ? a.P : 1;

  int acc[D][TO / 2];
  uint32_t f[D][4];  // a window's digit fragments, one set per stage
  u64 sum0[NF][2][2], sum1[NF][2][2];  // kSum: [fragment][row half][col]
  int it = 0, win = 0, pending = -1;
  const int* rs = a.rs + (size_t)c * D * a.O;
  const u64 q = a.q[c];
  // The recombination's constants: (bp, whi, wphi, corr), or with MR
  // (k, c_lo, c_hi) in the first three.
  const u64 bp = MR ? a.k[c] : a.bp[c];
  const u64 whi = MR ? a.clo[c] : a.whi[c];
  const u64 wphi = MR ? a.chi[c] : a.wphi[c];
  const u64 corr = MR ? 0 : a.corr[c];
  for (int p = 0; p < nparts; ++p) {
    bool first = true;
    for (int k0 = 0; k0 < a.K; k0 += KW, ++win) {
      // The previous window's products read the fragments: drain them.
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < D; ++s) fence_regs(f[s]);
      if (pending >= 0 && signal) mbar_arrive(&sm.empty[pending]);
      pending = -1;
      // The words of fragment rows jl, jl + 8, window rows 4q .. 4q + 3
      // for q = t (and t + 4 when KW = 32), and their digits per plane:
      // fragment register r holds row jl + 8 (r & 1), plane s (KW = 32,
      // quad t + 4 (r >> 1)) or plane 2s + (r >> 1) (KW = 16, quad t).
      const int xs = win % kXSlots;
      mbar_wait(&sm.xfull[xs], (win / kXSlots) & 1);
      const u64* xw = reinterpret_cast<const u64*>(sm.xt + xs * kXBytes);
      u64 w[2][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int qi = 0; qi < 2; ++qi) {
          const int k = 4 * (t + 4 * qi);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[h][qi][i] = (qi == 0 || vps == 1)
                              ? (IN == kRows ? xw[(k + i) * PJ + jl + 8 * h]
                                             : xw[(jl + 8 * h) * KW + k + i])
                              : 0;
        }
      // The next TMA into this tile is an async-proxy write after these
      // generic reads: fence the proxies before releasing the tile (without
      // it the silver key sums read words of the following window).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&sm.xempty[xs]);
#pragma unroll
      for (int s = 0; s < D; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          f[s][r] = vps == 1 ? digit4(w[r & 1][r >> 1], s)
                             : digit4(w[r & 1][0], 2 * s + (r >> 1));
#pragma unroll
      for (int s = 0; s < D; ++s) {
        if (s >= spw) break;
        const int slot = it % R;
        mbar_wait(&sm.full[slot], (it / R) & 1);
        const unsigned char* tt = sm.tt + slot * t_bytes<D, EPI>();
#pragma unroll
        for (int u = 0; u < D; ++u) fence_regs(acc[u]);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < D; ++u)
          wgmma<TO>(acc[u], f[s], desc_sw32(tt + u * rows * kZ), !first);
        wgmma_commit();
#pragma unroll
        for (int u = 0; u < D; ++u) fence_regs(acc[u]);
        if (pending >= 0) {
          wgmma_wait<1>();
          if (signal) mbar_arrive(&sm.empty[pending]);
        }
        pending = slot;
        first = false;
        ++it;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < D; ++s) fence_regs(f[s]);
    if (signal) mbar_arrive(&sm.empty[pending]);
    pending = -1;
#pragma unroll
    for (int u = 0; u < D; ++u) fence_regs(acc[u]);

    // acc[u][4i + 2h + e]: column j0 + jl + 8h, row o0 + 8i + 2t + e.
    if constexpr (kSum) {
      // Both key products of each element, added to the sums; the key
      // words are loaded element by element (the sums hold 2 * TO
      // registers, and loads batched ahead spill).
#pragma unroll
      for (int i = 0; i < NF; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + 8 * i + 2 * t + e;
          if (o >= a.O) continue;
          int r[D];
#pragma unroll
          for (int u = 0; u < D; ++u) r[u] = rs[u * a.O + o];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + jl + 8 * h;
            if (j >= a.J) continue;
            int ev[D];
#pragma unroll
            for (int u = 0; u < D; ++u)
              ev[u] = acc[u][4 * i + 2 * h + e] + r[u];
            const u64 val = rec<D, MR>(ev, q, bp, whi, wphi, corr);
            const long long ki =
                p * a.k_sp + c * a.k_sc + (long long)o * a.J + j;
            u64 p0, p1;
            if (EPI == kKsk) {
              p0 = shoup_mul(val, a.k0w[ki], a.k0wp[ki], q);
              p1 = shoup_mul(val, a.k1w[ki], a.k1wp[ki], q);
            } else {
              p0 = montmul(val, a.k0w[ki], q, a.k[c]);
              p1 = montmul(val, a.k1w[ki], q, a.k[c]);
            }
            sum0[i][h][e] = p ? csub_u(sum0[i][h][e] + p0, 2 * q) : p0;
            sum1[i][h][e] = p ? csub_u(sum1[i][h][e] + p1, 2 * q) : p1;
          }
        }
    } else {
      // The words of fragment i: its loads first (indices clamped into the
      // tile), then the arithmetic and the stores of the elements inside
      // it: one memory latency per fragment, not per element.
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        u64 tw[4];  // (h, e) at 2h + e
        long long n[4];
        bool ok[4];
        int r[2][D];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = m & 1, h = m >> 1;
          const int o = o0 + 8 * i + 2 * t + e, j = j0 + jl + 8 * h;
          const int oc = o < a.O ? o : a.O - 1;
          const int jc = j < a.J ? j : a.J - 1;
          ok[m] = o < a.O && j < a.J;
          n[m] = (long long)oc * a.J + jc;
          if (h == 0) {
#pragma unroll
            for (int u = 0; u < D; ++u) r[e][u] = rs[u * a.O + oc];
          }
          if (EPI == kTwiddle)
            tw[m] = a.tw[(long long)c * a.N +
                         (a.tw_t ? (long long)jc * a.O + oc : n[m])];
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = m & 1, h = m >> 1;
          int ev[D];
#pragma unroll
          for (int u = 0; u < D; ++u)
            ev[u] = acc[u][4 * i + 2 * h + e] + r[e][u];
          u64 val = rec<D, MR>(ev, q, bp, whi, wphi, corr);
          if (EPI == kTwiddle) val = montmul(val, tw[m], q, a.k[c]);
          if (EPI == kOut && a.post_reduce) val = csub_u(val, q);
          if (ok[m]) a.y[b * a.y_sb + c * a.y_sc + n[m]] = val;
        }
      }
    }
  }
  if (kSum) {
#pragma unroll
    for (int i = 0; i < NF; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = o0 + 8 * i + 2 * t + e;
          const int j = j0 + jl + 8 * h;
          if (o < a.O && j < a.J) {
            const long long n =
                b * a.y_ss + c * a.y_sc + (long long)o * a.J + j;
            a.y[n] = sum0[i][h][e];
            a.y[a.y_sb + n] = sum1[i][h][e];
          }
        }
  }
}

// One stage: one output tile per block. Grid: (B * ceil(J / 128),
// ceil(O / TO), C), the batch and column tiles of a row tile of a channel
// next to each other (for the key sums B is the segments: a tile walks the
// P parts of its segment);
// kThreads threads: the two consumer warpgroups, then the producer
// warpgroup.
template <int D, int IN, int EPI, bool MR = false>
__global__ void __launch_bounds__(kThreads, 1)
    stage(const __grid_constant__ Stage a) {
  constexpr int R = ring<D, EPI>();
  extern __shared__ unsigned char smem_raw[];
  const Smem<D, EPI> sm(smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(&sm.full[i], 1);   // the producer's arrival and TMA bytes
      mbar_init(&sm.empty[i], 2);  // one thread of each consumer warpgroup
    }
    for (int i = 0; i < kXSlots; ++i) {
      mbar_init(&sm.xfull[i], 1);
      mbar_init(&sm.xempty[i], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  constexpr int TO = tile_o<D, EPI>();
  const int jt = (a.J + kTileJ - 1) / kTileJ;
  const int b = blockIdx.x / jt, j0 = (blockIdx.x % jt) * kTileJ;
  const int o0 = blockIdx.y * TO, c = blockIdx.z;
  if (threadIdx.x >= 256) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) produce<D, IN, EPI>(a, sm, b, j0, o0, c);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, IN, EPI, MR>(a, sm, b, j0, o0, c, threadIdx.x >> 7);
  }
}

// -- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

inline int encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                  const void* base, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// The table [C, D*O, D*K] (int8) as the 3-D array {D*K, O, D*C}
// (innermost first): a box is kZ table columns of min(O, TO) rows of D
// planes, in the 32-byte swizzle.
inline int encode_table(CUtensorMap* map, const void* table, int D, int O,
                        int K, int C, int TO) {
  const cuuint64_t dims[3] = {(cuuint64_t)D * K, (cuuint64_t)O,
                              (cuuint64_t)D * C};
  const cuuint64_t strides[2] = {(cuuint64_t)D * K, (cuuint64_t)O * D * K};
  const cuuint32_t box[3] = {kZ, (cuuint32_t)(O < TO ? O : TO), (cuuint32_t)D};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, table, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_32B);
}

// The input words (b, c, k, j) of B batch elements as the 4-D array
// {J, K, C, B} (rows in) or {K, J, C, B} (columns in): a box is
// min(K, 32) rows of min(J, 128) columns of one channel and element.
inline int encode_words(CUtensorMap* map, const Stage& a, int IN, int C,
                        int B) {
  const cuuint64_t inner = IN == kRows ? a.J : a.K;
  const cuuint64_t outer = IN == kRows ? a.K : a.J;
  const cuuint64_t dims[4] = {inner, outer, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {inner * 8, (cuuint64_t)a.x_sc * 8,
                                 (cuuint64_t)a.x_sb * 8};
  const cuuint32_t kw = a.K < kZ ? a.K : kZ;
  const cuuint32_t pj = a.J < kTileJ ? a.J : kTileJ;
  const cuuint32_t box[4] = {IN == kRows ? pj : kw, IN == kRows ? kw : pj, 1,
                             1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, a.x, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int D, int IN, int EPI, bool MR>
int launch_d(Stage a, int B, int C, cudaStream_t st) {
  constexpr int TO = tile_o<D, EPI>();
  constexpr bool kSum = key_sums<EPI>();
  int rc = encode_table(&a.tmap, a.table, D, a.O, a.K, C, TO);
  if (rc == 0) rc = encode_words(&a.xmap, a, IN, C, kSum ? B * a.P : B);
  if (rc != 0) return rc;
  const dim3 grid(B * ((a.J + kTileJ - 1) / kTileJ),
                  (a.O + TO - 1) / TO, C);
  constexpr int smem = stage_smem<D, EPI>();
  rc = (int)cudaFuncSetAttribute(stage<D, IN, EPI, MR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  if (rc != 0) return rc;
  stage<D, IN, EPI, MR><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Digit counts with kernels: (4, 4) for 30-bit primes, (6, 6) for 40-bit,
// (8, 8) for 60-bit. -1 for any other. MR: the Montgomery recombination.
template <int IN, int EPI, bool MR = false>
int launch(int d, const Stage& a, int B, int C, cudaStream_t st) {
  switch (d) {
    case 4: return launch_d<4, IN, EPI, MR>(a, B, C, st);
    case 6: return launch_d<6, IN, EPI, MR>(a, B, C, st);
    case 8: return launch_d<8, IN, EPI, MR>(a, B, C, st);
    default: return -1;
  }
}

// The geometry of the stage at d digits, as stage_geometry() in
// ntt/cuda_mxu.py computes it: {TO, ring stages, shared memory bytes} of
// the transform stages, the same of the key-sum stage, then {kZ, columns
// per block, X tiles, threads, registers of a producer and of a consumer
// thread}.
template <int D>
void geometry_d(int* out) {
  const int g[12] = {tile_o<D, kOut>(),     ring<D, kOut>(),
                     stage_smem<D, kOut>(), tile_o<D, kKsk>(),
                     ring<D, kKsk>(),       stage_smem<D, kKsk>(),
                     kZ,                    kTileJ,
                     kXSlots,               kThreads,
                     kProducerRegs,         kConsumerRegs};
  for (int i = 0; i < 12; ++i) out[i] = g[i];
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
