// The key switch of one width group on the tensor-core NTT: with the
// special-prime mod-down folded in (ltt_mxu_switch), or without it
// (ltt_mxu_switch_inv), and its core from extension words that the caller
// gives (ltt_mxu_ksk_accum).
//
// Replaces, ltt_mxu_switch: liberate_tpu/ntt/mxu_pallas.py
// `_make_md_kernel` (:815, body :839), launched per width group by
// `_ksk_from_state_md_call` (:1039) and `dispatch_ksk_from_state` (:1127),
// in both modes: `special` (the group holding the special primes: its
// dropped rows are iterated and exported) and `ordinary` (the other
// groups: they consume the exported rows). Same words as the Pallas
// kernel; its ordinary rows also equal what ltt_mxu_switch_inv followed by
// the engine's separate mod-down gives (tests/test_torch_switch.py holds
// the two routes' mult words equal at one, two, four and six special
// primes).
//
// Replaces, ltt_mxu_switch_inv: `_ext_mulacc_inv_kernel_sk` (:777, Shoup-form
// key: value and quotient stacks) and `_ext_mulacc_inv_kernel` (:588,
// Montgomery-form key), both launched per width group by
// `ksk_accum_from_state` (:994) from `dispatch_ksk_from_state` (:1179-1203)
// when the mod-down is not folded (logN 16 and up, or a Montgomery-form
// key). Its output goes through the engine's separate Shoup mod-down.
//
// Replaces, ltt_mxu_ksk_accum: `_mulacc_inv_kernel` (:574, body
// `_mulacc_inv_tail` :490, launched by `_ksk_accum_inv_call` :721) with
// fold_inverse, and `_mulacc_kernel` (:433, launched by `ntt_ksk_accum`
// :679) without, both per width group from `dispatch_ksk_accum` (:350),
// Montgomery-form key only (the Pallas kernels have no working Shoup-key
// branch): launches 2-5, or 2-3 with the key sums as the output in the
// natural-order NTT domain ([R(k1), S(k2)], as mxu_ntt.ntt orders it).
//
// Ct-batched part segments (the Pallas kernels' grid (C, B*P), ``parts=``
// of `ksk_accum_from_state` :945-952): the state holds B segments of P
// parts, b-major, part-fastest (bp = b*P + p); each segment is one
// ciphertext's switch under the same key (read at part p, as the Pallas
// key block at `p % P + part_off` :988-990), its sums restart at the
// segment and its outputs are its own: [2][B][C][N], and with the fold its
// dropped rows [B][2 n_sp][N] (:1096-1105). B = 1 is the one-ciphertext
// switch.
//
// Per (channel, part) both compute the Shoup basis extension of the part's
// raw divided-difference state, the forward four-step transform, both key
// products (Shoup, or Montgomery as mxu_pallas.py:525-526), the sum over
// the parts (a conditional subtract after each add), and the inverse
// transform of both sums with the plain reduce to [0, q).
//
// What bounds it on the H100: about equally the int8 multiply-accumulates
// of the P forward and two inverse transforms per channel and the bytes of
// the key (value and quotient of both halves: 32 bytes per coefficient,
// channel and part in Shoup form, 16 in Montgomery form), then the table
// tiles that every block streams from L2 through its ring (in stage 2 once
// per part, and once per segment).
//
// Design: the Pallas kernels walk the parts sequentially per channel with
// both sums in VMEM; Hopper blocks run in no order, and a channel does not
// fit a block. So the switch is five launches through global memory (L2),
// the four transform stages being the stage kernel of mxu.cuh (TMA rings
// of table and data tiles, digits made once per block in registers, one
// wgmma per table plane), and the fold a sixth:
//   1. the extension of every part of every segment onto every channel,
//      elementwise (once per word: the stage blocks of one channel would
//      each repeat it);
//   2. stage 1 of the forward transform of every part (B*P polynomials);
//   3. stage 2, where each block loops over the parts of its segment and
//      tile (the table tiles stream through its ring once per part), keeps
//      both key-product sums in registers and reads the key words in its
//      epilogue;
//   4./5. the two inverse stages of both sums of every segment (2B
//      polynomials), the last with the reduce;
//   6. (ltt_mxu_switch only) the mod-down fold: one thread per (half,
//      segment, coefficient) walks the special group's dropped rows in
//      drop order,
//      exports them, and applies the removal steps to every ordinary
//      channel of the group. The cross-channel dependency of the dropped
//      rows is thereby inside one thread, and the dependency between groups
//      is the launch order.
#include "mxu.cuh"

using mxu::Stage;

namespace {

constexpr int kMaxSpecial = 8;
constexpr int kThreads = 256;

// The Shoup basis extension of segment part bp = b*P + p onto channel c
// with part p's scalars: every state row may be wrapped-signed, so each is
// offset by 2^63 and corrected per channel
// (liberate_tpu/ntt/mxu_pallas.py:862-872). Grid (N / kThreads, C, B*P).
__global__ void extend(const u64* st, int P, int A, int N, const u64* terms,
                       int nterms, int ldc, const u64* off0, const u64* qv,
                       const u64* bpv, u64* ext) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int c = blockIdx.y, bp = blockIdx.z, p = bp % P, C = gridDim.y;
  const u64 q = qv[c], q2 = 2 * q;
  const u64* s = st + (long long)bp * A * N + n;
  u64 acc = mxu::csub_u(mxu::barrett_2q(s[0] + mxu::kTop, bpv[c], q) + off0[c],
                        q2);
  for (int i = 1; i < A; ++i) {
    const u64* tm = terms + (long long)((p * nterms + i - 1) * 3) * ldc + c;
    const u64 e = mxu::csub_u(
        shoup_mul(s[(long long)i * N] + mxu::kTop, tm[0], tm[ldc], q) +
            tm[2 * ldc],
        q2);
    acc = mxu::csub_u(acc + e, q2);
  }
  ext[((long long)bp * C + c) * N + n] = acc;
}

// The removal steps are modarith.cuh's md_iter, as in the standalone
// mod-down (csrc/mod_down.cu). r: the group's reduced rows [2][B][C] with
// strides (B * r_sb, r_sb, N); special: the group's last n_sp channels
// are the dropped ones (last first); srcs: [B][2 * n_sp][N] rows, written
// in the special mode and read otherwise. piw: [n_sp, 2, ldc] (P_j^-1 and
// its Shoup quotient per channel).
__global__ void fold(u64* r, long long r_sb, int B, int C, int N, int n_sp,
                     int special, const u64* srcs_in, u64* srcs_out,
                     const u64* piw, int ldc, const u64* qv,
                     const u64* bpv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2LL * B * N) return;
  const int hb = (int)(idx / N), half = hb / B, b = hb % B;
  const long long n = idx % N;
  u64* rh = r + hb * r_sb;
  const long long srow = (long long)(b * 2 + half) * n_sp;
  u64 src[kMaxSpecial];
  if (special) {
    for (int kk = 0; kk < n_sp; ++kk) {
      const int ch = C - 1 - kk;
      const u64 q = qv[ch], bp = bpv[ch];
      u64 v = rh[(long long)ch * N + n];
      for (int j = 0; j < kk; ++j)
        v = mxu::csub_u(md_iter(v, src[j], piw[(2 * j) * ldc + ch],
                                piw[(2 * j + 1) * ldc + ch], q, bp),
                        q);
      src[kk] = v;
      srcs_out[(srow + kk) * N + n] = v;
    }
  } else {
    for (int kk = 0; kk < n_sp; ++kk)
      src[kk] = srcs_in[(srow + kk) * N + n];
  }
  const int nord = special ? C - n_sp : C;
  for (int ch = 0; ch < nord; ++ch) {
    const u64 q = qv[ch], bp = bpv[ch];
    u64 v = rh[(long long)ch * N + n];
    for (int j = 0; j < n_sp; ++j)
      v = md_iter(v, src[j], piw[(2 * j) * ldc + ch],
                  piw[(2 * j + 1) * ldc + ch], q, bp);
    rh[(long long)ch * N + n] = mxu::csub_u(v, q);
  }
}

// Launches 2-5 (2-3 without ``inverse``) on the extension words ext
// [B*P][C][N] (B segments of P parts), element strides (ext_sp, ext_sc, 1),
// below 2^(8 d): stage 1 of the forward transform of every part, stage 2
// with both key products summed over each segment's parts into acc
// [2][B][C][N] (strides (B * acc_sb, acc_sb, N, 1), natural-order NTT
// domain [0, 2q)), and with ``inverse`` the two inverse stages of every
// sum into out (strides (B * out_sb, out_sb, N, 1)), reduced to [0, q).
// mont: Montgomery-form key stacks (k0w, k1w; the quotient pointers are
// unused), else Shoup-form pairs.
int accum_core(int d, int mont, int inverse, const void* ext,
               long long ext_sp, long long ext_sc, int B, int P,
               const void* k0w, const void* k0wp, const void* k1w,
               const void* k1wp, long long k_sp, long long k_sc,
               void* inter1, void* acc, long long acc_sb, void* inter2,
               void* out, long long out_sb, int C, int logN,
               const void* m1, const void* r1,
               const void* tw, const void* m2, const void* r2,
               const void* i1, const void* ir1, const void* itw,
               const void* i2, const void* ir2, const void* q, const void* k,
               const void* bp, const void* whi, const void* wphi,
               const void* corr, cudaStream_t s) {
  const int N = 1 << logN;
  const int S = 1 << ((logN + 1) / 2);
  const int R = N / S;
  const long long CN = (long long)C * N;

  // 2. forward stage 1 of every part
  Stage a = mxu::shape(S, S, R, N);
  a.q = (const u64*)q;
  a.k = (const u64*)k;
  a.bp = (const u64*)bp;
  a.whi = (const u64*)whi;
  a.wphi = (const u64*)wphi;
  a.corr = (const u64*)corr;
  a.x = (const u64*)ext;
  a.x_sb = ext_sp;
  a.x_sc = ext_sc;
  a.y = (u64*)inter1;
  a.y_sb = CN;
  a.y_sc = N;
  a.table = (const int8_t*)m1;
  a.rs = (const int*)r1;
  a.tw = (const u64*)tw;
  a.tw_t = 0;
  int rc = mxu::launch<mxu::kRows, mxu::kTwiddle>(d, a, B * P, C, s);
  if (rc != 0) return rc;

  // 3. forward stage 2, both key products summed over each segment's parts
  Stage b = a;
  b.O = b.K = R;
  b.J = S;
  b.x = (const u64*)inter1;
  b.x_sb = CN;
  b.x_sc = N;
  b.y = (u64*)acc;
  b.y_sb = B * acc_sb;
  b.y_ss = acc_sb;
  b.y_sc = N;
  b.table = (const int8_t*)m2;
  b.rs = (const int*)r2;
  b.tw = nullptr;
  b.k0w = (const u64*)k0w;
  b.k0wp = (const u64*)k0wp;
  b.k1w = (const u64*)k1w;
  b.k1wp = (const u64*)k1wp;
  b.k_sp = k_sp;
  b.k_sc = k_sc;
  b.P = P;
  rc = mont ? mxu::launch<mxu::kCols, mxu::kKskMont>(d, b, B, C, s)
            : mxu::launch<mxu::kCols, mxu::kKsk>(d, b, B, C, s);
  if (rc != 0 || !inverse) return rc;

  // 4. inverse stage 1 of every sum
  Stage c = mxu::shape(R, R, S, N);
  c.q = a.q;
  c.k = a.k;
  c.bp = a.bp;
  c.whi = a.whi;
  c.wphi = a.wphi;
  c.corr = a.corr;
  c.x = (const u64*)acc;
  c.x_sb = acc_sb;
  c.x_sc = N;
  c.y = (u64*)inter2;
  c.y_sb = CN;
  c.y_sc = N;
  c.table = (const int8_t*)i1;
  c.rs = (const int*)ir1;
  c.tw = (const u64*)itw;
  c.tw_t = 1;
  rc = mxu::launch<mxu::kRows, mxu::kTwiddle>(d, c, 2 * B, C, s);
  if (rc != 0) return rc;

  // 5. inverse stage 2 with the reduce to [0, q)
  Stage e = c;
  e.O = e.K = S;
  e.J = R;
  e.x = (const u64*)inter2;
  e.x_sb = CN;
  e.y = (u64*)out;
  e.y_sb = out_sb;
  e.table = (const int8_t*)i2;
  e.rs = (const int*)ir2;
  e.tw = nullptr;
  e.post_reduce = 1;
  return mxu::launch<mxu::kCols, mxu::kOut>(d, e, 2 * B, C, s);
}

// Launches 1-5: the extension of every part of every segment into ext
// [B*P, C, N], then accum_core with the inverse.
int switch_core(int d, int mont, const void* st, int B, int P, int A,
                const void* terms, int nterms, int ldc, const void* off0,
                const void* k0w, const void* k0wp, const void* k1w,
                const void* k1wp, long long k_sp, long long k_sc, void* ext,
                void* inter1, void* acc, void* inter2, void* out,
                long long out_sb, int C, int logN, const void* m1,
                const void* r1, const void* tw, const void* m2,
                const void* r2, const void* i1, const void* ir1,
                const void* itw, const void* i2, const void* ir2,
                const void* q, const void* k, const void* bp,
                const void* whi, const void* wphi, const void* corr,
                cudaStream_t s) {
  const int N = 1 << logN;
  const long long CN = (long long)C * N;

  // 1. the extension of every part of every segment
  extend<<<dim3((unsigned)((N + kThreads - 1) / kThreads), C, B * P),
           kThreads, 0, s>>>((const u64*)st, P, A, N, (const u64*)terms,
                             nterms, ldc, (const u64*)off0, (const u64*)q,
                             (const u64*)bp, (u64*)ext);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return accum_core(d, mont, 1, ext, CN, N, B, P, k0w, k0wp, k1w, k1wp,
                    k_sp, k_sc, inter1, acc, CN, inter2, out, out_sb, C,
                    logN, m1, r1, tw, m2, r2, i1, ir1, itw, i2, ir2, q, k,
                    bp, whi, wphi, corr, s);
}

}  // namespace

// st: [B*P, A, N] raw state rows (B segments of P parts); terms:
// [P, nterms, 3, ldc] and piw: [n_sp, 2, ldc] (pointers at the group's
// first channel); off0: [C]. k*: the Shoup-form key stacks [P_full, C0, N]
// at (part_off, first key channel) with strides (k_sp, k_sc, 1). ext,
// inter1: scratch [B*P, C, N]; acc, inter2: scratch [2, B, C, N]; out:
// [2][B][C][N] with strides (B * out_sb, out_sb, N, 1); srcs: [B][2 n_sp][N].
// m1 .. ir2: the group's tables; q .. corr: [C].
extern "C" int ltt_mxu_switch(
    int d, int special, int n_sp, const void* st, int B, int P, int A,
    const void* terms, int nterms, int ldc, const void* off0,
    const void* piw, const void* k0w, const void* k0wp, const void* k1w,
    const void* k1wp, long long k_sp, long long k_sc, const void* srcs_in,
    void* srcs_out, void* ext, void* inter1, void* acc, void* inter2,
    void* out,
    long long out_sb, int C, int logN, const void* m1, const void* r1,
    const void* tw, const void* m2, const void* r2, const void* i1,
    const void* ir1, const void* itw, const void* i2, const void* ir2,
    const void* q, const void* k, const void* bp, const void* whi,
    const void* wphi, const void* corr, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_sp > kMaxSpecial) return -1;
  const int rc = switch_core(d, 0, st, B, P, A, terms, nterms, ldc, off0,
                             k0w, k0wp, k1w, k1wp, k_sp, k_sc, ext, inter1,
                             acc, inter2, out, out_sb, C, logN, m1, r1, tw,
                             m2, r2, i1, ir1, itw, i2, ir2, q, k, bp, whi,
                             wphi, corr, s);
  if (rc != 0) return rc;

  // 6. the mod-down fold
  const int N = 1 << logN;
  fold<<<(unsigned)((2LL * B * N + kThreads - 1) / kThreads), kThreads, 0,
         s>>>((u64*)out, out_sb, B, C, N, n_sp, special,
              (const u64*)srcs_in, (u64*)srcs_out, (const u64*)piw, ldc,
              (const u64*)q, (const u64*)bp);
  return (int)cudaGetLastError();
}

// The switch without the mod-down: arguments as ltt_mxu_switch's, minus the
// fold's; mont: k0w, k1w are Montgomery-form key stacks (k0wp, k1wp
// unused), else the Shoup-form pairs.
extern "C" int ltt_mxu_switch_inv(
    int d, int mont, const void* st, int B, int P, int A, const void* terms,
    int nterms, int ldc, const void* off0, const void* k0w,
    const void* k0wp, const void* k1w, const void* k1wp, long long k_sp,
    long long k_sc, void* ext, void* inter1, void* acc, void* inter2,
    void* out, long long out_sb, int C, int logN, const void* m1,
    const void* r1, const void* tw, const void* m2, const void* r2,
    const void* i1, const void* ir1, const void* itw, const void* i2,
    const void* ir2, const void* q, const void* k, const void* bp,
    const void* whi, const void* wphi, const void* corr, void* stream) {
  return switch_core(d, mont, st, B, P, A, terms, nterms, ldc, off0, k0w,
                     k0wp, k1w, k1wp, k_sp, k_sc, ext, inter1, acc, inter2,
                     out, out_sb, C, logN, m1, r1, tw, m2, r2, i1, ir1, itw,
                     i2, ir2, q, k, bp, whi, wphi, corr,
                     (cudaStream_t)stream);
}

// The switch from extension words: ext [P][C][N] in [0, 2q) with element
// strides (ext_sp, ext_sc, 1), Montgomery-form key stacks k0, k1 at
// (part_off, first key channel) with strides (k_sp, k_sc, 1). With
// fold_inverse, launches 2-5 into out [2][C][N] (strides (out_sh, N, 1)),
// coefficient domain [0, q); without, launches 2-3 with the key sums
// written to out, natural-order NTT domain [0, 2q) (acc and inter2 are
// then unused). inter1: scratch [P, C, N]; acc, inter2: scratch [2, C, N].
extern "C" int ltt_mxu_ksk_accum(
    int d, int fold_inverse, const void* ext, long long ext_sp,
    long long ext_sc, int P, const void* k0, const void* k1, long long k_sp,
    long long k_sc, void* inter1, void* acc, void* inter2, void* out,
    long long out_sh, int C, int logN, const void* m1, const void* r1,
    const void* tw, const void* m2, const void* r2, const void* i1,
    const void* ir1, const void* itw, const void* i2, const void* ir2,
    const void* q, const void* k, const void* bp, const void* whi,
    const void* wphi, const void* corr, void* stream) {
  const long long CN = (long long)C << logN;
  return accum_core(d, 1, fold_inverse, ext, ext_sp, ext_sc, 1, P, k0,
                    nullptr, k1, nullptr, k_sp, k_sc, inter1,
                    fold_inverse ? acc : out, fold_inverse ? CN : out_sh,
                    inter2, out, out_sh, C, logN, m1, r1, tw, m2, r2, i1,
                    ir1, itw, i2, ir2, q, k, bp, whi, wphi, corr,
                    (cudaStream_t)stream);
}
