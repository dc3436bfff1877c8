// Forward and inverse negacyclic NTT of one width group, natural order, as
// two int8 tensor-core stages each (the four-step transform).
//
// Replaces: liberate_tpu/ntt/mxu_pallas.py `_ntt_kernel` (:143) and
// `_intt_kernel` (:163), launched per width group by `_call` (:190) and
// `dispatch` (:312), with the Shoup recombination (shoup_rec=True) or the
// Montgomery one (shoup_rec=False, as the XLA composition
// liberate_tpu/ntt/mxu_ntt.py `ntt` and `intt_no_norm_factor` :494-540,
// which the JAX engine runs with use_mxu_pallas off), the `enter`
// (Montgomery entry folded into stage 1: the m1e tables), `exitx`
// (Montgomery exit folded into stage 2: the i2x tables) and `post_reduce`
// variants. Same words as the Pallas kernels.
//
// What bounds it on the H100: the int8 multiply-accumulates, about
// (dA dB S^2 R + dA dB R^2 S) per channel and polynomial (453e6 at silver
// for the 40-bit primes' (6, 6) digits), against 1979e12 int8 operations
// per second; then the L2 traffic of the blocks' tiles: a channel's table
// crosses L2 once per 128 columns of B * J, its data once per 32 rows of
// the output; and the data in device memory (two 8-byte words per
// coefficient, read and written once).
//
// Design: a channel's [S, R] intermediate is 256 KB at silver, more than a
// block's shared memory, and stage 2 contracts along the other axis. So
// each transform is two launches of the stage kernel of mxu.cuh (TMA rings
// of table and data tiles, digits made once per block in registers, one
// wgmma per table plane) through global memory, the intermediate staying
// in L2: stage 1 multiplies by the stage-1 table and applies the twiddle
// in its epilogue; stage 2 reads the intermediate transposed (its TMA box
// runs along the intermediate's rows) and writes the result. Both launches put the batch and the column tiles of one channel
// and row tile next to each other in the grid, so the channel's tables
// are read from device memory about once for the whole batch.
#include "mxu.cuh"

using mxu::Stage;

// x: [B, C, N] words with element strides (sb, sc, 1); y: output with
// strides (ysb, ysc, 1); scratch: contiguous [B, C, N]. t1/r1, tw, t2/r2:
// the group's stage tables (the caller picks m1 or m1e, i2 or i2x).
// Per-channel constants q, k, bp, whi, wphi, corr, clo, chi: [C]. d = dA =
// dB. mont_rec: recombine in the Montgomery form (clo, chi), else in the
// Shoup form (bp, whi, wphi, corr).
extern "C" int ltt_mxu_ntt(int inverse, int d, const void* x, long long sb,
                           long long sc, void* y, long long ysb,
                           long long ysc, void* scratch, int B, int C,
                           int logN, const void* t1, const void* r1,
                           const void* tw, const void* t2, const void* r2,
                           const void* q, const void* k, const void* bp,
                           const void* whi, const void* wphi,
                           const void* corr, const void* clo,
                           const void* chi, int mont_rec, int post_reduce,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = 1 << logN;
  const int S = 1 << ((logN + 1) / 2);
  const int R = N / S;
  // Forward: [S, R] -> stage 1 contracts s -> [S(k2), R(r)] -> stage 2
  // contracts r -> [R(k1), S(k2)]. Inverse: [R(k1), S(k2)] -> stage 1
  // contracts k1 -> [R(j), S(k2)] -> stage 2 contracts k2 -> [S(s), R(j)].
  const int O1 = inverse ? R : S, J1 = inverse ? S : R;
  Stage a = mxu::shape(O1, O1, J1, N);
  a.x = (const u64*)x;
  a.x_sb = sb;
  a.x_sc = sc;
  a.y = (u64*)scratch;
  a.y_sb = (long long)C * N;
  a.y_sc = N;
  a.table = (const int8_t*)t1;
  a.rs = (const int*)r1;
  a.tw = (const u64*)tw;
  a.tw_t = inverse;
  a.q = (const u64*)q;
  a.k = (const u64*)k;
  a.bp = (const u64*)bp;
  a.whi = (const u64*)whi;
  a.wphi = (const u64*)wphi;
  a.corr = (const u64*)corr;
  a.clo = (const u64*)clo;
  a.chi = (const u64*)chi;
  int rc = mont_rec
               ? mxu::launch<mxu::kRows, mxu::kTwiddle, true>(d, a, B, C, st)
               : mxu::launch<mxu::kRows, mxu::kTwiddle>(d, a, B, C, st);
  if (rc != 0) return rc;

  Stage b = a;
  b.O = b.K = J1;
  b.J = O1;
  b.x = (const u64*)scratch;
  b.x_sb = (long long)C * N;
  b.x_sc = N;
  b.y = (u64*)y;
  b.y_sb = ysb;
  b.y_sc = ysc;
  b.table = (const int8_t*)t2;
  b.rs = (const int*)r2;
  b.tw = nullptr;
  b.post_reduce = post_reduce;
  return mont_rec ? mxu::launch<mxu::kCols, mxu::kOut, true>(d, b, B, C, st)
                  : mxu::launch<mxu::kCols, mxu::kOut>(d, b, B, C, st);
}

// The stage kernel's geometry at d digits (see mxu::geometry_d): 12 ints
// into out. -1 for a digit count without a kernel.
extern "C" int ltt_mxu_geometry(int d, int* out) {
  switch (d) {
    case 4: mxu::geometry_d<4>(out); return 0;
    case 6: mxu::geometry_d<6>(out); return 0;
    case 8: mxu::geometry_d<8>(out); return 0;
    default: return -1;
  }
}
