"""The tensor-core ("MXU") kernels: CUDA wrappers, their plain PyTorch twins
and their launch counters.

Six kernels (sources in ``liberate_tpu_torch/csrc``):

- ``mxu_ntt_fwd``: forward negacyclic NTT of one width group, natural
  order, as two int8 matrix-product stages; ``enter`` folds the Montgomery
  entry into stage 1 (replaces ``mxu_pallas._ntt_kernel``);
- ``mxu_ntt_inv``: the inverse with N^-1 folded into stage 2; ``exitx``
  also folds the Montgomery exit, ``post_reduce`` reduces to [0, q)
  (replaces ``mxu_pallas._intt_kernel``);
  both recombine the digit planes in the form of their plan
  (``MxuPlan.mont_rec``): the Shoup form, or the Montgomery one of the
  JAX kernels' ``shoup_rec=False`` and of the XLA ``mxu_ntt`` (launch
  counters ``mxu_ntt_fwd_montrec``, ``mxu_ntt_inv_montrec``);
- ``mxu_switch``: the fused key switch of one width group from the raw
  divided-difference state (extension, transform, Shoup key products
  summed over the parts, inverse, reduce) with the special-prime
  mod-down folded in, in mode ``special`` or ``ordinary`` (replaces
  ``mxu_pallas._make_md_kernel``);
- ``mxu_switch_inv``: the same switch without the mod-down, its output
  reduced to [0, q) for the engine's separate mod-down; with a Shoup-form
  key (launch counter ``mxu_switch_inv``, replaces
  ``mxu_pallas._ext_mulacc_inv_kernel_sk``) or a Montgomery-form key
  (counter ``mxu_switch_inv_mont``, replaces
  ``mxu_pallas._ext_mulacc_inv_kernel``);
- ``mxu_ksk_accum``: the switch's core from extension words the caller
  gives, with a Montgomery-form key: the forward transform of every part
  and the key products summed over the parts, natural-order NTT-domain
  output (replaces ``mxu_pallas._mulacc_kernel``), or with
  ``fold_inverse`` also the inverse and the reduce to [0, q) (counter
  ``mxu_ksk_accum_inv``, replaces ``mxu_pallas._mulacc_inv_kernel``).

Beside them, the switch's standalone special-prime mod-down:

- ``mod_down``: the with-special words of the unfolded switch (every
  route but ``mxu_switch``'s fold, on every domain and mesh) to the
  ordinary channels, in one pass (``csrc/mod_down.cu``; replaces no
  Pallas kernel: the JAX package's mod-down is XLA pointwise code). Its
  twin is the chain of u64.py ops the engine ran before.

``dispatch``, ``dispatch_switch``, ``dispatch_switch_inv`` and
``dispatch_ksk_accum`` run a level's width groups, as
``mxu_pallas.dispatch``, ``dispatch_ksk_from_state`` (with and without
``moddown_piw``) and ``dispatch_ksk_accum`` do.

The switch kernels also run ct-batched part segments, as
``dispatch_ksk_from_state(parts=P)``: with ``parts`` given, the state holds
B segments of P parts, b-major, part-fastest (segment part bp = b*P + p),
each one ciphertext's switch under the same key, and the outputs gain a
batch axis ([2, B, C, N]; the exported dropped rows [B, 2 n_sp, N]). The
twins loop over the segments.

A wrapper launches its kernel for a CUDA tensor and runs its plain twin
only for a CPU tensor; it raises for anything else. Each twin repeats the
kernel's arithmetic step for step on int64 tensors and forms the digit
products in float64 (exact: every partial sum is below 2^28), so both
give the same words. Every launch adds one to ``launches[name]``.
"""

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from . import u64
from .cuda_ntt import _device_kind, _raise_on
from .mxu_ntt import MxuPlan

launches = {"mxu_ntt_fwd": 0, "mxu_ntt_inv": 0, "mxu_ntt_fwd_montrec": 0,
            "mxu_ntt_inv_montrec": 0, "mxu_switch": 0,
            "mxu_switch_inv": 0, "mxu_switch_inv_mont": 0,
            "mxu_ksk_accum": 0, "mxu_ksk_accum_inv": 0, "mod_down": 0}

# (dA, dB) pairs with compiled kernels (30-, 40- and 60-bit primes).
DIGITS = (4, 6, 8)

# The most special primes the mod-down kernels take (csrc/mxu_switch.cu's
# fold, csrc/mod_down.cu).
MAX_SPECIAL = 8

# The stage kernel's constants (csrc/mxu.cuh): table columns per ring
# stage, columns per block, X tiles in flight, threads (two consumer
# warpgroups and a producer one), the registers ptxas gives a thread of
# the block and those setmaxnreg gives a producer and a consumer thread,
# the ring's cap and the shared-memory budget.
KZ = 32
TILE_J = 128
X_SLOTS = 2
THREADS = 384
ENTRY_REGS = 168
PRODUCER_REGS, CONSUMER_REGS = 40, 232
MAX_RING = 16
SMEM_BUDGET = 200 * 1024
# Sides S, R of the transform that the stage kernel takes (logN 8 to 17,
# the presets' range: platinum's logN 17 is S = 512, R = 256).
SIDES = (16, 32, 64, 128, 256, 512)


def tile_o(d, ksum=False):
    """Output rows per block (the wgmma N) at d digits: 16 for the key-sum
    stage at 8 digits (its two sums share the registers), else 32."""
    return 16 if ksum and d == 8 else 32


def stage_geometry(d, O, K, J, B, C, ksum=False):
    """The launch geometry of one stage kernel at d digits (as
    csrc/mxu.cuh computes it): O output rows, K rows contracted, J
    columns, B batch elements (with ``ksum`` the segments, whose parts a
    block walks), C channels."""
    to = tile_o(d, ksum)
    t_bytes, x_bytes = d * to * KZ, TILE_J * KZ * 8
    ring = min(MAX_RING, (SMEM_BUDGET - 1024 - X_SLOTS * x_bytes)
               // (t_bytes + 16))
    kw = min(K, KZ)
    pj = min(J, TILE_J)
    return dict(
        tile_o=to, tile_j=TILE_J, ring=ring, kz=KZ, x_slots=X_SLOTS,
        threads=THREADS, regs=(ENTRY_REGS, PRODUCER_REGS, CONSUMER_REGS),
        smem=1024 + X_SLOTS * (x_bytes + 16) + ring * (t_bytes + 16),
        grid=(B * -(-J // TILE_J), -(-O // to), C),
        window=kw, stages_per_part=len(stage_schedule(d, K)),
        # registers a consumer thread holds across the stages: the d
        # accumulator sets, the digit fragments of a window, and with
        # ksum the two key sums (u64)
        live_regs=d * to // 2 + 4 * d + (2 * to if ksum else 0),
        # the table [C, d*O, d*K] (int8) as a 3-D TMA tensor map
        tmap=dict(dims=(d * K, O, d * C), strides=(d * K, O * d * K),
                  box=(KZ, min(O, to), d), swizzle=32),
        tx_bytes=KZ * min(O, to) * d,
        # the input words: box of kw rows of pj columns (rows in: [kw, pj]
        # with the columns innermost; columns in: [pj, kw])
        x_box=dict(rows=(pj, kw, 1, 1), cols=(kw, pj, 1, 1)),
        x_tx_bytes=8 * kw * pj)


def stage_schedule(d, K):
    """The ring stages of one part of a stage kernel at d digits that
    contracts K rows, in order: (z0, v0, nv, k0, kw) per stage, the table
    columns z0 .. z0 + KZ holding digit planes v0 .. v0 + nv of X rows
    k0 .. k0 + kw (column v*K + k is digit v of row k)."""
    kw = min(K, KZ)
    nv = KZ // kw
    return [(v0 * K + k0, v0, nv, k0, kw) for k0 in range(0, K, kw)
            for v0 in range(0, d, nv)]


def transform_geometry(plan, B, inverse=False):
    """The two stage launches of one transform of B polynomials."""
    O1, J1 = (plan.R, plan.S) if inverse else (plan.S, plan.R)
    C = plan.num_channels
    return [stage_geometry(plan.dA, O1, O1, J1, B, C),
            stage_geometry(plan.dA, J1, J1, O1, B, C)]


def switch_geometry(plan, P, B=1):
    """The four stage launches of the switch core of B segments of P parts:
    forward stage 1 (B*P), stage 2 with the key sums (B segments), the two
    inverse stages of every sum (2B)."""
    S, R, C, d = plan.S, plan.R, plan.num_channels, plan.dA
    return [stage_geometry(d, S, S, R, B * P, C),
            stage_geometry(d, R, R, S, B, C, ksum=True),
            *transform_geometry(plan, 2 * B, inverse=True)]


def reset_launches():
    for k in launches:
        launches[k] = 0


class MxuGroup(NamedTuple):
    """One width group of a channel layout: data channels [lo, hi) of the
    layout, with the group plan cut to them (views)."""
    lo: int
    hi: int
    plan: MxuPlan


# -- plain twins ------------------------------------------------------------------


def _csub(v, m):
    """v - m where v >= m (unsigned compare)."""
    return torch.where(u64.lt_unsigned(v, m), v, v - m)


def _cols(plan, *names):
    return tuple(getattr(plan, n)[:, None, None] for n in names)


def _matmul(table, rs, x, dB):
    """E = table [C, dA*O, dB*K] x offset digits of x [B, C, K, J], plus the
    row-sum corrections: int64 [B, C, dA*O, J] (the kernels' int32 sums).
    One batch element at a time: a broadcast product copies the table for
    each (65 GB for platinum's switch of 13 parts)."""
    t = table.to(torch.float64)
    rs = rs.to(torch.int64)[:, :, None]
    B, C, _, J = x.shape
    E = torch.empty((B, C, t.shape[1], J), dtype=torch.int64, device=x.device)
    for b in range(B):
        d = torch.cat([((x[b] >> (8 * v)) & 0xFF) - 128 for v in range(dB)],
                      dim=-2)
        E[b] = torch.matmul(t, d.to(torch.float64)).to(torch.int64) + rs
    return E


def _recombine(E, plan):
    """Planes E [B, C, dA*O, J] -> V mod q in [0, 2q): Horner over the
    planes, then in the Shoup form a Barrett reduction of the low part and
    a Shoup product of the high part (each offset by 2^63), the correction
    and two conditional subtracts; in the Montgomery form (``mont_rec``)
    a signed Montgomery product of each part by c_lo and c_hi, their sum
    and one conditional subtract."""
    planes = E.unflatten(-2, (plan.dA, -1))

    def horner(lo, hi):
        v = planes[..., hi - 1, :, :]
        for u in range(hi - 2, lo - 1, -1):
            v = v * 256 + planes[..., u, :, :]
        return v

    split = min(plan.split, plan.dA)
    if plan.mont_rec:
        q, k, c_lo, c_hi = _cols(plan, "q", "k", "c_lo", "c_hi")
        mont = (q & u64.LB_MASK, q >> u64.HALF_NBITS, k & u64.LB_MASK,
                k >> u64.HALF_NBITS)
        r = u64.montmul(horner(0, split), c_lo, *mont)
        if plan.dA > split:
            r = _csub(r + u64.montmul(horner(split, plan.dA), c_hi, *mont),
                      2 * q)
        return r
    q, bp, whi, wphi, corr = _cols(plan, "q", "bp", "whi", "wphi", "corr")
    r = u64.barrett_2q(horner(0, split) ^ u64.INT64_MIN, bp, q)
    if plan.dA > split:
        r = r + u64.shoup_mul(horner(split, plan.dA) ^ u64.INT64_MIN, whi,
                              wphi, q)
    r = _csub(r + corr, 4 * q)
    return _csub(r, 2 * q)


def _twiddle(x, tw, plan):
    """Montgomery product with the twiddle plane tw [C, S, R]."""
    q, k = _cols(plan, "q", "k")
    return u64.montmul(x, tw, q & u64.LB_MASK, q >> u64.HALF_NBITS,
                       k & u64.LB_MASK, k >> u64.HALF_NBITS)


def mxu_ntt_fwd_plain(x, plan, enter=False):
    """Forward transform of x [B, C, N] (words below 2^{8 dB}): natural
    order, [0, 2q)."""
    B, C, N = x.shape
    S, R = plan.S, plan.R
    t1, r1 = (plan.m1e, plan.m1e_rs) if enter else (plan.m1, plan.m1_rs)
    b = _recombine(_matmul(t1, r1, x.reshape(B, C, S, R), plan.dB), plan)
    b = _twiddle(b, plan.tw, plan)                      # [B, C, S(k2), R(r)]
    X = _recombine(_matmul(plan.m2, plan.m2_rs, b.transpose(-1, -2),
                           plan.dB), plan)              # [B, C, R(k1), S(k2)]
    return X.reshape(B, C, N)


def mxu_ntt_inv_plain(x, plan, exitx=False, post_reduce=False):
    """Inverse transform of x [B, C, N] (natural-order NTT domain)."""
    B, C, N = x.shape
    S, R = plan.S, plan.R
    y = _recombine(_matmul(plan.i1, plan.i1_rs, x.reshape(B, C, R, S),
                           plan.dB), plan)              # [B, C, R(j), S(k2)]
    y = _twiddle(y.transpose(-1, -2), plan.itw, plan)   # [B, C, S(k2), R(j)]
    t2, r2 = (plan.i2x, plan.i2x_rs) if exitx else (plan.i2, plan.i2_rs)
    out = _recombine(_matmul(t2, r2, y, plan.dB), plan)  # [B, C, S(s), R(j)]
    if post_reduce:
        out = _csub(out, _cols(plan, "q")[0])
    return out.reshape(B, C, N)


def _fold_plain(r, piw, plan, special, n_sp, srcs):
    """The mod-down fold on the group's reduced rows r [2, C, N]."""
    C, N = r.shape[1], r.shape[2]
    q = plan.q[:, None]
    bp = plan.bp[:, None]

    def md_iter(v, src, j, sl):
        tile = u64.barrett_2q(src, bp[sl], q[sl])
        return u64.shoup_mul(v + 2 * q[sl] - tile, piw[j, 0, sl, None],
                             piw[j, 1, sl, None], q[sl])

    out = r.clone()
    if special:
        rows = []
        for kk in range(n_sp):
            sl = slice(C - 1 - kk, C - kk)
            v = r[:, sl]
            for j in range(kk):
                v = _csub(md_iter(v, rows[j], j, sl), q[sl])
            rows.append(v)
        srcs = torch.cat(rows, dim=1).reshape(2 * n_sp, N)
        nord = C - n_sp
    else:
        rows = list(srcs.reshape(2, n_sp, 1, N).unbind(1))
        nord = C
    sl = slice(0, nord)
    v = r[:, sl]
    for j in range(n_sp):
        v = md_iter(v, rows[j], j, sl)
    out[:, sl] = _csub(v, q[sl])
    return (out, srcs) if special else out


def _extend_plain(st, terms, off0, plan):
    """The Shoup basis extension of the state rows st [P, A, N] onto the
    group's channels: [P, C, N] in [0, 2q)."""
    A = st.shape[1]
    q = plan.q[:, None]
    q2 = 2 * q
    s = st ^ u64.INT64_MIN
    acc = _csub(u64.barrett_2q(s[:, 0:1], plan.bp[:, None], q)
                + off0[:, None], q2)                    # [P, C, N]
    for i in range(1, A):
        w, wp, cadj = (terms[:, i - 1, f, :, None] for f in range(3))
        e = _csub(u64.shoup_mul(s[:, i:i + 1], w, wp, q) + cadj, q2)
        acc = _csub(acc + e, q2)
    return acc


def _accum_plain(ext, k0, k1, plan, key_ch, part_off):
    """The forward transform of every part of ext [P, C, N], both key
    products (Shoup-form pairs or Montgomery-form stacks, read at parts
    part_off.. and key channels key_ch..) and their sums over the parts:
    [2, C, N], natural-order NTT domain [0, 2q)."""
    P, C, _ = ext.shape
    q = plan.q[:, None]
    q2 = 2 * q
    x = mxu_ntt_fwd_plain(ext, plan)

    def key(t):
        return t[part_off:part_off + P, key_ch:key_ch + C]

    if isinstance(k0, tuple):
        p0 = u64.shoup_mul(x, key(k0[0]), key(k0[1]), q)
        p1 = u64.shoup_mul(x, key(k1[0]), key(k1[1]), q)
    else:
        k = plan.k[:, None]
        mont = (q & u64.LB_MASK, q >> u64.HALF_NBITS, k & u64.LB_MASK,
                k >> u64.HALF_NBITS)
        p0 = u64.montmul(x, key(k0), *mont)
        p1 = u64.montmul(x, key(k1), *mont)
    a0, a1 = p0[0], p1[0]
    for p in range(1, P):
        a0 = _csub(a0 + p0[p], q2)
        a1 = _csub(a1 + p1[p], q2)
    return torch.stack([a0, a1])


def _montgomery_key(name, k0, k1):
    if isinstance(k0, tuple) or isinstance(k1, tuple):
        raise ValueError(f"{name}: a Montgomery-form key only (the JAX "
                         f"kernels have no working Shoup-key branch)")


def mxu_ksk_accum_plain(ext, k0, k1, plan, key_ch, part_off):
    """#7: the forward transform of every part of ext [P, C, N] (words
    below 2^{8 dB}), the Montgomery key products summed over the parts:
    [2, C, N], natural-order NTT domain [0, 2q)."""
    _montgomery_key("mxu_ksk_accum", k0, k1)
    return _accum_plain(ext, k0, k1, plan, key_ch, part_off)


def mxu_ksk_accum_inv_plain(ext, k0, k1, plan, key_ch, part_off):
    """#8: mxu_ksk_accum_plain, then the inverse transform and the reduce:
    [2, C, N], coefficient domain [0, q)."""
    return mxu_ntt_inv_plain(
        mxu_ksk_accum_plain(ext, k0, k1, plan, key_ch, part_off), plan,
        post_reduce=True)


def _segments(st, parts):
    """The state's ct segments: [st] without ``parts``, else B of them."""
    if parts is None:
        return [st]
    return list(st.reshape(-1, parts, *st.shape[1:]).unbind(0))


def mxu_switch_inv_plain(st, terms, off0, k0, k1, plan, key_ch, part_off,
                         parts=None):
    """The switch of one width group without the mod-down (see
    ``mxu_switch_inv``): [2, C, N] in [0, q), or with ``parts`` [2, B, C,
    N], one segment after the other. k0, k1: Shoup-form (value, quotient)
    pairs, or Montgomery-form stacks."""
    outs = [mxu_ntt_inv_plain(
        _accum_plain(_extend_plain(s, terms, off0, plan), k0, k1, plan,
                     key_ch, part_off), plan, post_reduce=True)
        for s in _segments(st, parts)]
    return outs[0] if parts is None else torch.stack(outs, dim=1)


def mxu_switch_plain(st, terms, off0, piw, k0, k1, plan, key_ch, part_off,
                     n_sp, special, srcs=None, parts=None):
    """The fused switch of one width group (see ``mxu_switch``), one segment
    after the other with ``parts``."""
    if parts is None:
        r = mxu_switch_inv_plain(st, terms, off0, k0, k1, plan, key_ch,
                                 part_off)
        return _fold_plain(r, piw, plan, special, n_sp, srcs)
    outs = [mxu_switch_plain(s, terms, off0, piw, k0, k1, plan, key_ch,
                             part_off, n_sp, special,
                             None if special else srcs[b])
            for b, s in enumerate(_segments(st, parts))]
    if not special:
        return torch.stack(outs, dim=1)
    return (torch.stack([o[0] for o in outs], dim=1),
            torch.stack([o[1] for o in outs]))


def mod_down_plain(d, q, piw, bp, n_sp, C_ord):
    """The special-prime removal of d [..., C_sp, N] plain [0, q): each
    special prime in turn (the last channel first) subtracts its
    Barrett-reduced row from every channel and multiplies by P_j^-1
    (Shoup); [..., C_ord, N] in [0, q)."""
    C_sp = d.shape[-2]
    q2 = 2 * q[:, None]
    qc = q[:, None]
    v = d
    for P_ind in range(n_sp):
        cur = C_sp - P_ind
        src = v[..., cur - 1:cur, :]
        if P_ind:
            # The dropped row is subtracted as an INTEGER: make it the
            # canonical [0, q) representative of its own modulus.
            qr = q[cur - 1]
            src = torch.where(u64.lt_unsigned(src, qr), src, src - qr)
        tile = u64.barrett_2q(src.expand_as(v), bp[:, None], qc)
        v = u64.shoup_mul(v + q2 - tile, piw[P_ind, 0, :, None],
                          piw[P_ind, 1, :, None], qc)
    vo = v[..., :C_ord, :]
    qo = qc[:C_ord]
    return torch.where(vo < qo, vo, vo - qo)


# -- CUDA launches -----------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "ltt_mxu_ntt": [_I, _I, _P, _L, _L, _P, _L, _L, _P, _I, _I, _I]
    + [_P] * 13 + [_I, _I, _P],
    "ltt_mxu_switch": [_I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _P, _P,
                       _P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                       _L, _I, _I] + [_P] * 16 + [_P],
    "ltt_mxu_switch_inv": [_I, _I, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P,
                           _P,
                           _P, _L, _L, _P, _P, _P, _P, _P, _L, _I, _I]
    + [_P] * 16 + [_P],
    "ltt_mxu_ksk_accum": [_I, _I, _P, _L, _L, _I, _P, _P, _L, _L, _P, _P, _P,
                          _P, _L, _I, _I] + [_P] * 16 + [_P],
    "ltt_mod_down": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}


def _fn(lib_name, fn_name):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return fn


def _logN(plan):
    return (plan.S * plan.R).bit_length() - 1


def _check_plan(plan, device, transform=False):
    """What the kernels take of a plan; the switch kernels (all but the
    transforms) recombine in the Shoup form only."""
    if plan.mont_rec and not transform:
        raise ValueError("the MXU switch kernels recombine in the Shoup "
                         "form: a width-group plan, not the master plan")
    if plan.dA != plan.dB or plan.dA not in DIGITS:
        raise ValueError(f"no MXU kernel for digits ({plan.dA}, {plan.dB}); "
                         f"built: {DIGITS}")
    if plan.S not in SIDES or plan.R not in SIDES:
        raise ValueError(f"no MXU kernel for a [{plan.S}, {plan.R}] "
                         f"transform; sides taken: {SIDES}")
    for name, t in plan.tensors().items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"MXU table {name} must be contiguous on "
                             f"{device}")


def _check_words(*ts):
    for t in ts:
        if t.dtype != torch.int64 or t.stride(-1) != 1:
            raise ValueError("expected int64 words with a contiguous "
                             "coefficient axis")


def _check_tma(*ts):
    """The stage kernel reads its input words by TMA: 16-byte aligned
    tensors with strides of whole 16-byte units."""
    for t in ts:
        if t.data_ptr() % 16 or any(s % 2 for s in t.stride()[:-1]):
            raise ValueError("the MXU kernels need 16-byte aligned words "
                             "with even strides")


def _batched(x, plan, out):
    """x [..., C, N] as [B, C, N] (a view), and the output [B, C, N]."""
    C, N = plan.num_channels, plan.S * plan.R
    if x.shape[-2:] != (C, N):
        raise ValueError(f"expected [..., {C}, {N}] words, got "
                         f"{tuple(x.shape)}")
    xb = x.reshape(-1, C, N)
    if out is None:
        out = torch.empty(xb.shape, dtype=torch.int64, device=x.device)
    elif out.shape != xb.shape:
        raise ValueError(f"out must be {tuple(xb.shape)}")
    return xb, out


def _transform(name, inverse, x, plan, tables, post_reduce, twin, out):
    xb, out = _batched(x, plan, out)
    if _device_kind(x) == "cpu":
        out.copy_(twin(xb))
        return out
    _check_plan(plan, x.device, transform=True)
    _check_words(xb, out)
    _check_tma(xb)
    B, C, N = xb.shape
    scratch = torch.empty((B, C, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn("mxu_ntt", "ltt_mxu_ntt")(
            int(inverse), plan.dA, xb.data_ptr(), xb.stride(0), xb.stride(1),
            out.data_ptr(), out.stride(0), out.stride(1), scratch.data_ptr(),
            B, C, _logN(plan), *(t.data_ptr() for t in tables),
            *(getattr(plan, f).data_ptr() for f in
              ("q", "k", "bp", "whi", "wphi", "corr", "c_lo", "c_hi")),
            int(plan.mont_rec), int(post_reduce), stream)
    _raise_on(rc, name)
    launches[name + ("_montrec" if plan.mont_rec else "")] += 1
    return out


def mxu_ntt_fwd(x, plan, enter=False, out=None):
    """Forward transform of x [..., C, N] (CUDA kernel, or the twin on the
    CPU), into ``out`` [B, C, N] when given."""
    t1, r1 = (plan.m1e, plan.m1e_rs) if enter else (plan.m1, plan.m1_rs)
    res = _transform("mxu_ntt_fwd", False, x, plan,
                     (t1, r1, plan.tw, plan.m2, plan.m2_rs), False,
                     lambda xb: mxu_ntt_fwd_plain(xb, plan, enter), out)
    return res.reshape(x.shape) if out is None else res


def mxu_ntt_inv(x, plan, exitx=False, post_reduce=False, out=None):
    """Inverse transform of x [..., C, N], optionally with the Montgomery
    exit and the reduce to [0, q)."""
    t2, r2 = (plan.i2x, plan.i2x_rs) if exitx else (plan.i2, plan.i2_rs)
    res = _transform("mxu_ntt_inv", True, x, plan,
                     (plan.i1, plan.i1_rs, plan.itw, t2, r2), post_reduce,
                     lambda xb: mxu_ntt_inv_plain(xb, plan, exitx,
                                                  post_reduce), out)
    return res.reshape(x.shape) if out is None else res


def _check_switch(st, terms, off0, keys, plan, key_ch, part_off, parts):
    """Shape checks shared by the two switch wrappers: (B, P), the segments
    and the parts of each."""
    BP, A, N = st.shape
    P = BP if parts is None else parts
    if P < 1 or BP % P:
        raise ValueError(f"switch: {BP} state parts are not segments of "
                         f"{P}")
    C = plan.num_channels
    if terms.shape[:3] != (P, max(A - 1, 1), 3) or terms.shape[3] != C \
            or off0.shape != (C,) or N != plan.S * plan.R:
        raise ValueError("switch: tables do not match the state and plan")
    for t in keys:
        if t.shape != keys[0].shape or t.stride() != keys[0].stride() \
                or t.shape[0] < part_off + P or t.shape[1] < key_ch + C \
                or t.shape[2] != N:
            raise ValueError("switch: key stacks do not cover the parts and "
                             "channels")
    return BP // P, P


def _switch_out(out, B, C, N, parts, device):
    """The output [2, C, N] (without ``parts``) or [2, B, C, N], allocated
    when not given, as [2, B, C, N]."""
    shape = (2, C, N) if parts is None else (2, B, C, N)
    if out is None:
        out = torch.empty(shape, dtype=torch.int64, device=device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"out must be {shape}")
    return out, (out.unsqueeze(1) if parts is None else out)


def _check_dense(st, terms, off0, out4, ld):
    """out4: the output as [2, B, C, N]; its (half, segment) rows must be
    evenly spaced, as the kernels write them."""
    B = out4.shape[1]
    if not st.is_contiguous() or terms.stride() != (
            terms.shape[1] * 3 * ld, 3 * ld, ld, 1) \
            or off0.stride() != (1,) or out4.stride(2) != st.shape[-1] \
            or (B > 1 and out4.stride(0) != B * out4.stride(1)):
        raise ValueError("switch: state, scalar tables and output must be "
                         "dense (channel slices of one layout)")


def _out_sb(out4):
    """The stride between an output's (half, segment) rows."""
    return out4.stride(0) if out4.shape[1] == 1 else out4.stride(1)


def _switch_scratch(B, P, C, N, device):
    """ext, inter1 [B*P, C, N]; acc, inter2 [2, B, C, N]: the switch's
    intermediates between its launches (kept referenced by the caller
    until the launch call returns)."""
    ext = torch.empty((B * P, C, N), dtype=torch.int64, device=device)
    acc = torch.empty((2, B, C, N), dtype=torch.int64, device=device)
    return ext, torch.empty_like(ext), acc, torch.empty_like(acc)


def _plan_ptrs(plan):
    return tuple(getattr(plan, f).data_ptr() for f in
                 ("m1", "m1_rs", "tw", "m2", "m2_rs", "i1", "i1_rs", "itw",
                  "i2", "i2_rs", "q", "k", "bp", "whi", "wphi", "corr"))


def mxu_switch(st, terms, off0, piw, k0, k1, plan, key_ch, part_off, n_sp,
               special, srcs=None, out=None, parts=None):
    """The fused key switch of one width group with the mod-down folded in.

    st: [P, A, N] raw divided-difference state rows of the parts
    (zero-padded to A rows); terms: [P, max(A-1, 1), 3, C] the (w, wp,
    cadj) extension scalars per part, term and channel (zero for padded
    terms); off0: [C] the offset correction 2q - (2^63 mod q) of the first
    term; piw: [n_sp, 2, C] (P_j^-1, quotient) per removal step; k0, k1:
    Shoup-form key halves, each a (value, quotient) pair of [P_full, C0, N]
    stacks, read at parts part_off.. and key channels key_ch... ``special``:
    this group holds the special primes as its last n_sp channels; it
    returns (out, srcs), the exported dropped rows srcs [2 n_sp, N].
    Otherwise ``srcs`` is consumed and out returned. out: [2, C, N]; the
    ordinary rows fully mod-downed in [0, q), the special rows reduced.

    ``parts``: st holds B ct segments of ``parts`` parts [B*P, A, N]; out
    is then [2, B, C, N] and srcs [B, 2 n_sp, N]."""
    A, N = st.shape[1:]
    C = plan.num_channels
    if special and C < n_sp:
        raise ValueError(f"the special group holds {C} channels, fewer "
                         f"than the {n_sp} special primes")
    if piw.shape != (n_sp, 2, C):
        raise ValueError("mxu_switch: piw does not match the plan")
    keys = (*k0, *k1)
    B, P = _check_switch(st, terms, off0, keys, plan, key_ch, part_off,
                         parts)
    rows = (2 * n_sp, N) if parts is None else (B, 2 * n_sp, N)
    if not special and (srcs is None or tuple(srcs.shape) != rows
                        or not srcs.is_contiguous()):
        raise ValueError(f"mode 'ordinary' needs the special group's "
                         f"{list(rows)} rows")
    out, out4 = _switch_out(out, B, C, N, parts, st.device)
    if _device_kind(st) == "cpu":
        res = mxu_switch_plain(st, terms, off0, piw, k0, k1, plan, key_ch,
                               part_off, n_sp, special, srcs, parts)
        out.copy_(res[0] if special else res)
        return (out, res[1]) if special else out
    _check_plan(plan, st.device)
    ld = terms.stride(2)
    _check_dense(st, terms, off0, out4, ld)
    if piw.stride() != (2 * ld, ld, 1):
        raise ValueError("mxu_switch: piw must be a channel slice of one "
                         "layout")
    _check_words(st, terms, off0, piw, out, *keys)
    srcs_out = torch.empty(rows, dtype=torch.int64,
                           device=st.device) if special else None
    kv = [t[part_off:, key_ch:] for t in keys]
    scratch = _switch_scratch(B, P, C, N, st.device)
    with torch.cuda.device(st.device):
        stream = torch.cuda.current_stream(st.device).cuda_stream
        rc = _fn("mxu_switch", "ltt_mxu_switch")(
            plan.dA, int(special), n_sp, st.data_ptr(), B, P, A,
            terms.data_ptr(), terms.shape[1], ld, off0.data_ptr(),
            piw.data_ptr(), *(t.data_ptr() for t in kv), kv[0].stride(0),
            kv[0].stride(1), None if special else srcs.data_ptr(),
            srcs_out.data_ptr() if special else None,
            *(t.data_ptr() for t in scratch),
            out.data_ptr(), _out_sb(out4), C, _logN(plan),
            *_plan_ptrs(plan), stream)
    _raise_on(rc, "mxu_switch")
    launches["mxu_switch"] += 1
    return (out, srcs_out) if special else out


def mxu_switch_inv(st, terms, off0, k0, k1, plan, key_ch, part_off,
                   out=None, parts=None):
    """The key switch of one width group without the mod-down: out [2, C, N]
    ([2, B, C, N] with ``parts``) in [0, q), every channel reduced (the
    special rows included), for the engine's separate mod-down. Arguments
    as ``mxu_switch``'s, except the key: (value, quotient) pairs of
    Shoup-form stacks launch the Shoup-key kernel (counter
    ``mxu_switch_inv``), single Montgomery-form stacks [P_full, C0, N] the
    Montgomery-key kernel (``mxu_switch_inv_mont``)."""
    A, N = st.shape[1:]
    C = plan.num_channels
    mont = not isinstance(k0, tuple)
    keys = (k0, k1) if mont else (*k0, *k1)
    B, P = _check_switch(st, terms, off0, keys, plan, key_ch, part_off,
                         parts)
    out, out4 = _switch_out(out, B, C, N, parts, st.device)
    if _device_kind(st) == "cpu":
        out.copy_(mxu_switch_inv_plain(st, terms, off0, k0, k1, plan, key_ch,
                                       part_off, parts))
        return out
    _check_plan(plan, st.device)
    ld = terms.stride(2)
    _check_dense(st, terms, off0, out4, ld)
    _check_words(st, terms, off0, out, *keys)
    kv = [t[part_off:, key_ch:] for t in keys]
    k0w, k1w = (kv[0], kv[1]) if mont else (kv[0], kv[2])
    k0wp, k1wp = (None, None) if mont else (kv[1].data_ptr(),
                                            kv[3].data_ptr())
    name = "mxu_switch_inv_mont" if mont else "mxu_switch_inv"
    scratch = _switch_scratch(B, P, C, N, st.device)
    with torch.cuda.device(st.device):
        stream = torch.cuda.current_stream(st.device).cuda_stream
        rc = _fn("mxu_switch", "ltt_mxu_switch_inv")(
            plan.dA, int(mont), st.data_ptr(), B, P, A, terms.data_ptr(),
            terms.shape[1], ld, off0.data_ptr(), k0w.data_ptr(), k0wp,
            k1w.data_ptr(), k1wp, kv[0].stride(0), kv[0].stride(1),
            *(t.data_ptr() for t in scratch),
            out.data_ptr(), _out_sb(out4), C, _logN(plan), *_plan_ptrs(plan),
            stream)
    _raise_on(rc, name)
    launches[name] += 1
    return out


def mxu_ksk_accum(ext, k0, k1, plan, key_ch, part_off, fold_inverse=False,
                  out=None):
    """The switch's core of one width group from extension words: ext
    [P, C, N] (words below 2^{8 dB}, e.g. [0, 2q)), Montgomery-form key
    stacks k0, k1 [P_full, C0, N] read at parts part_off.. and key channels
    key_ch... Returns out [2, C, N]: the key sums in the natural-order NTT
    domain, [0, 2q) (counter ``mxu_ksk_accum``), or with ``fold_inverse``
    their inverse transforms reduced to [0, q) (``mxu_ksk_accum_inv``)."""
    _montgomery_key("mxu_ksk_accum", k0, k1)
    P, C, N = ext.shape
    if C != plan.num_channels or N != plan.S * plan.R:
        raise ValueError("mxu_ksk_accum: ext does not match the plan")
    for t in (k0, k1):
        if t.shape != k0.shape or t.stride() != k0.stride() \
                or t.shape[0] < part_off + P or t.shape[1] < key_ch + C \
                or t.shape[2] != N:
            raise ValueError("mxu_ksk_accum: key stacks do not cover the "
                             "parts and channels")
    if out is None:
        out = torch.empty((2, C, N), dtype=torch.int64, device=ext.device)
    elif out.shape != (2, C, N):
        raise ValueError(f"out must be {(2, C, N)}")
    twin = mxu_ksk_accum_inv_plain if fold_inverse else mxu_ksk_accum_plain
    if _device_kind(ext) == "cpu":
        out.copy_(twin(ext, k0, k1, plan, key_ch, part_off))
        return out
    _check_plan(plan, ext.device)
    if any(t.device != ext.device for t in (k0, k1, out)) \
            or out.stride(1) != N:
        raise ValueError("mxu_ksk_accum: keys and output on the data's "
                         "device, the output's channels dense")
    _check_words(ext, k0, k1, out)
    _check_tma(ext)
    kv = [t[part_off:, key_ch:] for t in (k0, k1)]
    inter1 = torch.empty((P, C, N), dtype=torch.int64, device=ext.device)
    acc, inter2 = (torch.empty((2, C, N), dtype=torch.int64,
                               device=ext.device) if fold_inverse else None
                   for _ in range(2))
    name = "mxu_ksk_accum_inv" if fold_inverse else "mxu_ksk_accum"
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream(ext.device).cuda_stream
        rc = _fn("mxu_switch", "ltt_mxu_ksk_accum")(
            plan.dA, int(fold_inverse), ext.data_ptr(), ext.stride(0),
            ext.stride(1), P, kv[0].data_ptr(), kv[1].data_ptr(),
            kv[0].stride(0), kv[0].stride(1), inter1.data_ptr(),
            None if acc is None else acc.data_ptr(),
            None if inter2 is None else inter2.data_ptr(), out.data_ptr(),
            out.stride(0), C, _logN(plan), *_plan_ptrs(plan), stream)
    _raise_on(rc, name)
    launches[name] += 1
    return out


def mod_down(d, q, piw, bp, n_sp, C_ord):
    """The key switch's special-prime mod-down: d [..., C_sp, N] plain
    [0, q) words over the with-special channels, the n_sp special primes
    last; q, bp [C_sp] the moduli and Barrett reciprocals floor(2^64 / q);
    piw [n_sp, 2, C_sp] (P_j^-1 mod q_i and its Shoup quotient) per removal
    step, the last channel's prime first. Returns [..., C_ord, N] in
    [0, q): the first C_ord channels (C_ord + n_sp <= C_sp).

    One launch of ``ltt_mod_down`` for a CUDA tensor (counter
    ``mod_down``), the twin ``mod_down_plain`` for a CPU one. d must be
    dense int64 words, the tables dense int64 on its device."""
    if d.dtype != torch.int64 or d.dim() < 2:
        raise TypeError(f"mod_down: expected int64 words [..., C_sp, N], got "
                        f"{d.dtype} {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("mod_down: the words must be contiguous")
    C_sp, N = d.shape[-2:]
    if not 1 <= n_sp <= MAX_SPECIAL:
        raise ValueError(f"mod_down: n_sp = {n_sp}; the kernel takes 1 to "
                         f"{MAX_SPECIAL} special primes")
    if not 1 <= C_ord <= C_sp - n_sp:
        raise ValueError(f"mod_down: {C_ord} ordinary channels of {C_sp} "
                         f"with {n_sp} special")
    for name, t, shape in (("q", q, (C_sp,)), ("bp", bp, (C_sp,)),
                           ("piw", piw, (n_sp, 2, C_sp))):
        if tuple(t.shape) != shape or t.dtype != torch.int64 \
                or t.device != d.device or not t.is_contiguous():
            raise ValueError(f"mod_down: {name} must be contiguous int64 "
                             f"{list(shape)} on {d.device}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    if _device_kind(d) == "cpu":
        return mod_down_plain(d, q, piw, bp, n_sp, C_ord)
    db = d.reshape(-1, C_sp, N)
    L = db.shape[0]
    if L > 65535:
        raise ValueError(f"mod_down: {L} rows; the kernel takes 65535")
    out = torch.empty((L, C_ord, N), dtype=torch.int64, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = _fn("mod_down", "ltt_mod_down")(
            db.data_ptr(), out.data_ptr(), L, C_sp, C_ord, N, n_sp,
            piw.data_ptr(), q.data_ptr(), bp.data_ptr(), stream)
    _raise_on(rc, "mod_down")
    launches["mod_down"] += 1
    return out.reshape(*d.shape[:-2], C_ord, N)


# -- width-group dispatch ------------------------------------------------------------


def dispatch(a, groups, inverse=False, plain=False, **kw):
    """Transform a [..., C, N] through a layout's width groups, one kernel
    per group, each writing its channel block of one output. ``kw``: enter
    (forward); exitx, post_reduce (inverse). ``plain``: run the twins
    whatever the device (to hold the kernels against them)."""
    C, N = groups[-1].hi, a.shape[-1]
    xb = a.reshape(-1, C, N)
    out = torch.empty(xb.shape, dtype=torch.int64, device=a.device)
    for g in groups:
        if plain:
            twin = mxu_ntt_inv_plain if inverse else mxu_ntt_fwd_plain
            out[:, g.lo:g.hi] = twin(xb[:, g.lo:g.hi], g.plan, **kw)
        else:
            f = mxu_ntt_inv if inverse else mxu_ntt_fwd
            f(xb[:, g.lo:g.hi], g.plan, out=out[:, g.lo:g.hi], **kw)
    return out.reshape(a.shape)


def _dispatch_out(st, C, parts):
    """[2, C, N], or [2, B, C, N] for B ct segments of ``parts`` parts."""
    lead = () if parts is None else (st.shape[0] // parts,)
    return torch.empty((2, *lead, C, st.shape[-1]), dtype=torch.int64,
                       device=st.device)


def dispatch_switch(st, terms, off0, piw, k0, k1, groups, level, part_off,
                    n_sp, plain=False, parts=None):
    """The fused switch of a level's with-special layout: the group holding
    the special primes (the last channels) runs first and exports its
    dropped rows; the other groups consume them. Returns [2, C_sp, N]: the
    ordinary rows fully mod-downed, the special rows raw (slice them off).
    ``level`` is the layout's first global channel, the key stacks'
    channel of data channel 0. ``plain``: run the twins. ``parts``: st
    holds B ct segments of that many parts; returns [2, B, C_sp, N]."""
    sp = max(groups, key=lambda g: g.hi)
    if sp.hi - sp.lo < n_sp:
        raise ValueError(f"the special width group [{sp.lo}, {sp.hi}) does "
                         f"not hold the {n_sp} special primes")
    out = _dispatch_out(st, sp.hi, parts)
    srcs = None
    for g in [sp] + [g for g in groups if g is not sp]:
        special = g is sp
        args = (st, terms[..., g.lo:g.hi], off0[g.lo:g.hi],
                piw[..., g.lo:g.hi], k0, k1, g.plan, level + g.lo, part_off,
                n_sp, special)
        if plain:
            res = mxu_switch_plain(*args, srcs=srcs, parts=parts)
            out[..., g.lo:g.hi, :] = res[0] if special else res
        else:
            res = mxu_switch(*args, srcs=srcs, out=out[..., g.lo:g.hi, :],
                             parts=parts)
        if special:
            srcs = res[1]
    return out


def dispatch_switch_inv(st, terms, off0, k0, k1, groups, level, part_off,
                        plain=False, parts=None):
    """The switch without the mod-down over a level's with-special layout,
    one kernel per width group: [2, C_sp, N] in [0, q) ([2, B, C_sp, N]
    with ``parts``, as ``dispatch_switch``). ``level`` is the layout's
    first global channel, the key stacks' channel of data channel 0.
    ``plain``: run the twins."""
    out = _dispatch_out(st, groups[-1].hi, parts)
    for g in groups:
        args = (st, terms[..., g.lo:g.hi], off0[g.lo:g.hi], k0, k1, g.plan,
                level + g.lo, part_off)
        if plain:
            out[..., g.lo:g.hi, :] = mxu_switch_inv_plain(*args, parts=parts)
        else:
            mxu_switch_inv(*args, out=out[..., g.lo:g.hi, :], parts=parts)
    return out


def dispatch_ksk_accum(ext, k0, k1, groups, level, part_off,
                       fold_inverse=False, plain=False):
    """The switch's core over a level's with-special layout from extension
    words ext [P, C_sp, N], one kernel per width group (see
    ``mxu_ksk_accum``): [2, C_sp, N], the natural-order NTT-domain key
    sums in [0, 2q), or with ``fold_inverse`` their inverse transforms in
    [0, q). ``level`` is the layout's first global channel, the key
    stacks' channel of data channel 0. ``plain``: run the twins."""
    out = torch.empty((2, groups[-1].hi, ext.shape[-1]), dtype=torch.int64,
                      device=ext.device)
    for g in groups:
        args = (ext[:, g.lo:g.hi], k0, k1, g.plan, level + g.lo, part_off)
        if plain:
            twin = (mxu_ksk_accum_inv_plain if fold_inverse
                    else mxu_ksk_accum_plain)
            out[:, g.lo:g.hi] = twin(*args)
        else:
            mxu_ksk_accum(*args, fold_inverse=fold_inverse,
                          out=out[:, g.lo:g.hi])
    return out
