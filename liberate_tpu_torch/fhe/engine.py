"""The CKKS engine on PyTorch: keys, encryption, the ct x ct multiply and
its key switch (relinearize, square, switch_key), the batched multiply,
additions, scalar and plaintext operations, rotations, conjugation and the
statistics built on them, threshold (multiparty) FHE and data management.

A polynomial is one int64 tensor [C, N] of 62-bit words on the engine's
device. Level/layout convention: the global prime order is
q = [scale_0..scale_{L-1}, base, special_0..special_{k-1}]; a ciphertext at
level ``l`` holds the channel suffix q[l:] minus the special primes; keys
hold the full level-0 with-special layout and are sliced by ``l``.

The multiply follows the reference's fused path with the butterfly kernels
and Shoup-form chains: four rescales, the products in the NTT domain
(one B=4 forward transform), the B=3 inverse transform, and the hybrid key
switch (basis extension, forward transform, key multiply-accumulate over
gadget parts, inverse transform, special-prime mod-down). Rescale and
extension are plain torch ops, the mod-down one kernel
(``cuda_mxu.mod_down``); the transforms and the key
multiply-accumulate are the CUDA kernels of ``ntt.cuda_ntt``: by default
the forward transform then ``ksk_mulacc``, with ``use_split_switch=False``
both in one ``ntt_mulacc`` kernel (``butterfly_switch_route``).

The JAX package's ``config`` switches that change words are keywords of
the engine (``CkksEngine``): with ``use_shoup_twiddles``,
``use_shoup_rescale``, ``use_shoup_moddown`` or ``use_shoup_extend`` off
the engine runs the reference-parity Montgomery chains instead of the
Shoup ones (``_rescale_core_mont``, ``_extend_mont`` with the canon
pre-stage before the switch's transform, ``_mod_down_mont``, the
Montgomery-twiddle transforms), which give the JAX CPU engine's words raw.

With ``use_mxu_ntt=True`` (the JAX package's ``config.use_mxu_ntt`` path
for its accelerator) every transform runs in the tensor-core kernels of
``ntt.cuda_mxu`` (natural-order NTT domain), and the key switch is one
kernel per width group: extension from the raw divided-difference state,
transform, key products summed over the parts, inverse, and, up to
``FOLD_MAX_LOGN`` with a Shoup-form key, the special-prime mod-down; else
the plain-domain mod-down follows in a kernel of its own
(``switch_route``).
"""

import datetime
import math
import os
import pickle
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from ..csprng import Csprng
from ..device import resolve_device
from ..ntt import cuda_mxu, cuda_ntt, ops, u64
from ..ntt.ntt_context import NttContext
from ..parallel import comm
from ..parallel.sharding import coef_columns
from ..version import VERSION
from .context.ckks_context import CkksContext
from .data_struct import DataStruct
from .encdec import encdec
from .presets import errors, types


def _col(t):
    return t[:, None]


# -- pointwise cores ---------------------------------------------------------------


def _sk_core(ternary, pack):
    return ops.enter_ntt(ops.tile_unsigned(ternary, pack), pack)


def _pk_core(e, a, sk, pack):
    """pk0 = e - a*sk (NTT + Montgomery domain)."""
    W = pack.q.shape[0]
    sk = ops.fit_channels(sk, W)
    a = ops.fit_channels(a, W)
    e_t = ops.enter_ntt(ops.tile_unsigned(e, pack), pack)
    return ops.mont_sub(e_t, ops.mont_mult(a, sk, pack), pack), a


def _encrypt_core(pt, dc, e0, e1, v, pk0, pk1, pack):
    """ct = (v*pk0 + pt + e0, v*pk1 + e1), pk0/pk1 in the ciphertext's
    layout. ``dc`` is the bias-guard DC coefficient's RNS remainder [C]
    (zeros when the guard is off)."""
    pk = torch.stack([pk0, pk1])
    e0_t = ops.tile_unsigned(e0, pack)
    e1_t = ops.tile_unsigned(e1, pack)
    pt_t = ops.tile_unsigned(pt, pack)
    pt_t[:, 0] += dc
    # Signed multiply + canon: plaintext coefficients may exceed +-q; the
    # signed semantics reduce any int64 correctly mod each channel prime.
    pt_t = ops.mont_enter_scalar(pt_t, pack.Rs_scale, pack)
    pt_t = ops.canon_2q(ops.mont_redc(pt_t, pack), pack)
    pte0 = ops.mont_add(pt_t, e0_t, pack)

    v_n = ops.enter_ntt(ops.tile_unsigned(v, pack), pack)
    vpk = ops.intt_exit(ops.mont_mult(v_n, pk, pack), pack)
    ct0 = ops.reduce_2q(ops.mont_add(vpk[0], pte0, pack), pack)
    ct1 = ops.reduce_2q(ops.mont_add(vpk[1], e1_t, pack), pack)
    return ct0, ct1


def _decrypt_double_pt(ct0, ct1, sk, pack):
    """pt = ct0 + ct1*sk (sk in the ciphertext's layout)."""
    a_n = ops.enter_ntt(ct1, pack)
    sa = ops.intt_exit(ops.mont_mult(a_n, sk, pack), pack)
    return ops.reduce_2q(ops.mont_add(ct0, sa, pack), pack)


def _mp_decrypt_partial(ct1, sk, pack):
    """a*sk of one party: one B=1 enter+transform, the product, one B=1
    inverse with the Montgomery exit and no reduce (lazy [0, 2q))."""
    a_n = ops.enter_ntt(ct1, pack)
    return ops.intt_exit(ops.mont_mult(a_n, sk, pack), pack)


def _mp_decrypt_head(ct0, ct1, sk, pack):
    """ct0 + a*sk of the first party, not reduced."""
    return ops.mont_add(ct0, _mp_decrypt_partial(ct1, sk, pack), pack)


def _decrypt_triplet_pt(d0, d1, d2, sk, pack):
    """pt = d0 + d1*sk + d2*sk^2 from an NTT+Montgomery-domain triplet."""
    d0_p = ops.intt_exit_reduce(d0, pack)
    d1_s = ops.intt_exit(ops.mont_mult(d1, sk, pack), pack)
    s2 = ops.mont_mult(sk, sk, pack)
    d2_s2 = ops.intt_exit(ops.mont_mult(d2, s2, pack), pack)
    pt = ops.mont_add(d0_p, d1_s, pack)
    pt = ops.mont_add(pt, d2_s2, pack)
    return ops.reduce_2q(pt, pack)


def _gt_unsigned(a, b):
    return ~u64.lt_unsigned(a, b) & (a != b)


def _final_rescale(pt, base_pack, final_scalar, round_half, base_at):
    """round((base - scaler) / q_l) as a signed base-prime representative
    [1, N], from the base-prime channel and the rescale channel."""
    base = pt[base_at:base_at + 1]
    scaler = pt[0:1]
    scaled = ops.mont_sub(base, scaler, base_pack)
    scaled = ops.mont_enter_scalar(scaled, final_scalar, base_pack)
    scaled = ops.make_signed(ops.reduce_2q(scaled, base_pack), base_pack)
    return scaled + _gt_unsigned(scaler, round_half).to(torch.int64)


def _rescale_core_shoup(d, rs_sh, bp, round_half, pack_next):
    """Drop the rescale channel: (d - s) * q_l^-1 with exact rounding, in
    the plain domain. d: [..., C_in, N]; the dropped channel is
    Barrett-reduced per surviving channel and the q_l^-1 multiply is a
    Shoup constant multiply. Output canonical [0, q)."""
    w, wp = rs_sh
    s = d[..., 0:1, :]
    body = d[..., 1:, :]
    q2 = _col(pack_next.q2)
    q = _col(pack_next.q)
    s_red = u64.barrett_2q(s.expand_as(body), _col(bp), q)
    diff = body + q2 - s_red                     # [0, 4q)
    out = u64.shoup_mul(diff, _col(w), _col(wp), q)
    if round_half is not None:
        out = out + _gt_unsigned(s, round_half).to(torch.int64)
    return torch.where(out < q, out, out - q)


def _rescale_core_mont(d, rs, round_half, pack_next):
    """The rescale's reference-parity Montgomery chain: (d - s), a signed
    Montgomery product by q_l^-1 R mod q_i, the rounding bit, one
    conditional subtract of q (the JAX package's ``_rescale_core``)."""
    s = d[..., 0:1, :]
    out = u64.montmul(d[..., 1:, :] - s, _col(rs), *pack_next.mont())
    if round_half is not None:
        out = out + _gt_unsigned(s, round_half).to(torch.int64)
    return ops.reduce_2q(out, pack_next)


def _mod_down_mont(d, pack_sp, pack_ord, PiRs, enter_ord, n_sp):
    """Special-prime removal in the reference's Montgomery chain (the JAX
    package's ``mod_down_mont``). d: [..., C_sp, N] plain [0, q); ordinary
    rows ride in Montgomery form and special rows plain (``enter_ord``:
    R^2 on the ordinary rows, R on the special ones), so each PiR multiply
    (P_j^-1 R, or R on the rows already dropped) advances both; a
    Montgomery exit and a reduce at the end. Returns [..., C_ord, N] in
    [0, q)."""
    C_sp = d.shape[-2]
    enter = _col(enter_ord)
    v = ops.mont_mult(d, enter, pack_sp)
    for P_ind in range(n_sp):
        cur = C_sp - P_ind
        tile = ops.mont_mult(v[..., cur - 1:cur, :].expand_as(v), enter,
                             pack_sp)
        v = ops.mont_sub(v, tile, pack_sp)
        v = ops.reduce_2q(ops.mont_mult(v, _col(PiRs[P_ind]), pack_sp),
                          pack_sp)
    r = ops.mont_redc(v[..., :pack_ord.q.shape[0], :], pack_ord)
    return ops.reduce_2q(r, pack_ord)


def _mod_down_shoup(d, pack_sp, pack_ord, PiWs, bp, n_sp):
    """Special-prime removal in the plain domain. d: [..., C_sp, N] plain
    [0, q); returns [..., C_ord, N] in [0, q). Each special prime in turn:
    subtract its (Barrett-reduced) row from every channel, multiply by
    P_j^-1 (Shoup). PiWs: [n_sp, 2, C_sp], the steps' (P_j^-1, quotient).
    One kernel on the card, its twin (the same words) on the CPU
    (``cuda_mxu.mod_down``)."""
    return cuda_mxu.mod_down(d, pack_sp.q, PiWs, bp, n_sp,
                             pack_ord.q.shape[0])


def _cc_mult_core(x0, x1, y0, y1, pack):
    """(d0, d1, d2) = (x0y0, x0y1+x1y0, x1y1) in the NTT domain, with one
    B=4 enter+transform."""
    x0, x1, y0, y1 = ops.enter_ntt(torch.stack([x0, x1, y0, y1]), pack)
    d0 = ops.mont_mult(x0, y0, pack)
    d1 = ops.mont_add(ops.mont_mult(x0, y1, pack),
                      ops.mont_mult(x1, y0, pack), pack)
    d2 = ops.mont_mult(x1, y1, pack)
    return d0, d1, d2


def _square_core(x0, x1, pack):
    """(d0, d1, d2) = (x0^2, 2 x0x1, x1^2) in the NTT domain, with one B=2
    enter+transform."""
    x0, x1 = ops.enter_ntt(torch.stack([x0, x1]), pack)
    d0 = ops.mont_mult(x0, x0, pack)
    x0x1 = ops.mont_mult(x0, x1, pack)
    d1 = ops.mont_add(x0x1, x0x1, pack)
    d2 = ops.mont_mult(x1, x1, pack)
    return d0, d1, d2


def _relin_pre(d0, d1, d2, pack):
    """The B=3 inverse transform with Montgomery exit and reduce."""
    return ops.intt_exit_reduce(torch.stack([d0, d1, d2]), pack)


def _relin_post(d0, d1, s0, s1, pack):
    return ops.reduce_2q(d0 + s0, pack), ops.reduce_2q(d1 + s1, pack)


def _add_core(a, b, pack):
    """(a + b) mod q in [0, q), part by part (a ciphertext's two parts or a
    triplet's three)."""
    return tuple(ops.reduce_2q(ops.mont_add(x, y, pack), pack)
                 for x, y in zip(a, b))


def _sub_core(a, b, pack):
    return tuple(ops.reduce_2q(ops.mont_sub(x, y, pack), pack)
                 for x, y in zip(a, b))


def _neg_core(d, pack):
    return ops.reduce_2q(ops.neg(ops.reduce_2q(d, pack), pack), pack)


def _scalar_mult_core(d, mont, pack):
    """Multiply d [..., C, N] by the per-channel Montgomery-form scalar
    mont [C]."""
    return ops.reduce_2q(ops.mont_enter_scalar(d, mont, pack), pack)


def _add_dc_core(d, vals, pack):
    """Add the per-channel constants vals [C] to the DC coefficient."""
    d = d.clone()
    d[:, 0] += vals
    return ops.reduce_2q(d, pack)


def _mc_mult_core(pt, d0, d1, pack):
    """(pt*d0, pt*d1) of a signed plaintext pt [1, N]: three B=1
    enter+transforms, two Montgomery products, two inverse transforms with
    the exit and the reduce."""
    pt_t = ops.enter_ntt(ops.tile_unsigned(pt, pack), pack)
    x0 = ops.enter_ntt(d0, pack)
    x1 = ops.enter_ntt(d1, pack)
    n0 = ops.intt_exit_reduce(ops.mont_mult(pt_t, x0, pack), pack)
    n1 = ops.intt_exit_reduce(ops.mont_mult(pt_t, x1, pack), pack)
    return n0, n1


def _mc_add_core(pt, d0, pack):
    """d0 + pt * scale in [0, q), in the plain domain."""
    pt_t = ops.mont_enter_scale(ops.tile_unsigned(pt, pack), pack)
    x0 = ops.mont_enter(d0, pack)
    n0 = ops.mont_redc(ops.mont_add(pt_t, x0, pack), pack)
    return ops.reduce_2q(n0, pack)


def _rotate_sk_core(sk, perm, pack):
    """The coefficient-domain signed permutation of the secret key (the
    Montgomery form commutes with it) over the ordinary channels: the
    domain's inverse transform, the permutation (``perm``: the engine's
    ``ops.apply_signed_perm``), negatives repaired to [0, 2q), the forward
    transform."""
    c = ops.intt(sk, pack)
    r = ops.canon_2q(perm(c), pack)
    return ops.ntt(r, pack)


def _rotate_ct_core(d, perm, pack):
    """The signed permutation of plain [0, q) words, back to [0, q)."""
    r = ops.make_unsigned(perm(d), pack)
    return ops.reduce_2q(r, pack)


def _pre_extend(a, start, alpha, part):
    """Divided-difference state of one gadget part of a [..., C, N]: a list
    of alpha [..., 1, N] rows (signed int64; Montgomery multiplies mirror
    the CUDA int64 semantics). Leading axes are a ciphertext batch."""
    a_part = a[..., start:start + alpha, :]
    pk = part.pack
    state = [a_part[..., 0:1, :]] * alpha
    for i in range(alpha - 1):
        diff = a_part[..., i + 1:i + 2, :] - state[i + 1]
        Y = u64.montmul(diff, part.Y_scalar[i],
                        pk.ql[i + 1], pk.qh[i + 1], pk.kl[i + 1],
                        pk.kh[i + 1])
        state[i + 1] = Y
        if i + 2 < alpha:
            new = u64.montmul(Y, _col(part.L_scalar[i]),
                              *(_col(t[i + 2:alpha]) for t in
                                (pk.ql, pk.qh, pk.kl, pk.kh)))
            for j in range(i + 2, alpha):
                state[j] = state[j] + new[..., j - i - 2:j - i - 1, :]
    return state


def _extend_shoup(state, le_sh, pack_sp, bp_off, level):
    """Basis extension onto the with-special layout in the plain domain:
    unsigned [0, 2q) output [C_sp, N]. Every term may be wrapped-signed, so
    it is offset by +2^63 before the Barrett/Shoup reduction and corrected
    with a per-channel constant."""
    bp, off0 = bp_off
    C_sp = pack_sp.q.shape[0]
    q2 = _col(pack_sp.q2)
    q = _col(pack_sp.q)

    def csub(x):                       # [0, 4q) -> [0, 2q)
        return torch.where(u64.lt_unsigned(x, q2), x, x - q2)

    t = (state[0] + u64.INT64_MIN).expand(C_sp, -1)
    acc = csub(u64.barrett_2q(t, _col(bp), q) + _col(off0))
    for i in range(len(state) - 1):
        w, wp, cadj = (x[level:level + C_sp] for x in le_sh[i])
        u = (state[i + 1] + u64.INT64_MIN).expand(C_sp, -1)
        e = csub(u64.shoup_mul(u, _col(w), _col(wp), q) + _col(cadj))
        acc = csub(acc + e)
    return acc


def _extend_mont(state, le, pack_sp):
    """Basis extension onto the with-special layout in the reference's
    Montgomery chain (the JAX package's ``extend``): the first term times
    R^2, each further term times L_i R^2, summed with conditional
    subtracts (signed compares): Montgomery-form words, wrapped negatives
    among them (``ops.canon`` repairs them before the transform). le: the
    terms' scalars over the layout's channels."""
    C_sp = pack_sp.q.shape[0]

    def rows(t):
        return t.expand(*t.shape[:-2], C_sp, t.shape[-1])

    acc = ops.mont_mult(rows(state[0]), _col(pack_sp.Rs), pack_sp)
    for i in range(len(state) - 1):
        acc = ops.mont_add(acc, ops.mont_mult(rows(state[i + 1]),
                                              _col(le[i]), pack_sp),
                           pack_sp)
    return acc


# The largest logN at which the butterfly switch runs its unsplit core (#4,
# ``ntt_mulacc``) when the engine does not split it, as the JAX engine
# does (``pallas_ntt.supports_fused_accum``: its single kernel holds a
# whole channel in VMEM up to N / 128 = SPLIT_ROWS rows).
FUSED_SWITCH_MAX_LOGN = 15


def butterfly_switch_route(logN, split, coef_sharded=False,
                           fused_switch=True):
    """The butterfly switch core the JAX engine runs at this logN,
    ``use_split_switch`` and ``use_fused_switch``: ``split`` (the forward
    NTT of the parts, then ``ksk_mulacc``), ``fused`` (``ntt_mulacc``: both
    in one kernel; logN <= FUSED_SWITCH_MAX_LOGN) or ``composed`` (the
    forward NTT, then the key products and the sum over the parts as torch
    ops, where the JAX engine composes them in XLA; at every logN without
    ``fused_switch``). On a coefficient shard (``coef_sharded``) the
    forward NTT is the coefficient-sharded one, so the unsplit core, a
    whole-length transform, is never taken: ``split`` runs ``ksk_mulacc``
    on the shard's columns, else ``composed``. With the Montgomery basis
    extension each route starts with the canon pre-stage (``split`` and
    ``composed``: ``ops.ntt``'s ``pre_canon``, #1's on a whole-length plan;
    ``fused``: #4's ``canon``)."""
    if not fused_switch:
        return "composed"
    if split:
        return "split"
    if coef_sharded or logN > FUSED_SWITCH_MAX_LOGN:
        return "composed"
    return "fused"


# The largest logN at which the tensor-core switch folds the special-prime
# mod-down into its kernels, as the JAX engine does (its fold kernel
# overflows the TPU's scoped VMEM at logN 16).
FOLD_MAX_LOGN = 15


def switch_route(logN, shoup_ksk, on_mesh=False, shoup_moddown=True,
                 fused=True):
    """The tensor-core switch kernel the JAX engine runs at this logN and
    key form, by the name of its launch counter: ``mxu_switch`` (mod-down
    folded in; Shoup-form key, Shoup mod-down, logN <= FOLD_MAX_LOGN, one
    device), ``mxu_switch_inv`` (Shoup-form key, separate mod-down) or
    ``mxu_switch_inv_mont`` (Montgomery-form key, separate mod-down); or
    ``composed`` where the JAX engine composes the switch in XLA (``fused``
    off: the Montgomery basis extension, or ``use_mxu_pallas`` off): the
    extension and the key products as torch ops around the transforms #5
    and #6. On a mesh (``on_mesh``) the fold is never taken: it needs
    every special row at each column, and a rank holds its own rows (the
    JAX engine folds on a single chip only)."""
    if not fused:
        return "composed"
    if not shoup_ksk:
        return "mxu_switch_inv_mont"
    if on_mesh or logN > FOLD_MAX_LOGN or not shoup_moddown:
        return "mxu_switch_inv"
    return "mxu_switch"


def _ksk_shoup(k, pack):
    """Montgomery-form key words [..., C, N] -> the Shoup pair (w, wp): the
    plain value w = REDC(k) in [0, q) and floor(w * 2^64 / q)."""
    w = ops.reduce_2q(ops.mont_redc(k, pack), pack)
    return w, u64.shoup_quotient(w, pack.q[:, None])


@errors.log_error
class CkksEngine:
    """The user-facing CKKS engine: keys (secret, public, evaluation,
    key-switching, rotation, conjugation and Galois), encode/encrypt,
    decrypt/decode of ciphertexts and triplets, ct x ct multiply and square
    with or without relinearisation, the batched multiply
    (``mult_batched``, ``mult_stacked``), relinearize, switch_key,
    add/sub/negate, scalar and plaintext operations (``mult``, ``add`` and
    ``sub`` dispatch on the operands' types), rotations, conjugation, sum,
    mean, cov, pow, sqrt, var and std; threshold (multiparty) keys and
    decryption; clone, device moves, save/load and a profiler trace.

    ``devices`` (or its alias ``device``): where every tensor lives
    (``torch_device``; ``device(x)`` answers where a DataStruct lies): a
    device or its name, or a list of them as the reference takes (the first
    is used); ``None`` means ``cuda:0`` and raises when no CUDA device is
    present. ``devices="cpu"`` runs the kernels' plain twins.
    ``mesh`` (``parallel.make_mesh(n)``, or ``mesh_shape=n`` inside a rank
    of ``parallel.run_ranks`` or of a ``torch.distributed`` job): this
    engine is one rank of n that shard the RNS channel axis. Every layout
    is padded to a multiple of n channels and the engine holds its rows on
    the mesh's device (``ntt.rows``); its keys and ciphertexts are those
    rows of the single-device engine's words at the same seed, and the
    steps that read other ranks' channels gather them (the rescale's
    dropped channel, the key switch's input and its special rows,
    ``level_up``, decryption). On a mesh with a ``coef`` axis of S ranks
    (``parallel.make_mesh2d(r, s)``, ``r`` may be 1; butterfly domain) the
    engine also holds only its coefficient columns (N / S of them): its
    transforms are the coefficient-sharded ones, and the steps that cross
    columns (the Galois permutations, decryption) gather along ``coef``.
    In the tensor-core domain a mesh has no ``coef`` axis, and the switch
    never folds the mod-down (``switch_route``).
    ``use_mxu_ntt``: run every transform and the key switch in the
    tensor-core kernels (natural-order NTT domain) instead of
    the butterfly kernels; one engine uses one domain throughout, and its
    keys and ciphertexts are for engines of the same domain.
    ``use_shoup_ksk`` (tensor-core domain only, as the JAX package's
    ``config.use_shoup_ksk``): keep the key stacks in Shoup form (value and
    quotient); else in Montgomery form, and the switch never folds the
    mod-down. ``use_split_switch`` (butterfly domain only, as the JAX
    package's ``config.use_split_switch``): run the switch core as the
    forward NTT then ``ksk_mulacc``; else as one ``ntt_mulacc`` kernel up
    to FUSED_SWITCH_MAX_LOGN and composed above it
    (``butterfly_switch_route``). All routes give the same words.

    The JAX package's ``config`` switches that change words or routes, by
    their field names, each True by default (the JAX package's TPU
    default), stored at construction:
    ``use_shoup_twiddles``: the transforms' twiddles in Shoup form (plain
    values and quotients); off, in Montgomery form, the reference's chain,
    whose words the JAX CPU engine gives (butterfly domain).
    ``use_shoup_rescale``: the rescale in the plain domain
    (``_rescale_core_shoup``); off, ``_rescale_core_mont``.
    ``use_shoup_moddown``: the switch's mod-down in the plain domain
    (``_mod_down_shoup``); off, ``_mod_down_mont``, and the tensor-core
    switch never folds it.
    ``use_shoup_extend``: the switch's basis extension in the plain
    domain (``_extend_shoup``, unsigned words) and its inverse transform
    without the Montgomery exit; off, the Montgomery extension
    (``_extend_mont``, signed words) with the canon pre-stage before the
    forward transform, the exit after the inverse, and in the tensor-core
    domain the composed switch (``switch_route``).
    ``use_mxu_pallas`` (tensor-core domain): the JAX package's switch of
    its fused Pallas kernels, which here selects the width-group plans with
    the Shoup recombination and the fused switch kernels (#9-#11); off, the
    JAX package's XLA composition: one plan over every channel with the
    Montgomery recombination in #5 and #6, the Montgomery entry and exit
    as pointwise ops around them, and the composed switch with a
    Montgomery-form key.
    ``use_fused_switch`` (butterfly domain): off, the composed switch core
    at every logN (``butterfly_switch_route``).
    The JAX fields that only choose a TPU layout or backend (``use_pallas``,
    ``pallas_interpret``, ``use_split_transform``, ``use_tiled_*``) give
    the same words and have no keyword. ``mult_batched`` loops over
    ``cc_mult`` unless the fused tensor-core switch runs with the Shoup
    mod-down and rescale, as the JAX engine's.
    """

    def __init__(self, devices=None, verbose: bool = False,
                 bias_guard: bool = True, norm: str = "forward",
                 seed=None, mesh_shape=None, mesh=None,
                 use_mxu_ntt: bool = False, use_shoup_ksk: bool = True,
                 use_split_switch: bool = True,
                 use_shoup_twiddles: bool = True,
                 use_shoup_rescale: bool = True,
                 use_shoup_moddown: bool = True,
                 use_shoup_extend: bool = True,
                 use_mxu_pallas: bool = True,
                 use_fused_switch: bool = True, device=None, **ctx_params):
        if device is not None:
            if devices is not None and devices != device:
                raise TypeError("devices and its alias device differ")
            devices = device
        if mesh is None and mesh_shape not in (None, 1):
            from ..parallel import make_mesh
            mesh = make_mesh(math.prod(mesh_shape)
                             if isinstance(mesh_shape, (tuple, list))
                             else int(mesh_shape))
        self.devices = devices
        self.mesh = mesh
        self.mesh_shape = mesh_shape
        self.mesh_axis = "rns"
        self.coef_shards, self.coef_index = 1, 0
        if mesh is not None:
            self.coef_shards = mesh.axis_size("coef")
            self.coef_index = mesh.axis_index("coef")
            self.channel_quantum = mesh.axis_size(self.mesh_axis)
            self.torch_device = mesh.device
        else:
            self.channel_quantum = 1
            self.torch_device = resolve_device(
                devices[0] if isinstance(devices, (list, tuple)) else devices)
        self.bias_guard = bias_guard
        self.norm = norm
        self.version = VERSION
        self.use_mxu_ntt = bool(use_mxu_ntt)
        self.use_shoup_ksk = bool(use_shoup_ksk)
        self.use_split_switch = bool(use_split_switch)
        self.use_shoup_twiddles = bool(use_shoup_twiddles)
        self.use_shoup_rescale = bool(use_shoup_rescale)
        self.use_shoup_moddown = bool(use_shoup_moddown)
        self.use_shoup_extend = bool(use_shoup_extend)
        self.use_mxu_pallas = bool(use_mxu_pallas)
        self.use_fused_switch = bool(use_fused_switch)

        if mesh is None:
            self.ctx = CkksContext(verbose=verbose, **ctx_params)
        else:
            # The ranks of one process build the host context once.
            self.ctx = mesh.shared(
                ("ctx", tuple(sorted(ctx_params.items()))),
                lambda: CkksContext(verbose=verbose, **ctx_params))
        self.ntt = NttContext(self.ctx, self.torch_device,
                              use_mxu=self.use_mxu_ntt, mesh=mesh,
                              shoup_twiddles=self.use_shoup_twiddles,
                              mxu_pallas=self.use_mxu_pallas)
        if self.coef_shards > 1:
            # The coefficient plans' checks (a power of two; on the card
            # shards of at least 2^8 words) raise here, not at first use.
            self.pack(0, -2)

        # The deepest usable level.
        self.num_levels = self.ntt.num_levels - 1
        self.num_slots = self.ctx.N // 2
        self.num_ordinary = self.ntt.num_ordinary_primes
        self.num_special = self.ntt.num_special_primes

        if mesh is not None and seed is None:
            # Every rank draws the same words: rank 0's random key.
            seed = comm.broadcast_mesh(
                torch.from_numpy(np.frombuffer(os.urandom(32), np.uint32)
                                 .astype(np.int64)), mesh).numpy()
        self.rng = Csprng(self.ctx.N, self.num_ordinary,
                          max(self.num_special, 2), sigma=self.ctx.sigma,
                          seed=seed, device=self.torch_device)

        self.int_scale = 2 ** self.ctx.scale_bits
        self.scale = np.float64(self.int_scale)
        self.hash = self.ctx.engine_hash()

        self._make_adjustments_and_corrections()
        self._make_mont_PR()
        self._create_ksk_rescales()
        self._create_rescale_scales()
        self.galois_deltas = [2 ** i for i in range(self.ctx.logN - 1)]
        self._ksk_stacked_cache = OrderedDict()
        self._ksk_level_cache = OrderedDict()
        self._mxu_switch_cache = {}
        self._perm_device_cache = {}
        self._mesh_cache = {}

        # (type, type) -> the name of the method: bound methods here would
        # tie the engine to itself in a reference cycle, and ``del engine``
        # would leave its tables and keys (over 10 GB at platinum) to the
        # cyclic collector.
        self.mult_dispatch = {
            (DataStruct, DataStruct): "auto_cc_mult",
            (list, DataStruct): "mc_mult",
            (np.ndarray, DataStruct): "mc_mult",
            (DataStruct, np.ndarray): "cm_mult",
            (DataStruct, list): "cm_mult",
            (float, DataStruct): "scalar_mult",
            (DataStruct, float): "mult_scalar",
            (int, DataStruct): "int_scalar_mult",
            (DataStruct, int): "mult_int_scalar",
        }
        self.add_dispatch = {
            (DataStruct, DataStruct): "auto_cc_add",
            (list, DataStruct): "mc_add",
            (np.ndarray, DataStruct): "mc_add",
            (DataStruct, np.ndarray): "cm_add",
            (DataStruct, list): "cm_add",
            (float, DataStruct): "scalar_add",
            (DataStruct, float): "add_scalar",
            (int, DataStruct): "scalar_add",
            (DataStruct, int): "add_scalar",
        }
        self.sub_dispatch = {
            (DataStruct, DataStruct): "auto_cc_sub",
            (list, DataStruct): "mc_sub",
            (np.ndarray, DataStruct): "mc_sub",
            (DataStruct, np.ndarray): "cm_sub",
            (DataStruct, list): "cm_sub",
            (float, DataStruct): "scalar_sub",
            (DataStruct, float): "sub_scalar",
            (int, DataStruct): "scalar_sub",
            (DataStruct, int): "sub_scalar",
        }

    def _tensor(self, vals):
        return u64.tensor(vals, self.torch_device)

    # -- precomputation -------------------------------------------------------

    def _make_adjustments_and_corrections(self):
        """Per-level deviation/correction factors and the final decryption
        scalar q_l^-1 * R mod base_prime."""
        ctx = self.ctx
        self.alpha = [(self.scale / np.float64(q)) ** 2
                      for q in ctx.q[:ctx.num_scales]]
        self.deviations = [1.0]
        for al in self.alpha:
            self.deviations.append(self.deviations[-1] ** 2 * al)

        # At level l the rescale channel is q[l].
        self.final_q = [ctx.q[l] for l in range(self.num_levels)]
        self.final_alpha = [(self.scale / np.float64(q))
                            for q in self.final_q]
        self.corrections = [1 / (d * fa) for d, fa
                            in zip(self.deviations, self.final_alpha)]

        self.base_prime = ctx.q[self.num_ordinary - 1]
        self.base_idx = self.num_ordinary - 1
        self.final_scalar = [
            self._tensor([(pow(q, -1, self.base_prime) * ctx.R)
                          % self.base_prime])
            for q in self.final_q]
        self.round_halves = [self._tensor([q // 2]) for q in self.final_q]
        self.base_pack = self.ntt.make_pack(self.base_idx, self.base_idx + 1,
                                            with_plan=False)

    def _make_mont_PR(self):
        """P*R mod q_i over the ordinary primes, for ksk generation."""
        P = math.prod(self.ctx.q[-self.num_special:])
        self.mont_PR = self._tensor([(P * self.ctx.R) % q
                                     for q in self.ctx.q[:self.num_ordinary]])

    def _shoup_pair(self, ws, qs):
        ws = [int(w) % int(q) for w, q in zip(ws, qs)]
        return (self._tensor(ws),
                self._tensor([(w << 64) // int(q) for w, q in zip(ws, qs)]))

    def _create_ksk_rescales(self):
        """Mod-down tables per level, over the with-special channels. Shoup
        form: for each special prime P_j (P_j^-1 mod q_i, quotient), 1 on
        the channels already dropped, stacked [n_sp, 2, C_sp]; the Barrett
        reciprocals floor(2^64 / q_i), and the offset correction
        2q - (2^63 mod q) of the basis extension's first term. Montgomery
        form: PiRs, P_j^-1 R mod q_i (R, the identity, on the channels
        already dropped), and enter_ord, R^2 on the ordinary channels and R
        on the special ones."""
        ctx = self.ctx
        R = ctx.R
        P = ctx.q[-self.num_special:][::-1]
        self.PiWs = []
        self.bp_sp = []
        self.PiRs = []
        self.enter_ord = []
        for level in range(self.num_levels):
            q_lvl = ctx.q[level:]
            C_sp = len(q_lvl)
            n_ord = C_sp - self.num_special
            per_level, per_level_r = [], []
            for P_ind, Pj in enumerate(P):
                live = C_sp - P_ind - 1
                ws = ([pow(Pj, -1, mi) for mi in q_lvl[:live]]
                      + [1] * (C_sp - live))
                per_level.append(self._shoup_pair(ws, q_lvl))
                per_level_r.append(self._tensor(
                    [w * R % mi for w, mi in zip(ws, q_lvl)]))
            self.PiWs.append(torch.stack([torch.stack(p)
                                          for p in per_level]))
            self.PiRs.append(tuple(per_level_r))
            self.bp_sp.append((
                self._tensor([(1 << 64) // q for q in q_lvl]),
                self._tensor([2 * q - ((1 << 63) % q) for q in q_lvl])))
            self.enter_ord.append(self._tensor(
                ctx.R_square[level:level + n_ord]
                + [R % mi for mi in q_lvl[n_ord:]]))

    def _create_rescale_scales(self):
        """Rescale tables of the channels that survive level l: the Shoup
        form's (q_l^-1 mod q_i, quotient) and Barrett reciprocals, the
        Montgomery form's q_l^-1 R mod q_i (``rescale_scales``)."""
        ctx = self.ctx
        self.rescale_sh = []
        self.bp_ord = []
        self.rescale_scales = []
        for level in range(self.num_levels):
            m0 = ctx.q[level]
            m = ctx.q[level + 1:self.num_ordinary]
            self.rescale_sh.append(
                self._shoup_pair([pow(m0, -1, mi) for mi in m], m))
            self.bp_ord.append(self._tensor([(1 << 64) // q for q in m]))
            self.rescale_scales.append(self._tensor(
                [pow(m0, -1, mi) * ctx.R % mi for mi in m]))

    def pack(self, level: int, mult_type: int = -1):
        return self.ntt.level_pack(level, mult_type)

    # -- the channel layout on a mesh ----------------------------------------------
    #
    # A layout is (level, mult_type). Without a mesh these helpers are the
    # single-device identities; on one, a layout's words are this rank's
    # rows of it (``ntt.rows``) and, on a coef axis, its coefficient columns
    # (``_cols``); a step that reads other ranks' channels gathers them
    # along ``rns``, one that reads other columns along ``coef``.

    def _cached(self, key, build):
        if key not in self._mesh_cache:
            self._mesh_cache[key] = build()
        return self._mesh_cache[key]

    def _index(self, offsets):
        """int64 device index of the row offsets."""
        return self._cached(("index", tuple(offsets)), lambda: torch.tensor(
            offsets, dtype=torch.int64, device=self.torch_device))

    def _offsets(self, level, mult_type, base):
        return [r - base for r in self.ntt.rows(level, mult_type)]

    def _cols(self, full):
        """This rank's coefficient columns of full-length words [..., N]
        (the CSPRNG's draws, encoded messages): all of them but on a coef
        axis."""
        if self.coef_shards == 1:
            return full
        return full[..., coef_columns(self.mesh, full.shape[-1])].contiguous()

    def _local_rows(self, full, level, mult_type):
        """This rank's rows of a layout's words [..., C, n] of all its
        channels."""
        if self.mesh is None:
            return full
        start = self.ntt.channel_range(level, mult_type)[0]
        return full[..., self._index(self._offsets(level, mult_type, start)),
                    :]

    def _local(self, full, level, mult_type):
        """This rank's rows and columns of a layout's full-width words
        [..., C, N]."""
        return self._cols(self._local_rows(full, level, mult_type))

    def _gather(self, x, level, mult_type):
        """A layout's words [..., C, n] of all its channels from every
        rank's rows (along ``rns``: the columns stay this rank's)."""
        if self.mesh is None:
            return x
        if self.channel_quantum > 1:
            x = comm.all_gather(x, self.mesh, self.mesh_axis)
        return x[..., :self.ntt.num_channels(level, mult_type), :]

    def _gather_full(self, x, level, mult_type):
        """A layout's full-width words [..., C, N] on every rank: gathered
        along ``rns``, then along ``coef``."""
        x = self._gather(x, level, mult_type)
        if self.coef_shards > 1:
            x = comm.all_gather(x, self.mesh, "coef", dim=-1)
        return x

    def _dc(self, vals):
        """Per-channel constants [C] to add to coefficient 0: zeros on a
        coefficient shard that does not hold it."""
        return vals if self.coef_index == 0 else torch.zeros_like(vals)

    def _fit(self, x, src, dst):
        """Words of the layout src in the layout dst (whose channels start
        no earlier): src's words of dst's channels, zeros where src has
        none (``ops.fit_channels``)."""
        if src == dst:
            return x
        full = self._gather(x, *src)
        return self._local_rows(
            ops.fit_channels(full[..., dst[0] - src[0]:, :],
                             self.ntt.num_channels(*dst)), *dst)

    def _key_layout(self, key: DataStruct):
        """The layout of a secret or public key's words."""
        return (0, -2 if key.include_special else -1)

    # -- examples and errors -------------------------------------------------------

    def absmax_error(self, x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        if np.iscomplexobj(x) and np.iscomplexobj(y):
            return (np.abs(x.real - y.real).max()
                    + np.abs(x.imag - y.imag).max() * 1j)
        return np.abs(x - y).max()

    def integral_bits_available(self):
        return math.floor(math.log2(self.base_prime)) - self.ctx.scale_bits

    def example(self, amin=None, amax=None, decimal_places: int = 10):
        if amin is None:
            amin = -(2 ** self.integral_bits_available())
        if amax is None:
            amax = 2 ** self.integral_bits_available()
        base = 10 ** decimal_places
        a = np.random.randint(amin * base, amax * base, self.num_slots) / base
        b = np.random.randint(amin * base, amax * base, self.num_slots) / base
        if self.mesh is not None:
            # Every rank encrypts the same message: rank 0's.
            a, b = comm.broadcast_mesh(torch.from_numpy(np.stack([a, b])),
                                       self.mesh).numpy()
        return a + b * 1j

    # -- encode / decode ------------------------------------------------------------

    def padding(self, m):
        m = np.atleast_1d(np.asarray(m))
        return np.pad(m, (0, self.num_slots - len(m)))

    def encode(self, m, level: int = 0, padding=True) -> torch.Tensor:
        """Complex message -> signed plaintext polynomial [1, N]."""
        if padding:
            m = self.padding(m)
        encoded = encdec.encode(m, rng=self.rng, scale=self.scale,
                                deviation=self.deviations[level],
                                norm=self.norm)
        return torch.from_numpy(encoded[None, :]).to(self.torch_device)

    def decode(self, m, level=0, is_real: bool = False):
        """Signed plaintext [1, N] -> complex message (N/2 slots)."""
        poly = m.to("cpu").numpy()[0]
        decoded = encdec.decode(poly, scale=self.scale,
                                correction=self.corrections[level],
                                norm=self.norm)[:self.num_slots]
        return decoded.real if is_real else decoded

    # -- key generation ----------------------------------------------------------

    def create_secret_key(self, include_special: bool = True) -> DataStruct:
        """Uniform ternary secret in the NTT+Montgomery domain."""
        ternary = self._cols(self.rng.randint(amax=3, shift=-1, repeats=1))
        mult_type = -2 if include_special else -1
        sk = _sk_core(ternary, self.pack(0, mult_type))
        return DataStruct(sk, include_special, True, True,
                          types.origins["sk"], 0, self.hash)

    def create_public_key(self, sk: DataStruct, include_special: bool = False,
                          a=None, crs=None) -> DataStruct:
        """pk = (e - a*s, a)."""
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        if include_special and not sk.include_special:
            raise errors.SecretKeyNotIncludeSpecialPrime()
        mult_type = -2 if include_special else -1
        pack = self.pack(0, mult_type)

        e = self._cols(self.rng.discrete_gaussian(repeats=1))
        if a is None:
            a = crs
        if a is None:
            repeats = self.num_special if include_special else 0
            a = self._local(
                self.rng.randint(amax=self.ntt.q_ints(0, mult_type),
                                 repeats=repeats), 0, mult_type)
        pk0, a_fit = _pk_core(e, a, self._fit(sk.data, self._key_layout(sk),
                                              (0, mult_type)), pack)
        return DataStruct((pk0, a_fit), include_special, True, True,
                          types.origins["pk"], 0, self.hash)

    def create_key_switching_key(self, sk_from: DataStruct, sk_to: DataStruct,
                                 a=None) -> DataStruct:
        """Hybrid gadget-decomposed ksk: one public-key pair per partition,
        with P*sk_from added on that partition's channel block."""
        if (sk_from.origin != types.origins["sk"]
                or sk_to.origin != types.origins["sk"]):
            raise errors.NotMatchType(origin="not a secret key",
                                      to=types.origins["sk"])
        if not sk_from.ntt_state or not sk_from.montgomery_state:
            raise errors.NotMatchDataStructState(origin=sk_from.origin)

        Psk = ops.mont_enter_scalar(
            self._fit(sk_from.data, self._key_layout(sk_from), (0, -1)),
            self.mont_PR[self._index(self.ntt.rows(0, -1))], self.pack(0, -1))
        # P*sk_from in the with-special layout, zero on the special rows.
        Psk = self._fit(Psk, (0, -1), (0, -2))
        pack_sp = self.pack(0, -2)
        rows = self._index(self.ntt.rows(0, -2))
        ksk = []
        for part in self.ntt.parts(0):
            crs = a[part.part_id] if a is not None else None
            pk = self.create_public_key(sk_to, include_special=True, a=crs)
            lo, hi = part.prime_idx[0], part.prime_idx[-1] + 1
            block = ((rows >= lo) & (rows < hi))[:, None]
            pk0 = torch.where(block, ops.mont_add(pk.data[0], Psk, pack_sp),
                              pk.data[0])
            ksk.append(pk._replace(
                data=(pk0, pk.data[1]),
                origin=f"key switch key part index {part.part_id}"))
        return DataStruct(ksk, True, True, True, types.origins["ksk"], 0,
                          self.hash)

    def create_evk(self, sk: DataStruct) -> DataStruct:
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        sk2 = sk._replace(data=ops.mont_mult(sk.data, sk.data,
                                             self.pack(0, -2)))
        return self.create_key_switching_key(sk2, sk)

    def _ksk_stacked(self, ksk: DataStruct):
        """Key halves stacked once per key: [P_full, C0_sp, N] x 2. The
        switch reads the level's channels and the active parts through
        strides, without slicing copies. Small LRU keyed by identity.

        Tensor-core domain with ``use_shoup_ksk`` where the fused switch
        kernels run (``_mxu_fused``, as the JAX engine's
        ``_mxu_fused_switch``): each half in Shoup form, a pair of the plain
        value w = REDC(k) in [0, q) and its quotient floor(w 2^64 / q), so
        the switch kernel's key products are Shoup products; else the
        Montgomery-form words as they are."""
        if ksk in self._ksk_stacked_cache:
            self._ksk_stacked_cache.move_to_end(ksk)
            return self._ksk_stacked_cache[ksk]
        k0 = torch.stack([part.data[0] for part in ksk.data])
        k1 = torch.stack([part.data[1] for part in ksk.data])
        if self.use_mxu_ntt and self.use_shoup_ksk and self._mxu_fused():
            pack0 = self.pack(0, -2)
            k0, k1 = _ksk_shoup(k0, pack0), _ksk_shoup(k1, pack0)
        self._ksk_stacked_cache[ksk] = (k0, k1)
        if len(self._ksk_stacked_cache) > 16:
            self._ksk_stacked_cache.popitem(last=False)
        return k0, k1

    # -- encrypt / decrypt --------------------------------------------------------

    def encrypt(self, pt, pk: DataStruct, level: int = 0) -> DataStruct:
        """Encrypt the full-length plaintext ``pt`` [1, N] (``encode``)."""
        if pk.origin != types.origins["pk"]:
            raise errors.NotMatchType(origin=pk.origin, to=types.origins["pk"])
        mult_type = -2 if pk.include_special else -1
        pack = self.pack(level, mult_type)
        e0e1 = self._cols(self.rng.discrete_gaussian(repeats=2))
        v = self._cols(self.rng.randint(amax=2, shift=0, repeats=1))
        dc = torch.zeros_like(pack.q)
        ct0, ct1 = _encrypt_core(self._cols(pt), dc, e0e1[0:1], e0e1[1:2], v,
                                 *self._pk_at(pk, level), pack)
        return DataStruct((ct0, ct1), mult_type == -2, False, False,
                          types.origins["ct"], level, self.hash)

    def _pk_at(self, pk: DataStruct, level):
        """The public key's halves in the layout of a ciphertext at
        ``level``."""
        lay = self._key_layout(pk)
        return (self._fit(d, lay, (level, lay[1])) for d in pk.data)

    def _decrypt_pt(self, ct: DataStruct, sk: DataStruct):
        """Raw decryption of a ciphertext (plain domain) or a triplet (NTT
        and Montgomery domain) to the plaintext RNS poly (no final
        rescale), full width on every rank of a mesh."""
        pack = self.pack(ct.level, -1)
        if ct.origin == types.origins["ct"]:
            if ct.ntt_state or ct.montgomery_state:
                raise errors.NotMatchDataStructState(origin=ct.origin)
            pt = _decrypt_double_pt(ct.data[0], ct.data[1],
                                    self._sk_at(sk, ct.level), pack)
        elif ct.origin == types.origins["ctt"]:
            if not ct.ntt_state or not ct.montgomery_state:
                raise errors.NotMatchDataStructState(origin=ct.origin)
            pt = _decrypt_triplet_pt(*ct.data, self._sk_at(sk, ct.level),
                                     pack)
        else:
            raise errors.NotMatchType(origin=ct.origin, to="ct or ctt")
        return self._gather_full(pt, ct.level, -1)

    def _sk_at(self, sk: DataStruct, level):
        """The secret key in the ordinary layout of ``level``."""
        return self._fit(sk.data, self._key_layout(sk), (level, -1))

    def _final_rescale_signed(self, pt, level, final_round=True):
        rh = (self.round_halves[level] if final_round
              else self._tensor([(1 << 63) - 1]))
        return _final_rescale(pt, self.base_pack, self.final_scalar[level],
                              rh, self.num_ordinary - 1 - level)

    def decrypt(self, ct: DataStruct, sk: DataStruct, final_round=True):
        """Decrypt to the signed base-prime plaintext poly [1, N]."""
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        if not sk.ntt_state or not sk.montgomery_state:
            raise errors.NotMatchDataStructState(origin=sk.origin)
        pt = self._decrypt_pt(ct, sk)
        return self._final_rescale_signed(pt, ct.level, final_round)

    def decrypt_double(self, ct: DataStruct, sk: DataStruct,
                       final_round=True):
        """``decrypt`` of a ciphertext (not a triplet)."""
        if ct.origin != types.origins["ct"]:
            raise errors.NotMatchType(origin=ct.origin, to=types.origins["ct"])
        return self.decrypt(ct, sk, final_round=final_round)

    def decrypt_triplet(self, ct_mult: DataStruct, sk: DataStruct,
                        final_round=True):
        """Decrypt a triplet (``cc_mult(relin=False)``, ``square(relin=
        False)``) to the signed base-prime plaintext poly [1, N]."""
        if ct_mult.origin != types.origins["ctt"]:
            raise errors.NotMatchType(origin=ct_mult.origin,
                                      to=types.origins["ctt"])
        return self.decrypt(ct_mult, sk, final_round=final_round)

    def encodecrypt(self, m, pk: DataStruct, level: int = 0,
                    padding=True) -> DataStruct:
        if pk.origin != types.origins["pk"]:
            raise errors.NotMatchType(origin=pk.origin, to=types.origins["pk"])
        if padding:
            m = self.padding(m)
        mult_type = -2 if pk.include_special else -1
        pack = self.pack(level, mult_type)
        q_lvl = self.ntt.q_rows(level, mult_type)

        pt = encdec.encode(m, rng=self.rng, scale=self.scale,
                           deviation=self.deviations[level], norm=self.norm,
                           return_without_scaling=self.bias_guard)
        dc = torch.zeros_like(pack.q)
        if self.bias_guard:
            # Split the integral DC part into RNS to dodge single-channel
            # overflow.
            dc_integral = float(np.floor(pt[0]))
            pt = pt.copy()
            pt[0] -= dc_integral
            dc_scale = int(dc_integral) * self.int_scale
            dc = self._dc(self._tensor([dc_scale % qi for qi in q_lvl]))
            pt = self.rng.randround(pt * self.scale)
        pt = self._cols(torch.from_numpy(
            np.asarray(pt, dtype=np.int64)[None, :]).to(self.torch_device))

        e0e1 = self._cols(self.rng.discrete_gaussian(repeats=2))
        v = self._cols(self.rng.randint(amax=2, shift=0, repeats=1))
        ct0, ct1 = _encrypt_core(pt, dc, e0e1[0:1], e0e1[1:2], v,
                                 *self._pk_at(pk, level), pack)
        return DataStruct((ct0, ct1), mult_type == -2, False, False,
                          types.origins["ct"], level, self.hash)

    def decryptcode(self, ct: DataStruct, sk: DataStruct, is_real=False,
                    final_round=True):
        if not sk.ntt_state or not sk.montgomery_state:
            raise errors.NotMatchDataStructState(origin=sk.origin)
        level = ct.level
        pt = self._decrypt_pt(ct, sk)
        C = self.ntt.num_channels(level, -1)
        base_at = self.num_ordinary - 1 - level

        dc = 0
        if C >= 3 and self.bias_guard:
            # 3-prime CRT reconstruction of the DC coefficient.
            dc0, dc1, dc2 = (int(v) for v in
                             pt[[base_at, 0, 1], 0].to("cpu").tolist())
            pt = pt.clone()
            pt[base_at, 0] = 0
            pt[0, 0] = 0
            q_lvl = self.ntt.q_ints(level, -1)
            q0, q1, q2 = q_lvl[base_at], q_lvl[0], q_lvl[1]
            Q = q0 * q1 * q2
            Q0, Q1, Q2 = q1 * q2, q0 * q2, q0 * q1
            dc_crt = (dc0 * pow(Q0, -1, q0) * Q0
                      + dc1 * pow(Q1, -1, q1) * Q1
                      + dc2 * pow(Q2, -1, q2) * Q2) % Q
            if dc_crt > Q // 2:
                dc_crt -= Q
            dc = (dc_crt + (q1 - 1)) // q1

        scaled = self._final_rescale_signed(pt, level, final_round)
        correction = self.corrections[level]
        poly = scaled.to("cpu").numpy()[0]
        decoded = encdec.decode(poly, scale=self.scale, correction=correction,
                                norm=self.norm,
                                return_without_scaling=self.bias_guard)
        decoded = decoded[:self.num_slots]
        if self.bias_guard:
            decoded = decoded / self.scale * correction
            decoded = decoded + dc / self.scale * correction
        return decoded.real if is_real else decoded

    def encorypt(self, m, pk, level: int = 0, padding=True):
        return self.encodecrypt(m, pk, level=level, padding=padding)

    def decrode(self, ct, sk, is_real=False, final_round=True):
        return self.decryptcode(ct, sk, is_real=is_real,
                                final_round=final_round)

    # -- key switching -----------------------------------------------------------

    def _switch(self, a, ksk: DataStruct, level: int, exit_ntt=False):
        """Key-switch a [C_ord, N] (plain [0, q), coefficient domain; with
        ``exit_ntt`` NTT and Montgomery domain, brought back by the inverse
        transform with the exit and the reduce): returns (d0, d1) over the
        ordinary channels in [0, q). The butterfly switch core takes
        ``butterfly_switch_route``."""
        if exit_ntt:
            a = ops.intt_exit_reduce(a, self.pack(level, -1))
        if self.use_mxu_ntt:
            return self._switch_mxu(a, ksk, level)
        parts = self.ntt.parts(level)
        pack_sp = self.pack(level, -2)
        # Every part's channels on every rank of a mesh.
        a = self._gather(a, level, -1)
        ext = self._extend(a, level)                      # [P, C_sp, N]
        canon = not self.use_shoup_extend
        k0, k1, at = self._ksk_at(ksk, level)
        part_off = parts[0].part_id
        route = butterfly_switch_route(self.ctx.logN, self.use_split_switch,
                                       self.coef_shards > 1,
                                       self.use_fused_switch)
        if route == "fused":
            return self._switch_exit(torch.stack(cuda_ntt.ntt_mulacc(
                ext, k0, k1, pack_sp.plan, at, part_off, canon)), level)
        x = ops.ntt(ext, pack_sp, pre_canon=canon)
        if route == "split":
            # On a coefficient shard #3 runs on the shard's columns with
            # its local plan (moduli, length).
            plan = pack_sp.plan if pack_sp.coef is None \
                else pack_sp.coef.local
            d0, d1 = cuda_ntt.ksk_mulacc(x, k0, k1, plan, at, part_off)
        else:
            d0, d1 = self._key_products(x, k0, k1, at, part_off, pack_sp)
        return self._switch_exit(torch.stack([d0, d1]), level)

    def _extend(self, a, level):
        """Every part's basis extension of a [C_ord, N] (all channels)
        onto the with-special layout, stacked [P, C_sp, N]: the Shoup
        extension (unsigned [0, 2q)), or with ``use_shoup_extend`` off the
        Montgomery one (signed words)."""
        parts = self.ntt.parts(level)
        pack_sp = self.pack(level, -2)
        le, bp_off = self._extension_tables(level)
        return torch.stack([
            _extend_shoup(_pre_extend(a, p.local_start, p.alpha, p), le[i],
                          pack_sp, bp_off, 0) if self.use_shoup_extend
            else _extend_mont(_pre_extend(a, p.local_start, p.alpha, p),
                              le[i], pack_sp)
            for i, p in enumerate(parts)])

    @staticmethod
    def _key_products(x, k0, k1, at, part_off, pack_sp):
        """The composed switch core's key products of the transformed parts
        x [P, C_sp, N] with the Montgomery-form key stacks and their sums
        over the parts, as torch ops: (d0, d1) [C_sp, N]."""
        P, C_sp = x.shape[0], x.shape[1]
        t0 = ops.mont_mult(x, k0[part_off:part_off + P, at:at + C_sp],
                           pack_sp)
        t1 = ops.mont_mult(x, k1[part_off:part_off + P, at:at + C_sp],
                           pack_sp)
        d0, d1 = t0[0], t1[0]
        for p in range(1, P):
            d0 = ops.mont_add(d0, t0[p], pack_sp)
            d1 = ops.mont_add(d1, t1[p], pack_sp)
        return d0, d1

    def _switch_exit(self, d, level):
        """The key sums d [2, C_sp, N] (NTT domain) through the inverse
        transform and the mod-down: the reduce without the exit after the
        Shoup extension (its products are plain), with it after the
        Montgomery one."""
        pack_sp = self.pack(level, -2)
        d = (ops.intt_reduce if self.use_shoup_extend
             else ops.intt_exit_reduce)(d, pack_sp)
        d = self._mod_down(d, level)
        return d[0], d[1]

    def _mod_down(self, d, level):
        """The mod-down of the switch's [..., C_sp, n] words of ``level``
        (``_mod_down_shoup``, or ``_mod_down_mont`` with
        ``use_shoup_moddown`` off); on a mesh from the gathered rows (this
        rank's ordinary rows and the special rows, from every rank)."""
        if self.mesh is None:
            pack_md = self.pack(level, -2)
            pirs, enter_ord = self.PiRs[level], self.enter_ord[level]
            piws, bp = self.PiWs[level], self.bp_sp[level][0]
        else:
            idx, pack_md, pirs, enter_ord, piws, bp = \
                self._mod_down_tables(level)
            d = self._gather(d, level, -2)[..., idx, :]
        if not self.use_shoup_moddown:
            return _mod_down_mont(d, pack_md, self.pack(level, -1), pirs,
                                  enter_ord, self.num_special)
        return _mod_down_shoup(d, pack_md, self.pack(level, -1), piws, bp,
                               self.num_special)

    def create_switcher(self, a, ksk: DataStruct, level: int,
                        exit_ntt: bool = False):
        """Key-switch the polynomial ``a`` [C_ord, N] of ``level`` (plain
        [0, q); NTT and Montgomery domain with ``exit_ntt``): returns
        (d0, d1) over the ordinary channels in plain [0, q)."""
        d0, d1 = self._switch(a, ksk, level, exit_ntt=exit_ntt)
        return d0, d1

    # Tables of the switch and the rescale cut to a rank's rows: each pairs
    # a layout's rows with the per-level tables, which are over the
    # channels from ``level`` on (the extension's terms over all of them).

    def _extension_tables(self, level):
        """(each part's extension terms, the Barrett reciprocals and offset
        corrections) of the with-special layout, cut to this rank's rows
        (all of them on one device) once a level: they start at row 0.
        The terms are the Shoup extension's (w, wp, cadj), or with
        ``use_shoup_extend`` off the Montgomery extension's L_i R^2."""
        def build():
            rows = self._index(self.ntt.rows(level, -2))
            rel = self._index(self._offsets(level, -2, level))
            if self.use_shoup_extend:
                terms = [tuple(tuple(t[rows] for t in term)
                               for term in p.L_enter_sh)
                         for p in self.ntt.parts(level)]
            else:
                terms = [tuple(t[rows] for t in p.L_enter)
                         for p in self.ntt.parts(level)]
            return terms, tuple(t[rel] for t in self.bp_sp[level])

        return self._cached(("extension", level), build)

    def _mod_down_tables(self, level):
        """The gathered rows the mod-down reads on a mesh (this rank's
        ordinary rows, then the special rows), their pack, the Montgomery
        chain's P_j^-1 R steps and entry scalars, and the Shoup chain's
        P_j^-1 steps [n_sp, 2, rows] and Barrett reciprocals."""
        def build():
            C_ord = self.ntt.num_channels(level, -1)
            C_sp = self.ntt.num_channels(level, -2)
            offs = self._offsets(level, -1, level) + list(range(C_ord, C_sp))
            idx = self._index(offs)
            return (idx, self.ntt.make_pack_rows([level + o for o in offs],
                                                 with_plan=False),
                    tuple(t[idx] for t in self.PiRs[level]),
                    self.enter_ord[level][idx],
                    self.PiWs[level].index_select(-1, idx),
                    self.bp_sp[level][0][idx])

        return self._cached(("mod_down", level), build)

    def _ksk_at(self, ksk: DataStruct, level):
        """The key stacks and the row of the level's first channel in them:
        the stacks and ``level`` on one device; on a mesh this rank's rows
        of the level's with-special layout (a gather the first time a key
        meets a level, then kept) and 0. A Shoup-form half is a (value,
        quotient) pair, each cut alike."""
        k0, k1 = self._ksk_stacked(ksk)
        if self.mesh is None or level == 0:
            return k0, k1, level
        key = (ksk, level)

        def fit(k):
            if isinstance(k, tuple):
                return tuple(fit(t) for t in k)
            return self._fit(k, (0, -2), (level, -2)).contiguous()

        if key not in self._ksk_level_cache:
            self._ksk_level_cache[key] = (fit(k0), fit(k1))
            if len(self._ksk_level_cache) > 16:
                self._ksk_level_cache.popitem(last=False)
        self._ksk_level_cache.move_to_end(key)
        return (*self._ksk_level_cache[key], 0)

    def _rescale_words(self, d, level, round_half):
        """The rescale of words d [..., C, N] of the ordinary layout of
        ``level`` into that of level + 1 (``_rescale_core_shoup``, or
        ``_rescale_core_mont`` with ``use_shoup_rescale`` off); on a mesh
        from the gathered words (the dropped channel and this rank's
        rows)."""
        pack_next = self.pack(level + 1, -1)
        if self.mesh is None:
            rs_sh, bp = self.rescale_sh[level], self.bp_ord[level]
            rs = self.rescale_scales[level]
        else:
            def build():
                offs = self._offsets(level + 1, -1, level + 1)
                rel = self._index(offs)
                return (self._index([0] + [o + 1 for o in offs]),
                        tuple(t[rel] for t in self.rescale_sh[level]),
                        self.bp_ord[level][rel],
                        self.rescale_scales[level][rel])

            idx, rs_sh, bp, rs = self._cached(("rescale", level), build)
            d = self._gather(d, level, -1)[..., idx, :]
        if not self.use_shoup_rescale:
            return _rescale_core_mont(d, rs, round_half, pack_next)
        return _rescale_core_shoup(d, rs_sh, bp, round_half, pack_next)

    def _mxu_switch_tables(self, level: int):
        """Per-level scalars of the fused switch: the extension terms
        [P, max(A-1, 1), 3, C_sp] ((w, wp, cadj) per part, term and
        channel, zero past a part's alpha-1 terms), the first term's offset
        correction [C_sp] and the mod-down steps [n_sp, 2, C_sp]; on a mesh
        over this rank's rows of the with-special layout."""
        if level not in self._mxu_switch_cache:
            parts = self.ntt.parts(level)
            C_sp = self.ntt.num_channels(level, -2)
            nterms = max(max(p.alpha for p in parts) - 1, 1)
            terms = torch.zeros((len(parts), nterms, 3, C_sp),
                                dtype=torch.int64, device=self.torch_device)
            for pi, p in enumerate(parts):
                for i, sh in enumerate(p.L_enter_sh):
                    terms[pi, i] = torch.stack(
                        [t[level:level + C_sp] for t in sh])
            piw = self.PiWs[level]
            off0 = self.bp_sp[level][1]
            if self.mesh is not None:
                rel = self._index(self._offsets(level, -2, level))
                terms, off0, piw = (t.index_select(-1, rel).contiguous()
                                    for t in (terms, off0, piw))
            self._mxu_switch_cache[level] = (terms, off0, piw)
        return self._mxu_switch_cache[level]

    def _mxu_fused(self):
        """Whether the tensor-core switch runs in its fused kernels (the
        Shoup basis extension with ``use_mxu_pallas``, as the JAX engine's
        ``mxu_fused``); else it is composed (``switch_route``)."""
        return self.use_shoup_extend and self.use_mxu_pallas

    def _switch_mxu(self, a, ksk: DataStruct, level: int):
        """_switch in the tensor-core domain: the raw divided-difference
        state of each part, zero-padded to A rows and stacked [P, A, N],
        goes through the switch kernels (extension, transform, key
        products, inverse), which also fold in the mod-down on the
        ``switch_route`` that does; else the mod-down follows. On a mesh
        every rank runs the kernels on its rows of the with-special layout
        from the gathered state, then the gathered mod-down. On the
        ``composed`` route the extension, the key products and their sums
        are torch ops around the transforms #5 and #6 (with the Montgomery
        extension its canon first, and the exit after the inverse), as
        the JAX engine composes them in XLA.

        A ciphertext batch a [B, C, N] runs as B segments of P parts
        ([B*P, A, N], b-major) through one dispatch of the same kernels;
        (d0, d1) are then [B, C, N] each."""
        parts = self.ntt.parts(level)
        # Every part's channels on every rank of a mesh.
        a = self._gather(a, level, -1)
        k0, k1, at = self._ksk_at(ksk, level)
        pack_sp = self.pack(level, -2)
        part_off = parts[0].part_id
        route = switch_route(self.ctx.logN, self.use_shoup_ksk,
                             self.mesh is not None, self.use_shoup_moddown,
                             self._mxu_fused())
        if route == "composed":
            x = ops.ntt(self._extend(a, level), pack_sp,
                        pre_canon=not self.use_shoup_extend)
            return self._switch_exit(torch.stack(self._key_products(
                x, k0, k1, at, part_off, pack_sp)), level)
        A = max(p.alpha for p in parts)
        zero = torch.zeros_like(a[..., 0:1, :])
        st = torch.stack([
            torch.cat(s + [zero] * (A - len(s)), dim=-2)
            for s in (_pre_extend(a, p.local_start, p.alpha, p)
                      for p in parts)], dim=-3)
        seg = None if a.dim() == 2 else len(parts)
        st = st.reshape(-1, A, a.shape[-1])
        terms, off0, piw = self._mxu_switch_tables(level)
        if route == "mxu_switch":
            d = cuda_mxu.dispatch_switch(st, terms, off0, piw, k0, k1,
                                         pack_sp.mxu, at, part_off,
                                         self.num_special, parts=seg)
            C = self.ntt.num_channels(level, -1)
            return d[0, ..., :C, :], d[1, ..., :C, :]
        d = cuda_mxu.dispatch_switch_inv(st, terms, off0, k0, k1, pack_sp.mxu,
                                         at, part_off, parts=seg)
        d = self._mod_down(d, level)
        return d[0], d[1]

    # -- rescale / mult ----------------------------------------------------------

    def rescale(self, ct: DataStruct, exact_rounding=True) -> DataStruct:
        if ct.origin != types.origins["ct"]:
            raise errors.NotMatchType(origin=ct.origin, to=types.origins["ct"])
        level = ct.level
        if level + 1 >= self.num_levels:
            raise errors.MaximumLevelError(level=level,
                                           level_max=self.num_levels)
        rh = self.round_halves[level] if exact_rounding else None
        c = self._rescale_words(torch.stack(ct.data), level, rh)
        return DataStruct((c[0], c[1]), False, False, False,
                          types.origins["ct"], level + 1, self.hash)

    def switch_key(self, ct: DataStruct, ksk: DataStruct) -> DataStruct:
        """Switch a ciphertext to the key ``ksk`` carries it to
        (``create_key_switching_key(sk_from, sk_to)``: ct under sk_from in,
        under sk_to out). Of an NTT-state ciphertext, ct1 leaves the NTT
        domain before the switch; ct0 and the flags are kept as they
        are."""
        if ct.origin != types.origins["ct"]:
            raise errors.NotMatchType(origin=ct.origin, to=types.origins["ct"])
        level = ct.level
        d0, d1 = self._switch(ct.data[1], ksk, level, exit_ntt=ct.ntt_state)
        pack = self.pack(level, -1)
        ct0 = ops.reduce_2q(ops.mont_add(ct.data[0], d0, pack), pack)
        return DataStruct((ct0, d1), ct.include_special, ct.ntt_state,
                          ct.montgomery_state, types.origins["ct"], level,
                          self.hash)

    def relinearize(self, ct_triplet: DataStruct,
                    evk: DataStruct) -> DataStruct:
        """Triplet -> ciphertext at the same level: the B=3 inverse
        transform, then the key switch of d2."""
        if ct_triplet.origin != types.origins["ctt"]:
            raise errors.NotMatchType(origin=ct_triplet.origin,
                                      to=types.origins["ctt"])
        level = ct_triplet.level
        pack = self.pack(level, -1)
        d0, d1, d2 = _relin_pre(*ct_triplet.data, pack)
        s0, s1 = self._switch(d2, evk, level)
        c0, c1 = _relin_post(d0, d1, s0, s1, pack)
        return DataStruct((c0, c1), False, False, False,
                          types.origins["ct"], level, self.hash)

    def square(self, ct: DataStruct, evk: DataStruct,
               relin=True) -> DataStruct:
        """ct x ct of one ciphertext with itself: the rescale, the products
        (one B=2 transform) and, with ``relin``, the relinearisation."""
        x = self.rescale(ct)
        pack = self.pack(x.level, -1)
        ct_mult = DataStruct(_square_core(*x.data, pack), False, True, True,
                             types.origins["ctt"], x.level, self.hash)
        return self.relinearize(ct_mult, evk) if relin else ct_mult

    def cc_mult(self, a: DataStruct, b: DataStruct, evk: DataStruct,
                relin=True) -> DataStruct:
        """ct x ct multiply with the input rescales; the result sits one
        level deeper: a ciphertext with ``relin``, else the NTT- and
        Montgomery-domain triplet."""
        for ct in (a, b):
            if ct.origin != types.origins["ct"]:
                raise errors.NotMatchType(origin=ct.origin,
                                          to=types.origins["ct"])
        if a.level != b.level:
            raise errors.NotSameLevelError(a=a.level, b=b.level)
        level = a.level
        nxt = level + 1
        if nxt >= self.num_levels:
            raise errors.MaximumLevelError(level=level,
                                           level_max=self.num_levels)
        pack = self.pack(nxt, -1)
        x0, x1, y0, y1 = self._rescale_words(
            torch.stack([*a.data, *b.data]), level, self.round_halves[level])
        ct_mult = DataStruct(_cc_mult_core(x0, x1, y0, y1, pack), False,
                             True, True, types.origins["ctt"], nxt, self.hash)
        return self.relinearize(ct_mult, evk) if relin else ct_mult

    # -- the batched mult -------------------------------------------------------

    def mult_batched(self, cts_a, cts_b, evk: DataStruct):
        """B independent ct x ct multiplies with relinearisation and rescale
        at one common level: a list of B ciphertexts. Where the fused
        tensor-core switch runs with the Shoup mod-down and rescale
        (``_batched_mult``) one batched program (``mult_stacked``): one
        B=4B rescale and enter+transform, one B=3B inverse, one switch
        dispatch of B ct segments; elsewhere a loop of ``cc_mult``, as the
        JAX engine loops where it has no ct-batched stages."""
        if len(cts_a) != len(cts_b) or not cts_a:
            raise errors.DifferentTypeError(a=len(cts_a), b=len(cts_b))
        if not self._batched_mult():
            return [self.cc_mult(a, b, evk) for a, b in zip(cts_a, cts_b)]
        level = cts_a[0].level
        for ct in (*cts_a, *cts_b):
            if ct.level != level:
                raise errors.NotMatchType(origin=f"level {ct.level}",
                                          to=f"level {level}")
        out = self.mult_stacked(self.stack_cts(cts_a), self.stack_cts(cts_b),
                                evk)
        return self.unstack_ct(out)

    def _batched_mult(self):
        """Whether every stage of ``cc_mult`` takes a ciphertext batch: the
        tensor-core domain with the fused switch and the Shoup mod-down and
        rescale (the JAX engine's ``mult_batched`` guard)."""
        return (self.use_mxu_ntt and self._mxu_fused()
                and self.use_shoup_moddown and self.use_shoup_rescale)

    def stack_cts(self, cts) -> DataStruct:
        """B same-level ciphertexts as one with [B, C, N] parts."""
        first = cts[0]
        return first._replace(data=tuple(
            torch.stack([c.data[i] for c in cts])
            for i in range(len(first.data))))

    def unstack_ct(self, ct: DataStruct):
        """A stacked ciphertext back into its B ciphertexts."""
        return [ct._replace(data=tuple(d[i] for d in ct.data))
                for i in range(ct.data[0].shape[0])]

    def mult_stacked(self, ct_a: DataStruct, ct_b: DataStruct,
                     evk: DataStruct) -> DataStruct:
        """The multiply of stacked ciphertexts (``stack_cts``). Where every
        stage of ``cc_mult`` takes the batch axis (``_batched_mult``) one
        call; elsewhere it unstacks, multiplies pair by pair and restacks
        (the JAX engine's ``mult_stacked`` has no such guard and gives
        wrong words where its stages are not batched)."""
        if self._batched_mult():
            return self.cc_mult(ct_a, ct_b, evk)
        return self.stack_cts([
            self.cc_mult(a, b, evk)
            for a, b in zip(self.unstack_ct(ct_a), self.unstack_ct(ct_b))])

    def level_up(self, ct: DataStruct, dst_level: int) -> DataStruct:
        if ct.origin != types.origins["ct"]:
            raise errors.NotMatchType(origin=ct.origin, to=types.origins["ct"])
        new_ct = self.rescale(ct)
        src_level = ct.level + 1
        if dst_level < src_level:
            raise errors.MaximumLevelError(level=dst_level,
                                           level_max=src_level)
        diff_deviation = (self.deviations[dst_level]
                          / np.sqrt(self.deviations[src_level]))
        deviated_delta = round(self.scale * diff_deviation)
        d = _scalar_mult_core(
            self._fit(torch.stack(new_ct.data), (src_level, -1),
                      (dst_level, -1)),
            self._scalar_to_mont(deviated_delta, dst_level),
            self.pack(dst_level, -1))
        return DataStruct((d[0], d[1]), False, False, False,
                          types.origins["ct"], dst_level, self.hash)

    def auto_level(self, ct0: DataStruct, ct1: DataStruct):
        if ct0.level < ct1.level:
            return self.level_up(ct0, ct1.level), ct1
        if ct0.level > ct1.level:
            return ct0, self.level_up(ct1, ct0.level)
        return ct0, ct1

    def auto_cc_mult(self, ct0, ct1, evk, relin=True):
        a, b = self.auto_level(ct0, ct1)
        return self.cc_mult(a, b, evk, relin=relin)

    def auto_cc_add(self, ct0, ct1):
        a, b = self.auto_level(ct0, ct1)
        return self.cc_add(a, b)

    def auto_cc_sub(self, ct0, ct1):
        a, b = self.auto_level(ct0, ct1)
        return self.cc_sub(a, b)

    # -- add / sub / negate -------------------------------------------------------

    def _cc_double(self, a: DataStruct, b: DataStruct, core) -> DataStruct:
        for ct in (a, b):
            if ct.ntt_state or ct.montgomery_state:
                raise errors.NotMatchDataStructState(origin=ct.origin)
        if a.level != b.level:
            raise errors.NotSameLevelError(a=a.level, b=b.level)
        c = core(a.data[:2], b.data[:2], self.pack(a.level, -1))
        return DataStruct(c, False, False, False, types.origins["ct"],
                          a.level, self.hash)

    def _cc_triplet(self, a: DataStruct, b: DataStruct, core) -> DataStruct:
        if a.level != b.level:
            raise errors.NotSameLevelError(a=a.level, b=b.level)
        c = core(a.data, b.data, self.pack(a.level, -1))
        return DataStruct(c, False, True, True, types.origins["ctt"],
                          a.level, self.hash)

    def cc_add_double(self, a: DataStruct, b: DataStruct) -> DataStruct:
        return self._cc_double(a, b, _add_core)

    def cc_add_triplet(self, a: DataStruct, b: DataStruct) -> DataStruct:
        return self._cc_triplet(a, b, _add_core)

    def cc_add(self, a: DataStruct, b: DataStruct) -> DataStruct:
        if a.origin == types.origins["ct"] and b.origin == types.origins["ct"]:
            return self.cc_add_double(a, b)
        if (a.origin == types.origins["ctt"]
                and b.origin == types.origins["ctt"]):
            return self.cc_add_triplet(a, b)
        raise errors.DifferentTypeError(a=a.origin, b=b.origin)

    def cc_sub_double(self, a: DataStruct, b: DataStruct) -> DataStruct:
        return self._cc_double(a, b, _sub_core)

    def cc_sub_triplet(self, a: DataStruct, b: DataStruct) -> DataStruct:
        return self._cc_triplet(a, b, _sub_core)

    def cc_sub(self, a: DataStruct, b: DataStruct) -> DataStruct:
        if a.origin != b.origin:
            raise errors.DifferentTypeError(a=a.origin, b=b.origin)
        if a.origin == types.origins["ct"]:
            return self.cc_sub_double(a, b)
        if a.origin == types.origins["ctt"]:
            return self.cc_sub_triplet(a, b)
        raise errors.NotMatchType(origin=a.origin, to="ct or ctt")

    cc_subtract = cc_sub

    def negate(self, ct: DataStruct) -> DataStruct:
        pack = self.pack(ct.level, -1)
        return ct._replace(data=tuple(_neg_core(d, pack) for d in ct.data))

    # -- scalar ops --------------------------------------------------------------

    def _scalar_to_mont(self, value: int, level: int):
        """value * R mod q_i over the level's ordinary channels."""
        return self._tensor([(value * self.ctx.R) % qi
                             for qi in self.ntt.q_rows(level, -1)])

    def _scalar_mult(self, ct: DataStruct, value: int) -> DataStruct:
        mont = self._scalar_to_mont(value, ct.level)
        pack = self.pack(ct.level, -1)
        return ct._replace(data=tuple(_scalar_mult_core(d, mont, pack)
                                      for d in ct.data))

    def mult_int_scalar(self, ct: DataStruct, scalar, evk=None, relin=True):
        if ct.origin != types.origins["ct"]:
            raise errors.NotMatchType(origin=ct.origin, to=types.origins["ct"])
        return self._scalar_mult(ct, int(scalar))

    def mult_scalar(self, ct: DataStruct, scalar, evk=None, relin=True):
        """ct * scalar: the scalar at the scale of the next level, then the
        rescale."""
        scaled = int(scalar * self.scale
                     * np.sqrt(self.deviations[ct.level + 1]) + 0.5)
        return self.rescale(self._scalar_mult(ct, scaled))

    def add_scalar(self, ct: DataStruct, scalar):
        scaled = int(scalar * self.scale * self.deviations[ct.level] + 0.5)
        if self.norm == "backward":
            scaled *= self.ctx.N
        scaled *= self.int_scale
        vals = self._dc(self._tensor([scaled % qi
                                      for qi in self.ntt.q_rows(ct.level,
                                                                -1)]))
        d0 = _add_dc_core(ct.data[0], vals, self.pack(ct.level, -1))
        return ct._replace(data=(d0,) + tuple(ct.data[1:]))

    def sub_scalar(self, ct: DataStruct, scalar):
        return self.add_scalar(ct, -scalar)

    def int_scalar_mult(self, scalar, ct, evk=None, relin=True):
        return self.mult_int_scalar(ct, scalar)

    def scalar_mult(self, scalar, ct, evk=None, relin=True):
        return self.mult_scalar(ct, scalar)

    def scalar_add(self, scalar, ct):
        return self.add_scalar(ct, scalar)

    def scalar_sub(self, scalar, ct):
        return self.add_scalar(self.negate(ct), scalar)

    # -- message ops -------------------------------------------------------------

    def mc_mult(self, m, ct: DataStruct, evk=None, relin=True):
        """ct * m: m encoded at the scale of the next level, the negacyclic
        product, then the rescale."""
        m = np.array(m) * np.sqrt(self.deviations[ct.level + 1])
        pt = self._cols(self.encode(m, 0))
        d0, d1 = _mc_mult_core(pt, ct.data[0], ct.data[1],
                               self.pack(ct.level, -1))
        return self.rescale(ct._replace(data=(d0, d1)))

    def mc_add(self, m, ct: DataStruct):
        pt = self._cols(self.encode(m, ct.level))
        d0 = _mc_add_core(pt, ct.data[0], self.pack(ct.level, -1))
        return ct._replace(data=(d0,) + tuple(ct.data[1:]))

    def mc_sub(self, m, ct: DataStruct):
        return self.mc_add(m, self.negate(ct))

    def cm_mult(self, ct, m, evk=None, relin=True):
        return self.mc_mult(m, ct)

    def cm_add(self, ct, m):
        return self.mc_add(m, ct)

    def cm_sub(self, ct, m):
        return self.mc_add(-np.array(m), ct)

    # -- rotations and conjugation ---------------------------------------------------

    def _perm(self, perm_key, perm_data):
        """The signed permutation of a Galois automorphism as a function of
        words [..., C, n]: its gather index (int64) and sign mask on the
        engine's device are kept for the engine's life. On a coef axis
        they are cut to this rank's columns, and the function gathers the
        words along ``coef`` first: output column j reads input column
        gather[j], which another shard may hold."""
        if perm_key not in self._perm_device_cache:
            gather, neg = perm_data
            self._perm_device_cache[perm_key] = tuple(
                self._cols(torch.from_numpy(t).to(self.torch_device))
                for t in (gather.astype(np.int64), neg))
        gather, neg = self._perm_device_cache[perm_key]

        def perm(x):
            if self.coef_shards > 1:
                x = comm.all_gather(x, self.mesh, "coef", dim=-1)
            return ops.apply_signed_perm(x, gather, neg)

        return perm

    def _rotated_sk(self, sk: DataStruct, perm_key, perm_data) -> DataStruct:
        rotated = _rotate_sk_core(self._sk_at(sk, 0),
                                  self._perm(perm_key, perm_data),
                                  self.pack(0, -1))
        return DataStruct(rotated, False, True, True, types.origins["sk"], 0,
                          self.hash)

    def create_rotation_key(self, sk: DataStruct, delta: int,
                            a=None) -> DataStruct:
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        perm = encdec.rotate_perm_data(self.ctx.N, delta)
        sk_rotated = self._rotated_sk(sk, ("rot", delta), perm)
        rotk = self.create_key_switching_key(sk_rotated, sk, a=a)
        return rotk._replace(origin=types.origins["rotk"] + f"{delta}")

    def create_conjugation_key(self, sk: DataStruct) -> DataStruct:
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        perm = encdec.conjugate_perm_data(self.ctx.N)
        sk_conj = self._rotated_sk(sk, ("conj",), perm)
        conjk = self.create_key_switching_key(sk_conj, sk)
        return conjk._replace(origin=types.origins["conjk"])

    def create_galois_key(self, sk: DataStruct) -> DataStruct:
        """The rotation keys of every delta in ``galois_deltas`` (2^i)."""
        parts = [self.create_rotation_key(sk, delta)
                 for delta in self.galois_deltas]
        return DataStruct(parts, True, True, True, types.origins["galk"], 0,
                          self.hash)

    def _permute_ct(self, ct: DataStruct, perm_key, perm_data) -> DataStruct:
        perm = self._perm(perm_key, perm_data)
        pack = self.pack(ct.level, -1)
        return ct._replace(data=tuple(_rotate_ct_core(d, perm, pack)
                                      for d in ct.data))

    def _rotate_switch(self, ct: DataStruct, rotk: DataStruct, perm_key,
                       perm_data) -> DataStruct:
        """The rotation of a plain-domain ciphertext: the signed
        permutation of both parts, the key switch of the second, the final
        add."""
        level = ct.level
        pack = self.pack(level, -1)
        r = _rotate_ct_core(torch.stack(ct.data[:2]),
                            self._perm(perm_key, perm_data), pack)
        s0, s1 = self._switch(r[1], rotk, level)
        c0 = ops.reduce_2q(ops.mont_add(r[0], s0, pack), pack)
        return DataStruct((c0, s1), ct.include_special, ct.ntt_state,
                          ct.montgomery_state, types.origins["ct"], level,
                          self.hash)

    def rotate_single(self, ct: DataStruct, rotk: DataStruct) -> DataStruct:
        """Rotate the slots by the delta of ``rotk``'s origin (the part
        after its last ':'): slot i moves to i + delta, as np.roll."""
        if types.origins["rotk"] not in rotk.origin:
            raise errors.NotMatchType(origin=rotk.origin,
                                      to=types.origins["rotk"])
        delta = int(rotk.origin.split(":")[-1])
        perm = encdec.rotate_perm_data(self.ctx.N, delta)
        if ct.ntt_state or ct.montgomery_state:
            rotated = self._permute_ct(ct, ("rot", delta), perm)
            return self.switch_key(rotated, rotk)
        return self._rotate_switch(ct, rotk, ("rot", delta), perm)

    def rotate_galois(self, ct: DataStruct, gk: DataStruct, delta: int,
                      return_circuit=False):
        """Rotate by any delta as a chain of the Galois key's power-of-two
        rotations (the largest first)."""
        if gk.origin != types.origins["galk"]:
            raise errors.NotMatchType(origin=gk.origin,
                                      to=types.origins["galk"])
        current_delta = delta % self.num_slots
        circuit = []
        while current_delta:
            ind = int(math.log2(current_delta))
            circuit.append(ind)
            current_delta -= self.galois_deltas[ind]
        rotated = ct
        for ind in circuit:
            rotated = self.rotate_single(rotated, gk.data[ind])
        return (rotated, circuit) if return_circuit else rotated

    def conjugate(self, ct: DataStruct, conjk: DataStruct) -> DataStruct:
        perm = encdec.conjugate_perm_data(self.ctx.N)
        if ct.ntt_state or ct.montgomery_state:
            conj = self._permute_ct(ct, ("conj",), perm)
            return self.switch_key(conj, conjk)
        return self._rotate_switch(ct, conjk, ("conj",), perm)

    # -- statistics ------------------------------------------------------------------

    def sum(self, ct: DataStruct, gk: DataStruct) -> DataStruct:
        """Every slot holds the sum of all slots."""
        new_ct = ct
        for roti in range(self.ctx.logN - 1):
            rot_ct = self.rotate_single(new_ct, gk.data[roti])
            new_ct = self.add(rot_ct, new_ct)
        return new_ct

    def mean(self, ct: DataStruct, gk: DataStruct, alpha=1) -> DataStruct:
        new_ct = self.mult(1 / self.num_slots / alpha, ct)
        for roti in range(self.ctx.logN - 1):
            rot_ct = self.rotate_single(new_ct, gk.data[roti])
            new_ct = self.add(rot_ct, new_ct)
        return new_ct

    def cov(self, ct_a: DataStruct, ct_b: DataStruct,
            evk: DataStruct, gk: DataStruct) -> DataStruct:
        cta_dev = self.sub(ct_a, self.mean(ct_a, gk))
        ctb_dev = self.sub(ct_b, self.mean(ct_b, gk))
        return self.mult(self.mult(cta_dev, ctb_dev, evk),
                         1 / (self.num_slots - 1))

    def pow(self, ct: DataStruct, power: int, evk: DataStruct) -> DataStruct:
        """ct^power by repeated squaring, then the products of the powers
        of two that make up the rest."""
        current_exponent = 2
        pow_list = [ct]
        while current_exponent <= power:
            pow_list.append(self.cc_mult(pow_list[-1], pow_list[-1], evk))
            current_exponent *= 2
        remaining = power - current_exponent // 2
        new_ct = pow_list[-1]
        while remaining > 0:
            ind = math.floor(math.log2(remaining))
            new_ct = self.auto_cc_mult(new_ct, pow_list[ind], evk)
            remaining -= 2 ** ind
        return new_ct

    def sqrt(self, ct: DataStruct, evk: DataStruct, e=0.0001,
             alpha=0.0001) -> DataStruct:
        """Wilkes' iteration for the square root of slots in (0, 1]: runs
        while e <= 1 - alpha (the step's constants from np.roots)."""
        a = ct
        b = ct
        while e <= 1 - alpha:
            k = float(np.roots([1 - e ** 3, -6 + 6 * e ** 2, 9 - 9 * e])[1])
            t = self.mult_scalar(a, k)
            b0 = self.sub_scalar(t, 3)
            b1 = self.mult_scalar(b, (k ** 0.5) / 2)
            b = self.cc_mult(b0, b1, evk)

            a0 = self.mult_scalar(a, (k ** 3) / 4)
            t = self.sub_scalar(a, 3 / k)
            a1 = self.square(t, evk)
            a = self.cc_mult(a0, a1, evk)
            e = k * (3 - k) ** 2 / 4
        return b

    def var(self, ct: DataStruct, evk: DataStruct, gk: DataStruct,
            relin=False) -> DataStruct:
        dev = self.sub(ct, self.mean(ct, gk))
        dev = self.square(dev, evk, relin=relin)
        if not relin:
            dev = self.relinearize(dev, evk)
        return self.mean(dev, gk)

    def std(self, ct: DataStruct, evk: DataStruct, gk: DataStruct,
            relin=False) -> DataStruct:
        return self.sqrt(self.var(ct, evk, gk, relin=relin), evk)

    def reduce_error(self, ct):
        return self.mult_scalar(ct, 1.0)

    # -- multiparty (threshold) FHE --------------------------------------------------

    def multiparty_public_crs(self, pk: DataStruct):
        return pk.data[1]

    def multiparty_create_public_key(self, sk: DataStruct, a=None,
                                     include_special=False) -> DataStruct:
        return self.create_public_key(sk, include_special=include_special,
                                      a=a)

    def multiparty_create_collective_public_key(self,
                                                pks: list) -> DataStruct:
        """The parties' pk0 summed over the common CRS."""
        pack = self.pack(0, -2 if pks[0].include_special else -1)
        b = pks[0].data[0]
        for pk in pks[1:]:
            b = ops.mont_add(b, pk.data[0], pack)
        return pks[0]._replace(data=(b, pks[0].data[1]),
                               origin=types.origins["pk"])

    def multiparty_decrypt_head(self, ct: DataStruct, sk: DataStruct):
        """ct0 + a*sk_0 of the first party, lazy [0, 2q)."""
        return _mp_decrypt_head(ct.data[0], ct.data[1],
                                self._sk_at(sk, ct.level),
                                self.pack(ct.level, -1))

    def multiparty_decrypt_partial(self, ct: DataStruct, sk: DataStruct):
        """a*sk_i of every other party, lazy [0, 2q)."""
        return _mp_decrypt_partial(ct.data[1], self._sk_at(sk, ct.level),
                                   self.pack(ct.level, -1))

    def multiparty_decrypt_fusion(self, pcts: list, level=0,
                                  include_special=False):
        """The head and partial decryptions summed and decoded."""
        pack = self.pack(level, -1)
        pt = pcts[0]
        for pct in pcts[1:]:
            pt = ops.mont_add(pt, pct, pack)
        scaled = self._final_rescale_signed(
            self._gather_full(ops.reduce_2q(pt, pack), level, -1), level)
        return self.decode(scaled, level=level)

    def multiparty_create_key_switching_key(self, sk_src: DataStruct,
                                            sk_dst: DataStruct,
                                            a=None) -> DataStruct:
        return self.create_key_switching_key(sk_src, sk_dst, a=a)

    def multiparty_create_rotation_key(self, sk: DataStruct, delta: int,
                                       a=None) -> DataStruct:
        return self.create_rotation_key(sk, delta, a=a)

    def _sum_ksk_pk0(self, ksks: list) -> DataStruct:
        """The key-switching-key shares with their pk0 halves summed."""
        pack = self.pack(0, -2)
        out_parts = []
        for i, part in enumerate(ksks[0].data):
            pk0 = part.data[0]
            for other in ksks[1:]:
                pk0 = ops.mont_add(pk0, other.data[i].data[0], pack)
            out_parts.append(part._replace(data=(pk0, part.data[1])))
        return ksks[0]._replace(data=out_parts)

    def multiparty_generate_rotation_key(self, rotks: list) -> DataStruct:
        return self._sum_ksk_pk0(rotks)

    def generate_rotation_crs(self, rotk: DataStruct):
        if (types.origins["rotk"] not in rotk.origin
                and types.origins["ksk"] != rotk.origin):
            raise errors.NotMatchType(origin=rotk.origin,
                                      to=types.origins["ksk"])
        return [ksk.data[1] for ksk in rotk.data]

    def generate_galois_crs(self, galk: DataStruct):
        if galk.origin != types.origins["galk"]:
            raise errors.NotMatchType(origin=galk.origin,
                                      to=types.origins["galk"])
        return [[ksk.data[1] for ksk in rotk.data] for rotk in galk.data]

    def multiparty_create_galois_key(self, sk: DataStruct,
                                     a: list) -> DataStruct:
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        parts = [self.multiparty_create_rotation_key(sk, delta, a=a[i])
                 for i, delta in enumerate(self.galois_deltas)]
        return DataStruct(parts, True, True, True, types.origins["galk"], 0,
                          self.hash)

    def multiparty_generate_galois_key(self, galks: list) -> DataStruct:
        return galks[0]._replace(data=[
            self._sum_ksk_pk0([g.data[i] for g in galks])
            for i in range(len(galks[0].data))])

    def multiparty_sum_evk_share(self, evks_share: list) -> DataStruct:
        return self._sum_ksk_pk0(evks_share)

    def multiparty_mult_evk_share_sum(self, evk_sum: DataStruct,
                                      sk: DataStruct) -> DataStruct:
        """Both halves of every part times the party's secret share, over
        the special primes too."""
        if sk.origin != types.origins["sk"]:
            raise errors.NotMatchType(origin=sk.origin, to=types.origins["sk"])
        if not sk.include_special:
            raise errors.SecretKeyNotIncludeSpecialPrime()
        pack = self.pack(0, -2)
        return evk_sum._replace(data=[
            part._replace(data=tuple(ops.mont_mult(d, sk.data, pack)
                                     for d in part.data))
            for part in evk_sum.data])

    def multiparty_sum_evk_share_mult(self,
                                      evk_sum_mult: list) -> DataStruct:
        pack = self.pack(0, -2)
        out_parts = []
        for i, part in enumerate(evk_sum_mult[0].data):
            b, a = part.data
            for other in evk_sum_mult[1:]:
                b = ops.mont_add(b, other.data[i].data[0], pack)
                a = ops.mont_add(a, other.data[i].data[1], pack)
            out_parts.append(part._replace(data=(b, a)))
        return evk_sum_mult[0]._replace(data=out_parts)

    # -- data management -------------------------------------------------------------

    def _map(self, text, fn):
        """A copy of the DataStruct tree with fn applied to every tensor."""
        if isinstance(text, DataStruct):
            return text._replace(data=self._map(text.data, fn))
        if isinstance(text, (tuple, list)):
            return type(text)(self._map(d, fn) for d in text)
        return fn(text)

    def gather(self, text: DataStruct) -> DataStruct:
        """The single-device engine's words of ``text``: on a mesh every
        rank's rows and columns gathered to full width (on every rank);
        else ``text`` itself. ``parallel.shard_datastruct`` is the
        inverse."""
        if self.mesh is None:
            return text
        lay = (text.level, -2 if text.include_special else -1)

        def full(d):
            if isinstance(d, DataStruct):
                return self.gather(d)
            if isinstance(d, (tuple, list)):
                return type(d)(full(x) for x in d)
            return self._gather_full(d, *lay)

        return text._replace(data=full(text.data))

    def clone(self, text: DataStruct) -> DataStruct:
        """A copy that shares no tensor with ``text`` (the port writes some
        tensors in place)."""
        return self._map(text, torch.clone)

    def cpu(self, text: DataStruct) -> DataStruct:
        return self._map(text, lambda t: t.to("cpu"))

    def device_put(self, text: DataStruct) -> DataStruct:
        """``text`` with every tensor on the engine's device."""
        return self._map(text, lambda t: t.to(self.torch_device))

    cuda = device_put

    def move_to(self, text: DataStruct, direction="gpu2cpu") -> DataStruct:
        """'gpu2cpu': to the CPU; 'cpu2gpu': to the engine's device."""
        if direction == "gpu2cpu":
            return self.cpu(text)
        if direction == "cpu2gpu":
            return self.device_put(text)
        raise ValueError(f"unknown direction {direction!r}")

    def device(self, text: DataStruct) -> str:
        """'cpu' or 'cuda': where the first tensor of ``text`` lies."""
        x = text
        while not isinstance(x, torch.Tensor):
            x = x.data if isinstance(x, DataStruct) else x[0]
        return x.device.type

    def save(self, text: DataStruct, filename=None):
        """Pickle a CPU copy of ``text``; returns the file name."""
        if filename is None:
            filename = (datetime.datetime.now().strftime("%Y%m%d%H%M%S%f")
                        + ".pkl")
        with Path(filename).open("wb") as f:
            pickle.dump(self.cpu(text), f)
        return filename

    def load(self, filename, move_to_device=True):
        """A saved DataStruct of an engine of the same parameters (else
        ``HashMismatchError``), on the engine's device or on the CPU."""
        with Path(filename).open("rb") as f:
            text = pickle.load(f)
        if text.hash and text.hash != self.hash:
            raise errors.HashMismatchError()
        return self.device_put(text) if move_to_device else text

    def print_data_structure(self, text, level=0):
        indent = "  " * level
        if isinstance(text, DataStruct):
            print(f"{indent}{text.origin} (level={text.level})")
            data = text.data
            if (isinstance(data, (list, tuple)) and data
                    and isinstance(data[0], DataStruct)):
                for d in data:
                    self.print_data_structure(d, level + 1)
            else:
                for d in (data if isinstance(data, (list, tuple)) else [data]):
                    print(f"{indent}  tensor {tuple(d.shape)}")

    def refresh(self, seed=None):
        self.rng.refresh(seed)

    def profile(self, log_dir: str):
        """A context manager tracing the calls inside it with
        ``torch.profiler`` (the host, and the card's kernels on a CUDA
        engine); the trace is written to ``log_dir`` as it closes::

            with engine.profile("fhe-trace"):
                engine.mult(ct1, ct2, evk)
        """
        from torch.profiler import ProfilerActivity, profile, \
            tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.torch_device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(str(log_dir)))

    # -- dispatchers -----------------------------------------------------------------

    def _dispatch(self, table, a, b):
        name = table.get((type(a), type(b)))
        if name is None:
            raise errors.DifferentTypeError(a=type(a).__name__,
                                            b=type(b).__name__)
        return getattr(self, name)

    def mult(self, a, b, evk=None, relin=True):
        return self._dispatch(self.mult_dispatch, a, b)(a, b, evk, relin)

    def add(self, a, b):
        return self._dispatch(self.add_dispatch, a, b)(a, b)

    def sub(self, a, b):
        return self._dispatch(self.sub_dispatch, a, b)(a, b)


# Reference-compatible alias.
ckks_engine = CkksEngine
