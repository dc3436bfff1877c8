"""Polynomial modular ops on int64 words [..., C, N].

Pointwise ops take the per-channel constants of a ``LevelPack`` and
broadcast them over the channel axis (-2). The transforms dispatch to the
kernel wrappers of ``cuda_ntt`` (butterfly) or ``cuda_mxu`` (tensor-core):
the CUDA kernel for a CUDA tensor, its plain twin for a CPU tensor. The
butterfly kernels use Shoup-form (plain) twiddles, so they return the same
values mod q as the Montgomery-twiddle chains, with other [0, 2q)
representatives.

Every compare keeps the signedness the reference uses: ``reduce_2q``,
``make_signed``, ``canon_2q`` and the conditional subtracts compare signed.
"""

import torch

from . import cuda_mxu, cuda_ntt, u64

__all__ = [
    "mont_mult", "mont_enter", "mont_enter_scale", "mont_enter_scalar",
    "mont_redc", "mont_add", "mont_sub", "neg", "reduce_2q", "canon_2q",
    "make_signed", "make_unsigned", "tile_unsigned", "apply_signed_perm",
    "fit_channels", "ntt", "intt", "enter_ntt", "intt_exit",
    "intt_exit_reduce", "intt_reduce", "intt_no_norm",
]


def _col(t):
    """[C] -> [C, 1], broadcasting over the coefficient axis."""
    return t[:, None]


def _cond_sub(v, m):
    return torch.where(v < m, v, v - m)


# -- pointwise Montgomery ops ----------------------------------------------------


def mont_mult(a, b, pack):
    """a*b*R^-1 mod q; ``a`` may be wrapped-negative (signed semantics)."""
    return u64.montmul(a, b, *pack.mont())


def mont_enter(a, pack):
    """Enter Montgomery form: multiply by R^2 (-> a*R mod q)."""
    return mont_mult(a, _col(pack.Rs), pack)


def mont_enter_scale(a, pack):
    """Multiply by scale*R (the encode-side scaling, into Montgomery
    form)."""
    return mont_mult(a, _col(pack.Rs_scale), pack)


def mont_enter_scalar(a, scalar, pack):
    """Multiply by a per-channel Montgomery-form scalar [C]."""
    return mont_mult(a, _col(scalar), pack)


def mont_redc(a, pack):
    return u64.montredc(a, *pack.mont())


def mont_add(a, b, pack):
    return _cond_sub(a + b, _col(pack.q2))


def mont_sub(a, b, pack):
    q2 = _col(pack.q2)
    return _cond_sub(a + q2 - b, q2)


def neg(a, pack):
    """-a mod q kept in [0, 2q): 2q - a, conditionally reduced."""
    q2 = _col(pack.q2)
    return _cond_sub(q2 - a, q2)


def reduce_2q(a, pack):
    """[0, 2q) -> [0, q)."""
    return _cond_sub(a, _col(pack.q))


def canon_2q(a, pack):
    """Repair two's-complement negatives in (-2q, 0) to [0, 2q)."""
    return torch.where(a < 0, a + _col(pack.q2), a)


def make_signed(a, pack):
    """[0, q) -> centred representative in (-q/2, q/2]."""
    q = _col(pack.q)
    return torch.where(a <= q >> 1, a, a - q)


def make_unsigned(a, pack):
    return a + _col(pack.q)


def tile_unsigned(a, pack):
    """Broadcast a signed [N] or [1, N] poly to [C, N]: a + q per channel."""
    return a.reshape(1, -1) + _col(pack.q)


def apply_signed_perm(a, gather, neg_mask):
    """Signed coefficient permutation out[..., j] = (-1)^neg_mask[j] *
    a[..., gather[j]] (the Galois automorphism on negacyclic polynomials).
    The negation is two's complement; the caller repairs the sign
    (``make_unsigned`` or ``canon_2q``). gather: int64 [N] on a's
    device."""
    g = a.index_select(-1, gather)
    return torch.where(neg_mask, -g, g)


def fit_channels(d, W):
    """Slice or zero-pad the channel axis (-2) to width ``W``."""
    C = d.shape[-2]
    if C >= W:
        return d[..., :W, :]
    pad = torch.zeros(d.shape[:-2] + (W - C, d.shape[-1]), dtype=d.dtype,
                      device=d.device)
    return torch.cat([d, pad], dim=-2)


# -- transforms -------------------------------------------------------------------
#
# A pack carries the tables of one domain: ``plan`` for the butterfly
# kernels (bit-reversed NTT domain) or ``mxu`` for the tensor-core kernels
# (natural order), as the JAX package's ops route by pack.pallas /
# pack.mxu. The domains never mix: a pack without tables raises.


def _plan(pack):
    if pack.plan is None:
        raise ValueError("this pack carries no transform tables")
    return pack.plan


def ntt(a, pack):
    """Forward negacyclic NTT (butterfly: natural-order input, bit-reversed
    output; tensor-core: natural order), preserving the Montgomery
    domain."""
    if pack.mxu is not None:
        return cuda_mxu.dispatch(a, pack.mxu)
    return cuda_ntt.ntt_fwd(a, _plan(pack))


def enter_ntt(a, pack):
    """Montgomery enter (x R) fused with the forward NTT."""
    if pack.mxu is not None:
        return cuda_mxu.dispatch(a, pack.mxu, enter=True)
    return cuda_ntt.ntt_fwd(a, _plan(pack), pre_enter=True)


def intt(a, pack):
    """Inverse NTT with the N^-1 normalisation."""
    if pack.mxu is not None:
        return cuda_mxu.dispatch(a, pack.mxu, inverse=True)
    return cuda_ntt.ntt_inv(a, _plan(pack))


def intt_exit(a, pack):
    """Inverse NTT fused with the Montgomery exit (x R^-1)."""
    if pack.mxu is not None:
        return cuda_mxu.dispatch(a, pack.mxu, inverse=True, exitx=True)
    return cuda_ntt.ntt_inv(a, _plan(pack), post_exit=True)


def intt_exit_reduce(a, pack):
    if pack.mxu is not None:
        return cuda_mxu.dispatch(a, pack.mxu, inverse=True, exitx=True,
                                 post_reduce=True)
    return cuda_ntt.ntt_inv(a, _plan(pack), post_exit=True, post_reduce=True)


def intt_no_norm(a, pack):
    """Inverse NTT without the N^-1 normalisation (lazy [0, 2q) words; the
    coefficient-sharded inverse normalises after its cross-shard stages).
    Butterfly domain only."""
    return cuda_ntt.ntt_inv(a, _plan(pack), no_norm=True)


def intt_reduce(a, pack):
    """Inverse NTT + N^-1 + reduce to [0, q), with NO Montgomery exit (the
    Shoup-form key switch: its products are already plain)."""
    if pack.mxu is not None:
        return cuda_mxu.dispatch(a, pack.mxu, inverse=True, post_reduce=True)
    return cuda_ntt.ntt_inv(a, _plan(pack), post_reduce=True)
