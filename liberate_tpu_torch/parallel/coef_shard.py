"""Coefficient-sharded forward and inverse negacyclic NTT.

The coefficient axis of N words is cut into S = 2^k shards of L = N / S, and
rank i of the ``coef`` axis holds words [i L, (i + 1) L) of every channel.
In the butterfly network (twiddle of stage s and block b at bank entry
2^s + b):

1. the first k forward stages (the last k inverse ones) pair shard i with
   shard i XOR 2^(k-1-s): one ``comm.exchange`` a stage, and every word of
   the shard takes the one twiddle bank[2^s + (i >> (k - s))], a scalar per
   (channel, shard);
2. the other logN - k stages are shard-local: a length-L transform whose
   block bl of local stage sl is global block i 2^sl + bl, so it runs on
   the per-shard bank local[2^sl + bl] = bank[2^sl (2^k + i) + bl] as it
   is: the butterfly kernels (#1, and #2 in its no-normalise mode) on one
   ``cuda_ntt.make_plan`` a shard. On the card logL must be in the
   kernels' range (8-17): a plan for CUDA tensors with a shorter shard is
   refused; the wrappers take their plain twins for CPU tensors only;
3. the inverse multiplies by the global N^-1 (N^-1 R^-1 with the
   Montgomery exit) after its cross-shard stages, then reduces if asked;
   with ``no_norm`` it stops after them (lazy [0, 2q) words).

The plan takes the twiddle form of the context's master plan: Shoup-form
twiddles, or Montgomery-form ones (``use_shoup_twiddles`` off: the cross
stages multiply by Montgomery products, the local kernels run their
Montgomery mode, the entry multiplies by R^2 and the inverse normalises
by N^-1 R, then reduces out of Montgomery form for the exit).
A cross stage is the single-device twin's stage on the same words (the
twiddle product, the lazy [0, 2q) conditional subtracts), so the results
are the single-device transforms' words (``ops.ntt``, ``enter_ntt``, ``intt``,
``intt_exit``, ``intt_exit_reduce``, ``intt_reduce``, ``intt_no_norm``).
Batch axes before [C, L] pass through.
On a 2-D (``rns``, ``coef``) mesh each rank also holds only its rows of the
channels (``rns_axis``); channels are independent, so that adds no
communication.
"""

import numpy as np
import torch

from ..ntt import cuda_ntt, u64
from ..ntt.cuda_ntt import make_plan
from . import comm

__all__ = ["CoefShardPlan", "make_coef_plan", "ntt_coef_sharded",
           "intt_coef_sharded"]


class CoefShardPlan:
    """One rank's tables for the coefficient-sharded transforms.

    local: the shard's NttPlan at logL (rearranged banks); cross_f,
    cross_i: the cross stages' twiddles, pairs of [k, C] tensors (the
    twiddles and their Shoup quotients, None for Montgomery twiddles);
    q, enter, ninv, ninv_exit: the channels' modulus and the global
    constants of the entry and of the normalisation, as in an NttPlan
    (whose form ``mont`` and Montgomery constants ``cons`` it keeps).
    """

    __slots__ = ("mesh", "axis", "S", "index", "logN", "channels", "local",
                 "cross_f", "cross_i", "q", "enter", "ninv", "ninv_exit",
                 "mont", "cons")

    def __init__(self, mesh, axis, logN, channels, local, cross_f, cross_i,
                 master):
        self.mesh, self.axis = mesh, axis
        self.S = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.logN = logN
        self.channels = channels
        self.local = local
        self.cross_f, self.cross_i = cross_f, cross_i
        self.q = master.q
        self.enter, self.ninv = master.enter, master.ninv
        self.ninv_exit = master.ninv_exit
        self.mont = master.mont
        self.cons = [t[:, None] for t in cuda_ntt._montmul_consts(master)]


def _rearranged_index(logN, S, i):
    """Global bank entries of shard i's local bank: entry 2^sl + bl holds
    the global entry 2^sl (S + i) + bl (entry 0 is unused)."""
    L = (1 << logN) // S
    idx = np.zeros(L, dtype=np.int64)
    for sl in range(L.bit_length() - 1):
        m = 1 << sl
        idx[m:2 * m] = m * (S + i) + np.arange(m)
    return idx


def _cross_index(S, i):
    """Bank entry of shard i's twiddle at cross stage s < k = log2 S."""
    k = S.bit_length() - 1
    return [(1 << s) + (i >> (k - s)) for s in range(k)]


def make_coef_plan(ntt_ctx, mesh, axis="coef", level=0, mult_type=-2,
                   rns_axis=None, idx=None) -> CoefShardPlan:
    """This rank's plan from a butterfly-domain NttContext's master banks,
    for the channels of (level, mult_type), or the global channel indices
    ``idx``. ``rns_axis``: also shard the channels over that mesh axis (the
    2-D layout); their count must divide by its size."""
    master = ntt_ctx._master.plan
    if master is None:
        raise ValueError("the coefficient-sharded transforms run in the "
                         "butterfly domain (a context without use_mxu)")
    S = mesh.axis_size(axis)
    if S < 2 or S & (S - 1) or S > ntt_ctx.ctx.N:
        raise ValueError(f"{S} coefficient shards: a power of two from 2")
    if idx is None:
        idx = range(*ntt_ctx.channel_range(level, mult_type))
    idx = list(idx)
    if rns_axis is not None:
        n = mesh.axis_size(rns_axis)
        if len(idx) % n:
            raise ValueError(f"channel count {len(idx)} not divisible by "
                             f"mesh axis '{rns_axis}' ({n}); pad channels "
                             f"first")
        w, r = len(idx) // n, mesh.axis_index(rns_axis)
        idx = idx[r * w:(r + 1) * w]
    dev = master.q.device
    logL = ntt_ctx.logN - (S.bit_length() - 1)
    if dev.type == "cuda" and logL < cuda_ntt.MIN_LOGN:
        raise ValueError(f"{S} coefficient shards leave shards of 2^{logL} "
                         f"words; the transform kernels take logN "
                         f"{cuda_ntt.MIN_LOGN}-{cuda_ntt.MAX_LOGN}")
    m = master.select(torch.tensor(idx, device=dev))
    i = mesh.axis_index(axis)
    logN = ntt_ctx.logN
    loc = torch.from_numpy(_rearranged_index(logN, S, i)).to(dev)
    w, iw = m.w.index_select(1, loc), m.iw.index_select(1, loc)
    if m.mont:
        # The rearranged Montgomery banks as they are (make_plan would
        # enter them again); the local transforms use no entry or
        # normalisation of their own.
        local = cuda_ntt.NttPlan(logL, m.q, m.k, w.contiguous(), None,
                                 iw.contiguous(), None, m.enter, m.ninv,
                                 None, m.ident, mont=True)
    else:
        local = make_plan(logL, [ntt_ctx.ctx.q[j] for j in idx],
                          [ntt_ctx.ctx.k[j] for j in idx], w, iw, dev)
    cross = torch.tensor(_cross_index(S, i), device=dev, dtype=torch.int64)

    def scalars(w, wp):
        return (w.index_select(1, cross).T.contiguous(),
                None if wp is None else
                wp.index_select(1, cross).T.contiguous())

    return CoefShardPlan(mesh, axis, logN, idx, local, scalars(m.w, m.wp),
                         scalars(m.iw, m.iwp), m)


def _cond_sub(v, m):
    return torch.where(v < m, v, v - m)


def _col(t):
    return t[:, None]


def _mul(x, w, wp, plan):
    """x times the per-channel constants w [C] in the plan's form: a Shoup
    product with the quotients wp, or a Montgomery product."""
    if plan.mont:
        return u64.montmul(x, _col(w), *plan.cons)
    return u64.shoup_mul(x, _col(w), _col(wp), _col(plan.q))


def ntt_coef_sharded(a, plan: CoefShardPlan, pre_enter=False):
    """Forward NTT of this rank's shard a [..., C, L] (natural order in,
    bit-reversed out, as ``ops.ntt``); ``pre_enter`` first enters
    Montgomery form (``ops.enter_ntt``)."""
    q2 = 2 * _col(plan.q)
    x = a
    if pre_enter:
        x = _mul(x, plan.enter[0], None if plan.mont else plan.enter[1],
                 plan)
    k = plan.S.bit_length() - 1
    wps = plan.cross_f[1]
    for s in range(k):
        d = 1 << (k - 1 - s)
        other = comm.exchange(x, plan.index ^ d, plan.mesh, plan.axis)
        w, wp = plan.cross_f[0][s], None if wps is None else wps[s]
        if plan.index & d:           # this shard holds the odd outputs
            x = _cond_sub(other + q2 - _mul(x, w, wp, plan), q2)
        else:
            x = _cond_sub(x + _mul(other, w, wp, plan), q2)
    return cuda_ntt.ntt_fwd(x, plan.local)


def intt_coef_sharded(a, plan: CoefShardPlan, post_exit=False,
                      post_reduce=False, no_norm=False):
    """Inverse NTT of this rank's shard a [..., C, L] with the global N^-1
    normalisation (``ops.intt``); ``post_exit`` fuses the Montgomery exit
    (``ops.intt_exit``), ``post_reduce`` the reduce to [0, q)
    (``ops.intt_reduce``; ``ops.intt_exit_reduce`` with both); ``no_norm``
    none of them (``ops.intt_no_norm``)."""
    cuda_ntt._check_no_norm(no_norm, post_exit, post_reduce)
    x = cuda_ntt.ntt_inv(a, plan.local, no_norm=True)
    q = _col(plan.q)
    q2 = 2 * q
    k = plan.S.bit_length() - 1
    wps = plan.cross_i[1]
    for s in reversed(range(k)):
        d = 1 << (k - 1 - s)
        other = comm.exchange(x, plan.index ^ d, plan.mesh, plan.axis)
        w, wp = plan.cross_i[0][s], None if wps is None else wps[s]
        if plan.index & d:
            x = _mul(_cond_sub(other + q2 - x, q2), w, wp, plan)
        else:
            x = _cond_sub(x + other, q2)
    if no_norm:
        return x
    if plan.mont:
        x = _mul(x, plan.ninv[0], None, plan)
        if post_exit:
            x = u64.montredc(x, *plan.cons)
    else:
        x = _mul(x, *(plan.ninv_exit if post_exit else plan.ninv), plan)
    return _cond_sub(x, q) if post_reduce else x
