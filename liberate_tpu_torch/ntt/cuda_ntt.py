"""The butterfly kernels: CUDA wrappers, their plain PyTorch twins and
their launch counters.

Four kernels (sources in ``liberate_tpu_torch/csrc``):

- ``ntt_fwd``: forward negacyclic NTT over [..., C, N], optionally entering
  Montgomery form first (``pre_enter``) or with the canon pre-stage
  (``pre_canon``: wrapped-negative words to [0, 2q) through a signed
  Montgomery product by R mod q, the JAX kernel's ``pre_canon``), and
  reducing to [0, q) last (replaces ``pallas_ntt._ntt_kernel``);
- ``ntt_inv``: the inverse NTT with the N^-1 normalisation (and the
  Montgomery exit with ``post_exit``) and the optional reduce folded in,
  or with ``no_norm`` none of them (replaces ``pallas_ntt._intt_kernel``
  and its ``no_norm`` mode; counted as ``ntt_inv_no_norm``);
- ``ksk_mulacc``: the key-switch products with both key halves, summed
  over the gadget parts (replaces ``pallas_ntt._ksk_mulacc_kernel``);
- ``ntt_mulacc``: the forward NTT of every gadget part and ``ksk_mulacc``
  in one kernel, the unsplit switch core (replaces
  ``pallas_ntt._ntt_mulacc_kernel``; with ``canon`` its canon pre-stage,
  for the Montgomery basis extension's signed words). It runs
  ``ntt_fwd``'s cluster transform with the key products as its epilogue,
  the parts in G groups of clusters (``mulacc_geometry``).

The transforms take the twiddle form of their plan (``NttPlan.mont``):
Shoup-form plain twiddles (the JAX package's ``use_shoup_twiddles``, its
TPU default) or Montgomery-form twiddles, whose butterflies and entry and
normalisation multiplies are the reference's Montgomery chain (the JAX
package's CPU transforms and ``golden.ntt``, bit for bit). The two give
the same values mod q, with other [0, 2q) representatives.

A wrapper launches its kernel for a CUDA tensor and runs its plain twin
only for a CPU tensor; it raises for anything else. Each twin repeats the
kernel's arithmetic step for step, so both give the same words. Every
launch adds one to its counter: ``launches[name]`` in the default modes,
``mode_launches[label]`` in the reference-parity ones, the label the
kernel's name, then ``_mont`` on a Montgomery-twiddle plan and ``_canon``
with the canon pre-stage (``launch_label``).

``ntt_fwd`` and ``ntt_inv`` run one thread-block cluster per (b, c)
channel, its CTAs holding the channel in their shared memory;
``bfly_geometry`` models that launch.
"""

import ctypes

import torch

from .. import _build
from . import u64

def launch_label(name, mont=False, canon=False):
    """The launch counter of a kernel mode: ``name`` (ntt_fwd, ntt_inv,
    ntt_inv_no_norm, ntt_mulacc), ``_mont`` with Montgomery twiddles,
    ``_canon`` with the canon pre-stage."""
    return name + ("_mont" if mont else "") + ("_canon" if canon else "")


launches = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_inv_no_norm": 0,
            "ksk_mulacc": 0, "ntt_mulacc": 0}
mode_launches = {launch_label(n, m, c): 0
                 for n, canons in (("ntt_fwd", (False, True)),
                                   ("ntt_inv", (False,)),
                                   ("ntt_inv_no_norm", (False,)),
                                   ("ntt_mulacc", (False, True)))
                 for m in (False, True) for c in canons if m or c}


def _count(label):
    (launches if label in launches else mode_launches)[label] += 1


# The butterfly transforms' launch (csrc/ntt.cu): a cluster of K CTAs per
# channel, CTA k holding the chunk k of M = N / K words: M at most
# 2^LOG_CHUNK, and K = 2^MAX_LOGK (8, the portable cluster limit) from
# FULL_CLUSTER_LOGN on; logN from MIN_LOGN to MAX_LOGN.
LOG_CHUNK = 14
MAX_LOGK = 3
FULL_CLUSTER_LOGN = 16
MAX_COLUMN = 8
PASS = 4
MIN_LOGN, MAX_LOGN = 8, 17
TEAM_THREADS = 128


def bfly_geometry(logN, K=None):
    """The launch of one butterfly transform at logN, as csrc/ntt.cu
    computes it (its ``ltt_ntt_geometry``), or with K CTAs per cluster
    forced (a model only).

    Returns K, logM (log2 of a CTA's chunk), threads per CTA (one per 32
    words), smem (bytes of shared memory per CTA), fold, cross, groups and
    teams. The cross-chunk phase works on columns of K << fold words
    (N >> (log2 K + fold) apart) and runs the stages ``cross`` on them in
    registers: the log2 K stages across the chunks and the fold first
    local ones, all of the stages before the first pass of PASS when a
    column stays within MAX_COLUMN words and a thread's share of the
    chunk, else none. ``groups``: the local register passes in forward
    order as (first stage, stages), all of PASS stages but an unfolded
    first one (the inverse runs them in reverse); ``teams``: how many
    teams of TEAM_THREADS split the CTA in the passes of PASS, each on its
    own 1/teams of the chunk.
    """
    if K is None:
        K = 1 << (MAX_LOGK if logN >= FULL_CLUSTER_LOGN
                  else max(0, logN - LOG_CHUNK))
    logK = K.bit_length() - 1
    if K != 1 << logK or logN - logK < 4:
        raise ValueError(f"no cluster of {K} CTAs at logN {logN}")
    logM = logN - logK
    first = logM - PASS * ((logM - 1) // PASS)
    threads = max(32, (1 << logM) >> 5)
    column = K << first
    fold = first if column <= min(MAX_COLUMN, (1 << logM) // threads) else 0
    return dict(K=K, logM=logM, threads=threads, smem=8 << logM, fold=fold,
                cross=list(range(logK + fold)),
                groups=([(logK, first)] if fold != first else [])
                + [(logK + r0, PASS) for r0 in range(first, logM, PASS)],
                teams=min(max(1, threads // TEAM_THREADS), 1 << first))


# The unsplit switch core's launch (csrc/ntt_mulacc.cu): logN up to
# MULACC_MAX_LOGN (the engine's FUSED_SWITCH_MAX_LOGN), clusters of
# MULACC_K[logN] CTAs (else 1), each holding MULACC_HELD[logN] parts'
# chunks at once (else 1), chosen by bfly_variants.py --mulacc on the H100.
# A CTA of t threads holds 128 registers a thread, so at most
# MAX_THREADS // t of them fit an SM, and as many as its SM_SMEM bytes of
# shared memory hold (1 KB of them reserved a CTA).
MULACC_MAX_LOGN = 15
MULACC_K = {14: 4, 15: 8}
MULACC_HELD = {15: 2}
MULACC_MAX_HELD = 4
MAX_THREADS = 512
SMEM_PER_CTA = 232448
SM_SMEM = 233472


def mulacc_geometry(logN, P, C, K=None, G=None, held=None):
    """The launch of the unsplit switch core (``ntt_mulacc``) on P parts of
    C channels at logN, as its wrapper chooses it (or with K CTAs a
    cluster, G part groups and ``held`` parts' chunks a CTA forced: a model
    only): ``bfly_geometry``'s transform at that K (``smem`` for all the
    chunks held), plus G (by default P / held, rounded up), the part groups
    ``parts`` ((first, end) of each, in group order), ``columns``
    (cross-chunk columns a thread), ``ctas`` (G * K * C), ``per_sm`` (CTAs
    an SM holds) and ``takes`` (whether the kernel launches it: chunks of
    at most 2^LOG_CHUNK words within a CTA's shared memory, at least one
    column a thread, at most MULACC_MAX_HELD chunks).
    """
    if not MIN_LOGN <= logN <= MULACC_MAX_LOGN:
        raise ValueError(f"ntt_mulacc: the kernel takes logN {MIN_LOGN}-"
                         f"{MULACC_MAX_LOGN}, not {logN}")
    geo = bfly_geometry(logN, MULACC_K.get(logN, 1) if K is None else K)
    K = geo["K"]
    held = MULACC_HELD.get(logN, 1) if held is None else held
    G = -(-P // held) if G is None else G
    if not 1 <= G <= P:
        raise ValueError(f"ntt_mulacc: {G} part groups of {P} parts")
    columns = ((1 << geo["logM"]) >> geo["fold"]) // K // geo["threads"]
    smem = held * geo["smem"]
    geo.update(G=G, held=held, smem=smem,
               parts=[(g * P // G, (g + 1) * P // G) for g in range(G)],
               columns=columns, ctas=G * K * C,
               per_sm=min(MAX_THREADS // geo["threads"],
                          SM_SMEM // (smem + 1024)),
               takes=geo["logM"] <= LOG_CHUNK and columns >= 1
               and 1 <= held <= MULACC_MAX_HELD and smem <= SMEM_PER_CTA)
    return geo


def reset_launches():
    for counts in (launches, mode_launches):
        for k in counts:
            counts[k] = 0


class NttPlan:
    """Per-channel tables of the kernels for one channel layout.

    ``mont`` selects the twiddle form. Shoup (False): w/wp, iw/iwp are
    the forward and inverse PLAIN twiddle banks [C, N] (bit-reversed:
    stage s, block b uses entry 2^s + b) and their Shoup quotients
    floor(w * 2^64 / q); enter: (R mod q, quotient); ninv: (N^-1,
    quotient); ninv_exit: (N^-1 R^-1, quotient), each a pair of [C]
    tensors. Montgomery (True): w/iw are the banks in Montgomery form,
    psi R mod q as the reference's REDC by R^2 leaves them (lazy [0, 2q)),
    wp = iwp = None; enter: (R^2 mod q,); ninv: (N^-1 R mod q,);
    ninv_exit None (the exit is a Montgomery reduce after the
    normalisation). q, k: [C] modulus and k = -q^-1 mod 2^62; ident:
    R mod q, the canon pre-stage's Montgomery identity.
    """

    __slots__ = ("logN", "q", "k", "w", "wp", "iw", "iwp", "enter", "ninv",
                 "ninv_exit", "ident", "mont")

    def __init__(self, logN, q, k, w, wp, iw, iwp, enter, ninv, ninv_exit,
                 ident, mont=False):
        self.logN = logN
        self.q, self.k = q, k
        self.w, self.wp, self.iw, self.iwp = w, wp, iw, iwp
        self.enter, self.ninv, self.ninv_exit = enter, ninv, ninv_exit
        self.ident, self.mont = ident, mont

    def slice(self, start, stop):
        """The plan of the channel range [start, stop) (views, no copies)."""
        def cut(t):
            return t[start:stop]
        return self._map(cut)

    def select(self, idx):
        """The plan of the channels idx (an int64 index tensor; copies)."""
        return self._map(lambda t: t.index_select(0, idx))

    def _map(self, fn):
        def f(t):
            if t is None:
                return None
            return tuple(map(f, t)) if isinstance(t, tuple) else fn(t)
        return NttPlan(self.logN, *(f(getattr(self, n)) for n in
                                    self.__slots__[1:-1]), mont=self.mont)


def make_plan(logN, q_list, k_list, psi_plain, ipsi_plain, device,
              mont=False):
    """Build an NttPlan from the plain banks psi_plain/ipsi_plain (int64
    [C, N]): with ``mont`` the Montgomery-twiddle plan, else the Shoup one,
    whose quotient banks are computed by long division on ``device``."""
    R = 1 << 62
    N = 1 << logN
    qt = u64.tensor(q_list, device)
    kt = u64.tensor(k_list, device)
    w = torch.as_tensor(psi_plain, dtype=torch.int64).to(device)
    iw = torch.as_tensor(ipsi_plain, dtype=torch.int64).to(device)
    ninv = [pow(N, -1, q) for q in q_list]
    ident = u64.tensor([R % q for q in q_list], device)
    if mont:
        Rs = u64.tensor([R * R % q for q in q_list], device)
        cons = [t[:, None] for t in _halves(qt, kt)]
        return NttPlan(
            logN, qt, kt, u64.montmul(w, Rs[:, None], *cons).contiguous(),
            None, u64.montmul(iw, Rs[:, None], *cons).contiguous(), None,
            enter=(Rs,),
            ninv=(u64.tensor([n * R % q for n, q in zip(ninv, q_list)],
                             device),),
            ninv_exit=None, ident=ident, mont=True)

    def quot(bank):
        return u64.shoup_quotient(bank, qt[:, None]).contiguous()

    def scalar(ws):
        return (u64.tensor(ws, device),
                u64.tensor([(w_ << 64) // q for w_, q in zip(ws, q_list)],
                           device))

    rinv = [pow(R, -1, q) for q in q_list]
    return NttPlan(
        logN, qt, kt, w, quot(w), iw, quot(iw),
        enter=scalar([R % q for q in q_list]),
        ninv=scalar(ninv),
        ninv_exit=scalar([(n * r) % q for n, r, q in zip(ninv, rinv,
                                                          q_list)]),
        ident=ident)


def prime_plan(logN, count, device, bits=60, mont=False):
    """The NttPlan of the ``count`` largest primes q = 1 (mod 2N) below
    2^bits, without a whole context (the presets' 60-bit base and special
    primes are the first of them): transform checks at any logN."""
    from ..fhe.context.ckks_context import psi_bank
    from ..fhe.context.prim_test import miller_rabin

    m = 2 << logN
    q, primes = ((1 << bits) - 1) // m * m + 1, []
    while len(primes) < count:
        if miller_rabin(q):
            primes.append(q)
        q -= m
    R = 1 << 62
    psi, ipsi = psi_bank(primes, logN)
    return make_plan(logN, primes, [(-pow(p, -1, R)) % R for p in primes],
                     psi, ipsi, device, mont=mont)


# -- plain twins ------------------------------------------------------------------


def _cond_sub(v, m):
    # Signed compare, as the reference's conditional subtract.
    return torch.where(v < m, v, v - m)


def _halves(q, k):
    """The 31-bit half limbs (ql, qh, kl, kh) of q and k for u64.montmul."""
    return (q & u64.LB_MASK, q >> u64.HALF_NBITS,
            k & u64.LB_MASK, k >> u64.HALF_NBITS)


def _montmul_consts(plan):
    return _halves(plan.q, plan.k)


def _cols(plan, dims):
    """(q, and the montmul constants) as [C, 1, ...] columns of ``dims``
    trailing axes."""
    def col(t):
        return t.reshape((-1,) + (1,) * dims)
    return col(plan.q), [col(t) for t in _montmul_consts(plan)]


def _scalar_mul(a, plan, pair):
    """a [B, C, N] times the per-channel constant ``pair``: a Shoup product
    with (w, wp), or a Montgomery product with (w,) on a Montgomery
    plan."""
    q, cons = _cols(plan, 1)
    if plan.mont:
        return u64.montmul(a, pair[0][:, None], *cons)
    return u64.shoup_mul(a, pair[0][:, None], pair[1][:, None], q)


def _twiddle(x, plan, bank, quot, m):
    """x [B, C, m, h] times the twiddles of stage log2(m), bank entries
    m .. 2m - 1: Shoup with their quotients, or Montgomery (the XLA
    chain's montmul(twiddle, word))."""
    q, cons = _cols(plan, 2)
    if plan.mont:
        return u64.montmul(bank[:, m:2 * m, None], x, *cons)
    return u64.shoup_mul(x, bank[:, m:2 * m, None], quot[:, m:2 * m, None],
                         q)


def canon_plain(x, plan):
    """The canon pre-stage: canon_2q(montmul_signed(x, R mod q)), x [B, C,
    N] signed words (wrapped negatives allowed) -> [0, 2q)."""
    q, cons = _cols(plan, 1)
    r = u64.montmul(x, plan.ident[:, None], *cons)
    return torch.where(r < 0, r + 2 * q, r)


def ntt_fwd_plain(x, plan, pre_enter=False, post_reduce=False,
                  pre_canon=False):
    """Forward NTT of x [B, C, N] (CT butterflies, bit-reversed output)."""
    B, C, N = x.shape
    q2 = 2 * plan.q[:, None, None]
    a = x
    if pre_canon:
        a = canon_plain(a, plan)
    if pre_enter:
        a = _scalar_mul(a, plan, plan.enter)
    for s in range(plan.logN):
        m = 1 << s
        v = a.reshape(B, C, m, 2, N >> (s + 1))
        U, O = v[:, :, :, 0], v[:, :, :, 1]
        V = _twiddle(O, plan, plan.w, plan.wp, m)
        a = torch.stack([_cond_sub(U + V, q2), _cond_sub(U + q2 - V, q2)],
                        dim=3).reshape(B, C, N)
    if post_reduce:
        a = _cond_sub(a, plan.q[:, None])
    return a


def _check_no_norm(no_norm, post_exit, post_reduce):
    if no_norm and (post_exit or post_reduce):
        raise ValueError("no_norm skips the exit and the reduce with the "
                         "normalisation")


def ntt_inv_plain(x, plan, post_exit=False, post_reduce=False,
                  no_norm=False):
    """Inverse NTT of x [B, C, N] (GS butterflies), then the multiply by
    N^-1 (Shoup: N^-1 R^-1 with post_exit; Montgomery: by N^-1 R, then a
    Montgomery reduce with post_exit), then optionally [0, 2q) -> [0, q).
    ``no_norm``: the lazy [0, 2q) words of the last stage, with neither."""
    _check_no_norm(no_norm, post_exit, post_reduce)
    B, C, N = x.shape
    q2 = 2 * plan.q[:, None, None]
    a = x
    for s in reversed(range(plan.logN)):
        m = 1 << s
        v = a.reshape(B, C, m, 2, N >> (s + 1))
        U, V = v[:, :, :, 0], v[:, :, :, 1]
        W = _twiddle(_cond_sub(U + q2 - V, q2), plan, plan.iw, plan.iwp, m)
        a = torch.stack([_cond_sub(U + V, q2), W], dim=3).reshape(B, C, N)
    if no_norm:
        return a
    if plan.mont:
        a = _scalar_mul(a, plan, plan.ninv)
        if post_exit:
            a = u64.montredc(a, *_cols(plan, 1)[1])
    else:
        a = _scalar_mul(a, plan, plan.ninv_exit if post_exit else plan.ninv)
    if post_reduce:
        a = _cond_sub(a, plan.q[:, None])
    return a


def ksk_mulacc_plain(x, k0, k1, plan, level, part_off):
    """x [P, C, N]; k0/k1 full key stacks [P_full, C0, N]. Returns
    (d0, d1) [C, N]: montmul products with the key at
    [part_off + p, level + c], summed over p with a 2q conditional
    subtract after each add."""
    P, C, _ = x.shape
    cons = [t[:, None] for t in _montmul_consts(plan)]
    q2 = 2 * plan.q[:, None]
    p0 = u64.montmul(x, k0[part_off:part_off + P, level:level + C], *cons)
    p1 = u64.montmul(x, k1[part_off:part_off + P, level:level + C], *cons)
    d0, d1 = p0[0], p1[0]
    for p in range(1, P):
        d0 = _cond_sub(d0 + p0[p], q2)
        d1 = _cond_sub(d1 + p1[p], q2)
    return d0, d1


def ntt_mulacc_plain(x, k0, k1, plan, level, part_off, canon=False):
    """x [P, C, N] lazy [0, 2q) (with ``canon`` signed words, through the
    canon pre-stage first): the forward NTT of every part, then
    ksk_mulacc_plain. Returns (d0, d1) [C, N]."""
    return ksk_mulacc_plain(ntt_fwd_plain(x, plan, pre_canon=canon), k0, k1,
                            plan, level, part_off)


# -- CUDA launches -----------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "ltt_ntt_fwd": [_P, _L, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                    _I, _P],
    "ltt_ntt_inv": [_P, _L, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                    _I, _P],
    "ltt_ntt_geometry": [_I, ctypes.POINTER(_I)],
    "ltt_ksk_mulacc": [_P, _L, _L, _P, _P, _L, _L, _I, _I, _I, _P, _P, _P, _P,
                       _P],
    "ltt_ntt_mulacc": [_P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                       _P, _P, _P, _P, _L, _L, _P, _P, _P],
    "ltt_ntt_mulacc_geometry": [_I, _I, ctypes.POINTER(_I)],
}


def _fn(lib_name, fn_name):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(x, *tables):
    if x.dtype != torch.int64:
        raise TypeError(f"expected int64 words, got {x.dtype}")
    for t in tables:
        if t.device != x.device or t.dtype != torch.int64 \
                or not t.is_contiguous():
            raise ValueError("kernel tables must be contiguous int64 on "
                             "the data's device")


_LAUNCH_ERRORS = {
    -1: "a logN, cluster or part grouping the kernel does not take",
    -2: "its cluster of CTAs cannot be scheduled on this device",
}


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: " + _LAUNCH_ERRORS.get(
            rc, f"CUDA error {rc} at launch"))


def _batched(x, plan):
    """View x [..., C, N] as [B, C, N] (no copy); checks the shape."""
    C, N = plan.q.shape[0], 1 << plan.logN
    if x.shape[-2:] != (C, N):
        raise ValueError(f"expected [..., {C}, {N}] words, got "
                         f"{tuple(x.shape)}")
    return x.reshape(-1, C, N)


def _device_kind(x):
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise RuntimeError(f"no kernel for device {x.device}")


def _check_transform(name, xb, plan):
    """What the transform kernels take of xb [B, C, N]: a contiguous
    coefficient axis, logN in their range and, for the inverse (read in
    16-byte words), a 16-byte aligned start and even strides."""
    B, C, _ = xb.shape
    if xb.stride(2) != 1:
        raise ValueError(f"{name}: the coefficient axis must be contiguous")
    if not MIN_LOGN <= plan.logN <= MAX_LOGN:
        raise ValueError(f"{name}: the kernel takes logN {MIN_LOGN}-"
                         f"{MAX_LOGN}, not {plan.logN}")
    if name == "ntt_inv" and (xb.data_ptr() % 16
                              or (B > 1 and xb.stride(0) % 2)
                              or (C > 1 and xb.stride(1) % 2)):
        raise ValueError("ntt_inv: the kernel reads its input in 16-byte "
                         "words: it must be 16-byte aligned with even "
                         "batch and channel strides")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _transform(name, x, plan, w, wp, scal, mode, post_reduce, twin,
               counter):
    """One transform launch: twiddle bank w with its quotients wp (None on
    a Montgomery plan), the per-channel constants ``scal`` of the entry or
    the normalisation (None for none), ``mode`` (forward: 0, 1 entry,
    2 canon; inverse: the Montgomery exit)."""
    xb = _batched(x, plan)
    if _device_kind(x) == "cpu":
        return twin(xb).reshape(x.shape)
    consts = [t for t in (plan.k, w, wp, *(scal or ())) if t is not None]
    _check_cuda(x, plan.q, *consts)
    _check_transform(name, xb, plan)
    B, C, N = xb.shape
    s0, s1 = (tuple(scal) + (None,))[:2] if scal else (None, None)
    out = torch.empty((B, C, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn("ntt", "ltt_" + name)(
            xb.data_ptr(), xb.stride(0), xb.stride(1), out.data_ptr(), B, C,
            plan.logN, w.data_ptr(), _ptr(wp), plan.q.data_ptr(),
            plan.k.data_ptr(), _ptr(s0), _ptr(s1), mode, int(post_reduce),
            stream)
    _raise_on(rc, name)
    _count(counter)
    return out.reshape(x.shape)


def ntt_fwd(x, plan, pre_enter=False, post_reduce=False, pre_canon=False):
    """Forward NTT of x [..., C, N] (CUDA kernel, or the twin on the CPU),
    in the twiddle form of the plan; ``pre_enter`` enters Montgomery form
    first, ``pre_canon`` runs the canon pre-stage on signed words."""
    if pre_enter and pre_canon:
        raise ValueError("ntt_fwd: pre_enter or pre_canon, not both")
    scal = plan.enter if pre_enter else (plan.ident,) if pre_canon else None
    return _transform(
        "ntt_fwd", x, plan, plan.w, plan.wp, scal,
        2 if pre_canon else int(pre_enter), post_reduce,
        lambda xb: ntt_fwd_plain(xb, plan, pre_enter, post_reduce,
                                 pre_canon),
        launch_label("ntt_fwd", plan.mont, pre_canon))


def ntt_inv(x, plan, post_exit=False, post_reduce=False, no_norm=False):
    """Inverse NTT of x [..., C, N] with the N^-1 multiply (and the
    Montgomery exit when post_exit) and optional reduce; with ``no_norm``
    without the multiply (and then without the exit and the reduce)."""
    _check_no_norm(no_norm, post_exit, post_reduce)
    if no_norm:
        scal = None
    elif plan.mont:
        scal = plan.ninv
    else:
        scal = plan.ninv_exit if post_exit else plan.ninv
    return _transform(
        "ntt_inv", x, plan, plan.iw, plan.iwp, scal,
        int(post_exit and plan.mont), post_reduce,
        lambda xb: ntt_inv_plain(xb, plan, post_exit, post_reduce, no_norm),
        launch_label("ntt_inv_no_norm" if no_norm else "ntt_inv",
                     plan.mont))


def _check_switch_core(name, x, k0, k1, plan, level, part_off):
    """Shape checks of the switch cores; on a CUDA tensor also the dtypes,
    devices and strides the kernels read. Returns the key views at
    (part_off, level)."""
    P, C, N = x.shape
    if plan.q.shape[0] != C or N != 1 << plan.logN:
        raise ValueError(f"{name}: x does not match the plan")
    if k0.shape != k1.shape or k0.stride() != k1.stride() \
            or k0.shape[0] < part_off + P or k0.shape[1] < level + C \
            or k0.shape[2] != N:
        raise ValueError(f"{name}: key stacks do not cover the parts and "
                         f"channels")
    if x.is_cuda:
        _check_cuda(x, plan.q, plan.k)
        for t in (x, k0, k1):
            if t.device != x.device or t.dtype != torch.int64 \
                    or t.stride(2) != 1:
                raise ValueError(f"{name}: int64 operands on one device "
                                 f"with a contiguous coefficient axis")
    return (k0[part_off:part_off + P, level:level + C],
            k1[part_off:part_off + P, level:level + C])


def ksk_mulacc(x, k0, k1, plan, level, part_off):
    """Key-switch multiply-accumulate (see ksk_mulacc_plain). The key
    stacks are read in place through their strides."""
    k0v, k1v = _check_switch_core("ksk_mulacc", x, k0, k1, plan, level,
                                  part_off)
    if _device_kind(x) == "cpu":
        return ksk_mulacc_plain(x, k0, k1, plan, level, part_off)
    P, C, N = x.shape
    d0 = torch.empty((C, N), dtype=torch.int64, device=x.device)
    d1 = torch.empty_like(d0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn("ksk_mulacc", "ltt_ksk_mulacc")(
            x.data_ptr(), x.stride(0), x.stride(1), k0v.data_ptr(),
            k1v.data_ptr(), k0v.stride(0), k0v.stride(1), P, C, plan.logN,
            plan.q.data_ptr(), plan.k.data_ptr(), d0.data_ptr(),
            d1.data_ptr(), stream)
    _raise_on(rc, "ksk_mulacc")
    launches["ksk_mulacc"] += 1
    return d0, d1


def ntt_mulacc(x, k0, k1, plan, level, part_off, canon=False):
    """The unsplit switch core (see ntt_mulacc_plain): x [P, C, N] lazy
    [0, 2q) extension words (with ``canon`` signed words, through the canon
    pre-stage) in, (d0, d1) [C, N] out, in the twiddle form of the plan.
    The key stacks are read in place through their strides (16-byte
    aligned with even strides on the card). logN 8 to MULACC_MAX_LOGN."""
    k0v, k1v = _check_switch_core("ntt_mulacc", x, k0, k1, plan, level,
                                  part_off)
    P, C, N = x.shape
    if not MIN_LOGN <= plan.logN <= MULACC_MAX_LOGN:
        raise ValueError(f"ntt_mulacc: the kernel takes logN {MIN_LOGN}-"
                         f"{MULACC_MAX_LOGN}, not {plan.logN}")
    if _device_kind(x) == "cpu":
        return ntt_mulacc_plain(x, k0, k1, plan, level, part_off, canon)
    _check_cuda(x, *(t for t in (plan.w, plan.wp, plan.ident)
                     if t is not None))
    if k0v.data_ptr() % 16 or k1v.data_ptr() % 16 \
            or any(s % 2 for s in k0v.stride()[:2]):
        raise ValueError("ntt_mulacc: the kernel reads the keys in 16-byte "
                         "words: 16-byte aligned views with even part and "
                         "channel strides")
    geo = mulacc_geometry(plan.logN, P, C)
    G, K = geo["G"], geo["K"]
    d = torch.empty((2, C, N), dtype=torch.int64, device=x.device)
    part = torch.empty((G - 1, 2, C, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn("ntt_mulacc", "ltt_ntt_mulacc")(
            x.data_ptr(), x.stride(0), x.stride(1), part.data_ptr(), P, G,
            geo["held"], C, plan.logN, K.bit_length() - 1,
            plan.w.data_ptr(), _ptr(plan.wp), plan.q.data_ptr(),
            plan.k.data_ptr(), plan.ident.data_ptr() if canon else None,
            k0v.data_ptr(), k1v.data_ptr(), k0v.stride(0), k0v.stride(1),
            d[0].data_ptr(), d[1].data_ptr(), stream)
    _raise_on(rc, "ntt_mulacc")
    _count(launch_label("ntt_mulacc", plan.mont, canon))
    return d[0], d[1]
