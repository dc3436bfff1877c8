"""Tables of the tensor-core ("MXU") NTT: the transform as int8 matmuls.

Per RNS channel (N = R*S, psi a primitive 2N-th root, W = psi^2), the data
is viewed A[s, r] = a[s*R + r] and transformed in four steps:

    stage 1:  B[k2, r]  = sum_s M1[k2, s] A[s, r],   M1[k2, s] = psi^{R s (2 k2 + 1)}
    twiddle:  B'[k2, r] = B[k2, r] psi^{r (2 k2 + 1)}                (Montgomery form)
    stage 2:  X[k1*S + k2] = sum_r M2[k1, r] B'[k2, r],  M2[k1, r] = W^{S r k1}

giving X[k] = sum_n a[n] psi^n W^{nk} in NATURAL order. The inverse runs
the mirrored steps (I1, the inverse twiddle, I2 with N^-1 folded in).

Each product of a table by 62-bit words is exact over the integers through
base-256 digits: the table side (built here, once) folds the data-digit
weight 2^{8v} into the table and splits each entry into dA BALANCED digits
in [-128, 127]; the data side (in the kernels) takes dB unsigned digits,
offset by -128 into int8, and adds back 128 x the table row's digit sum
(``*_rs``). Every int32 partial sum stays below 2^28.

``make_plan`` is a vectorised rebuild of the JAX package's
``liberate_tpu/ntt/mxu_ntt.py:make_plan`` (same digits, same constants):
power tables by repeated doubling with Shoup constant products on int64
tensors, every other table entry an index into them. ``group_plans`` builds
one plan per width group (``width_groups``) and caches it on disk.
"""

import hashlib
from pathlib import Path

import torch

from . import u64

# Planes of the recombination's low part: weights up to 2^{8*(SPLIT-1)}.
SPLIT = 5


def channel_digit_params(q):
    """(dA, dB) for one modulus: dA = fewest balanced base-256 digits whose
    positive capacity 127 * (256^dA - 1) / 255 covers q - 1; dB = bytes of
    the lazy residue bound 2q."""
    q = int(q)
    dA = 1
    while 127 * ((256 ** dA - 1) // 255) < q - 1:
        dA += 1
    dB = -(-((2 * q - 1).bit_length()) // 8)
    return dA, dB


def width_groups(q_list):
    """Contiguous channel runs with equal (dA, dB):
    [(start, stop, (dA, dB)), ...]."""
    runs = []
    for i, q in enumerate(q_list):
        p = channel_digit_params(q)
        if runs and runs[-1][1] == i and runs[-1][2] == p:
            runs[-1] = (runs[-1][0], i + 1, p)
        else:
            runs.append((i, i + 1, p))
    return runs


_TABLES = ("m1", "m1e", "m2", "i1", "i2", "i2x")
_CONSTS = ("q", "k", "bp", "whi", "wphi", "corr")
_FIELDS = (_CONSTS + _TABLES + tuple(t + "_rs" for t in _TABLES)
           + ("tw", "itw"))


class MxuPlan:
    """One channel set's tables, as tensors on one device.

    Digit tables (int8) are in the kernels' layout [C, dA*O, dB*K]: row
    u*O + o holds plane u of output row o, column v*K + k the weight of
    data digit v of input row k. ``*_rs`` are the int32 offset corrections
    [C, dA*O]. m1/m1e (forward stage 1, m1e = M1 * R: the transform of
    a*R), m2 (forward stage 2), i1 (inverse stage 1), i2/i2x (inverse
    stage 2 with N^-1, i2x also with R^-1: the Montgomery exit).
    tw/itw: Montgomery-form twiddles [C, S, R] (int64). Per channel [C]
    (int64): q, k = -q^-1 mod 2^62, the Barrett reciprocal
    bp = floor(2^64 / q), the high-part weight whi = 2^{8*split} mod q with
    its Shoup quotient wphi, and corr, the correction of the two +2^63
    offsets of the recombination.
    """

    __slots__ = ("R", "S", "dA", "dB", "split") + _FIELDS

    def __init__(self, R, S, dA, dB, split, **tensors):
        self.R, self.S, self.dA, self.dB, self.split = R, S, dA, dB, split
        for f in _FIELDS:
            setattr(self, f, tensors[f])

    @property
    def num_channels(self):
        return self.q.shape[0]

    def tensors(self):
        return {f: getattr(self, f) for f in _FIELDS}

    def slice(self, start, stop):
        """The plan of channels [start, stop) (views, no copies)."""
        return MxuPlan(self.R, self.S, self.dA, self.dB, self.split,
                       **{f: t[start:stop] for f, t in self.tensors().items()})

    def select(self, idx):
        """The plan of the channels idx (an int64 index tensor, repeats
        allowed; copies)."""
        return MxuPlan(self.R, self.S, self.dA, self.dB, self.split,
                       **{f: t.index_select(0, idx)
                          for f, t in self.tensors().items()})


def _mulmod(x, w, wp, q):
    """x * w mod q, canonical [0, q), for x in [0, q): a Shoup product
    ([0, 2q)) and one subtract. w, wp, q broadcast against x."""
    r = u64.shoup_mul(x, w, wp, q)
    return torch.where(r < q, r, r - q)


def _mulmod_const(x, ws, qs, qt):
    """x [C, ...] times one constant per channel (Python ints ws)."""
    ws = [w % q for w, q in zip(ws, qs)]
    shape = (-1,) + (1,) * (x.dim() - 1)
    w = u64.tensor(ws, x.device).reshape(shape)
    wp = u64.tensor([(w_ << 64) // q for w_, q in zip(ws, qs)],
                    x.device).reshape(shape)
    return _mulmod(x, w, wp, qt.reshape(shape))


def _pow_table(roots, qs, qt, n):
    """[C, n]: root_c^i mod q_c for i < n (n a power of two), by doubling."""
    t = torch.ones((len(qs), 1), dtype=torch.int64, device=qt.device)
    while t.shape[1] < n:
        m = t.shape[1]
        t = torch.cat([t, _mulmod_const(t, [pow(r, m, q) for r, q in
                                            zip(roots, qs)], qs, qt)], dim=1)
    return t


def _balanced_digits(x, nd):
    """int64 [...] in [0, 2^62) -> int64 [nd, ...] balanced base-256 digits
    in [-128, 127] (the carry rule of the JAX package's _balanced_digits_np)."""
    out = []
    for _ in range(nd):
        d = x & 0xFF
        x = x >> 8
        carry = d > 127
        out.append(torch.where(carry, d - 256, d))
        x = x + carry.to(torch.int64)
    if bool((x != 0).any()):
        raise ValueError("table entry too large for nd balanced digits")
    return torch.stack(out)


def _decompose(M, qs, qt, dA, dB):
    """M [C, O, I] canonical -> (int8 [C, dA*O, dB*I], int32 [C, dA*O]).
    One data digit v at a time goes into the int8 table, so the int64
    digits of one v are the largest temporary (at platinum's 512-point
    side a stack of all dB would be 5.4 GB for one (6, 6) table)."""
    C, O, I = M.shape
    out = torch.empty((C, dA, O, dB, I), dtype=torch.int8, device=M.device)
    rs = torch.zeros((C, dA, O), dtype=torch.int64, device=M.device)
    for v in range(dB):
        digs = _balanced_digits(_mulmod_const(
            M, [pow(2, 8 * v, q) for q in qs], qs, qt),
            dA).transpose(0, 1)                       # [C, dA, O, I]
        out[:, :, :, v] = digs
        rs += 128 * digs.sum(dim=3)
    if bool((rs.abs() >= 2 ** 31).any()):
        raise ValueError("row-sum correction exceeds int32")
    return (out.reshape(C, dA * O, dB * I),
            rs.reshape(C, dA * O).to(torch.int32))


def make_plan(logN, q_list, k_list, psi_list, device, dA, dB,
              word_bits=62) -> MxuPlan:
    """Build the tables of one channel set at digit parameters (dA, dB).

    q_list: moduli; k_list: -q^-1 mod 2^62; psi_list: primitive 2N-th
    roots. R = 2^word_bits is the Montgomery radix."""
    N = 1 << logN
    S = 1 << ((logN + 1) // 2)
    R = N // S
    split = min(dA, SPLIT)
    qs = [int(q) for q in q_list]
    qt = u64.tensor(qs, device)
    Rms = [(1 << word_bits) % q for q in qs]
    ipsis = [pow(int(p), -1, q) for p, q in zip(psi_list, qs)]
    ppsi = _pow_table([int(p) for p in psi_list], qs, qt, 2 * N)
    pipsi = _pow_table(ipsis, qs, qt, 2 * N)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    def look(table, idx):                             # idx [X, Y] -> [C, X, Y]
        return table[:, (idx % (2 * N)).reshape(-1)].reshape(
            (len(qs),) + tuple(idx.shape))

    odd_s = 2 * ar(S)[:, None] + 1                    # 2 k2 + 1, as a column
    M1 = look(ppsi, R * ar(S)[None, :] * odd_s)       # [k2, s]
    TW = look(ppsi, ar(R)[None, :] * odd_s)           # [k2, r]
    M2 = look(ppsi, 2 * S * ar(R)[:, None] * ar(R)[None, :])   # [k1, r]
    I1 = look(pipsi, 2 * S * ar(R)[:, None] * ar(R)[None, :])  # [j, k1]
    ITW = look(pipsi, ar(R)[None, :] * odd_s)         # [k2, j]
    I2 = _mulmod_const(look(pipsi, R * ar(S)[:, None]
                            * (2 * ar(S)[None, :] + 1)),
                       [pow(N, -1, q) for q in qs], qs, qt)  # [s, k2]
    M1e = _mulmod_const(M1, Rms, qs, qt)
    I2x = _mulmod_const(I2, [pow(r, -1, q) for r, q in zip(Rms, qs)], qs, qt)

    t = {}
    for name, M in (("m1", M1), ("m1e", M1e), ("m2", M2), ("i1", I1),
                    ("i2", I2), ("i2x", I2x)):
        t[name], t[name + "_rs"] = _decompose(M, qs, qt, dA, dB)
    t["tw"] = _mulmod_const(TW, Rms, qs, qt)
    t["itw"] = _mulmod_const(ITW, Rms, qs, qt)

    w_hi = [pow(2, 8 * split, q) for q in qs]
    t["q"] = qt
    t["k"] = u64.tensor(k_list, device)
    t["bp"] = u64.tensor([(1 << 64) // q for q in qs], device)
    t["whi"] = u64.tensor(w_hi, device)
    t["wphi"] = u64.tensor([(w << 64) // q for w, q in zip(w_hi, qs)],
                           device)
    t["corr"] = u64.tensor(
        [(-pow(2, 63, q) * (1 + (w if dA > split else 0))) % q
         for w, q in zip(w_hi, qs)], device)
    return MxuPlan(R, S, dA, dB, split, **t)


def _cache_path(ctx, lo, hi, dA, dB):
    key = hashlib.sha256(
        f"mxu_torch1_{lo}_{hi}_{dA}_{dB}_{ctx.logN}_{ctx.buffer_bit_length}_"
        f"{'_'.join(str(q) for q in ctx.q)}".encode()).hexdigest()[:24]
    return Path(ctx.cache_folder) / f"mxu_{key}.pt"


def group_plans(ctx, device, cache=True):
    """One plan per width group of the context's primes:
    ((start, stop, MxuPlan), ...) over global channel indices. With
    ``cache``, each plan is read from the context's cache folder when
    there, and written there after a build."""
    from ..fhe.context.ckks_context import primitive_root_2N

    out = []
    for lo, hi, (dA, dB) in width_groups(ctx.q):
        path = _cache_path(ctx, lo, hi, dA, dB)
        if cache and path.exists():
            d = torch.load(path, map_location=device, weights_only=True)
            plan = MxuPlan(d["R"], d["S"], d["dA"], d["dB"], d["split"],
                           **{f: d[f] for f in _FIELDS})
        else:
            qs = ctx.q[lo:hi]
            plan = make_plan(ctx.logN, qs, ctx.k[lo:hi],
                             [primitive_root_2N(q, ctx.N) for q in qs],
                             device, dA, dB,
                             word_bits=ctx.compute_radix_bits)
            if cache:
                d = {f: t.to("cpu") for f, t in plan.tensors().items()}
                d.update(R=plan.R, S=plan.S, dA=plan.dA, dB=plan.dB,
                         split=plan.split)
                tmp = path.with_suffix(".tmp")
                torch.save(d, tmp)
                tmp.replace(path)
        out.append((lo, hi, plan))
    return tuple(out)
