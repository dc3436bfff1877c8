"""The host side of the port's butterfly transforms (``csrc/ntt.cu``,
kernels #1 ``ntt_fwd`` and #2 ``ntt_inv``), on the CPU: no card, no JAX.

- the launch geometry (a cluster of K CTAs per channel, each holding
  N / K words in shared memory) fits one H100 at logN 8-17;
- the shared-memory swizzle is a permutation, and every half-warp access
  of the register groups and of the cross-chunk phase falls on 16
  distinct 8-byte bank pairs;
- a replay of the kernel's phase order (the cross-chunk stages in
  registers, the words through the swizzled shared memory of the CTA that
  owns them, the local register passes) gives the twins' words bit for
  bit, forward and inverse, at logN 8 with K forced to 1, 2, 4 and 8 and
  at logN 9, 12 and 15 with the kernel's own K;
- the wrapper's checks of what the kernel takes.
"""

import functools

import numpy as np
import pytest
import torch

from liberate_tpu_torch.ntt import cuda_ntt, u64

SMEM_PER_BLOCK = 232448   # bytes a block may use on an H100
REGS_PER_SM = 65536
MAX_CLUSTER = 8           # the portable cluster size
REGS_NEEDED = 128         # 8 words, 7 twiddle pairs, addresses: no spill
SEED = 20260817
PASS = cuda_ntt.PASS


@functools.lru_cache(maxsize=None)
def _plan(logN, C):
    return cuda_ntt.prime_plan(logN, C, "cpu")


def _words(plan, B, seed=SEED):
    """Lazy words below 2q, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = plan.q.numpy()
    x = rng.integers(0, 2 * q[None, :, None],
                     size=(B, len(q), 1 << plan.logN), dtype=np.int64)
    return torch.from_numpy(x)


def _swz(i):
    return i ^ ((i >> 4) & 15)


def _group(x, s, blk, R, fwd, w, wp, q):
    """Stages s .. s+R-1 (CT) or s+R-1 .. s (GS) of the groups x [B, C, K,
    G, 2^R], the 2^R words of a thread's group; blk [K, G] the group's
    block at stage s. Twiddle of stage s+i for word k: 2^(s+i) + (blk <<
    i) + (k >> (R - i))."""
    x = list(x.unbind(-1))
    W = 1 << R
    q = q[:, None, None]
    q2 = 2 * q
    for i in (range(R) if fwd else reversed(range(R))):
        half = W >> (i + 1)
        for k in range(W):
            if k & half:
                continue
            e = (1 << (s + i)) + (blk << i) + (k >> (R - i))
            tw, twp = w[:, e], wp[:, e]
            U, V = x[k], x[k + half]
            if fwd:
                V = u64.shoup_mul(V, tw, twp, q)
                x[k] = cuda_ntt._cond_sub(U + V, q2)
                x[k + half] = cuda_ntt._cond_sub(U + q2 - V, q2)
            else:
                x[k] = cuda_ntt._cond_sub(U + V, q2)
                x[k + half] = u64.shoup_mul(
                    cuda_ntt._cond_sub(U + q2 - V, q2), tw, twp, q)
    return torch.stack(x, -1)


def _local(geo, s, R):
    """(word indices [G, 2^R] of the groups, their blocks [K, G] at stage
    s) of one local register group in the CTA's chunk."""
    logK, logM = geo["K"].bit_length() - 1, geo["logM"]
    r0 = s - logK
    logt = logM - r0 - R
    g = torch.arange(1 << (logM - R))
    blk = g >> logt
    base = (blk << (logt + R)) | (g & ((1 << logt) - 1))
    idx = base[:, None] + (torch.arange(1 << R) << logt)
    rank = torch.arange(geo["K"])[:, None]
    return idx, (rank << r0) + blk, logt


def _scalar(pair, q):
    return pair[0][:, None, None, None], pair[1][:, None, None, None], \
        q[:, None, None, None]


def _columns(geo):
    """(t, W, chunk [W], offset [t, W]): the cross-chunk columns j < t of
    W words j + i * t, word i in CTA chunk[i] at offset[j, i]."""
    K, M, fold = geo["K"], 1 << geo["logM"], geo["fold"]
    t, W = M >> fold, K << fold
    i = torch.arange(W)
    offset = torch.arange(t)[:, None] + (i & ((1 << fold) - 1)) * t
    return t, W, i >> fold, _swz(offset)


def replay_fwd(x, plan, geo, pre_enter=False, post_reduce=False,
               smem=False):
    """The forward kernel's phases on x [B, C, N]: per column the W words,
    entered and through the cross-chunk stages, each written to its CTA's
    shared memory; then the local passes, the last one's neighbouring
    words to the output. ``smem``: return instead what the last pass
    leaves in each CTA's shared memory, [B, C, K, M], word i of a chunk
    at swz(i) (bfly.cuh fwd_chunk)."""
    B, C, N = x.shape
    K, M = geo["K"], 1 << geo["logM"]
    t, W, chunk, offset = _columns(geo)
    v = x.reshape(B, C, W, t).transpose(2, 3)[:, :, None]   # [B, C, 1, t, W]
    if pre_enter:
        v = u64.shoup_mul(v, *_scalar(plan.enter, plan.q))
    if geo["cross"]:
        v = _group(v, 0, torch.zeros((1, t), dtype=torch.int64),
                   len(geo["cross"]), True, plan.w, plan.wp, plan.q)
    sh = torch.empty((B, C, K, M), dtype=torch.int64)
    sh[:, :, chunk[None, :], offset] = v[:, :, 0]
    out = torch.empty((B, C, K, M), dtype=torch.int64)
    for n, (s, R) in enumerate(geo["groups"]):
        idx, blk, logt = _local(geo, s, R)
        y = _group(sh[..., _swz(idx)], s, blk, R, True, plan.w, plan.wp,
                   plan.q)
        if smem or n < len(geo["groups"]) - 1:
            sh[..., _swz(idx)] = y
        else:
            assert (R, logt) == (PASS, 0)
            if post_reduce:
                y = cuda_ntt._cond_sub(y, plan.q[:, None, None, None])
            out[..., idx] = y
    return sh if smem else out.reshape(B, C, N)


def replay_inv(x, plan, geo, post_exit=False, post_reduce=False):
    """The inverse kernel's phases: the local passes in reverse, the first
    reading its neighbouring words from the input; then per column the W
    words from their CTAs through the cross-chunk stages, the
    normalisation and the reduce, to j + i * t."""
    B, C, N = x.shape
    K, M = geo["K"], 1 << geo["logM"]
    t, W, chunk, offset = _columns(geo)
    xin = x.reshape(B, C, K, M)
    sh = torch.empty((B, C, K, M), dtype=torch.int64)
    for n, (s, R) in enumerate(reversed(geo["groups"])):
        idx, blk, logt = _local(geo, s, R)
        if n == 0:
            assert (R, logt) == (PASS, 0)
        y = _group(xin[..., idx] if n == 0 else sh[..., _swz(idx)], s, blk,
                   R, False, plan.iw, plan.iwp, plan.q)
        sh[..., _swz(idx)] = y
    v = sh[:, :, chunk[None, :], offset][:, :, None]       # [B, C, 1, t, W]
    if geo["cross"]:
        v = _group(v, 0, torch.zeros((1, t), dtype=torch.int64),
                   len(geo["cross"]), False, plan.iw, plan.iwp, plan.q)
    v = u64.shoup_mul(v, *_scalar(plan.ninv_exit if post_exit
                                  else plan.ninv, plan.q))
    if post_reduce:
        v = cuda_ntt._cond_sub(v, plan.q[:, None, None, None])
    return v[:, :, 0].transpose(2, 3).reshape(B, C, N)


LOGNS = list(range(cuda_ntt.MIN_LOGN, cuda_ntt.MAX_LOGN + 1))


@pytest.mark.parametrize("logN", LOGNS)
def test_geometry_fits_the_h100(logN):
    g = cuda_ntt.bfly_geometry(logN)
    K, logM = g["K"], g["logM"]
    assert K == (8 if logN >= 16 else 1 << max(0, logN - 14))
    assert K << logM == 1 << logN and K <= MAX_CLUSTER
    assert g["smem"] == 8 << logM <= SMEM_PER_BLOCK
    t = g["threads"]
    assert t % 32 == 0 and t <= 512 and t * REGS_NEEDED <= REGS_PER_SM
    # a column of at most 8 words in the cross-chunk phase, and every
    # thread on the same number of columns (the cluster wait follows its
    # first loads)
    cols = K << g["fold"]
    assert cols <= 8 and ((1 << logM) >> g["fold"]) // K % t == 0
    first = logM - PASS * ((logM - 1) // PASS)
    assert g["fold"] == (0 if logN in (8, 12, 16, 17) else first)
    # the cross-chunk stages and the local passes cover stages 0 .. logN-1
    # once, in order; all passes but an unfolded first have PASS stages,
    # and the forward's last (the inverse's first) is PASS stages of
    # neighbours
    stages = g["cross"] + [s + i for s, R in g["groups"] for i in range(R)]
    assert stages == list(range(logN))
    assert all(R == PASS for _, R in g["groups"][1:])
    assert g["groups"][0][1] == PASS or g["fold"] == 0
    assert g["groups"][-1] == (logN - PASS, PASS)
    # the teams of the passes of PASS: whole warps, each on its own blocks
    teams = g["teams"]
    assert t % teams == 0 and (t // teams) % 32 == 0 and teams <= 16
    assert teams == min(max(1, t // 128), 1 << first)
    assert teams == {13: 2, 14: 4, 15: 4, 16: 2, 17: 4}.get(logN, 1)


@pytest.mark.parametrize("logN", LOGNS)
def test_swizzle_keeps_half_warps_off_shared_bank_conflicts(logN):
    g = cuda_ntt.bfly_geometry(logN)
    K, M, t = g["K"], 1 << g["logM"], g["threads"]
    phys = _swz(torch.arange(M))
    assert torch.equal(phys.sort().values, torch.arange(M))

    def distinct_banks(phys):
        # phys [threads in issue order, ...]: each half-warp of 16 threads
        # on 16 distinct 8-byte bank pairs
        banks = (phys % 16).reshape(-1, 16, *phys.shape[1:])
        assert torch.equal(banks.sort(dim=1).values,
                           torch.arange(16).reshape(1, 16, *[1] * (
                               phys.dim() - 1)).expand_as(banks))

    # the cross-chunk phase: a CTA's columns in issue order, each word of a
    # column to (or from) its CTA
    cols, _, _, offset = _columns(g)
    distinct_banks(offset)
    assert (cols // K) % t == 0
    for s, R in g["groups"]:
        idx, _, _ = _local(g, s, R)
        distinct_banks(_swz(idx))


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_replay_forward_is_the_twin(K, flags):
    plan = _plan(8, 2)
    x = _words(plan, 2)
    geo = cuda_ntt.bfly_geometry(8, K)
    assert torch.equal(replay_fwd(x, plan, geo, *flags),
                       cuda_ntt.ntt_fwd_plain(x, plan, *flags))


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_replay_inverse_is_the_twin(K, flags):
    plan = _plan(8, 2)
    x = _words(plan, 2, SEED + 1)
    geo = cuda_ntt.bfly_geometry(8, K)
    assert torch.equal(replay_inv(x, plan, geo, *flags),
                       cuda_ntt.ntt_inv_plain(x, plan, *flags))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logN", [9, 12, 15])
def test_replay_at_the_kernels_own_geometry(logN, inverse):
    plan = _plan(logN, 1)
    x = _words(plan, 1)
    geo = cuda_ntt.bfly_geometry(logN)
    assert geo["K"] == (2 if logN == 15 else 1)
    assert geo["fold"] == {9: 1, 15: 2}.get(logN, 0)
    if inverse:
        got = replay_inv(x, plan, geo, True, True)
        want = cuda_ntt.ntt_inv_plain(x, plan, True, True)
    else:
        got = replay_fwd(x, plan, geo, True, True)
        want = cuda_ntt.ntt_fwd_plain(x, plan, True, True)
    assert torch.equal(got, want)
    # and the inverse undoes the forward (N^-1 folded in, no exit)
    if not inverse:
        back = replay_inv(cuda_ntt.ntt_fwd_plain(x, plan), plan, geo,
                          post_reduce=True)
        assert torch.equal(back, x % plan.q[None, :, None])


def test_wrapper_checks_what_the_kernel_takes():
    plan = _plan(8, 2)
    x = _words(plan, 2)
    check = cuda_ntt._check_transform
    check("ntt_inv", x, plan)
    check("ntt_fwd", x[:, 1:], plan.slice(1, 2))
    flat = torch.empty(x.numel() + 1, dtype=torch.int64)
    odd = flat[1:].view(x.shape)          # 8 bytes past 16-byte alignment
    check("ntt_fwd", odd, plan)
    with pytest.raises(ValueError, match="16-byte"):
        check("ntt_inv", odd, plan)
    with pytest.raises(ValueError, match="contiguous"):
        check("ntt_fwd", x.transpose(1, 2).contiguous().transpose(1, 2),
              plan)
    small = cuda_ntt.prime_plan(7, 1, "cpu")
    with pytest.raises(ValueError, match="logN 8-17"):
        check("ntt_fwd", _words(small, 1), small)
    with pytest.raises(ValueError, match="no cluster"):
        cuda_ntt.bfly_geometry(8, 3)
