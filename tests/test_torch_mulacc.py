"""The host side of the unsplit switch core (``csrc/ntt_mulacc.cu``, kernel
#4 ``ntt_mulacc``), on the CPU: no card, no JAX.

- a replay of the kernel's order: per part group, each part's cluster
  transform (the forward replay of ``test_torch_bfly.py``, its words as
  the last pass leaves them in shared memory), each thread's word pairs
  read as the kernel reads them, both key products, the group's sums in
  part order, then the combine of the groups' sums, gives
  ``ntt_mulacc_plain``'s words bit for bit: at logN 8 with K forced to 1,
  2, 4 and 8 and G in {1, 2, P}, and at logN 14 and 15 with the kernel's
  own geometry;
- any grouping and order of the part sum gives the twin's words, words at
  the top of [0, 2q) among them;
- the launch geometry fits one H100 at logN 8-15 and fills it at the
  presets' level-1 shapes; the wrapper refuses what the kernel does not
  take.
"""

import numpy as np
import pytest
import torch

from liberate_tpu_torch.fhe import engine
from liberate_tpu_torch.ntt import cuda_ntt, u64
from test_torch_bfly import MAX_CLUSTER, REGS_NEEDED, REGS_PER_SM, \
    SMEM_PER_BLOCK, _plan, _swz, _words, replay_fwd

SEED = 20260818


def _keys(plan, P_full, C0, level, seed):
    """Key stacks [P_full, C0, N] x 2, lazy words below 2q of the plan's
    channel c at key channel level + c (any word below 2^62 elsewhere)."""
    rng = np.random.default_rng(seed)
    bound = np.full(C0, 1 << 62, dtype=np.int64)
    bound[level:level + len(plan.q)] = 2 * plan.q.numpy()
    return tuple(torch.from_numpy(rng.integers(
        0, bound[None, :, None], size=(P_full, C0, 1 << plan.logN),
        dtype=np.int64)) for _ in range(2))


def _top_words(plan, P, seed):
    """Extension words [P, C, N] below 2q, a quarter of them in the top 16
    values of [0, 2q)."""
    x = _words(plan, P, seed)
    rng = np.random.default_rng(seed + 1)
    top = torch.from_numpy(rng.random(tuple(x.shape)) < 0.25)
    q2 = 2 * plan.q[None, :, None]
    near = q2 - 1 - torch.from_numpy(rng.integers(0, 16, tuple(x.shape)))
    return torch.where(top, near, x)


def replay_mulacc(x, k0, k1, plan, level, part_off, geo):
    """The kernel's order on x [P, C, N]: for each part group (g, its
    parts in turn), CTA k of each (part, channel) cluster reads the word
    pairs of its chunk as the kernel does (the aligned pair at
    swz(2i) & ~1, swapped when swz(2i) is odd) and multiplies them by both
    key halves' pairs at word k * M + 2i; the products of the ``held``
    parts a CTA holds at once are summed, then added to the group's sums
    (stored, for a group's first parts); group 0's sums are d0/d1, to
    which the combine adds the other groups' in group order."""
    P, C, N = x.shape
    M = 1 << geo["logM"]
    sh = replay_fwd(x, plan, geo, smem=True)           # [P, C, K, M]
    at = _swz(2 * torch.arange(M // 2))
    v = torch.stack([sh[..., at & ~1], sh[..., (at & ~1) + 1]], -1)
    odd = (at & 1).bool()[:, None]
    words = torch.where(odd, v.flip(-1), v).reshape(P, C, N)
    cons = [t[:, None] for t in cuda_ntt._montmul_consts(plan)]
    q2 = 2 * plan.q[:, None]
    prods = [u64.montmul(words, k[part_off:part_off + P, level:level + C],
                         *cons) for k in (k0, k1)]
    def add(a, b):
        return [b_ if a_ is None else cuda_ntt._cond_sub(a_ + b_, q2)
                for a_, b_ in zip(a, b)]

    sums = []
    for first, end in geo["parts"]:
        s = [None, None]
        for p in range(first, end, geo["held"]):
            t = [None, None]
            for j in range(p, min(p + geo["held"], end)):
                t = add(t, [u[j] for u in prods])
            s = add(s, t)
        sums.append(s)
    d = sums[0]
    for s in sums[1:]:
        d = [cuda_ntt._cond_sub(a + b, q2) for a, b in zip(d, s)]
    return tuple(d)


def _check_replay(logN, P, C, K=None, G=None, held=None, level=1,
                  part_off=1, seed=SEED):
    plan = _plan(logN, C)
    x = _top_words(plan, P, seed)
    k0, k1 = _keys(plan, part_off + P + 1, level + C + 1, level, seed + 2)
    geo = cuda_ntt.mulacc_geometry(logN, P, C, K=K, G=G, held=held)
    got = replay_mulacc(x, k0, k1, plan, level, part_off, geo)
    want = cuda_ntt.ntt_mulacc_plain(x, k0, k1, plan, level, part_off)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return geo


@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_replay_at_logn8_is_the_twin(K, G):
    geo = _check_replay(8, 3, 2, K=K, G=G)
    assert geo["G"] == G and len(geo["parts"]) == G


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("held", [2, 3])
def test_replay_with_parts_held_together_is_the_twin(held, G):
    geo = _check_replay(8, 5, 2, K=2, G=G, held=held)
    assert geo["held"] == held and geo["smem"] == held * (8 << geo["logM"])


@pytest.mark.parametrize("logN", [14, 15])
def test_replay_at_the_kernels_own_geometry(logN):
    torch.set_num_threads(1)
    geo = _check_replay(logN, 3, 2, seed=SEED + logN)
    held = cuda_ntt.MULACC_HELD.get(logN, 1)
    assert geo["takes"] and geo["K"] == cuda_ntt.MULACC_K[logN]
    assert geo["held"] == held and geo["G"] == -(-3 // held)


@pytest.mark.parametrize("G", [1, 2, 3, 5, 13])
def test_any_grouping_and_order_of_the_part_sum_is_the_twins(G):
    """Products in [0, 2q), many at its top: summed in any order and in G
    groups of any sizes, then the groups' sums in any order, with a
    conditional subtract of 2q after each add, they give the sequential
    sum's words."""
    plan = _plan(8, 3)
    P, N = 13, 1 << plan.logN
    prods = _top_words(plan, P, SEED + G)
    q2 = 2 * plan.q[:, None]
    assert bool((prods < q2).all()) and bool((prods >= q2 - 16).any())
    want = prods[0]
    for p in range(1, P):
        want = cuda_ntt._cond_sub(want + prods[p], q2)
    rng = np.random.default_rng(SEED + G)
    for _ in range(4):
        order = rng.permutation(P)
        cuts = np.sort(rng.choice(np.arange(1, P), G - 1, replace=False))
        sums = []
        for grp in np.split(order, cuts):
            s = prods[grp[0]]
            for p in grp[1:]:
                s = cuda_ntt._cond_sub(s + prods[p], q2)
            sums.append(s)
        got = None
        for i in rng.permutation(G):
            got = sums[i] if got is None else cuda_ntt._cond_sub(
                got + sums[i], q2)
        assert got.shape == (3, N) and torch.equal(got, want)


@pytest.mark.parametrize("logN", range(cuda_ntt.MIN_LOGN,
                                       cuda_ntt.MULACC_MAX_LOGN + 1))
def test_geometry_fits_the_h100(logN):
    """The wrapper's launch at logN on the silver and bronze level-1 shapes
    and on one part of one channel: the chunks held in one CTA's shared
    memory, a portable cluster, 128 registers a thread, at least one
    cross-chunk column a thread, a group of ``held`` parts a cluster."""
    assert cuda_ntt.MULACC_MAX_LOGN == engine.FUSED_SWITCH_MAX_LOGN
    for P, C in ((9, 18), (7, 8), (1, 1)):
        g = cuda_ntt.mulacc_geometry(logN, P, C)
        K, t = g["K"], g["threads"]
        assert g["takes"] and g["columns"] >= 1
        assert K == cuda_ntt.MULACC_K.get(logN, 1) <= MAX_CLUSTER
        held = cuda_ntt.MULACC_HELD.get(logN, 1)
        assert g["held"] == held
        assert g["smem"] == held * (8 << g["logM"]) <= SMEM_PER_BLOCK
        assert t % 32 == 0 and t * REGS_NEEDED * g["per_sm"] <= REGS_PER_SM
        assert g["per_sm"] * (g["smem"] + 1024) <= cuda_ntt.SM_SMEM
        assert g["G"] == -(-P // held)
        assert [p for a, b in g["parts"] for p in range(a, b)] \
            == list(range(P))
        assert max(b - a for a, b in g["parts"]) == min(held, P)
        assert g["ctas"] == g["G"] * K * C


def test_geometry_at_the_presets():
    """Silver (P=9, C_sp=18, logN 15) and bronze (P=7, C_sp=8, logN 14) at
    level 1: two parts a cluster of eight 128-thread CTAs, each CTA holding
    both parts' chunks (720 CTAs, three an SM), and a part a cluster of
    four (224 CTAs, four an SM)."""
    silver = cuda_ntt.mulacc_geometry(15, 9, 18)
    assert (silver["K"], silver["G"], silver["held"], silver["threads"],
            silver["ctas"], silver["per_sm"]) == (8, 5, 2, 128, 720, 3)
    assert silver["parts"] == [(0, 1), (1, 3), (3, 5), (5, 7), (7, 9)]
    bronze = cuda_ntt.mulacc_geometry(14, 7, 8)
    assert (bronze["K"], bronze["G"], bronze["threads"], bronze["ctas"],
            bronze["per_sm"]) == (4, 7, 128, 224, 4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="logN 8-15"):
        cuda_ntt.mulacc_geometry(16, 10, 38)
    small = cuda_ntt.prime_plan(7, 1, "cpu")
    x = _words(small, 2)
    k0, k1 = _keys(small, 2, 1, 0, SEED)
    with pytest.raises(ValueError, match="logN 8-15"):
        cuda_ntt.ntt_mulacc(x, k0, k1, small, 0, 0)
    with pytest.raises(ValueError, match="part groups"):
        cuda_ntt.mulacc_geometry(8, 3, 2, G=4)
    # forced geometries the kernel refuses: a chunk beyond one CTA, or no
    # cross-chunk column for a thread
    assert not cuda_ntt.mulacc_geometry(15, 9, 18, K=1)["takes"]
    assert not cuda_ntt.mulacc_geometry(8, 3, 2, K=8)["takes"]
