"""The host side of the port's tensor-core stage kernel (``csrc/mxu.cuh``),
on the CPU: no card, no JAX.

- the launch geometry (tile, grid, ring depth, shared memory, registers)
  of every stage the port launches, for d in {4, 6, 8} at logN 8 and 14
  to 17 (platinum's 512-point side), fits one H100 block;
- the ring schedule covers every table column exactly once, and the TMA
  tensor map's tiles, read through its dims and strides from the flat
  table, are the canonical table's rows and columns;
- replaying the schedule (table tiles by the tensor map, digit tiles by
  the producer's rule) and recombining gives the twins' words, at logN 8
  and on one logN 17 channel per digit width (6 and 8);
- the wrappers raise on shapes and layouts the kernel does not take, and
  still run the twins for CPU tensors.
"""

import contextlib
import functools

import pytest
import torch

import liberate_tpu_torch
from liberate_tpu_torch.fhe.context.ckks_context import primitive_root_2N
from liberate_tpu_torch.fhe.context.prim_test import miller_rabin
from liberate_tpu_torch.ntt import cuda_mxu, mxu_ntt, u64
from liberate_tpu_torch.ntt.mxu_ntt import MxuPlan

SMEM_PER_BLOCK = 232448   # bytes a block may use on an H100
REGS_PER_SM = 65536
MAX_REGS = 255


def _sides(logN):
    S = 1 << ((logN + 1) // 2)
    return S, (1 << logN) // S


@pytest.fixture(scope="module")
def plans():
    """The logN 8 tensor-core plans of the port, one per digit count
    (scale 30: (4, 4) and (8, 8) groups; scale 40: (6, 6))."""
    out = {}
    for sb in (30, 40):
        eng = liberate_tpu_torch.CkksEngine(
            device="cpu", logN=8, scale_bits=sb, num_scales=3,
            num_special_primes=2, is_secured=False, seed=3, use_mxu_ntt=True)
        for g in eng.pack(0, -2).mxu:
            out.setdefault(g.plan.dA, g.plan)
    assert sorted(out) == [4, 6, 8]
    return out


@contextlib.contextmanager
def _one_thread():
    """Torch on one thread: under the suite's parallel workers, torch's
    threads on logN 17 arrays (above its parallel grain) oversubscribe the
    cores, and a plan build took minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _top_prime(logN, bits):
    """The largest prime q = 1 (mod 2N) below 2^bits."""
    m = 2 << logN
    q = ((1 << bits) - 1) // m * m + 1
    while not miller_rabin(q):
        q -= m
    return q


@functools.lru_cache(maxsize=None)
def _plan17(d):
    """A one-channel plan of logN 17's shapes (S = 512, R = 256) at d
    digits, for the kernel's host side: the constants of a 40-bit (d = 6)
    or 60-bit (d = 8) prime q = 1 (mod 2^18), taken from its logN 8 plan,
    and random int8 tables with their row sums (the replay and the tiles
    hold for any table; logN 17's own tables are held against the JAX
    package in tests/test_torch_mxu.py)."""
    q = _top_prime(17, {6: 40, 8: 60}[d])
    assert mxu_ntt.channel_digit_params(q) == (d, d)
    small = mxu_ntt.make_plan(8, [q], [(-pow(q, -1, 1 << 62)) % (1 << 62)],
                              [primitive_root_2N(q, 1 << 8)], "cpu", d, d)
    gen = torch.Generator().manual_seed(d)
    t = dict(small.tensors())
    for name in ("m1", "m1e", "m2", "i1", "i2", "i2x"):
        side = 256 if name in ("m2", "i1") else 512
        with _one_thread():
            t[name] = torch.randint(-128, 128, (1, d * side, d * side),
                                    generator=gen, dtype=torch.int8)
            t[name + "_rs"] = (128 * t[name].sum(-1, dtype=torch.int64)).to(
                torch.int32)
    t["tw"] = t["itw"] = torch.zeros((1, 512, 256), dtype=torch.int64)
    return MxuPlan(256, 512, d, d, small.split, **t)


@pytest.mark.parametrize("logN", [8, 14, 15, 16, 17])
@pytest.mark.parametrize("d", [4, 6, 8])
def test_stage_geometry_fits_one_block(d, logN):
    S, R = _sides(logN)
    C, P = 38, 10
    plan = type("Shape", (), dict(S=S, R=R, dA=d, num_channels=C))
    launches = (cuda_mxu.transform_geometry(plan, 4)
                + cuda_mxu.transform_geometry(plan, 3, inverse=True)
                + cuda_mxu.switch_geometry(plan, P))
    shapes = [(S, S, R, 4, False), (R, R, S, 4, False), (R, R, S, 3, False),
              (S, S, R, 3, False), (S, S, R, P, False), (R, R, S, P, True),
              (R, R, S, 2, False), (S, S, R, 2, False)]
    for g, (O, K, J, B, ksum) in zip(launches, shapes):
        to = g["tile_o"]
        assert to == (16 if ksum and d == 8 else 32)
        assert g["threads"] == 3 * 128
        entry, pr, cr = g["regs"]
        # ptxas's count: the 12 warps share 4 sub-partitions of 16384
        assert entry == 16384 // (g["threads"] // 32 // 4 * 32) // 8 * 8
        # setmaxnreg moves registers within the block's allocation
        assert 128 * pr + 256 * cr <= g["threads"] * entry
        assert pr <= entry <= cr <= MAX_REGS and pr % 8 == cr % 8 == 0
        # room beside the live registers for the epilogue's temporaries
        assert g["live_regs"] + 24 <= cr
        assert g["ring"] >= 3 and g["smem"] <= SMEM_PER_BLOCK
        assert g["smem"] >= 1024 + g["x_slots"] * 8 * g["tile_j"] * g["kz"] \
            + g["ring"] * d * to * g["kz"]
        gx, gy, gz = g["grid"]
        assert gz == C and gy * to >= O > (gy - 1) * to
        tiles = gx // (1 if ksum else B)
        assert tiles * g["tile_j"] >= J > (tiles - 1) * g["tile_j"]
        assert g["tx_bytes"] == g["kz"] * min(O, to) * d
        assert g["x_tx_bytes"] == 8 * min(K, 32) * min(J, 128)
        assert g["stages_per_part"] * g["kz"] == d * K


@pytest.mark.parametrize("K", [16, 128, 256, 512])
@pytest.mark.parametrize("d", [4, 6, 8])
def test_schedule_covers_every_table_column_once(d, K):
    seen = []
    for z0, v0, nv, k0, kw in cuda_mxu.stage_schedule(d, K):
        assert nv * kw == cuda_mxu.KZ and z0 == v0 * K + k0
        for zz in range(cuda_mxu.KZ):
            v, k = v0 + zz // kw, k0 + zz % kw
            assert z0 + zz == v * K + k and v < d and k < K
            seen.append(z0 + zz)
    assert sorted(seen) == list(range(d * K))


def _tma_tile(table, tmap, z0, o0, c0):
    """The box at coordinates (z0, o0, c0) of the tensor map over the flat
    table bytes, as [box2, box1, box0]; rows past the dims read as -1."""
    flat = table.reshape(-1)
    (d0, d1, d2), (s1, s2), (b0, b1, b2) = (tmap["dims"], tmap["strides"],
                                            tmap["box"])
    if o0 + b1 <= d1 and c0 + b2 <= d2 and z0 + b0 <= d0:
        return flat.as_strided((b2, b1, b0), (s2, s1, 1),
                               c0 * s2 + o0 * s1 + z0)
    out = torch.full((b2, b1, b0), -1, dtype=flat.dtype)
    for i2 in range(b2):
        for i1 in range(b1):
            if o0 + i1 < d1 and c0 + i2 < d2 and z0 + b0 <= d0:
                at = (c0 + i2) * s2 + (o0 + i1) * s1 + z0
                out[i2, i1] = flat[at:at + b0]
    return out


def _check_tiles(plan, table, O, K, ksum=False):
    """Every box the stage's blocks ask for, over every row tile: the
    canonical table's rows and columns of every plane."""
    d, C = plan.dA, plan.num_channels
    g = cuda_mxu.stage_geometry(d, O, K, plan.R, 1, C, ksum=ksum)
    tm = g["tmap"]
    assert tm["box"] == (32, min(O, g["tile_o"]), d)
    assert tm["dims"] == (d * K, O, d * C)
    assert tm["strides"] == (table.stride(1), table.stride(0) // d)
    assert all(s % 16 == 0 for s in tm["strides"]) and max(tm["box"]) <= 256
    rows = tm["box"][1]
    for c in range(C):
        for o0 in range(0, O, rows):
            for z0, *_ in cuda_mxu.stage_schedule(d, K):
                tile = _tma_tile(table, tm, z0, o0, c * d)
                for u in range(d):
                    r0 = u * O + o0
                    assert torch.equal(
                        tile[u], table[c, r0:r0 + rows, z0:z0 + 32])


@pytest.mark.parametrize("d", [4, 6, 8])
def test_tensor_map_tiles_are_the_canonical_table(plans, d):
    plan = plans[d]
    _check_tiles(plan, plan.m1, plan.S, plan.S)


@pytest.mark.parametrize("d", [6, 8])
def test_tensor_map_tiles_at_logn17(d):
    """Platinum's sides: stage 1 of the forward transform (O = K = 512),
    and the key-sum stage over the forward stage-2 table (O = K = 256,
    16-row tiles at 8 digits)."""
    plan = _plan17(d)
    with _one_thread():
        _check_tiles(plan, plan.m1, 512, 512)
        _check_tiles(plan, plan.m2, 256, 256, ksum=True)


def _replay(plan, x):
    """Stage 1 of the forward transform of x [C, S, R] replayed stage by
    stage as the kernel runs it: per row tile and ring stage the table
    tile by the tensor map and the digit tile by the producer's rule,
    summed (in float64: every partial sum is an integer below 2^28, so
    exact), plus the row sums, recombined."""
    d, S, R, C = plan.dA, plan.S, plan.R, plan.num_channels
    g = cuda_mxu.stage_geometry(d, S, S, R, 1, C)
    rows = g["tmap"]["box"][1]
    E = torch.zeros((C, d, S, R), dtype=torch.float64)
    for c in range(C):
        for z0, v0, nv, k0, kw in cuda_mxu.stage_schedule(d, S):
            v = v0 + torch.arange(cuda_mxu.KZ) // kw
            k = k0 + torch.arange(cuda_mxu.KZ) % kw
            digits = ((x[c, k] >> (8 * v)[:, None]) & 0xFF) - 128
            for o0 in range(0, S, rows):
                a = _tma_tile(plan.m1, g["tmap"], z0, o0, c * d)
                E[c, :, o0:o0 + rows] += a.to(torch.float64) @ digits.to(
                    torch.float64)
    E = E.to(torch.int64).reshape(C, d * S, R) \
        + plan.m1_rs.to(torch.int64)[:, :, None]
    return cuda_mxu._recombine(E[None], plan)[0]


def _replay_equals_twin(plan, seed):
    C, S, R = plan.num_channels, plan.S, plan.R
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 62, (C, S, R), generator=gen) % (
        2 * plan.q[:, None, None])
    want = cuda_mxu._recombine(
        cuda_mxu._matmul(plan.m1, plan.m1_rs, x[None], plan.dB), plan)[0]
    assert torch.equal(_replay(plan, x), want)


@pytest.mark.parametrize("d", [4, 6, 8])
def test_schedule_replay_gives_the_twins_words(plans, d):
    _replay_equals_twin(plans[d], d)


@pytest.mark.parametrize("d", [6, 8])
def test_schedule_replay_gives_the_twins_words_at_logn17(d):
    """One platinum channel: 16 row tiles of 32, 2 column tiles of the
    stage's 256 columns replayed whole, K = 512."""
    with _one_thread():
        _replay_equals_twin(_plan17(d), 17 + d)


def test_checks_refuse_what_the_kernel_does_not_take(plans):
    plan = plans[6]
    for R, S in ((8, 8), (512, 1024)):
        bad = MxuPlan(R, S, plan.dA, plan.dB, plan.split, **plan.tensors())
        with pytest.raises(ValueError, match="sides taken"):
            cuda_mxu._check_plan(bad, plan.q.device)
    platinum = MxuPlan(256, 512, plan.dA, plan.dB, plan.split,
                       **plan.tensors())
    cuda_mxu._check_plan(platinum, plan.q.device)
    odd = MxuPlan(plan.R, plan.S, 5, 5, plan.split, **plan.tensors())
    with pytest.raises(ValueError, match="no MXU kernel for digits"):
        cuda_mxu._check_plan(odd, plan.q.device)
    cuda_mxu._check_plan(plan, plan.q.device)
    x = torch.zeros((4, 3, 256), dtype=torch.int64)
    cuda_mxu._check_tma(x, x[:, 1:], x[1:3])
    for bad in (x.reshape(-1)[1:769].reshape(3, 256),
                x.reshape(-1)[:3 * 255].reshape(3, 255),
                torch.zeros((3, 3, 256), dtype=torch.int64)[:, :, 1:]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            cuda_mxu._check_tma(bad)


def test_wrappers_run_the_twins_on_cpu(plans):
    cuda_mxu.reset_launches()
    for d, plan in plans.items():
        C, N = plan.num_channels, plan.S * plan.R
        gen = torch.Generator().manual_seed(10 + d)
        x = torch.randint(0, 1 << 62, (2, C, N), generator=gen) % (
            2 * plan.q[:, None])
        assert torch.equal(cuda_mxu.mxu_ntt_fwd(x, plan, enter=True),
                           cuda_mxu.mxu_ntt_fwd_plain(x, plan, True))
        got = cuda_mxu.mxu_ntt_inv(x, plan, exitx=True, post_reduce=True)
        assert torch.equal(got, cuda_mxu.mxu_ntt_inv_plain(x, plan, True,
                                                           True))
        assert bool((~u64.lt_unsigned(got, plan.q[:, None])).sum() == 0)
    assert cuda_mxu.launches == dict.fromkeys(cuda_mxu.launches, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_mxu.mxu_ntt_fwd(x.to("meta"), plan)
