"""The plain twins of the port's four butterfly CUDA kernels against the
Pallas kernels they replace, run in interpret mode on the CPU: bit-exact,
with the Shoup-form twiddle planes (the Pallas plan's default). Also
against the XLA ``ops`` path, which uses Montgomery twiddles: equal mod q.

logN 8, the 4 with-special channels of level 2 (C <= 4)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liberate_tpu import config
from liberate_tpu.fhe.context.ckks_context import CkksContext
from liberate_tpu.ntt import ops, pallas_ntt, u64
from liberate_tpu.ntt.ntt_context import NttContext
from liberate_tpu_torch.fhe.context.ckks_context import \
    CkksContext as TorchCkksContext
from liberate_tpu_torch.ntt import cuda_ntt
from liberate_tpu_torch.ntt import ops as torch_ops
from liberate_tpu_torch.ntt.ntt_context import NttContext as TorchNttContext

PARAMS = dict(logN=8, scale_bits=30, num_scales=3, num_special_primes=2,
              is_secured=False)
LEVEL = 2


@pytest.fixture(scope="module")
def setup():
    ctx = CkksContext(**PARAMS)
    nc = NttContext(ctx)
    start, stop = nc.channel_range(LEVEL, -2)
    use_pallas = config.use_pallas
    config.use_pallas = True
    try:
        assert config.use_shoup_twiddles
        plan = nc._maybe_pallas_plan(np.arange(start, stop))
    finally:
        config.use_pallas = use_pallas
    tnc = TorchNttContext(TorchCkksContext(**PARAMS), "cpu")
    tpack = tnc.level_pack(LEVEL, -2)
    q = np.array(ctx.q[start:stop], dtype=np.int64)
    return dict(ctx=ctx, plan=plan, xla_pack=nc.level_pack(LEVEL, -2),
                tpack=tpack, tplan=tpack.plan, q=q, C=stop - start, N=ctx.N)


def _data(s, B, seed=7, lazy=False):
    """Words below q, or below 2q (``lazy``) where the path feeds the
    kernel lazily reduced words."""
    rng = np.random.default_rng(seed)
    m = s["q"][:, None] * (2 if lazy else 1)
    return (rng.integers(0, 1 << 62, size=(B, s["C"], s["N"])) % m
            ).astype(np.int64)


def _packed(a):
    """int64 [..., C, N] -> the reference's packed [2, ..., C, N]."""
    return jnp.asarray(u64.from_int64_np(a))


def _words(packed):
    return u64.to_int64_np(np.asarray(packed))


@pytest.mark.parametrize("pre_enter,post_reduce,B", [
    (True, False, 2),       # enter_ntt, batched as in _cc_mult_core
    (False, True, 1),
])
def test_ntt_fwd_twin_matches_pallas(setup, pre_enter, post_reduce, B):
    a = _data(setup, B, lazy=not pre_enter)
    want = _words(pallas_ntt.ntt(_packed(a), setup["plan"],
                                 pre_enter=pre_enter,
                                 post_reduce=post_reduce, interpret=True))
    got = cuda_ntt.ntt_fwd_plain(torch.from_numpy(a), setup["tplan"],
                                 pre_enter=pre_enter, post_reduce=post_reduce)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("post_exit,post_reduce,no_norm,B", [
    (True, True, False, 3),     # intt_exit_reduce, batched as in _relin_pre
    (True, False, False, 2),    # intt_exit (encrypt, decrypt)
    (False, True, False, 1),    # intt_reduce (after the key switch)
    (False, False, True, 2),    # the coefficient-sharded inverse's locals
], ids=["True-True-3", "True-False-2", "False-True-1", "no_norm-2"])
def test_ntt_inv_twin_matches_pallas(setup, post_exit, post_reduce, no_norm,
                                     B):
    a = _data(setup, B, lazy=True)
    want = _words(pallas_ntt.intt(_packed(a), setup["plan"],
                                  post_exit=post_exit,
                                  post_reduce=post_reduce, no_norm=no_norm,
                                  interpret=True))
    got = cuda_ntt.ntt_inv_plain(torch.from_numpy(a), setup["tplan"],
                                 post_exit=post_exit, post_reduce=post_reduce,
                                 no_norm=no_norm)
    assert np.array_equal(got.numpy(), want)
    if no_norm:
        assert torch.equal(cuda_ntt.ntt_inv(torch.from_numpy(a),
                                            setup["tplan"], no_norm=True),
                           got)
        with pytest.raises(ValueError):
            cuda_ntt.ntt_inv(torch.from_numpy(a), setup["tplan"],
                             post_reduce=True, no_norm=True)


def test_ksk_mulacc_twin_matches_pallas(setup):
    """The phase-split switch core (Shoup extension: no canon pre-stage):
    forward NTT of P=3 parts, then the key products accumulated over parts
    with the key read at (part_off + p, level + c) of the full stacks."""
    P, part_off, P_full = 3, 1, 4
    C, N = setup["C"], setup["N"]
    ctx = setup["ctx"]
    C0 = len(ctx.q)
    rng = np.random.default_rng(3)
    ext = np.stack([_data(setup, 1, seed=10 + p, lazy=True)[0]
                    for p in range(P)])
    qs = np.array(ctx.q, dtype=np.int64)
    k0, k1 = ((rng.integers(0, 1 << 62, size=(P_full, C0, N))
               % (2 * qs[:, None])).astype(np.int64) for _ in range(2))
    ident = jnp.zeros((2, C), jnp.uint32)     # unused without the canon
    want0, want1 = pallas_ntt._ntt_ksk_accum_split(
        _packed(ext), _packed(k0), _packed(k1), setup["plan"], ident, LEVEL,
        part_off, interpret=True, canon=False)
    x = cuda_ntt.ntt_fwd_plain(torch.from_numpy(ext), setup["tplan"])
    got0, got1 = cuda_ntt.ksk_mulacc_plain(
        x, torch.from_numpy(k0), torch.from_numpy(k1), setup["tplan"],
        LEVEL, part_off)
    assert np.array_equal(got0.numpy(), _words(want0))
    assert np.array_equal(got1.numpy(), _words(want1))


def test_ntt_mulacc_twin_matches_fused_pallas(setup, monkeypatch):
    """The unsplit switch core (#4, ``_ntt_mulacc_kernel``), as the JAX
    engine runs it with ``use_split_switch`` off and ``use_fused_switch``
    on, without the canon pre-stage (Shoup extension): the same P=3 parts
    and key placement as the split test above. The flags are set here
    because another test file leaves ``use_fused_switch`` off behind it."""
    P, part_off, P_full = 3, 1, 4
    ctx = setup["ctx"]
    C0, N = len(ctx.q), setup["N"]
    rng = np.random.default_rng(4)
    ext = np.stack([_data(setup, 1, seed=20 + p, lazy=True)[0]
                    for p in range(P)])
    qs = np.array(ctx.q, dtype=np.int64)
    k0, k1 = ((rng.integers(0, 1 << 62, size=(P_full, C0, N))
               % (2 * qs[:, None])).astype(np.int64) for _ in range(2))
    monkeypatch.setattr(config, "use_split_switch", False)
    monkeypatch.setattr(config, "use_fused_switch", True)

    def split(*args, **kw):
        raise AssertionError("the split switch core ran instead of #4")

    monkeypatch.setattr(pallas_ntt, "_ntt_ksk_accum_split", split)
    assert pallas_ntt.supports_fused_accum(setup["plan"])
    ident = jnp.zeros((2, setup["C"]), jnp.uint32)  # unused without canon
    want0, want1 = pallas_ntt.ntt_ksk_accum(
        _packed(ext), _packed(k0), _packed(k1), setup["plan"], ident, LEVEL,
        part_off, interpret=True, canon=False)
    got0, got1 = cuda_ntt.ntt_mulacc_plain(
        torch.from_numpy(ext), torch.from_numpy(k0), torch.from_numpy(k1),
        setup["tplan"], LEVEL, part_off)
    assert np.array_equal(got0.numpy(), _words(want0))
    assert np.array_equal(got1.numpy(), _words(want1))


@pytest.mark.parametrize("op", ["ntt", "enter_ntt", "intt",
                                "intt_exit_reduce", "intt_no_norm"])
def test_twins_equal_xla_ops_mod_q(setup, op):
    """The XLA path runs Montgomery twiddles: other lazy representatives,
    the same values mod q (and identical words once reduced). The
    no-normalise inverse goes through the port's ``ops.intt_no_norm``."""
    a = _data(setup, 1)[0]
    want = _words(getattr(ops, op)(_packed(a), setup["xla_pack"]))
    tplan, ta = setup["tplan"], torch.from_numpy(a)
    got = {
        "ntt": lambda: cuda_ntt.ntt_fwd(ta, tplan),
        "enter_ntt": lambda: cuda_ntt.ntt_fwd(ta, tplan, pre_enter=True),
        "intt": lambda: cuda_ntt.ntt_inv(ta, tplan),
        "intt_exit_reduce": lambda: cuda_ntt.ntt_inv(
            ta, tplan, post_exit=True, post_reduce=True),
        "intt_no_norm": lambda: torch_ops.intt_no_norm(ta, setup["tpack"]),
    }[op]().numpy()
    q = setup["q"][:, None]
    assert np.array_equal(got % q, want % q)
    if op == "intt_exit_reduce":
        assert np.array_equal(got, want)


def test_wrappers_take_twins_only_on_cpu(setup):
    """On a CPU tensor a wrapper runs its twin and counts no launch; on a
    device with no kernel it raises instead of falling back."""
    tplan = setup["tplan"]
    a = torch.from_numpy(_data(setup, 2))
    k = torch.from_numpy(_data(setup, 2, seed=8, lazy=True)).reshape(
        2, setup["C"], -1)
    cuda_ntt.reset_launches()
    assert torch.equal(cuda_ntt.ntt_fwd(a, tplan, pre_enter=True),
                       cuda_ntt.ntt_fwd_plain(a, tplan, pre_enter=True))
    assert torch.equal(cuda_ntt.ntt_inv(a, tplan, post_exit=True),
                       cuda_ntt.ntt_inv_plain(a, tplan, post_exit=True))
    for fn, twin in ((cuda_ntt.ntt_mulacc, cuda_ntt.ntt_mulacc_plain),
                     (cuda_ntt.ksk_mulacc, cuda_ntt.ksk_mulacc_plain)):
        assert torch.equal(torch.stack(fn(a, k, k, tplan, 0, 0)),
                           torch.stack(twin(a, k, k, tplan, 0, 0)))
    assert torch.equal(cuda_ntt.ntt_inv(a, tplan, no_norm=True),
                       cuda_ntt.ntt_inv_plain(a, tplan, no_norm=True))
    assert cuda_ntt.launches == {"ntt_fwd": 0, "ntt_inv": 0,
                                 "ntt_inv_no_norm": 0, "ksk_mulacc": 0,
                                 "ntt_mulacc": 0}
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_ntt.ntt_fwd(a.to("meta"), tplan)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_ntt.ntt_mulacc(a.to("meta"), k.to("meta"), k.to("meta"), tplan,
                            0, 0)
