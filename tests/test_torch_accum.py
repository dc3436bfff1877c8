"""The tensor-core switch core from extension words (#7 and #8 of the kernel
table) against the JAX package, on the CPU, at logN 8 with 40-bit scale
primes (the silver width groups (6, 6) and (8, 8)), Montgomery-form keys:

- the #8 twin (``mxu_ksk_accum_inv_plain``) is bit-exact with
  ``mxu_pallas.dispatch_ksk_accum(fold_inverse=True)`` in interpret mode,
  over one width group (one interpret-mode Pallas call);
- the #7 twin equals, mod q, the XLA composition the JAX package checks
  its own #7 kernel against (``benchmarks/ntt_probe10.py``:
  ``mxu_ntt.ntt``, ``ops.mont_mult``, ``ops.mont_add``, no Pallas): the
  JAX #7 kernel reads an argument it does not have and cannot be traced;
- the #6 twin (inverse with the reduce) of #7's output is #8's, bit for
  bit, over both width groups;
- the extension, #8 and the separate mod-down give the words of the
  engine's switch (#9 then the mod-down) with the Montgomery-form key;
- on the CPU the wrappers run their twins and count no launch; a
  Shoup-form key raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liberate_tpu_torch
from liberate_tpu import config
from liberate_tpu.fhe.context.ckks_context import CkksContext
from liberate_tpu.ntt import mxu_ntt, mxu_pallas, ops, u64
from liberate_tpu.ntt.ntt_context import NttContext
from liberate_tpu_torch.fhe import engine as port_engine
from liberate_tpu_torch.ntt import cuda_mxu

PARAMS = dict(logN=8, scale_bits=40, num_scales=3, num_special_primes=2,
              is_secured=False)
SEED = 20260816
LEVEL = 1
P, PART_OFF, P_FULL = 3, 1, 4

_FLAGS = ("use_mxu_ntt", "use_mxu_pallas", "use_pallas", "pallas_interpret")


@pytest.fixture(scope="module")
def setup():
    """The port's Montgomery-key MXU engine and its level-1 with-special
    layout (width groups [0, 2) at (6, 6), [2, 5) at (8, 8)); random
    extension words below 2q and Montgomery-form key stacks below 2q."""
    tm = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                       use_shoup_ksk=False, seed=SEED,
                                       **PARAMS)
    groups = tm.pack(LEVEL, -2).mxu
    assert [(g.lo, g.hi, g.plan.dA) for g in groups] == [(0, 2, 6),
                                                          (2, 5, 8)]
    rng = np.random.default_rng(31)
    q_all = np.array(tm.ctx.q, dtype=np.int64)[:, None]
    q = q_all[LEVEL:]
    ext = (rng.integers(0, 1 << 62, size=(P, len(q), tm.ctx.N))
           % (2 * q)).astype(np.int64)
    k0, k1 = ((rng.integers(0, 1 << 62, size=(P_FULL, len(q_all),
                                               tm.ctx.N))
               % (2 * q_all)).astype(np.int64) for _ in range(2))
    return dict(tm=tm, groups=groups, q=q, ext=ext, k0=k0, k1=k1)


def _jax_pack():
    saved = {f: getattr(config, f) for f in _FLAGS}
    try:
        for f in _FLAGS:
            setattr(config, f, True)
        return NttContext(CkksContext(**PARAMS)).level_pack(LEVEL, -2)
    finally:
        for f, v in saved.items():
            setattr(config, f, v)


def _packed(a):
    return jnp.asarray(u64.from_int64_np(a))


def _words(packed):
    return u64.to_int64_np(np.asarray(packed))


def _torch(s, *names):
    return tuple(torch.from_numpy(s[n]) for n in names)


def test_ksk_accum_inv_twin_matches_pallas(setup):
    """#8 over the (6, 6) width group (global channels 1-2)."""
    g = setup["groups"][0]
    ext = setup["ext"][:, g.lo:g.hi]
    o0, o1 = mxu_pallas.dispatch_ksk_accum(
        _packed(ext), _packed(setup["k0"]), _packed(setup["k1"]),
        _jax_pack().mxu, LEVEL, PART_OFF, interpret=True, fold_inverse=True)
    got = cuda_mxu.mxu_ksk_accum_inv_plain(
        torch.from_numpy(ext), *_torch(setup, "k0", "k1"), g.plan,
        LEVEL + g.lo, PART_OFF)
    C, N = ext.shape[1:]
    for half, o in enumerate((o0, o1)):
        assert np.array_equal(got[half].numpy(), _words(o).reshape(C, N))


def test_ksk_accum_twin_equals_xla_composition_mod_q(setup):
    """#7 over both width groups against the forward transform, the key
    products and the part sums composed in XLA (the ntt_probe10 oracle)."""
    pack = _jax_pack()
    k0, k1 = (_packed(setup[k])[:, PART_OFF:, LEVEL:] for k in ("k0", "k1"))
    x = mxu_ntt.ntt(_packed(setup["ext"]), pack.mxu.resolve())
    t0, t1 = ops.mont_mult(x, k0, pack), ops.mont_mult(x, k1, pack)
    w0, w1 = t0[:, 0], t1[:, 0]
    for p in range(1, P):
        w0 = ops.mont_add(w0, t0[:, p], pack)
        w1 = ops.mont_add(w1, t1[:, p], pack)
    got = cuda_mxu.dispatch_ksk_accum(
        *_torch(setup, "ext", "k0", "k1"), setup["groups"], LEVEL, PART_OFF)
    q = setup["q"]
    for half, w in enumerate((w0, w1)):
        assert np.array_equal(got[half].numpy() % q, _words(w) % q)


def test_inverse_of_ksk_accum_is_ksk_accum_inv(setup):
    """#6 (inverse, reduce) after #7 gives #8's words, both width groups."""
    args = (*_torch(setup, "ext", "k0", "k1"), setup["groups"], LEVEL,
            PART_OFF)
    ntt_out = cuda_mxu.dispatch_ksk_accum(*args)
    coef = cuda_mxu.dispatch_ksk_accum(*args, fold_inverse=True)
    assert torch.equal(cuda_mxu.dispatch(ntt_out, setup["groups"],
                                         inverse=True, post_reduce=True),
                       coef)
    assert bool((ntt_out < 2 * torch.from_numpy(setup["q"])).all())


def test_switch_core_path_equals_engine_switch(setup):
    """The port's Shoup extension of a random level-1 polynomial, #8 and
    the separate Shoup mod-down give the words of the engine's switch
    (#9, whose fused extension makes the same [0, 2q) representatives)."""
    tm = setup["tm"]
    evk = tm.create_evk(tm.create_secret_key())
    pack_sp = tm.pack(LEVEL, -2)
    q = tm.pack(LEVEL, -1).q.numpy()[:, None]
    a = torch.from_numpy(np.random.default_rng(37).integers(
        0, 1 << 62, size=(len(q), tm.ctx.N)) % q)
    parts = tm.ntt.parts(LEVEL)
    ext = torch.stack([port_engine._extend_shoup(
        port_engine._pre_extend(a, p.local_start, p.alpha, p),
        p.L_enter_sh, pack_sp, tm.bp_sp[LEVEL], LEVEL) for p in parts])
    d = cuda_mxu.dispatch_ksk_accum(ext, *tm._ksk_stacked(evk), pack_sp.mxu,
                                    LEVEL, parts[0].part_id,
                                    fold_inverse=True)
    got = port_engine._mod_down_shoup(
        d, pack_sp, tm.pack(LEVEL, -1), tm.PiWs[LEVEL], tm.bp_sp[LEVEL][0],
        tm.num_special)
    want = tm._switch_mxu(a, evk, LEVEL)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ksk_accum_wrappers_take_twins_only_on_cpu(setup):
    ext, k0, k1 = _torch(setup, "ext", "k0", "k1")
    g = setup["groups"][1]
    x = ext[:, g.lo:g.hi]
    cuda_mxu.reset_launches()
    for fold in (False, True):
        twin = (cuda_mxu.mxu_ksk_accum_inv_plain if fold
                else cuda_mxu.mxu_ksk_accum_plain)
        assert torch.equal(
            cuda_mxu.mxu_ksk_accum(x, k0, k1, g.plan, LEVEL + g.lo, PART_OFF,
                                   fold_inverse=fold),
            twin(x, k0, k1, g.plan, LEVEL + g.lo, PART_OFF))
    assert cuda_mxu.launches == dict.fromkeys(cuda_mxu.launches, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_mxu.mxu_ksk_accum(x.to("meta"), k0.to("meta"), k1.to("meta"),
                               g.plan, LEVEL + g.lo, PART_OFF)
    with pytest.raises(ValueError, match="Montgomery-form key only"):
        cuda_mxu.dispatch_ksk_accum(ext, (k0, k0), (k1, k1),
                                    setup["groups"], LEVEL, PART_OFF)
