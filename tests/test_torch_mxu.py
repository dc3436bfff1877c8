"""The port's tensor-core ("MXU") NTT domain against the JAX package, on the
CPU, at logN 8 with 40-bit scale primes (3 scales, 2 special primes): the
same two width groups as silver, (6, 6) digits with a high recombination
part for the scale primes and (8, 8) for the base and special primes.

- the port's tables equal the JAX package's ``mxu_ntt.make_plan``;
- the twins of the forward (``enter``) and inverse (``exitx``) kernels are
  bit-exact with ``mxu_pallas`` in interpret mode, over all 6 channels;
- at logN 17 (platinum's S = 512, R = 256), on one 40-bit and one 60-bit
  prime: the port's tables equal the JAX ``make_plan``'s, and the
  forward (``enter``) and inverse (``exitx``) twins equal the JAX
  package's XLA composition (``mxu_ntt.ntt`` and ``intt_no_norm_factor``
  over the plan with the m1e and i2x tables in place of m1 and i2) mod q,
  the forward also bit for bit: the composition recombines in Montgomery
  form, the twins in the kernels' Shoup form, and the inverse's lazy
  representatives differ;
- the slice: keys and a ciphertext made by the port's MXU engine, carried
  to a JAX engine on its MXU kernel path (interpret mode), which runs only
  ``mult`` (the B=4 ``enter`` transform, the B=3 ``exitx`` + reduce
  inverse, and the fused switch in both modes): its output is bit-identical
  to the port's ``mult`` on each switch route (folded; unfolded, as at
  logN 16, forced through ``engine.FOLD_MAX_LOGN``; Montgomery-form key,
  ``use_shoup_ksk=False``), which agree with two special primes.

The JAX engine never runs keygen or encryption here: in interpret mode they
cost tens of seconds.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import liberate_tpu
import liberate_tpu_torch
from liberate_tpu import config
from liberate_tpu.fhe.context.ckks_context import CkksContext, \
    primitive_root_2N
from liberate_tpu.fhe.data_struct import DataStruct as JaxDataStruct
from liberate_tpu.ntt import mxu_ntt, mxu_pallas, u64
from liberate_tpu.ntt.ntt_context import NttContext
from liberate_tpu_torch import interop
from liberate_tpu_torch.fhe import engine as port_engine
from liberate_tpu_torch.fhe.context.prim_test import miller_rabin
from liberate_tpu_torch.ntt import cuda_mxu, ops
from liberate_tpu_torch.ntt import mxu_ntt as port_mxu_ntt

PARAMS = dict(logN=8, scale_bits=40, num_scales=3, num_special_primes=2,
              is_secured=False)
SEED = 20260816
TOL = 1e-4

_FLAGS = ("use_mxu_ntt", "use_mxu_pallas", "use_pallas", "pallas_interpret")


class _MxuKernelPath:
    """The JAX package's accelerator path (MXU domain, Pallas MXU kernels)
    in interpret mode; restores the flags on exit."""

    def __enter__(self):
        self.saved = {f: getattr(config, f) for f in _FLAGS}
        for f in _FLAGS:
            setattr(config, f, True)

    def __exit__(self, *exc):
        for f, v in self.saved.items():
            setattr(config, f, v)


@pytest.fixture(scope="module")
def port():
    te = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                       seed=SEED, **PARAMS)
    sk = te.create_secret_key()
    pk = te.create_public_key(sk)
    evk = te.create_evk(sk)
    rng = np.random.default_rng(5)
    m = rng.uniform(-1, 1, te.num_slots) + 1j * rng.uniform(
        -1, 1, te.num_slots)
    ct = te.encorypt(m, pk)
    saved, port_engine.FOLD_MAX_LOGN = port_engine.FOLD_MAX_LOGN, 0
    try:
        unfolded = te.mult(ct, ct, evk)
    finally:
        port_engine.FOLD_MAX_LOGN = saved
    tm = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                       use_shoup_ksk=False, seed=SEED,
                                       **PARAMS)
    return dict(te=te, sk=sk, evk=evk, m=m, ct=ct,
                mult=te.mult(ct, ct, evk), unfolded=unfolded,
                mont=tm.mult(ct, ct, evk))


@pytest.fixture(scope="module")
def jax_ctx():
    ctx = CkksContext(**PARAMS)
    with _MxuKernelPath():
        pack = NttContext(ctx).level_pack(0, -2)
    assert len(pack.mxu.groups) == 2
    return ctx, pack


def _words(packed):
    return u64.to_int64_np(np.asarray(packed))


def _lazy(q, B, N, seed):
    """Words below 2q, as the path feeds the transforms."""
    rng = np.random.default_rng(seed)
    q = np.array(q, dtype=np.int64)[:, None]
    return (rng.integers(0, 1 << 62, size=(B, q.shape[0], N))
            % (2 * q)).astype(np.int64)


@pytest.mark.parametrize("group", [0, 1])
def test_tables_equal_jax_make_plan(port, group):
    ctx = port["te"].ctx
    lo, hi, plan = port["te"].ntt.mxu_groups[group]
    dA, dB = (6, 6) if group == 0 else (8, 8)
    assert (plan.dA, plan.dB) == (dA, dB)
    qs = ctx.q[lo:hi]
    psis = [primitive_root_2N(q, ctx.N) for q in qs]
    want = mxu_ntt.make_plan(
        ctx.logN, qs, [ctx.R % q for q in qs], psis,
        [pow(p, -1, q) for p, q in zip(psis, qs)],
        [pow(ctx.N, -1, q) for q in qs], word_bits=ctx.buffer_bit_length,
        dA=dA, dB=dB)
    C = hi - lo
    assert (want["S"], want["R"], want["split"]) == (plan.S, plan.R,
                                                     plan.split)
    for name in ("m1", "m1e", "m2", "i1", "i2", "i2x"):
        w = np.asarray(want[name])
        assert np.array_equal(getattr(plan, name).numpy(),
                              w.reshape(C, -1, w.shape[-1])), name
        assert np.array_equal(getattr(plan, name + "_rs").numpy(),
                              np.asarray(want[name + "_rs"]).reshape(C, -1))
    for name in ("tw", "itw", "bp", "whi", "wphi", "corr"):
        assert np.array_equal(getattr(plan, name).numpy(),
                              _words(want[name])), name


LOGN17 = 17
R62 = 1 << 62


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
def _logn17(bits):
    """For one prime width (40 or 60 bits): the prime, the port's plan and
    the JAX package's make_plan dict at logN 17, built once per worker and
    width that a test needs."""
    N = 1 << LOGN17
    q = _top_prime(LOGN17, bits)
    dA, dB = port_mxu_ntt.channel_digit_params(q)
    psi = primitive_root_2N(q, N)
    with _one_thread():
        plan = port_mxu_ntt.make_plan(
            LOGN17, [q], [(-pow(q, -1, R62)) % R62], [psi], "cpu", dA, dB)
    want = mxu_ntt.make_plan(LOGN17, [q], [R62 % q], [psi],
                             [pow(psi, -1, q)], [pow(N, -1, q)],
                             word_bits=62, dA=dA, dB=dB)
    return q, plan, want


@pytest.mark.parametrize("bits", [40, 60])
def test_tables_equal_jax_make_plan_at_logn17(bits):
    q, plan, want = _logn17(bits)
    assert (plan.S, plan.R) == (want["S"], want["R"]) == (512, 256)
    assert (plan.dA, plan.split) == (want["dA"], want["split"]) == (
        (6, 5) if bits == 40 else (8, 5))
    for name in ("m1", "m1e", "m2", "i1", "i2", "i2x"):
        w = np.asarray(want[name])
        assert np.array_equal(getattr(plan, name).numpy(),
                              w.reshape(1, -1, w.shape[-1])), name
        assert np.array_equal(getattr(plan, name + "_rs").numpy(),
                              np.asarray(want[name + "_rs"]).reshape(1, -1))
    for name in ("tw", "itw", "bp", "whi", "wphi", "corr"):
        assert np.array_equal(getattr(plan, name).numpy(),
                              _words(want[name])), name


@pytest.mark.parametrize("inverse, bits", [(False, 40), (True, 60)],
                         ids=["fwd_enter_40", "inv_exitx_60"])
def test_transform_twins_equal_xla_composition_at_logn17(inverse, bits):
    """#5 with ``enter`` on the 40-bit channel and #6 with ``exitx`` on the
    60-bit one (XLA's int8 products take 5-8 s a transform here), B=1,
    against the XLA composition over the plan with m1e for m1 (the
    transform of a*R) or i2x for i2 (with the Montgomery exit): equal mod
    q, and the forward bit for bit (the inverse's words are other lazy
    representatives in about half the coefficients)."""
    q, plan, want = _logn17(bits)
    k = (-pow(q, -1, R62)) % R62
    h = 31
    jplan = mxu_ntt.plan_from_dict(
        {f: v if isinstance(v, int) else jnp.asarray(v)
         for f, v in want.items()},
        *(jnp.asarray(np.array([v], dtype=np.uint32))
          for v in (q & (1 << h) - 1, q >> h, k & (1 << h) - 1, k >> h)),
        jnp.asarray(u64.from_int64_np(np.array([2 * q]))))
    a = _lazy([q], 1, 1 << LOGN17, seed=bits)
    x = torch.from_numpy(a)
    if inverse:
        want = jax.jit(mxu_ntt.intt_no_norm_factor)(
            jnp.asarray(u64.from_int64_np(a)),
            dataclasses.replace(jplan, i2=jplan.i2x, i2_rs=jplan.i2x_rs))
        with _one_thread():
            got = cuda_mxu.mxu_ntt_inv_plain(x, plan, exitx=True)
    else:
        want = jax.jit(mxu_ntt.ntt)(
            jnp.asarray(u64.from_int64_np(a)),
            dataclasses.replace(jplan, m1=jplan.m1e, m1_rs=jplan.m1e_rs))
        with _one_thread():
            got = cuda_mxu.mxu_ntt_fwd_plain(x, plan, enter=True)
    got, want = got.numpy(), _words(want)
    assert got.min() >= 0 and got.max() < 2 * q
    assert np.array_equal(got % q, want % q)
    if not inverse:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd_enter",
                                                        "inv_exitx"])
def test_transform_twins_match_pallas(port, jax_ctx, inverse):
    """#5 with ``enter`` (keygen, encrypt) and #6 with ``exitx`` (encrypt,
    decrypt), B=2 over all 6 channels, both width groups."""
    ctx, pack = jax_ctx
    a = _lazy(ctx.q, 2, ctx.N, seed=11 + inverse)
    kw = dict(exitx=True) if inverse else dict(enter=True)
    with _MxuKernelPath():
        want = _words(mxu_pallas.dispatch(
            jnp.asarray(u64.from_int64_np(a)), pack.mxu, inverse=inverse,
            interpret=True, **kw))
    tpack = port["te"].pack(0, -2)
    got = cuda_mxu.dispatch(torch.from_numpy(a), tpack.mxu, inverse=inverse,
                            **kw)
    assert np.array_equal(got.numpy(), want)


def _to_jax(ds):
    def build(tree, meta):
        def conv(x):
            if isinstance(x, tuple) and len(x) == 2 \
                    and isinstance(x[1], dict):
                return build(*x)
            if isinstance(x, (tuple, list)):
                return type(x)(conv(t) for t in x)
            return jnp.asarray(x)
        return JaxDataStruct(conv(tree), **meta)
    return build(*interop.to_reference_arrays(ds))


def test_mult_bit_identical_to_jax_mxu_kernels(port):
    """The slice: the JAX engine on its MXU kernel path multiplies the
    port's ciphertext with the port's evk; the words equal the port's, on
    each switch route."""
    with _MxuKernelPath():
        je = liberate_tpu.CkksEngine(seed=SEED, **PARAMS)
        assert je._mxu_fused_switch()
        ct = _to_jax(port["ct"])
        out = je.mult(ct, ct, _to_jax(port["evk"]))
    assert out.level == port["mult"].level == 1
    for route in ("mult", "unfolded", "mont"):
        for j, t in zip(out.data, port[route].data):
            assert np.array_equal(_words(j), t.numpy()), route


def test_mult_decrode_error(port):
    te = port["te"]
    err = abs(te.absmax_error(te.decrode(port["mult"], port["sk"]),
                              port["m"] * port["m"]))
    assert err < TOL


def test_mxu_packs_carry_no_butterfly_tables(port):
    """An MXU engine's packs carry no butterfly tables, so the butterfly
    kernels cannot be reached from it, and a pack without tables raises;
    on the CPU the tensor-core wrappers run their twins and count no
    launch."""
    te = port["te"]
    for level, mult_type in ((0, -2), (1, -1)):
        pack = te.pack(level, mult_type)
        assert pack.plan is None and pack.mxu is not None
    cuda_mxu.reset_launches()
    te.mult(port["ct"], port["ct"], port["evk"])
    assert cuda_mxu.launches == dict.fromkeys(cuda_mxu.launches, 0)
    with pytest.raises(ValueError, match="no transform tables"):
        ops.ntt(port["ct"].data[0], te.ntt.make_pack(0, 1, with_plan=False))
