"""The port's tensor-core key switch without the folded mod-down, against
the JAX package, on the CPU, at logN 8 with 40-bit scale primes (the
silver width groups (6, 6) and (8, 8)).

At logN 16 (gold) the JAX engine does not fold the special-prime mod-down
into its switch kernel: with a Shoup-form key it runs
``_ext_mulacc_inv_kernel_sk``, with a Montgomery-form key
(``config.use_shoup_ksk=False``) ``_ext_mulacc_inv_kernel`` at every logN,
and then the separate ``engine._mod_down_shoup``. Here:

- ``switch_route`` picks the kernel the JAX engine runs;
- the Shoup-key twin equals ``mxu_pallas.dispatch_ksk_from_state`` in
  interpret mode, over both width groups, on random state rows and keys;
- the port's ``_mod_down_shoup`` equals the JAX one (tiled form) with four
  and six special primes, gold's and platinum's counts;
- the standalone mod-down wrapper ``cuda_mxu.mod_down`` (on the CPU its
  twin, the u64.py chain) gives the exact mod-down in integers with one,
  two, four and six special primes, with and without a batch axis and on
  a mesh rank's gathered rows, and refuses what its kernel does not take;
- a JAX engine with Montgomery-form keys switches a random polynomial
  with the port's evk; its words equal the port's switch with the
  Montgomery-form key, and with the Shoup-form key on both routes (the
  unfolded one forced through ``FOLD_MAX_LOGN``); the Montgomery-key twin
  equals the JAX kernel on the inputs that kernel got inside that switch;
- with one, four and six special primes (bronze's, gold's and
  platinum's counts: at one the fold runs bronze's n_sp = 1) the folded
  and unfolded routes leave the same mult words, as with two.

The port's ``mult`` on the unfolded route and with the Montgomery-form key
is held word for word against the JAX MXU engine's ``mult`` in
``test_torch_mxu.py``, which already runs one (a JAX mult costs about
20 s of tracing).

The JAX engine never runs keygen or encryption here, and every Pallas call
in interpret mode costs 4-7 s of tracing and lowering per width group, so
the file makes only two JAX calls that reach Pallas: the Shoup-key
kernel's and one switch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liberate_tpu
import liberate_tpu_torch
from liberate_tpu import config
from liberate_tpu.fhe import engine as jax_engine
from liberate_tpu.fhe.context.ckks_context import CkksContext
from liberate_tpu.fhe.data_struct import DataStruct as JaxDataStruct
from liberate_tpu.ntt import mxu_pallas, u64
from liberate_tpu.ntt.ntt_context import NttContext
from liberate_tpu_torch import interop
from liberate_tpu_torch.fhe import engine as port_engine
from liberate_tpu_torch.ntt import cuda_mxu
from liberate_tpu_torch.parallel import make_mesh, run_ranks

PARAMS = dict(logN=8, scale_bits=40, num_scales=3, num_special_primes=2,
              is_secured=False)
SEED = 20260816
TOL = 1e-4

_FLAGS = ("use_mxu_ntt", "use_mxu_pallas", "use_pallas", "pallas_interpret")


class _MxuKernelPath:
    """The JAX package's accelerator path (MXU domain, Pallas MXU kernels)
    in interpret mode, with the given key form; restores the flags."""

    def __init__(self, shoup_ksk=True):
        self.shoup_ksk = shoup_ksk

    def __enter__(self):
        self.saved = {f: getattr(config, f) for f in _FLAGS + (
            "use_shoup_ksk",)}
        for f in _FLAGS:
            setattr(config, f, True)
        config.use_shoup_ksk = self.shoup_ksk

    def __exit__(self, *exc):
        for f, v in self.saved.items():
            setattr(config, f, v)


class _Unfolded:
    """The port's Shoup-key switch on the unfolded route at any logN."""

    def __enter__(self):
        self.saved = port_engine.FOLD_MAX_LOGN
        port_engine.FOLD_MAX_LOGN = 0

    def __exit__(self, *exc):
        port_engine.FOLD_MAX_LOGN = self.saved


def _words(packed):
    return u64.to_int64_np(np.asarray(packed))


def _limbs(words):
    return jnp.asarray(interop.int64_to_limbs(np.asarray(words)))


def _terms_words(t):
    """JAX u32 extension scalars [P, n, 6, W] -> the port's int64
    [P, n, 3, W] (w, wp, cadj)."""
    t = np.asarray(t)
    return torch.from_numpy(interop.limbs_to_int64(
        np.stack([t[:, :, 0::2], t[:, :, 1::2]])))


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


def _port_run(**kw):
    te = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                       seed=SEED, **PARAMS, **kw)
    sk = te.create_secret_key()
    evk = te.create_evk(sk)
    rng = np.random.default_rng(5)
    m = rng.uniform(-1, 1, te.num_slots) + 1j * rng.uniform(
        -1, 1, te.num_slots)
    ct = te.encorypt(m, te.create_public_key(sk))
    return dict(te=te, sk=sk, evk=evk, m=m, ct=ct)


@pytest.fixture(scope="module")
def port():
    """The Shoup-key engine (mult on the unfolded route) and the
    Montgomery-key engine, from one seed: the same keys and ciphertext."""
    run = _port_run()
    with _Unfolded():
        run["unfolded"] = run["te"].mult(run["ct"], run["ct"], run["evk"])
    mont = _port_run(use_shoup_ksk=False)
    run["tm"] = mont["te"]
    run["mont"] = mont["te"].mult(mont["ct"], mont["ct"], mont["evk"])
    for a, b in zip(run["ct"].data, mont["ct"].data):
        assert torch.equal(a, b)
    return run


@pytest.mark.parametrize("logN, shoup_ksk, kernel", [
    (15, True, "mxu_switch"), (16, True, "mxu_switch_inv"),
    (8, False, "mxu_switch_inv_mont"), (16, False, "mxu_switch_inv_mont"),
    (14, True, "mxu_switch"), (17, True, "mxu_switch_inv"),
    (14, False, "mxu_switch_inv_mont"), (17, False, "mxu_switch_inv_mont")])
def test_switch_route(logN, shoup_ksk, kernel):
    """#11 (fold) / #10 / #9, as the JAX engine's md_ok picks them: bronze
    (logN 14) folds, platinum (logN 17) does not."""
    assert port_engine.switch_route(logN, shoup_ksk) == kernel


def test_shoup_key_twin_matches_pallas(port):
    """#10: level 0 (3 parts, A = 2, both width groups) on random state
    rows and Shoup-form key pairs."""
    te = port["te"]
    level, N = 0, te.ctx.N
    parts = te.ntt.parts(level)
    P, A = len(parts), max(p.alpha for p in parts)
    rng = np.random.default_rng(17)
    st = rng.integers(-(1 << 63), 1 << 63, size=(P, A, N), dtype=np.int64)
    pack0 = te.pack(0, -2)
    q = pack0.q.numpy()[:, None]
    ks = [port_engine._ksk_shoup(torch.from_numpy(
        rng.integers(0, 1 << 62, size=(P, len(q), N)) % (2 * q)), pack0)
        for _ in range(2)]
    terms, off0, _ = te._mxu_switch_tables(level)
    got = cuda_mxu.dispatch_switch_inv(
        torch.from_numpy(st), terms, off0, *ks, te.pack(level, -2).mxu,
        level, parts[0].part_id)

    W = off0.shape[0]
    ctx = CkksContext(**PARAMS)
    with _MxuKernelPath():
        ref = NttContext(ctx).level_pack(level, -2).mxu
    S, R = 16, 16
    tl = interop.int64_to_limbs(terms.numpy())          # [2, P, n, 3, W]
    t6 = np.stack([tl[0], tl[1]], axis=3).reshape(P, -1, 6, W)
    kj = [tuple(_limbs(t.numpy()).reshape(2, P, len(q), R, S) for t in k)
          for k in ks]
    o0, o1 = jax.jit(lambda *a: mxu_pallas.dispatch_ksk_from_state(
        *a, ref, level, parts[0].part_id, W, interpret=True))(
        _limbs(st).reshape(2, P, A, S, R), jnp.asarray(t6), _limbs(off0),
        *kj)
    for half, o in enumerate((o0, o1)):
        assert np.array_equal(got[half].numpy(), _words(o).reshape(W, N))


@pytest.mark.parametrize("n_sp", [4, 6])
def test_mod_down_shoup_matches_jax_special_primes(n_sp):
    """n_sp = 4 (gold) and 6 (platinum) at level 1, on random plain
    [0, q) rows in the tiled form the JAX engine passes after the
    unfolded switch."""
    params = dict(PARAMS, num_special_primes=n_sp)
    te = liberate_tpu_torch.CkksEngine(device="cpu", seed=SEED, **params)
    je = liberate_tpu.CkksEngine(seed=SEED, **params)
    level, N = 1, te.ctx.N
    C_sp = te.ntt.num_channels(level, -2)
    C_ord = te.ntt.num_channels(level, -1)
    assert te.num_special == je.num_special == n_sp
    q = te.pack(level, -2).q.numpy()[:, None]
    rng = np.random.default_rng(23)
    d = rng.integers(0, 1 << 62, size=(2, C_sp, N)) % q
    got = port_engine._mod_down_shoup(
        torch.from_numpy(d), te.pack(level, -2), te.pack(level, -1),
        te.PiWs[level], te.bp_sp[level][0], n_sp)
    # Op by op: jitted alone, without the optimisation barriers of the
    # engine's switch program, XLA fuses the removal steps into one loop
    # that recomputes every earlier step (79 s on the CPU at n_sp = 6).
    want = jax_engine._mod_down_shoup(
        _limbs(d).reshape(2, 2, C_sp, 16, 16), je.pack(level, -2),
        je.pack(level, -1), tuple(je.PiWs[level]), je.bp_sp[level][0], n_sp,
        C_sp, C_sp, C_ord, tiled=True)
    assert got.shape == (2, C_ord, N)
    assert np.array_equal(got.numpy(), _words(want))


def _mod_down_exact(d, q, n_sp, C_ord):
    """The mod-down in Python integers: each special prime P_j in turn (the
    last channel first) leaves its row's canonical value s and every
    channel i before it becomes (v - s) P_j^-1 mod q_i."""
    v = d.astype(object)
    qs = [int(x) for x in q]
    for j in range(n_sp):
        ch = len(qs) - 1 - j
        src = v[..., ch, :] % qs[ch]
        for i in range(ch):
            v[..., i, :] = (v[..., i, :] - src) * pow(qs[ch], -1, qs[i]) \
                % qs[i]
    return v[..., :C_ord, :].astype(np.int64)


def _mod_down_case(e, level, lead, rng):
    """Random plain words of the mod-down's rows on e at ``level`` (a mesh
    rank's gathered rows, or the with-special layout) with ``lead``
    leading axes, the wrapper's words and the exact ones."""
    C_ord = e.pack(level, -1).q.shape[0]
    if e.mesh is None:
        q, piw, bp = e.pack(level, -2).q, e.PiWs[level], e.bp_sp[level][0]
    else:
        _, pack, _, _, piw, bp = e._mod_down_tables(level)
        q = pack.q
    d = rng.integers(0, 1 << 62, size=(*lead, len(q), e.ctx.N)) \
        % q.numpy()[:, None]
    got = cuda_mxu.mod_down(torch.from_numpy(d), q, piw, bp, e.num_special,
                            C_ord)
    return got.numpy(), _mod_down_exact(d, q.numpy(), e.num_special, C_ord)


@pytest.mark.parametrize("n_sp, layout", [
    (1, "ct"), (1, "batched"), (2, "ct"), (2, "batched"), (4, "ct"),
    (4, "batched"), (6, "ct"), (6, "batched"), (2, "mesh")])
def test_mod_down_wrapper_matches_exact(n_sp, layout):
    """``cuda_mxu.mod_down`` on CPU words (its twin, the chain the engine
    ran before the kernel) at level 1: [2, C_sp, N] words of one
    ciphertext, [2, B, C_sp, N] of a batch of three, and a rank's gathered
    rows on a two-rank mesh (its ordinary rows, then every special row,
    with the tables of ``_mod_down_tables``)."""
    params = dict(PARAMS, num_special_primes=n_sp, seed=SEED)
    rng = np.random.default_rng(31 + n_sp)
    if layout != "mesh":
        te = liberate_tpu_torch.CkksEngine(device="cpu", **params)
        lead = (2,) if layout == "ct" else (2, 3)
        got, want = _mod_down_case(te, 1, lead, rng)
        assert got.shape == (*lead, te.ntt.num_channels(1, -1), te.ctx.N)
        assert np.array_equal(got, want)
        return

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=make_mesh(2), device="cpu",
                                          **params)
        return _mod_down_case(e, 1, (2,), np.random.default_rng(
            37 + e.mesh.axis_index("rns")))

    for got, want in run_ranks(2, body, device="cpu"):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("fault", [
    "dtype", "noncontiguous", "n_sp", "q_width", "piw_width"])
def test_mod_down_wrapper_refuses(fault):
    """The wrapper raises on what its kernel does not take: int32 words,
    non-contiguous words, more special primes than the kernel is built
    for, and tables whose width is not the words' channel count."""
    C_sp, N, n_sp = 12, 256, 2
    rng = np.random.default_rng(41)
    q = torch.from_numpy(rng.integers(1 << 40, 1 << 41, size=C_sp) | 1)
    d = torch.from_numpy(rng.integers(0, 1 << 40, size=(2, C_sp, N)))
    bp = torch.full((C_sp,), 1 << 23, dtype=torch.int64)
    piw = torch.ones((n_sp, 2, C_sp), dtype=torch.int64)
    C_ord = C_sp - n_sp
    assert cuda_mxu.mod_down(d, q, piw, bp, n_sp, C_ord).shape == (
        2, C_ord, N)
    if fault == "dtype":
        d = d.to(torch.int32)
    elif fault == "noncontiguous":
        d = d.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "n_sp":
        n_sp = cuda_mxu.MAX_SPECIAL + 1
        piw = torch.ones((n_sp, 2, C_sp), dtype=torch.int64)
        C_ord = C_sp - n_sp
    elif fault == "q_width":
        q = q[:-1]
    else:
        piw = piw[..., :-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        cuda_mxu.mod_down(d, q, piw, bp, n_sp, C_ord)


def test_switch_matches_jax_montgomery_key_engine(port, monkeypatch):
    """A JAX engine on its MXU kernel path with Montgomery-form key stacks
    switches a random level-0 polynomial with the port's evk
    (``_ext_mulacc_inv_kernel``, then ``_mod_down_shoup``). Its words
    equal the port's switch on all three routes, and the #9 twin equals
    the JAX kernel on the inputs it got there, over both width groups
    (3 parts, A = 2)."""
    calls = []
    dispatch = mxu_pallas.dispatch_ksk_from_state

    def spy(state, terms, off0, k0, k1, mxu_ref, level, part_off, W, **kw):
        out = dispatch(state, terms, off0, k0, k1, mxu_ref, level, part_off,
                       W, **kw)
        calls.append(dict(level=level, part_off=part_off, W=W,
                          arrays=(state, terms, off0, k0, k1, *out)))
        return out

    te, tm, evk = port["te"], port["tm"], port["evk"]
    level, N = 1, te.ctx.N
    q = te.pack(level, -1).q.numpy()[:, None]
    a = np.random.default_rng(29).integers(0, 1 << 62, size=(len(q), N)) % q
    monkeypatch.setattr(mxu_pallas, "dispatch_ksk_from_state", spy)
    with _MxuKernelPath(shoup_ksk=False):
        je = liberate_tpu.CkksEngine(seed=SEED, **PARAMS)
        assert je._mxu_fused_switch()
        # The engine's switch program, made to return the kernel's inputs
        # and outputs too (a host callback would keep the persistent
        # compilation cache from storing it).
        fn = je._switcher_fn(level, False).__wrapped__
        traced = jax.jit(lambda *args: (fn(*args), calls[-1]["arrays"]))

        def switcher(*args):
            out, calls[-1]["arrays"] = traced(*args)
            return out

        je._switcher_cache[(level, False)] = switcher
        want = je.create_switcher(_limbs(a), _to_jax(evk), level)
        jax.block_until_ready(want)
    a = torch.from_numpy(a)
    got = {"mont": tm._switch(a, evk, level),
           "fold": te._switch(a, evk, level),
           "create_switcher": te.create_switcher(a, evk, level)}
    with _Unfolded():
        got["unfolded"] = te._switch(a, evk, level)
    for route, g in got.items():
        for half in range(2):
            assert np.array_equal(g[half].numpy(), _words(want[half])), route

    (call,) = calls
    st, terms, off0, k0, k1, o0, o1 = call["arrays"]
    W = call["W"]
    ks = [torch.from_numpy(interop.limbs_to_int64(np.asarray(k))).reshape(
        k.shape[1], k.shape[2], N) for k in (k0, k1)]
    st = torch.from_numpy(interop.limbs_to_int64(np.asarray(st))).reshape(
        -1, st.shape[2], N)
    got = cuda_mxu.dispatch_switch_inv(
        st, _terms_words(terms),
        torch.from_numpy(interop.limbs_to_int64(np.asarray(off0))),
        *ks, tm.pack(level, -2).mxu, call["level"], call["part_off"])
    for half, o in enumerate((o0, o1)):
        assert np.array_equal(got[half].numpy(), _words(o).reshape(W, N))


@pytest.mark.parametrize("n_sp", [1, 4, 6])
def test_routes_agree_with_special_primes(n_sp):
    """At bronze's, gold's and platinum's special-prime counts the folded
    and the unfolded Shoup-key routes leave the same mult words (one
    special prime: one channel per gadget part, the fold's n_sp = 1)."""
    te = liberate_tpu_torch.CkksEngine(
        device="cpu", use_mxu_ntt=True, seed=SEED,
        **dict(PARAMS, num_special_primes=n_sp))
    assert all(p.alpha <= n_sp for p in te.ntt.parts(0))
    sk = te.create_secret_key()
    evk = te.create_evk(sk)
    m = np.linspace(-1, 1, te.num_slots)
    ct = te.encorypt(m, te.create_public_key(sk))
    fold = te.mult(ct, ct, evk)
    with _Unfolded():
        unfolded = te.mult(ct, ct, evk)
    assert abs(te.absmax_error(te.decrode(unfolded, sk), m * m)) < TOL
    for a, b in zip(fold.data, unfolded.data):
        assert torch.equal(a, b)


def test_unfolded_mult_decrode_error(port):
    te = port["te"]
    for route in ("unfolded", "mont"):
        err = abs(te.absmax_error(te.decrode(port[route], port["sk"]),
                                  port["m"] * port["m"]))
        assert err < TOL, route


def test_montgomery_key_stacks_stay_montgomery(port):
    """With use_shoup_ksk=False the stacks are the key's Montgomery words;
    on the CPU the wrappers run their twins and count no launch."""
    tm = port["tm"]
    k0, k1 = tm._ksk_stacked(port["evk"])
    assert isinstance(k0, torch.Tensor)
    assert torch.equal(k0[1], port["evk"].data[1].data[0])
    cuda_mxu.reset_launches()
    tm.mult(port["ct"], port["ct"], port["evk"])
    assert cuda_mxu.launches == dict.fromkeys(cuda_mxu.launches, 0)
