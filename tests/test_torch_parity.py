"""The JAX ``config`` switches that change words, as ``CkksEngine``
keywords of the port, against the JAX package on the CPU: the
reference-parity Montgomery chains (twiddles, rescale, basis extension,
mod-down) and the Montgomery recombination of the tensor-core transforms.

Raw equality wherever both sides run the same Montgomery chain; mod q only
where one side keeps a Shoup form, as each test states.

- the Montgomery-twiddle twins of #1 and #2 (and the ``ops`` transforms on
  a Montgomery-twiddle pack) against the JAX XLA ``ops`` transforms and
  ``golden.ntt``/``golden.intt``, raw, at logN 8 and 10;
- the canon pre-stage: #1's ``pre_canon`` then #3, and #4's ``canon``,
  against the JAX engine's composed chain (``canon_2q`` of the signed
  identity product, ``ops.ntt``, the key products, the part sum) on signed
  words with wrapped negatives: raw with Montgomery twiddles, mod q with
  Shoup ones;
- the #5/#6 twins with the Montgomery recombination on the master plan,
  at the digits the JAX engine runs with ``use_mxu_pallas`` off, against
  ``mxu_ntt.ntt``/``intt_no_norm_factor``, raw, and the ``ops``
  compositions around them against the JAX ones;
- the coefficient-sharded transforms on a Montgomery-twiddle plan (four
  coef ranks) against the JAX package's sharded transforms, raw;
- ``use_shoup_twiddles=False`` against the ``shared_eng`` fixture (the
  JAX CPU default): keys (sk, pk, evk, a rotation key), ``encorypt``,
  ``mult`` and ``rotate_single`` raw (the Shoup engine matches only mod q);
- all four chain flags off against a JAX engine with
  ``use_shoup_{moddown,rescale,extend}`` off, at
  ``tests/test_shoup_chains.py``'s parameters: keys, ``encorypt``,
  ``mult``, ``rescale`` and ``rotate_single`` raw on the split, fused and
  composed butterfly routes. The JAX side runs encorypt and the tensor
  product jitted (encorypt shares ``tests/test_shoup_chains.py``'s
  program through the persistent XLA cache), the relinearisation, the
  rescale and ``rotate_single`` op by op (``jax.disable_jit``: jitted,
  they run for minutes on the CPU);
- the tensor-core engine with ``use_mxu_pallas`` and the chains off: the
  JAX MXU engine's words through the JAX package's XLA ``mxu_ntt`` are
  held through the twins and the ``ops`` compositions above, and the
  engine against the default engine mod q (each flag alone below);
- each flag alone, port only: mult and rotation words equal the default
  engine's mod q, in both domains;
- the routes: each flag set's mult calls exactly its route's kernel
  wrappers (a spy on the wrappers records their launch counters' labels),
  ``switch_route``/``butterfly_switch_route`` take the flags, and
  ``mult_batched`` loops where the JAX engine loops;
- two ranks of an ``rns`` mesh with every chain Montgomery give the
  single-device words.
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import liberate_tpu
import liberate_tpu_torch
from liberate_tpu import config
from liberate_tpu.fhe.context.ckks_context import CkksContext
from liberate_tpu.fhe.data_struct import DataStruct as JaxDataStruct
from liberate_tpu.ntt import golden, mxu_ntt, ops, u64
from liberate_tpu.ntt.ntt_context import NttContext
from liberate_tpu_torch import interop
from liberate_tpu_torch.fhe import engine as port_engine
from liberate_tpu_torch.fhe.data_struct import DataStruct
from liberate_tpu_torch.fhe.context.ckks_context import \
    CkksContext as TorchCkksContext
from liberate_tpu_torch.ntt import cuda_mxu, cuda_ntt
from liberate_tpu_torch.ntt import mxu_ntt as port_mxu_ntt
from liberate_tpu_torch.ntt import ops as torch_ops
from liberate_tpu_torch.ntt import u64 as port_u64
from liberate_tpu_torch.ntt.ntt_context import NttContext as TorchNttContext
from liberate_tpu_torch.parallel import make_mesh, run_ranks

SHARED = dict(logN=8, scale_bits=30, num_scales=8, num_special_primes=2,
              is_secured=False, seed=20260816)
CHAINS = dict(logN=8, scale_bits=30, num_scales=6, num_special_primes=2,
              is_secured=False, seed=4242)
JAX_CHAIN_FLAGS = ("use_shoup_moddown", "use_shoup_rescale",
                   "use_shoup_extend")
MONT = dict(use_shoup_twiddles=False, use_shoup_rescale=False,
            use_shoup_moddown=False, use_shoup_extend=False)
ROUTES = {"split": {}, "fused": dict(use_split_switch=False),
          "composed": dict(use_fused_switch=False)}
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(a):
    return jnp.asarray(u64.from_int64_np(np.asarray(a)))


def _words(x):
    return u64.to_int64_np(np.asarray(x))


def _raw_equal(ds_j, ds_t):
    """Same flags and raw words, over a DataStruct's tree."""
    if isinstance(ds_t.data, (list, tuple)) \
            and isinstance(ds_t.data[0], DataStruct):
        return all(_raw_equal(a, b) for a, b in zip(ds_j.data, ds_t.data))
    for f in ("origin", "level", "ntt_state", "montgomery_state"):
        assert getattr(ds_j, f) == getattr(ds_t, f), f
    data_j = ds_j.data if isinstance(ds_j.data, (list, tuple)) \
        else (ds_j.data,)
    data_t = ds_t.data if isinstance(ds_t.data, (list, tuple)) \
        else (ds_t.data,)
    return all(np.array_equal(_words(j), t.numpy())
               for j, t in zip(data_j, data_t))


def _to_jax(ds):
    """A port DataStruct as the JAX package's (through ``interop``)."""
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


def _mod_q_equal(a, b, q):
    """Ciphertext words equal mod q ([C] moduli of their layout)."""
    q = torch.tensor(q, dtype=torch.int64)[:, None]
    return all(torch.equal(x % q, y % q) for x, y in zip(a.data, b.data))


# -- the transforms' Montgomery modes against the JAX XLA path -------------------


def _contexts(logN, mont=True):
    params = dict(logN=logN, scale_bits=30, num_scales=3,
                  num_special_primes=2, is_secured=False)
    ctx = CkksContext(**params)
    tnc = TorchNttContext(TorchCkksContext(**params), "cpu",
                          shoup_twiddles=not mont)
    return ctx, NttContext(ctx), tnc


def _lazy(rng, q, shape, bound=2):
    return (rng.integers(0, 1 << 62, size=shape) % (bound * q[:, None])
            ).astype(np.int64)


@pytest.mark.parametrize("logN", [8, 10])
def test_mont_twiddle_twins_equal_jax_ops(logN):
    """#1/#2 with Montgomery twiddles: the twins, and the ``ops``
    transforms of a Montgomery-twiddle pack, give the JAX XLA transforms'
    words raw (and golden.ntt's/intt's), B = 2, the with-special layout of
    level 1; at logN 10 the forward and the inverse with the exit and the
    reduce (the mult's), at logN 8 every mode."""
    ctx, nc, tnc = _contexts(logN)
    lo, hi = nc.channel_range(1, -2)
    jpack, tpack = nc.level_pack(1, -2), tnc.level_pack(1, -2)
    plan = tpack.plan
    assert plan.mont and plan.wp is None
    q = np.array(ctx.q[lo:hi], dtype=np.int64)
    rng = np.random.default_rng(logN)
    lazy, canon = _lazy(rng, q, (2, hi - lo, ctx.N)), \
        _lazy(rng, q, (2, hi - lo, ctx.N), bound=1)
    cases = [
        (ops.ntt, torch_ops.ntt, lazy,
         dict(), cuda_ntt.ntt_fwd_plain),
        (ops.intt_exit_reduce, torch_ops.intt_exit_reduce, lazy,
         dict(post_exit=True, post_reduce=True), cuda_ntt.ntt_inv_plain),
    ]
    if logN == 8:
        cases += [
            (ops.enter_ntt, torch_ops.enter_ntt, canon,
             dict(pre_enter=True), cuda_ntt.ntt_fwd_plain),
            (ops.intt, torch_ops.intt, lazy, dict(),
             cuda_ntt.ntt_inv_plain),
            (ops.intt_exit, torch_ops.intt_exit, lazy, dict(post_exit=True),
             cuda_ntt.ntt_inv_plain),
            (ops.intt_no_norm, torch_ops.intt_no_norm, lazy,
             dict(no_norm=True), cuda_ntt.ntt_inv_plain),
        ]
    for jf, tf, a, kw, twin in cases:
        want = _words(jf(_packed(a), jpack))
        x = torch.from_numpy(a)
        assert np.array_equal(twin(x, plan, **kw).numpy(), want), jf.__name__
        assert np.array_equal(tf(x, tpack).numpy(), want), jf.__name__
    # golden: the reference's chain on the JAX context's Montgomery banks.
    psi = _words(nc._psi_mont)[lo:hi]
    ipsi = _words(nc._ipsi_mont)[lo:hi]
    limbs = [np.array(getattr(ctx, f)[lo:hi], dtype=np.int64) for f in (
        "q_double", "q_lower_bits", "q_higher_bits", "k_lower_bits",
        "k_higher_bits")]
    ninv = np.array([(n * ctx.R) % qq for n, qq in
                     zip(ctx.N_inv[lo:hi], ctx.q[lo:hi])], dtype=np.int64)
    a = lazy[0]
    assert np.array_equal(golden.ntt(a, psi, *limbs),
                          cuda_ntt.ntt_fwd_plain(torch.from_numpy(lazy),
                                                 plan)[0].numpy())
    assert np.array_equal(golden.intt(a, ipsi, ninv[:, None], *limbs),
                          cuda_ntt.ntt_inv_plain(torch.from_numpy(lazy),
                                                 plan)[0].numpy())


def test_mont_coef_sharded_equal_jax():
    """The coefficient-sharded transforms on a Montgomery-twiddle plan
    (``use_shoup_twiddles`` off on a coef mesh), four coef ranks as
    threads: the forward and the inverse give the JAX package's
    ``ntt_coef_sharded``/``intt_coef_sharded`` words raw (its 4-device
    coef CPU mesh, which always runs Montgomery planes), and with the
    entry, with the exit and reduce and without the normalisation (#2's
    ``no_norm`` mode in the locals) the single-device Montgomery
    transforms' words (held raw against JAX's above)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from liberate_tpu.parallel import coef_shard as jax_coef_shard
    from liberate_tpu.parallel import make_mesh as jax_make_mesh
    from liberate_tpu_torch.parallel.coef_shard import (
        intt_coef_sharded, make_coef_plan, ntt_coef_sharded)

    ctx, nc, tnc = _contexts(8)
    pack = tnc.level_pack(0, -2)
    q, N, S = pack.q.numpy(), ctx.N, 4
    rng = np.random.default_rng(12)
    a = _lazy(rng, q, (len(q), N), bound=1)
    f = torch_ops.ntt(torch.from_numpy(a), pack).numpy()
    mesh = jax_make_mesh(S, axis_name="coef")
    plan = jax_coef_shard.make_coef_plan(nc, mesh)
    sh = NamedSharding(mesh, PartitionSpec(None, None, "coef"))
    # One program, as tests/test_torch_coef_shard.py compiles it (the
    # persistent XLA cache shares it).
    want_f, want_i = (_words(w) for w in jax.jit(
        lambda x, y: (jax_coef_shard.ntt_coef_sharded(x, plan),
                      jax_coef_shard.intt_coef_sharded(y, plan)))(
        jax.device_put(_packed(a), sh), jax.device_put(_packed(f), sh)))
    L = N // S

    def body():
        p = make_coef_plan(tnc, make_mesh(S, axis_name="coef"))
        assert p.mont and p.local.mont and p.cross_f[1] is None

        def cut(x):
            return torch.from_numpy(x[..., p.index * L:(p.index + 1) * L]
                                    .copy())
        return (ntt_coef_sharded(cut(a), p),
                ntt_coef_sharded(cut(a), p, pre_enter=True),
                intt_coef_sharded(cut(f), p),
                intt_coef_sharded(cut(f), p, post_exit=True,
                                  post_reduce=True),
                intt_coef_sharded(cut(f), p, no_norm=True))

    got = [torch.cat(o, dim=-1).numpy()
           for o in zip(*run_ranks(S, body, device="cpu"))]
    at, ft = torch.from_numpy(a), torch.from_numpy(f)
    for g, w in zip(got, (
            want_f, torch_ops.enter_ntt(at, pack), want_i,
            torch_ops.intt_exit_reduce(ft, pack),
            torch_ops.intt_no_norm(ft, pack))):
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mont", [True, False], ids=["mont", "shoup"])
def test_canon_twins_equal_jax_chain(mont):
    """#1 ``pre_canon`` (then #3) and #4 ``canon`` on signed words with
    wrapped negatives against the JAX engine's composed chain
    (engine.py:1612-1627): raw with Montgomery twiddles, mod q with Shoup
    twiddles (another [0, 2q) representative)."""
    ctx, nc, tnc = _contexts(8, mont)
    level, P, part_off = 1, 3, 0
    lo, hi = nc.channel_range(level, -2)
    C, N = hi - lo, ctx.N
    jpack, tpack = nc.level_pack(level, -2), tnc.level_pack(level, -2)
    q = np.array(ctx.q[lo:hi], dtype=np.int64)
    rng = np.random.default_rng(11)
    ext = rng.integers(-(1 << 61), 1 << 61, size=(P, C, N)).astype(np.int64)
    ext[:, :, :4] = -1                        # wrapped negatives for sure
    C0 = len(ctx.q)
    qs = np.array(ctx.q, dtype=np.int64)
    k0, k1 = ((rng.integers(0, 1 << 62, size=(P, C0, N)) % (2 * qs[:, None])
               ).astype(np.int64) for _ in range(2))
    ident = _packed(np.array([ctx.R % int(x) for x in q], dtype=np.int64))
    e = ops.canon_2q(ops.mont_enter_scalar(_packed(ext), ident, jpack,
                                           signed=True), jpack)
    t = ops.ntt(e, jpack)
    want = []
    for key in (k0, k1):
        prod = ops.mont_mult(t, _packed(key[:, lo:hi]), jpack)
        s = prod[:, 0]
        for p in range(1, P):
            s = ops.mont_add(s, prod[:, p], jpack)
        want.append(_words(s))
    plan = tpack.plan
    x = torch.from_numpy(ext)
    keys = [torch.from_numpy(k) for k in (k0, k1)]
    split = cuda_ntt.ksk_mulacc_plain(
        cuda_ntt.ntt_fwd_plain(x, plan, pre_canon=True), *keys, plan, level,
        part_off)
    fused = cuda_ntt.ntt_mulacc_plain(x, *keys, plan, level, part_off,
                                      canon=True)
    wrapped = cuda_ntt.ntt_mulacc(x, *keys, plan, level, part_off,
                                  canon=True)
    qc = q[:, None]
    for got in (split, fused, wrapped):
        for g, w in zip(got, want):
            if mont:
                assert np.array_equal(g.numpy(), w)
            else:
                assert np.array_equal(g.numpy() % qc, w % qc)
    assert np.array_equal(torch_ops.ntt(x, tpack, pre_canon=True).numpy(),
                          cuda_ntt.ntt_fwd_plain(x, plan,
                                                 pre_canon=True).numpy())


def test_mxu_montrec_twins_equal_jax(monkeypatch):
    """#5/#6 with the Montgomery recombination on the master plan: the JAX
    engine with ``use_mxu_pallas`` off runs one plan over every channel
    (``pack.mxu.resolve()``) at (8, 8) digits; the port's master plan has
    those digits and tables, its twins give ``mxu_ntt.ntt`` and
    ``intt_no_norm_factor``'s words raw, and the ``ops`` compositions
    (entry, exit, reduce as pointwise ops) the JAX ``ops``' raw."""
    monkeypatch.setattr(config, "use_mxu_ntt", True)
    monkeypatch.setattr(config, "use_mxu_pallas", False)
    params = dict(logN=8, scale_bits=40, num_scales=3, num_special_primes=2,
                  is_secured=False)
    ctx = CkksContext(**params)
    nc = NttContext(ctx)
    jpack = nc.level_pack(1, -2)
    jplan = jpack.mxu.resolve()
    assert not jpack.mxu.groups
    tnc = TorchNttContext(TorchCkksContext(**params), "cpu", use_mxu=True,
                          mxu_pallas=False)
    (lo0, hi0, master), = tnc.mxu_groups
    assert (lo0, hi0) == (0, len(ctx.q)) and master.mont_rec
    assert (master.dA, master.dB, master.split) == \
        (jplan.dA, jplan.dB, jplan.split) == (8, 8, 5)
    assert port_mxu_ntt.digit_params(ctx.buffer_bit_length) == (8, 8)
    full = nc._mxu_master
    for name in ("m1", "m2", "i1", "i2"):
        assert np.array_equal(getattr(master, name).numpy(), np.asarray(
            getattr(full, name)).reshape(getattr(master, name).shape))
    for name in ("c_lo", "c_hi"):
        assert np.array_equal(getattr(master, name).numpy(),
                              _words(getattr(full, name)))
    tpack = tnc.level_pack(1, -2)
    plan = tpack.mxu[0].plan
    lo, hi = nc.channel_range(1, -2)
    q = np.array(ctx.q[lo:hi], dtype=np.int64)
    rng = np.random.default_rng(5)
    a = _lazy(rng, q, (2, hi - lo, ctx.N))
    x = torch.from_numpy(a)
    assert np.array_equal(cuda_mxu.mxu_ntt_fwd_plain(x, plan).numpy(),
                          _words(mxu_ntt.ntt(_packed(a), jplan)))
    assert np.array_equal(cuda_mxu.mxu_ntt_inv_plain(x, plan).numpy(),
                          _words(mxu_ntt.intt_no_norm_factor(_packed(a),
                                                             jplan)))
    canon = _lazy(rng, q, (2, hi - lo, ctx.N), bound=1)
    for jf, tf, b in ((ops.enter_ntt, torch_ops.enter_ntt, canon),
                      (ops.intt_exit_reduce, torch_ops.intt_exit_reduce, a),
                      (ops.intt_reduce, torch_ops.intt_reduce, a),
                      (ops.intt_exit, torch_ops.intt_exit, a)):
        assert np.array_equal(tf(torch.from_numpy(b), tpack).numpy(),
                              _words(jf(_packed(b), jpack))), jf.__name__


def test_montmul_signed_wrapped_negatives():
    """The port's ``u64.montmul`` is the JAX package's ``montmul_signed``
    on wrapped-negative words (the canon pre-stage's and the Montgomery
    extension's inputs) and ``montmul`` on unsigned ones."""
    rng = np.random.default_rng(3)
    q = (1 << 60) - 93 * (1 << 20) + 1
    k = (-pow(q, -1, 1 << 62)) % (1 << 62)
    a = rng.integers(-(1 << 62), 1 << 62, size=4096).astype(np.int64)
    a[:8] = [-1, -2, -(1 << 61), -q, -2 * q, 1 - q, 0, 1]
    b = (rng.integers(0, 1 << 62, size=4096) % (2 * q)).astype(np.int64)
    LB = (1 << 31) - 1
    cons = [np.full(4096, v, dtype=np.int64) for v in
            (q & LB, q >> 31, k & LB, k >> 31)]
    want = _words(u64.pack(*u64.montmul_signed(
        u64.unpack(_packed(a)), u64.unpack(_packed(b)),
        *(jnp.asarray(c.astype(np.uint32)) for c in cons))))
    got = port_u64.montmul(torch.from_numpy(a), torch.from_numpy(b),
                           *(torch.from_numpy(c) for c in cons))
    assert np.array_equal(got.numpy(), want)
    pos = a >= 0
    want_u = _words(u64.pack(*u64.montmul(
        u64.unpack(_packed(a[pos])), u64.unpack(_packed(b[pos])),
        *(jnp.asarray(c[pos].astype(np.uint32)) for c in cons))))
    assert np.array_equal(got.numpy()[pos], want_u)


# -- engines against the JAX engine --------------------------------------------------


@pytest.fixture(scope="module")
def shared_run(shared_eng):
    """The port's Montgomery-twiddle engine and the JAX CPU default engine
    at the shared_eng parameters, their CSPRNG steps in step: the keys of
    both, then encorypt, mult and rotate_single of both."""
    je = shared_eng
    tm = liberate_tpu_torch.CkksEngine(device="cpu", use_shoup_twiddles=False,
                                       **SHARED)
    out = {}
    tm.rng.steps[:] = je.rng.steps
    for e, tag in ((tm, "t"), (je, "j")):
        sk = e.create_secret_key()
        pk = e.create_public_key(sk)
        out[tag] = dict(sk=sk, pk=pk, evk=e.create_evk(sk),
                        rotk=e.create_rotation_key(sk, 1))
    assert np.array_equal(tm.rng.steps, je.rng.steps)
    m = np.random.default_rng(6).uniform(-1, 1, je.num_slots) + 0j
    for e, tag in ((tm, "t"), (je, "j")):
        r = out[tag]
        r["ct"] = e.encorypt(m, r["pk"])
        r["mult"] = e.mult(r["ct"], r["ct"], r["evk"])
        r["rot"] = e.rotate_single(r["ct"], r["rotk"])
    out["m"], out["tm"] = m, tm
    return out


def test_mont_twiddle_keys_equal_shared_eng(shared_run):
    """Keys raw: sk, pk, evk and a rotation key (the Shoup engine's keys
    equal the JAX CPU engine's only mod q)."""
    j, t = shared_run["j"], shared_run["t"]
    for name in ("sk", "pk", "evk", "rotk"):
        assert _raw_equal(j[name], t[name]), name


def test_mont_twiddle_ops_equal_shared_eng(shared_run):
    """``encorypt``, ``mult`` and ``rotate_single`` raw against the JAX
    CPU engine's, and the mult decodes within TOL."""
    j, t, tm = shared_run["j"], shared_run["t"], shared_run["tm"]
    for name in ("ct", "mult", "rot"):
        assert _raw_equal(j[name], t[name]), name
    m = shared_run["m"]
    assert abs(tm.absmax_error(tm.decrode(t["mult"], t["sk"]), m * m)) < TOL


@pytest.fixture(scope="module")
def chains_run():
    """The port's keys of an engine with every chain flag off, carried to
    a JAX engine with its three chain flags off (keygen reads no chain
    flag: the keys' words are held raw in the shared_eng test), at
    tests/test_shoup_chains.py's parameters; the JAX engine's encorypt
    and tensor product jitted (encorypt is a program of
    tests/test_shoup_chains.py, which a whole run shares through the
    persistent XLA cache), then the relinearisation, the rescale of the
    mult and rotate_single of the mult op by op (``jax.disable_jit``:
    jitted, the relinearised mult runs for about 35 s and rotate_single
    for about 150 s on the CPU, op by op about 20 s and 4 s)."""
    te = liberate_tpu_torch.CkksEngine(device="cpu", **MONT, **CHAINS)
    sk = te.create_secret_key()
    keys = dict(sk=sk, pk=te.create_public_key(sk), evk=te.create_evk(sk),
                rotk=te.create_rotation_key(sk, 1))
    prev = {f: getattr(config, f) for f in JAX_CHAIN_FLAGS}
    try:
        for f in JAX_CHAIN_FLAGS:
            setattr(config, f, False)
        je = liberate_tpu.CkksEngine(**CHAINS)
        je.rng.steps[:] = te.rng.steps
        jk = {k: _to_jax(v) for k, v in keys.items()}
        m = np.random.default_rng(9).uniform(-1, 1, je.num_slots) + 0j
        ct = je.encorypt(m, jk["pk"])
        triplet = je.cc_mult(ct, ct, jk["evk"], relin=False)
        with jax.disable_jit():
            mult = je.relinearize(triplet, jk["evk"])
            res = je.rescale(mult)
            rot = je.rotate_single(mult, jk["rotk"])
    finally:
        for f, v in prev.items():
            setattr(config, f, v)
    return dict(steps=te.rng.steps.copy(), keys=keys, m=m, ct=ct,
                mult=mult, rescale=res, rot=rot)


@pytest.mark.parametrize("route", list(ROUTES))
def test_montgomery_chains_equal_jax(chains_run, route):
    """Every chain flag off: keys, encorypt, mult, rescale and
    rotate_single raw on each butterfly switch route (the keys against
    the split engine's, whose words the JAX engine took)."""
    te = liberate_tpu_torch.CkksEngine(device="cpu", **MONT, **ROUTES[route],
                                       **CHAINS)
    assert port_engine.butterfly_switch_route(
        8, te.use_split_switch, fused_switch=te.use_fused_switch) == route
    sk = te.create_secret_key()
    keys = dict(sk=sk, pk=te.create_public_key(sk), evk=te.create_evk(sk),
                rotk=te.create_rotation_key(sk, 1))
    for name, ds in keys.items():
        assert _raw_equal(_to_jax(chains_run["keys"][name]), ds), name
    assert np.array_equal(te.rng.steps, chains_run["steps"])
    ct = te.encorypt(chains_run["m"], keys["pk"])
    mult = te.mult(ct, ct, keys["evk"])
    got = dict(ct=ct, mult=mult, rescale=te.rescale(mult),
               rot=te.rotate_single(mult, keys["rotk"]))
    for name, ds in got.items():
        assert _raw_equal(chains_run[name], ds), name


# -- the port alone: each flag, the routes, the mesh -------------------------------


def _flow(flags, mxu=False, params=CHAINS):
    """keygen, encorypt, mult and rotate_single of a port engine."""
    e = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=mxu,
                                      **flags, **params)
    sk = e.create_secret_key()
    pk = e.create_public_key(sk)
    evk = e.create_evk(sk)
    rotk = e.create_rotation_key(sk, 1)
    m = np.random.default_rng(4).uniform(-1, 1, e.num_slots) + 0j
    ct = e.encorypt(m, pk)
    return dict(e=e, sk=sk, m=m, mult=e.mult(ct, ct, evk),
                rot=e.rotate_single(ct, rotk))


_DEFAULT = {}


def _default(mxu):
    if mxu not in _DEFAULT:
        _DEFAULT[mxu] = _flow({}, mxu)
    return _DEFAULT[mxu]


@pytest.mark.parametrize("mxu,flag", [
    (False, "use_shoup_twiddles"), (False, "use_shoup_rescale"),
    (False, "use_shoup_moddown"), (False, "use_shoup_extend"),
    (False, "use_fused_switch"), (True, "use_shoup_rescale"),
    (True, "use_shoup_moddown"), (True, "use_shoup_extend"),
    (True, "use_mxu_pallas")],
    ids=lambda v: {True: "mxu", False: "bfly"}.get(v, v))
def test_each_flag_alone_equals_default_mod_q(mxu, flag):
    """One flag off, the others at their defaults: the mult and rotation
    words equal the default engine's mod q (the port's counterpart of
    tests/test_shoup_chains.py:73), and decode within TOL."""
    base, got = _default(mxu), _flow({flag: False}, mxu)
    e = got["e"]
    for name, level in (("mult", 1), ("rot", 0)):
        q = e.ctx.q[level:e.num_ordinary]
        assert _mod_q_equal(base[name], got[name], q), name
    err = e.absmax_error(e.decrode(got["mult"], got["sk"]),
                         got["m"] * got["m"])
    assert abs(err) < TOL


class _Spy:
    """Records the launch-counter label of every kernel wrapper call (the
    wrappers count only their launches on the card)."""

    def __init__(self, monkeypatch):
        self.calls = {}

        def wrap(mod, name, label):
            orig = getattr(mod, name)
            sig = inspect.signature(orig)

            def f(*a, **kw):
                arg = sig.bind(*a, **kw)
                arg.apply_defaults()
                key = label(**arg.arguments)
                self.calls[key] = self.calls.get(key, 0) + 1
                return orig(*a, **kw)
            monkeypatch.setattr(mod, name, f)

        lbl = cuda_ntt.launch_label
        wrap(cuda_ntt, "ntt_fwd", lambda plan, pre_canon, **_:
             lbl("ntt_fwd", plan.mont, pre_canon))
        wrap(cuda_ntt, "ntt_inv", lambda plan, no_norm, **_:
             lbl("ntt_inv_no_norm" if no_norm else "ntt_inv", plan.mont))
        wrap(cuda_ntt, "ksk_mulacc", lambda **_: "ksk_mulacc")
        wrap(cuda_ntt, "ntt_mulacc", lambda plan, canon, **_:
             lbl("ntt_mulacc", plan.mont, canon))
        for name in ("mxu_ntt_fwd", "mxu_ntt_inv"):
            wrap(cuda_mxu, name, lambda plan, _n=name, **_:
                 _n + ("_montrec" if plan.mont_rec else ""))
        for name in ("mxu_switch", "mxu_switch_inv"):
            wrap(cuda_mxu, name, lambda _n=name, **_: _n)


@pytest.mark.parametrize("mxu,flags,route", [
    (False, {}, {"ntt_fwd", "ntt_inv", "ksk_mulacc"}),
    (False, MONT, {"ntt_fwd_mont", "ntt_fwd_mont_canon", "ksk_mulacc",
                   "ntt_inv_mont"}),
    (False, dict(MONT, use_split_switch=False),
     {"ntt_fwd_mont", "ntt_mulacc_mont_canon", "ntt_inv_mont"}),
    (False, dict(MONT, use_fused_switch=False),
     {"ntt_fwd_mont", "ntt_fwd_mont_canon", "ntt_inv_mont"}),
    (True, dict(MONT, use_mxu_pallas=False),
     {"mxu_ntt_fwd_montrec", "mxu_ntt_inv_montrec"}),
    (True, dict(use_shoup_moddown=False),
     {"mxu_ntt_fwd", "mxu_ntt_inv", "mxu_switch_inv"}),
], ids=["bfly", "bfly-mont-split", "bfly-mont-fused", "bfly-mont-composed",
        "mxu-mont", "mxu-moddown"])
def test_mult_takes_its_route(monkeypatch, mxu, flags, route):
    """The mult calls exactly its route's kernel wrappers (by their launch
    counters' labels); the mult_batched of two pairs loops (one mult's
    calls each) where the JAX engine loops."""
    e = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=mxu, **flags,
                                      **CHAINS)
    sk = e.create_secret_key()
    pk = e.create_public_key(sk)
    evk = e.create_evk(sk)
    m = np.random.default_rng(1).uniform(-1, 1, e.num_slots) + 0j
    ct = e.encorypt(m, pk)
    spy = _Spy(monkeypatch)
    one = e.mult(ct, ct, evk)
    assert set(spy.calls) == route
    calls, spy.calls = dict(spy.calls), {}
    two = e.mult_batched([ct, ct], [ct, ct], evk)
    assert e._batched_mult() == (mxu and not flags)
    if not e._batched_mult():
        assert spy.calls == {k: 2 * v for k, v in calls.items()}
    for ds in two:
        assert all(torch.equal(a, b) for a, b in zip(ds.data, one.data))


def test_routes_take_the_flags():
    """``butterfly_switch_route`` and ``switch_route`` with the flags."""
    bsr, sr = port_engine.butterfly_switch_route, port_engine.switch_route
    assert bsr(8, True) == "split" and bsr(8, False) == "fused"
    assert bsr(16, False) == "composed"
    assert bsr(8, True, fused_switch=False) == "composed"
    assert bsr(8, False, fused_switch=False) == "composed"
    assert sr(8, True) == "mxu_switch"
    assert sr(8, True, shoup_moddown=False) == "mxu_switch_inv"
    assert sr(8, False, shoup_moddown=False) == "mxu_switch_inv_mont"
    assert sr(8, True, fused=False) == "composed"
    assert sr(16, False, fused=False) == "composed"


def test_rns_mesh_montgomery_chains_equal_single_device():
    """Two ranks of an rns mesh (threads), every chain Montgomery: keys,
    the ciphertext and the mult gathered give the single-device words."""
    small = dict(CHAINS, num_scales=3)

    def run(mesh):
        e = liberate_tpu_torch.CkksEngine(
            device="cpu" if mesh is None else None, mesh=mesh, **MONT,
            **small)
        sk = e.create_secret_key()
        pk = e.create_public_key(sk)
        evk = e.create_evk(sk)
        m = np.random.default_rng(8).uniform(-1, 1, e.num_slots) + 0j
        ct = e.encorypt(m, pk)
        out = [sk, ct, e.mult(ct, ct, evk)]
        if mesh is not None:
            out = [e.gather(ds) for ds in out]
        return [t.clone() for ds in out for t in
                (ds.data if isinstance(ds.data, tuple) else (ds.data,))]

    want = run(None)
    for got in run_ranks(2, lambda: run(make_mesh(2)), device="cpu"):
        assert all(torch.equal(a, b) for a, b in zip(want, got))
