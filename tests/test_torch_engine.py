"""The port's slice end to end against the JAX package, on the CPU, at the
shared_eng parameters (logN 8, scale_bits 30, 8 scales, 2 special primes,
seed 20260816).

Both engines draw from counter-keyed ChaCha20 streams, so with the port's
stream steps set to the JAX engine's they draw the same words. The stored
keys are NTT-domain lazy [0, 2q) words: the port's Shoup twiddles give
other representatives than the JAX CPU path's Montgomery twiddles, so
keys are compared reduced to [0, q), where they are bit-identical. The
ciphertexts of encorypt and mult end in a reduce and are compared raw.

With one special prime (bronze's partition: one channel per gadget part)
the port's mult gives the JAX engine's words too. The gadget partition
(``RnsPartition``) equals the JAX package's at every preset's prime counts.

The butterfly switch core's three routes (split, fused, composed) leave
the same mult words, and the standalone entry points (``mult(relin=False)``,
``relinearize``, ``square``, ``switch_key``, ``decrypt_triplet``) give the
JAX engine's words: raw where the result ends in a reduce, mod q for the
NTT-domain triplet. The engine on a mesh (4 ranks of an ``rns`` mesh, a
2 x 2 and a 1 x 4 (``rns``, ``coef``) mesh) gives them too, gathered.
"""

import gc
import weakref

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import liberate_tpu_torch
import liberate_tpu
from liberate_tpu.fhe.data_struct import DataStruct as JaxDataStruct
from liberate_tpu.fhe.data_struct import to_host
from liberate_tpu.ntt import u64
from liberate_tpu.ntt.rns_partition import RnsPartition as JaxRnsPartition
from liberate_tpu_torch import interop
from liberate_tpu_torch.fhe import engine as port_engine
from liberate_tpu_torch.ntt import cuda_ntt
from liberate_tpu_torch.ntt.rns_partition import RnsPartition
from liberate_tpu_torch.parallel import make_mesh, make_mesh2d, run_ranks

PARAMS = dict(logN=8, scale_bits=30, num_scales=8, num_special_primes=2,
              is_secured=False, seed=20260816)
TOL = 1e-5


def _jax_words(x):
    return u64.to_int64_np(np.asarray(x))


def _to_port(ds, device="cpu"):
    h = to_host(ds)

    def tree(d):
        if isinstance(d, JaxDataStruct):
            return (tree(d.data), {k: getattr(d, k) for k in d.__slots__})
        if isinstance(d, (tuple, list)):
            return type(d)(tree(t) for t in d)
        return np.asarray(d)

    return interop.from_reference(
        tree(h.data), {k: getattr(h, k) for k in h.__slots__}, device)


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


def _assert_words_equal(ds_j, ds_t, q=None):
    """Same flags and words (mod q when given: [C] moduli)."""
    for f in ("origin", "level", "ntt_state", "montgomery_state"):
        assert getattr(ds_j, f) == getattr(ds_t, f), f
    for j, t in zip(ds_j.data, ds_t.data):
        jw, tw = _jax_words(j), t.numpy()
        if q is not None:
            jw, tw = jw % q[:, None], tw % q[:, None]
        assert np.array_equal(jw, tw)


@pytest.fixture(scope="module")
def run(shared_eng, shared_keys):
    je = shared_eng
    te = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)
    te.rng.steps[:] = je.rng.steps
    steps0 = te.rng.steps.copy()
    keys_j = (je.create_secret_key(),)
    keys_j += (je.create_public_key(keys_j[0]), je.create_evk(keys_j[0]))
    keys_t = (te.create_secret_key(),)
    keys_t += (te.create_public_key(keys_t[0]), te.create_evk(keys_t[0]))
    assert np.array_equal(te.rng.steps, je.rng.steps)

    rng = np.random.default_rng(5)
    m = rng.uniform(-1, 1, je.num_slots) + 1j * rng.uniform(
        -1, 1, je.num_slots)
    ct_j = je.encorypt(m, keys_j[1])
    ct_t = te.encorypt(m, keys_t[1])
    return dict(je=je, te=te, steps0=steps0, keys_j=keys_j, keys_t=keys_t,
                m=m,
                ct_j=ct_j, ct_t=ct_t,
                mult_j=je.mult(ct_j, ct_j, keys_j[2]),
                mult_t=te.mult(ct_t, ct_t, keys_t[2]),
                shared_keys=shared_keys)


def _canonical_pairs(r, which, keys_t=None):
    """(jax words, port words, moduli) of each polynomial of a key: the
    fixture's port keys, or ``keys_t`` (sk, pk, evk)."""
    q = np.array(r["je"].ctx.q, dtype=np.int64)
    idx = {"sk": 0, "pk": 1, "evk": 2}[which]
    kj, kt = r["keys_j"][idx], (keys_t or r["keys_t"])[idx]
    if which == "sk":
        return [(kj.data, kt.data)], q
    if which == "pk":
        return list(zip(kj.data, kt.data)), q
    return [(a, b) for pj, pt in zip(kj.data, kt.data)
            for a, b in zip(pj.data, pt.data)], q


@pytest.mark.parametrize("which", ["sk", "pk", "evk"])
def test_keys_bit_identical_mod_q(run, which):
    pairs, q = _canonical_pairs(run, which)
    for j, t in pairs:
        jw, tw = _jax_words(j), t.numpy()
        qc = q[:jw.shape[0], None]
        assert np.array_equal(jw % qc, tw % qc)


def _mesh_engine_equals_jax(run, ranks, mesh_fn):
    """The engine on ``ranks`` ranks (gloo threads of this process), each on
    its mesh ``mesh_fn()``, from the fixture's stream steps: its gathered
    keys are the JAX engine's words mod q, its ciphertext and mult output
    the JAX words raw."""
    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=mesh_fn(), device="cpu",
                                          **PARAMS)
        e.rng.steps[:] = run["steps0"]
        sk = e.create_secret_key()
        pk, evk = e.create_public_key(sk), e.create_evk(sk)
        ct = e.encorypt(run["m"], pk)
        out = e.mult(ct, ct, evk)
        return [e.gather(x) for x in (sk, pk, evk, ct, out)]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = run_ranks(ranks, body, device="cpu")
    finally:
        torch.set_num_threads(n)
    for *keys, ct, out in out:
        for which in ("sk", "pk", "evk"):
            pairs, q = _canonical_pairs(run, which, keys)
            for j, t in pairs:
                jw, tw = _jax_words(j), t.numpy()
                qc = q[:jw.shape[0], None]
                assert np.array_equal(jw % qc, tw % qc), which
        _assert_words_equal(run["ct_j"], ct)
        _assert_words_equal(run["mult_j"], out)


def test_sharded_engine_equals_jax(run):
    """The RNS-channel-sharded engine on 4 ranks (the channel axes padded
    to a multiple of 4) gives the JAX engine's words."""
    _mesh_engine_equals_jax(run, 4, lambda: make_mesh(4))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_coef_mesh_engine_equals_jax(run, shape):
    """The engine on a mesh with a coef axis, a (2 rns x 2 coef) and a
    coefficient-only (1 x 4) one (the coefficient-sharded transforms, the
    split switch on a shard's columns), gives the JAX engine's words."""
    _mesh_engine_equals_jax(run, shape[0] * shape[1],
                            lambda: make_mesh2d(*shape))


def test_encorypt_bit_identical(run):
    for j, t in zip(run["ct_j"].data, run["ct_t"].data):
        assert np.array_equal(_jax_words(j), t.numpy())


def test_mult_bit_identical(run):
    assert run["mult_t"].level == run["mult_j"].level == 1
    for j, t in zip(run["mult_j"].data, run["mult_t"].data):
        assert np.array_equal(_jax_words(j), t.numpy())


def test_encode_encrypt_decrypt_bit_identical(run):
    """The separate calls: encode, encrypt, decrypt (to the signed
    base-prime plaintext), decode."""
    je, te, m = run["je"], run["te"], run["m"]
    (sk_j, pk_j, _), (sk_t, pk_t, _) = run["keys_j"], run["keys_t"]
    te.rng.steps[:] = je.rng.steps
    pt_j, pt_t = je.encode(m), te.encode(m)
    assert np.array_equal(_jax_words(pt_j), pt_t.numpy())
    ct_j, ct_t = je.encrypt(pt_j, pk_j), te.encrypt(pt_t, pk_t)
    for j, t in zip(ct_j.data, ct_t.data):
        assert np.array_equal(_jax_words(j), t.numpy())
    dec_j, dec_t = je.decrypt(ct_j, sk_j), te.decrypt(ct_t, sk_t)
    assert np.array_equal(_jax_words(dec_j), dec_t.numpy())
    assert abs(te.absmax_error(te.decode(dec_t), m)) < TOL


def test_decrypt_double_equals_jax(run):
    """decrypt_double: a ciphertext's decryption, the JAX engine's words;
    anything else raises NotMatchType, as in the JAX engine."""
    je, te = run["je"], run["te"]
    (sk_j, _, _), (sk_t, _, _) = run["keys_j"], run["keys_t"]
    assert np.array_equal(_jax_words(je.decrypt_double(run["ct_j"], sk_j)),
                          te.decrypt_double(run["ct_t"], sk_t).numpy())
    for e, sk, pk in ((je, sk_j, run["keys_j"][1]),
                      (te, sk_t, run["keys_t"][1])):
        with pytest.raises(liberate_tpu_torch.errors.NotMatchType
                           if e is te else liberate_tpu.errors.NotMatchType):
            e.decrypt_double(pk, sk)


def test_devices_keyword():
    """The first parameter is ``devices``, as in the JAX engine; ``device``
    stays its alias, and a reference-style list names the device."""
    import inspect

    first = [list(inspect.signature(c.__init__).parameters)[1]
             for c in (liberate_tpu.CkksEngine, liberate_tpu_torch.CkksEngine)]
    assert first == ["devices", "devices"]
    small = dict(logN=8, scale_bits=30, num_scales=2, num_special_primes=1,
                 is_secured=False)
    for kw in (dict(devices="cpu"), dict(device="cpu"),
               dict(devices=["cpu"]), dict(devices="cpu", device="cpu")):
        e = liberate_tpu_torch.CkksEngine(**kw, **small)
        assert e.torch_device == torch.device("cpu")
    assert e.devices == "cpu"
    with pytest.raises(TypeError, match="alias"):
        liberate_tpu_torch.CkksEngine(devices="cpu", device="cuda:0",
                                      **small)


def test_level_up_bit_identical(run):
    up_j = run["je"].level_up(run["ct_j"], 2)
    up_t = run["te"].level_up(run["ct_t"], 2)
    assert up_t.level == up_j.level == 2
    for j, t in zip(up_j.data, up_t.data):
        assert np.array_equal(_jax_words(j), t.numpy())


def test_mult_decrode_error(run):
    m2 = run["m"] * run["m"]
    err_j = abs(run["je"].absmax_error(
        run["je"].decrode(run["mult_j"], run["keys_j"][0]), m2))
    err_t = abs(run["te"].absmax_error(
        run["te"].decrode(run["mult_t"], run["keys_t"][0]), m2))
    assert err_t < TOL
    assert err_t <= 2 * err_j


def test_port_ciphertext_decrypts_under_jax(run):
    """Keys handed JAX -> port: the port encrypts and multiplies with the
    JAX engine's pk and evk; JAX decrypts with its sk."""
    je, te, m = run["je"], run["te"], run["m"]
    sk, pk, evk = run["shared_keys"]
    ct = te.encorypt(m, _to_port(pk))
    ct2 = te.mult(ct, ct, _to_port(evk))
    assert abs(je.absmax_error(je.decrode(_to_jax(ct), sk), m)) < TOL
    assert abs(je.absmax_error(je.decrode(_to_jax(ct2), sk), m * m)) < TOL


def test_jax_ciphertext_decrypts_under_port(run):
    """Ciphertext and secret key handed JAX -> port."""
    je, te, m = run["je"], run["te"], run["m"]
    sk, pk, _ = run["shared_keys"]
    ct = je.encorypt(m, pk)
    dec = te.decrode(_to_port(ct), _to_port(sk))
    assert abs(te.absmax_error(dec, m)) < TOL
    # And a port ciphertext comes back through to_reference_arrays intact.
    back = _to_port(_to_jax(run["ct_t"]))
    for a, b in zip(back.data, run["ct_t"].data):
        assert torch.equal(a, b)


@pytest.mark.parametrize("logN, split, route", [
    (15, True, "split"), (16, True, "split"), (15, False, "fused"),
    (16, False, "composed"), (14, True, "split"), (17, True, "split"),
    (14, False, "fused"), (17, False, "composed")])
def test_butterfly_switch_route(logN, split, route):
    """#4 unsplit up to logN 15 (bronze's 14 included), composed above
    (platinum's 17), as the JAX engine's supports_fused_accum gates it;
    the split route at every logN."""
    assert port_engine.butterfly_switch_route(logN, split) == route


def test_mult_bit_identical_one_special_prime():
    """Bronze's partition at logN 8: one special prime, so one channel per
    gadget part. The JAX engine (CPU path) multiplies the port's
    ciphertext with the port's evk, carried over by interop; its words
    equal the port's mult, which decodes."""
    params = dict(PARAMS, num_scales=3, num_special_primes=1)
    te = liberate_tpu_torch.CkksEngine(device="cpu", **params)
    assert [p.alpha for p in te.ntt.parts(0)] == [1] * 4
    sk = te.create_secret_key()
    evk = te.create_evk(sk)
    m = np.random.default_rng(7).uniform(-1, 1, te.num_slots)
    ct = te.encorypt(m, te.create_public_key(sk))
    out = te.mult(ct, ct, evk)
    je = liberate_tpu.CkksEngine(**params)
    ct_j = _to_jax(ct)
    _assert_words_equal(je.mult(ct_j, ct_j, _to_jax(evk)), out)
    assert abs(te.absmax_error(te.decrode(out, sk), m * m)) < TOL


def test_engine_freed_on_del():
    """An engine holds no reference cycle: ``del`` frees it (its tables and
    keys) without the cyclic collector, which the test keeps off."""
    te = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)
    sk = te.create_secret_key()
    ct = te.encorypt(np.linspace(-1, 1, te.num_slots),
                     te.create_public_key(sk))
    te.mult(ct, ct, te.create_evk(sk))
    ref = weakref.ref(te)
    gc.disable()
    try:
        del te
        assert ref() is None
    finally:
        gc.enable()


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("preset, num_ordinary, num_special", [
    ("bronze", 8, 1), ("silver", 17, 2), ("gold", 35, 4),
    ("platinum", 73, 6)])
def test_rns_partition_equals_jax(preset, num_ordinary, num_special):
    """The gadget partition at each preset's prime counts (bronze: 8 parts
    of one channel; platinum: 12 blocks of 6 and the base), host only."""
    got = RnsPartition(num_ordinary, num_special, 1)
    want = JaxRnsPartition(num_ordinary, num_special, 1)
    assert vars(got).keys() == vars(want).keys()
    for k, v in vars(want).items():
        assert _same(getattr(got, k), v), k
    assert got.num_partitions + 1 == {"bronze": 8, "silver": 9, "gold": 10,
                                      "platinum": 13}[preset]


def test_switch_routes_give_the_same_mult_words(run, monkeypatch):
    """At logN 8 the fused route (``ntt_mulacc``) and the composed one
    (forced by lowering FUSED_SWITCH_MAX_LOGN) leave the split route's mult
    words, and each runs its own switch core."""
    te, ct, evk = run["te"], run["ct_t"], run["keys_t"][2]
    calls = []
    for name in ("ntt_mulacc", "ksk_mulacc"):
        def spy(*args, _f=getattr(cuda_ntt, name), _n=name):
            calls.append(_n)
            return _f(*args)
        monkeypatch.setattr(cuda_ntt, name, spy)
    monkeypatch.setattr(te, "use_split_switch", False)
    outs = {"fused": te.mult(ct, ct, evk)}
    assert calls == ["ntt_mulacc"]
    monkeypatch.setattr(port_engine, "FUSED_SWITCH_MAX_LOGN", 7)
    outs["composed"] = te.mult(ct, ct, evk)
    assert calls == ["ntt_mulacc"]
    for route, out in outs.items():
        for a, b in zip(out.data, run["mult_t"].data):
            assert torch.equal(a, b), route


@pytest.mark.parametrize("entry", ["triplet", "relinearize", "square",
                                   "switch_key", "decrypt_triplet"])
def test_entry_point_words_equal_jax(run, entry):
    """Each engine's own keys and ciphertext (identical words, keys equal
    mod q); the switch_key key comes from the JAX engine through interop.
    The triplet is NTT-domain lazy [0, 2q) (other representatives from the
    port's Shoup twiddles): equal mod q. The rest end in a reduce: equal."""
    je, te = run["je"], run["te"]
    ct_j, ct_t = run["ct_j"], run["ct_t"]
    (sk_j, _, evk_j), (sk_t, _, evk_t) = run["keys_j"], run["keys_t"]
    m = run["m"]
    if entry == "square":
        out_j, out_t = je.square(ct_j, evk_j), te.square(ct_t, evk_t)
        _assert_words_equal(out_j, out_t)
        assert abs(te.absmax_error(te.decrode(out_t, sk_t), m * m)) < TOL
        return
    if entry == "switch_key":
        sk2 = je.create_secret_key()
        ksk = je.create_key_switching_key(sk_j, sk2)
        out_j = je.switch_key(run["mult_j"], ksk)
        out_t = te.switch_key(run["mult_t"], _to_port(ksk))
        _assert_words_equal(out_j, out_t)
        err = te.absmax_error(te.decrode(out_t, _to_port(sk2)), m * m)
        assert abs(err) < TOL
        return
    ctt_j = je.mult(ct_j, ct_j, evk_j, relin=False)
    ctt_t = te.mult(ct_t, ct_t, evk_t, relin=False)
    if entry == "triplet":
        q = np.array(te.ntt.q_ints(ctt_t.level, -1), dtype=np.int64)
        _assert_words_equal(ctt_j, ctt_t, q)
    elif entry == "relinearize":
        out_t = te.relinearize(ctt_t, evk_t)
        _assert_words_equal(je.relinearize(ctt_j, evk_j), out_t)
        for a, b in zip(out_t.data, run["mult_t"].data):
            assert torch.equal(a, b)
    else:
        dec_j = je.decrypt_triplet(ctt_j, sk_j)
        dec_t = te.decrypt_triplet(ctt_t, sk_t)
        assert np.array_equal(_jax_words(dec_j), dec_t.numpy())
        err = te.absmax_error(te.decrode(ctt_t, sk_t), m * m)
        assert abs(err) < TOL
