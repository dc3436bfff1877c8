"""The port's threshold (multiparty) FHE against the JAX package, on the CPU.

At the shared_eng parameters (logN 8, scale_bits 30, 8 scales, 2 special
primes, seed 20260816), with 2 and 3 parties, in the butterfly domain: the
port makes the parties' secret keys and the JAX engine gets them through
``interop``. Each engine then runs every step of the protocol itself, with
the port's CSPRNG at the JAX engine's stream steps before each step, so
both draw the same words:

- the collective public key equals the JAX engine's mod q (keys are lazy
  [0, 2q) NTT-domain words whose representatives differ between the port's
  Shoup twiddles and the JAX CPU path's Montgomery ones);
- a ciphertext under it (raw words equal): the head and partial
  decryptions equal mod q (both lazy [0, 2q) out of the inverse
  transform), the fusion's decoded message equal;
- the three-step collective evk (sum of the shares' pk0, each party's
  product with its secret, the sum of those) equal mod q at every step;
  ``mult`` under it gives the JAX engine's words and threshold-decrypts to
  an error < 1e-4;
- the collective rotation key and ``rotate_single`` under it, and the
  collective Galois key, its 7 rotation keys, and ``rotate_galois``: keys
  equal mod q, rotated words equal;
- two port engines of one seed draw the same CRS; the wrong-origin and
  wrong-width errors of the JAX engine.

In the tensor-core domain (port only, no JAX keygen in interpret mode):
the collective keys brought back to the coefficient domain equal the
butterfly domain's mod q, and the threshold-decrypted mult error is
< 1e-4.
"""

import numpy as np
import pytest
import torch

import liberate_tpu_torch
from liberate_tpu_torch.fhe.presets import errors
from liberate_tpu_torch.ntt import ops
from test_torch_engine import PARAMS, _jax_words, _to_jax

TOL = 1e-4


def _steps(r):
    r["te"].rng.steps[:] = r["je"].rng.steps


def _both(r, make):
    """make(engine, the party's keys) on the JAX engine, then on the port
    at the JAX engine's CSPRNG steps."""
    _steps(r)
    out = make(r["je"], r["sks_j"]), make(r["te"], r["sks"])
    assert np.array_equal(r["te"].rng.steps, r["je"].rng.steps)
    return out


def _equal_mod_q(j, t, q):
    jw, tw = _jax_words(j), t.numpy()
    qc = q[:jw.shape[-2], None]
    return np.array_equal(jw % qc, tw % qc)


def _key_equal_mod_q(kj, kt, q):
    """Every polynomial of a key (nested DataStructs) equal mod q."""
    if hasattr(kt, "origin"):
        assert kj.origin == kt.origin
        return _key_equal_mod_q(kj.data, kt.data, q)
    if isinstance(kt, (tuple, list)):
        assert len(kj) == len(kt)
        return all(_key_equal_mod_q(a, b, q) for a, b in zip(kj, kt))
    return _equal_mod_q(kj, kt, q)


def _threshold_decrypt(e, ct, sks):
    pcts = [e.multiparty_decrypt_head(ct, sks[0])]
    pcts += [e.multiparty_decrypt_partial(ct, s) for s in sks[1:]]
    return e.multiparty_decrypt_fusion(pcts, level=ct.level)


def _collective_pk(e, sks):
    pk0 = e.multiparty_create_public_key(sks[0])
    crs = e.multiparty_public_crs(pk0)
    pks = [pk0] + [e.multiparty_create_public_key(s, a=crs) for s in sks[1:]]
    return e.multiparty_create_collective_public_key(pks)


def _evk_steps(e, sks):
    """The three steps of the collective evk: the shares' pk0 summed, each
    party's product with its secret, their sum."""
    shares = [e.create_key_switching_key(sks[0], sks[0])]
    crs = e.generate_rotation_crs(shares[0])
    shares += [e.multiparty_create_key_switching_key(s, s, a=crs)
               for s in sks[1:]]
    summed = e.multiparty_sum_evk_share(shares)
    mults = [e.multiparty_mult_evk_share_sum(summed, s) for s in sks]
    return summed, mults, e.multiparty_sum_evk_share_mult(mults)


def _rotation_key(e, sks, delta=1):
    rotk0 = e.multiparty_create_rotation_key(sks[0], delta)
    crs = e.generate_rotation_crs(rotk0)
    return e.multiparty_generate_rotation_key(
        [rotk0] + [e.multiparty_create_rotation_key(s, delta, a=crs)
                   for s in sks[1:]])


def _galois_key(e, sks):
    gk0 = e.create_galois_key(sks[0])
    crs = e.generate_galois_crs(gk0)
    return e.multiparty_generate_galois_key(
        [gk0] + [e.multiparty_create_galois_key(s, crs) for s in sks[1:]])


@pytest.fixture(scope="module")
def port_engine():
    return liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)


@pytest.fixture(scope="module", params=[2, 3], ids=["2 parties", "3 parties"])
def mp(request, shared_eng, port_engine):
    je, te = shared_eng, port_engine
    sks = [te.create_secret_key() for _ in range(request.param)]
    r = dict(je=je, te=te, sks=sks, sks_j=[_to_jax(s) for s in sks],
             q=np.array(te.ctx.q, dtype=np.int64))
    r["cpk"] = _both(r, _collective_pk)
    rng = np.random.default_rng(31 + request.param)
    r["m"] = rng.uniform(-1, 1, te.num_slots) + 1j * rng.uniform(
        -1, 1, te.num_slots)
    r["ct"] = _both(r, lambda e, _: e.encorypt(
        r["m"], r["cpk"][e is te]))
    r["evk"] = _both(r, _evk_steps)
    return r


def test_collective_public_key_equals_jax_mod_q(mp):
    kj, kt = mp["cpk"]
    assert kt.origin == "public key"
    assert _key_equal_mod_q(kj, kt, mp["q"])


def test_ciphertext_under_collective_key_equals_jax(mp):
    cj, ct = mp["ct"]
    for j, t in zip(cj.data, ct.data):
        assert np.array_equal(_jax_words(j), t.numpy())


def test_decrypt_head_partial_and_fusion_equal_jax(mp):
    (cj, ct), je, te = mp["ct"], mp["je"], mp["te"]
    heads = (je.multiparty_decrypt_head(cj, mp["sks_j"][0]),
             te.multiparty_decrypt_head(ct, mp["sks"][0]))
    assert _equal_mod_q(*heads, mp["q"])
    for sj, st in zip(mp["sks_j"][1:], mp["sks"][1:]):
        assert _equal_mod_q(je.multiparty_decrypt_partial(cj, sj),
                            te.multiparty_decrypt_partial(ct, st), mp["q"])
    dj = _threshold_decrypt(je, cj, mp["sks_j"])
    dt = _threshold_decrypt(te, ct, mp["sks"])
    assert np.array_equal(np.asarray(dj), dt)
    assert abs(te.absmax_error(dt[:te.num_slots], mp["m"])) < TOL


@pytest.mark.parametrize("step", ["sum of shares", "share products",
                                  "collective evk"])
def test_collective_evk_steps_equal_jax_mod_q(mp, step):
    (sj, mj, ej), (st, mt, et) = mp["evk"]
    kj, kt = {"sum of shares": (sj, st), "share products": (mj, mt),
              "collective evk": (ej, et)}[step]
    assert _key_equal_mod_q(kj, kt, mp["q"])


def test_mult_under_collective_evk_equals_jax(mp):
    (cj, ct), (ej, et) = mp["ct"], (mp["evk"][0][2], mp["evk"][1][2])
    mj = mp["je"].mult(cj, cj, ej)
    mt = mp["te"].mult(ct, ct, et)
    assert mt.level == mj.level == 1
    for j, t in zip(mj.data, mt.data):
        assert np.array_equal(_jax_words(j), t.numpy())
    dec = _threshold_decrypt(mp["te"], mt, mp["sks"])
    assert abs(mp["te"].absmax_error(dec[:mp["te"].num_slots],
                                     mp["m"] * mp["m"])) < TOL


def test_collective_rotation_key_and_rotate_equal_jax(mp):
    kj, kt = _both(mp, _rotation_key)
    assert kt.origin == "rotation key:1"
    assert _key_equal_mod_q(kj, kt, mp["q"])
    (cj, ct) = mp["ct"]
    rj, rt = mp["je"].rotate_single(cj, kj), mp["te"].rotate_single(ct, kt)
    for j, t in zip(rj.data, rt.data):
        assert np.array_equal(_jax_words(j), t.numpy())
    dec = _threshold_decrypt(mp["te"], rt, mp["sks"])
    assert abs(mp["te"].absmax_error(dec[:mp["te"].num_slots],
                                     np.roll(mp["m"], 1))) < TOL


@pytest.fixture(scope="module")
def galois(mp):
    return _both(mp, _galois_key)


def test_collective_galois_key_equals_jax_mod_q(mp, galois):
    """Its 7 rotation keys (delta 2^i) at logN 8."""
    gj, gt = galois
    assert gt.origin == "galois key" and len(gt.data) == 7
    for i in range(7):
        assert gt.data[i].origin == f"rotation key:{2 ** i}"
        assert _key_equal_mod_q(gj.data[i], gt.data[i], mp["q"]), i


def test_rotate_galois_under_collective_key_equals_jax(mp, galois):
    (cj, ct), (gj, gt) = mp["ct"], galois
    rj = mp["je"].rotate_galois(cj, gj, 3)
    rt = mp["te"].rotate_galois(ct, gt, 3)
    for j, t in zip(rj.data, rt.data):
        assert np.array_equal(_jax_words(j), t.numpy())
    dec = _threshold_decrypt(mp["te"], rt, mp["sks"])
    assert abs(mp["te"].absmax_error(dec[:mp["te"].num_slots],
                                     np.roll(mp["m"], 3))) < TOL


def test_crs_equal_across_engines_of_one_seed():
    """Two engines of one seed draw the same CRS: common randomness is
    generated, not sent."""
    params = dict(PARAMS, num_scales=3, seed=1234)
    e1, e2 = (liberate_tpu_torch.CkksEngine(device="cpu", **params)
              for _ in range(2))
    a1, a2 = (e.rng.randint(amax=e.ntt.q_ints(0, -2), repeats=e.num_special)
              for e in (e1, e2))
    assert torch.equal(a1, a2)
    pk1, pk2 = (e.multiparty_create_public_key(e.create_secret_key())
                for e in (e1, e2))
    assert torch.equal(e1.multiparty_public_crs(pk1),
                       e2.multiparty_public_crs(pk2))


def test_wrong_origins_raise(mp):
    te, sk = mp["te"], mp["sks"][0]
    cpk, ct = mp["cpk"][1], mp["ct"][1]
    with pytest.raises(errors.NotMatchType):
        te.generate_rotation_crs(cpk)
    with pytest.raises(errors.NotMatchType):
        te.generate_galois_crs(mp["evk"][1][2])
    with pytest.raises(errors.NotMatchType):
        te.multiparty_create_galois_key(ct, [])
    with pytest.raises(errors.NotMatchType):
        te.multiparty_mult_evk_share_sum(mp["evk"][1][0], cpk)
    with pytest.raises(errors.SecretKeyNotIncludeSpecialPrime):
        te.multiparty_mult_evk_share_sum(
            mp["evk"][1][0], te.create_secret_key(include_special=False))
    with pytest.raises(errors.NotMatchType):
        te.multiparty_create_public_key(cpk)


# -- the tensor-core domain ------------------------------------------------------


@pytest.fixture(scope="module")
def domains():
    """Three parties' collective keys in each domain, from one seed, each
    step at the same CSPRNG steps: the same secrets and errors. A CRS is
    drawn as NTT-domain words, which the two domains order differently, so
    the tensor-core engine takes the butterfly engine's CRS carried over
    through the coefficient domain: the same keys in coefficients."""
    b, m = (liberate_tpu_torch.CkksEngine(device="cpu", **kw, **PARAMS)
            for kw in ({}, dict(use_mxu_ntt=True)))

    def both(make_b, make_m):
        steps = b.rng.steps.copy()
        out_b = make_b()
        m.rng.steps[:] = steps
        return out_b, make_m()

    def carried(a, mult_type):
        return ops.ntt(ops.intt(a, b.pack(0, mult_type)),
                       m.pack(0, mult_type))

    sks = [both(b.create_secret_key, m.create_secret_key) for _ in range(3)]
    crs = b.multiparty_public_crs(b.multiparty_create_public_key(sks[0][0]))
    crs_m = carried(crs, -1)
    pks = [both(lambda s=s: b.multiparty_create_public_key(s[0], a=crs),
                lambda s=s: m.multiparty_create_public_key(s[1], a=crs_m))
           for s in sks]

    def ksk_crs(make):
        a = b.generate_rotation_crs(make(sks[0][0]))
        return a, [carried(x, -2) for x in a]

    crs, crs_m = ksk_crs(lambda s: b.create_key_switching_key(s, s))
    shares = [both(lambda s=s: b.multiparty_create_key_switching_key(
        s[0], s[0], a=crs), lambda s=s: m.multiparty_create_key_switching_key(
        s[1], s[1], a=crs_m)) for s in sks]
    crs, crs_m = ksk_crs(lambda s: b.create_rotation_key(s, 1))
    rotks = [both(lambda s=s: b.multiparty_create_rotation_key(s[0], 1,
                                                               a=crs),
                  lambda s=s: m.multiparty_create_rotation_key(s[1], 1,
                                                               a=crs_m))
             for s in sks]
    out = {}
    for i, (name, e) in enumerate((("butterfly", b), ("MXU", m))):
        mine = [s[i] for s in sks]
        summed = e.multiparty_sum_evk_share([s[i] for s in shares])
        out[name] = dict(
            e=e, sks=mine,
            cpk=e.multiparty_create_collective_public_key(
                [k[i] for k in pks]),
            evk=e.multiparty_sum_evk_share_mult(
                [e.multiparty_mult_evk_share_sum(summed, s) for s in mine]),
            rotk=e.multiparty_generate_rotation_key([k[i] for k in rotks]))
    return out


def _coefficients(e, key):
    """A key's polynomials in the coefficient domain (the domain's inverse
    transform), reduced to [0, q)."""
    q = np.array(e.ctx.q, dtype=np.int64)

    def leaves(x):
        if hasattr(x, "origin"):
            return leaves(x.data)
        if isinstance(x, (tuple, list)):
            return [t for d in x for t in leaves(d)]
        return [x]

    out = []
    for t in leaves(key):
        pack = e.pack(0, -2 if t.shape[0] > e.num_ordinary else -1)
        out.append(ops.intt(t, pack).numpy() % q[:t.shape[0], None])
    return out


@pytest.mark.parametrize("key", ["cpk", "evk", "rotk"])
def test_mxu_collective_keys_equal_butterfly_in_coefficients(domains, key):
    b, m = domains["butterfly"], domains["MXU"]
    for x, y in zip(_coefficients(b["e"], b[key]),
                    _coefficients(m["e"], m[key])):
        assert np.array_equal(x, y)


def test_mxu_threshold_decrypted_mult(domains):
    d = domains["MXU"]
    e = d["e"]
    m = np.linspace(-1, 1, e.num_slots)
    ct = e.encorypt(m, d["cpk"])
    out = e.rotate_single(e.mult(ct, ct, d["evk"]), d["rotk"])
    dec = _threshold_decrypt(e, out, d["sks"])
    assert abs(e.absmax_error(dec[:e.num_slots], np.roll(m * m, 1))) < TOL
