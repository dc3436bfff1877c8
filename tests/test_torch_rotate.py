"""The port's rotations, conjugation, their keys and the statistics built on
them against the JAX package, on the CPU.

At the shared_eng parameters (logN 8, scale_bits 30, 8 scales, 2 special
primes, seed 20260816): the port makes the secret key, public key, evk and
ciphertext; the JAX engine gets them through ``interop``. Each engine makes
its own rotation, conjugation and Galois keys from that secret key, with
the port's CSPRNG at the JAX engine's stream steps, so both draw the same
words. Keys are NTT-domain lazy [0, 2q) words: the port's Shoup twiddles
give other representatives than the JAX CPU path's Montgomery ones, so
they are compared reduced to [0, q). Rotated ciphertexts end in a reduce
and are compared raw:

- rotation (delta 1 and 3) and conjugation keys, and every rotation key of
  the Galois key, equal mod q;
- ``rotate_single`` (delta 1, 3), ``conjugate``, ``rotate_galois`` (delta 3
  and num_slots - 1), ``sum`` and ``mean``: words equal, decoded error
  against np.roll, np.conj, the sum and the mean;
- a Galois key carried JAX -> port rotates to the port key's words;
- ``cov``, ``pow(5)``, ``var``, ``sqrt(e=0.3, alpha=0.2)`` and ``std``
  (its sqrt replaced at the wire, as ``tests/test_engine_math.py`` does):
  each runs the JAX engine at several new levels (10-30 s of compiling
  on the CPU), so the port's decoded error is held to
  ``tests/test_engine_math.py``'s tolerances instead: 1e-3, 0.05 for
  sqrt.

In the tensor-core domain (``test_torch_mxu.py``'s parameters: logN 8,
scale_bits 40, 3 scales): the rotated secret key brought back to the
coefficient domain equals the butterfly domain's mod q; ``rotate_single``
and ``conjugate`` give the words of a JAX engine on its MXU kernel path in
interpret mode, on the port's keys and ciphertext (one JAX program: the
rotation hop at level 0 serves both).
"""

import numpy as np
import pytest

import liberate_tpu
import liberate_tpu_torch
from liberate_tpu_torch.ntt import ops
from test_torch_engine import PARAMS, _assert_words_equal, _jax_words, \
    _to_jax, _to_port
from test_torch_mxu import PARAMS as MXU_PARAMS
from test_torch_mxu import SEED, _MxuKernelPath

TOL = 1e-5
MATH_TOL = 1e-3        # tests/test_engine_math.py: pow, cov, var
SQRT_TOL = 0.05        # tests/test_engine_math.py: sqrt


@pytest.fixture(scope="module")
def eng(shared_eng):
    te = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)
    sk = te.create_secret_key()
    pk = te.create_public_key(sk)
    evk = te.create_evk(sk)
    rng = np.random.default_rng(11)
    m = rng.uniform(-1, 1, te.num_slots) + 1j * rng.uniform(
        -1, 1, te.num_slots)
    ct = te.encorypt(m, pk)
    return dict(je=shared_eng, te=te, sk=sk, sk_j=_to_jax(sk), pk=pk,
                evk=evk, m=m, ct=ct, ct_j=_to_jax(ct))


def _make_both(r, make):
    """make(engine, secret key) on the JAX engine, then on the port with its
    CSPRNG at the JAX engine's steps."""
    r["te"].rng.steps[:] = r["je"].rng.steps
    out = make(r["je"], r["sk_j"]), make(r["te"], r["sk"])
    assert np.array_equal(r["te"].rng.steps, r["je"].rng.steps)
    return out


KEYS = {"rot1": lambda e, sk: e.create_rotation_key(sk, 1),
        "rot3": lambda e, sk: e.create_rotation_key(sk, 3),
        "conj": lambda e, sk: e.create_conjugation_key(sk)}


@pytest.fixture(scope="module")
def keys(eng):
    return {k: _make_both(eng, make) for k, make in KEYS.items()}


@pytest.fixture(scope="module")
def galois(eng):
    return _make_both(eng, lambda e, sk: e.create_galois_key(sk))


def _assert_key_equal_mod_q(kj, kt, q):
    assert kj.origin == kt.origin
    assert len(kj.data) == len(kt.data)
    for pj, pt in zip(kj.data, kt.data):
        for j, t in zip(pj.data, pt.data):
            jw, tw = _jax_words(j), t.numpy()
            qc = q[:jw.shape[0], None]
            assert np.array_equal(jw % qc, tw % qc)


@pytest.mark.parametrize("key", sorted(KEYS))
def test_rotation_keys_equal_jax_mod_q(eng, keys, key):
    kj, kt = keys[key]
    assert kt.origin == {"rot1": "rotation key:1", "rot3": "rotation key:3",
                         "conj": "conjugation key"}[key]
    _assert_key_equal_mod_q(kj, kt, np.array(eng["te"].ctx.q, np.int64))


@pytest.mark.parametrize("i", range(7))
def test_galois_key_equals_jax_mod_q(eng, galois, i):
    """Rotation key i of the Galois key (delta 2^i; logN - 1 = 7 keys)."""
    gj, gt = galois
    assert gt.origin == gj.origin == "galois key"
    assert len(gt.data) == len(eng["te"].galois_deltas) == 7
    assert gt.data[i].origin == f"rotation key:{2 ** i}"
    _assert_key_equal_mod_q(gj.data[i], gt.data[i],
                            np.array(eng["te"].ctx.q, np.int64))


ROTATIONS = {
    "rot1": (lambda e, c, k: e.rotate_single(c, k), lambda m: np.roll(m, 1)),
    "rot3": (lambda e, c, k: e.rotate_single(c, k), lambda m: np.roll(m, 3)),
    "conj": (lambda e, c, k: e.conjugate(c, k), np.conj),
}


@pytest.mark.parametrize("case", sorted(ROTATIONS))
def test_rotate_words_equal_jax(eng, keys, case):
    op, want = ROTATIONS[case]
    kj, kt = keys[case]
    out_j = op(eng["je"], eng["ct_j"], kj)
    out_t = op(eng["te"], eng["ct"], kt)
    _assert_words_equal(out_j, out_t)
    err = eng["te"].absmax_error(eng["te"].decrode(out_t, eng["sk"]),
                                 want(eng["m"]))
    assert abs(err) < TOL


@pytest.mark.parametrize("delta", [3, 127])
def test_rotate_galois_words_equal_jax(eng, galois, delta):
    """delta 3 = 2 + 1; num_slots - 1 = 127 runs all seven keys."""
    gj, gt = galois
    out_j, circ_j = eng["je"].rotate_galois(eng["ct_j"], gj, delta,
                                            return_circuit=True)
    out_t, circ_t = eng["te"].rotate_galois(eng["ct"], gt, delta,
                                            return_circuit=True)
    assert circ_t == circ_j
    _assert_words_equal(out_j, out_t)
    err = eng["te"].absmax_error(eng["te"].decrode(out_t, eng["sk"]),
                                 np.roll(eng["m"], delta))
    assert abs(err) < TOL


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_sum_mean_words_equal_jax(eng, galois, op):
    gj, gt = galois
    out_j = getattr(eng["je"], op)(eng["ct_j"], gj)
    out_t = getattr(eng["te"], op)(eng["ct"], gt)
    _assert_words_equal(out_j, out_t)
    want = getattr(np, op)(eng["m"])
    err = eng["te"].absmax_error(eng["te"].decrode(out_t, eng["sk"]),
                                 np.full(eng["te"].num_slots, want))
    assert abs(err) < TOL


def test_jax_galois_key_rotates_in_the_port(eng, galois):
    """The JAX engine's Galois key carried to the port (a list of rotation
    keys, each a list of key-switching parts) rotates to the words of the
    port's own key."""
    gj, gt = galois
    carried = _to_port(gj)
    assert [k.origin for k in carried.data] == [k.origin for k in gt.data]
    te = eng["te"]
    a = te.rotate_galois(eng["ct"], carried, 5)
    b = te.rotate_galois(eng["ct"], gt, 5)
    for x, y in zip(a.data, b.data):
        assert np.array_equal(x.numpy(), y.numpy())


def _real_ct(eng, x):
    te = eng["te"]
    te.rng.steps[:] = 3
    return te.encorypt(x, eng["pk"])


@pytest.mark.parametrize("op", ["cov", "pow", "var", "sqrt", "std"])
def test_statistics_decoded_error(eng, galois, op, monkeypatch):
    te, evk, gk = eng["te"], eng["evk"], galois[1]
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, te.num_slots)
    tol = MATH_TOL
    if op == "sqrt":
        x = rng.uniform(0.35, 0.95, te.num_slots)
    ct = _real_ct(eng, x)
    if op == "cov":
        y = rng.uniform(-1, 1, te.num_slots)
        out = te.cov(ct, _real_ct(eng, y), evk, gk)
        want = (x - x.mean()) * (y - y.mean()) / (te.num_slots - 1)
    elif op == "pow":
        out, want = te.pow(ct, 5, evk), x ** 5
    elif op == "var":
        out = te.var(ct, evk, gk)
        want = np.full(te.num_slots, ((x - x.mean()) ** 2).mean())
    elif op == "sqrt":
        out, want = te.sqrt(ct, evk, e=0.3, alpha=0.2), np.sqrt(x)
        tol = SQRT_TOL
    else:
        # std = sqrt(var), checked at the wire as test_engine_math.py
        # does: the default (e, alpha) iterations outrun the 8 levels.
        monkeypatch.setattr(te, "sqrt", lambda ct_in, evk_in, **kw: ct_in)
        out = te.std(ct, evk, gk)
        want = np.full(te.num_slots, ((x - x.mean()) ** 2).mean())
    dec = te.decrode(out, eng["sk"], is_real=True)
    assert abs(te.absmax_error(dec, want)) < tol


# -- the tensor-core domain --------------------------------------------------------


@pytest.mark.parametrize("key", ["rot1", "conj"])
def test_mxu_rotated_sk_equals_butterfly_mod_q(eng, key):
    """The two domains' secret keys from the same CSPRNG words, rotated in
    each engine's own domain and brought back to the coefficient domain by
    its inverse transform: equal mod q."""
    from liberate_tpu_torch.fhe.encdec import encdec

    N = eng["te"].ctx.N
    perm = (encdec.rotate_perm_data(N, 1) if key == "rot1"
            else encdec.conjugate_perm_data(N))
    coef = []
    for mxu in (False, True):
        e = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=mxu,
                                          **PARAMS)
        rot = e._rotated_sk(e.create_secret_key(), (key,), perm)
        pack = e.pack(0, -1)
        coef.append(ops.reduce_2q(ops.reduce_2q(
            ops.intt(rot.data, pack), pack), pack).numpy())
    q = np.array(eng["te"].ntt.q_ints(0, -1), np.int64)[:, None]
    assert np.array_equal(coef[0] % q, coef[1] % q)


@pytest.fixture(scope="module")
def mxu():
    te = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                       seed=SEED, **MXU_PARAMS)
    sk = te.create_secret_key()
    rng = np.random.default_rng(17)
    m = rng.uniform(-1, 1, te.num_slots) + 1j * rng.uniform(
        -1, 1, te.num_slots)
    ct = te.encorypt(m, te.create_public_key(sk))
    keys = {"rot1": te.create_rotation_key(sk, 1),
            "conj": te.create_conjugation_key(sk)}
    outs = {"rot1": te.rotate_single(ct, keys["rot1"]),
            "conj": te.conjugate(ct, keys["conj"])}
    with _MxuKernelPath():
        je = liberate_tpu.CkksEngine(seed=SEED, **MXU_PARAMS)
        assert je._mxu_fused_switch()
        ct_j = _to_jax(ct)
        jax_outs = {"rot1": je.rotate_single(ct_j, _to_jax(keys["rot1"])),
                    "conj": je.conjugate(ct_j, _to_jax(keys["conj"]))}
    return dict(te=te, sk=sk, m=m, outs=outs, jax_outs=jax_outs)


@pytest.mark.parametrize("case", ["rot1", "conj"])
def test_mxu_rotate_words_equal_jax_mxu_kernels(mxu, case):
    _assert_words_equal(mxu["jax_outs"][case], mxu["outs"][case])
    want = np.roll(mxu["m"], 1) if case == "rot1" else np.conj(mxu["m"])
    te = mxu["te"]
    err = te.absmax_error(te.decrode(mxu["outs"][case], mxu["sk"]), want)
    assert abs(err) < 1e-4
