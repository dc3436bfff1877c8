"""The port's additions, scalar and plaintext operations and the switch of
an NTT-state ciphertext against the JAX package, on the CPU, at the
shared_eng parameters (logN 8, scale_bits 30, 8 scales, 2 special primes,
seed 20260816).

The port makes the keys and ciphertexts; they reach the JAX engine
through ``interop`` (so the JAX engine runs no keygen or encryption), and
both engines run the same operation on the same words. Every result ends
in a reduce to [0, q), so the words are compared raw, flags included.
Before each operation the port's CSPRNG steps are set to the JAX
engine's: the message operations encode with a randomised rounding.

- ciphertext add, sub and negate, of ciphertexts and of NTT-domain
  triplets, and add across levels (``auto_level``);
- every scalar and message operation through ``mult``, ``add`` and
  ``sub``, each (type, type) pair of the dispatch tables that takes a
  ciphertext and a float, an int, a list or an array;
- ``switch_key`` of an NTT-state ciphertext;
- the dispatch tables name the JAX engine's methods, and ``bool`` raises;
- the tensor-core domain's ``mc_mult`` gives the butterfly domain's
  words.
"""

import numpy as np
import pytest

import liberate_tpu_torch
from liberate_tpu.fhe.presets import errors as jax_errors
from liberate_tpu_torch.fhe.presets import errors
from liberate_tpu_torch.ntt import ops
from test_torch_engine import PARAMS, _assert_words_equal, _to_jax

TOL = 1e-5

# name: (the operation on (engine, ct1, ct2, m2), the slots it decodes to
# from (m1, m2)).
CASES = {
    "cc_add": (lambda e, x, y, m: e.add(x, y), lambda a, b: a + b),
    "cc_sub": (lambda e, x, y, m: e.sub(x, y), lambda a, b: a - b),
    "cc_subtract": (lambda e, x, y, m: e.cc_subtract(x, y),
                    lambda a, b: a - b),
    "negate": (lambda e, x, y, m: e.negate(x), lambda a, b: -a),
    "auto_level_add": (lambda e, x, y, m: e.add(e.level_up(x, 2), y),
                       lambda a, b: a + b),
    "auto_level_sub": (lambda e, x, y, m: e.sub(x, e.level_up(y, 1)),
                       lambda a, b: a - b),
    "mult_scalar": (lambda e, x, y, m: e.mult(x, 0.5), lambda a, b: a / 2),
    "scalar_mult": (lambda e, x, y, m: e.mult(-0.75, x),
                    lambda a, b: -0.75 * a),
    "mult_int_scalar": (lambda e, x, y, m: e.mult(x, 3),
                        lambda a, b: 3 * a),
    "int_scalar_mult": (lambda e, x, y, m: e.mult(-2, x),
                        lambda a, b: -2 * a),
    "add_scalar": (lambda e, x, y, m: e.add(x, 0.5), lambda a, b: a + 0.5),
    "scalar_add": (lambda e, x, y, m: e.add(-0.25, x),
                   lambda a, b: a - 0.25),
    "add_int": (lambda e, x, y, m: e.add(x, 2), lambda a, b: a + 2),
    "int_add": (lambda e, x, y, m: e.add(-1, x), lambda a, b: a - 1),
    "sub_scalar": (lambda e, x, y, m: e.sub(x, 0.5), lambda a, b: a - 0.5),
    "scalar_sub": (lambda e, x, y, m: e.sub(0.5, x), lambda a, b: 0.5 - a),
    "sub_int": (lambda e, x, y, m: e.sub(x, 1), lambda a, b: a - 1),
    "int_sub": (lambda e, x, y, m: e.sub(2, x), lambda a, b: 2 - a),
    "mc_mult": (lambda e, x, y, m: e.mult(m, x), lambda a, b: a * b),
    "mc_mult_list": (lambda e, x, y, m: e.mult(list(m), x),
                     lambda a, b: a * b),
    "cm_mult": (lambda e, x, y, m: e.mult(x, m), lambda a, b: a * b),
    "cm_mult_list": (lambda e, x, y, m: e.mult(x, list(m)),
                     lambda a, b: a * b),
    "mc_add": (lambda e, x, y, m: e.add(m, x), lambda a, b: a + b),
    "cm_add_list": (lambda e, x, y, m: e.add(x, list(m)),
                    lambda a, b: a + b),
    "mc_sub": (lambda e, x, y, m: e.sub(m, x), lambda a, b: b - a),
    "cm_sub": (lambda e, x, y, m: e.sub(x, m), lambda a, b: a - b),
    "reduce_error": (lambda e, x, y, m: e.reduce_error(x),
                     lambda a, b: a),
}


@pytest.fixture(scope="module")
def arith(shared_eng):
    te = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)
    sk = te.create_secret_key()
    pk = te.create_public_key(sk)
    evk = te.create_evk(sk)
    rng = np.random.default_rng(9)
    m1, m2 = (rng.uniform(-1, 1, te.num_slots)
              + 1j * rng.uniform(-1, 1, te.num_slots) for _ in range(2))
    ct1, ct2 = te.encorypt(m1, pk), te.encorypt(m2, pk)
    return dict(je=shared_eng, te=te, sk=sk, evk=evk, m1=m1, m2=m2,
                ct1=ct1, ct2=ct2)


def _both(r, op, *cts):
    """op on the JAX engine and on the port, the port's CSPRNG at the JAX
    engine's steps: (JAX result, port result)."""
    je, te = r["je"], r["te"]
    te.rng.steps[:] = je.rng.steps
    out_j = op(je, *(_to_jax(c) for c in cts))
    out_t = op(te, *cts)
    assert np.array_equal(te.rng.steps, je.rng.steps)
    return out_j, out_t


@pytest.mark.parametrize("case", sorted(CASES))
def test_words_equal_jax(arith, case):
    op, want = CASES[case]
    r = arith
    out_j, out_t = _both(r, lambda e, x, y: op(e, x, y, r["m2"]),
                         r["ct1"], r["ct2"])
    _assert_words_equal(out_j, out_t)
    err = r["te"].absmax_error(r["te"].decrode(out_t, r["sk"]),
                               want(r["m1"], r["m2"]))
    assert abs(err) < TOL


@pytest.mark.parametrize("op", ["add", "sub", "negate"])
def test_triplet_words_equal_jax(arith, op):
    """Of the NTT-domain triplets of mult(relin=False): the results end in
    a reduce, so the words are equal raw."""
    r = arith
    te = r["te"]
    x = te.mult(r["ct1"], r["ct2"], r["evk"], relin=False)
    y = te.mult(r["ct1"], r["ct1"], r["evk"], relin=False)
    fn = {"add": lambda e, a, b: e.add(a, b),
          "sub": lambda e, a, b: e.sub(a, b),
          "negate": lambda e, a, b: e.negate(a)}[op]
    out_j, out_t = _both(r, fn, x, y)
    assert out_t.origin == "cipher text triplet" and out_t.ntt_state
    _assert_words_equal(out_j, out_t)
    m12, m11 = r["m1"] * r["m2"], r["m1"] * r["m1"]
    want = {"add": m12 + m11, "sub": m12 - m11, "negate": -m12}[op]
    err = te.absmax_error(te.decrode(out_t, r["sk"]), want)
    assert abs(err) < TOL


def test_switch_key_of_ntt_state_ciphertext(arith):
    """ct1 of an NTT- and Montgomery-state ciphertext leaves the NTT domain
    (inverse transform, exit, reduce) before the switch; ct0 is added as
    it is. Both engines get the same words."""
    r = arith
    te = r["te"]
    pack = te.pack(0, -1)
    ct = r["ct1"]
    ct_ntt = ct._replace(data=tuple(ops.enter_ntt(d, pack) for d in ct.data),
                         ntt_state=True, montgomery_state=True)
    ksk = te.create_key_switching_key(r["sk"], te.create_secret_key())
    out_j, out_t = _both(r, lambda e, c, k: e.switch_key(c, k), ct_ntt, ksk)
    assert out_t.ntt_state and out_t.montgomery_state
    _assert_words_equal(out_j, out_t)
    # ct1 out is the switch of ct1's coefficient-domain words.
    plain = te.switch_key(ct, ksk)
    assert np.array_equal(out_t.data[1].numpy(), plain.data[1].numpy())


@pytest.mark.parametrize("table", ["mult_dispatch", "add_dispatch",
                                   "sub_dispatch"])
def test_dispatch_names_the_jax_methods(arith, table):
    """Each (type, type) pair reaches the method of the same name as in
    the JAX engine; the port's table names it instead of binding it."""
    def by_type_names(t):
        return {tuple(c.__name__ for c in k): v for k, v in t.items()}

    want = {k: f.__name__ for k, f in
            by_type_names(getattr(arith["je"], table)).items()}
    got = getattr(arith["te"], table)
    assert all(isinstance(v, str) for v in got.values())
    assert by_type_names(got) == want


@pytest.mark.parametrize("op", ["mult", "add", "sub"])
def test_bool_operand_raises(arith, op):
    """type(True) is bool, in no table: both engines raise."""
    ct = arith["ct1"]
    with pytest.raises(errors.DifferentTypeError):
        getattr(arith["te"], op)(ct, True)
    with pytest.raises(jax_errors.DifferentTypeError):
        getattr(arith["je"], op)(True, _to_jax(ct))


def test_mxu_mc_mult_equals_butterfly(arith):
    """mc_mult ends in the inverse transform's reduce and a rescale, in
    the coefficient domain: the tensor-core engine gives the butterfly
    engine's words on the same ciphertext and message."""
    te = arith["te"]
    tm = liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                       **PARAMS)
    outs = []
    for e in (te, tm):
        e.rng.steps[:] = 7
        outs.append(e.mult(arith["m2"], arith["ct1"]))
    for a, b in zip(*(o.data for o in outs)):
        assert np.array_equal(a.numpy(), b.numpy())
    err = te.absmax_error(te.decrode(outs[1], arith["sk"]),
                          arith["m1"] * arith["m2"])
    assert abs(err) < TOL
