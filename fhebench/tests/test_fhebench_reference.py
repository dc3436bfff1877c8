"""The plain reference against the port at small sizes on the CPU: the
secret key it works out from the seed, the primes it works out from the
parameters, and its judgement of the port's ciphertexts."""

import numpy as np
import pytest
import torch
from conftest import ROOT  # noqa: F401  (puts the checkout on the path)

from fhebench.reference.chacha20 import secret_key
from fhebench.reference.ckks import Judge, mulmod
from fhebench.reference.primes import modulus_chain
from liberate_tpu_torch import CkksEngine
from liberate_tpu_torch.fhe.context.ckks_context import CkksContext

SMALL = dict(scale_bits=40, num_scales=3, num_special_primes=2,
             is_secured=False)


def _engine(logN, seed, tmp_path, **kw):
    return CkksEngine(devices="cpu", logN=logN, seed=seed, use_mxu_ntt=True,
                      cache_folder=str(tmp_path), **dict(SMALL, **kw))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77, 2 ** 40 + 3])
def test_secret_key_is_the_engines(seed, tmp_path):
    eng = _engine(10, seed, tmp_path)
    sk = eng.rng.randint(amax=3, shift=-1, repeats=1)[0].numpy()
    assert (secret_key(seed, eng.ctx.N, eng.num_ordinary, eng.num_special)
            == sk).all()


@pytest.mark.parametrize("kw", [
    dict(logN=10, scale_bits=40, num_scales=3, num_special_primes=2),
    dict(logN=15, scale_bits=40, num_special_primes=2),
    dict(logN=16, scale_bits=40, num_special_primes=4),
    dict(logN=16, scale_bits=30, num_special_primes=4)])
def test_primes_are_the_contexts(kw, tmp_path):
    ctx = CkksContext(cache_folder=str(tmp_path), is_secured="num_scales"
                      not in kw, **kw)
    q, L = modulus_chain(kw["logN"], kw["scale_bits"],
                         kw["num_special_primes"], kw.get("num_scales"))
    assert q == ctx.q and L == ctx.num_scales


def test_mulmod_against_python_ints():
    g = torch.Generator().manual_seed(0)
    q = torch.tensor([(1 << 61) - 1, 1152921504606830593, 1099511678977,
                      268369921])[:, None]
    a = torch.randint(0, 1 << 62, (4, 500), generator=g) % q
    b = torch.randint(0, 1 << 62, (4, 500), generator=g) % q
    r = mulmod(a, b, q)
    for i in range(4):
        qi = int(q[i, 0])
        assert [int(v) for v in r[i]] == [int(x) * int(y) % qi
                                          for x, y in zip(a[i], b[i])]


@pytest.mark.parametrize("logN", [10, 12])
def test_judge_holds_the_port(logN, tmp_path):
    seed = 2 ** 31 + logN
    eng = _engine(logN, seed, tmp_path)
    sk = eng.create_secret_key()
    pk = eng.create_public_key(sk)
    evk = eng.create_evk(sk)
    rng = np.random.default_rng(1)
    m = [rng.uniform(-1, 1, eng.num_slots) for _ in range(4)]
    cts = [eng.encorypt(x, pk) for x in m]
    out = eng.mult_batched(cts[:2], cts[2:], evk)
    rk = eng.create_rotation_key(sk, 3)
    dot = eng.add(eng.rotate_single(out[0], rk), out[0])
    q, L = modulus_chain(logN, 40, 2, 3)
    judge = Judge(q, L, 40, secret_key(seed, eng.ctx.N, eng.num_ordinary,
                                       eng.num_special), "cpu")
    # what the port decodes, the reference decodes alike
    for ct, want in ((out[0], m[0] * m[2]), (out[1], m[1] * m[3])):
        err, bad = judge.judge(ct.data, 1, 1, want)
        assert bad == 0 and err < 1e-8
        err_port = np.abs(eng.decrode(ct, sk) - want).max()
        assert err == pytest.approx(err_port, rel=0.05)
    p = m[0] * m[2]
    assert judge.judge(dot.data, 1, 1, p + np.roll(p, 3))[0] < 1e-8
    assert judge.judge(cts[0].data, 0, 0, m[0])[0] < 1e-9
    # an altered word shows in its channel; a wrong answer in the slots
    c0 = out[0].data[0].clone()
    c0[1, 7] += 1
    assert judge.judge((c0, out[0].data[1]), 1, 1, m[0] * m[2])[1] == 1
    assert judge.judge(out[1].data, 1, 1, m[0] * m[2])[0] > 1e-2
    assert judge.judge(cts[0].data, 1, 1, m[0] * m[2])[0] == float("inf")
