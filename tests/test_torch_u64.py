"""The port's int64 word arithmetic against the JAX package's limb
arithmetic (ntt/u64.py) and golden model (ntt/golden.py): bit-exact on
10^4 random words per op, with wrapped negatives, Shoup quotients
>= 2^63 and operands with bit 63 set."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liberate_tpu.ntt import golden, u64 as ju
from liberate_tpu_torch.ntt import u64 as tu

N = 10_000
R = 1 << 62


def _rng():
    return np.random.default_rng(20260816)


def _words(rng, n=N):
    """Random 64-bit patterns, a quarter of them with bit 63 set."""
    return rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64,
                        endpoint=True)


def _moduli(rng, n=N):
    """Odd moduli between 2^39 and 2^61, as the presets' primes."""
    bits = rng.integers(39, 61, size=n)
    q = (rng.integers(0, 1 << 62, size=n) % (1 << bits)) | (1 << bits) | 1
    return q.astype(np.int64)


def _mont_consts(q):
    k = np.array([(-pow(int(qi), -1, R)) % R for qi in q], dtype=np.int64)
    return q & ju.LB_MASK.astype(np.int64), q >> 31, \
        k & ju.LB_MASK.astype(np.int64), k >> 31


def _jx(a):
    """int64 numpy -> (lo, hi) jnp uint32 limb pair."""
    p = ju.from_int64_np(a)
    return jnp.asarray(p[0]), jnp.asarray(p[1])


def _np(pair):
    return ju.to_int64_np(np.stack([np.asarray(pair[0]),
                                    np.asarray(pair[1])]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _below(rng, bound):
    return (rng.integers(0, 1 << 62, size=bound.size) % bound).astype(
        np.int64)


@pytest.mark.parametrize("signed", [False, True])
def test_montmul(signed):
    rng = _rng()
    q = _moduli(rng)
    ql, qh, kl, kh = _mont_consts(q)
    a = _words(rng) if signed else _below(rng, 2 * q)
    b = _below(rng, 2 * q)
    f = tu.montmul_signed if signed else tu.montmul
    got = f(_t(a), _t(b), _t(ql), _t(qh), _t(kl), _t(kh)).numpy()
    assert np.array_equal(got, golden.mont_mult(a, b, ql, qh, kl, kh))
    jf = ju.montmul_signed if signed else ju.montmul
    jc = [jnp.asarray(c.astype(np.uint32)) for c in (ql, qh, kl, kh)]
    assert np.array_equal(got, _np(jf(_jx(a), _jx(b), *jc)))


@pytest.mark.parametrize("signed", [False, True])
def test_montredc(signed):
    rng = _rng()
    q = _moduli(rng)
    ql, qh, kl, kh = _mont_consts(q)
    a = _words(rng) if signed else _below(rng, np.full(N, R))
    f = tu.montredc_signed if signed else tu.montredc
    got = f(_t(a), _t(ql), _t(qh), _t(kl), _t(kh)).numpy()
    assert np.array_equal(got, golden.mont_redc(a, ql, qh, kl, kh))
    jf = ju.montredc_signed if signed else ju.montredc
    jc = [jnp.asarray(c.astype(np.uint32)) for c in (ql, qh, kl, kh)]
    assert np.array_equal(got, _np(jf(_jx(a), *jc)))


def test_mulhi64():
    rng = _rng()
    a, b = _words(rng), _words(rng)
    got = tu.mulhi64(_t(a), _t(b)).numpy()
    assert np.array_equal(got, _np(ju.mulhi64(_jx(a), _jx(b))))
    au, bu = a.view(np.uint64), b.view(np.uint64)
    for i in range(0, N, 997):
        assert int(got[i]) & ((1 << 64) - 1) == \
            (int(au[i]) * int(bu[i])) >> 64


def test_shoup_mul_and_quotient():
    rng = _rng()
    q = _moduli(rng)
    # w near q makes the quotient wp = floor(w 2^64 / q) >= 2^63.
    w = np.where(rng.random(N) < 0.5, q - 1 - _below(rng, q // 8),
                 _below(rng, q))
    wp_py = [(int(wi) << 64) // int(qi) for wi, qi in zip(w, q)]
    wp = np.array([tu.to_signed(v) for v in wp_py], dtype=np.int64)
    assert (wp < 0).any()
    assert np.array_equal(tu.shoup_quotient(_t(w), _t(q)).numpy(), wp)
    x = _words(rng)
    got = tu.shoup_mul(_t(x), _t(w), _t(wp), _t(q)).numpy()
    assert np.array_equal(
        got, _np(ju.shoup_mul(_jx(x), _jx(w), _jx(wp), _jx(q))))
    gu = got.view(np.uint64)
    assert (gu < 2 * q.view(np.uint64)).all()


def test_barrett_2q():
    rng = _rng()
    q = _moduli(rng)
    bp = np.array([tu.to_signed((1 << 64) // int(qi)) for qi in q],
                  dtype=np.int64)
    x = _words(rng)
    got = tu.barrett_2q(_t(x), _t(bp), _t(q)).numpy()
    assert np.array_equal(got, _np(ju.barrett_2q(_jx(x), _jx(bp), _jx(q))))


def test_compares():
    rng = _rng()
    a, b = _words(rng), _words(rng)
    b[:100] = a[:100]
    ta, tb = _t(a), _t(b)
    assert np.array_equal(tu.lt_unsigned(ta, tb).numpy(),
                          np.asarray(ju.lt_unsigned(_jx(a), _jx(b))))
    assert np.array_equal(tu.lt_signed(ta, tb).numpy(),
                          np.asarray(ju.lt_signed(_jx(a), _jx(b))))
