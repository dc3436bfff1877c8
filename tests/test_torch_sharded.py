"""The RNS-channel-sharded engine (``CkksEngine(mesh=make_mesh(n))``) on the
CPU, ranks as gloo threads of this process, over the cases of
``tests/test_sharded.py``: mult with relinearisation and rescale at 8 and 4
ranks on divisible (C0_sp = 8) and non-divisible (C0_sp = 6) channel
counts, ``level_up``, ``rotate_single``, threshold decryption and the
import of single-device data (``shard_datastruct``).

The oracle is the port's single-device engine, which the other
``test_torch_*`` files hold against the JAX package: at the same seed
every key and ciphertext gathered from the ranks (``engine.gather``) is its
words, raw, and every rank decodes its message."""

import numpy as np
import pytest
import torch

import liberate_tpu_torch
from liberate_tpu_torch import DataStruct
from liberate_tpu_torch.parallel import (make_mesh, make_mesh2d, run_ranks,
                                         shard_datastruct)

# As tests/test_sharded.py: num_scales=5, nsp=2 -> C0_sp = 8 (divisible by
# 8, its levels not); num_scales=3 -> C0_sp = 6 (divisible by neither).
PARAMS_DIV = dict(logN=8, scale_bits=30, num_scales=5, num_special_primes=2,
                  is_secured=False, seed=20260816)
PARAMS_NONDIV = dict(logN=8, scale_bits=30, num_scales=3,
                     num_special_primes=2, is_secured=False, seed=7)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _messages(k, slots, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
            for _ in range(k)]


def _tensors(x):
    if isinstance(x, DataStruct):
        return _tensors(x.data)
    if isinstance(x, (tuple, list)):
        return [t for d in x for t in _tensors(d)]
    return [x]


def _run(params, n, flow):
    """flow(engine) -> {name: DataStruct, tensor or decoded message} on the
    single-device engine and on n ranks (DataStructs gathered); asserts
    every rank's results are the single-device ones, words raw and
    messages equal, and returns them."""
    want = flow(liberate_tpu_torch.CkksEngine(device="cpu", **params))

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=make_mesh(n), device="cpu",
                                          **params)
        assert e.channel_quantum == n
        return {k: e.gather(v) if isinstance(v, DataStruct) else v
                for k, v in flow(e).items()}

    for got in run_ranks(n, body, device="cpu"):
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                assert np.array_equal(got[k], w), k
                continue
            if isinstance(w, DataStruct):
                assert (got[k].origin, got[k].level) == (w.origin, w.level)
            a, b = _tensors(got[k]), _tensors(w)
            assert len(a) == len(b), k
            for x, y in zip(a, b):
                assert torch.equal(x, y), k
    return want


@pytest.mark.parametrize("params,n", [
    (PARAMS_DIV, 8),
    (PARAMS_NONDIV, 8),
    (PARAMS_NONDIV, 4),
], ids=["div-8", "nondiv-8", "nondiv-4"])
def test_sharded_mult_relin_rescale(params, n):
    def flow(e):
        m1, m2 = _messages(2, e.num_slots)
        sk = e.create_secret_key()
        pk = e.create_public_key(sk)
        evk = e.create_evk(sk)
        ct1, ct2 = e.encorypt(m1, pk), e.encorypt(m2, pk)
        out = e.mult(ct1, ct2, evk)       # two rescales, products, relin
        return dict(sk=sk, pk=pk, evk=evk, ct1=ct1, ct2=ct2, out=out,
                    dec=e.decrode(out, sk))

    r = _run(params, n, flow)
    m1, m2 = _messages(2, len(r["dec"]))
    assert abs(np.abs(r["dec"] - m1 * m2).max()) < TOL


def test_sharded_level_up():
    """level_up walks the ciphertext through non-divisible channel counts
    (7 ordinary channels at level 0 down to 4 at level 3, over 8 ranks)."""
    def flow(e):
        (m,) = _messages(1, e.num_slots)
        sk = e.create_secret_key()
        ct = e.encorypt(m, e.create_public_key(sk))
        up = e.level_up(ct, 3)
        return dict(up=up, dec=e.decrode(up, sk))

    r = _run(PARAMS_DIV, 8, flow)
    assert r["up"].level == 3
    (m,) = _messages(1, len(r["dec"]))
    assert np.abs(r["dec"] - m).max() < TOL


def test_sharded_rotate():
    def flow(e):
        (m,) = _messages(1, e.num_slots)
        sk = e.create_secret_key()
        ct = e.encorypt(m, e.create_public_key(sk))
        rotk = e.create_rotation_key(sk, 2)
        rot = e.rotate_single(ct, rotk)
        return dict(rotk=rotk, rot=rot, dec=e.decrode(rot, sk))

    r = _run(PARAMS_NONDIV, 8, flow)
    (m,) = _messages(1, len(r["dec"]))
    assert np.abs(r["dec"] - np.roll(m, 2)).max() < TOL


def test_sharded_threshold_decrypt():
    """Three parties' collective public key, encryption under it, the head
    and partial decryptions (gathered words) and the fusion."""
    def flow(e):
        (m,) = _messages(1, e.num_slots)
        sks = [e.create_secret_key() for _ in range(3)]
        crs, pks = None, []
        for sk in sks:
            pks.append(e.multiparty_create_public_key(sk, a=crs))
            crs = e.multiparty_public_crs(pks[-1])
        cpk = e.multiparty_create_collective_public_key(pks)
        ct = e.encorypt(m, cpk)
        pcts = [e.multiparty_decrypt_head(ct, sks[0])]
        pcts += [e.multiparty_decrypt_partial(ct, sk) for sk in sks[1:]]
        lay = (ct.level, -1)
        return dict(cpk=cpk, ct=ct,
                    pcts=[e._gather(p, *lay) for p in pcts],
                    dec=e.multiparty_decrypt_fusion(pcts, level=ct.level))

    r = _run(PARAMS_NONDIV, 8, flow)
    (m,) = _messages(1, len(r["dec"]))
    assert np.abs(r["dec"] - m).max() < TOL


def test_import_host_data_onto_mesh():
    """A single-device engine's key and ciphertext, cut into each rank's
    padded rows by shard_datastruct, decrypt on a 4-rank engine of the same
    parameters as on the single-device one."""
    eng1 = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS_NONDIV)
    sk = eng1.create_secret_key()
    (m,) = _messages(1, eng1.num_slots)
    ct = eng1.encorypt(m, eng1.create_public_key(sk))
    want = eng1.decrode(ct, sk)

    def body():
        mesh = make_mesh(4)
        e = liberate_tpu_torch.CkksEngine(mesh=mesh, device="cpu",
                                          **PARAMS_NONDIV)
        ct_s, sk_s = shard_datastruct(ct, mesh), shard_datastruct(sk, mesh)
        assert sk_s.data.shape[-2] == 2                 # 6 -> 8 over 4
        assert all(t.shape[-2] == 1 for t in ct_s.data)
        assert e.hash == eng1.hash
        return e.decrode(ct_s, sk_s), e.gather(ct_s)

    for dec, back in run_ranks(4, body, device="cpu"):
        assert np.array_equal(dec, want)
        assert all(torch.equal(a, b) for a, b in zip(back.data, ct.data))
    assert np.abs(want - m).max() < TOL


def test_sharded_other_operations():
    """The rest of the engine on 4 ranks, word for word: add, sub, negate,
    the scalar and message operations, square and relinearize, switch_key
    to a second key, conjugation and mult_batched."""
    def flow(e):
        m1, m2 = _messages(2, e.num_slots, seed=5)
        sk = e.create_secret_key()
        pk = e.create_public_key(sk)
        evk = e.create_evk(sk)
        ct1, ct2 = e.encorypt(m1, pk), e.encorypt(m2, pk)
        sk2 = e.create_secret_key()
        out = dict(
            add=e.add(ct1, ct2), sub=e.sub(ct1, ct2), neg=e.negate(ct1),
            mf=e.mult(ct1, 0.5), mi=e.mult(ct1, 3), mm=e.mult(ct1, m2),
            af=e.add(ct1, 0.25), am=e.add(ct1, m2),
            sq=e.square(ct1, evk, relin=False),
            ks=e.switch_key(ct1, e.create_key_switching_key(sk, sk2)),
            conj=e.conjugate(ct1, e.create_conjugation_key(sk)),
            batched=e.mult_batched([ct1, ct2], [ct2, ct1], evk)[1])
        out["relin"] = e.relinearize(out["sq"], evk)
        out["dec_ks"] = e.decrode(out["ks"], sk2)
        out["dec_double"] = e.decrypt_double(ct1, sk)
        out["dec_triplet"] = e.decrypt_triplet(out["sq"], sk)
        return out

    r = _run(PARAMS_NONDIV, 4, flow)
    m1, _ = _messages(2, len(r["dec_ks"]), seed=5)
    assert np.abs(r["dec_ks"] - m1).max() < TOL


def test_seed_from_rank_zero():
    """Without a seed the ranks draw rank 0's key: their secret keys are
    one key's rows, which decrypts their ciphertext."""
    params = dict(PARAMS_NONDIV, seed=None)

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh_shape=4, device="cpu",
                                          **params)
        sk = e.create_secret_key()
        (m,) = _messages(1, e.num_slots)
        dec = e.decrode(e.encorypt(m, e.create_public_key(sk)), sk)
        return e.gather(sk).data, np.abs(dec - m).max()

    out = run_ranks(4, body, device="cpu")
    assert all(torch.equal(sk, out[0][0]) for sk, _ in out)
    assert all(err < TOL for _, err in out)


def test_mesh_engine_refusals():
    """A mesh with a coef axis and the tensor-core domain on a mesh wait
    for a later slice; they raise."""
    def body():
        with pytest.raises(NotImplementedError, match="coef axis"):
            liberate_tpu_torch.CkksEngine(mesh=make_mesh2d(1, 2),
                                          device="cpu", **PARAMS_NONDIV)
        with pytest.raises(NotImplementedError, match="butterfly"):
            liberate_tpu_torch.CkksEngine(mesh=make_mesh(2), device="cpu",
                                          use_mxu_ntt=True, **PARAMS_NONDIV)

    run_ranks(2, body, device="cpu")
