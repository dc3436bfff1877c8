"""The engine on a mesh with a ``coef`` axis (``CkksEngine(mesh=
make_mesh2d(r, s))``) on the CPU, ranks as gloo threads of this process:
the flows of ``tests/test_coef_shard.py``'s ``test_engine_on_2d_mesh`` and
``test_multiparty_on_2d_mesh`` on a (2 rns x 2 coef) and a coefficient-only
(1 x 4) mesh, at C0_sp = 6 (its layouts past level 0, of 3 and 5
channels, are padded to the 2 rns ranks);
the constant and plaintext additions in the coefficient domain (only
coefficient shard 0 holds the DC coefficient), conjugation, ``level_up``,
rank 0's key on every rank without a seed, ``shard_datastruct`` onto the
mesh and back, and the ``ops`` transforms of a coef pack.

The oracle is the port's single-device engine, which the other
``test_torch_*`` files hold against the JAX package: at the same seed every
key and ciphertext gathered from the ranks (``engine.gather``, along both
axes) is its words, raw, and every rank decodes its message within
``tests/test_coef_shard.py``'s bounds."""

import numpy as np
import pytest
import torch

import liberate_tpu_torch
from liberate_tpu_torch import DataStruct
from liberate_tpu_torch.ntt import ops
from liberate_tpu_torch.parallel import (make_mesh2d, run_ranks,
                                         shard_datastruct)

PARAMS = dict(logN=8, scale_bits=30, num_scales=3, num_special_primes=2,
              is_secured=False, seed=7)
SHAPES = [(2, 2), (1, 4)]
IDS = ["2x2", "1x4"]


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


def _run(shape, flow, params=PARAMS):
    """flow(engine) -> {name: DataStruct, tensors or decoded message} on the
    single-device engine and on the ranks of a make_mesh2d(*shape) mesh
    (DataStructs gathered); asserts every rank's are the single-device
    ones, words raw and messages equal, and returns them."""
    want = flow(liberate_tpu_torch.CkksEngine(device="cpu", **params))

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=make_mesh2d(*shape),
                                          device="cpu", **params)
        pack = e.pack(0, -2)
        assert pack.coef is not None and pack.plan is None
        assert pack.coef.local.logN == 8 - (shape[1].bit_length() - 1)
        return {k: e.gather(v) if isinstance(v, DataStruct) else v
                for k, v in flow(e).items()}

    for got in run_ranks(shape[0] * shape[1], body, device="cpu"):
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


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_engine_on_2d_mesh(shape):
    """Keys, encorypt, mult with relinearisation and rescale, a rotation
    key and rotate_single (the Galois permutation gathers along coef);
    add_scalar, sub_scalar and a plaintext add in the coefficient domain,
    add, mult by a message, conjugation and level_up."""
    def flow(e):
        m, m2 = _messages(2, e.num_slots)
        sk = e.create_secret_key()
        pk = e.create_public_key(sk)
        evk = e.create_evk(sk)
        ct, ct2 = e.encorypt(m, pk), e.encorypt(m2, pk)
        rotk = e.create_rotation_key(sk, 1)
        out = dict(ct=ct, prod=e.mult(ct, ct, evk),
                   rot=e.rotate_single(ct, rotk), af=e.add(ct, 0.25),
                   sf=e.sub(ct, 0.5), am=e.add(ct, m2), add=e.add(ct, ct2),
                   mm=e.mult(ct, m2),
                   conj=e.conjugate(ct, e.create_conjugation_key(sk)),
                   up=e.level_up(ct, 2))
        out.update({f"dec_{k}": e.decrode(v, sk) for k, v in out.items()})
        return dict(out, sk=sk, pk=pk, evk=evk, rotk=rotk)

    r = _run(shape, flow)
    m, m2 = _messages(2, len(r["dec_ct"]))
    assert np.abs(r["dec_ct"] - m).max() < 1e-6
    for k, want in (("prod", m * m), ("rot", np.roll(m, 1)),
                    ("af", m + 0.25), ("sf", m - 0.5), ("am", m + m2),
                    ("add", m + m2), ("mm", m * m2), ("conj", m.conj()),
                    ("up", m)):
        assert np.abs(r[f"dec_{k}"] - want).max() < 1e-5, k
    assert r["up"].level == 2


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_multiparty_on_2d_mesh(shape):
    """Three parties' collective public key and threshold decryption; the
    head and partial decryptions gathered along both axes."""
    def flow(e):
        (m,) = _messages(1, e.num_slots, seed=4)
        sks = [e.create_secret_key() for _ in range(3)]
        pk0 = e.multiparty_create_public_key(sks[0])
        crs = e.multiparty_public_crs(pk0)
        pks = [pk0] + [e.multiparty_create_public_key(s, a=crs)
                       for s in sks[1:]]
        cpk = e.multiparty_create_collective_public_key(pks)
        ct = e.encorypt(m, cpk)
        pcts = [e.multiparty_decrypt_head(ct, sks[0])]
        pcts += [e.multiparty_decrypt_partial(ct, s) for s in sks[1:]]
        lay = (ct.level, -1)
        return dict(cpk=cpk, ct=ct,
                    pcts=[e._gather_full(p, *lay) for p in pcts],
                    dec=e.multiparty_decrypt_fusion(pcts, level=ct.level))

    r = _run(shape, flow, dict(PARAMS, seed=9))
    (m,) = _messages(1, len(r["dec"]), seed=4)
    assert np.abs(r["dec"] - m).max() < 1e-5


def test_key_from_rank_zero_on_2d_mesh():
    """Without a seed every rank, whatever its coef index, draws rank 0's
    key: the gathered secret keys are one key, which decrypts."""
    params = dict(PARAMS, seed=None)

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=make_mesh2d(2, 2),
                                          device="cpu", **params)
        sk = e.create_secret_key()
        (m,) = _messages(1, e.num_slots)
        dec = e.decrode(e.encorypt(m, e.create_public_key(sk)), sk)
        return e.gather(sk).data, np.abs(dec - m).max()

    out = run_ranks(4, body, device="cpu")
    assert all(torch.equal(sk, out[0][0]) for sk, _ in out)
    assert all(err < 1e-6 for _, err in out)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_import_host_data_onto_2d_mesh(shape):
    """A single-device engine's key and ciphertext, cut into each rank's
    padded rows and coefficient columns by shard_datastruct, decrypt on the
    mesh engine as on the single-device one, and gather back to the same
    words."""
    eng1 = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)
    sk = eng1.create_secret_key()
    (m,) = _messages(1, eng1.num_slots)
    ct = eng1.encorypt(m, eng1.create_public_key(sk))
    want = eng1.decrode(ct, sk)
    n_rns, n_coef = shape

    def body():
        mesh = make_mesh2d(*shape)
        e = liberate_tpu_torch.CkksEngine(mesh=mesh, device="cpu", **PARAMS)
        ct_s, sk_s = shard_datastruct(ct, mesh), shard_datastruct(sk, mesh)
        assert sk_s.data.shape == (6 // n_rns, eng1.ctx.N // n_coef)
        return e.decrode(ct_s, sk_s), e.gather(ct_s), e.gather(sk_s)

    for dec, back, sk_back in run_ranks(4, body, device="cpu"):
        assert np.array_equal(dec, want)
        assert all(torch.equal(a, b) for a, b in zip(back.data, ct.data))
        assert torch.equal(sk_back.data, sk.data)


@pytest.mark.parametrize("name", ["ntt", "enter_ntt", "intt", "intt_exit",
                                  "intt_exit_reduce", "intt_reduce",
                                  "intt_no_norm"])
def test_ops_on_a_coef_pack(name):
    """Each ``ops`` transform of a (2 x 2) rank's pack runs the
    coefficient-sharded one: joined along the coef axis, the single-device
    words of the rank's rows."""
    eng1 = liberate_tpu_torch.CkksEngine(device="cpu", **PARAMS)
    full = eng1.pack(0, -2)
    q = full.q[:, None]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(0, 1 << 62, size=(2, 6, eng1.ctx.N))
                         % q.numpy())
    fn = getattr(ops, name)
    want = fn(x, full)

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=make_mesh2d(2, 2),
                                          device="cpu", **PARAMS)
        rows = e.ntt.rows(0, -2)
        got = fn(e._local(x, 0, -2), e.pack(0, -2))
        return rows, e._gather_full(got, 0, -2)

    for rows, got in run_ranks(4, body, device="cpu"):
        assert rows in ([0, 1, 2], [3, 4, 5])
        assert torch.equal(got, want)
