"""The tensor-core domain on an RNS-channel mesh (``CkksEngine(mesh=
make_mesh(n), use_mxu_ntt=True)``) on the CPU, ranks as gloo threads of this
process, the counterpart of ``tests/test_mxu.py``'s
``test_engine_mxu_backend_on_mesh``: at logN 8 and 40-bit scales (two width
groups, as silver's) and C0_sp = 6, which 4 ranks pad to 8, in both key
forms; keys, ``encorypt``, mult, ``rotate_single`` and ``mult_batched``.

The oracle is the port's single-device tensor-core engine, which
``tests/test_torch_mxu.py`` holds against the JAX package: every key and
ciphertext gathered from the ranks is its words mod q (the rank's switch is
the unfolded one, then the gathered mod-down; the single device folds it),
and every rank decodes its message."""

import numpy as np
import pytest
import torch

import liberate_tpu_torch
from liberate_tpu_torch import DataStruct
from liberate_tpu_torch.fhe.engine import switch_route
from liberate_tpu_torch.parallel import make_mesh, run_ranks

PARAMS = dict(logN=8, scale_bits=40, num_scales=3, num_special_primes=2,
              is_secured=False, seed=5)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(x):
    if isinstance(x, DataStruct):
        return _tensors(x.data)
    if isinstance(x, (tuple, list)):
        return [t for d in x for t in _tensors(d)]
    return [x]


def _flow(e):
    rng = np.random.default_rng(3)
    m1, m2 = (rng.uniform(-1, 1, e.num_slots)
              + 1j * rng.uniform(-1, 1, e.num_slots) for _ in range(2))
    sk = e.create_secret_key()
    pk = e.create_public_key(sk)
    evk = e.create_evk(sk)
    rotk = e.create_rotation_key(sk, 1)
    ct1, ct2 = e.encorypt(m1, pk), e.encorypt(m2, pk)
    prod = e.mult(ct1, ct2, evk)
    rot = e.rotate_single(prod, rotk)
    batched = e.mult_batched([ct1, ct2, ct1, ct2], [ct2, ct1, ct1, ct2], evk)
    words = dict(sk=sk, pk=pk, evk=evk, rotk=rotk, ct1=ct1, prod=prod,
                 rot=rot, b3=batched[3])
    decs = dict(prod=(e.decrode(prod, sk), m1 * m2),
                rot=(e.decrode(rot, sk), np.roll(m1 * m2, 1)),
                b3=(e.decrode(batched[3], sk), m2 * m2))
    return words, decs


@pytest.mark.parametrize("shoup_ksk", [True, False], ids=["shoup", "mont"])
@pytest.mark.parametrize("n", [2, 4])
def test_mxu_engine_on_rns_mesh(n, shoup_ksk):
    kw = dict(PARAMS, use_mxu_ntt=True, use_shoup_ksk=shoup_ksk)
    one = liberate_tpu_torch.CkksEngine(device="cpu", **kw)
    want, _ = _flow(one)

    def body():
        e = liberate_tpu_torch.CkksEngine(mesh=make_mesh(n), device="cpu",
                                          **kw)
        groups = e.pack(0, -2).mxu
        assert e.pack(0, -2).plan is None and groups
        # The rank's width groups tile its rows of the padded layout.
        assert groups[0].lo == 0 and groups[-1].hi == len(e.ntt.rows(0, -2))
        words, decs = _flow(e)
        return {k: e.gather(v) for k, v in words.items()}, decs

    for got, decs in run_ranks(n, body, device="cpu"):
        for k, w in want.items():
            q = one.pack(w.level, -2 if w.include_special else -1).q[:, None]
            a, b = _tensors(got[k]), _tensors(w)
            assert len(a) == len(b), k
            for x, y in zip(a, b):
                assert torch.equal(x % q, y % q), k
        for k, (dec, m) in decs.items():
            assert np.abs(dec - m).max() < TOL, k


def test_mesh_switch_route_never_folds():
    """On a mesh the tensor-core switch takes the unfolded kernel of its key
    form; on one device it folds up to FOLD_MAX_LOGN."""
    assert switch_route(8, True) == "mxu_switch"
    assert switch_route(8, True, on_mesh=True) == "mxu_switch_inv"
    assert switch_route(8, False, on_mesh=True) == "mxu_switch_inv_mont"
    assert switch_route(16, True, on_mesh=True) == "mxu_switch_inv"
