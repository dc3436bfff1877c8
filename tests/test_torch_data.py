"""The port's data management on the CPU, against the JAX package where the
two can be compared.

- ``clone`` copies every tensor: an in-place write to the clone leaves the
  source as it was (the port writes some tensors in place; the JAX
  package's arrays are immutable, so its ``clone`` copies structure only);
- ``save``/``load`` round trip (a ciphertext and a nested key, under
  ``tmp_path``), ``load(move_to_device=False)``, ``HashMismatchError`` for
  a file of an engine of other parameters;
- ``move_to`` both ways, ``cpu``/``cuda``/``device_put``, a bad direction;
  ``device()``;
- ``print_data_structure``'s origin and level lines equal the JAX
  engine's for the same DataStruct (the JAX package prints its [2, C, N]
  limb pairs where the port prints [C, N] tensors);
- ``refresh(seed)``: the port's CSPRNG then draws the JAX engine's words;
- ``profile(log_dir)`` writes a trace.
"""

import numpy as np
import pytest
import torch

import liberate_tpu
import liberate_tpu_torch
from liberate_tpu_torch.fhe.presets import errors
from test_torch_engine import _jax_words, _to_jax

SMALL = dict(logN=8, scale_bits=30, num_scales=3, num_special_primes=2,
             is_secured=False)


@pytest.fixture(scope="module")
def eng():
    e = liberate_tpu_torch.CkksEngine(device="cpu", seed=3, **SMALL)
    sk = e.create_secret_key()
    pk = e.create_public_key(sk)
    evk = e.create_evk(sk)
    m = np.linspace(-1, 1, e.num_slots)
    return dict(e=e, sk=sk, pk=pk, evk=evk, m=m, ct=e.encorypt(m, pk))


def _leaves(x):
    if hasattr(x, "origin"):
        return _leaves(x.data)
    if isinstance(x, (tuple, list)):
        return [t for d in x for t in _leaves(d)]
    return [x]


def _same(a, b):
    """Same nesting, metadata and words."""
    if hasattr(a, "origin"):
        assert [getattr(a, k) for k in a.__slots__ if k != "data"] == \
            [getattr(b, k) for k in b.__slots__ if k != "data"]
        return _same(a.data, b.data)
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("what", ["ct", "evk"])
def test_clone_is_independent_of_its_source(eng, what):
    src = eng[what]
    before = [t.clone() for t in _leaves(src)]
    copy = eng["e"].clone(src)
    assert _same(copy, src)
    for t in _leaves(copy):
        t[..., 0] += 1
    assert all(torch.equal(t, b) for t, b in zip(_leaves(src), before))
    assert not any(c.data_ptr() == s.data_ptr()
                   for c, s in zip(_leaves(copy), _leaves(src)))


@pytest.mark.parametrize("what", ["ct", "evk"])
def test_save_load_round_trip(eng, what, tmp_path):
    e = eng["e"]
    fn = e.save(eng[what], tmp_path / f"{what}.pkl")
    back = e.load(fn)
    assert _same(back, eng[what])
    assert e.device(back) == "cpu"
    assert _same(e.load(fn, move_to_device=False), eng[what])
    if what == "ct":
        assert abs(e.absmax_error(e.decrode(back, eng["sk"]),
                                  eng["m"])) < 1e-6


def test_load_of_other_parameters_raises(eng, tmp_path):
    other = liberate_tpu_torch.CkksEngine(device="cpu", seed=3,
                                          **dict(SMALL, num_scales=4))
    fn = eng["e"].save(eng["ct"], tmp_path / "ct.pkl")
    with pytest.raises(errors.HashMismatchError):
        other.load(fn)


def test_save_without_a_name_returns_one(eng, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fn = eng["e"].save(eng["ct"])
    assert fn.endswith(".pkl") and (tmp_path / fn).exists()


@pytest.mark.parametrize("direction", ["gpu2cpu", "cpu2gpu"])
def test_move_to(eng, direction):
    e = eng["e"]
    moved = e.move_to(eng["evk"], direction)
    assert _same(moved, eng["evk"]) and e.device(moved) == "cpu"


def test_move_to_bad_direction_raises(eng):
    with pytest.raises(ValueError, match="direction"):
        eng["e"].move_to(eng["ct"], "cpu2tpu")


def test_cpu_cuda_device_put_and_device(eng):
    e = eng["e"]
    for f in (e.cpu, e.cuda, e.device_put):
        out = f(eng["pk"])
        assert _same(out, eng["pk"]) and e.device(out) == "cpu"
    assert e.device(eng["evk"]) == e.device(eng["ct"]) == "cpu"


def _lines(print_fn, text, capsys):
    capsys.readouterr()
    print_fn(text)
    return [ln for ln in capsys.readouterr().out.splitlines()
            if "(level=" in ln]


@pytest.mark.parametrize("what", ["ct", "evk"])
def test_print_data_structure_equals_jax(eng, shared_eng, what, capsys):
    port = _lines(eng["e"].print_data_structure, eng[what], capsys)
    ref = _lines(shared_eng.print_data_structure, _to_jax(eng[what]), capsys)
    assert port == ref and port


def test_refresh_draws_the_jax_words():
    je = liberate_tpu.CkksEngine(seed=5, **SMALL)
    te = liberate_tpu_torch.CkksEngine(device="cpu", seed=5, **SMALL)
    for e in (je, te):
        e.refresh(20261017)
    draws = [e.rng.randint(amax=e.ntt.q_ints(0, -2), repeats=e.num_special)
             for e in (je, te)]
    assert np.array_equal(_jax_words(draws[0]), draws[1].numpy())
    te.refresh(20261018)
    assert not torch.equal(te.rng.randint(amax=te.ntt.q_ints(0, -2),
                                          repeats=te.num_special), draws[1])


def test_profile_writes_a_trace(eng, tmp_path):
    e = eng["e"]
    with e.profile(tmp_path / "trace"):
        e.mult(eng["ct"], eng["ct"], eng["evk"])
    assert list((tmp_path / "trace").glob("*.json"))
