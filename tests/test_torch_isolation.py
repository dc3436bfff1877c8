"""The port stands alone: it imports neither JAX nor the JAX package, and
its engine runs on the CPU only when asked to. A Galois key survives the
trip through ``interop`` and back."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "liberate_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import liberate_tpu_torch, liberate_tpu_torch.interop\n"
        "import liberate_tpu_torch.parallel.coef_shard\n"
        "import liberate_tpu_torch.native, liberate_tpu_torch.utils\n"
        "from liberate_tpu_torch.examples import (ckks_engine, evaluators,\n"
        "    multichip, multiparty)\n"
        "liberate_tpu_torch.native.miller_rabin(97)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')"
        " or m == 'liberate_tpu' or m.startswith('liberate_tpu.'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PKG.parent, timeout=120)
    assert r.returncode == 0, r.stderr


_NAMES_JAX = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b)|liberate_tpu\.|"
    r"from\s+liberate_tpu\s|import\s+liberate_tpu\b(?!_torch)",
    re.MULTILINE)


def test_no_source_names_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert files
    assert {"native", "utils", "examples"} <= {
        f.relative_to(PKG).parts[0] for f in files}
    offenders = [str(f.relative_to(PKG)) for f in files
                 if _NAMES_JAX.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("script", ["chip_smoke.py", "stage_variants.py",
                                    "bfly_variants.py",
                                    "tests/torch_multihost_worker.py"])
def test_card_scripts_name_no_jax(script):
    """The scripts run on the card (the multi-process worker also on the
    CPU) import neither JAX nor the JAX package; they name its kernels only
    as file:line strings."""
    text = (PKG.parent / script).read_text()
    assert "liberate_tpu_torch" in text
    assert not _NAMES_JAX.search(text)


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    import liberate_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        liberate_tpu_torch.CkksEngine(logN=8, scale_bits=30, num_scales=3,
                                      num_special_primes=2, is_secured=False)


def _csprng():
    from liberate_tpu_torch.csprng import Csprng
    return Csprng(64, 2, 2, seed=1)


def _from_reference():
    import numpy as np
    from liberate_tpu_torch import interop
    return interop.from_reference(
        np.zeros((2, 1, 8), np.uint32),
        dict(include_special=False, ntt_state=False, montgomery_state=False,
             origin="ct", level=0, hash="", version=""))


def _run_ranks():
    from liberate_tpu_torch.parallel import run_ranks
    return run_ranks(2, lambda: None)


def _make_mesh_in_ranks():
    from liberate_tpu_torch.parallel import make_mesh, run_ranks
    return run_ranks(2, lambda: make_mesh(devices=[None, None]),
                     device="cpu")


@pytest.mark.parametrize("make", [_csprng, _from_reference, _run_ranks,
                                  _make_mesh_in_ranks],
                         ids=["csprng", "from_reference", "run_ranks",
                              "make_mesh"])
def test_other_entry_points_without_device_raise_when_no_cuda(monkeypatch,
                                                               make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def _galois_tree():
    """The limb tree of a Galois key: a list of rotation keys, each a list
    of key-switching parts, each a pair of polynomials."""
    import numpy as np

    def meta(origin):
        return dict(include_special=True, ntt_state=True,
                    montgomery_state=True, origin=origin, level=0, hash="",
                    version="")

    part = ((np.zeros((2, 3, 8), np.uint32),) * 2,
            meta("key switch key part index 0"))
    rotk = ([part, part], meta("rotation key:1"))
    return [rotk, rotk], meta("galois key")


def test_galois_key_from_reference_without_device_raises(monkeypatch):
    from liberate_tpu_torch import interop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.from_reference(*_galois_tree())


@pytest.fixture(scope="module")
def cpu_engine():
    import numpy as np

    import liberate_tpu_torch

    e = liberate_tpu_torch.CkksEngine(device="cpu", logN=8, scale_bits=30,
                                      num_scales=3, num_special_primes=2,
                                      is_secured=False, seed=1)
    sk = e.create_secret_key()
    ct = e.encorypt(np.linspace(-1, 1, e.num_slots),
                    e.create_public_key(sk))
    return e, sk, ct


def _leaves(x):
    from liberate_tpu_torch.fhe.data_struct import DataStruct

    if isinstance(x, DataStruct):
        return _leaves(x.data)
    if isinstance(x, (tuple, list)):
        return [t for d in x for t in _leaves(d)]
    return [x]


@pytest.mark.parametrize("entry", [
    "create_rotation_key", "create_conjugation_key", "create_galois_key",
    "rotate_single", "rotate_galois", "conjugate", "sum"])
def test_key_and_rotation_entry_points_stay_on_the_cpu(cpu_engine, entry,
                                                       monkeypatch):
    """Without a card, an engine built with device="cpu" runs the key and
    rotation entry points and leaves every tensor on the CPU (an engine
    built without a device raises: above)."""
    e, sk, ct = cpu_engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry in ("create_rotation_key", "rotate_single"):
        out = e.create_rotation_key(sk, 1)
        if entry == "rotate_single":
            out = e.rotate_single(ct, out)
    elif entry in ("create_conjugation_key", "conjugate"):
        out = e.create_conjugation_key(sk)
        if entry == "conjugate":
            out = e.conjugate(ct, out)
    else:
        out = e.create_galois_key(sk)
        if entry == "rotate_galois":
            out = e.rotate_galois(ct, out, 3)
        elif entry == "sum":
            out = e.sum(ct, out)
    assert all(t.device.type == "cpu" for t in _leaves(out))


def test_galois_key_interop_round_trip(cpu_engine):
    """to_reference_arrays then from_reference gives back the Galois key:
    its nesting, every DataStruct's metadata and every word."""
    from liberate_tpu_torch import interop
    from liberate_tpu_torch.fhe.data_struct import DataStruct

    e, sk, _ = cpu_engine
    gk = e.create_galois_key(sk)
    back = interop.from_reference(*interop.to_reference_arrays(gk),
                                  device="cpu")

    def same(a, b):
        if isinstance(a, DataStruct):
            assert isinstance(b, DataStruct)
            assert [getattr(a, k) for k in a.__slots__ if k != "data"] == \
                [getattr(b, k) for k in b.__slots__ if k != "data"]
            return same(a.data, b.data)
        if isinstance(a, (tuple, list)):
            assert type(a) is type(b) and len(a) == len(b)
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    assert len(gk.data) == 7 and same(gk, back)


def _collective(e, sks):
    """Two parties' collective public key and evk."""
    pk0 = e.multiparty_create_public_key(sks[0])
    crs = e.multiparty_public_crs(pk0)
    cpk = e.multiparty_create_collective_public_key(
        [pk0, e.multiparty_create_public_key(sks[1], a=crs)])
    shares = [e.create_key_switching_key(sks[0], sks[0])]
    crs = e.generate_rotation_crs(shares[0])
    shares.append(e.multiparty_create_key_switching_key(sks[1], sks[1],
                                                        a=crs))
    summed = e.multiparty_sum_evk_share(shares)
    return cpk, e.multiparty_sum_evk_share_mult(
        [e.multiparty_mult_evk_share_sum(summed, s) for s in sks])


@pytest.mark.parametrize("entry", [
    "multiparty_create_collective_public_key", "multiparty_collective_evk",
    "multiparty_decrypt_head", "multiparty_decrypt_partial",
    "multiparty_generate_rotation_key", "mult_batched", "mult_stacked",
    "clone", "move_to", "device_put", "load"])
def test_new_entry_points_stay_on_the_cpu(cpu_engine, entry, monkeypatch,
                                          tmp_path):
    """The multiparty, batched-mult and data entry points of a CPU engine
    leave every tensor on the CPU without a card; ``load`` puts what it
    reads on the engine's device."""
    e, sk, ct = cpu_engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sks = [sk, e.create_secret_key()]
    if entry == "multiparty_create_collective_public_key":
        out = _collective(e, sks)[0]
    elif entry == "multiparty_collective_evk":
        out = _collective(e, sks)[1]
    elif entry == "multiparty_decrypt_head":
        out = e.multiparty_decrypt_head(ct, sk)
    elif entry == "multiparty_decrypt_partial":
        out = e.multiparty_decrypt_partial(ct, sks[1])
    elif entry == "multiparty_generate_rotation_key":
        rotk0 = e.multiparty_create_rotation_key(sk, 1)
        crs = e.generate_rotation_crs(rotk0)
        out = e.multiparty_generate_rotation_key(
            [rotk0, e.multiparty_create_rotation_key(sks[1], 1, a=crs)])
    elif entry in ("mult_batched", "mult_stacked"):
        evk = e.create_evk(sk)
        if entry == "mult_batched":
            out = e.mult_batched([ct, ct], [ct, ct], evk)
        else:
            s = e.stack_cts([ct, ct])
            out = e.mult_stacked(s, s, evk)
    elif entry == "clone":
        out = e.clone(ct)
    elif entry == "move_to":
        out = e.move_to(ct, "cpu2gpu")
    elif entry == "device_put":
        out = e.device_put(ct)
    else:
        out = e.load(e.save(ct, tmp_path / "ct.pkl"))
        assert e.device(out) == "cpu"
    assert all(t.device.type == "cpu" for t in _leaves(out))
