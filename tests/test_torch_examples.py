"""The port's four examples (``liberate_tpu_torch/examples``) on the CPU at
logN 8: each ``main`` runs through and returns the errors it printed, under
the bounds of the JAX package's tests (a fresh encryption within 1e-6, a
multiply or rotation of one within 1e-5). ``multichip`` runs its 4 ranks
as threads (``run_ranks(4, device="cpu")``), on an ``rns`` and a 2-D mesh.

Every call the examples make is held against the JAX package by the other
``test_torch_*`` files; the JAX examples are not run here."""

import pytest
import torch

from liberate_tpu_torch.examples import (_params, ckks_engine, evaluators,
                                         multichip, multiparty)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(_params.SMALL, "logN", 8)
    yield
    torch.set_num_threads(n)


def _bounded(errors, bound):
    worst = {k: max(v) if isinstance(v, tuple) else v
             for k, v in errors.items()}
    assert worst and all(e < bound for e in worst.values()), worst


def test_ckks_engine(capsys):
    errors = ckks_engine.main([], device="cpu")
    assert list(errors) == ["separate encode/encrypt",
                            "fused encorypt/decrode", "after save/load"]
    _bounded(errors, 1e-6)
    assert errors["after save/load"] == errors["fused encorypt/decrode"]
    assert "== after save/load ==" in capsys.readouterr().out


def test_evaluators(capsys):
    errors = evaluators.main([], device="cpu")
    levels = _params.SMALL["num_scales"] - 1
    assert len(errors) == 5 * levels + 4
    _bounded(errors, 1e-5)
    out = capsys.readouterr().out
    assert out.count("\n") >= levels + 5 and "ct*message err:" in out


def test_multiparty(capsys):
    errors = multiparty.main([], device="cpu")
    assert list(errors) == ["threshold enc/dec", "collective-evk mult"]
    _bounded(errors, 1e-5)
    out = capsys.readouterr().out
    assert "collective rotation key assembled: rotation key" in out
    assert "collective galois key assembled: galois key" in out


def test_multichip(capsys):
    errors = multichip.main([], device="cpu")
    assert list(errors) == ["sharded mult", "sharded rotate",
                            "imported host ciphertext",
                            "2-D (rns, coef) mesh mult"]
    assert all(len(v) == multichip.RANKS and len(set(v)) == 1
               for v in errors.values())
    _bounded(errors, 1e-5)
    out = capsys.readouterr().out
    assert out.count("absmax error:") == 4          # rank 0 prints


def test_params_and_command_line():
    assert _params.example_params("silver")["logN"] == 15
    assert "mesh_shape" not in _params.example_params("gold")
    opts = _params.parse_args(["bronze", "--device", "cpu"], "x")
    assert (opts.preset, opts.device) == ("bronze", "cpu")
    with pytest.raises(SystemExit):
        _params.parse_args(["tin"], "x")
