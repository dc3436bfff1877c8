"""The port stands alone: it imports neither JAX nor the JAX package, and
its engine runs on the CPU only when asked to."""

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
    offenders = [str(f.relative_to(PKG)) for f in files
                 if _NAMES_JAX.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("script", ["chip_smoke.py", "stage_variants.py",
                                    "bfly_variants.py"])
def test_card_scripts_name_no_jax(script):
    """The scripts run on the card import neither JAX nor the JAX package;
    they name its kernels only as file:line strings."""
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


@pytest.mark.parametrize("make", [_csprng, _from_reference],
                         ids=["csprng", "from_reference"])
def test_other_entry_points_without_device_raise_when_no_cuda(monkeypatch,
                                                               make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
