"""The benchmark's own tests: ``python -m pytest fhebench/tests -q`` on
the CPU; the tests marked ``chip`` need a CUDA card and skip without one
(on the card: ``python -m pytest fhebench/tests -q -m chip -s``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A size the CPU holds: the engine's twins at logN 10, three scales.
TINY = dict(logN=10, num_scales=3, is_secured=False)
CELLS = ("silver-tc.mult-b8", "gold-tc.mult-b4", "gold-tc.dot16")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
