"""The frozen kernel formulas against the bounds of PERF.md's kernel
table (level-1 shapes; width groups of 40-bit primes at 6 int8 digits and
60-bit ones at 8)."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on the path)

from fhebench.harness import kernels


def _ms(name, groups, **shape):
    f = kernels.load(name)
    return 1e3 * sum(kernels.call_bound(f, dict(shape, C=C, d=d))[0]
                     for C, d in groups)


@pytest.mark.parametrize("name, groups, shape, ms", [
    ("mxu_switch_inv", [(33, 6), (5, 8)],
     dict(B=1, P=10, A=4, n_sp=0, S=256, R=256, mont=False), 0.6136),
    ("mxu_switch", [(15, 6), (3, 8)],
     dict(B=1, P=9, A=2, n_sp=2, S=256, R=128, mont=False), 0.1024),
    ("mxu_switch_inv", [(15, 6), (3, 8)],
     dict(B=1, P=9, A=2, n_sp=0, S=256, R=128, mont=True), 0.1024),
    ("mxu_ntt_fwd", [(15, 6), (1, 8)],
     dict(B=4, S=256, R=128, mont_rec=False), 0.0307),
    ("mxu_ntt_fwd", [(33, 6), (1, 8)],
     dict(B=4, S=256, R=256, mont_rec=False), 0.1698),
    ("mxu_ntt_inv", [(33, 6), (1, 8)],
     dict(B=3, S=256, R=256, mont_rec=False), 0.1274),
])
def test_tensor_core_bounds(name, groups, shape, ms):
    assert _ms(name, groups, **shape) == pytest.approx(ms, abs=5e-5)


def test_ksk_mulacc_bound():
    f = kernels.load("ksk_mulacc")
    t, by = kernels.call_bound(f, dict(P=9, C=18, N=32768))
    assert by == "bytes" and 1e3 * t == pytest.approx(0.0408, abs=5e-5)


def test_shapes_from_the_wrappers_arguments(tmp_path):
    """The shapes a formula reads from a call, on the port's own plans."""
    from fhebench.harness.kernels import Recorder
    from liberate_tpu_torch import CkksEngine

    eng = CkksEngine(devices="cpu", logN=10, scale_bits=40, num_scales=3,
                     num_special_primes=2, is_secured=False, seed=3,
                     use_mxu_ntt=True, cache_folder=str(tmp_path))
    sk = eng.create_secret_key()
    pk = eng.create_public_key(sk)
    evk = eng.create_evk(sk)
    cts = [eng.encorypt([0.5], pk) for _ in range(4)]
    with Recorder() as rec:
        eng.mult_batched(cts[:2], cts[2:], evk)
    names = [n for n, _ in rec.calls]
    groups = len(eng.pack(1, -1).mxu)
    assert names.count("mxu_ntt_fwd") == groups
    assert names.count("mxu_ntt_inv") == groups
    assert names.count("mxu_switch") == len(eng.pack(1, -2).mxu)
    assert all(b > 0 for _, b in rec.calls)
    # the wrappers are the port's again
    from liberate_tpu_torch.ntt import cuda_mxu
    assert cuda_mxu.mxu_switch.__module__ == cuda_mxu.__name__
