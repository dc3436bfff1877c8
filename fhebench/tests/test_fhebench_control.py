"""The comparison that decides ``correct`` fails where it has to.

On the CPU at a tiny size: each fault the cells can have, planted under
the timed path, makes a run come out not correct: a step that returns its
state unchanged, half of the batch left out (its answers copied from the
other half), an answer altered where it is produced. On the card (marked
``chip``) at the cells' own sizes: the sound program on a dozen seeds and
the control, the same engine at the next precision below the
configuration's (scale 2^30 for 2^40), on three; each run's compared
numbers are printed, the readings the limits were set from."""

import json

import pytest
from conftest import CELLS, TINY

from fhebench import run as R
from liberate_tpu_torch import CkksEngine


def _run(cell):
    return R.run(cell, 2 ** 31 + 99, 1.0, 0, require_cuda=False,
                 device="cpu", overrides=TINY)


def _unchanged_mult(self, a, b, evk=None, relin=True):
    return a


def _unchanged_batch(self, cts_a, cts_b, evk):
    return list(cts_a)


def _half_batch(orig):
    def mult_batched(self, cts_a, cts_b, evk):
        h = max(1, len(cts_a) // 2)
        out = orig(self, cts_a[:h], cts_b[:h], evk)
        return (out * 2)[:len(cts_a)]
    return mult_batched


def _altered(orig):
    def op(self, *args, **kw):
        out = orig(self, *args, **kw)
        outs = out if isinstance(out, list) else [out]
        for ct in outs:
            ct.data[0][ct.data[0].shape[0] // 2, 11] += 1
        return out
    return op


def _unchanged_rotation(self, ct, rotk):
    return ct


FAULTS = {
    "silver-tc.mult-b8": [
        ("mult_batched", lambda o: _unchanged_batch),
        ("mult_batched", _half_batch),
        ("mult_batched", _altered)],
    "gold-tc.mult-b4": [
        ("mult_batched", lambda o: _unchanged_batch),
        ("mult_batched", _half_batch),
        ("mult_batched", _altered)],
    "gold-tc.dot16": [
        ("mult", lambda o: _unchanged_mult),
        ("rotate_single", lambda o: _unchanged_rotation),
        ("add", _altered)],
}


@pytest.mark.parametrize("cell, fault", [
    (c, i) for c in CELLS for i in range(len(FAULTS[c]))])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    name, make = FAULTS[cell][fault]
    monkeypatch.setattr(CkksEngine, name, make(getattr(CkksEngine, name)))
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


def _readings(cell, seeds, over=None):
    out = []
    for seed in seeds:
        res = R.run(cell, seed, 3.0, 0, overrides=over)
        c = res["compared"]
        print(json.dumps({"cell": cell, "seed": seed, "control": bool(over),
                          "correct": res["correct"],
                          **{k: v["value"] for k, v in c.items()}}))
        out.append(res)
    return out


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, card):
    seeds = [2 ** 31 + 5000 + i for i in range(3)]
    assert not any(r["correct"]
                   for r in _readings(cell, seeds, {"scale_bits": 30}))


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_dozen_seeds_on_the_card(cell, card):
    seeds = [2 ** 31 + 6000 + i for i in range(12)]
    assert all(r["correct"] for r in _readings(cell, seeds))
