"""The xdist reorder of tests/_schedule.py, on synthetic node ids, and the
names on its HEAVY list against the files and the collection."""

import os
import re

import pytest

from _schedule import HEAVY, first_block, spread_heavy

WORKERS = 6


def _collection(n):
    """n node ids with the heavy tests first, as `tests/` collects them."""
    return list(HEAVY) + [f"tests/test_x.py::test_{i}"
                          for i in range(n - len(HEAVY))]


@pytest.mark.parametrize("n", [600, 647, 700])
def test_first_blocks_hold_one_heavy_test_each(n):
    ids = _collection(n)
    order = spread_heavy(ids, HEAVY, WORKERS)
    assert sorted(order) == list(range(n))
    heavy = {ids.index(h) for h in HEAVY}
    block = first_block(n, WORKERS)
    for k in range(WORKERS):
        first = order[k * block:(k + 1) * block]
        assert first[0] == ids.index(HEAVY[k])
        assert len(heavy.intersection(first)) == 1
    at = [p for p, i in enumerate(order) if i in heavy]
    assert len(at) == len(HEAVY)
    assert min(b - a for a, b in zip(at, at[1:])) > 1
    light = [i for i in order if i not in heavy]
    assert light == sorted(light)


def test_order_unchanged_without_workers():
    ids = _collection(647)
    assert spread_heavy(ids, HEAVY, None) == list(range(647))


@pytest.mark.parametrize("n", [1, 6, 20, 25, 26, 40])
def test_small_collections_keep_every_test(n):
    ids = _collection(max(n, len(HEAVY)))[:n]
    order = spread_heavy(ids, HEAVY, WORKERS)
    assert sorted(order) == list(range(n))
    if n <= len(HEAVY):
        assert order == list(range(n))


def test_heavy_tests_exist():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for nodeid in HEAVY:
        path, name = nodeid.split("::")
        with open(os.path.join(root, path)) as f:
            source = f.read()
        assert re.search(rf"^def {re.escape(name.split('[')[0])}\(",
                         source, re.M), nodeid


def test_heavy_ids_match_the_collection(request):
    """A heavy test whose function this run collects is collected under
    the id on HEAVY: a changed parameter id would drop it from the reorder
    without a word. (Nothing to check for files the run does not collect.)
    """
    ids = {item.nodeid for item in request.session.items}
    for nodeid in HEAVY:
        func = nodeid.split("[")[0]
        cases = sorted(i for i in ids
                       if i == func or i.startswith(func + "["))
        assert not cases or nodeid in cases, (nodeid, cases)
