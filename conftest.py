"""Hooks for the tier-1 suite under ``tests/``, beside ``tests/conftest.py``'s
JAX set-up.

Under pytest-xdist the collection is reordered so that the heavy tests
(``tests/_schedule.py``'s ``HEAVY``) open the workers' first blocks instead
of piling onto one worker. Every phase of a test under ``tests/`` also runs
under a time limit: past it, the worker writes every thread's stack to
stderr and exits, and xdist reports the test as failed and goes on with a
fresh worker, so a stall costs one test and leaves a traceback. The
benchmark's own tests (``fhebench/tests``, some of them minutes on the
card) run without one.
"""

import faulthandler
import os
import sys

import pytest

from tests._schedule import HEAVY, spread_heavy

# Seconds one phase of a test (set-up, call or teardown) may run. In whole
# tier-1 runs with six workers busy on an 8-core CPU host, the slowest
# test off HEAVY took 106 s and the slowest on it 632 s, on the slowest
# host seen. 600 s leaves a light test more than 5x; a heavy test's limit
# sits just under the run's 1470 s clock (ROADMAP.md), so only a stall
# ends it, and a stall in one of the first blocks still leaves its stacks.
LIGHT_LIMIT_S = 600
HEAVY_LIMIT_S = 1400

_heavy = frozenset(HEAVY)
_dump_fd = pytest.StashKey[int]()


def pytest_configure(config):
    # Output capture is suspended while plugins configure, so this is the
    # real stderr, which a capturing test phase hides from faulthandler.
    config.stash[_dump_fd] = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_dump_fd])


@pytest.hookimpl(wrapper=True)
def _time_limited(item):
    if not item.nodeid.startswith("tests/"):
        return (yield)
    limit = HEAVY_LIMIT_S if item.nodeid in _heavy else LIGHT_LIMIT_S
    faulthandler.dump_traceback_later(
        limit, exit=True, file=item.config.stash[_dump_fd])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


pytest_runtest_setup = pytest_runtest_call = _time_limited
pytest_runtest_teardown = _time_limited


# trylast: reorder what is left after `-m` deselection, the list xdist
# splits into blocks. Every worker sees the same items and worker count,
# so every worker reports the same order.
@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    workers = getattr(config, "workerinput", {}).get("workercount")
    order = spread_heavy([item.nodeid for item in items], HEAVY, workers)
    items[:] = [items[i] for i in order]
