"""The port as a ``torch.distributed`` job of two processes on the CPU
(gloo over ``tcp://127.0.0.1``), the counterpart of
``tests/test_multihost.py``: ``tests/torch_multihost_worker.py`` runs the
RNS-channel-sharded engine across the processes (its gathered words those
of a single-device engine at the same seed) and two parties' threshold
decryption with one party a process. Every collective and the wait on the
processes carry a time limit; a worker that fails makes the others fail
on their own, and the test fails without waiting out the limit."""

import re

import torch_multihost_worker as worker

# Seconds for the whole run and for each collective.
TIMEOUT = 90.0


def test_two_process_sharded_engine_and_threshold_decrypt():
    codes, outs, wall = worker.launch(2, "cpu", timeout=TIMEOUT)
    log = "\n".join(outs)
    assert wall < TIMEOUT, f"the workers hung:\n{log}"
    for r, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"worker {r} failed:\n{log}"
        assert f"[{r}] OK" in out
        assert f"[{r}] CRS identical across 2 processes" in out
        assert f"[{r}] sharded engine over 2 processes" in out


def test_a_failing_worker_fails_the_others():
    """A worker that raises once the mesh is made ends at once, and its
    peer, which waits for it in a collective, fails on its own with the
    collective's error, well within the limit (the launcher kills no
    worker here)."""
    codes, outs, wall = worker.launch(2, "cpu", timeout=TIMEOUT,
                                      fail_rank=1, kill_on_failure=False)
    assert codes[1] == 1 and "told to fail" in outs[1], outs
    # Rank 0 ends on the error gloo's TCP transport raises in its
    # collective for the departed peer: "closed" when rank 1's socket shut
    # cleanly (FIN), "reset" when rank 1 exited with rank 0's bytes unread
    # (RST), whichever the two processes' timing gave.
    last = outs[0].strip().splitlines()[-1]
    assert codes[0] == 1 and re.match(
        r"RuntimeError: \[\S*gloo/transport/tcp/pair\.cc:\d+\] "
        r".*Connection (closed|reset) by peer", last), outs
    assert "told to fail" not in outs[0], outs
    assert wall < TIMEOUT / 2, (wall, outs)
