"""The traced sub-window: ``torch.profiler`` over a bounded run of
requests, reduced to device busy time, the split between the port's
kernels and PyTorch's own, the idle gaps by what the host was doing, and
the top device operations.

The benchmark marks each request (``fhebench.request``), the engine call
inside it (``fhebench.call``) and the wait for the card
(``fhebench.sync``) with ``record_function``; the profiler puts those
spans and the device's operations on one timeline."""

import json
import os
import re
import tempfile
from bisect import bisect_right
from collections import defaultdict

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# PyTorch's own device work: its kernels live in these namespaces, and its
# copies and fills are memcpy and memset operations.
TORCH_KERNEL = re.compile(r"(^|[^A-Za-z0-9_])(at|c10|cub|thrust|cutlass)::")
REQUEST, CALL, SYNC = "fhebench.request", "fhebench.call", "fhebench.sync"


def is_port_kernel(event):
    return (event.get("cat") == "kernel"
            and not TORCH_KERNEL.search(event.get("name", "")))


def profile(fn):
    """Run fn() under the profiler (host and card); the chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="fhebench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


class Summary:
    """What the readers take from one traced sub-window (seconds)."""

    def __init__(self, trace, answers):
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        spans = defaultdict(list)
        for e in events:
            if e.get("cat") in ("user_annotation", "cpu_op") and \
                    e["name"] in (REQUEST, CALL, SYNC):
                spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        if not spans[REQUEST]:
            raise RuntimeError("the trace holds no request span")
        self.lo = min(s for s, _ in spans[REQUEST])
        self.hi = max(e for _, e in spans[REQUEST])
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and self.lo <= e["ts"] < self.hi]
        if not dev:
            raise RuntimeError("the trace holds no device operation in the "
                               "traced window")
        self.answers = answers
        self.window_s = (self.hi - self.lo) * 1e-6
        intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
        self.busy_s = stats.union_length(intervals, self.lo, self.hi) * 1e-6
        self.port_s = sum(e["dur"] for e in dev if is_port_kernel(e)) * 1e-6
        self.chains_s = sum(e["dur"] for e in dev
                            if not is_port_kernel(e)) * 1e-6
        by_name = defaultdict(float)
        for e in dev:
            by_name[e["name"]] += e["dur"] * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        self.port_kernels = sorted({e["name"] for e in dev
                                    if is_port_kernel(e)})
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events if e.get("cat") == "cpu_op"
                       and e["name"] not in (REQUEST, CALL, SYNC)))
        idle = defaultdict(float)
        for s, e in stats.gaps(intervals, self.lo, self.hi):
            idle[_label(s, spans, host)] += (e - s) * 1e-6
        self.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])

    @property
    def idle_pct(self):
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self):
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def _inside(t, ranges):
    return any(s <= t < e for s, e in ranges)


def _label(t, spans, host):
    """What the host was doing when the card fell idle at t."""
    if _inside(t, spans[SYNC]):
        return "waiting in synchronize"
    if not _inside(t, spans[CALL]):
        return "between requests"
    i = bisect_right(host, (t, float("inf"), ""))
    best = None
    for s, e, name in reversed(host[max(0, i - 64):i]):
        if e > t and (best is None or s > best[0]):
            best = (s, name)
    return "engine call: " + (best[1] if best else "python")
