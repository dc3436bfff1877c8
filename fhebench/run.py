#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 fhebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names a configuration
(``configs/<config>.json``: the engine's parameters) and a traffic mix
(``traffic/<mix>.json``). The run builds the engine, its keys and a pool
of ciphertexts from the seed, warms up the cell's own shapes, then one
closed-loop client sends requests for ``--seconds``. With ``--trace 0`` it
prints the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (``metrics/<name>.py``), read from the window's spans and from a
traced sub-window after it. Either way the reference (``reference/``)
judges a seeded sample of the window's answers against the limits of
``limits/<cell>.json``. The last line of standard output is the result,
one JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the process may not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "liberate_tpu")
# A judged answer that cannot be read (wrong level or shape).
UNREADABLE = 1e30


def process_age():
    """Seconds since this process started (0 where /proc says nothing)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age()


class NoDevice(RuntimeError):
    pass


def cache_env(root):
    """Every build and cache of the program at fixed paths in the
    checkout."""
    build = Path(root) / "build"
    os.environ["LIBERATE_TPU_TORCH_BUILD"] = str(build / "liberate_tpu_torch")
    os.environ["LIBERATE_TPU_TORCH_CACHE"] = str(build / "fhebench" / "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "fhebench" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "fhebench" / "triton")
    return build / "fhebench" / "cache"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metric lists."""

    def __init__(self, name, root=ROOT):
        from fhebench.harness.traffic import Traffic

        with open(Path(root) / "BENCHMARK.json") as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        with open(Path(root) / configs[self.spec["config"]]["file"]) as f:
            self.config = json.load(f)
        self.traffic = Traffic(
            HERE / "traffic" / f"{self.spec['traffic']}.json")
        with open(HERE / "limits" / f"{name}.json") as f:
            self.limits = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name)]


class Record:
    """What the metric readers see of one run (host times in seconds)."""

    def __init__(self):
        self.requests = []       # (call, returned, done) of each request
        self.window_s = 0.0
        self.answers_done = 0
        self.setup_s = 0.0
        self.trace = None        # trace.Summary of the traced sub-window
        self.bound_s = None      # summed kernel bounds of that sub-window


def run(workload, seed, seconds, trace, root=ROOT, require_cuda=True,
        device=None, overrides=None, log=sys.stderr):
    """One run of a cell; the result (a dict, ``compared`` last)."""
    cache = cache_env(root)
    cell = Cell(workload, root)
    import torch

    if require_cuda:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device")
        if torch.cuda.device_count() < cell.spec["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell needs {cell.spec['chips']}")
    from liberate_tpu_torch import CkksEngine

    from fhebench.harness import kernels
    from fhebench.harness import trace as tracing

    cuda = device is None or str(device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tr = cell.traffic
    params = dict(cell.config["engine"], **(overrides or {}))
    steps = [("imports", time.perf_counter())]
    engine = CkksEngine(devices=device, seed=seed, cache_folder=str(cache),
                        **params)
    sync()
    steps.append(("engine", time.perf_counter()))
    sk = engine.create_secret_key()
    pk = engine.create_public_key(sk)
    evk = engine.create_evk(sk)
    keys = tr.make_keys(engine, sk)
    sync()
    steps.append(("keys", time.perf_counter()))
    msgs = tr.messages(seed, engine.num_slots)
    pool = [engine.encorypt(m, pk) for m in msgs]
    sync()
    steps.append(("pool", time.perf_counter()))
    plan = tr.plan(seed)
    for _ in range(tr.warmup_requests):
        tr.issue(engine, evk, keys, pool, next(plan))
    sync()
    steps.append(("warm-up", time.perf_counter()))
    print("set-up (s): " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), (_, prev)
        in zip(steps, [("start", T0)] + steps[:-1])), file=log)

    # -- the window: one closed-loop client ------------------------------
    import numpy as np

    rec = Record()
    pick = np.random.default_rng([seed % 2 ** 64, 2])
    sample = []                 # reservoir of (pool indices, answers)
    attempted = failed = 0
    t_start = time.perf_counter()
    rec.setup_s = AGE0 + (t_start - T0)
    n = 0
    while time.perf_counter() - t_start < seconds:
        idx = next(plan)
        attempted += tr.answers_per_request
        t_call = time.perf_counter()
        try:
            answers = tr.issue(engine, evk, keys, pool, idx)
            t_ret = time.perf_counter()
            sync()
        except Exception as e:  # noqa: BLE001 -- a refused request counts
            print(f"request {n} failed: {type(e).__name__}: {e}", file=log)
            failed += tr.answers_per_request
            n += 1
            continue
        t_done = time.perf_counter()
        rec.requests.append((t_call, t_ret, t_done))
        rec.answers_done += len(answers)
        kept = [tuple(a.data) for a in answers]
        if len(sample) < tr.sample_requests:
            sample.append((idx, kept))
        else:
            j = int(pick.integers(0, len(rec.requests)))
            if j < tr.sample_requests:
                sample[j] = (idx, kept)
        n += 1
    if rec.requests:
        rec.window_s = rec.requests[-1][2] - t_start
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # -- the traced sub-window -------------------------------------------
    if trace:
        def traced():
            from torch.profiler import record_function

            for _ in range(tr.trace_requests):
                i = next(plan)
                with record_function(tracing.REQUEST):
                    with record_function(tracing.CALL):
                        tr.issue(engine, evk, keys, pool, i)
                    with record_function(tracing.SYNC):
                        sync()

        with kernels.Recorder() as recorder:
            chrome = tracing.profile(traced)
        rec.trace = tracing.Summary(
            chrome, tr.trace_requests * tr.answers_per_request)
        rec.bound_s = recorder.bound_s()
        del chrome

    # -- judge the sampled answers with the reference ---------------------
    num_ordinary, num_special = engine.num_ordinary, engine.num_special
    N = engine.ctx.N
    del engine, sk, pk, evk, keys, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from fhebench.reference.chacha20 import secret_key
    from fhebench.reference.ckks import Judge
    from fhebench.reference.primes import modulus_chain

    q, L = modulus_chain(params["logN"], params["scale_bits"],
                         params["num_special_primes"],
                         params.get("num_scales"),
                         params.get("buffer_bit_length", 62))
    if L + 1 != num_ordinary:
        raise RuntimeError("the reference's modulus chain differs in length")
    judge = Judge(q, L, params["scale_bits"],
                  secret_key(seed, N, num_ordinary, num_special),
                  "cuda" if cuda else "cpu")
    max_err, bad, checked = 0.0, 0, 0
    for idx, kept in sample:
        for words, want in zip(kept, tr.expected(msgs, idx)):
            err, b = judge.judge(words, tr.mults_per_answer,
                                 tr.mults_per_answer, want)
            max_err = max(max_err, min(err, UNREADABLE))
            bad += b if b >= 0 else N * num_ordinary
            checked += 1
    compared = {
        "max_err": {"value": max_err, "limit": cell.limits["max_err"]},
        "bad_residues": {"value": bad, "limit": cell.limits["bad_residues"]},
        "answers_checked": {"value": checked,
                            "limit": cell.limits["answers_checked"]},
    }
    correct = (failed == 0 and rec.answers_done > 0
               and max_err <= cell.limits["max_err"]
               and bad <= cell.limits["bad_residues"]
               and checked >= cell.limits["answers_checked"])

    # -- the metrics -----------------------------------------------------
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["name"] == "setup_s":
            value = rec.setup_s
        else:
            reader = _load(HERE / "metrics" / f"{m['name']}.py",
                           "fhebench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.spec["chips"], "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power_limit_w"] = power_limit()
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
        print("port kernels in the trace: "
              + "; ".join(rec.trace.port_kernels), file=log)
    result["compared"] = compared
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the run may not hold: "
                           f"{', '.join(found)}")
    return result


def power_limit():
    """The card's power limit (W) from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        result = run(a.workload, a.seed, a.seconds, a.trace)
    except NoDevice as e:
        print(f"fhebench: {e}", file=sys.stderr)
        return 2
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
