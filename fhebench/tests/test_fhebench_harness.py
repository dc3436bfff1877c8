"""The harness on the CPU: each cell rehearsed at a tiny size through the
port's twins, the metric arithmetic, the files found by name, and the
modules the harness and the reference load."""

import json
import os
import shutil
import statistics
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT, TINY

from fhebench import run as R
from fhebench.harness import stats
from fhebench.harness import trace as tracing

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "liberate_tpu"}


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_well_formed_line(cell):
    res = R.run(cell, 2 ** 31 + 7, 1.0, 0, require_cuda=False,
                device="cpu", overrides=TINY)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}


def test_same_seed_same_inputs():
    cell = R.Cell("gold-tc.dot16")
    a, b = cell.traffic.plan(5), cell.traffic.plan(5)
    for _ in range(10):
        x, y = next(a), next(b)
        assert (x[0] == y[0]).all() and (x[1] == y[1]).all()
    assert (cell.traffic.messages(2 ** 33 + 1, 64)
            == cell.traffic.messages(2 ** 33 + 1, 64)).all()


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "fhebench" / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fhebench", tmp_path / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "fhebench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_every_name_has_its_file():
    fb = ROOT / "fhebench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (fb / "traffic" / f"{w['traffic']}.json").is_file()
        assert (fb / "limits" / f"{w['name']}.json").is_file()
        assert any(c["name"] == w["config"] for c in BENCH["configs"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s":
            assert (fb / "metrics" / f"{m['name']}.py").is_file()


def test_rate_and_tail():
    assert stats.rate(300, 10.0) == 30.0
    vals = [float(v) for v in range(1, 101)]
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile(vals, 50) == statistics.median(vals)
    assert stats.percentile([7.0], 95) == 7.0
    rec = R.Record()
    # three requests, the tail over all of them
    rec.requests = [(0.0, 0.01, 0.1), (0.1, 0.11, 0.3), (0.3, 0.31, 0.35)]
    rec.answers_done, rec.window_s = 12, 0.35
    from fhebench.harness import readers
    assert readers.answers_per_s(rec) == pytest.approx(12 / 0.35)
    assert readers.request_p95_ms(rec) == pytest.approx(
        1e3 * stats.percentile([0.1, 0.2, 0.05], 95))
    assert readers.host_ms_per_answer(rec) == pytest.approx(1e3 * 0.03 / 12)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union_length(iv, 0, 10) == 5
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_from_a_synthetic_timeline():
    ev = [_ev(tracing.REQUEST, "user_annotation", 0, 100),
          _ev(tracing.CALL, "user_annotation", 0, 40),
          _ev(tracing.SYNC, "user_annotation", 40, 60),
          _ev("aten::mul", "cpu_op", 0, 10),
          _ev("aten::stack", "cpu_op", 10, 30),
          _ev("void mxu::stage<6, 1>(mxu::Stage)", "kernel", 5, 20),
          _ev("void at::native::vectorized_elementwise_kernel<4>", "kernel",
              30, 40),
          _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 70, 10),
          _ev(tracing.REQUEST, "user_annotation", 100, 100),
          _ev("fold", "kernel", 150, 25)]
    s = tracing.Summary({"traceEvents": ev}, answers=8)
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(20e-6 + 40e-6 + 10e-6 + 25e-6)
    assert s.idle_pct == pytest.approx(100 * (1 - 95 / 200))
    assert s.port_s == pytest.approx(45e-6)
    assert s.chains_s == pytest.approx(50e-6)
    assert s.port_kernels == ["fold", "void mxu::stage<6, 1>(mxu::Stage)"]
    gaps = dict(s.idle_gaps)
    assert gaps["engine call: aten::mul"] == pytest.approx(5e-6)
    assert gaps["engine call: aten::stack"] == pytest.approx(5e-6)
    assert gaps["waiting in synchronize"] == pytest.approx(70e-6)
    assert gaps["between requests"] == pytest.approx(25e-6)
    b = s.breakdown()
    assert len(b["device_ops"]) == 4 and b["device_ops"][0][0].startswith(
        "void at::native")


def test_trace_without_device_work_fails():
    ev = [_ev(tracing.REQUEST, "user_annotation", 0, 100)]
    with pytest.raises(RuntimeError):
        tracing.Summary({"traceEvents": ev}, answers=1)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300, check=True).stdout
    return set(out.split())


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import fhebench.run, fhebench.harness.kernels as k,"
            " fhebench.harness.trace, fhebench.harness.readers,"
            " fhebench.reference.ckks, fhebench.reference.primes,"
            " fhebench.reference.chacha20;"
            "import liberate_tpu_torch;"
            "k.formulas();"
            "from pathlib import Path;"
            "[fhebench.run._load(p, 'm' + str(i)) for i, p in"
            " enumerate(Path('fhebench/metrics').glob('*.py'))];"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not _loaded(code) & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import fhebench.reference.ckks, fhebench.reference.primes,"
            " fhebench.reference.chacha20;"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not _loaded(code) & (FORBIDDEN | {"liberate_tpu_torch"})
