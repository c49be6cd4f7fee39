"""Every cell end to end on the CPU at a tiny size, in a fresh process:
the contract's last line, plain and traced, and no module of JAX or of
the JAX package loaded by the end."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

CHILD = r"""
import io, json, sys
sys.path.insert(0, %(root)r)
from portbench import run
out, err = io.StringIO(), io.StringIO()
rc = run.run(%(w)r, %(seed)d, 0.5, %(trace)r, device="cpu", mix=%(mix)r,
             out=out, err=err)
print(json.dumps({"rc": rc, "line": out.getvalue().strip().splitlines()[-1],
                  "err": err.getvalue().strip().splitlines()[-1],
                  "blocked": run.blocked_modules()}))
"""


def child(workload, trace, root=ROOT, extra=None, cwd=ROOT):
    code = CHILD % {"root": root, "w": workload, "seed": 2 ** 31 + 17,
                    "trace": trace, "mix": TINY.get(workload, extra)}
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=cwd, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_rehearses_on_the_cpu(workload, trace):
    res = child(workload, trace)
    assert res["rc"] == 0 and res["blocked"] == []
    line = json.loads(res["line"])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert res["err"].startswith("check ")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    group = bench["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group
            if workload in m.get("workloads", [workload])}
    # a CPU run has no device trace: the device metrics are silent there
    got = set(line["metrics"])
    assert got <= want and ("setup_s" in got or trace)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_new_cell_and_metric_are_found_from_files_alone(tmp_path):
    """A copy of the benchmark, with a cell and a metric added as new
    files and manifest entries, runs the new cell and reads the new
    metric without an edit to any file that was there."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = "psa_affine.batch4_score"
    bench["workloads"].append({"name": name, "config": "psa_affine",
                               "traffic": "batch4_score", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "psa_gcups":
            m["workloads"].append(name)
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "workloads" / (name + ".json")).write_text(
        json.dumps({"config": "psa_affine", "traffic": "batch4_score",
                    "kind": "psa_batch_score", "pairs": 4, "length": 200,
                    "batches": 2, "example_slot0": False,
                    "sample_pairs": 3}))
    (tmp_path / "portbench" / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n    return len(rec['calls']) / rec['window_s']\n")
    code = CHILD % {"root": str(tmp_path), "w": name, "seed": 5,
                    "trace": False, "mix": None}
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(json.loads(proc.stdout.strip().splitlines()[-1])[
        "line"])
    assert line["correct"] is True
    assert {"psa_gcups", "calls_per_s", "setup_s"} == set(line["metrics"])


def test_a_bare_benchmark_exits_non_zero_without_a_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "psa_affine.batch128_score", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env=env)
    assert proc.returncode != 0 and "correct" not in proc.stdout
