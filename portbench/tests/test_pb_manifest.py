"""BENCHMARK.json against the benchmark's contract: names, units, files."""

import json
import os
import re

from conftest import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_name_has_its_files():
    b = bench()
    pkg = os.path.join(ROOT, "portbench")
    assert b["paths"] == ["portbench"]
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        with open(os.path.join(pkg, "workloads", w["name"] + ".json")) as f:
            mix = json.load(f)
        assert (mix["config"], mix["traffic"]) == (w["config"], w["traffic"])
        assert os.path.exists(os.path.join(pkg, "traffic",
                                           mix["kind"] + ".py"))
        assert w["name"] in TINY
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(pkg, "metrics",
                                           m["name"] + ".py")), m["name"]
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m["name"] for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
