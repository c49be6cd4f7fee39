"""The benchmark's machinery, driven by data.

``BENCHMARK.json`` names each cell; the cell's file
``portbench/workloads/<cell>.json`` names its configuration
(``portbench/configs/<config>.json``: the scoring and the guarantees),
its traffic kind (``portbench/traffic/<kind>.py``: the inputs from the
seed, the call, its work, and the check against the plain reference)
and the kind's parameters.  Each metric is read by
``portbench/metrics/<metric>.py``'s ``read(rec)`` from the run's record;
a reader that finds nothing returns None.  A new cell, configuration or
metric is a new file and a manifest entry, never an edit here.

A run: make the inputs, warm every distinct input once (set-up), then a
closed loop, one caller calling back to back over the inputs in turn,
until ``seconds`` have passed; the window ends when its last call
returns.  With ``trace`` the window runs under ``torch.profiler``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")
CALL_SPAN, WINDOW_SPAN = "portbench.call", "portbench.window"


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: its manifest entry, mix, configuration, kind
    module and the metrics it reports (end-to-end, per-layer)."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    mix = load_json(PKG, "workloads", name + ".json")
    if (mix["config"], mix["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError("workloads/%s.json names %s/%s, BENCHMARK.json %s/%s"
                         % (name, mix["config"], mix["traffic"],
                            entry["config"], entry["traffic"]))
    config = load_json(PKG, "configs", entry["config"] + ".json")
    kind = importlib.import_module("portbench.traffic." + mix["kind"])

    def ours(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return {"name": name, "entry": entry, "mix": mix, "config": config,
            "kind": kind, "end_to_end": ours(bench["end_to_end"]),
            "per_layer": ours(bench["per_layer"])}


def reader(metric: str):
    """``read`` of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(PKG, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def scoring(config: dict) -> tuple:
    s = config["scoring"]
    return (s["match"], s["mismatch"], s["gap_extend"], s["gap_open"])


def closed_loop(kind, inputs, params, device, seconds, sync, trace=False,
                clock_factory=None):
    """Call back to back over ``inputs`` in turn until ``seconds`` have
    passed.  Returns ``(calls, outputs, window_s)``: per call a dict of its
    host-clock start and end, input index, work units and roofline work
    (and its RoundClock rounds when ``clock_factory`` gives one)."""
    import torch
    calls, outputs = [], []
    t0 = time.perf_counter()
    k = 0
    with torch.profiler.record_function(WINDOW_SPAN):
        while True:
            idx = k % len(inputs)
            clock = clock_factory() if clock_factory else None
            c0 = time.perf_counter()
            if trace:
                with torch.profiler.record_function(CALL_SPAN):
                    out = kind.call(inputs[idx], params, device, clock)
                    sync()
            else:
                out = kind.call(inputs[idx], params, device, clock)
                sync()
            c1 = time.perf_counter()
            rec = {"t0": c0, "t1": c1, "input": idx,
                   "units": kind.units(inputs[idx], out),
                   "work": kind.work(inputs[idx], out)}
            if clock is not None:
                rec["rounds"] = clock.rounds
            calls.append(rec)
            outputs.append((idx, out))
            k += 1
            if c1 - t0 >= seconds:
                break
    return calls, outputs, calls[-1]["t1"] - t0


def _event_times(e) -> tuple:
    """(start, end) seconds of a kineto event."""
    try:
        s, d = e.start_ns(), e.duration_ns()
        return s * 1e-9, (s + d) * 1e-9
    except AttributeError:
        s, d = e.start_us(), e.duration_us()
        return s * 1e-6, (s + d) * 1e-6


def trace_record(prof) -> dict:
    """The traced window's device operations and host spans, in the
    profiler's clock: ``device`` [(start, end, name)] of the kernels and
    copies, ``spans`` [(start, end, name)] of the host's annotated ranges
    (the program's ``profiling.span`` names and the benchmark's own),
    ``calls`` the benchmark's call spans and ``window`` its window span.
    An annotated range is also mirrored on the device's timeline; that
    mirror is no device operation and is left out."""
    import torch
    device, spans, calls, window = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        s, t = _event_times(e)
        name = e.name()
        user = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not user:
                device.append((s, t, name))
            continue
        if name == WINDOW_SPAN:
            window = (s, t)
        elif name == CALL_SPAN:
            calls.append((s, t))
        if user:
            spans.append((s, t, name))
    names = {name for _, _, name in spans}
    device = sorted(d for d in device if d[2] not in names)
    calls.sort()
    return {"device": device, "spans": spans, "calls": calls,
            "window": window}


def merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_within(busy, lo, hi) -> float:
    """Seconds of the disjoint ``busy`` intervals inside [lo, hi]."""
    return sum(max(0.0, min(t, hi) - max(s, lo)) for s, t in busy)


def breakdown(tr: dict) -> dict:
    """The device operations that took most time, by name, and the
    window's idle gaps summed by the innermost host span open at each
    gap's start; at most 10 of each, longest first."""
    lo, hi = tr["window"]
    ops = {}
    for s, t, name in tr["device"]:
        if t > lo and s < hi:
            ops[name] = ops.get(name, 0.0) + (min(t, hi) - max(s, lo))
    busy = merged((max(s, lo), min(t, hi)) for s, t, _ in tr["device"]
                  if t > lo and s < hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = {}
    spans = sorted(tr["spans"])
    active, nxt = [], 0
    for s, t in zip(edges[::2], edges[1::2]):
        if t <= s:
            continue
        while nxt < len(spans) and spans[nxt][0] <= s:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] > s]
        key = max(active)[2] if active else "(no span)"
        gaps[key] = gaps.get(key, 0.0) + (t - s)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                if v > 0][:10]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def process_age() -> float | None:
    """Seconds since this process started, from /proc (Linux), else
    None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None
