"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``tsta_tpu_torch/``.  The kernels build into the checkout's
``build/`` on the first run there.  The inputs come from ``--seed``;
every distinct input is called once in set-up, then the window calls
them in turn, back to back, for ``--seconds``.  After the window the
outputs are judged against the plain reference (``portbench/reference``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number beside its limit,
also printed as the last lines of standard error.

Exits non-zero with no result line without a CUDA device, with fewer
devices than the cell asks for, without the program, or when a module
of JAX or of the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
BLOCKED = ("jax", "jaxlib", "flax", "tsta_tpu")


def blocked_modules() -> list:
    """Top-level names of loaded modules that a run may not load,
    compared whole (``tsta_tpu_torch`` is the program, not ``tsta_tpu``)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(BLOCKED))


def _pin_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", mix: dict | None = None,
        out=None, err=None) -> int:
    """One run of ``workload``; returns the exit code.  ``device`` "cpu"
    and ``mix`` (replacing the cell's parameters) are for rehearsals at a
    tiny size; a real run takes the card."""
    from portbench import harness
    out = out or sys.stdout
    err = err or sys.stderr
    age = harness.process_age()     # set-up counts from process start
    t_setup0 = time.perf_counter() - age if age is not None else T_IMPORT
    _pin_caches(harness.ROOT)
    cell = harness.cell(workload)
    if mix is not None:
        cell["mix"] = {**cell["mix"], **mix}
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: torch.cuda.is_available() is false", file=err)
            return 3
        if torch.cuda.device_count() < cell["entry"]["chips"]:
            print("portbench: %d CUDA devices, the cell asks for %d"
                  % (torch.cuda.device_count(), cell["entry"]["chips"]),
                  file=err)
            return 3
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)

        def sync():
            torch.cuda.synchronize(dev)
    else:
        dev = torch.device(device)

        def sync():
            pass
    try:
        import tsta_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print("portbench: the program is missing: %s" % e, file=err)
        return 4
    kind, params = cell["kind"], harness.scoring(cell["config"])
    seed %= 2 ** 63                 # any whole number; numpy wants >= 0
    inputs = kind.inputs(cell["mix"], seed)
    for inp in inputs:            # every distinct input's shapes, once
        kind.call(inp, params, dev)
    sync()
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    clock_factory = None
    if trace and hasattr(kind, "clock"):
        def clock_factory():
            return kind.clock(dev)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        kind.call(inputs[0], params, dev)   # the profiler's own start-up
        sync()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_setup0
    calls, outputs, window_s = harness.closed_loop(
        kind, inputs, params, dev, seconds, sync, trace, clock_factory)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    rec = {"setup_s": setup_s, "window_s": window_s, "calls": calls,
           "peak_window_bytes": window_peak, "trace": None}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else dev.type),
                  "count": 1,
                  "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {}
    if prof is not None:
        tr = harness.trace_record(prof)
        del prof
        rec["trace"] = tr
        if tr["window"] is not None:
            lo, hi = tr["window"]
            busy = harness.merged((max(s, lo), min(t, hi))
                                  for s, t, _ in tr["device"]
                                  if t > lo and s < hi)
            tr["busy"] = busy
            device_rec["busy_s"] = harness.busy_within(busy, lo, hi)
            device_rec["window_s"] = hi - lo
            result["breakdown"] = harness.breakdown(tr)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = harness.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = blocked_modules()
    if found:
        print("portbench: modules of JAX or the JAX package were loaded: %s"
              % ", ".join(found), file=err)
        return 5
    del calls, rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = kind.check(cell["mix"], inputs, outputs, params, dev, seed)
    print("portbench: the check took %.3f s" % (time.perf_counter() - t_check),
          file=err)
    correct = all(v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        print("check %s %s limit %s" % (name, v, lim), file=err)
    line = {"correct": correct, "attempted": len(outputs), "failed": 0,
            "metrics": metrics, "device": device_rec, **result,
            "checks": {name: {"value": v, "limit": lim}
                       for name, v, lim in checks}}
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return run(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
