"""Profiling and throughput metering.

Counterpart of ``tsta_tpu/utils/profiling.py``:

* ``Phase`` -- wall-clock phase timers with a structured report;
* ``gcups`` -- the north-star metric (billions of DP cells per second);
* ``trace`` -- context manager around ``torch.profiler`` that writes a
  Chrome/Perfetto trace (``chrome://tracing``, ui.perfetto.dev);
* ``span`` -- a named range around a group of launches: an NVTX range on
  the card and a ``record_function`` span in a ``trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class Phase:
    """Accumulating named wall-clock timers."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> List[dict]:
        return [{"phase": k, "total_s": round(v, 4),
                 "calls": self.counts[k]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])]


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome/Perfetto trace
    into ``log_dir`` as ``tsta_torch.<pid>.<ms>.pt.trace.json``.  ``None``
    traces nothing."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, "tsta_torch.%d.%d.pt.trace.json"
        % (os.getpid(), int(time.time() * 1000))))


@contextlib.contextmanager
def span(name: str):
    """A named range around a group of launches: ``record_function`` (a
    span in ``trace``'s output) and, where a card is present, an NVTX
    range, so a device trace reads by phase."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
