"""Shared arithmetic of the metric readers."""

from __future__ import annotations


def rate(rec: dict, scale: float = 1e9) -> float:
    """All the work units of the window's calls over the window's time,
    in units of ``scale`` a second."""
    return sum(c["units"] for c in rec["calls"]) / rec["window_s"] / scale


def traced(rec: dict):
    """The traced window's record with its busy intervals, or None."""
    tr = rec.get("trace")
    return tr if tr and tr.get("window") and tr.get("busy") is not None \
        else None


def idle_pct(rec: dict):
    tr = traced(rec)
    if tr is None:
        return None
    lo, hi = tr["window"]
    busy = sum(t - s for s, t in tr["busy"])
    return 100.0 * (1.0 - busy / (hi - lo))


def kernels_roofline(rec: dict):
    """The least time of the window's alignment work (``roofline.py``)
    over the device's busy time in the window, in %; None when no device
    operation ran."""
    from portbench import roofline
    tr = traced(rec)
    if tr is None:
        return None
    busy = sum(t - s for s, t in tr["busy"])
    if busy <= 0:
        return None
    least = sum(roofline.least_seconds(c["work"]) for c in rec["calls"])
    return 100.0 * least / busy


def call_host_ms(rec: dict):
    """Mean over the window's calls of the call's wall minus the device's
    busy time inside it, in ms, from the traced call spans."""
    from portbench.harness import busy_within
    tr = traced(rec)
    if tr is None or not tr["calls"]:
        return None
    host = [(t - s) - busy_within(tr["busy"], s, t) for s, t in tr["calls"]]
    return 1e3 * sum(host) / len(host)


def peak_gb(rec: dict):
    peak = rec.get("peak_window_bytes")
    return peak / 1e9 if peak else None
