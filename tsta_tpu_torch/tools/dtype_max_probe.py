"""The narrow-dtype max probe (Q2-17d) on the card: what an elementwise max
costs in int16, uint16, int8 and uint8 against int32, and the s16x2 DPX
forms of the difference method's cell against their int32 forms.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.dtype_max_probe [--iters 2000]
        [--copies 256] [--reps 5]

Counterpart of the TPU probe ``scripts/dtype_max_probe.py`` (its kernel
``kern``, ``pallas_call`` at :34): a (256, 128) tile of one dtype, ``c =
x`` then ``iters`` rounds of ``max(max(max(max(c, y), x), y), x)``, x and
y drawn as the script draws them, over the dtype's whole range (a fresh
``default_rng(0)`` a form).  ``csrc/dtype_max_probe.cu`` runs it as
packed SIMD where the card has it (``__vmaxs2``, ``__vmaxu2``, ``__vmaxs4``, ``__vmaxu4``: two
or four lanes a 32-bit word; int32 one ``max.s32`` a lane) over
``copies`` copies of the tile, each word a chain of its own.  The DPX
forms run ``c = max(c + y, x)`` (``__viaddmax_s32``, ``__viaddmax_s16x2``;
y in [-2, 1] and x in [-1,000, 1,000], so no lane leaves int16) and ``c =
max(c, y, x)`` (``__vimax3_s32``, ``__vimax3_s16x2``), four times a
round.  Every output is held to :func:`plain`, numpy's, exactly; the
times are CUDA events, the median of ``reps`` after a warm-up (numpy's,
one tile, on the host clock).

Prints one JSON line a form: ms, ``ns_per_tile_max`` (the TPU probe's
unit: ms over iters * 4 * copies tile-wide maxes), ``lanes_per_clock``
(element-maxes a clock an SM at the boost clock, 1.98 GHz), its speed over
its int32 form at the same element count, ``bound_ms`` (its instructions,
one a 32-bit word of lanes and step, at the issue rate: 128 lanes a clock
an SM, four schedulers of one warp instruction each, at the boost clock;
the bytes, two tiles read and the copies written, at 3.35 TB/s, where
longer), and whether it equals numpy; then the card's name and power
limit.  Exits non-zero if any form differs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

ROWS, LANES = 256, 128          # the TPU probe's tile
SM_CLOCK_HZ = 1.98e9            # the H100's boost clock
SCHED_LANES = 128               # an SM's four schedulers, a warp each a clock
HBM_BYTES_PER_S = 3.35e12       # the H100 SXM's HBM3
# name: (numpy dtype, the kernel's form, DPX op or None, its int32 form)
FORMS = {
    "int32": (np.int32, 0, None, "int32"),
    "int16": (np.int16, 1, None, "int32"),
    "uint16": (np.uint16, 2, None, "int32"),
    "int8": (np.int8, 3, None, "int32"),
    "uint8": (np.uint8, 4, None, "int32"),
    "viaddmax_s32": (np.int32, 5, "viaddmax", "viaddmax_s32"),
    "viaddmax_s16x2": (np.int16, 6, "viaddmax", "viaddmax_s32"),
    "vimax3_s32": (np.int32, 7, "vimax3", "vimax3_s32"),
    "vimax3_s16x2": (np.int16, 8, "vimax3", "vimax3_s32"),
}
launches = 0


def tile(name: str, seed: int = 0):
    """(x, y): the (256, 128) inputs of ``name``'s form: the TPU probe's
    draw over the dtype's range, or for viaddmax x in [-1,000, 1,000] and
    y in [-2, 1]."""
    dt = np.dtype(FORMS[name][0])
    rng = np.random.default_rng(seed)
    if FORMS[name][2] == "viaddmax":
        return (rng.integers(-1000, 1001, (ROWS, LANES)).astype(dt),
                rng.integers(-2, 2, (ROWS, LANES)).astype(dt))
    info = np.iinfo(dt)
    return (rng.integers(info.min, info.max, (ROWS, LANES)).astype(dt),
            rng.integers(info.min, info.max, (ROWS, LANES)).astype(dt))


def plain(name: str, x: np.ndarray, y: np.ndarray, iters: int):
    """The probe's function in numpy, step by step, in the form's dtype."""
    op = FORMS[name][2]
    c = x.copy()
    for _ in range(iters):
        for v in (y, x, y, x):
            if op == "viaddmax":
                c = np.maximum(c + y, x)
            elif op == "vimax3":
                c = np.maximum(np.maximum(c, y), x)
            else:
                c = np.maximum(c, v)
    return c


def run(name: str, x, y, iters: int, copies: int):
    """``csrc/dtype_max_probe.cu`` on CUDA tensors x, y ((256, 128) of the
    form's dtype): returns (copies, 256, 128) of that dtype, each copy the
    probe's function of the tile.  Adds one to :data:`launches`."""
    import torch

    from tsta_tpu_torch.ops import _kernels
    global launches
    dev = x.device
    if dev.type != "cuda" or y.device != dev:
        raise ValueError("dtype_max_probe needs CUDA tensors, got %s"
                         % dev)
    if x.shape != (ROWS, LANES) or y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError("x and y must be (256, 128) of one dtype")
    words = ROWS * LANES * x.element_size() // 4
    out = torch.empty((copies, ROWS, LANES), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels._lib().tsta_dtype_max_probe(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), FORMS[name][1], words,
            iters, copies, _kernels._stream(dev))
    _kernels._raise_on(rc, "dtype_max_probe")
    launches += 1
    return out


def measure(iters: int = 2000, copies: int = 256, reps: int = 5,
            dev=None) -> dict:
    """Every form on the card: its time (CUDA events, median of ``reps``
    after a warm-up), rates, and whether every copy equals :func:`plain`.
    Returns {name: record}."""
    import torch
    dev = torch.device(dev or "cuda")
    res = {}
    for name, (dt, _, _, base) in FORMS.items():
        x, y = tile(name)
        tx = torch.from_numpy(x).to(dev)
        ty = torch.from_numpy(y).to(dev)
        run(name, tx, ty, iters, copies)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = run(name, tx, ty, iters, copies)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        t0 = time.perf_counter()
        want = plain(name, x, y, iters)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = out.cpu().numpy()
        t = statistics.median(ms)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lane_ops = ROWS * LANES * iters * 4 * copies
        # a step of a 32-bit word: one max (or DPX) instruction for its
        # 4 / itemsize lanes, whether or not the card has it as one
        instrs = lane_ops * x.itemsize / 4
        t_ops = instrs / (SCHED_LANES * SM_CLOCK_HZ * sms) * 1e3
        t_bytes = (2 + copies) * x.nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {
            "dtype": np.dtype(dt).name, "ms": t, "runs_ms": ms,
            "plain_ms": plain_ms,
            "ns_per_tile_max": t * 1e6 / (iters * 4 * copies),
            "lanes_per_clock": lane_ops / (t * 1e-3 * SM_CLOCK_HZ * sms),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "equal": bool((got == want[None]).all()),
            "max_abs_err": int(np.abs(got.astype(np.int64)
                                      - want[None].astype(np.int64)).max()),
            "vs": base}
    for r in res.values():
        r["speed_over_int32_form"] = res[r["vs"]]["ms"] / r["ms"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--copies", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    res = measure(args.iters, args.copies, args.reps)
    for name, r in res.items():
        print(json.dumps({"form": name, **r}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0 if all(r["equal"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
