"""The walk probes (Q2-17a, b, c, e) on the card: what one step of a serial
walk costs on an H100 SM, piece by piece.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.walk_probes [--probe a|b|c|e] [--reps 5]

Counterparts of the TPU probes under ``scripts/``, each at the script's
sizes:

- (a) ``walk_ablate.py:36 kernel``: N = 10,240 steps of a while loop, one
  piece of the banded walk's body added a mode (``empty``, ``wr``, ``rd``,
  ``rd3``, ``cond``, ``cond_dma``);
- (b) ``walk_ablate2.py:32 kernel``: the loop's structure at N = 163,840
  (``while_empty``, ``fori_empty``, ``unroll4``, ``unroll8``,
  ``cond_dma``, ``full_unroll8``);
- (c) ``walk_ablate3.py:33 kernel``: a walk over a (128, 256) window of a
  (10,240, 20,480) plane, ``plane[r, c] = c`` (``nodma``, ``decode``,
  ``six``, ``dma119``, ``dma18``);
- (e) ``db_probe.py:14 kern``: two copies into a double-buffered band,
  then 64 reads summed (``db``).

``csrc/walk_probes.cu`` runs each program as one block, thread 0
walking, the P programs side by side on P SMs (on the TPU they ran one
after another on one core), and :func:`plain` replays one program in
Python integers with the scripts' floor division.  Facts of the scripts
that the port keeps: in (a) and (b) the refetch never fires (bi0 starts at
-2^30 and i >= 0), so the copy is compiled in and never taken; most modes
read a band nothing wrote, and (c)'s ``six`` raises its bi0 in most steps
(its miss test holds while i >= bi0 + 128 or j >= 1,024: in 9,216 of the
10,240 at the script's sizes).  On a TPU the
words of the band and of ``out`` that nothing writes are undefined; the
port pins them to INT32_MIN, the value interpret mode gives them, so every
mode's whole ``out`` is defined and compared.

Prints one JSON line a probe and mode: ``ms`` (CUDA events, the median of
``reps`` after a warm-up, each launch behind a short device sleep so no
host time is timed), ``ns_per_step`` = ms / N (the card's unit, the
programs running side by side), ``ns_per_step_marginal`` (ms at N less ms
at N / 2, over N / 2 steps: the fixed cost of a launch cancelled),
``tpu_unit_ns`` = ms / (P N) (the scripts' unit, their programs in turn),
``sass_instr_per_step`` (the walker loop's shortest cycle in the library's
SASS, over the steps a body), ``refetches`` (counted by the plain replay),
``bound_ms`` and ``bound_by``, ``plain_ms`` (host clock) and ``equal``;
then the card's name and power limit.  The bound is the longer of the
walks' chain rule (the dependent shared-memory loads on a step's chain, 30
cycles each at 1,980 MHz, plus each copy that fires at 3.35 TB/s) and the
issue rule (one instruction a clock, one thread issuing); the bytes every
program copies and ``out`` at 3.35 TB/s stand beside them.  Exits non-zero
if any output differs, a mode beats its bound, a loop is missing from the
SASS, or a time does not grow with N.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from tsta_tpu_torch.ops import _kernels

INT32_MIN = -2 ** 31
SM_CLOCK_HZ = 1.98e9            # the H100's boost clock
CHAIN_CYCLES = 30               # a dependent shared-memory load
HBM_BYTES_PER_S = 3.35e12       # the H100 SXM's HBM3
MIN_SCALING = 1.5               # ms at N over ms at N / 2, a loop of N steps
# the scripts' sizes (and (e)'s 64 reads)
SIZES = {
    "a": dict(N=10240, P=8, BAND_R=24, BAND_W=1024),
    "b": dict(N=163840, P=8, BAND_R=24, BAND_W=1024),
    "c": dict(N=10240, P=8, M_ROWS=10240, N_W=20480, BAND_R=128,
              BAND_W=256),
    "e": dict(R=8, WS=8, L=128, STEPS=64),
}
# the TPU kernel each probe replaces, and the mode the smoke reports
SCRIPTS = {
    "a": ("scripts/walk_ablate.py:36 kernel (pallas_call :91)", "cond_dma"),
    "b": ("scripts/walk_ablate2.py:32 kernel (pallas_call :101)",
          "full_unroll8"),
    "c": ("scripts/walk_ablate3.py:33 kernel (pallas_call :123)", "dma119"),
    "e": ("scripts/db_probe.py:14 kern (pallas_call :31)", "db"),
}
BI0 = _kernels.PROBE_BI0        # (a) and (b)'s refetch state at the start
OUT_RING = 10240                # (b)'s out ring
# dependent shared-memory loads on one step's chain: in (c) a step's reads
# are addressed by the j the step before moved to; elsewhere by i or t,
# which no load feeds
CHAIN_LOADS = {"a": 0, "b": 0, "c": 1, "e": 0}


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def _rows(plane, r, rows, c=0, cols=None):
    """``plane[r:r + rows, c:c + cols]`` as lists, the start clamped into
    the plane as dynamic_slice clamps it."""
    r = _clip(r, 0, plane.shape[0] - rows)
    cols = plane.shape[1] if cols is None else cols
    return plane[r:r + rows, c:c + cols].tolist()


def _plain_a(mode, plane, N, BAND_R, BAND_W, **_):
    band = [[INT32_MIN] * BAND_W for _ in range(BAND_R)]
    row = [INT32_MIN] * (N + 1)
    cond = mode in ("cond", "cond_dma")
    i, t, acc, bi0, fetches = N - 1, 0, 0, BI0 if cond else 0, 0
    while i >= 0:
        if cond and i < bi0:
            if mode == "cond_dma":
                bi = max((i - 15) // 8 * 8, 0)
                band = _rows(plane, bi, BAND_R, 0, BAND_W)
                fetches += 1
                bi0 = bi
            else:
                bi0 = max(i - 23, 0)
        acc2 = acc
        if mode not in ("empty", "wr"):
            li = _clip(i - bi0 if cond else i % BAND_R, 0, BAND_R - 1)
            sh = (i & 3) * 8
            acc2 = acc + ((band[li][(i >> 2) % BAND_W] >> sh) & 0xFF)
            if mode != "rd":
                w2 = band[li][(max(i - 1, 0) >> 2) % BAND_W]
                w3 = band[max(li - 1, 0)][(i >> 2) % BAND_W]
                f = ((w2 >> sh) & 0xFF) // 3 % 3
                e = ((w3 >> sh) & 0xFF) % 3
                acc2 += 1 if acc2 % 9 == 1 else (0 if f > e else 2)
        if mode != "empty":
            row[t] = acc2
        i, t, acc = i - 1, t + 1, acc2
    row[0] = acc
    return row, fetches


def _plain_b(mode, plane, N, BAND_R, BAND_W, **_):
    if N % 8:
        raise ValueError("probe b: N %d must be a multiple of 8" % N)
    band = [[INT32_MIN] * BAND_W for _ in range(BAND_R)]
    row = [INT32_MIN] * _kernels.PROBE_B_OUT_COLS
    if mode == "fori_empty":
        i, t, acc = N - 1, 0, 0
        for _ in range(N):
            i, t, acc = i - 1, t + 1, acc + 1
        row[0] = acc
        return row, 0

    def read_step(i, t, acc, bi0):
        li = _clip(i - bi0, 0, BAND_R - 1)
        sh = (i & 3) * 8
        code = (band[li][(i >> 2) % BAND_W] >> sh) & 0xFF
        w2 = band[li][(max(i - 1, 0) >> 2) % BAND_W]
        w3 = band[max(li - 1, 0)][(i >> 2) % BAND_W]
        f = ((w2 >> sh) & 0xFF) // 3 % 3
        e = ((w3 >> sh) & 0xFF) % 3
        move = 1 if code % 9 == 1 else (0 if f > e else 2)
        row[t % OUT_RING] = acc + move
        return acc + move

    U = {"while_empty": 1, "unroll4": 4, "unroll8": 8, "cond_dma": 1,
         "full_unroll8": 8}[mode]
    dma = mode in ("cond_dma", "full_unroll8")
    i, t, acc, bi0, fetches = N - 1, 0, 0, BI0 if dma else 0, 0
    while i >= 0:
        if dma and i < bi0:
            # the script clips to 256 - BAND_R, its plane's rows
            bi = _clip(((i % 224) - 15) // 8 * 8, 0,
                       plane.shape[0] - BAND_R)
            band[:] = _rows(plane, bi, BAND_R, 0, BAND_W)
            fetches += 1
            bi0 = bi
        for k in range(U):
            if mode in ("unroll4", "unroll8"):
                row[(t + k) % OUT_RING] = acc
                acc += 1
            elif mode == "full_unroll8":
                acc = read_step(i - k, t + k, acc, bi0)
            else:
                acc += 1
        i, t = i - U, t + U
    row[0] = acc
    return row, fetches


def _plain_c(mode, plane, N, M_ROWS, N_W, BAND_R, BAND_W, **_):
    band = [[INT32_MIN] * BAND_W for _ in range(BAND_R)]
    row = [INT32_MIN] * (N + 8)
    dma = mode in ("dma119", "dma18")
    period = 119 if mode == "dma119" else 18
    i, t, j, forced, bi0, wj0, fetches = N - 1, 0, N - 1, 0, 0, 0, 0
    while i >= 0:
        if dma and t % period == 0:
            bi = _clip((i - (BAND_R - 9)) // 8 * 8, 0, M_ROWS - BAND_R)
            wj = _clip(((j >> 2) + 128) // 128 * 128 - BAND_W, 0,
                       N_W - BAND_W)
            band = _rows(plane, bi, BAND_R, wj, BAND_W)
            fetches += 1
            bi0, wj0 = bi, wj
        elif mode == "six":
            miss = i >= 0 and j >= 0 and (
                (i > 0 and i - 1 < bi0 - 2 * M_ROWS)
                or i < bi0 - 2 * M_ROWS or i >= bi0 + BAND_R
                or (max(j - 1, 0) >> 2) < wj0 - 2 * N_W
                or (j >> 2) >= wj0 + BAND_W)
            bi0 += 1 if miss else 0
        li = _clip(i - bi0, 0, BAND_R - 1) if dma else i % BAND_R
        ww = _clip((max(j, 0) >> 2) - wj0 if dma else (j >> 2) % BAND_W,
                   0, BAND_W - 1)
        sh = (j & 3) * 8
        code = (band[li][ww] >> sh) & 0xFF
        fprev = ((band[li][_clip(ww - 1, 0, BAND_W - 1)] >> sh)
                 & 0xFF) // 3 % 3
        eprev = ((band[_clip(li - 1, 0, BAND_R - 1)][ww] >> sh) & 0xFF) % 3
        if mode == "nodma":
            move = code % 3
        else:   # the real _decode_step rules, with the forced-move carry
            in_core = i >= 0 and j >= 0
            back, f, e = code // 9, code // 3 % 3, code % 3
            if in_core:
                move = forced - 1 if forced > 0 else back
            else:
                move = 0 if j >= 0 else 2
            left = move == 0 and j - 1 >= 0 and (
                f == 0 or (f >= 1 and fprev == 2))
            up = move == 2 and i - 1 >= 0 and (
                e == 0 or (e >= 1 and eprev == 2))
            forced = (1 if left else 3 if up else 0) if in_core else 0
        row[t] = move
        i, t, j = i - 1, t + 1, j - (0 if move == 2 else 1)
    row[0] = t + bi0
    return row, fetches


def _plain_e(mode, x, R, WS, L, STEPS, **_):
    band = [x[0:R].tolist(), x[R:2 * R].tolist()]   # the two copies
    acc = 0
    for t in range(STEPS):
        acc += band[t & 1][t % R][(t * 7) % WS][(t * 13) % L]
    return [acc], 2


def plain(probe: str, mode: str, plane, **sizes):
    """The probe's TPU program, one of them, replayed in Python integers
    over ``plane`` (a numpy int32 array; (e)'s ``x``), at the script's
    sizes where ``sizes`` names none.  Returns (out, refetches): the whole
    ``out`` array, every program's row the same, INT32_MIN where nothing
    is written, and the copies one program made."""
    sz = {**SIZES[probe], **sizes}
    fn = {"a": _plain_a, "b": _plain_b, "c": _plain_c, "e": _plain_e}[probe]
    row, fetches = fn(mode, np.asarray(plane), **sz)
    out = np.array(row, np.int32)[None]
    return np.repeat(out, sz.get("P", 1), axis=0), fetches


def make_plane(probe: str, dev=None, **sizes):
    """The probe's input as the script makes it, on ``dev`` (a torch
    device; None: numpy only), and its numpy copy: (a), (b) the (256,
    1,024) plane from ``default_rng(0)``; (c) ``plane[r, c] = c`` of
    (M_ROWS, N_W), made on the device; (e) ``x = arange`` of (2R, WS,
    L)."""
    sz = {**SIZES[probe], **sizes}
    if probe == "c":
        import torch
        row = torch.arange(sz["N_W"], dtype=torch.int32,
                           device=dev or "cpu")
        t = row.expand(sz["M_ROWS"], sz["N_W"]).contiguous()
        return (t if dev is not None else None), t.cpu().numpy()
    if probe == "e":
        host = np.arange(2 * sz["R"] * sz["WS"] * sz["L"],
                         dtype=np.int32).reshape(2 * sz["R"], sz["WS"],
                                                 sz["L"])
    else:
        host = np.random.default_rng(0).integers(
            0, 2 ** 31, (256, sz["BAND_W"]), np.int64).astype(np.int32)
    if dev is None:
        return None, host
    import torch
    return torch.from_numpy(host).to(dev), host


def run(probe: str, mode: str, plane, out, n: int) -> None:
    """``csrc/walk_probes.cu`` on CUDA tensors: ``plane`` the probe's
    input, ``out`` ((P, ``_kernels.walk_probe_out_cols``) int32,
    INT32_MIN-filled by the caller), ``n`` the steps (for (e) its reads).
    Adds one to the probe's entry of ``_kernels.launches``."""
    if probe == "e":
        _kernels.walk_probe_e(plane, out, n)
    else:
        getattr(_kernels, "walk_probe_" + probe)(plane, out, mode, n)


# ---- the walker loops in the library's SASS ------------------------------

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+([^;]*?)\s*;")
_KERNEL = re.compile(r"walk_probe_([abce])(?:ILi(\d+)EE)?")


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output as {function: [(address, predicate,
    opcode, operands)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if not m or cur is None:
            continue
        addr, words = int(m.group(1), 16), m.group(2).split(None, 1)
        pred = ""
        if words and words[0].startswith("@"):
            pred = words[0]
            words = words[1].split(None, 1) if len(words) > 1 else []
        op = words[0] if words else ""
        args = words[1] if len(words) > 1 else ""
        cur.append((addr, pred, op, args))
    return funcs


def _successors(insns) -> list:
    at = {ins[0]: k for k, ins in enumerate(insns)}
    succ = []
    for k, (_, pred, op, args) in enumerate(insns):
        base = op.split(".")[0]
        nxt = [k + 1] if k + 1 < len(insns) else []
        conditional = pred not in ("", "@PT")
        if base == "BRA":
            hexes = re.findall(r"0x[0-9a-f]+", args)
            tgt = at.get(int(hexes[-1], 16)) if hexes else None
            s = [tgt] if tgt is not None else []
            succ.append(s + nxt if conditional or "," in args else s)
        elif base in ("EXIT", "RET", "BPT"):   # BPT.TRAP ends the kernel
            succ.append(nxt if conditional else [])
        elif base in ("BRX", "JMX"):
            succ.append([])
        else:
            succ.append(nxt)
    return succ


def _natural_loops(insns):
    """The instructions' successors and the natural loops of one kernel's
    SASS, over the instructions reachable from its entry: (succ, {header:
    (body, back-edge sources)})."""
    n = len(insns)
    succ = _successors(insns)
    preds = [[] for _ in range(n)]
    for k, ss in enumerate(succ):
        for s in ss:
            preds[s].append(k)
    seen, stack = {0}, [0]
    while stack:
        for s in succ[stack.pop()]:
            if s not in seen:
                seen.add(s)
                stack.append(s)
    full = (1 << n) - 1
    dom = [full] * n
    dom[0] = 1
    changed = True
    while changed:
        changed = False
        for k in sorted(seen - {0}):
            d = full
            for p in preds[k]:
                if p in seen:
                    d &= dom[p]
            d |= 1 << k
            if d != dom[k]:
                dom[k], changed = d, True
    loops = {}   # header -> (body, back-edge sources)
    for k in seen:
        for h in succ[k]:
            if dom[k] >> h & 1:
                body, srcs = loops.setdefault(h, ({h}, set()))
                srcs.add(k)
                stack = [k]
                while stack:
                    u = stack.pop()
                    if u not in body:
                        body.add(u)
                        stack.extend(p for p in preds[u] if p in seen)
    return succ, loops


def _shortest_cycle(h, body, srcs, succ):
    """The instructions of the loop's shortest cycle through its header
    (breadth first, one instruction a node), header first; None if none
    closes."""
    parent, queue = {h: None}, [h]
    for u in queue:
        for s in succ[u]:
            if s in body and s not in parent:
                parent[s] = u
                queue.append(s)
    ends = [k for k in srcs if k in parent]
    if not ends:
        return None
    path, k = [], min(ends, key=lambda e: queue.index(e))
    while k is not None:
        path.append(k)
        k = parent[k]
    return path[::-1]


def walker_loop(insns):
    """The walker's loop in one kernel's SASS: the last outermost natural
    loop after the block's barrier (the fill's loop comes before it; a
    refetch's copy and wait loops nest inside it; (e)'s copies' loop comes
    before it).  Returns {"instructions": its body's, "cycle": the
    instructions of its shortest cycle (the step that takes no rare
    branch)}, or None when no loop follows the barrier."""
    bar = next((k for k, ins in enumerate(insns)
                if ins[2].startswith("BAR")), None)
    if bar is None or not insns:
        return None
    succ, loops = _natural_loops(insns)
    outer = [h for h, (body, _) in loops.items() if h > bar and not any(
        g != h and h in b for g, (b, _) in loops.items())]
    if not outer:
        return None
    h = max(outer)
    body, srcs = loops[h]
    return {"instructions": len(body),
            "cycle": len(_shortest_cycle(h, body, srcs, succ))}


# the PSA walks on the window ring: K3 and Q2-16 (psa_walk.cu), Q2-8
# (psa_walk_bounded.cu), Q2-12 (psa_walk_pair2.cu)
_WALK_KERNEL = re.compile(r"(psa_walk(?:_bounded|_pair2)?)_kernel")
WALK_LOADS_A_STEP = 3   # a step reads its cell, the left and the upper code


def step_loops(insns) -> list:
    """The walker's step loops in one window-ring walk kernel's SASS: each
    natural loop with no barrier whose shortest cycle reads the window
    with ``ld.shared.u8`` (LDS.U8, three a step), as {"instructions": its
    body's, "cycle": its shortest cycle's, "lds": the LDS.U8 on that
    cycle, "per_step": cycle over lds / 3}, fewest per_step first.  In the
    two-pair loop every three loads are a step of one pair, so its
    per_step counts a pair-step."""
    succ, loops = _natural_loops(insns)
    res = []
    for h, (body, srcs) in loops.items():
        if any(insns[k][2].startswith("BAR") for k in body):
            continue   # the phase loop, which holds the step loops
        path = _shortest_cycle(h, body, srcs, succ)
        lds = sum(insns[k][2].startswith("LDS.U8") for k in path or ())
        if lds >= WALK_LOADS_A_STEP:
            res.append({"instructions": len(body), "cycle": len(path),
                        "lds": lds,
                        "per_step": len(path) * WALK_LOADS_A_STEP / lds})
    return sorted(res, key=lambda r: r["per_step"])


def walk_sass_steps(text: str) -> dict:
    """{kernel: {"loops": :func:`step_loops`, "per_step": the fewest}} for
    the PSA walk kernels in ``text`` (``cuobjdump -sass`` of the library):
    ``psa_walk``, ``psa_walk_bounded`` and ``psa_walk_pair2``."""
    res = {}
    for name, insns in parse_sass(text).items():
        m = _WALK_KERNEL.search(name)
        if not m:
            continue
        loops = step_loops(insns)
        res[m.group(1)] = {"loops": loops, "per_step":
                           loops[0]["per_step"] if loops else None}
    return res


def sass_steps(text: str) -> dict:
    """{(probe, mode): {"instructions", "cycle", "per_step"}} for every
    walk probe kernel in ``text`` (``cuobjdump -sass`` of the library):
    the walker loop's shortest cycle over the steps a body (8 in (b)'s
    ``unroll8`` and ``full_unroll8``, 4 in ``unroll4``), or None for a
    kernel with no walker loop."""
    res = {}
    for name, insns in parse_sass(text).items():
        m = _KERNEL.search(name)
        if not m:
            continue
        probe = m.group(1)
        mode = _kernels.WALK_PROBE_MODES[probe][int(m.group(2) or 0)]
        loop = walker_loop(insns)
        if loop is not None:
            u = {"unroll4": 4, "unroll8": 8, "full_unroll8": 8}.get(mode, 1)
            loop["per_step"] = loop["cycle"] / u
        res[(probe, mode)] = loop
    return res


def library_sass() -> str:
    """``cuobjdump -sass`` of the built kernel library."""
    lib = _kernels.build()
    tool = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def bound(probe: str, steps: int, per_step: float, refetches: int, P: int,
          out_words: int) -> dict:
    """The least time of ``steps`` steps of one program: the chain rule
    (CHAIN_LOADS dependent loads a step at CHAIN_CYCLES, plus the
    program's copies at the HBM rate) or the issue rule (``per_step``
    instructions a step at one a clock), the longer; and the bytes all P
    programs copy and ``out`` at the HBM rate, if longer still."""
    copy = {"a": 98304, "b": 98304, "c": 131072, "e": 32768}[probe]
    chain_load = steps * CHAIN_LOADS[probe] * CHAIN_CYCLES / SM_CLOCK_HZ
    copy_s = refetches * copy / HBM_BYTES_PER_S
    rules = {"chain": chain_load + copy_s,
             "issue": steps * per_step / SM_CLOCK_HZ,
             "bytes": (P * refetches * copy + 4 * out_words)
             / HBM_BYTES_PER_S}
    rule = max(rules, key=rules.get)
    by_bytes = rule == "bytes" or (rule == "chain" and copy_s > chain_load)
    return {"bound_ms": rules[rule] * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "bound_rule": rule,
            **{k + "_ms": v * 1e3 for k, v in rules.items()}}


def _timed(fn, reps: int) -> list:
    """CUDA-event milliseconds of ``reps`` calls of ``fn``, each behind a
    device sleep long enough for the host to enqueue the launch, so the
    events time the kernel and not the host's call."""
    import torch
    ms = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(2_000_000)
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return ms


def problems(rec: dict) -> list:
    """What is wrong with a mode's record: an output that differs, a loop
    the SASS lacks, a time that does not grow with N, a bound beaten."""
    bad = []
    if not rec["equal"]:
        bad.append("differs from plain")
    if rec["sass_instr_per_step"] is None:
        bad.append("no walker loop in the SASS")
    if rec.get("scaling") is not None and rec["scaling"] < MIN_SCALING:
        bad.append("time does not grow with N (x%.2f)" % rec["scaling"])
    if rec["ms"] < rec["bound_ms"]:
        bad.append("beat its bound")
    return bad


def measure(probes: str = "abce", reps: int = 5, dev=None) -> list:
    """Every mode of each probe on the card at the script's sizes: its
    output against :func:`plain`, its times, its SASS loop and its bound.
    Returns the records (see :func:`problems`).  (c)'s plane is made on
    the card, copied to the host for the plain replay, and both are freed
    before the next probe."""
    import torch
    dev = torch.device(dev or "cuda")
    sass = sass_steps(library_sass())
    recs = []
    for probe in probes:
        sz = SIZES[probe]
        n, P = sz.get("N", sz.get("STEPS")), sz.get("P", 1)
        cols = _kernels.walk_probe_out_cols(probe, n)
        plane, host = make_plane(probe, dev, **sz)
        for mode in _kernels.WALK_PROBE_MODES[probe]:

            def launch(steps, out):
                run(probe, mode, plane, out, steps)
                return out

            def empty(steps):
                return torch.full((P, _kernels.walk_probe_out_cols(
                    probe, steps)), INT32_MIN, dtype=torch.int32, device=dev)

            first = launch(n, empty(n))      # the warm-up, compared too
            out = empty(n)
            runs = _timed(lambda: launch(n, out), reps)
            half = None
            if probe != "e":
                o2 = empty(n // 2)
                half = statistics.median(_timed(
                    lambda: launch(n // 2, o2), reps))
            t0 = time.perf_counter()
            want, fetches = plain(probe, mode, host, **sz)
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(int(np.abs(o.cpu().numpy().astype(np.int64)
                                 - want.astype(np.int64)).max())
                      for o in (first, out))
            ms = statistics.median(runs)
            loop = sass.get((probe, mode))
            per_step = loop["per_step"] if loop else None
            rec = {"probe": probe, "mode": mode,
                   "replaces": SCRIPTS[probe][0], "N": n, "P": P,
                   "ms": ms, "runs_ms": runs, "ms_half": half,
                   "scaling": ms / half if half else None,
                   "ns_per_step": ms * 1e6 / n,
                   "ns_per_step_marginal": (ms - half) * 1e6 / (n - n // 2)
                   if half else None,
                   "tpu_unit_ns": ms * 1e6 / (P * n),
                   "sass_instr_per_step": per_step,
                   "sass_loop_instructions": loop["instructions"]
                   if loop else None,
                   "refetches": fetches, "plain_ms": plain_ms,
                   "max_abs_err": err, "equal": err == 0,
                   **bound(probe, n, per_step or 0, fetches, P, P * cols)}
            rec["problems"] = problems(rec)
            recs.append(rec)
        del plane, host
        torch.cuda.empty_cache()
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", choices=tuple("abce"), default=None,
                    help="one probe (default: all four)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    recs = measure(args.probe or "abce", args.reps)
    for r in recs:
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 1 if any(r["problems"] for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
