#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (tsta_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device: card name, ``nvidia-smi`` name and power limit, torch, CUDA
   and nvcc versions;
2. build: the kernels of ``tsta_tpu_torch/csrc`` compiled with nvcc for
   sm_90a into the ignored ``build/`` directory;
3. kernels: each kernel against its plain PyTorch version on the card,
   exact integer equality (DP score-only on a mixed 100-3,000 bp batch and
   a 40 kbp pair; DP traced on 4 pairs of 2-4 kbp, every cell code; the
   walk on that plane, moves and counts);
4. main path: ``tsta-torch psa`` on the reference's 10,000 x 10,000 bp
   example pair (recovered from ``tests/golden/example_big``), traced and
   score-only, with the launch counters reset before and read after; the
   output must be byte-identical to the golden and stdout ``maxsorce=-5``;
   then ``python -m tsta_tpu_torch psa -X -3`` against ``psa_x3.out``;
5. batches: 128 x 10,240 bp score-only and 32 x 10 kbp traced (slot 0 the
   example pair), exact against the plain versions and the golden;
6. timings: kernel and plain version on the card at the main path's
   shapes (CUDA events), and every output of those runs (scores, corners,
   each plane byte, walk words and counts) exactly equal; the kernels
   record's errors are these.

The last three lines are the kernels record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without CUDA or outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "example_big")
SEED = 20261016


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + fields,
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def golden_example():
    """The reference's example reads: the golden alignment's rows with
    the gaps removed."""
    with open(os.path.join(GOLDEN, "psa_default.out"), "rb") as f:
        lines = f.read().split(b"\n")
    if len(lines) != 4 or lines[0] != b">1" or lines[2] != b">2":
        raise RuntimeError("unexpected golden layout")
    return lines[1].replace(b"-", b""), lines[3].replace(b"-", b"")


def max_err(got, want) -> int:
    import torch
    if got.shape != want.shape:
        raise AssertionError("shape %s != %s" % (tuple(got.shape),
                                                 tuple(want.shape)))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def cuda_ms(fn, reps: int):
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    timed with CUDA events on the current stream, and the last run's
    result."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def random_pairs(rng, lengths, similar):
    """Seeded pairs; ``similar`` ones are ~12% substituted and ~3%
    indel copies, the rest independent."""
    import numpy as np
    pairs = []
    for k, (n, m) in enumerate(lengths):
        a = rng.integers(0, 4, n).astype(np.uint8)
        if similar(k):
            b = a.copy()
            b[rng.integers(0, n, n // 8)] = rng.integers(0, 4, n // 8)
            b = np.delete(b, rng.integers(0, n, n // 60))
            b = np.insert(b, rng.integers(0, len(b), n // 60),
                          rng.integers(0, 4, n // 60).astype(np.uint8))
            b = np.resize(b, m)
        else:
            b = rng.integers(0, 4, m).astype(np.uint8)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        pairs.append((acgt[a], acgt[b]))
    return pairs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

    from tsta_tpu_torch import AlignParams, cli
    from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan
    from tsta_tpu_torch.ops import traceback as tb
    from tsta_tpu_torch.parallel import batch as pbatch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    params = AlignParams()
    p = psa_scan.as_params(params)
    rng = np.random.default_rng(SEED)
    kind = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")

    # 1. device
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit({"phase": "device", "name": kind, "smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1]})

    # 2. build
    t0 = time.perf_counter()
    _kernels.build()
    info = _kernels.build_info
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(info["seconds"], 3),
          "library": os.path.relpath(info["path"], ROOT),
          "flags": " ".join(_kernels.NVCC_FLAGS),
          "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                    if "Used" in ln or "spill" in ln]})

    # 3. each kernel against its plain version, on the card
    errs = {k: 0 for k in _kernels.KERNELS}
    lens_mixed = [(int(rng.integers(100, 3001)), int(rng.integers(100, 3001)))
                  for _ in range(64)]
    batches = [random_pairs(rng, lens_mixed, lambda k: k % 2 == 0),
               random_pairs(rng, [(40000, 39700)], lambda k: True)]
    for pairs in batches:
        a, b, lens = psa_diff.pack_pairs(pairs, dev)
        got = psa_diff.dp_packed(a, b, lens, p)
        want = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], p)[:2]
        torch.cuda.synchronize()
        errs["psa_dp_score"] = max(errs["psa_dp_score"],
                                   *(max_err(g, w) for g, w in zip(got, want)))
    pairs = random_pairs(rng, [(int(rng.integers(2000, 4001)),
                                int(rng.integers(2000, 4001)))
                               for _ in range(4)], lambda k: k < 3)
    pairs = [(x, y) if len(x) >= len(y) else (y, x) for x, y in pairs]
    a, b, nm = psa_diff.pack_pairs(pairs, dev, traced=True)
    ks, kc, kplane = psa_diff.dp_packed(a, b, nm, p, traced=True)
    ps, pc, pplane = psa_scan.scan_rows(a, b, nm[:, 0], nm[:, 1], p, True)
    kw, kcnt = tb.walk_packed(kplane, nm)
    pw, pcnt = tb.walk_packed_plain(kplane, nm)
    torch.cuda.synchronize()
    errs["psa_dp_traced"] = max(max_err(ks, ps), max_err(kc, pc),
                                max_err(kplane, pplane))
    errs["psa_walk"] = max(max_err(kw, pw), max_err(kcnt, pcnt))
    emit({"phase": "kernels", "max_abs_err": errs,
          "score_only_pairs": [len(x) for x in batches],
          "traced_lengths": nm.tolist(), "plane": list(kplane.shape)})
    if any(errs.values()):
        raise AssertionError("kernel differs from its plain version: %s"
                             % errs)
    del kplane, pplane

    # 4. the main path through the CLI
    s1, s2 = golden_example()
    with open(os.path.join(GOLDEN, "psa_default.out"), "rb") as f:
        gold = f.read()
    with open(os.path.join(GOLDEN, "psa_x3.out"), "rb") as f:
        gold_x3 = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "seqa1.fa"), os.path.join(tmp, "seqb1.fa")
        with open(fa, "wb") as f:
            f.write(b">seqa1\n" + s1 + b"\n")
        with open(fb, "wb") as f:
            f.write(b">seqb1\n" + s2 + b"\n")
        out = os.path.join(tmp, "out.txt")
        argv = ["psa", "-1", fa, "-2", fb, "--device", "cuda"]
        buf = io.StringIO()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc1 = cli.main(argv + ["-o", out])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rc2 = cli.main(argv + ["--notrace"])
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(_kernels.launches)
        with open(out, "rb") as f:
            traced_ok = f.read() == gold
        stdout = buf.getvalue().split()
        t3 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tsta_tpu_torch", "psa", "-X", "-3",
             "-1", fa, "-2", fb, "-o", out + ".x3", "--json",
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        t4 = time.perf_counter()
        if proc.returncode != 0:
            raise RuntimeError("tsta_tpu_torch psa -X -3 failed:\n"
                               + proc.stderr)
        x3 = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(out + ".x3", "rb") as f:
            x3_ok = f.read() == gold_x3
    emit({"phase": "main_path", "rc": [rc1, rc2], "stdout": stdout,
          "golden_identical": traced_ok, "x3_golden_identical": x3_ok,
          "launches": launches, "x3_launches": x3["launches"],
          "psa_traced_wall_s": round(t1 - t0, 4),
          "psa_notrace_wall_s": round(t2 - t1, 4),
          "x3_subprocess_wall_s": round(t4 - t3, 4),
          "x3_align_wall_s": x3["wall_s"],
          "example": [len(s1), len(s2)]})
    if (rc1, rc2) != (0, 0) or stdout != ["maxsorce=-5", "maxsorce=-5"]:
        raise AssertionError("main path stdout %s rc %s" % (stdout,
                                                              (rc1, rc2)))
    if not (traced_ok and x3_ok):
        raise AssertionError("output differs from the golden files")
    if min(launches.values()) < 1 or min(x3["launches"]["psa_dp_traced"],
                                         x3["launches"]["psa_walk"]) < 1:
        raise AssertionError("a kernel of the main path never launched: "
                             "%s %s" % (launches, x3["launches"]))

    # 5. batches at the users' scale
    ex = (np.frombuffer(s1, np.uint8), np.frombuffer(s2, np.uint8))
    pairs = [ex] + random_pairs(rng, [(10240, 10240)] * 127,
                                lambda k: k % 2 == 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pbatch.align_batch(pairs, params, device=dev)
    t_batch = time.perf_counter() - t0
    a, b, lens = psa_diff.pack_pairs(pairs, dev)
    want_s, want_c, _ = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], p)
    got_s = torch.tensor([r.score for r in res], dtype=torch.int32)
    got_c = torch.tensor([r.last for r in res], dtype=torch.int32)
    score_err = max(max_err(got_s, want_s.cpu()),
                    max_err(got_c, want_c.cpu()))
    cells_score = sum(len(x) * len(y) for x, y in pairs)

    tpairs = [ex] + random_pairs(rng, [(10000, 10000)] * 31,
                                 lambda k: k % 2 == 0)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tres = pbatch.align_batch_traced_device(tpairs, params, device=dev)
    t_traced = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rescored = [tb.score_alignment(aln.a_row, aln.b_row, params) == c
                for _, c, aln in tres]
    slot0 = b">1\n" + tres[0][2].a_row + b"\n>2\n" + tres[0][2].b_row
    cells_traced = sum(len(x) * len(y) for x, y in tpairs)
    emit({"phase": "batches", "score_only_pairs": len(pairs),
          "slot0_score": res[0].score, "score_only_max_abs_err": score_err,
          "score_only_e2e_s": round(t_batch, 4),
          "score_only_e2e_gcups": round(cells_score / t_batch / 1e9, 3),
          "traced_pairs": len(tpairs), "traced_rescored_ok": all(rescored),
          "traced_slot0_golden_identical": slot0 == gold,
          "traced_e2e_s": round(t_traced, 4),
          "traced_e2e_gcups": round(cells_traced / t_traced / 1e9, 3),
          "traced_peak_device_gb": round(peak_gb, 3), "smi": smi_line})
    if res[0].score != -5 or score_err or not all(rescored) \
            or slot0 != gold:
        raise AssertionError("batch results wrong")

    # 6. kernel and plain version at the main path's shapes: times, and
    # exact equality of every output of the timed runs
    times = {}
    ms, got = cuda_ms(lambda: psa_diff.dp_packed(a, b, lens, p), 3)
    pms, want = cuda_ms(lambda: psa_scan.scan_rows(a, b, lens[:, 0],
                                                   lens[:, 1], p), 1)
    times["psa_dp_score"] = {
        "shape": "128 x 10240 score-only", "ms": ms, "plain_ms": pms,
        "gcups": cells_score / ms / 1e6, "plain_gcups": cells_score / pms / 1e6,
        "max_abs_err": max(score_err, *(max_err(g, w)
                                        for g, w in zip(got, want[:2])))}
    del a, b, lens, got, want
    for label, group in (("32 x 10 kbp", tpairs), ("1 x 10 kbp", [ex])):
        a, b, nm = psa_diff.pack_pairs(group, dev, traced=True)
        cells = sum(len(x) * len(y) for x, y in group)
        ms, (ks, kc, plane) = cuda_ms(
            lambda: psa_diff.dp_packed(a, b, nm, p, True), 2)
        pms, (ps, pc, pplane) = cuda_ms(
            lambda: psa_scan.scan_rows(a, b, nm[:, 0], nm[:, 1], p, True), 1)
        # per pair, so the int64 difference stays small
        dp_err = max(max_err(ks, ps), max_err(kc, pc),
                     *(max_err(g, w) for g, w in zip(plane, pplane)))
        del pplane
        wms, (kw, kcnt) = cuda_ms(lambda: tb.walk_packed(plane, nm), 2)
        wpms, (pw, pcnt) = cuda_ms(lambda: tb.walk_packed_plain(plane, nm), 1)
        times["psa_dp_traced " + label] = {
            "shape": label + " traced", "ms": ms, "plain_ms": pms,
            "gcups": cells / ms / 1e6, "plain_gcups": cells / pms / 1e6,
            "max_abs_err": dp_err}
        times["psa_walk " + label] = {
            "shape": label, "ms": wms, "plain_ms": wpms,
            "max_abs_err": max(max_err(kw, pw), max_err(kcnt, pcnt))}
        del a, b, nm, plane, ks, kc, ps, pc, kw, kcnt, pw, pcnt
    emit({"phase": "timings", "times": times, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    bad = {k: t["max_abs_err"] for k, t in times.items() if t["max_abs_err"]}
    if bad:
        raise AssertionError("kernel differs from its plain version at the "
                             "main path's shapes: %s" % bad)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    src = "tsta_tpu_torch/csrc/%s"
    entries = [
        ("psa_dp_score", src % "psa_dp.cu", "tsta_tpu/ops/psa_diff.py:309",
         times["psa_dp_score"]),
        ("psa_dp_traced", src % "psa_dp.cu", "tsta_tpu/ops/psa_diff.py:309",
         times["psa_dp_traced 32 x 10 kbp"]),
        ("psa_walk", src % "psa_walk.cu", "tsta_tpu/ops/traceback.py:614",
         times["psa_walk 32 x 10 kbp"]),
    ]
    emit({"kernels": [{"name": n, "route": "cuda", "source": s,
                       "replaces": r, "launches": launches[n],
                       "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                       "plain_ms": t["plain_ms"], "shape": t["shape"]}
                      for n, s, r, t in entries]})
    print(smi_line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
