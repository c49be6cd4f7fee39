"""K1, the score-only PSA DP of ``csrc/psa_dp.cu``, in two checkouts on one
card: their compiled code side by side, then their times, alternating.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.psa_dp_ab --other DIR [--rounds 2]

``DIR`` is the root of another checkout of the repo, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.

1. **Code.**  Each checkout's ``psa_dp.cu`` is compiled to a cubin with the
   port's flags and ``-Xptxas -v``.  For K1's instantiation (every bool
   template argument false) it prints ptxas's resource lines and its SASS
   (``cuobjdump -sass``), the instructions compared with the constant-bank
   offsets of the kernel's parameters masked, since a new parameter moves
   them.
2. **Time.**  Each run is a fresh process started in one checkout's root
   with that root on ``PYTHONPATH``: it builds that checkout's kernels and
   times ``psa_diff.dp_packed`` (one K1 launch) with CUDA events, median
   of ``--reps`` after a warm-up, on 128 pairs of 10,240 bp made from
   ``--seed`` (the smoke's K1 shape).  Each round runs other, this, this,
   other, so neither side always goes first.

Prints one JSON object per line; the last is the summary: each side's
median of its runs' medians, this over other, and whether every run's
scores and corners agree.
"""

from __future__ import annotations

import argparse
import difflib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

from tsta_tpu_torch.ops import _kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the timed process, run in either checkout: only what both have
CHILD = r"""
import hashlib, json, statistics, sys
import numpy as np, torch
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.ops import _kernels, psa_diff
seed, reps = int(sys.argv[1]), int(sys.argv[2])
rng = np.random.default_rng(seed)
acgt = np.frombuffer(b"ACGT", np.uint8)
pairs = []
for _ in range(128):
    a = rng.integers(0, 4, 10240).astype(np.uint8)
    b = a.copy()
    b[rng.integers(0, 10240, 1280)] = rng.integers(0, 4, 1280)
    b = np.delete(b, rng.integers(0, 10240, 170))
    pairs.append((acgt[a], acgt[b]))
P = AlignParams()
p = (P.match, P.mismatch, P.gap_extend, P.gap_open)
a, b, lens = psa_diff.pack_pairs(pairs, torch.device("cuda"))
scores, corners = psa_diff.dp_packed(a, b, lens, p)   # build, load, warm up
torch.cuda.synchronize()
ms = []
for _ in range(reps):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    psa_diff.dp_packed(a, b, lens, p)
    ev[1].record()
    torch.cuda.synchronize()
    ms.append(ev[0].elapsed_time(ev[1]))
out = torch.stack([scores, corners]).cpu().numpy().tobytes()
print(json.dumps({"ms": ms, "median_ms": statistics.median(ms),
                  "launches": _kernels.launches["psa_dp_score"],
                  "outputs_sha256": hashlib.sha256(out).hexdigest(),
                  "build_s": _kernels.build_info.get("seconds")}))
"""

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SASS_FUN = re.compile(r"Function : (\w+)")
_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_CBANK = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def is_k1(name: str) -> bool:
    """Whether a mangled ``psa_dp_kernel`` instantiation is K1's: every
    bool template argument false (``<false>``, or ``<256, false, false>``
    in a checkout whose ``psa_dp.cu`` still has the row-chunk mode)."""
    m = re.search(r"psa_dp_kernelI((?:L[a-z]-?\d+E)+)E", name)
    return bool(m) and "Lb1E" not in m.group(1)


def ptxas_entries(report: str) -> dict:
    """ptxas ``-v`` output, split by entry function: name -> its lines."""
    out, name = {}, None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(line.strip())
    return out


def sass_functions(dump: str) -> dict:
    """``cuobjdump -sass`` output: function name -> its instructions, with
    the parameters' constant-bank offsets masked."""
    out, name = {}, None
    for line in dump.splitlines():
        m = _SASS_FUN.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _SASS_INSN.search(line)
        if name is not None and m:
            out[name].append(_CBANK.sub("c[0x0][.]", m.group(1)))
    return out


def k1_code(root: str, work: str, tag: str) -> dict:
    """Compile ``root``'s ``psa_dp.cu`` and return K1's mangled name,
    ptxas lines and masked SASS."""
    nvcc = _kernels.nvcc_path()
    src = os.path.join(root, "tsta_tpu_torch", "csrc", "psa_dp.cu")
    cubin = os.path.join(work, tag + ".cubin")
    r = subprocess.run([nvcc] + _kernels.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", src,
                          "-o", cubin], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s" % (src, r.stderr))
    entries = ptxas_entries(r.stdout + r.stderr)
    names = [n for n in entries if is_k1(n)]
    if len(names) != 1:
        raise RuntimeError("K1 not found once in %s: %s" % (src, list(entries)))
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    return {"name": names[0], "ptxas": entries[names[0]],
            "sass": sass_functions(dump)[names[0]]}


def timed_run(root: str, seed: int, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", CHILD, str(seed), str(reps)],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode:
        raise RuntimeError("timed run in %s failed:\n%s" % (root, r.stderr))
    return json.loads(r.stdout.strip().splitlines()[-1])


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}

    with tempfile.TemporaryDirectory() as work:
        code = {k: k1_code(root, work, k) for k, root in trees.items()}
    so, st = code["other"]["sass"], code["this"]["sass"]
    diff = [d for d in difflib.unified_diff(so, st, lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("+++", "---")]
    emit({"code": {k: {"name": c["name"], "ptxas": c["ptxas"],
                       "instructions": len(c["sass"]),
                       "sass_sha256": hashlib.sha256(
                           "\n".join(c["sass"]).encode()).hexdigest()}
                   for k, c in code.items()},
          "sass_equal_masked": so == st, "sass_diff_lines": diff[:200],
          "sass_diff_count": len(diff)})

    runs = {"other": [], "this": []}
    for rnd in range(args.rounds):
        for k in ("other", "this", "this", "other"):
            res = timed_run(trees[k], args.seed, args.reps)
            runs[k].append(res)
            emit({"round": rnd, "tree": k, **res})
    med = {k: statistics.median(r["median_ms"] for r in v)
           for k, v in runs.items()}
    emit({"median_ms": med, "this_over_other": med["this"] / med["other"],
          "outputs_equal": len({r["outputs_sha256"] for v in runs.values()
                                for r in v}) == 1,
          "runs": {k: [r["median_ms"] for r in v] for k, v in runs.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
