"""The POA round DP of ``csrc/poa_dp.cu`` in two checkouts on one card:
their times at the main paths' shapes, alternating, and whether their
outputs agree.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.poa_dp_ab --other DIR [--rounds 1]

``DIR`` is the root of another checkout of the repo, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Each run is a fresh process started in one checkout's root with that root
on ``PYTHONPATH``: it builds that checkout's kernels and times
``msa_poa.poa_dp`` with CUDA events (median of ``--reps`` after a
warm-up) in its three uses:

* the single call of the 3 x 50 kbp round 2 (``chip_smoke.long_reads``,
  seed 7; round 1 through that checkout's kernels), at the card's budget;
* the forward chunk of the last 3,392 rows of the 3 x 200 kbp round 1
  (seed 13, at the card's budget: 32,768-row chunks, 196,608 columns, 8
  windows), from a zeroed entry ring;
* the window remat of that chunk's last window (24,576 columns), from a
  zeroed ring and zeroed checkpoints;
* in a checkout with the wide form, its single call on the 3 x 50 kbp
  round 2 with a 65-pred staircase (``chip_smoke.WIDE_50K``), which only
  that checkout times.

The zeroed rings and checkpoints are the same inputs in both checkouts, so
their words, scores, checkpoints and rings (read column by column through
each checkout's own ``msa_poa.ring_positions``) must agree.  Each round
runs other, this, this, other.  First each checkout's ``poa_dp.cu`` is
compiled to a cubin: per kernel build its SASS instruction count and
whether the masked SASS of the two sides is equal
(``psa_dp_ab.compare_code``).  Prints one JSON object per run and, last,
the summary: per use each side's median of its runs' medians, this over
other, and whether every run's outputs agree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

from tsta_tpu_torch.tools.psa_dp_ab import compare_code

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the timed process, run in either checkout: only what both have
CHILD = r"""
import hashlib, json, statistics, sys
import torch
import chip_smoke
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.device import device_budget
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import _kernels, msa_chunked, msa_poa
reps = int(sys.argv[1])
dev = torch.device("cuda", 0)
P = AlignParams()


def timed(fn):
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return ms, out


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def cols(ring, n):
    return ring[:, :, msa_poa.ring_positions(n, dev)]


def plan(n):
    f = getattr(msa_poa, "poa_plan", None)
    return None if f is None else list(f(n))


res = {}
r = chip_smoke.next_round(chip_smoke.long_reads(), 1, P, dev)
args = (*r["tables"], r["n_real"], r["n_nodes"], P, r["W"])
ms, (w, s) = timed(lambda: msa_poa.poa_dp(*args))
res["single call, 50 kbp round 2"] = {
    "ms": ms, "shape": r["shape"], "plan": plan(args[4].shape[0]),
    "outputs_sha256": digest(w[:r["n_nodes"]], s)}
del r, args, w, s

seqs = chip_smoke.long_reads(13, 200000)
g = PoaGraph.from_sequence(seqs[0], 3)
prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, seqs[1], P,
                                                  device_budget(dev))
cr = msa_chunked.ChunkedRound(g, prep, a, n_real, NC, NWIN, P, dev)
c = cr.nchunks - 1


def forward():
    ring = msa_poa.new_ring(cr.W, n, dev)
    ck = torch.zeros((NC, NWIN, 3), dtype=torch.int32, device=dev)
    fa, kw = cr.forward_call(c, ring, ck)
    return msa_poa.poa_dp(*fa, **kw)[1], ck, ring


ms, (s, ck, ring) = timed(forward)
res["forward chunk, 200 kbp round 1"] = {
    "ms": ms, "shape": "%d of %d rows x %d columns, NWIN %d, W %d"
    % (cr.rows(c), NC, n, NWIN, cr.W), "plan": plan(n),
    "outputs_sha256": digest(s, ck, cols(ring, n))}
ck_all = torch.zeros((cr.nchunks * NC, NWIN, 3), dtype=torch.int32,
                     device=dev)
hb = ck_all[:, :, 0].contiguous()
snap = msa_poa.new_ring(cr.W, n, dev)


def remat():
    fa, kw = cr.remat_call(c, NWIN - 1, snap, ck_all, hb)
    return msa_poa.poa_dp(*fa, **kw)[0], kw["ring"]


ms, (w, ring) = timed(remat)
res["window remat, 200 kbp round 1"] = {
    "ms": ms, "shape": "%d of %d rows x %d columns" % (cr.rows(c), NC, cr.CW),
    "plan": plan(cr.CW),
    "outputs_sha256": digest(w[:cr.rows(c)], cols(ring, cr.CW))}
del w, ring, ck_all, hb, snap
import inspect
if "stair" in inspect.signature(chip_smoke.next_round).parameters:
    r = chip_smoke.next_round(chip_smoke.long_reads(), 1, P, dev,
                              stair=chip_smoke.WIDE_50K)
    args = (*r["tables"], r["n_real"], r["n_nodes"], P, r["W"])
    ms, (w, s) = timed(lambda: msa_poa.poa_dp(*args, lists=r["lists"]))
    res["wide single call, 50 kbp round 2"] = {
        "ms": ms, "shape": r["shape"], "plan": plan(args[4].shape[0]),
        "outputs_sha256": digest(w[:r["n_nodes"]], s)}
    del r, args, w, s
for v in res.values():
    v["median_ms"] = statistics.median(v["ms"])
ptx = _kernels.build_info.get("ptxas", "").splitlines()
regs = [ptx[k + 1].strip() for k, line in enumerate(ptx[:-1])
        if "poa_dp_kernel" in line and "Compiling entry" in line]
print(json.dumps({"uses": res, "ptxas": regs,
                  "launches": {k: v for k, v in _kernels.launches.items()
                               if v},
                  "build_s": _kernels.build_info.get("seconds")}))
"""


def timed_run(root: str, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", CHILD, str(reps)], cwd=root,
                       env=env, capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError("timed run in %s failed:\n%s" % (root, r.stderr))
    return json.loads(r.stdout.strip().splitlines()[-1])


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    with tempfile.TemporaryDirectory() as work:
        emit({"code poa_dp.cu": compare_code(trees, work, "poa_dp.cu")})
    runs = {"other": [], "this": []}
    for rnd in range(args.rounds):
        for k in ("other", "this", "this", "other"):
            res = timed_run(trees[k], args.reps)
            runs[k].append(res)
            emit({"round": rnd, "tree": k, **res})
    summary = {}
    for use in runs["this"][0]["uses"]:
        # a use only this checkout has (the wide form) has no ratio
        have = {k: [r["uses"][use] for r in v if use in r["uses"]]
                for k, v in runs.items()}
        have = {k: v for k, v in have.items() if v}
        med = {k: statistics.median(u["median_ms"] for u in v)
               for k, v in have.items()}
        summary[use] = {
            "median_ms": med,
            "this_over_other": (med["this"] / med["other"] if "other" in med
                                else None),
            "outputs_equal": len({u["outputs_sha256"]
                                  for v in have.values() for u in v}) == 1,
            "plan": runs["this"][0]["uses"][use]["plan"]}
    emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
