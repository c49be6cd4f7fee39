"""The POA traceback walks in two checkouts on one card: Q2-5 and Q2-6's
walk times, alternating, every output compared.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.poa_walk_ab --other DIR [--rounds 2] \
        [--sweep 32:128:128,32:0:128,64:256:256]

``DIR`` is the root of another checkout of the repo, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.

Each run is a fresh process started in one checkout's root with that root
on ``PYTHONPATH`` (``psa_dp_ab``'s harness: other, this, this, other each
round): it builds that checkout's kernels, prints ptxas's lines for the
walk kernels, makes each plane with that checkout's own DP (outside the
timing) and times the walk with CUDA events, the median of ``--reps``:

* Q2-5 (``msa_poa.poa_walk``) on each of the 4 rounds of the MSA example
  (``chip_smoke.example_msa_reads``) and on round 2 of 3 x 50 kbp
  (``chip_smoke.long_reads``, seed 7), each round's graph from that
  checkout's kernels;
* Q2-6's walk (``msa_poa.poa_walk_bounded``) in the first cell of the 3 x
  200 kbp round 1 (seed 13, at the card's budget), from the best sink:
  the cell ``chip_smoke.hold_round`` times;
* in a checkout with the wide form, Q2-5 on the 3 x 50 kbp round 2 with a
  65-pred staircase (``chip_smoke.WIDE_50K``), which only that checkout
  times.

First each checkout's ``poa_walk.cu`` and ``poa_walk_bounded.cu`` are
compiled to cubins: per kernel build its SASS instruction count and
whether the masked SASS of the two sides is equal
(``psa_dp_ab.compare_code``).

Each shape is timed twice: ``cold``, with the 50 MB L2 flushed (a 256 MB
write) before each launch, as the main path finds a plane right after its
DP wrote it; and ``warm``, launch after launch.  A checkout whose walks
return counters (moves, pred moves, misses, phases) records them and its
plan (S, R, threads).  With ``--sweep``, this checkout's first run of
each round also times each shape cold at each forced ``S:R:threads`` (R
= 0: every move reads device memory, the cost of a step without its
staged window), every output compared with its plan's.  Prints one JSON
object per line; the last is the summary: for each shape each side's
median of its runs' medians, this over other, and whether every run's
outputs agree (align map and exit state, through a checksum), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import tempfile

from tsta_tpu_torch.tools.psa_dp_ab import (CHILD_HELPERS, ROOT, alternate,
                                            child_run, compare_code, emit,
                                            summarize)

# the timed process, run in either checkout: only what both have
CHILD = CHILD_HELPERS + r"""
import inspect
import chip_smoke
from tsta_tpu_torch.device import device_budget
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import msa_chunked, msa_poa
reps = int(sys.argv[1])
sweep = [tuple(int(v) for v in x.split(":")) for x in sys.argv[2].split(",")
         if x]
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
staged = "counts" in inspect.signature(msa_poa.poa_walk).parameters


def digest(outs):
    return hashlib.sha256(json.dumps([checksum(o) for o in outs])
                          .encode()).hexdigest()


def record(label, fn, outputs, counter, maxdist, max_in):
    kw = {"maxdist": maxdist} if staged else {}
    for cold in (True, False):
        n0 = _kernels.launches[counter]
        ms, out = timed(lambda: fn(**kw), reps, flush=flush if cold else None)
        res[label + (" cold" if cold else " warm")] = {
            "ms": ms, "median_ms": statistics.median(ms),
            "launches": _kernels.launches[counter] - n0,
            "outputs": digest(outputs(out))}
    if not staged:
        return
    counts = torch.zeros((4,), dtype=torch.int32, device=dev)
    fn(counts=counts, **kw)
    res[label + " cold"]["steps"] = counts.tolist()
    plans[label] = list(msa_poa.poa_walk_plan(maxdist, max_in))
    for S, R, threads in sweep:   # this checkout's forced plans, cold
        ms, out = timed(lambda: fn(S=S, R=R, threads=threads, counts=counts),
                        reps, flush=flush)
        swept.setdefault(label, {})["%d:%d:%d" % (S, R, threads)] = {
            "median_ms": statistics.median(ms), "counts": counts.tolist(),
            "equal": digest(outputs(out)) == res[label + " cold"]["outputs"]}


def single(label, seqs, rounds, **kw):
    r = chip_smoke.next_round(seqs, rounds, P, dev, **kw)
    args = (*r["tables"], r["n_real"], r["n_nodes"], P, r["W"])
    wide = {"lists": r["lists"]} if r.get("lists") is not None else {}
    words, scores = msa_poa.poa_dp(*args, **wide)
    best = msa_poa.best_sink(scores, r["mask"])
    preds = r["preds"]
    shapes[label] = r["shape"]
    record(label, lambda **k: msa_poa.poa_walk(words, preds, best,
                                               r["n_real"], **k),
           lambda o: [o], "poa_walk_wide" if preds.shape[1] > 64
           else "poa_walk",
           msa_poa.max_pred_distance(preds.cpu().numpy())
           if staged else None, preds.shape[1])
    del words, scores, r, args
    torch.cuda.empty_cache()


res, swept, plans, shapes = {}, {}, {}, {}
ex = chip_smoke.example_msa_reads()
for k in range(4):
    single("Q2-5 example round %d" % (k + 1), ex, k)
single("Q2-5 50 kbp round 2", chip_smoke.long_reads(), 1)
if "stair" in inspect.signature(chip_smoke.next_round).parameters:
    single("Q2-5 wide 50 kbp round 2", chip_smoke.long_reads(), 1,
           stair=chip_smoke.WIDE_50K)

seqs = chip_smoke.long_reads(13, 200000)
g = PoaGraph.from_sequence(seqs[0], 3)
prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, seqs[1], P,
                                                  device_budget(dev))
cr = msa_chunked.ChunkedRound(g, prep, a, n_real, NC, NWIN, P, dev)
snaps, scores, ckpt = cr.forward(msa_poa.poa_dp)
row, j = int(msa_poa.best_sink(scores, cr.mask)), n_real - 1
c, w = cr.cell(row, j)
fa, kw = cr.remat_call(c, w, snaps[c], ckpt, ckpt[:, :, 0].contiguous())
words = msa_poa.poa_dp(*fa, **kw)[0]
del snaps, fa, kw
preds = cr.chunk_preds(c)
align = torch.full((n,), -1, dtype=torch.int32, device=dev)


def bounded(**k):
    align.fill_(-1)
    return msa_poa.poa_walk_bounded(words, preds, row, j, 0, c * NC, w * cr.CW,
                                    align, **k), align


label = "Q2-6 walk, 200 kbp round 1 cell"
shapes[label] = "cell (%d, %d): %d of %d rows x %d columns" % (
    c, w, cr.rows(c), NC, cr.CW)
record(label, bounded, lambda o: list(o), "poa_walk_bounded",
       getattr(cr, "maxdist", None), preds.shape[1])
lines = _kernels.build_info["ptxas"].splitlines()
ptxas = [" ".join(x.strip() for x in lines[k:k + 4])
         for k, ln in enumerate(lines)
         if "Compiling" in ln and "poa_walk" in ln]
print(json.dumps({"shapes": res, "rounds": shapes, "plans": plans,
                  "sweep": swept, "build_s": _kernels.build_info.get("seconds"),
                  "ptxas": ptxas}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", default="",
                    help="plans S:R:threads to time in this checkout, e.g. "
                         "32:128:128,32:0:128 (its first run of each round, "
                         "cold)")
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    with tempfile.TemporaryDirectory() as work:
        emit({"code " + src: compare_code(trees, work, src)
              for src in ("poa_walk.cu", "poa_walk_bounded.cu")})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    runs = alternate(trees, lambda root, first: child_run(
        root, CHILD, [args.reps, args.sweep if first else ""]), args.rounds)
    emit({"smi": smi, "summary": summarize(runs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
