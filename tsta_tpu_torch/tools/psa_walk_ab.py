"""The PSA traceback walks in two checkouts on one card: their compiled code
side by side, then K3, Q2-12 and Q2-8's times, alternating, every output
compared.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.psa_walk_ab --other DIR [--rounds 2] \
        [--sweep 64:256,32:128,16:64]

``DIR`` is the root of another checkout of the repo, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.

First each checkout's ``psa_walk.cu``, ``psa_walk_bounded.cu`` and
``psa_walk_pair2.cu`` are compiled to cubins and their kernels' SASS
compared, the parameters' constant-bank offsets masked
(``psa_dp_ab.compare_code``).  Then each run is a fresh process started in
one checkout's root with that root on ``PYTHONPATH`` (``psa_dp_ab``'s
harness: other, this, this, other each round): it builds that checkout's
kernels, prints ptxas's lines for the walk kernels, makes each plane with
that checkout's DP (outside the timing) and times the walk with CUDA
events, the median of ``--reps``:

* K3 (``traceback.walk_packed``) on the traced plane of the 10 kbp
  example (``tests/golden/example_big``; the example's walk, Q2-16's
  shape), of 32 x 10 kbp (slot 0 the example, the rest from ``--seed``),
  of reads 0 and 1 of the seed-13 200 kbp set cut to 100,000 bp, and of
  a traced batch of 4,096 pairs of 150-2,000 bp (``chip_smoke.py`` phase
  16 (c)'s generator), one launch for each group the route cuts
  (``psa_diff._traced_groups``), their sum;
* Q2-12 (``traceback.walk_packed(pair2=True)``, the two-pair walk) on the
  32 x 10 kbp plane and on the traced batch's groups, an odd group taking
  K3 (its sum); then K3 and Q2-12 on the batch's groups of an even number
  of pairs alone, the launches that run the two-pair walk (their sums);
* Q2-8 (``traceback.walk_bounded``) on chunk 0 of reads 0 and 1 of that
  set at 65,536 rows a chunk (65,536 x 200,064), from the state the
  chunked route's own walk entered it with.

Each shape is timed twice: ``cold``, with the 50 MB L2 flushed (a 256 MB
write) before each launch, as the main path finds a plane right after its
DP wrote it; and ``warm``, launch after launch.  With ``--sweep``, this
checkout's first run of each round also times each shape cold at each
forced ``S:threads`` (K3 and Q2-12; Q2-8 takes each S at its 256
threads), every output compared with its plan's.  Prints one JSON object per line; the
last is the summary: for each shape each side's median of its runs'
medians, this over other, and whether every run's outputs agree (words
and counts, or moves and exit state, through a checksum), with the card's
name and power limit.
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

WALK_SOURCES = ("psa_walk.cu", "psa_walk_bounded.cu", "psa_walk_pair2.cu")

# the timed process, run in either checkout: only what both have
CHILD = CHILD_HELPERS + r"""
from tsta_tpu_torch.device import device_budget
from tsta_tpu_torch.ops import psa_chunked
from tsta_tpu_torch.ops import traceback as tb
seed, reps = int(sys.argv[1]), int(sys.argv[2])
sweep = [tuple(int(v) for v in x.split(":")) for x in sys.argv[3].split(",")
         if x]
rng = np.random.default_rng(seed)
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)


def short_pairs(rng, count):
    pairs = []
    for _ in range(count):
        n = int(rng.integers(150, 2001))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        b[rng.integers(0, n, n // 20)] = rng.integers(0, 4, n // 20)
        b = np.delete(b, rng.integers(0, n, n // 40))
        b = np.insert(b, rng.integers(0, len(b), n // 40),
                      rng.integers(0, 4, n // 40).astype(np.uint8))
        pairs.append((acgt[a], acgt[b]))
    return [(a, b) if len(a) >= len(b) else (b, a) for a, b in pairs]


def digest(outs):
    return hashlib.sha256(json.dumps([checksum(o) for o in outs])
                          .encode()).hexdigest()


def record(label, fn, outputs, counter, steps, bounded=False):
    for cold in (True, False):
        n0 = _kernels.launches[counter]
        ms, out = timed(fn, reps, flush=flush if cold else None)
        res[label + (" cold" if cold else " warm")] = {
            "ms": ms, "median_ms": statistics.median(ms), "steps": steps,
            "launches": _kernels.launches[counter] - n0,
            "outputs": digest(outputs(out))}
    shapes = sorted({(s, 256) for s, _ in sweep}) if bounded else sweep
    for S, threads in shapes:   # this checkout's block shapes, cold
        kw = {"S": S} if bounded else {"S": S, "threads": threads}
        ms, out = timed(lambda: fn(**kw), reps, flush=flush)
        swept.setdefault(label, {})["%d:%d" % (S, threads)] = {
            "median_ms": statistics.median(ms),
            "equal": digest(outputs(out)) == res[label + " cold"]["outputs"]}


def walk_groups(planes, **kw):
    return [x for plane, nm in planes for x in tb.walk_packed(plane, nm,
                                                              **kw)]


res, swept, plans = {}, {}, {}
layout = getattr(_kernels, "psa_walk_layout", None)
sms = torch.cuda.get_device_properties(dev).multi_processor_count
ex = example()
reads = long_reads()
mid = [tuple(np.frombuffer(r[:100000], np.uint8) for r in reads[:2])]
for label, group in (("K3 example", [ex]),
                     ("K3 32 x 10 kbp",
                      [ex] + [mutated(10000, 1250, 200) for _ in range(31)]),
                     ("K3 100 kbp pair", mid)):
    a, b, nm = psa_diff.pack_pairs(group, dev, traced=True)
    plane = psa_diff.dp_packed(a, b, nm, p, True)[2]
    del a, b
    steps = int(tb.walk_packed(plane, nm)[1].sum())
    plans[label] = layout(len(group), sms) if layout else None
    record(label, lambda **s: tb.walk_packed(plane, nm, **s), lambda o: o,
           "psa_walk", steps)
    if len(group) == 32:
        label = "Q2-12 32 x 10 kbp"
        plans[label] = plans["K3 32 x 10 kbp"]   # K3's plan
        record(label, lambda **s: tb.walk_packed(plane, nm, pair2=True, **s),
               lambda o: o, "psa_walk_pair2", steps)
    del plane
    torch.cuda.empty_cache()
batch = short_pairs(np.random.default_rng(20261016 + 16), 4096)
groups, _ = psa_diff._traced_groups(*psa_diff._lengths(batch),
                                    device_budget(dev))
planes = []
for g in groups:
    a, b, nm = psa_diff.pack_pairs([batch[i] for i in g], dev, traced=True)
    planes.append((psa_diff.dp_packed(a, b, nm, p, True)[2], nm))
    del a, b
label = "K3 traced batch 4096 x 150-2000 bp"
plans[label] = [[len(g), *(layout(len(g), sms) if layout else [])]
                for g in groups]
batch_steps = sum(int(c.sum()) for c in walk_groups(planes)[1::2])
record(label, lambda **s: walk_groups(planes, **s), lambda o: o, "psa_walk",
       batch_steps)
record("Q2-12 traced batch 4096 x 150-2000 bp",
       lambda **s: walk_groups(planes, pair2=True, **s), lambda o: o,
       "psa_walk_pair2", batch_steps)
even = [(plane, nm) for plane, nm in planes if len(nm) % 2 == 0]
even_steps = sum(int(c.sum()) for c in walk_groups(even)[1::2])
record("K3 traced batch, even groups", lambda **s: walk_groups(even, **s),
       lambda o: o, "psa_walk", even_steps)
record("Q2-12 traced batch, even groups",
       lambda **s: walk_groups(even, pair2=True, **s), lambda o: o,
       "psa_walk_pair2", even_steps)
del even
del planes
torch.cuda.empty_cache()
ea, eb = (np.frombuffer(r, np.uint8) for r in reads[:2])
psa_chunked.psa_align_traced_chunked(ea, eb, p, device=dev)
clock = psa_chunked.last_clock
state = tuple(clock.walk_from[-1])
pair = psa_chunked.ChunkedPair(ea, eb, p, clock.mc, dev)
plane = psa_chunked.chunk_dp(*pair.chunk_call(0, *pair.entry()))[2]
moves = torch.zeros(pair.m_pad + pair.n_pad, dtype=torch.int8, device=dev)
wargs = pair.walk_call(0, plane, [], *state, moves)
record("Q2-8 chunk 0 of the 200 kbp pair",
       lambda **s: tb.walk_bounded(*wargs, **s),
       lambda o: (o, moves), "psa_walk_bounded", clock.walk_steps[-1],
       bounded=True)
lines = _kernels.build_info["ptxas"].splitlines()
ptxas = [" ".join(x.strip() for x in lines[k:k + 4])
         for k, ln in enumerate(lines) if "Compiling" in ln and "walk" in ln]
print(json.dumps({"shapes": res, "walk_s": getattr(_kernels, "WALK_S", None),
                  "k3_plans": plans, "sweep": swept,
                  "chunk": [clock.mc, pair.n_pad], "walk_from": state,
                  "build_s": _kernels.build_info.get("seconds"),
                  "ptxas": ptxas}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", default="",
                    help="K3 and Q2-12 block shapes S:threads to time in "
                         "this checkout, e.g. 64:256,32:128,16:64 (its first "
                         "run of each round, cold)")
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    with tempfile.TemporaryDirectory() as work:
        emit({"code " + src: compare_code(trees, work, src)
              for src in WALK_SOURCES})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    runs = alternate(trees, lambda root, first: child_run(
        root, CHILD, [args.seed, args.reps, args.sweep if first else ""]),
        args.rounds)
    emit({"smi": smi, "summary": summarize(runs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
