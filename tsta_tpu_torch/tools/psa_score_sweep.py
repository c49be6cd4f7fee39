"""The score-only DP's blocks-an-SM sweep on one card: each shape at the D
of one, two, three and four blocks an SM (``psa_diff.score_plan`` with
``per_sm`` forced) or at the D of ``--d``, at each packet height of
``--t``, every output equal to K1's at its plan.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.psa_score_sweep [--kernel k1|diff]
        [--shapes "128 x 10k,32 x 10k"] [--d 1,2,3,4] [--t 32,64]

``--kernel diff`` sweeps the difference method (``csrc/psa_dp_diff.cu``,
``psa_diff.run_dp_int16``) in place of K1: its plan is
``psa_diff.diff_plan``, a forced D cuts the columns by
``psa_diff.diff_shards`` (a D those cannot make is skipped), and K1 is
timed at its plan beside it.  ``--shapes`` keeps the shapes whose label
holds one of its comma-separated parts.

The shapes are the smoke's (``chip_smoke.py``): the 100 kbp and 200 kbp
pairs and the three pairs of ``check_200k``'s pairwise DP (the seed-13 200
kbp set), 8 to 256 pairs of 10,240 bp (slot 0 the example), phase 3's 64
mixed pairs and phase 16's 4,096 short pairs.  Each D is timed with CUDA
events (median of 2 to 5 after a warm-up); a D past the card's resident
limit is skipped.  Prints the card's name and power limit, then one JSON
object per shape.  ``psa_diff.score_plan``'s two-blocks-an-SM rule reads
this sweep, and ``psa_diff.diff_plan``'s use of K1's shard count reads
its ``--kernel diff`` runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

from tsta_tpu_torch.ops import _kernels, psa_diff

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
P0 = (2, -5, -2, -4)


def cuda_ms(fn, reps: int):
    """Median milliseconds of ``fn`` over ``reps`` runs after a warm-up
    (CUDA events), and the last run's result."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times), out


def shapes(cs):
    """(label, pairs, reps) of each shape, made as ``cs`` (the smoke's
    module) makes them."""
    s1, s2 = cs.golden_example()
    ex = (np.frombuffer(s1, np.uint8), np.frombuffer(s2, np.uint8))
    reads = [np.frombuffer(r, np.uint8) for r in cs.long_reads(13, 200000)]
    rng = np.random.default_rng(1)
    b10 = [ex] + cs.random_pairs(rng, [(10240, 10240)] * 255,
                                 lambda k: k % 2 == 0)
    mixed = cs.random_pairs(rng, [(int(rng.integers(100, 3001)),
                                   int(rng.integers(100, 3001)))
                                  for _ in range(64)], lambda k: k % 2 == 0)
    return [("1 x 100k", [(reads[0][:100000], reads[1][:100000])], 3),
            ("1 x 200k", [(reads[1], reads[0])], 2),
            ("3 x 200k", [(reads[1], reads[0]), (reads[2], reads[0]),
                          (reads[2], reads[1])], 2),
            ("8 x 10k", b10[:8], 5), ("16 x 10k", b10[:16], 5),
            ("32 x 10k", b10[:32], 5), ("64 mixed", mixed, 5),
            ("64 x 10k", b10[:64], 5), ("128 x 10k", b10[:128], 5),
            ("200 x 10k", b10[:200], 3), ("256 x 10k", b10[:256], 3),
            ("4096 short", cs.short_pairs(np.random.default_rng(5), 4096),
             5)]


def runs(kernel, P, n_pad, sms, ds, ts, dev) -> list:
    """(D, T, launch kwargs and shape fields, resident limit) of each run:
    the D of one to four blocks an SM, or ``ds``, at each T of ``ts``."""
    plan = psa_diff.diff_plan if kernel == "diff" else psa_diff.score_plan
    ds = ds or dict.fromkeys(plan(P, n_pad, sms, per_sm=k)[0]
                             for k in (1, 2, 3, 4))
    out = []
    for D in ds:
        for T in ts:
            if kernel == "diff":
                try:
                    C, W, G = psa_diff.diff_shards(n_pad, D)
                except ValueError:
                    out.append((D, T, None, "no %d shards" % D))
                    continue
                limit = _kernels.psa_dp_diff_max_blocks(W, G, T, dev)
                shape = {"W": W, "G": G}
            else:
                C = -(-n_pad // D)
                limit = _kernels.psa_dp_max_blocks(C, T, dev)
                shape = {"W": -(-C // 256)}
            if D > 1 and P * D > limit:
                out.append((D, T, None, "resident limit %d" % limit))
            else:
                out.append((D, T, shape, None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k1", "diff"), default="k1")
    ap.add_argument("--shapes", default="",
                    help="comma-separated parts of the labels to keep")
    ap.add_argument("--d", default="", help="comma-separated forced D")
    ap.add_argument("--t", default="32", help="comma-separated T")
    args = ap.parse_args(argv)
    ds = [int(v) for v in args.d.split(",") if v]
    ts = [int(v) for v in args.t.split(",") if v]
    keep = [v.strip() for v in args.shapes.split(",") if v.strip()]
    if not torch.cuda.is_available():
        print("psa_score_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(cs.smi("name,power.limit"), flush=True)
    diff = args.kernel == "diff"
    run = psa_diff.run_dp_int16 if diff else psa_diff.run_dp
    for label, group, reps in shapes(cs):
        if keep and not any(k in label for k in keep):
            continue
        a, b, lens = psa_diff.pack_pairs(group, dev)
        P, n_pad = a.shape
        k1_ms, want = cuda_ms(lambda: psa_diff.run_dp(a, b, lens, P0), reps)
        rec = {"case": label, "kernel": args.kernel, "P": P, "n_pad": n_pad,
               "plan": (psa_diff.diff_plan if diff else psa_diff.score_plan)(
                   P, n_pad, sms), "k1_plan_ms": k1_ms, "runs": []}
        if diff:
            rec["plan_ms"] = cuda_ms(lambda: run(a, b, lens, P0), reps)[0]
        for D, T, shape, skipped in runs(args.kernel, P, n_pad, sms, ds, ts,
                                         dev):
            if skipped:
                rec["runs"].append({"D": D, "T": T, "skipped": skipped})
                continue
            ms, got = cuda_ms(lambda: run(a, b, lens, P0, D=D, T=T), reps)
            rec["runs"].append({
                "D": D, "T": T, **shape, "blocks": P * D, "ms": ms,
                "equal": all(torch.equal(g, w) for g, w in zip(got, want))})
        print(json.dumps(rec), flush=True)
        del a, b, lens
    return 0


if __name__ == "__main__":
    sys.exit(main())
