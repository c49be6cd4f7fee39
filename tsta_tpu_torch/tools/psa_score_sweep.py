"""The score-only DP's blocks-an-SM sweep on one card: each shape at the D
of one, two, three and four blocks an SM (``psa_diff.score_plan`` with
``per_sm`` forced), every output equal to the first run's.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.psa_score_sweep

The shapes are the smoke's (``chip_smoke.py``): the 100 kbp and 200 kbp
pairs and the three pairs of ``check_200k``'s pairwise DP (the seed-13 200
kbp set), 8 to 256 pairs of 10,240 bp (slot 0 the example), phase 3's 64
mixed pairs and phase 16's 4,096 short pairs.  Each D is timed with CUDA
events (median of 2 to 5 after a warm-up); a D past the card's resident
limit is skipped.  Prints the card's name and power limit, then one JSON
object per shape.  ``psa_diff.score_plan``'s two-blocks-an-SM rule reads
this sweep.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("psa_score_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(cs.smi("name,power.limit"), flush=True)
    for label, group, reps in shapes(cs):
        a, b, lens = psa_diff.pack_pairs(group, dev)
        P, n_pad = a.shape
        rec = {"case": label, "P": P, "n_pad": n_pad,
               "plan": psa_diff.score_plan(P, n_pad, sms), "runs": []}
        want = None
        for D in dict.fromkeys(psa_diff.score_plan(P, n_pad, sms, per_sm=k)[0]
                               for k in (1, 2, 3, 4)):
            C = -(-n_pad // D)
            if D > 1 and P * D > _kernels.psa_dp_max_blocks(C, 32, dev):
                rec["runs"].append({"D": D, "skipped": "resident limit"})
                continue
            ms, got = cuda_ms(lambda: psa_diff.run_dp(a, b, lens, P0, D=D),
                              reps)
            want = got if want is None else want
            rec["runs"].append({
                "D": D, "W": -(-C // 256), "blocks": P * D, "ms": ms,
                "equal": all(torch.equal(g, w) for g, w in zip(got, want))})
        print(json.dumps(rec), flush=True)
        del a, b, lens
    return 0


if __name__ == "__main__":
    sys.exit(main())
