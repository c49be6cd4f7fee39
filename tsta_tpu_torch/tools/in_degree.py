"""How wide POA graphs grow: the largest in-degree of the native engine's
graph after each round, on seeded read sets of the kinds that make wide
nodes.

Run from the root of a checkout, on the card by default (the kernels;
``--device cpu`` takes the plain versions on the host)::

    python -m tsta_tpu_torch.tools.in_degree [--device cpu]

A round past 64 preds runs the wide forms (32-bit words, 13-bit pred
fields).  The sets, each made from ``--seed``:

* ``mixed``: a 200 bp template and 88 reads with ~15% substitutions,
  insertions and deletions, mixed;
* ``noisy``: a 60 bp template and 192 reads with ~30% of them;
* ``random``: 152 independent random reads of 60 bp;
* ``insertions``: a 60 bp template and 99 reads with 1-10 random bases
  inserted at one site;
* ``staircase``: a 200 bp template and 99 reads, read k with the k bases
  before position 150 deleted (an edited-amplicon pool's deletions of
  every length ending at one base).

Prints one JSON object per set: the largest in-degree after rounds 10,
25, 50, 100 and the last, the round it first passed 64, and the seconds.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
MARKS = (10, 25, 50, 100)


def mutate(rng, base, rate):
    """``base`` with each position substituted, deleted or followed by an
    inserted base with probability ``rate`` / 3 each."""
    out = []
    for b in base:
        r = rng.random()
        if r < rate / 3:
            out.append(ACGT[rng.integers(0, 4)])
        elif r < 2 * rate / 3:
            continue
        else:
            out.append(b)
            if r < rate:
                out.append(ACGT[rng.integers(0, 4)])
    return np.array(out or [base[0]], np.uint8).tobytes()


def read_sets(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t200, t60 = rng.choice(ACGT, 200), rng.choice(ACGT, 60)
    return {
        "mixed": [t200.tobytes()] + [mutate(rng, t200, 0.15)
                                     for _ in range(88)],
        "noisy": [t60.tobytes()] + [mutate(rng, t60, 0.30)
                                    for _ in range(192)],
        "random": [rng.choice(ACGT, 60).tobytes() for _ in range(153)],
        "insertions": [t60.tobytes()] + [
            np.concatenate([t60[:30], rng.choice(ACGT, rng.integers(1, 11)),
                            t60[30:]]).tobytes() for _ in range(99)],
        "staircase": [t200.tobytes()] + [
            np.concatenate([t200[:150 - k], t200[150:]]).tobytes()
            for k in range(1, 100)],
    }


def grow(seqs, device) -> dict:
    """Progressive rounds of ``seqs``: the largest in-degree after each."""
    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.device import device_budget, resolve_device
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    dev = resolve_device(device)
    params, budget = AlignParams(), device_budget(dev)
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    degrees = []
    t0 = time.perf_counter()
    for sno in range(1, len(seqs)):
        packed, order, _ = msa_poa.run_round(g, seqs[sno], params, dev,
                                             "auto", budget)
        msa_native._finish_round(g, seqs[sno], sno, order,
                                 packed.cpu().numpy(), [], [], [])
        degrees.append(g.max_in_degree())
    wide = [k + 1 for k, d in enumerate(degrees) if d > msa_poa.MAX_IN]
    return {"rounds": len(degrees),
            "max_in_degree": {str(m): degrees[m - 1] for m in MARKS
                              if m <= len(degrees)} | {
                                  "last": degrees[-1]},
            "first_wide_round": wide[0] if wide else None,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--sets", default="mixed,noisy,random,insertions,"
                                      "staircase")
    args = ap.parse_args(argv)
    from tsta_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    sets = read_sets(args.seed)
    for name in args.sets.split(","):
        print(json.dumps({"set": name, "device": str(dev),
                          **grow(sets[name], dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
