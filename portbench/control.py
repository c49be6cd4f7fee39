"""The control of each cell's check: the plain reference put in the
program's place, computed in a narrower integer type, judged by the same
check.  A check that passes its control cannot tell a lower precision
from the program, so every cell's control has to come out not correct.

The configurations state exact int32 scores.  The control takes the
narrowest type below that in which the cell's scores no longer fit:
int16 where they pass 32,767 (the 200 kbp pair, the 50 kbp MSA rounds),
int8 for the 10 kbp batch, whose scores int16 still holds exactly.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the check's numbers for the control, each
with its limit, and whether the control came out correct.  It calls
every distinct input of the cell once (no window) and needs the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from portbench import harness
from portbench.reference import gotoh, poa

DTYPE = {"psa_batch_score": torch.int8, "psa_pair_traced": torch.int16,
         "msa_reads": torch.int16}


def outputs(kind_name: str, mix: dict, inputs: list, params, device,
            dtype) -> list:
    """The control's (input index, output) of one call of each input (of
    each sampled set for the MSA, whose check reads no other)."""
    if kind_name == "psa_batch_score":
        flat = [p for batch in inputs for p in batch]
        best, corner = gotoh.score_pairs(flat, params, device, dtype)
        res = [SimpleNamespace(score=s, last=c) for s, c in zip(best, corner)]
        out, k = [], 0
        for b, batch in enumerate(inputs):
            out.append((b, res[k:k + len(batch)]))
            k += len(batch)
        return out
    if kind_name == "psa_pair_traced":
        best, corner = gotoh.score_pairs(inputs, params, device, dtype)
        return [(k, SimpleNamespace(score=s, corner=c, swapped=False,
                                    a_row=b"", b_row=b""))
                for k, (s, c) in enumerate(zip(best, corner))]
    if kind_name == "msa_reads":
        return [(k, SimpleNamespace(**poa.align_seqs(inputs[k], params,
                                                     device, dtype)))
                for k in range(min(mix["sample_sets"], len(inputs)))]
    raise KeyError(kind_name)


def control(workload: str, seed: int, device, mix: dict | None = None):
    """The check's numbers for the control on ``seed``: ``[(name, value,
    limit)]``."""
    cell = harness.cell(workload)
    if mix is not None:
        cell["mix"] = {**cell["mix"], **mix}
    kind_name = cell["mix"]["kind"]
    params = harness.scoring(cell["config"])
    inputs = cell["kind"].inputs(cell["mix"], seed)
    outs = outputs(kind_name, cell["mix"], inputs, params, device,
                   DTYPE[kind_name])
    return cell["kind"].check(cell["mix"], inputs, outs, params, device,
                              seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control(args.workload, seed, torch.device(args.device))
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "dtype": str(DTYPE[harness.cell(args.workload)["mix"]["kind"]]),
            "correct": all(v <= lim for _, v, lim in checks),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
