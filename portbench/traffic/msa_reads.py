"""Traffic kind: one progressive MSA of a few long reads a call.

A call is ``tsta_tpu_torch.ops.msa_native.align_seqs(seqs, params)`` (the
``tsta-torch msa --engine native`` path).  The mix gives ``length``: a
read set is ``long_reads(seed + k, length)``, a base read and two mutated
copies, and ``sets`` distinct sets are cycled.  The check runs the plain
reference over ``sample_sets`` sets drawn from the seed and compares
every call of them: rows, consensus and round scores; every call of any
set has rows that are its reads with gaps put in.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import seeded


def inputs(mix: dict, seed: int) -> list:
    return [seeded.long_reads(seed + k, mix["length"])
            for k in range(mix["sets"])]


def call(seqs, params, device, clock=None):
    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.ops import msa_native
    return msa_native.align_seqs(seqs, AlignParams(*params), device=device,
                                 clock=clock)


def clock(device):
    """The program's per-round wall split, passed to traced calls."""
    from tsta_tpu_torch.ops import msa_poa
    return msa_poa.RoundClock(device)


def _graph_lens(seqs, out) -> list:
    """Nodes of the graph entering each round."""
    return [len(seqs[0])] + list(out.graph_len[:-1])


def units(seqs, out) -> int:
    """DP cells: the graph entering each round x that round's read."""
    return sum(g * len(s) for g, s in zip(_graph_lens(seqs, out), seqs[1:]))


def work(seqs, out) -> dict:
    """Cells, and pred edges x columns counted as one edge a node (a
    lower bound: every node but a source has a pred)."""
    cells = units(seqs, out)
    edges = sum((g - 1) * len(s)
                for g, s in zip(_graph_lens(seqs, out), seqs[1:]))
    rows = sum(len(r) for r in out.rows) + len(out.consensus)
    return {"poa_cells": cells, "poa_edge_cells": edges,
            "bytes": sum(len(s) for s in seqs) + rows}


def degapped(out, seqs) -> bool:
    return [r.replace(b"-", b"") for r in out.rows] == [bytes(s)
                                                        for s in seqs]


def check(mix, inputs, calls, params, device, seed, align=None) -> list:
    """``calls``: (input index, output) of every call of the window.
    Returns ``[(name, value, limit)]``, each held as value <= limit.
    ``align`` (the plain reference's ``align_seqs`` by default) aligns
    the sampled sets; the control passes its own."""
    from portbench.reference import poa
    align = align or poa.align_seqs
    rng = np.random.default_rng([seed, 2])
    done = sorted({k for k, _ in calls})
    pick = sorted(int(x) for x in rng.choice(
        done, min(mix["sample_sets"], len(done)), replace=False))
    want = {k: align(inputs[k], params, device) for k in pick}
    rows_wrong = consensus_wrong = score_gap = not_reads = 0
    for k, out in calls:
        not_reads += not degapped(out, inputs[k])
        if k in want:
            w = want[k]
            rows_wrong += sum(a != b for a, b in zip(out.rows, w["rows"])) \
                + abs(len(out.rows) - len(w["rows"]))
            consensus_wrong += out.consensus != w["consensus"]
            score_gap = max([score_gap] + [
                abs(a - b) for a, b in zip(out.round_scores,
                                           w["round_scores"])])
            if len(out.round_scores) != len(w["round_scores"]):
                score_gap = max(score_gap, 1 << 30)
    return [("round_score_gap", score_gap, 0), ("rows_wrong", rows_wrong, 0),
            ("consensus_wrong", consensus_wrong, 0),
            ("rows_not_reads", not_reads, 0)]
