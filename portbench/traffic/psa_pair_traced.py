"""Traffic kind: one long pair a call, with its alignment written.

A call is ``tsta_tpu_torch.models.psa.align_pair(a, b, params,
traced=True)`` (the ``tsta-torch psa`` path).  The mix gives the reads'
``length``: the pair is reads 0 and 1 of ``long_reads(seed, length)``,
and the ``pairs`` distinct pairs cycled are made with seeds seed, seed +
1, ...  The check runs the plain reference over every distinct pair once
and holds every call to it: the score and the corner equal the
reference's, the rows are the reads with gaps put in, and the rows score
the corner.
"""

from __future__ import annotations

from portbench.traffic import seeded


def inputs(mix: dict, seed: int) -> list:
    return [tuple(seeded.long_reads(seed + k, mix["length"])[:2])
            for k in range(mix["pairs"])]


def call(pair, params, device, clock=None):
    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.models import psa
    return psa.align_pair(pair[0], pair[1], AlignParams(*params),
                          traced=True, device=device)


def units(pair, out) -> int:
    return len(pair[0]) * len(pair[1])


def work(pair, out) -> dict:
    rows = len(out.a_row) + len(out.b_row) if out.a_row else 0
    return {"psa_traced_cells": units(pair, out),
            "bytes": len(pair[0]) + len(pair[1]) + rows + 8}


def check(mix, inputs, calls, params, device, seed, score=None) -> list:
    """``calls``: (input index, output) of every call of the window.
    Returns ``[(name, value, limit)]``, each held as value <= limit."""
    from portbench.reference import gotoh
    score = score or gotoh.score_pairs
    best, corner = score(inputs, params, device)
    score_gap = corner_gap = rows_gap = rows_not_reads = 0
    for k, out in calls:
        a, b = inputs[k]
        score_gap = max(score_gap, abs(out.score - best[k]))
        corner_gap = max(corner_gap, abs(out.corner - corner[k]))
        rows = (out.a_row or b"", out.b_row or b"")
        if out.swapped:
            a, b = b, a
        if (gotoh.degap(rows[0]), gotoh.degap(rows[1])) != (a, b):
            rows_not_reads += 1
            continue
        try:
            rescored = gotoh.rescore(rows[0], rows[1], params)
        except ValueError:
            rows_not_reads += 1
            continue
        rows_gap = max(rows_gap, abs(rescored - corner[k]))
    return [("score_gap", score_gap, 0), ("corner_gap", corner_gap, 0),
            ("rows_score_gap", rows_gap, 0),
            ("rows_not_reads", rows_not_reads, 0)]
