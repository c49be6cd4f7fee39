"""Traffic kind: batches of pairs scored without traceback.

A call is ``tsta_tpu_torch.parallel.batch.align_batch(pairs, params,
traced=False)`` on one batch (the ``tsta-torch batch`` path).  The mix
gives ``pairs`` a batch of ``length`` bp each (``random_pairs``, similar
copies) and ``batches`` distinct batches; with ``example_slot0`` slot 0 of
every batch is the reference's 10 kbp example pair.  The check scores a
sample of ``sample_pairs`` (batch, slot) pairs drawn from the seed, slot 0
of batch 0 always among them, with the plain reference, and compares them
in every call that aligned them.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import seeded


def inputs(mix: dict, seed: int) -> list:
    rng = np.random.default_rng(seed)
    n = mix["length"]
    out = []
    for _ in range(mix["batches"]):
        k = mix["pairs"] - (1 if mix["example_slot0"] else 0)
        pairs = [(a.tobytes(), b.tobytes()) for a, b in seeded.random_pairs(
            rng, [(n, n)] * k, lambda _: True)]
        if mix["example_slot0"]:
            pairs.insert(0, seeded.example_pair())
        out.append(pairs)
    return out


def call(pairs, params, device, clock=None):
    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.parallel import batch
    return batch.align_batch(pairs, AlignParams(*params), traced=False,
                             device=device)


def units(pairs, out) -> int:
    """DP cells of the batch: m x n of each pair, unpadded."""
    return sum(len(a) * len(b) for a, b in pairs)


def work(pairs, out) -> dict:
    return {"psa_cells": units(pairs, out),
            "bytes": sum(len(a) + len(b) for a, b in pairs) + 8 * len(pairs)}


def results(out) -> list:
    """(score, corner) of each pair of a call's output."""
    return [(r.score, r.last) for r in out]


def check(mix, inputs, calls, params, device, seed, score=None) -> list:
    """``calls``: (input index, output) of every call of the window.
    Returns ``[(name, value, limit)]``, each held as value <= limit.
    ``score`` (the plain reference's ``score_pairs`` by default) scores
    the sample; the control passes its own."""
    from portbench.reference import gotoh
    score = score or gotoh.score_pairs
    rng = np.random.default_rng([seed, 1])
    every = [(b, s) for b in range(len(inputs)) for s in range(len(inputs[b]))]
    k = min(mix["sample_pairs"], len(every))
    pick = {(b, 0) for b in range(len(inputs))}
    pick |= {every[int(x)] for x in rng.choice(len(every), k, replace=False)}
    pick = sorted(pick)
    best, corner = score([inputs[b][s] for b, s in pick], params, device)
    want = {bs: (x, y) for bs, x, y in zip(pick, best, corner)}
    wrong = 0
    for b, out in calls:
        got = results(out)
        for bb, s in pick:
            if bb == b:
                wrong += len(got) != len(inputs[b]) or got[s] != want[(bb, s)]
    return [("pairs_wrong", wrong, 0)]
