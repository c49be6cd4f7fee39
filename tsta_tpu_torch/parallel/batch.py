"""Batched PSA on one device.

Counterpart of ``tsta_tpu/parallel/batch.py``.  Pairs are bucketed by
padded shape; score-only buckets run through the DP kernel in one launch
each, traced batches through the DP kernel with code planes and the
device walk (the round-1 chain of ``ops/psa_pallas.py`` pair by pair for
M <= 0), and a traced pair over the device budget through the chunked
path (``ops/psa_chunked.py``).  Score-only batches refuse M <= 0, as the
JAX package's do.  ``mesh=`` shards a batch over the mesh's ``data``
axis: each row of devices takes its contiguous share of each bucket (or
of the traced batch) and runs it on its first device, through the route
the batch takes unsharded (``ops/psa_diff.py``); the results come back in
input order, equal to the unsharded run's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.io import encode_dna, read_first_record
from tsta_tpu_torch.device import resolve_device
from tsta_tpu_torch.models.psa import KERNELS
from tsta_tpu_torch.ops import psa_diff, psa_pallas, psa_scan
from tsta_tpu_torch.ops.psa_scan import bucket
from tsta_tpu_torch.parallel.mesh import on_device, shares


def stride_for_process(items: list) -> list:
    """Multi-host input scatter: this process's strided slice of an
    already-filtered input list, per TSTA_NUM_PROCESSES /
    TSTA_PROCESS_ID (the same partition as the JAX package's)."""
    n_proc = int(os.environ.get("TSTA_NUM_PROCESSES", "1"))
    proc_id = int(os.environ.get("TSTA_PROCESS_ID", "0"))
    if n_proc <= 1:
        return items
    return items[proc_id::n_proc]


def _prep(pairs, swap: bool):
    prepped = []
    for a, b in pairs:
        a = encode_dna(a)
        b = encode_dna(b)
        if swap and b.shape[0] > a.shape[0]:
            a, b = b, a
        prepped.append((a, b))
    return prepped


def align_batch(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                params: AlignParams = AlignParams(),
                traced: bool = False,
                mesh=None,
                swap: bool = True,
                kernel: str = "auto",
                device=None) -> List[psa_scan.PsaResult]:
    """Align a list of (a, b) byte-array pairs; PsaResult per pair in
    input order.

    ``kernel``: 'auto' or 'cuda' runs each score-only bucket through the
    DP kernel (its plain version on a CPU device); 'plain', and every
    traced batch, runs the ``psa_scan`` row scan over each bucket and
    returns the three traceback planes.  ``mesh`` shards each bucket over
    its ``data`` axis, each share on its row's first device (``device``
    then does not apply).
    """
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    if not (p[0] > 0 and p[1] < 0 and p[2] < 0 and p[3] <= 0):
        # padding to a bucket shape is score-neutral only for sane signs
        raise ValueError("batch alignment requires M>0>X, E<0, O<=0 "
                         "(got %s); align exotic parameter sets "
                         "pair-by-pair with psa_scan.psa_align" % (p,))
    if kernel not in KERNELS:
        raise ValueError("kernel must be one of %s (got %r)"
                         % (", ".join(KERNELS), kernel))
    devs = ([resolve_device(device)] if mesh is None
            else [resolve_device(d) for d in mesh.devices[:, 0]])
    if kernel == "cuda" and any(d.type != "cuda" for d in devs):
        raise ValueError("kernel='cuda' needs a CUDA device (got %s)"
                         % ", ".join(map(str, devs)))
    prepped = _prep(pairs, swap)
    buckets = {}
    for idx, (a, b) in enumerate(prepped):
        key = (bucket(a.shape[0]), bucket(b.shape[0]))
        buckets.setdefault(key, []).append(idx)

    results: List[Optional[psa_scan.PsaResult]] = [None] * len(prepped)
    for idxs in buckets.values():
        if kernel != "plain" and not traced:
            scores, corners = psa_diff.psa_align_batch_diff(
                [prepped[i] for i in idxs], p, mesh=mesh, device=devs[0])
            for pos, i in enumerate(idxs):
                results[i] = psa_scan.PsaResult(int(scores[pos]),
                                                int(corners[pos]))
            continue
        for lo, hi, dev in shares(mesh, len(idxs), devs[0]):
            if hi > lo:
                with on_device(dev):
                    _scan_share(prepped, idxs[lo:hi], p, traced, dev,
                                results)
    return results


def _scan_share(prepped, idxs, p, traced: bool, dev, results) -> None:
    """The ``psa_scan`` row scan of the pairs ``idxs`` of one bucket on
    ``dev``, into ``results``."""
    a, b, lens = psa_diff.pack_pairs([prepped[i] for i in idxs], dev)
    best, corner, codes = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], p,
                                             traced)
    best, corner = best.cpu().numpy(), corner.cpu().numpy()
    for pos, i in enumerate(idxs):
        planes = ()
        if traced:
            nr, mr = prepped[i][0].shape[0], prepped[i][1].shape[0]
            planes = psa_scan.planes_from_codes(codes[pos, :mr, :nr])
        results[i] = psa_scan.PsaResult(int(best[pos]), int(corner[pos]),
                                        *planes)


def align_batch_traced_device(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                              params: AlignParams = AlignParams(),
                              swap: bool = True,
                              mesh=None,
                              device=None):
    """Traced batch with the traceback walked on the device; returns
    (score, corner, Alignment) per pair in input order, with the
    reference's longer-sequence-horizontal swap when ``swap``.  Parameters
    of ``psa_diff.supports_params`` take the packed traced kernels, the
    rest of the round-1 domain (X < 0, E < 0, O <= 0, any M) the round-1
    chain pair by pair (``psa_pallas.psa_align_traced_device``); a pair
    over the device budget runs in row-chunks either way.  ``mesh``
    shards the pairs over its ``data`` axis, each share on its row's
    first device (``device`` then does not apply)."""
    p = psa_pallas._traced_params(params)
    prepped = _prep(pairs, swap)
    if psa_diff.supports_params(p):
        return psa_diff.psa_align_batch_traced_packed(prepped, p, mesh=mesh,
                                                      device=device)
    out = []
    for lo, hi, dev in shares(mesh, len(prepped), device):
        with on_device(dev):
            out += [psa_pallas.psa_align_traced_device(a, b, p, device=dev)
                    for a, b in prepped[lo:hi]]
    return out


def align_manifest(manifest_path: str, params: AlignParams = AlignParams(),
                   traced: bool = False, out_dir: Optional[str] = None,
                   mesh=None, resume: Optional[str] = None, device=None):
    """Align pairs listed in a TSV manifest (name, fasta1, fasta2).

    With ``resume``, results stream into a JSONL store and pairs already
    recorded there are skipped, so a preempted job restarts at pair
    granularity.  ``mesh`` shards the pairs over its ``data`` axis
    (:func:`align_batch`, :func:`align_batch_traced_device`).
    """
    store = None
    if resume:
        from tsta_tpu_torch.utils.checkpoint import ShardedResults
        store = ShardedResults(resume)

    names, pairs, skipped = [], [], []
    with open(manifest_path) as f:
        rows = [ln.strip() for ln in f]
    rows = [ln for ln in rows if ln and not ln.startswith("#")]
    for line in stride_for_process(rows):
        name, f1, f2 = line.split("\t")[:3]
        if store is not None and store.done(name):
            skipped.append(store.get(name))
            continue
        r1 = read_first_record(f1)
        r2 = read_first_record(f2)
        if r1 is None or r2 is None:
            raise ValueError("manifest pair %r: empty sequence input"
                             % name)
        names.append(name)
        pairs.append((r1.sequence, r2.sequence))
    alns = [None] * len(pairs)
    if traced:
        out = align_batch_traced_device(pairs, params, mesh=mesh,
                                        device=device)
        scores = [(s, c) for s, c, _ in out]
        alns = [aln for _, _, aln in out]
    else:
        scores = [(r.score, r.last)
                  for r in align_batch(pairs, params, mesh=mesh,
                                       device=device)]
    rows = list(skipped)
    for name, (a, b), (score, corner), aln in zip(names, pairs, scores,
                                                  alns):
        row = {"name": name, "score": int(score), "corner": int(corner),
               "cells": len(a) * len(b)}
        if traced and out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, name + ".txt"), "wb") as fo:
                fo.write(b">1\n" + aln.a_row + b"\n>2\n" + aln.b_row)
        if store is not None:
            store.record(row)
        rows.append(row)
    return rows

