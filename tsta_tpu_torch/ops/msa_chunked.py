"""Chunked POA rounds: the rounds whose (N, n) words plane the memory plan
will not hold.

Counterpart of ``tsta_tpu/ops/msa_pallas.py`` ``_round_chunked``
(:1301-1574), with ``_win_fills`` (:986) and ``_ring_window`` (:1005).
A round the plan cuts into node chunks of ``NC`` rows runs in two
passes:

1. **Forward.**  For each chunk in topo order: snapshot the ring (a
   clone), then run the DP over the chunk's rows (``poa_dp.cu``'s forward
   chunk): the ring carries the last W rows' H and E into the next chunk,
   each node's sink score is kept, and, with ``NWIN`` column windows,
   each node's H, running max q and F at the last column of every window
   (the checkpoints, an (N, NWIN, 3) int32 tensor).  No words are
   written.
2. **Backward.**  The best sink (:func:`msa_poa.best_sink`) starts the
   walk.  While the walk is inside the round, the cell it is in, chunk
   ``row // NC`` and window ``min(j // CW, NWIN - 1)``, is
   rematerialised: the DP again over the chunk's rows and the window's
   CW columns (``poa_dp.cu``'s window remat), from the chunk's entry
   ring cut to the window (:func:`ring_window`) and the window's left
   boundary from the checkpoints (:func:`win_fills`).  The walk
   (``poa_walk_bounded.cu``, on the window ring of
   :func:`msa_poa.poa_walk_plan`) runs in that cell's words until it leaves
   the cell and writes the round's align entries on the device; the host
   reads back (row, j, state), 12 bytes, and picks the next cell.

With ``NWIN`` = 0 (n not a multiple of 1,024) the same loop runs one
window of n columns, with the round's own fills.  A chunked round gives
the same sink scores, best row and align map, and therefore the same
graph, rows and consensus, as the single-call round, bit for bit: the
remat repeats the forward's arithmetic on the same inputs, and the walk
the single-call walk's steps.

The TPU driver's CAP-bounded walk log, K-fused cell chains and
speculative remats hide the TPU host link's round trips; here each cell
costs one remat, one walk launch and one 12-byte read.  The working set
is one cell's (NC, CW) int16 words at a time, the ring snapshots and the
checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch

from tsta_tpu_torch.ops import msa_poa
from tsta_tpu_torch.ops.psa_scan import NEG, as_params


def win_fills(ck_c, hb, predsT_c, pmaskT_c, b: int, col0: int, e_: int,
              o_: int) -> torch.Tensor:
    """(4, NC) int32 fills of a window remat from column ``col0`` (the
    checkpoint boundary ``b`` = window - 1 is column col0 - 1): [0] the
    max over each node's preds of the checkpointed H(p, col0-1), a
    virtual pred giving H(-1, col0-1) = o + col0*e, [1] its first-max
    pred index, [2] the F running-max seed q and [3] F(v, col0-1) from
    the node's own checkpoint.  ``ck_c``: the chunk's (NC, NWIN, 3)
    checkpoints; ``hb``: (N, NWIN) checkpointed H of every row of the
    round; ``predsT_c``/``pmaskT_c``: the chunk's (max_in, NC) pred
    table (global buffer row ids)."""
    hbp = hb[(predsT_c.long() - 1).clamp_min(0), b]
    virt = torch.full_like(hbp, o_ + col0 * e_)
    vals = torch.where(pmaskT_c != 0, torch.where(predsT_c == 0, virt, hbp),
                       NEG)
    return torch.stack([vals.max(0).values,
                        torch.argmax(vals, 0).to(torch.int32),
                        ck_c[:, b, 1], ck_c[:, b, 2]])


def ring_window(snap, n: int, col0: int, cw: int) -> torch.Tensor:
    """The columns [col0, col0 + cw) of a ring taken at ``n`` columns,
    as a ring of a ``cw``-column launch: ``poa_dp.cu`` interleaves each
    ring row for its launch width, so the window is de-interleaved and
    re-interleaved with one gather."""
    dev = snap.device
    out = msa_poa.new_ring(snap.shape[0], cw, dev)
    src = msa_poa.ring_positions(n, dev)[col0:col0 + cw]
    out[:, :, msa_poa.ring_positions(cw, dev)] = snap[:, :, src]
    return out


def _chunk(t, c: int, NC: int) -> torch.Tensor:
    """Rows [c*NC, (c+1)*NC) of a (k, N) table, contiguous."""
    return t[:, c * NC:(c + 1) * NC].contiguous()


class ChunkedRound:
    """A chunked round's tables on ``dev``, padded to whole chunks (the
    padded rows have no preds and are never computed), and the arguments
    of its DP launches: ``forward_call`` for a forward chunk,
    ``remat_call`` for a window remat.  Each returns ``(args, kwargs)``
    for :func:`msa_poa.poa_dp` or :func:`msa_native.round_dp_plain`."""

    def __init__(self, g, prep, a, n_real: int, NC: int, NWIN: int, params,
                 dev):
        predsT, pmaskT, bases, fills, N, _, W, order, preds = prep
        self.n, self.n_real, self.NC, self.NWIN, self.W = (
            a.shape[0], n_real, NC, NWIN, W)
        self.CW = self.n // NWIN if NWIN else self.n
        self.params, self.dev = params, dev
        self.nchunks = -(-N // NC)
        self.n_nodes = len(order)
        pad = self.nchunks * NC - N

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                dev, non_blocking=True)

        self.predsT = put(np.pad(predsT, ((0, 0), (0, pad))))
        self.pmaskT = put(np.pad(pmaskT, ((0, 0), (0, pad))))
        self.bases = put(np.pad(bases.reshape(N), (0, pad)))
        self.fills = put(np.pad(fills, ((0, 0), (0, pad)),
                                constant_values=NEG))
        self.preds = put(np.pad(preds, ((0, pad), (0, 0))))
        # the walk's plan: the most rows a move climbs
        self.maxdist = msa_poa.max_pred_distance(preds)
        self.mask = put(msa_poa.sink_mask(g, order, N + pad))
        self.a = put(a)

    def rows(self, c: int) -> int:
        """Real rows of chunk ``c``."""
        return min(max(self.n_nodes - c * self.NC, 0), self.NC)

    def chunk_preds(self, c: int) -> torch.Tensor:
        """Chunk ``c``'s (NC, max_in) pred rows, for the bounded walk."""
        return self.preds[c * self.NC:(c + 1) * self.NC]

    def forward_call(self, c: int, ring, ckpt):
        """Chunk ``c``'s forward: ``ring`` carries in and out, ``ckpt``
        (its (NC, NWIN, 3) slice, or None) takes the checkpoints."""
        NC = self.NC
        args = (_chunk(self.predsT, c, NC), _chunk(self.pmaskT, c, NC),
                self.bases[c * NC:(c + 1) * NC], _chunk(self.fills, c, NC),
                self.a, self.n_real, self.rows(c), self.params, self.W)
        return args, {"ring": ring, "chunk_base": c * NC, "ckpt": ckpt,
                      "with_words": False}

    def forward(self, dp):
        """The forward pass through ``dp``: the ring snapshot at each
        chunk's entry, the (Np,) sink scores and the (Np, NWIN, 3)
        checkpoints (None without windows)."""
        NC = self.NC
        ring = msa_poa.new_ring(self.W, self.n, self.dev)
        ckpt = (torch.zeros((self.nchunks * NC, self.NWIN, 3),
                            dtype=torch.int32, device=self.dev)
                if self.NWIN else None)
        snaps, scores = [], []
        for c in range(self.nchunks):
            snaps.append(ring.clone())
            args, kw = self.forward_call(
                c, ring, None if ckpt is None else ckpt[c * NC:(c + 1) * NC])
            scores.append(dp(*args, **kw)[1])
        return snaps, torch.cat(scores), ckpt

    def cell(self, row: int, j: int):
        """The (chunk, window) cell that holds the walk at (row, j)."""
        return (row // self.NC,
                min(j // self.CW, self.NWIN - 1) if self.NWIN else 0)

    def remat_call(self, c: int, w: int, snap, ckpt, hb):
        """Cell (c, w)'s window remat from ``snap``, chunk ``c``'s entry
        ring: a new ring of the window, and the window's left boundary
        from the checkpoints (``hb`` their H plane) or, in the first
        window, the round's own fills."""
        NC, CW = self.NC, self.CW
        col0 = w * CW
        pt, pm = _chunk(self.predsT, c, NC), _chunk(self.pmaskT, c, NC)
        if w > 0:
            _, _, e_, o_ = as_params(self.params)
            fills = win_fills(ckpt[c * NC:(c + 1) * NC], hb, pt, pm, w - 1,
                              col0, e_, o_)
        else:
            fills = _chunk(self.fills, c, NC)
        ring = (ring_window(snap, self.n, col0, CW) if self.NWIN
                else snap.clone())
        args = (pt, pm, self.bases[c * NC:(c + 1) * NC], fills,
                self.a[col0:col0 + CW], self.n_real, self.rows(c),
                self.params, self.W)
        return args, {"ring": ring, "chunk_base": c * NC, "col0": col0}


@torch.no_grad()
def round_chunked(g, prep, a, n_real: int, NC: int, NWIN: int, params, dev,
                  use_kernel: bool, clock=None) -> torch.Tensor:
    """One chunked round of the read ``a`` ((n,) uint8 host array, zero
    padded) against ``g``, whose tables are ``prep``
    (:func:`msa_poa.prepare`), with ``NC`` rows per chunk and ``NWIN``
    checkpoint windows.  ``use_kernel``: the CUDA kernels, else their
    plain versions.  Returns the (2 + n,) int32 ``[best, score,
    align...]`` on ``dev``, as a single-call round does."""
    from tsta_tpu_torch.ops.msa_native import round_dp_plain
    r = ChunkedRound(g, prep, a, n_real, NC, NWIN, params, dev)
    dp = msa_poa.poa_dp if use_kernel else round_dp_plain
    if use_kernel:
        def walk(*a):
            return msa_poa.poa_walk_bounded(*a, maxdist=r.maxdist)
    else:
        walk = msa_poa.walk_bounded_plain
    if clock:
        clock.mark("dp0")
    snaps, scores, ckpt = r.forward(dp)
    if clock:
        clock.mark("dp1")

    best = msa_poa.best_sink(scores, r.mask)
    hb = ckpt[:, :, 0].contiguous() if NWIN else None
    align = torch.full((r.n,), -1, dtype=torch.int32, device=dev)
    row, j, state = int(best), n_real - 1, 0
    cells = 0
    while row >= 0 and j >= 0:
        c, w = r.cell(row, j)
        args, kw = r.remat_call(c, w, snaps[c], ckpt, hb)
        words, _ = dp(*args, **kw)
        st = walk(words, r.chunk_preds(c), row, j, state, c * NC, w * r.CW,
                  align)
        cells += 1
        row, j, state = st.tolist()
        del words
    if clock:
        # one remat per walked cell
        clock.chunked = {"NC": NC, "chunks": r.nchunks, "NWIN": NWIN,
                         "CW": r.CW, "remats": cells, "cells_walked": cells}
    return msa_poa.pack_round(scores, align, best)
