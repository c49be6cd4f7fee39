"""Plain Gotoh global alignment with affine gaps, in PyTorch.

The reference that the PSA cells are judged by.  It imports nothing of
the program under test.  Cells are indexed as the reference TSTA prints
them: read ``a`` along the columns (j = 0..n-1), read ``b`` down the rows
(i = 0..m-1), a gap of k bases costs ``O + k*E``::

    E(i,j) = max(E(i-1,j) + E, H(i-1,j) + O + E)       vertical gap
    F(i,j) = max(F(i,j-1) + E, H(i,j-1) + O + E)       horizontal gap
    H(i,j) = max(H(i-1,j-1) + s(a_j, b_i), E(i,j), F(i,j))

with the boundary H(-1,-1) = 0, H(-1,j) = O + (j+1)E, H(i,-1) = O + (i+1)E
and no gap state open on it.  ``best`` is the largest H over the m x n
cells (the reference's ``maxsorce``), ``corner`` is H(m-1, n-1).

The DP runs one row at a time over a batch of pairs padded to one width:
F along a row is a running maximum (``scan.prefix_max``), so a row is a
fixed handful of tensor operations whatever its width.  Any integer
dtype may be asked for: the control computes the same recurrence in a
narrower one, saturating at its range as SIMD aligners do (each value
computed in int32, then clamped to the narrow type's range).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.scan import padded, prefix_max


def _limits(dtype) -> tuple:
    info = torch.iinfo(dtype)
    return info.min, info.max


@torch.no_grad()
def score_pairs(pairs, params, device, dtype=torch.int32) -> tuple:
    """(best, corner) lists of ints for ``pairs`` of byte strings or uint8
    arrays, ``params`` (match, mismatch, gap_extend, gap_open).  All pairs
    run together, padded to the longest; a pair's padded cells are left
    out of its maximum and its corner.  With a dtype narrower than int64,
    every value is clamped to that dtype's range after each step."""
    M, X, E, O = (int(x) for x in params)
    B = len(pairs)
    A = [np.frombuffer(bytes(a), np.uint8) for a, _ in pairs]
    Bs = [np.frombuffer(bytes(b), np.uint8) for _, b in pairs]
    n = max(len(a) for a in A)
    m = max(len(b) for b in Bs)
    a_h = np.zeros((B, n), np.int16)
    b_h = np.full((B, m), -1, np.int16)     # a pad row never matches
    for k, (a, b) in enumerate(zip(A, Bs)):
        a_h[k, :len(a)] = a
        b_h[k, :len(b)] = b
    for k, a in enumerate(A):
        a_h[k, len(a):] = -2                # a pad column never matches
    dev = torch.device(device)
    lo, hi = _limits(dtype)
    narrow = dtype in (torch.int8, torch.int16)
    dtype = torch.int32 if narrow else dtype
    neg = max(lo, -(2 ** 28))               # "no gap open": far below any H
    a_t = torch.from_numpy(a_h).to(dev)
    b_t = torch.from_numpy(b_h).to(dev)
    n_real = torch.tensor([len(a) for a in A], device=dev)
    m_real = torch.tensor([len(b) for b in Bs], device=dev)

    def sat(t):
        return t.clamp_(lo, hi) if narrow else t

    def cst(v):
        return max(lo, min(hi, int(v)))

    j = torch.arange(n, device=dev, dtype=torch.int64)
    jE = (j * E).clamp(lo, hi).to(dtype)
    OjE = (O + j * E).clamp(lo, hi).to(dtype)
    hprev = torch.empty((B, n + 1), dtype=dtype, device=dev)
    hnext = torch.empty_like(hprev)
    hprev[:, 0] = 0
    hprev[:, 1:] = (O + (j + 1) * E).clamp(lo, hi).to(dtype)
    e = torch.full((B, n), neg, dtype=dtype, device=dev)
    g = torch.full((B, padded(n)), lo, dtype=dtype, device=dev)
    best = torch.full((B, n), lo, dtype=dtype, device=dev)
    m_list = [len(b) for b in Bs]
    m_min = min(m_list)
    last_row = {}
    for k, mk in enumerate(m_list):
        last_row.setdefault(mk - 1, []).append(k)
    corner = [lo] * B
    subM = torch.tensor(cst(M), dtype=dtype, device=dev)
    subX = torch.tensor(cst(X), dtype=dtype, device=dev)
    rows = torch.arange(1, m + 1, device=dev, dtype=torch.int64)
    h_left = (O + rows * E).clamp(lo, hi).to(dtype)       # H(i, -1)
    g_left = (O + rows * E + E).clamp(lo, hi).to(dtype)   # its F seed
    G = 64                    # rows a chunk: even, so H's buffers swap back
    chunk_b = torch.empty((B, G), dtype=b_t.dtype, device=dev)
    chunk_h = torch.empty((G,), dtype=dtype, device=dev)
    chunk_g = torch.empty((G,), dtype=dtype, device=dev)
    bufs = [hprev, hnext]

    def row(sub_b, hl, gl, k, into_best):
        """Row k of the current chunk (``sub_b`` its bases, ``hl`` and
        ``gl`` its boundary values): H into bufs[(k + 1) % 2], and into
        the running maximum with ``into_best``."""
        hp, hn = bufs[k % 2], bufs[(k + 1) % 2]
        sub = torch.where(a_t == sub_b, subM, subX)
        diag = sat(hp[:, :-1] + sub)
        torch.maximum(sat(e + E), sat(hp[:, 1:] + cst(O + E)), out=e)
        c = torch.maximum(diag, e)
        g[:, 0] = gl
        torch.sub(c[:, :-1], jE[:-1], out=g[:, 1:n])
        sat(g)
        f = sat(prefix_max(g)[:, :n] + OjE)
        torch.maximum(c, f, out=hn[:, 1:])
        hn[:, 0] = hl
        if into_best:
            torch.maximum(best, hn[:, 1:], out=best)
        return hn[:, 1:]

    def chunk():
        for k in range(G):
            row(chunk_b[:, k:k + 1], chunk_h[k], chunk_g[k], k, True)

    def load(r0):
        chunk_b.copy_(b_t[:, r0:r0 + G])
        chunk_h.copy_(h_left[r0:r0 + G])
        chunk_g.copy_(g_left[r0:r0 + G])

    # rows before any pair's last: whole chunks, on the card replayed
    # from one captured graph (the same kernels, launched once a chunk)
    R = max(0, (m_min - 1) // G * G)
    graph = None
    for r0 in range(0, R, G):
        load(r0)
        if graph is not None:
            graph.replay()
            continue
        chunk()
        if r0 == 0 and dev.type == "cuda" and R >= 2 * G:
            graph = _capture(chunk)
    for i in range(R, m):                   # the rest, row by row
        k = (i - R) % 2
        h = row(b_t[:, i:i + 1], h_left[i], g_left[i], k, i < m_min)
        if i >= m_min:                      # rows past a pair's end
            best = torch.where((i < m_real).view(B, 1),
                               torch.maximum(best, h), best)
        for p in last_row.get(i, ()):
            corner[p] = h[p, len(A[p]) - 1].clone()
    del graph
    valid_col = j.view(1, n) < n_real.view(B, 1)
    best = torch.where(valid_col, best, lo).amax(dim=1).cpu().tolist()
    corner = [int(x) for x in torch.stack(corner).cpu().tolist()]
    return [int(x) for x in best], corner


def _capture(fn):
    """``fn``'s kernels captured as one CUDA graph, or None where they
    cannot be (the rows then run eagerly)."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError:
        return None
    return graph


def rescore(a_row: bytes, b_row: bytes, params) -> int:
    """The affine score of an alignment given as two gapped rows of equal
    length ('-' a gap): each aligned pair scores M or X, each maximal run
    of gaps in one row O + run * E.  A column gapped in both rows is not
    an alignment: ValueError."""
    M, X, E, O = (int(x) for x in params)
    r1 = np.frombuffer(a_row, np.uint8)
    r2 = np.frombuffer(b_row, np.uint8)
    if r1.shape != r2.shape:
        raise ValueError("rows of different lengths")
    g1, g2 = r1 == ord("-"), r2 == ord("-")
    if (g1 & g2).any():
        raise ValueError("a column is a gap in both rows")
    both = ~g1 & ~g2
    same = int((both & (r1 == r2)).sum())
    diff = int(both.sum()) - same

    def runs(gap):
        starts = gap & ~np.concatenate([[False], gap[:-1]])
        return int(starts.sum()), int(gap.sum())

    o1, k1 = runs(g1)
    o2, k2 = runs(g2)
    return same * M + diff * X + (o1 + o2) * O + (k1 + k2) * E


def degap(row: bytes) -> bytes:
    return row.replace(b"-", b"")
