"""One POA round on the device: host tables, the memory plan, the DP and
walk kernels' wrappers, the best sink and the packed per-round result.

Counterpart of ``tsta_tpu/ops/msa_pallas.py`` (``_prepare``,
``_round_plan``, ``_prep_round``, ``round_dp_fused``, ``pack_round``).  A
round whose words plane fits the memory plan runs as one chain on the
current stream:

1. host tables in topo order (:func:`prepare`): the pred table in the
   order of ``g.csr()`` (the tie rules depend on it), bases, the
   left-boundary fills and the ring size ``W``;
2. the DP (:func:`poa_dp`, ``csrc/poa_dp.cu``): a (N, n) 16-bit word
   plane and the per-node sink scores;
3. the best sink, a first-max argmax over the sink rows;
4. the walk (:func:`poa_walk`, ``csrc/poa_walk.cu``) from the best sink
   to the per-column aligned rows, on a window ring of the plane and the
   preds in shared memory (:func:`poa_walk_plan`, replayed on the CPU by
   :func:`poa_walk_staged_plain`);
5. ``[best, score, align...]`` packed into one int32 tensor, so the host
   pays one device-to-host transfer per round.

A round the plan chunks runs through ``ops/msa_chunked.py``: the forward
DP in node chunks with checkpoints, then a backward that rematerialises
one (chunk, column window) cell at a time and walks it
(:func:`poa_walk_bounded`).

Each wrapper takes its plain PyTorch version for CPU tensors
(:func:`tsta_tpu_torch.ops.msa_native.round_dp_plain`,
:func:`walk_plain`, :func:`walk_bounded_plain`) and launches its kernel,
or raises, for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from tsta_tpu_torch.ops import _kernels
# poa_dp.cu's plan and ring width, from n alone (re-exported)
from tsta_tpu_torch.ops._kernels import (SHARD_MAX, SHARD_THREADS,  # noqa
                                         poa_plan, poa_walk_plan, ring_width)
from tsta_tpu_torch.native.build import load_poa
from tsta_tpu_torch.ops.psa_scan import NEG, as_params, bucket
from tsta_tpu_torch.utils import profiling

LANES = 128
MAX_IN = _kernels.POA_MAX_IN   # the 16-bit words' 6-bit pred fields
WIDE_MAX_IN = 1 << 13          # the plain version's int32 words: 13 bits


def _next_pow2(v):
    w = 1
    while w < v:
        w *= 2
    return w


def _node_block(N):
    """Node-count quantum of the TPU kernel's SMEM blocks; kept so the
    tables (and N) equal the JAX package's."""
    return min(512, N)


def _hm1(N_real, max_in, preds, lens, e_, o_, hm1) -> None:
    """The H(v,-1) recurrence over topo rows, in C (poa_fast.c
    ``tsta_poa_hm1``): hm1[i+1] = max over preds of hm1 + e, or o + e for
    a source."""
    lib = load_poa()
    lens64 = np.ascontiguousarray(lens, np.int64)
    preds32 = np.ascontiguousarray(preds, np.int32)
    lib.tsta_poa_hm1(
        N_real, max_in,
        preds32.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens64.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        int(e_), int(o_),
        hm1.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))


def prepare(g, params, cap: bool = True):
    """Dense per-round tables of graph ``g`` in topo order, as
    ``msa_pallas._prepare``: ``(predsT, pmaskT, bases, fills, N, max_in,
    W, order, preds)`` with predsT/pmaskT (max_in, N) int32 (buffer row
    ids, 0 = the virtual row), bases (1, N), fills (4, N) int32, preds
    (N, max_in).  ``max_in`` is the in-degree rounded up to a power of
    two; with ``cap`` an in-degree above 64 raises ``ValueError``."""
    order = g.topo
    N_real = len(order)
    max_in = max(1, g.max_in_degree())
    if cap and max_in > MAX_IN:
        raise ValueError(
            "POA kernel traceback packs predecessor indices into 6 bits "
            "(in-degree %d > %d; the reference caps at 42)" % (max_in, MAX_IN))
    max_in = _next_pow2(max_in)
    N = bucket(N_real)
    nb = _node_block(N)
    N = -(-N // nb) * nb
    e_, o_ = params.gap_extend, params.gap_open

    order_arr = np.asarray(order, np.int64)
    pos = np.empty(len(g), np.int64)
    pos[order_arr] = np.arange(N_real)
    nd_all, ptr_all, flat_all = g.csr()[:3]
    lens = nd_all[order_arr]
    n_edges = int(lens.sum())
    rowi = np.repeat(np.arange(N_real), lens)
    coli = np.arange(n_edges) - np.repeat(np.cumsum(lens) - lens, lens)
    flat = flat_all[np.repeat(ptr_all[order_arr], lens) + coli]
    preds = np.zeros((N, max_in), np.int32)
    pmask = np.zeros((N, max_in), np.int32)
    preds[rowi, coli] = pos[flat] + 1
    pmask[rowi, coli] = 1
    pmask[np.where(lens == 0)[0], 0] = 1   # sources read the virtual row 0
    bases = np.zeros((N, 1), np.int32)
    bases[:N_real, 0] = g._bases[order_arr].astype(np.int32)
    maxdist = max_pred_distance(preds)
    hm1 = np.full((N + 1,), NEG, np.int64)
    _hm1(N_real, max_in, preds, lens, e_, o_, hm1)
    hm1 = hm1.astype(np.int32)
    # [0] max over valid preds of H(p,-1), [1] its first-max index, [2]
    # the F seed H(v,-1) + e, [3] the f_ext fill F(v,-1) (none: NEG)
    hm1p = np.where(pmask.T != 0, hm1[preds.T], np.int32(NEG))
    fills = np.stack([
        hm1p.max(axis=0),
        np.argmax(hm1p, axis=0).astype(np.int32),
        (hm1[1:N + 1] + np.int32(e_)).astype(np.int32),
        np.full((N,), NEG, np.int32),
    ]).astype(np.int32)
    # ring slots: W > maxdist, so a pred's rows outlive its successors
    W = 2
    while W < maxdist + 1:
        W *= 2
    W = min(W, _next_pow2(N + 1))
    return (preds.T.copy(), pmask.T.copy(), bases.reshape(1, N), fills, N,
            max_in, W, order, preds)


def round_plan(N: int, n: int, W: int, budget: int):
    """``msa_pallas._round_plan`` with the budget passed in: ``None`` when
    the (N, n) words plane fits one call, else the node-chunk size ``NC``
    of a chunked round; raises ``ValueError`` when not even that fits."""
    if 2 * N * n <= int(0.5 * budget):
        return None
    nb = _node_block(N)
    NC = nb
    while 2 * (NC * 2) * n <= budget // 4 and NC * 2 < _next_pow2(N):
        NC *= 2
    nchunks = -(-N // NC)
    if nchunks <= 1:
        if 2 * N * n + 8 * W * n <= int(0.8 * budget):
            return None
        raise ValueError(
            "native MSA round cannot fit the chip (%d nodes x %d cols, "
            "ring W=%d, ~%.2f MB plane vs %.2f MB budget); use "
            "engine='compat' (host-RAM planes) for reads this long"
            % (N, n, W, 2 * N * n / 2 ** 20, budget / 2 ** 20))
    need = (4 * NC * n + (nchunks + 1) * 8 * W * n
            + _ckpt_windows(n) * LANES * 4 * nchunks * NC)
    if need > int(0.8 * budget):
        raise ValueError(
            "native MSA round cannot fit the chip even chunked "
            "(%d nodes x %d cols, ring W=%d, ~%.1f GB working set); "
            "use engine='compat' (host-RAM planes) for reads this long"
            % (N, n, W, need / 2 ** 30))
    return NC


def _ckpt_windows(n):
    """Column windows of a chunked round's checkpoints (0 = none), as
    ``msa_pallas._ckpt_windows``; part of the plan's memory count."""
    if n % 1024:
        return 0
    k = n // 1024
    for d in (8, 7, 6, 5, 4, 3, 2):
        if k % d == 0:
            return d
    return 0


def round_columns(n_real: int) -> int:
    """Padded column count of a round: ``bucket``, then 8,192-rounded
    above 16,384 (the TPU path's compile buckets; kept for equal
    planes)."""
    n = bucket(n_real)
    if n > 16384:
        n = -(-n // 8192) * 8192
    return n


def prep_round(g, seq: bytes, params, budget: int, cap: bool = True):
    """Tables, padded read and plan of one round: ``(prep, n, n_real, a,
    NC, NWIN)`` with ``a`` the (n,) uint8 read, zero-padded, ``NC`` the
    plan's node chunk (None: one call) and ``NWIN`` the chunked round's
    column windows (0: none, the backward rematerialises whole chunks)."""
    if len(seq) == 0:
        raise ValueError("cannot align an empty read")
    prep = prepare(g, params, cap=cap)
    N, W = prep[4], prep[6]
    n_real = len(seq)
    n = round_columns(n_real)
    NC = round_plan(N, n, W, budget)
    NWIN = _ckpt_windows(n) if NC is not None else 0
    a = np.zeros((n,), np.uint8)
    a[:n_real] = np.frombuffer(bytes(seq), np.uint8)
    return prep, n, n_real, a, NC, NWIN


def ring_positions(n: int, dev, D: int | None = None) -> torch.Tensor:
    """(n,) int64: where ``poa_dp.cu``'s ring keeps column j of an
    n-column launch in each H or E row: column d*C + t*S + k (shard d,
    thread t) at d*SHARD_THREADS*S + k*SHARD_THREADS + t, so a warp's
    accesses coalesce (:func:`poa_plan`, ``D`` as there)."""
    _, C, S, _ = poa_plan(n, D)
    j = torch.arange(n, device=dev)
    r = j % C
    return (j // C) * (SHARD_THREADS * S) + (r % S) * SHARD_THREADS + r // S


def new_ring(W: int, n: int, dev, D: int | None = None) -> torch.Tensor:
    """A zeroed (W, 2, ring width) int32 ring for an n-column launch."""
    return torch.zeros((W, 2, ring_width(n, D)), dtype=torch.int32,
                       device=dev)


def poa_dp(predsT, pmaskT, bases, fills, a, n_real, n_nodes, params, W, *,
           ring=None, chunk_base=0, col0=0, ckpt=None, with_words=True,
           D=None, T=None, G=None):
    """The round DP over rows < ``n_nodes``: returns ``(words, scores)``,
    words (N, n) int16 (rows >= n_nodes zero; None without
    ``with_words``) and scores (N,) int32 (NEG past n_nodes).  The other
    arguments are :func:`msa_native.round_dp_plain`'s: without ``ring``
    the single call, with it a chunked round's forward chunk (no words,
    ``ckpt``) or window remat (words).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/poa_dp.cu`` (:func:`poa_plan`'s
    D shards on co-resident blocks; ``D`` and ``T`` override the plan, a
    ring is then laid out for the forced D, and ``G`` the grid) or
    raise."""
    if a.device.type == "cpu":
        if D is not None or T is not None or G is not None:
            raise ValueError("poa_dp: D, T and G are the kernel's overrides")
        from tsta_tpu_torch.ops.msa_native import round_dp_plain
        return round_dp_plain(predsT, pmaskT, bases, fills, a, n_real,
                              n_nodes, params, W, ring=ring,
                              chunk_base=chunk_base, col0=col0, ckpt=ckpt,
                              with_words=with_words)
    N = predsT.shape[1]
    words = None
    if with_words:
        words = torch.empty((N, a.shape[0]), dtype=torch.int16,
                            device=a.device)
    scores = torch.full((N,), NEG, dtype=torch.int32, device=a.device)
    _kernels.poa_dp(predsT, pmaskT, bases, fills, a, n_real, n_nodes,
                    as_params(params), W, words, scores, ring=ring,
                    chunk_base=chunk_base, col0=col0, ckpt=ckpt, D=D, T=T,
                    G=G)
    if words is not None:
        words[n_nodes:].zero_()
    return words, scores


def walk_plain(words, preds, best, n_real: int) -> torch.Tensor:
    """The POA traceback walk in Python: the plain version of
    ``csrc/poa_walk.cu`` and the counterpart of ``msa_pallas._walk``.

    ``words``: (N, n) plane, int16 (6-bit pred fields) or int32 (13-bit,
    the plain round's format past 64 preds); ``preds``: (N, max_in)
    int32; ``best``: start row (int or one-element tensor).  Returns the
    (n,) int32 aligned rows (-1 for gaps) on ``words``' device."""
    bits = 6 if words.dtype == torch.int16 else 13
    fmask = (1 << bits) - 1
    pr = preds.cpu().numpy()
    plane = words.numpy() if words.device.type == "cpu" else None
    align = np.full((words.shape[1],), -1, np.int32)
    row = int(best.reshape(-1)[0]) if torch.is_tensor(best) else int(best)
    j, state = n_real - 1, 0
    while j >= 0 and row >= 0:
        w = int(plane[row, j] if plane is not None else words[row, j])
        w &= 0xFFFF if bits == 6 else 0xFFFFFFFF
        if state == 0:
            h_type = (w >> 2) & 3
            if h_type == 0:
                align[j] = row
                row = int(pr[row, (w >> 4) & fmask]) - 1
                j -= 1
            else:
                state = h_type
        elif state == 1:
            row = int(pr[row, (w >> (4 + bits)) & fmask]) - 1
            state = (w >> 1) & 1
        else:
            align[j] = -1
            j -= 1
            state = 2 if w & 1 else 0
    return torch.from_numpy(align).to(words.device)


def poa_walk(words, preds, best, n_real: int, *, maxdist=None, S=None,
             R=None, threads=None, counts=None) -> torch.Tensor:
    """Walk a round's word plane from row ``best`` ((1,) int32); returns
    the (n,) int32 aligned rows.  CPU tensors take :func:`walk_plain`;
    CUDA tensors launch ``csrc/poa_walk.cu`` (:func:`poa_walk_plan` for
    the round's ``maxdist``; ``S``, ``R`` and ``threads`` force it, and
    ``counts``, a (4,) int32 tensor, takes the moves, pred moves, misses
    and phases) or raise."""
    if words.device.type == "cpu":
        if S is not None or R is not None or threads is not None \
                or counts is not None:
            raise ValueError("S, R, threads and counts are the kernel's; a "
                             "CPU plane takes the plain walk")
        return walk_plain(words, preds, best, n_real)
    align = torch.full((words.shape[1],), -1, dtype=torch.int32,
                       device=words.device)
    _kernels.poa_walk(words, preds, best, n_real, align, maxdist=maxdist,
                      S=S, R=R, threads=threads, counts=counts)
    return align


def walk_bounded_plain(words, preds, row: int, j: int, state: int,
                       base: int, col0: int, align) -> torch.Tensor:
    """The POA walk inside one cell of a chunked round, in Python: the
    plain version of ``csrc/poa_walk_bounded.cu`` and the counterpart of
    ``msa_pallas._walk_bounded_banded``.

    ``words``: the cell's (nc, cw) plane of rows [base, base + nc) and
    columns [col0, col0 + cw), int16 or int32 as :func:`walk_plain`;
    ``preds``: its (nc, max_in) rows of the pred table.  Walks from
    (row, j, state) until the walk leaves the cell, writes ``align``
    ((n,) int32) at the consumed columns and returns (row, j, state) as a
    (3,) int32 tensor on ``align``'s device."""
    bits = 6 if words.dtype == torch.int16 else 13
    fmask = (1 << bits) - 1
    wmask = 0xFFFF if bits == 6 else 0xFFFFFFFF
    plane = words.cpu().numpy()
    pr = preds.cpu().numpy()
    nc, cw = plane.shape
    cols, rows = [], []
    while base <= row < base + nc and col0 <= j < col0 + cw:
        rl = row - base
        w = int(plane[rl, j - col0]) & wmask
        if state == 0:
            h_type = (w >> 2) & 3
            if h_type == 0:
                cols.append(j)
                rows.append(row)
                row = int(pr[rl, (w >> 4) & fmask]) - 1
                j -= 1
            else:
                state = h_type
        elif state == 1:
            row = int(pr[rl, (w >> (4 + bits)) & fmask]) - 1
            state = (w >> 1) & 1
        else:
            cols.append(j)
            rows.append(-1)
            j -= 1
            state = 2 if w & 1 else 0
    if cols:
        align[torch.tensor(cols, device=align.device)] = torch.tensor(
            rows, dtype=torch.int32, device=align.device)
    return torch.tensor([row, j, state], dtype=torch.int32,
                        device=align.device)


def poa_walk_bounded(words, preds, row: int, j: int, state: int, base: int,
                     col0: int, align, *, maxdist=None, S=None, R=None,
                     threads=None, counts=None) -> torch.Tensor:
    """:func:`walk_bounded_plain`'s function: CPU tensors take it; CUDA
    tensors launch ``csrc/poa_walk_bounded.cu`` (the plan and overrides
    of :func:`poa_walk`) or raise.  Returns the (3,) int32 (row, j,
    state) on the device, the host's one 12-byte read per cell."""
    if words.device.type == "cpu":
        if S is not None or R is not None or threads is not None \
                or counts is not None:
            raise ValueError("S, R, threads and counts are the kernel's; a "
                             "CPU plane takes the plain walk")
        return walk_bounded_plain(words, preds, row, j, state, base, col0,
                                  align)
    out = torch.empty((3,), dtype=torch.int32, device=words.device)
    _kernels.poa_walk_bounded(words, preds, row, j, state, base, col0,
                              align, out, maxdist=maxdist, S=S, R=R,
                              threads=threads, counts=counts)
    return out


def max_pred_distance(preds) -> int:
    """The largest number of rows an edge skips, at least 1: row r's pred
    ``preds[r, k] - 1`` (0 = none or the virtual row) is at most this many
    rows above it (``prepare``'s ``maxdist``), so a walk's move climbs at
    most this far.  ``preds``: the (N, max_in) host table."""
    pr = np.asarray(preds)
    rows = np.arange(pr.shape[0])[:, None]
    d = np.where(pr > 0, rows - (pr.astype(np.int64) - 1), 0)
    return max(1, int(d.max())) if d.size else 1


def poa_walk_window(r0: int, j0: int, S: int, R: int, rows: int,
                    cols: int) -> tuple:
    """The part of a plane the POA walks' window anchored at (r0, j0)
    stages: rows [lo, hi) and columns [c0, c1) of the plane's own
    coordinates (a cell's: row - base, j - col0), clipped to its rows
    [0, rows) and columns [0, cols).

    The window is the R rows [r0 - R + 1, r0] (slot 0 = row r0 - R + 1)
    by 2S + 8 columns from c0 = j0 - 2S aligned down to 8 words (16-byte
    copies), with the pred-table rows of those rows; empty (hi == lo) for
    an anchor outside the plane or R = 0.  The rule of
    ``csrc/poa_walk_stage.cuh``'s ``poa_walk_window``."""
    c0 = max(j0 - 2 * S, 0) // 8 * 8
    c1 = min(c0 + 2 * S + 8, cols)
    if not (0 <= r0 < rows and 0 <= j0 < cols):
        return 0, 0, c0, c1
    return max(r0 - R + 1, 0), r0 + 1, c0, c1


@torch.no_grad()
def poa_walk_staged_plain(words, preds, row: int, j: int, state: int,
                          S: int, R: int, base: int = 0, col0: int = 0,
                          align=None):
    """The POA walk replayed on the schedule of the walk kernels' window
    ring (``csrc/poa_walk_stage.cuh``), from a whole plane (``base`` =
    ``col0`` = 0, from (best, n_real - 1, 0)) or from one cell of a
    chunked round (:func:`walk_bounded_plain`'s arguments).

    Phases of at most S moves (a diagonal, an E move up the graph or an F
    move left, an H cell's switch to E or F taking its move on the same
    word); phase k reads the window anchored where phase k - 1 began
    (phase 0's at the entry), which the loaders stage with
    :func:`poa_walk_window` into the slots of the anchor they are given.
    A move inside the walker's window reads its word and pred from the
    slot of the walker's anchor and asserts (AssertionError) that the slot
    holds that cell; a move outside reads the plane and counts a miss.
    ``words``: int16 (6-bit pred fields), on the CPU or the card (then
    only the windows and the missed words are copied to the host).
    Returns ``(align, exit, counts)``: ``align`` ((n,) int32, a new one
    filled with -1 when None) updated at the consumed columns, the (3,)
    int32 exit (row, j, state) and the (4,) int32 counts (moves, pred
    moves, misses, phases), the kernels' own."""
    if words.dtype != torch.int16:
        raise ValueError("the walk kernels read int16 words, got %s"
                         % words.dtype)
    rows, cols = words.shape
    if align is None:
        align = torch.full((col0 + cols,), -1, dtype=torch.int32,
                           device=words.device)
    host = words.numpy() if words.device.type == "cpu" else None
    pr = preds.cpu().numpy()
    Wc = 2 * S + 8

    def plane(r0, r1, c0, c1):
        if host is not None:
            return host[r0:r1, c0:c1]
        return words[r0:r1, c0:c1].cpu().numpy()

    def stage(r0, j0):   # the loaders: the window anchored at (r0, j0)
        lo, hi, c0, c1 = poa_walk_window(r0, j0, S, R, rows, cols)
        rb = r0 - R + 1
        lo, hi = max(lo, rb), min(hi, rb + max(R, 0))   # the buffer's slots
        c1 = min(c1, c0 + Wc)
        win = np.zeros((max(R, 0), Wc), np.int32)
        held = np.full((max(R, 0), Wc), -1, np.int64)   # the cell a slot holds
        prow = np.full((max(R, 0),), -1, np.int64)      # the pred row
        if hi > lo and c1 > c0:
            win[lo - rb:hi - rb, :c1 - c0] = plane(lo, hi, c0, c1).view(
                np.uint16)
            held[lo - rb:hi - rb, :c1 - c0] = (
                np.arange(lo, hi)[:, None] * cols + np.arange(c0, c1))
            prow[lo - rb:hi - rb] = np.arange(lo, hi)
        return win, held, prow

    def inside(r, c):
        return 0 <= r < rows and 0 <= c < cols

    r, c = row - base, j - col0
    steps = pred_moves = misses = phases = 0
    cols_out, rows_out = [], []
    cur, anchor = stage(r, c), (r, c)
    done = False
    while not done:
        nxt, start = stage(r, c), (r, c)   # window k + 1, at phase k's start
        win, held, prow = cur
        rb, c0 = anchor[0] - R + 1, max(anchor[1] - 2 * S, 0) // 8 * 8
        for _ in range(S):
            if not inside(r, c):
                done = True
                break
            hit = 0 <= r - rb < R and 0 <= c - c0 < Wc
            if hit:
                assert held[r - rb, c - c0] == r * cols + c, (
                    "read of (%d, %d) not staged in the window of rows from "
                    "%d, columns from %d" % (r, c, rb, c0))
                w = int(win[r - rb, c - c0])
            else:
                w = int(plane(r, r + 1, c, c + 1)[0, 0]) & 0xFFFF
                misses += 1
            st = (w >> 2) & 3 if state == 0 else state
            if st < 2:   # a diagonal or an E move reads a pred
                assert not hit or prow[r - rb] == r, \
                    "pred of row %d not staged" % r
                p = int(pr[r, (w >> (4 if st == 0 else 10)) & 63])
                pred_moves += 1
            if st != 1:
                cols_out.append(c + col0)
                rows_out.append(r + base if st == 0 else -1)
            state = 0 if st == 0 else ((w >> 1) & 1 if st == 1
                                       else (w & 1) << 1)
            if st < 2:
                r = p - 1 - base
            if st != 1:
                c -= 1
            steps += 1
        else:
            done = not inside(r, c)
        phases += 1
        cur, anchor = nxt, start
    if cols_out:
        align[torch.tensor(cols_out, device=align.device)] = torch.tensor(
            rows_out, dtype=torch.int32, device=align.device)
    return (align,
            torch.tensor([r + base, c + col0, state], dtype=torch.int32,
                         device=align.device),
            torch.tensor([steps, pred_moves, misses, phases],
                         dtype=torch.int32, device=align.device))


def sink_mask(g, order, N: int) -> np.ndarray:
    """(N,) bool: topo rows that are sinks of ``g``."""
    mask = np.zeros((N,), bool)
    mask[:len(order)] = np.isin(np.asarray(order, np.int64),
                                np.fromiter(g.sinks(), np.int64))
    return mask


def best_sink(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First-max argmax of the sink rows' scores, as a (1,) int32 tensor
    on the scores' device (no host sync)."""
    masked = torch.where(mask, scores, NEG)
    return torch.argmax(masked).to(torch.int32).reshape(1)


def pack_round(scores, align, best) -> torch.Tensor:
    """``[best, scores[best], align...]`` as one int32 tensor: the round's
    single device-to-host transfer."""
    return torch.cat([best, scores.index_select(0, best.long()), align])


class RoundClock:
    """Wall split of each round: host seconds for the tables (``prep_s``),
    the wait for the round's result (``wait_transfer_s``: the device work
    not yet done when the host asks, and the transfer) and the merge and
    toposort (``merge_s``); device milliseconds of the DP (``dp_ms``) and
    of the best sink, walk and packing (``walk_ms``), from CUDA events on
    the card or the host clock on the CPU.  A chunked round adds its plan
    (``NC``, ``chunks``, ``NWIN``, ``CW``), its counters (``remats``,
    ``cells_walked``) and names its two parts ``forward_ms`` (the DP
    chunks) and ``backward_ms`` (best sink, remats, walks and packing).
    ``rounds`` holds one dict per round."""

    _DEVICE_MARKS = ("dp0", "dp1", "walk1")

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.rounds: list = []
        self._host: dict = {}
        self._events: dict = {}
        self.chunked: dict = {}

    def mark(self, name: str) -> None:
        self._host[name] = time.perf_counter()
        if self.cuda and name in self._DEVICE_MARKS:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events[name] = ev

    def close(self) -> None:
        """After the round's merge: record its split and reset."""
        h, ev = self._host, self._events
        if self.cuda:
            dp = ev["dp0"].elapsed_time(ev["dp1"])
            walk = ev["dp1"].elapsed_time(ev["walk1"])
        else:
            dp = (h["dp1"] - h["dp0"]) * 1e3
            walk = (h["walk1"] - h["dp1"]) * 1e3
        rec = {"prep_s": h["dp0"] - h["start"], "dp_ms": dp,
               "walk_ms": walk, "wait_transfer_s": h["got"] - h["walk1"],
               "merge_s": h["end"] - h["got"]}
        if self.chunked:
            rec.update(self.chunked, forward_ms=dp, backward_ms=walk)
        self.rounds.append(rec)
        self._host, self._events, self.chunked = {}, {}, {}


def run_round(g, seq: bytes, params, dev: torch.device, kernel: str,
              budget: int, clock: RoundClock | None = None):
    """Dispatch one round of ``seq`` against ``g`` on the current stream.

    ``kernel``: "auto" runs the kernels on a CUDA device, "plain" the
    plain versions, "cuda" the kernels only.  A graph whose in-degree
    exceeds 64 takes the plain versions with wide words (the TPU path
    sends it to its scan engine); "cuda" refuses it.  A round the plan
    chunks runs through :func:`msa_chunked.round_chunked`, which reads
    12 bytes back per cell it walks.  Returns ``(packed, order, wide)``:
    the (2 + n,) int32 ``[best, score, align...]`` on the device, the
    topo order, and whether the round took the wide route."""
    from tsta_tpu_torch.ops.msa_native import round_dp_plain
    wide = g.max_in_degree() > MAX_IN
    if wide and kernel == "cuda":
        raise ValueError(
            "kernel='cuda': the round's in-degree %d exceeds the POA "
            "kernels' %d (use kernel='auto', which runs such rounds "
            "through the plain versions)" % (g.max_in_degree(), MAX_IN))
    use_kernel = dev.type == "cuda" and kernel != "plain" and not wide
    if clock:
        clock.mark("start")
    prep, n, n_real, a, NC, NWIN = prep_round(g, seq, params, budget,
                                              cap=not wide)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    if max_in > WIDE_MAX_IN:
        raise ValueError("in-degree %d exceeds the plain round's %d"
                         % (max_in, WIDE_MAX_IN))
    if NC is not None:
        from tsta_tpu_torch.ops import msa_chunked
        with profiling.span("msa round chunked"):
            packed = msa_chunked.round_chunked(g, prep, a, n_real, NC, NWIN,
                                               params, dev, use_kernel, clock)
        if clock:
            clock.mark("walk1")
        return packed, order, wide

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            dev, non_blocking=True)

    tables = (put(predsT), put(pmaskT), put(bases.reshape(N)), put(fills),
              put(a))
    preds_d = put(preds)
    mask = put(sink_mask(g, order, N))
    if clock:
        clock.mark("dp0")
    with profiling.span("msa round"):
        dp = poa_dp if use_kernel else round_dp_plain
        words, scores = dp(*tables, n_real, len(order), params, W)
        if clock:
            clock.mark("dp1")
        best = best_sink(scores, mask)
        if use_kernel:
            align = poa_walk(words, preds_d, best, n_real,
                             maxdist=max_pred_distance(preds))
        else:
            align = walk_plain(words, preds_d, best, n_real)
        packed = pack_round(scores, align, best)
    if clock:
        clock.mark("walk1")
    return packed, order, wide
