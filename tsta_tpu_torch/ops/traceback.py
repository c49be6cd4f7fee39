"""Traceback: host decoding and the packed-plane walk.

Counterpart of ``tsta_tpu/ops/traceback.py``.  Moves at cell (i, j)
with rows = b and columns = a:

* back == 1: diagonal (consume a[j] and b[i]);
* back == 0: left (consume a[j], gap in b);
* back == 2: up (consume b[i], gap in a).

The reference's walk rewrites the back plane to force a gap run to
continue through open/extend ties (psa/psa.c:450-459).  The rewritten
cell is always the next one visited, so a "forced move" carried from
step to step is the same thing; :func:`decode_step` holds that rule
once for the PyTorch walks, and ``csrc/psa_walk.cu`` mirrors it.

The device walk (:func:`walk_packed`) runs over the DP kernel's code
plane, (P, m_pad, n_pad) uint8 with one ``back*9 + f*3 + e`` code per
cell, and returns the moves packed 16 per int32 word (2 bits each,
LSB first) plus a count per pair, the wire format of the JAX package's
banded walk.  At P = 1 it is also the walk of a single round-1 pair
(``ops/psa_pallas.py``), the counterpart of ``_decode_moves_banded`` and
of its XLA fall-back ``_decode_moves``.  As the TPU walks stage a band of
the plane in SMEM, the kernels stage a window of it in shared memory
ahead of the walk (:func:`walk_window`, whose schedule
:func:`walk_staged_plain` replays), but any plane fits the window ring,
so there is neither the band's gate nor a fall-back.  With
``pair2=True`` and an even P it walks two pairs per thread, each from
its own window ring (``csrc/psa_walk_pair2.cu``, whose schedule
:func:`walk_pair2_staged_plain` replays), JAX's ``pair2`` walk: the same
moves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tsta_tpu_torch.ops import _kernels, psa_scan


class Alignment(NamedTuple):
    a_row: bytes   # aligned sequence a (columns; '>1' in reference output)
    b_row: bytes   # aligned sequence b (rows; '>2')


def decode_pair(back, fback, eback, a: np.ndarray,
                b: np.ndarray) -> Alignment:
    """Walk the three planes from (m-1, n-1) and emit the aligned pair
    (the reference's trace(), plane rewrites included)."""
    back = np.array(back, dtype=np.int8, copy=True)  # mutated during walk
    fback = np.asarray(fback)
    eback = np.asarray(eback)
    m, n = back.shape
    if a.shape[0] < n or b.shape[0] < m:
        raise ValueError("sequence shorter than traceback plane")
    i, j = m - 1, n - 1
    out_a = bytearray()
    out_b = bytearray()
    gap = ord("-")
    while i >= 0 and j >= 0:
        d = back[i, j]
        if d == 1:
            out_a.append(a[j])
            out_b.append(b[i])
            i -= 1
            j -= 1
        elif d == 0:
            fb = fback[i, j]
            if j - 1 >= 0 and (fb == 1 or fb == -1 or
                               ((fb == 2 or fb == -2) and fback[i, j - 1] < 0)):
                back[i, j - 1] = 0
            out_a.append(a[j])
            out_b.append(gap)
            j -= 1
        else:
            eb = eback[i, j]
            if i - 1 >= 0 and (eb == 1 or eb == -1 or
                               ((eb == 2 or eb == -2) and eback[i - 1, j] < 0)):
                back[i - 1, j] = 2
            out_a.append(gap)
            out_b.append(b[i])
            i -= 1
    while j >= 0:
        out_a.append(a[j])
        out_b.append(gap)
        j -= 1
    while i >= 0:
        out_a.append(gap)
        out_b.append(b[i])
        i -= 1
    out_a.reverse()
    out_b.reverse()
    return Alignment(bytes(out_a), bytes(out_b))


def score_alignment(a_row: bytes, b_row: bytes, params) -> int:
    """Re-score an emitted alignment: matches/mismatches plus
    ``O + k*E`` per gap run, boundary gaps included."""
    m_, x_, e_, o_ = (params.match, params.mismatch, params.gap_extend,
                      params.gap_open)
    score = 0
    in_gap_a = in_gap_b = False
    for ca, cb in zip(a_row, b_row):
        ga, gb = ca == ord("-"), cb == ord("-")
        if ga and gb:
            raise ValueError("gap aligned to gap")
        if ga:
            score += e_ + (0 if in_gap_a else o_)
            in_gap_a, in_gap_b = True, False
        elif gb:
            score += e_ + (0 if in_gap_b else o_)
            in_gap_a, in_gap_b = False, True
        else:
            score += m_ if ca == cb else x_
            in_gap_a = in_gap_b = False
    return score


def decode_step(in_core, i, j, forced, code, fprev, eprev):
    """The walk's move and gap-run rules on (P,) tensors: given the
    current cell's code, the f-code of the cell to its left and the
    e-code of the cell above, return (move, forced_next)."""
    back = code // 9
    f = (code // 3) % 3   # 0 extend, 1 open, 2 open-tie
    e = code % 3
    move = torch.where(in_core,
                       torch.where(forced > 0, forced - 1, back),
                       torch.where(j >= 0, 0, 2))
    # extend (code 0) always continues the gap run; an open (1 or 2)
    # continues iff the entered cell carries the tie mark (code 2)
    force_left = (move == 0) & (j - 1 >= 0) & ((f == 0) | (fprev == 2))
    force_up = (move == 2) & (i - 1 >= 0) & ((e == 0) | (eprev == 2))
    forced_next = torch.where(
        in_core, torch.where(force_left, 1, torch.where(force_up, 3, 0)),
        0)
    return move, forced_next


def emit_alignment(moves: np.ndarray, a: np.ndarray, b: np.ndarray,
                   n: int, m: int) -> Alignment:
    """Move list -> aligned strings (moves run backwards from the
    alignment end; 1 diag, 0 left/gap-in-b, 2 up/gap-in-a)."""
    gap = ord("-")
    ca = moves != 2                      # consumes a
    cb = moves != 0                      # consumes b
    ai = n - 1 - (np.cumsum(ca) - ca)    # exclusive prefix
    bi = m - 1 - (np.cumsum(cb) - cb)
    out_a = np.where(ca, a[np.clip(ai, 0, n - 1)], gap).astype(np.uint8)
    out_b = np.where(cb, b[np.clip(bi, 0, m - 1)], gap).astype(np.uint8)
    return Alignment(out_a[::-1].tobytes(), out_b[::-1].tobytes())


def packed_words_len(maxlen: int) -> int:
    """Words in a packed 2-bit move row of up to ``maxlen`` moves (+1
    slack word for the unconditional tail flush)."""
    return (maxlen + 15) // 16 + 1


def pack_moves_words(moves: torch.Tensor) -> torch.Tensor:
    """(P, L) moves -> (P, packed_words_len(L)) int32, 16 moves of 2 bits
    per word, LSB first."""
    P, L = moves.shape
    W = packed_words_len(L)
    m = torch.zeros((P, W * 16), dtype=torch.int64, device=moves.device)
    m[:, :L] = moves.to(torch.int64)
    sh = 2 * torch.arange(16, dtype=torch.int64, device=moves.device)
    w = (m.view(P, W, 16) << sh).sum(dim=2)
    # the top move lands in bit 31: wrap to the two's-complement int32
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_moves(words, count) -> np.ndarray:
    """One pair's packed int32 move words -> (count,) int8 moves."""
    w = np.asarray(words, np.int32)[: (int(count) + 15) // 16]
    w = w.view(np.uint32)
    m = (w[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    return m.reshape(-1)[: int(count)].astype(np.int8)


def _check_walk_args(plane: torch.Tensor, nm: torch.Tensor):
    if plane.dtype != torch.uint8 or plane.dim() != 3:
        raise ValueError("plane must be (P, m_pad, n_pad) uint8, got %s %s"
                         % (tuple(plane.shape), plane.dtype))
    P, m_pad, n_pad = plane.shape
    if nm.dtype != torch.int32 or tuple(nm.shape) != (P, 2):
        raise ValueError("nm must be (%d, 2) int32, got %s %s"
                         % (P, tuple(nm.shape), nm.dtype))
    if nm.device != plane.device:
        raise ValueError("plane and nm on different devices (%s, %s)"
                         % (plane.device, nm.device))
    if not (plane.is_contiguous() and nm.is_contiguous()):
        raise ValueError("plane and nm must be contiguous")
    return P, m_pad, n_pad


@torch.no_grad()
def walk_packed_plain(plane: torch.Tensor, nm: torch.Tensor):
    """Lockstep P-pair walk in PyTorch: the plain version of the walk
    kernel and the counterpart of the JAX package's
    ``_decode_moves_packed``.

    ``plane``: (P, m_pad, n_pad) uint8 cell codes; ``nm``: (P, 2) int32
    real lengths (n, m).  Every pair walks from (m-1, n-1) until both i
    and j are below 0; finished pairs stand still and park their writes
    in a dump slot.  Returns (words, counts): (P, packed_words_len(
    m_pad + n_pad)) int32 and (P,) int32.
    """
    P, m_pad, n_pad = _check_walk_args(plane, nm)
    dev = plane.device
    if dev.type == "cuda":
        psa_scan.plain_calls += 1
    maxlen = m_pad + n_pad
    flat = plane.reshape(-1)
    base = torch.arange(P, device=dev, dtype=torch.int64) * (m_pad * n_pad)
    pidx = torch.arange(P, device=dev)
    i = nm[:, 1].to(torch.int64) - 1
    j = nm[:, 0].to(torch.int64) - 1
    t = torch.zeros(P, dtype=torch.int64, device=dev)
    forced = torch.zeros(P, dtype=torch.int64, device=dev)
    moves = torch.zeros((P, maxlen + 1), dtype=torch.int8, device=dev)
    for step in range(maxlen):
        active = (i >= 0) | (j >= 0)
        if step % 64 == 0 and not bool(active.any()):
            break
        in_core = (i >= 0) & (j >= 0)
        i0 = i.clamp(min=0)
        j0 = j.clamp(min=0)
        idx = torch.cat([base + i0 * n_pad + j0,
                         base + i0 * n_pad + (j - 1).clamp(min=0),
                         base + (i - 1).clamp(min=0) * n_pad + j0])
        v = flat[idx].to(torch.int64)
        code = torch.where(in_core, v[:P], 0)
        fprev = torch.where(j > 0, (v[P:2 * P] // 3) % 3, 0)
        eprev = torch.where(i > 0, v[2 * P:] % 3, 0)
        move, forced = decode_step(in_core, i, j, forced, code, fprev, eprev)
        moves[pidx, torch.where(active, t, maxlen)] = move.to(torch.int8)
        step_on = active.to(torch.int64)
        i = i - torch.where(move == 0, 0, 1) * step_on
        j = j - torch.where(move == 2, 0, 1) * step_on
        t = t + step_on
    return pack_moves_words(moves[:, :maxlen]), t.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _step_table():
    """:func:`decode_step` at every input it tells apart, as two numpy
    tables (move, forced_next) indexed [in_core, i > 0, j + 1 (j in -1,
    0, >= 1), forced (0..3), code (0..26), fprev, eprev]: one vectorised
    call, so a one-pair walk in Python keeps the rules in one place and
    costs a lookup per step."""
    axes = [torch.arange(k, dtype=torch.int64) for k in (2, 2, 3, 4, 27, 3,
                                                          3)]
    in_core, i, j, forced, code, fprev, eprev = (
        g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij"))
    move, nxt = decode_step(in_core.bool(), i, j - 1, forced, code, fprev,
                            eprev)
    shape = [len(x) for x in axes]
    return move.reshape(shape).numpy(), nxt.reshape(shape).numpy()


@torch.no_grad()
def walk_bounded_plain(plane: torch.Tensor, prev_row: torch.Tensor,
                       base: int, i: int, j: int, t: int, forced: int,
                       moves: torch.Tensor) -> torch.Tensor:
    """The walk inside one row-chunk of a pair's code plane, step by step
    on :func:`decode_step`: the plain version of
    ``csrc/psa_walk_bounded.cu`` and the counterpart of the JAX package's
    ``_decode_moves_bounded``.

    ``plane``: (rows, n_pad) uint8 codes of the pair's rows [base, base +
    rows); ``prev_row``: (n_pad,) uint8 codes of row base - 1 (zeros at
    base 0).  Walks from (i, j) with ``t`` moves made and ``forced``
    carried until i < base, or, at base 0, until i < 0 and j < 0; writes
    move t' to ``moves[t']`` ((L,) int8).  Returns (i, j, t, forced) as a
    (4,) int32 tensor on ``moves``' device."""
    if plane.device.type == "cuda":
        psa_scan.plain_calls += 1
    codes = plane.cpu().numpy()
    above = prev_row.cpu().numpy()
    step_move, step_next = _step_table()
    out = []
    while (i >= 0 or j >= 0) and (i >= base or (base == 0 and j >= 0)):
        in_core = i >= 0 and j >= 0
        code = fprev = eprev = 0
        if in_core:
            row = codes[i - base]
            code = int(row[j])
            fprev = int(row[j - 1]) // 3 % 3 if j > 0 else 0
            if i > 0:
                eprev = int(codes[i - 1 - base, j] if i > base
                            else above[j]) % 3
        key = (int(in_core), int(i > 0), min(j, 1) + 1, forced, code, fprev,
               eprev)
        move, forced = int(step_move[key]), int(step_next[key])
        out.append(move)
        i -= move != 0
        j -= move != 2
    if out:
        moves[t:t + len(out)] = torch.tensor(out, dtype=torch.int8)
    return torch.tensor([i, j, t + len(out), forced], dtype=torch.int32,
                        device=moves.device)


def walk_window(i0: int, j0: int, S: int, row_lo: int, rows: int,
                n_pad: int) -> tuple:
    """The plane a walk's window stages, anchored at (i0, j0): rows [r0,
    r1) and columns [c0, c1), clipped to the plane's rows [row_lo, row_lo
    + rows) (the chunk's, for the bounded walk) and to [0, n_pad).

    The 2S steps after (i0, j0) read only rows [i0 - 2S, i0] and columns
    [j0 - 2S, j0], since each step lowers i, j or both by one; the window
    is those rows, slot 0 being row i0 - 2S, by 2S + 16 columns from c0,
    j0 - 2S aligned down to 16 (16-byte copies).  Empty (r1 == r0) when
    the anchor is outside the matrix, where a walk reads nothing.  The
    rule of ``csrc/psa_walk_stage.cuh``'s ``walk_window``."""
    r0 = max(i0 - 2 * S, row_lo)
    r1 = max(r0, min(i0 + 1, row_lo + rows)) if j0 >= 0 else r0
    c0 = max(j0 - 2 * S, 0) // 16 * 16
    return r0, r1, c0, min(c0 + 2 * S + 16, n_pad)


@torch.no_grad()
def walk_staged_plain(plane: torch.Tensor, prev_row: torch.Tensor,
                      base: int, i: int, j: int, t: int, forced: int,
                      moves: torch.Tensor, S: int) -> torch.Tensor:
    """:func:`walk_bounded_plain`'s walk, replayed on the schedule of the
    walk kernels' window ring (``csrc/psa_walk_stage.cuh``): phases of at
    most S steps in the matrix, phase k reading only the window anchored
    at where phase k - 1 began (phase 0's at the entry), staged with
    :func:`walk_window`; the row above a chunk (row ``base`` - 1) comes
    from ``prev_row`` into its slot.  Once outside the matrix the walk
    reads nothing and runs to its end.  Raises AssertionError on a read
    outside the window; at base 0 over a whole plane it is the walk of
    :func:`walk_packed_plain`.  Same arguments and result as
    :func:`walk_bounded_plain`, plus ``S``.  Reads only the windows, so
    a plane on the card is never copied whole."""
    if plane.device.type == "cuda":
        psa_scan.plain_calls += 1
    rows, n_pad = plane.shape
    step_move, step_next = _step_table()
    width = 2 * S + 16

    def stage(i0, j0):
        r0, r1, c0, c1 = walk_window(i0, j0, S, base, rows, n_pad)
        win = np.full((2 * S + 1, width), -1, np.int16)   # -1: not staged
        ra = i0 - 2 * S
        if r1 > r0:
            win[r0 - ra:r1 - ra, :c1 - c0] = plane[
                r0 - base:r1 - base, c0:c1].cpu().numpy()
            if base > 0 and r0 == base and ra <= base - 1:
                win[base - 1 - ra, :c1 - c0] = prev_row[c0:c1].cpu().numpy()
        return win, ra, c0

    def read(window, r, c):
        win, ra, c0 = window
        assert 0 <= r - ra < win.shape[0] and 0 <= c - c0 < width and \
            win[r - ra, c - c0] >= 0, \
            "read of (%d, %d) outside the window at row %d, column %d" % (
                r, c, ra, c0)
        return int(win[r - ra, c - c0])

    def cont(i, j):
        return (i >= 0 or j >= 0) and (i >= base or (base == 0 and j >= 0))

    out = []
    cur = stage(i, j)
    done = False
    while not done:
        nxt = stage(i, j)   # the loaders' window for the next phase
        for _ in range(S):
            if not cont(i, j):
                done = True
                break
            if i < 0 or j < 0:   # outside the matrix: no reads, to the end
                while cont(i, j):
                    move = 0 if j >= 0 else 2
                    out.append(move)
                    i -= move != 0
                    j -= move != 2
                forced, done = 0, True
                break
            code = read(cur, i, j)
            fprev = read(cur, i, j - 1) // 3 % 3 if j > 0 else 0
            eprev = read(cur, i - 1, j) % 3 if i > 0 else 0
            key = (1, int(i > 0), min(j, 1) + 1, forced, code, fprev, eprev)
            move, forced = int(step_move[key]), int(step_next[key])
            out.append(move)
            i -= move != 0
            j -= move != 2
        else:
            done = not cont(i, j)
        cur = nxt
    if out:
        moves[t:t + len(out)] = torch.tensor(out, dtype=torch.int8)
    return torch.tensor([i, j, t + len(out), forced], dtype=torch.int32,
                        device=moves.device)


class _Pair2Walk:
    """One pair of the two-pair walk kernel, as its walker thread and its
    loaders see it (``csrc/psa_walk_pair2.cu``): the walk's state (i, j,
    t, forced), its cell's offset ``off`` in the current window, and its
    part of shared memory, a guard and two windows, as two arrays: the
    flat plane index a byte was staged from (-1: not staged by the
    window it lies in) and its code."""

    def __init__(self, plane, n, m, S, reach):
        self.plane, self.S, self.reach = plane, S, reach
        self.W = 2 * S + 16
        self.win = (2 * S + 1) * self.W
        self.guard = _kernels.pair2_guard(S)
        size = self.guard + 2 * self.win
        self.src = np.full(size, -1, np.int64)
        self.val = np.zeros(size, np.int64)
        self.i, self.j, self.t, self.forced = m - 1, n - 1, 0, 0
        self.moves = []
        self.ai, self.aj = self.i, self.j   # the current window's anchor

    def in_core(self):
        return self.i >= 0 and self.j >= 0

    def more(self):
        return self.i >= 0 or self.j >= 0

    def stage(self, b, i0, j0):
        """The loaders' copies of the window anchored at (i0, j0) into
        window b (``pair_stage``): rows [i0 - 2S, i0] from slot 0, columns
        from ``walk_window``'s c0; the rest of the window not staged."""
        m_pad, n_pad = self.plane.shape
        at = self.guard + b * self.win
        self.src[at:at + self.win] = -1
        r0, r1, c0, c1 = walk_window(i0, j0, self.S, 0, m_pad, n_pad)
        if r1 <= r0:
            return
        rows = np.arange(r0, r1)[:, None]
        cols = np.arange(c0, c1)[None, :]
        dst = at + (rows - (i0 - 2 * self.S)) * self.W + (cols - c0)
        self.src[dst] = rows * n_pad + cols
        self.val[dst] = self.plane[r0:r1, c0:c1].cpu().numpy()

    def begin(self, cur):
        """The walker's view of window ``cur`` for a phase: its start, its
        slot 0's row and column 0's plane column, and ``off``, the walk's
        cell."""
        self.at = self.guard + cur * self.win
        self.ra = self.ai - 2 * self.S
        self.c0 = max(self.aj - 2 * self.S, 0) // 16 * 16
        self.off = (self.i - self.ra) * self.W + (self.j - self.c0)

    def read(self, off, cell=None):
        """The byte at ``off`` in the current window: within the window or
        the guard before it, else AssertionError.  ``cell``: the plane
        cell (i, j) whose code the walk needs there, which the window must
        hold; else None (any byte)."""
        self.reach[0] = min(self.reach[0], off)
        self.reach[1] = max(self.reach[1], off)
        assert -self.guard <= off < self.win, \
            "read at %d outside the window (and its guard of %d) at row " \
            "%d, column %d" % (off, self.guard, self.ra, self.c0)
        if cell is None:
            return None
        n_pad = self.plane.shape[1]
        assert self.src[self.at + off] == cell[0] * n_pad + cell[1], \
            "read of %s outside the window at row %d, column %d" % (
                cell, self.ra, self.c0)
        return int(self.val[self.at + off])

    def step(self, masked, rules):
        """One step of ``chain_step``: the three reads, then, in the
        matrix, the move, the next forced move and the offset's step, held
        to :func:`decode_step`'s; a code read past the matrix's edge (i or
        j 0) taken as any byte.  Outside the matrix (``masked``) the reads
        are issued and nothing changes."""
        i, j, W = self.i, self.j, self.W
        if not self.in_core():
            assert masked, "an unmasked step outside the matrix"
            for d in (0, 1, W):
                self.read(self.off - d)
            return
        c = self.read(self.off, (i, j))
        l = self.read(self.off - 1, (i, j - 1) if j > 0 else None)
        u = self.read(self.off - W, (i - 1, j) if i > 0 else None)
        step_move, step_next, f0, f2, e0, e2 = rules
        key = (1, int(i > 0), min(j, 1) + 1, self.forced, c,
               l // 3 % 3 if j > 0 else 0, u % 3 if i > 0 else 0)
        move, nxt = int(step_move[key]), int(step_next[key])
        assert move == (self.forced - 1 if self.forced else c // 9)
        # the kernel's next forced move: bit ``move`` of the rules' union,
        # over every byte an edge read may hold
        ls = np.arange(256) if l is None else np.array([l])
        us = np.arange(256) if u is None else np.array([u])
        go = (((f0 >> c) | (f2 >> (ls[:, None] & 31))) & 1) | \
            (((e0 << 2 >> c) | (e2 << 2 >> (us[None, :] & 31))) & 4)
        forced = set(((go >> move) & 1).ravel().tolist())
        self.moves.append(move)
        self.i -= move != 0
        self.j -= move != 2
        self.t += 1
        self.off -= (1, W + 1, W)[move]
        if self.in_core():   # the next forced move is read only here
            assert forced == {int(nxt > 0)}, (i, j, forced, nxt)
        self.forced = nxt

    def tail(self):
        """Outside the matrix: left, then up, to the end (``run_tail``)."""
        while self.more():
            move = 0 if self.j >= 0 else 2
            self.moves.append(move)
            self.i -= move != 0
            self.j -= move != 2
            self.t += 1
        self.forced = 0


def _pair2_phase(walks, S, rules):
    """``chains_phase`` of the walks that begin it inside the matrix: the
    steps each is sure to take inside it (the least of their i and j,
    down to a multiple of 16) unmasked, i and j then read back off the
    offset; the rest of the phase masked, 4 steps of each a body, until
    every walk has left the matrix; then the tail of each that left."""
    fast = min(S, *(min(w.i, w.j) for w in walks))
    fast -= fast % 16
    for _ in range(fast):
        for w in walks:
            w.step(False, rules)
    for w in walks:
        rel = w.off
        assert rel >= 0 and (w.i, w.j) == (w.ra + rel // w.W,
                                          w.c0 + rel % w.W)
    for _ in range(fast, S, 4):
        for _ in range(4):
            for w in walks:
                w.step(True, rules)
        if not any(w.in_core() for w in walks):
            break
    for w in walks:
        if not w.in_core() and w.more():
            w.tail()


@torch.no_grad()
def walk_pair2_staged_plain(plane: torch.Tensor, nm: torch.Tensor, S: int,
                            phases: list | None = None,
                            reach: list | None = None):
    """The two-pair walk kernel (``csrc/psa_walk_pair2.cu``) emulated read
    by read.  Block q walks pairs 2q and 2q + 1; each pair has its part
    of shared memory, a guard of ``_kernels.pair2_guard(S)`` bytes and two
    windows.  Before phase 0 the loaders stage each pair's window at its
    entry; in phase k they stage window (k + 1) % 2 anchored where the
    pair's phase k began, and the walker reads window k % 2, anchored
    where its phase k - 1 began.  A phase that both pairs begin inside
    the matrix steps both (:func:`_pair2_phase`); else each that is
    inside alone, and a pair that begins outside runs its tail.  Every
    read the kernel issues is checked: the three of each step, inside
    the matrix or not (a pair that left it issues its reads at its exit
    cell until the phase ends), each within its pair's current window or
    the guard before it; a code a move depends on from that window, the
    right cell, staged by this phase's anchor; the kernel's move and
    next forced move (its branch-free rules, a read past the matrix's
    edge any byte) equal to :func:`decode_step`'s.  Raises AssertionError
    where one is not.  ``plane`` and ``nm`` as :func:`walk_packed_plain`,
    P even; returns its (words, counts).  ``phases``, when given, gets
    each block's phase count; ``reach``, a list [lo, hi], the lowest and
    highest read offset from a window's start."""
    P, m_pad, n_pad = _check_walk_args(plane, nm)
    if P < 2 or P % 2:
        raise ValueError("the two-pair walk takes an even number of pairs, "
                         "got %d" % P)
    if plane.device.type == "cuda":
        psa_scan.plain_calls += 1
    step_move, step_next = _step_table()
    # the kernel's step masks (walk_step_masks), read off the same rules
    codes = range(27)
    rules = (step_move, step_next,
             sum(int(step_next[1, 1, 2, 1, c, 0, 0] == 1) << c for c in codes),
             sum(int(step_next[1, 1, 2, 1, 3, c // 3 % 3, 0] == 1) << c
                 for c in codes),
             sum(int(step_next[1, 1, 2, 3, c, 0, 0] == 3) << c for c in codes),
             sum(int(step_next[1, 1, 2, 3, 1, 0, c % 3] == 3) << c
                 for c in codes))
    reach = [0, 0] if reach is None else reach
    moves = torch.zeros((P, m_pad + n_pad), dtype=torch.int8)
    counts = []
    for q in range(P // 2):
        walks = [_Pair2Walk(plane[2 * q + x], *(int(v) for v in nm[2 * q + x]),
                            S, reach) for x in range(2)]
        for w in walks:
            w.stage(0, w.i, w.j)
        k = 0
        while True:
            starts = [(w.i, w.j) for w in walks]   # where phase k begins
            for w, (i0, j0) in zip(walks, starts):   # the loaders
                w.stage((k + 1) % 2, i0, j0)
            for w in walks:
                w.begin(k % 2)
            if all(w.in_core() for w in walks):
                _pair2_phase(walks, S, rules)
            else:
                for w in walks:
                    if w.in_core():
                        _pair2_phase([w], S, rules)
                    elif w.more():
                        w.tail()
            for w, (i0, j0) in zip(walks, starts):
                w.ai, w.aj = i0, j0
            k += 1
            if not any(w.more() for w in walks):
                break
        if phases is not None:
            phases.append(k)
        for x, w in enumerate(walks):
            assert (w.i, w.j, w.t) == (-1, -1, len(w.moves))
            counts.append(w.t)
            if w.moves:
                moves[2 * q + x, :w.t] = torch.tensor(w.moves,
                                                      dtype=torch.int8)
    return pack_moves_words(moves), torch.tensor(counts, dtype=torch.int32)


def walk_bounded(plane: torch.Tensor, prev_row: torch.Tensor, base: int,
                 i: int, j: int, t: int, forced: int,
                 moves: torch.Tensor, S: int | None = None) -> torch.Tensor:
    """:func:`walk_bounded_plain`'s function: a CPU plane takes it; a
    CUDA plane launches ``csrc/psa_walk_bounded.cu`` (one block on the
    window ring, ``S`` steps a phase: ``_kernels.WALK_S`` unless forced)
    or raises.  Returns the (4,) int32 exit state on the device, the
    host's one 16-byte read per chunk."""
    if plane.device.type == "cpu":
        if S is not None:
            raise ValueError("S is the kernel's phase length; a CPU plane "
                             "takes the plain walk")
        return walk_bounded_plain(plane, prev_row, base, i, j, t, forced,
                                  moves)
    out = torch.empty((4,), dtype=torch.int32, device=plane.device)
    _kernels.psa_walk_bounded(plane, prev_row, base, i, j, t, forced, moves,
                              out, S=S)
    return out


def uses_pair2(P: int, pair2: bool) -> bool:
    """Whether :func:`walk_packed` takes the two-pair walk: asked for, and
    P even and >= 2 (the JAX package's gate, ``traceback.py:1073``)."""
    return bool(pair2) and P >= 2 and P % 2 == 0


def walk_packed(plane: torch.Tensor, nm: torch.Tensor, pair2: bool = False,
                S: int | None = None, threads: int | None = None):
    """Walk every pair of a code plane; same contract as
    :func:`walk_packed_plain`.  A CPU plane takes the plain version; a
    CUDA plane launches ``csrc/psa_walk.cu`` (one block per pair on the
    window ring, ``S`` steps a phase and ``threads`` a block:
    ``_kernels.psa_walk_layout``'s plan for P pairs unless forced), or
    with ``pair2`` under :func:`uses_pair2`'s gate ``csrc/psa_walk_pair2.cu``
    (one block and one walker thread per two pairs, each pair on its own
    window ring; ``S`` and ``threads`` K3's plan unless forced; the
    counterpart of
    JAX's ``_decode_moves_banded_packed(pair2=True)``), and raises if the
    kernel cannot be built or launched.  Pairing is scheduling only: the plain
    version already walks every pair in one lockstep loop."""
    P, m_pad, n_pad = _check_walk_args(plane, nm)
    if plane.device.type == "cpu":
        if S is not None or threads is not None:
            raise ValueError("S and threads are the kernel's; a CPU plane "
                             "takes the plain walk")
        return walk_packed_plain(plane, nm)
    if plane.device.type != "cuda":
        raise ValueError("walk_packed: unsupported device %s" % plane.device)
    n_words = packed_words_len(m_pad + n_pad)
    words = torch.empty((P, n_words), dtype=torch.int32, device=plane.device)
    counts = torch.empty((P,), dtype=torch.int32, device=plane.device)
    if uses_pair2(P, pair2):
        _kernels.psa_walk_pair2(plane, nm, words, counts, S=S,
                                threads=threads)
    else:
        _kernels.psa_walk(plane, nm, words, counts, S=S, threads=threads)
    return words, counts
