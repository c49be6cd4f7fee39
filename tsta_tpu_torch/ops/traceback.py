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
of its XLA fall-back ``_decode_moves``: it reads the plane from global
memory, so it has neither the band's gate nor a fall-back.  With
``pair2=True`` and an even P it walks two pairs per thread
(``csrc/psa_walk_pair2.cu``), JAX's ``pair2`` walk: the same moves.
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


def walk_bounded(plane: torch.Tensor, prev_row: torch.Tensor, base: int,
                 i: int, j: int, t: int, forced: int,
                 moves: torch.Tensor) -> torch.Tensor:
    """:func:`walk_bounded_plain`'s function: a CPU plane takes it; a
    CUDA plane launches ``csrc/psa_walk_bounded.cu`` (one thread) or
    raises.  Returns the (4,) int32 exit state on the device, the host's
    one 16-byte read per chunk."""
    if plane.device.type == "cpu":
        return walk_bounded_plain(plane, prev_row, base, i, j, t, forced,
                                  moves)
    out = torch.empty((4,), dtype=torch.int32, device=plane.device)
    _kernels.psa_walk_bounded(plane, prev_row, base, i, j, t, forced, moves,
                              out)
    return out


def uses_pair2(P: int, pair2: bool) -> bool:
    """Whether :func:`walk_packed` takes the two-pair walk: asked for, and
    P even and >= 2 (the JAX package's gate, ``traceback.py:1073``)."""
    return bool(pair2) and P >= 2 and P % 2 == 0


def walk_packed(plane: torch.Tensor, nm: torch.Tensor, pair2: bool = False):
    """Walk every pair of a code plane; same contract as
    :func:`walk_packed_plain`.  A CPU plane takes the plain version; a
    CUDA plane launches ``csrc/psa_walk.cu`` (one thread per pair), or
    with ``pair2`` under :func:`uses_pair2`'s gate ``csrc/psa_walk_pair2.cu``
    (one thread per two pairs; the counterpart of JAX's
    ``_decode_moves_banded_packed(pair2=True)``), and raises if the kernel
    cannot be built or launched.  Pairing is scheduling only: the plain
    version already walks every pair in one lockstep loop."""
    P, m_pad, n_pad = _check_walk_args(plane, nm)
    if plane.device.type == "cpu":
        return walk_packed_plain(plane, nm)
    if plane.device.type != "cuda":
        raise ValueError("walk_packed: unsupported device %s" % plane.device)
    n_words = packed_words_len(m_pad + n_pad)
    words = torch.empty((P, n_words), dtype=torch.int32, device=plane.device)
    counts = torch.empty((P,), dtype=torch.int32, device=plane.device)
    launch = _kernels.psa_walk_pair2 if uses_pair2(P, pair2) else \
        _kernels.psa_walk
    launch(plane, nm, words, counts)
    return words, counts
