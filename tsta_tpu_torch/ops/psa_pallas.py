"""Round-1 PSA: the kernels for every parameter set with X < 0, E < 0 and
O <= 0 (any M), and the two routers.

Counterpart of the round-1 half of ``tsta_tpu/ops/psa_pallas.py``.  The
JAX package runs its round-1 Pallas kernels for the sets its guard
(:func:`_traced_params`) takes, and its routers send the sets the packed
kernels take (``psa_diff.supports_params``, M > 0) there instead:

* Q2-13 ``_kernel`` (:func:`psa_align`, :func:`dp_pair`): one pair, n
  padded to LANES and m to T_R.  Score-only it is ``csrc/psa_dp.cu``'s K1
  at P = 1 over the pair's real extent; traced, ``csrc/psa_dp_traced.cu``
  at P = 1 (each body cuts the pair's columns into D shards over
  co-resident blocks) over every
  padded cell, so the (m_pad, n_pad) code plane equals the JAX kernel's
  byte for byte, padding included.  The JAX kernel's last H row is read
  by no caller, and is not produced here.
* Q2-14 ``_batch_kernel`` (:func:`psa_align_batch` for one pair or pairs
  wider than PACK_RMAX segments): K1 over the batch.
* Q2-15 ``_packed_kernel`` (:func:`psa_align_batch_packed`):
  ``csrc/psa_dp_short.cu``, a lane wavefront, one warp a pair at the strip
  width :func:`short_width` picks, pairs taken longest first
  (:func:`dp_short_wavefront` replays its schedule on the CPU).  JAX's
  PACK_SUBS (96 sublanes, P = 96 // Rp pairs per tile) has no
  counterpart.
* Q2-16 ``traceback._walk_kernel`` (through :func:`_traced_chain`):
  ``traceback.walk_packed`` at P = 1, ``csrc/psa_walk.cu``.

The traced chain is JAX's ``_traced_submit``, ``_traced_finish`` and
``_traced_chain`` in one function: one DP launch, one walk launch and one
read of score, corner, count and move words.  A pair whose plane is over
half the device budget runs in row-chunks (``ops/psa_chunked.py``).

These kernels give the JAX kernels' results for any M: a pad byte never
matches, so every move into padding lowers the score (X < 0, E < 0, O + E
< 0), and padded cells neither raise the max nor reach a real cell.
"""

from __future__ import annotations

import numpy as np
import torch

from tsta_tpu_torch.device import device_budget, resolve_device
from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan
from tsta_tpu_torch.ops import traceback as tb
from tsta_tpu_torch.ops.psa_diff import LANES, T_R
from tsta_tpu_torch.ops.psa_scan import PsaResult, as_params

PACK_RMAX = 16   # pairs of at most this many 128-column segments are short
# csrc/psa_dp_short.cu's plan: lanes a warp, the strip widths it is built
# for, and its cost model per lane (x2): a cell, and a step's fixed cost
SHORT_LANES = 32
SHORT_WIDTHS = (2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32)
SHORT_CELL_COST, SHORT_STEP_COST = 13, 40


def in_round1_domain(params) -> bool:
    """Whether the round-1 kernels take ``params``: X < 0, E < 0, O <= 0."""
    p = as_params(params)
    return p[1] < 0 and p[2] < 0 and p[3] <= 0


def _traced_params(params) -> tuple:
    """The JAX package's guard: ``params`` as a tuple, or ValueError."""
    p = as_params(params)
    if not in_round1_domain(p):
        raise ValueError("pallas kernel requires mismatch < 0, gap_extend"
                         " < 0 and gap_open <= 0 (got %s)" % (p,))
    return p


def dp_pair(a: np.ndarray, b: np.ndarray, params, traced: bool = False,
            device=None):
    """One pair through the DP at round-1 padding (``_psa_pallas``):
    returns ((1,) int32 score, (1,) int32 corner, the (m_pad, n_pad) uint8
    code plane or None, and the (1, 2) int32 real lengths), all on the
    device."""
    p = _traced_params(params)
    ta, tb_, nm = psa_diff.pack_pairs([(a, b)], resolve_device(device))
    out = psa_diff.run_dp(ta, tb_, nm, p, traced)
    return out[0], out[1], out[2][0] if traced else None, nm


def psa_align(a, b, params, traced: bool = False, device=None) -> PsaResult:
    """Q2-13 on one pair, the contract of ``psa_scan.psa_align``: the
    score and corner, and traced the three int8 traceback planes
    (``psa_scan.planes_from_codes``, JAX's ``_F_DECODE``) of the real
    cells, on ``device``."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    score, corner, plane, _ = dp_pair(a, b, params, traced, device)
    score, corner = torch.cat([score, corner]).tolist()
    if not traced:
        return PsaResult(score, corner)
    planes = psa_scan.planes_from_codes(plane[:b.shape[0], :a.shape[0]])
    return PsaResult(score, corner, *planes)


def dp_short(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor,
             params):
    """The short-pair DP over B padded pairs, score-only: (scores,
    corners) as (B,) int32.  ``a``: (B, n_pad) uint8 with n_pad <=
    ``_kernels.SHORT_MAX_N``, ``b``: (B, m_pad) uint8, ``lens``: (B, 2) int32
    real (n, m).  A CPU tensor takes the plain version
    (``psa_scan.scan_rows``); a CUDA tensor launches
    ``csrc/psa_dp_short.cu`` or raises."""
    p = _traced_params(params)
    if a.device.type == "cpu":
        return psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], p)[:2]
    B = a.shape[0]
    score = torch.empty((B,), dtype=torch.int32, device=a.device)
    corner = torch.empty((B,), dtype=torch.int32, device=a.device)
    _kernels.psa_dp_short(a, b, lens, p, score, corner)
    return score, corner


def short_cost(n: int, m: int, w: int, lanes: int = SHORT_LANES) -> int:
    """The modelled cost of an n x m pair at strips of ``w`` columns: its
    steps (m + L - 1 a tile of L lanes) times a step's cost."""
    tile = lanes * w
    tiles = -(-n // tile)
    last = -(-(n - (tiles - 1) * tile) // w)
    return (((tiles - 1) * (m + lanes - 1) + m + last - 1)
            * (SHORT_CELL_COST * w + SHORT_STEP_COST))


def short_width(n: int, m: int, lanes: int = SHORT_LANES,
                widths=SHORT_WIDTHS) -> int:
    """The strip width ``csrc/psa_dp_short.cu`` runs an n x m pair at: the
    least :func:`short_cost` among ``widths``, the narrowest on a tie (the
    library's ``tsta_psa_dp_short_width``)."""
    if n < 1 or m < 1:
        return widths[0]
    return min((short_cost(n, m, w, lanes), w) for w in widths)[1]


def short_plan(lens) -> dict:
    """The short-pair kernel's plan over a batch: {strip width: pairs}."""
    ws = [short_width(int(n), int(m)) for n, m in np.asarray(
        torch.as_tensor(lens).cpu())]
    return {w: ws.count(w) for w in sorted(set(ws))}


def _short_columns(ap: np.ndarray, j: np.ndarray, n: np.ndarray, o: int,
                   e: int):
    """A tile's strips for P pairs before row 0: (column bytes, H~(-1, j),
    E~(0, j)), each (P, lanes, W), from ``ap`` (P, n_stride) bytes, the
    tile's columns ``j`` (lanes, W) and the real widths ``n``.  Past n the
    byte is -1 (it matches none); from column n - 1 on the top edge is NEG,
    since it serves only as the next column's diagonal at row 0, and into
    padding that keeps every cell below the pair's real maximum."""
    P = len(ap)
    idx = np.minimum(j, ap.shape[1] - 1).reshape(1, -1).repeat(P, 0)
    ak = np.take_along_axis(ap, idx, 1).reshape((P,) + j.shape)
    top = np.broadcast_to(o + (j + 2) * e, ak.shape)
    return (np.where(j[None] < n[:, None, None], ak, -1),
            np.where(j[None] < n[:, None, None] - 1, top, psa_scan.NEG),
            top + o)


def _short_left(bnd: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Lane 0's left edge at row ``r`` of a tile past the first: the
    previous tile's (H~, F~) of that row, from the boundary buffer."""
    return bnd[np.arange(len(r)), r]


@torch.no_grad()
def dp_short_wavefront(a, b, lens, params, lanes: int = SHORT_LANES,
                       widths=SHORT_WIDTHS, force_w=None):
    """``csrc/psa_dp_short.cu``'s schedule on the CPU, step by step: the
    pairs taken longest first (n*m), each at :func:`short_width`'s strip
    width (or ``force_w``) on a warp of ``lanes`` lanes; per tile of
    lanes*W columns, lane l computing row s - l of its strip at step s from
    the H~ and F~ lane l - 1 left the step before, the tile's last lane
    writing its edge to the boundary buffer that the next tile's lane 0
    reads (:func:`_short_left`), columns past n_real kept below the real
    maximum (:func:`_short_columns`), values stored shifted by the row as
    the kernel stores them; then each pair's (best, corner) written at its
    input index.  ``a``: (B, n_stride) uint8, ``b``: (B, m_stride) uint8,
    ``lens``: (B, 2) real (n, m).  Returns (scores, corners) as (B,) int32
    tensors.  Pairs of one width run side by side."""
    m_, x_, e_, o_ = as_params(params)
    oe, mp, xp = o_ + e_, m_ - e_, x_ - e_
    neg = psa_scan.NEG
    a, b = (np.asarray(torch.as_tensor(t).cpu(), np.int64) for t in (a, b))
    lens = np.asarray(torch.as_tensor(lens).cpu(), np.int64)
    B = len(lens)
    order = np.argsort(-(lens[:, 0] * lens[:, 1]), kind="stable")
    score = np.full(B, neg, np.int64)
    corner = np.full(B, neg, np.int64)
    width = np.array([force_w or short_width(int(n), int(m), lanes, widths)
                      for n, m in lens])
    lane = np.arange(lanes)
    for W in sorted(set(width[order].tolist())):
        pk = order[width[order] == W]
        pk = pk[(lens[pk, 0] >= 1) & (lens[pk, 1] >= 1)]
        if not len(pk):
            continue
        P, n, m = len(pk), lens[pk, 0], lens[pk, 1]
        ap, bp = a[pk], b[pk]
        tile = lanes * W
        tiles = -(-n // tile)
        bnd = np.zeros((P, int(m.max()), 2), np.int64)
        best = np.full((P, lanes), neg, np.int64)
        cor = np.full((P, lanes), neg, np.int64)
        rows = np.arange(P)
        for t in range(int(tiles.max())):
            c0 = t * tile
            lanes_t = np.where(t < tiles, np.minimum(lanes, -(-(n - c0) // W)),
                               0)
            m_lane = np.where(lane[None] < lanes_t[:, None], m[:, None], 0)
            j = c0 + lane[:, None] * W + np.arange(W)[None]      # (lanes, W)
            ak, h, e = _short_columns(ap, j, n, o_, e_)
            hd = np.full((P, lanes), e_ if t == 0 else o_ + (c0 + 1) * e_,
                         np.int64)
            fout = np.zeros((P, lanes), np.int64)
            edge = np.full((P, 2), o_ + e_, np.int64)
            for s in range(int((m + lanes_t - 1).max())):
                r = s - lane[None]                                # (1, lanes)
                active = (r >= 0) & (r < m_lane)
                hl = np.concatenate([np.zeros((P, 1), np.int64),
                                     h[:, :-1, W - 1]], 1)
                fin = np.concatenate([np.zeros((P, 1), np.int64),
                                      fout[:, :-1]], 1)
                left = edge
                if t > 0:
                    left = np.where((s < m)[:, None],
                                    _short_left(bnd, np.minimum(s, m - 1)),
                                    edge)
                hl[:, 0], fin[:, 0] = left[:, 0], left[:, 1]
                rr = np.clip(r, 0, bp.shape[1] - 1)
                bch = np.take_along_axis(bp, np.broadcast_to(rr, (P, lanes)),
                                         1)
                # right to left, C~ over the H~ above it; then F~ and H~
                # left to right, as the kernel updates its registers
                hn, en = h.copy(), e.copy()
                for k in range(W - 1, -1, -1):
                    en[:, :, k] = np.maximum(hn[:, :, k] + o_, en[:, :, k])
                    d = hn[:, :, k - 1] if k else hd
                    hn[:, :, k] = np.maximum(
                        d + np.where(ak[:, :, k] == bch, mp, xp), en[:, :, k])
                f = fin.copy()
                for k in range(W):
                    c = hn[:, :, k].copy()
                    hn[:, :, k] = np.maximum(f + oe, c)
                    f = np.maximum(f + e_, c)
                act = active[:, :, None]
                h = np.where(act, hn, h)
                e = np.where(act, en, e)
                fout = np.where(active, f, fout)
                best = np.where(active, np.maximum(best, hn.max(2) + r * e_),
                                best)
                last = active[:, lanes - 1] & (t + 1 < tiles)
                if last.any():
                    rl = s - (lanes - 1)
                    bnd[rows[last], rl, 0] = hn[last, lanes - 1, W - 1]
                    bnd[rows[last], rl, 1] = f[last, lanes - 1]
                hd = hl
            kc = (n - 1 - c0)[:, None] - lane[None] * W           # (P, lanes)
            own = (t + 1 == tiles)[:, None] & (kc >= 0) & (kc < W)
            hk = np.take_along_axis(h, np.clip(kc, 0, W - 1)[:, :, None],
                                    2)[:, :, 0]
            cor = np.where(own, hk + (m[:, None] - 1) * e_, cor)
        score[pk], corner[pk] = best.max(1), cor.max(1)
    return (torch.from_numpy(score.astype(np.int32)),
            torch.from_numpy(corner.astype(np.int32)))


def psa_align_batch_packed(seq_pairs, params, device=None):
    """Score-only batch of short pairs (n <= ``_kernels.SHORT_MAX_N``, JAX's
    PACK_RMAX segments) through :func:`dp_short`: (scores, corners) int32
    numpy arrays."""
    p = _traced_params(params)
    if not seq_pairs:
        raise ValueError("empty pair batch")
    a, b, lens = psa_diff.pack_pairs(seq_pairs, resolve_device(device))
    if a.shape[1] > _kernels.SHORT_MAX_N:
        raise ValueError("short-pair batch takes n <= %d, got %d"
                         % (_kernels.SHORT_MAX_N, a.shape[1]))
    scores, corners = dp_short(a, b, lens, p)
    return scores.cpu().numpy(), corners.cpu().numpy()


def batch_route(seq_pairs, params) -> str:
    """The kernel ``psa_align_batch`` of either package picks: "packed"
    (``psa_diff``, M > 0), "short" (Q2-15: two or more pairs, none wider
    than PACK_RMAX segments) or "batch" (Q2-14)."""
    if psa_diff.supports_params(params):
        return "packed"
    n_max = max(int(a.shape[0]) for a, _ in seq_pairs)
    if len(seq_pairs) >= 2 and -(-n_max // LANES) <= PACK_RMAX:
        return "short"
    return "batch"


def psa_align_batch(seq_pairs, params, device=None):
    """Score-only batch router: (scores, corners) int32 numpy arrays in
    input order, through the kernel :func:`batch_route` names."""
    p = as_params(params)
    if not seq_pairs:
        raise ValueError("empty pair batch")
    route = batch_route(seq_pairs, p)
    if route == "packed":
        return psa_diff.psa_align_batch_diff(seq_pairs, p, device=device)
    if route == "short":
        return psa_align_batch_packed(seq_pairs, p, device=device)
    p = _traced_params(p)
    a, b, lens = psa_diff.pack_pairs(seq_pairs, resolve_device(device))
    scores, corners = psa_diff.run_dp(a, b, lens, p)
    return scores.cpu().numpy(), corners.cpu().numpy()


def _traced_chain(a: np.ndarray, b: np.ndarray, p, dev):
    """Q2-13 traced, then the walk, for one pair whose plane fits: one DP
    launch, one walk launch and one read of [score, corner, count,
    words...].  Returns (score, corner, Alignment)."""
    score, corner, plane, nm = dp_pair(a, b, p, True, dev)
    words, counts = tb.walk_packed(plane[None], nm)
    del plane
    head = torch.cat([score, corner, counts, words[0]]).cpu().numpy()
    moves = tb.unpack_moves(head[3:], head[2])
    aln = tb.emit_alignment(moves, a, b, a.shape[0], b.shape[0])
    return int(head[0]), int(head[1]), aln


def psa_align_traced_device(a: np.ndarray, b: np.ndarray, params,
                            device=None):
    """Traced alignment with the traceback walked on the device; only the
    moves reach the host.  Parameters of ``psa_diff.supports_params`` take
    the packed traced kernels; the rest of the round-1 domain the traced
    chain, or row-chunks when m_pad * n_pad is over half the budget.
    Returns (score, corner, Alignment)."""
    from tsta_tpu_torch.ops import psa_chunked
    p = _traced_params(params)
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    dev = resolve_device(device)
    if psa_diff.supports_params(p):
        return psa_diff.psa_align_batch_traced_packed([(a, b)], p,
                                                      device=dev)[0]
    n_pad = -(-a.shape[0] // LANES) * LANES
    m_pad = -(-b.shape[0] // T_R) * T_R
    if m_pad * n_pad > device_budget(dev) // 2:
        return psa_chunked.psa_align_traced_chunked(a, b, p, device=dev)
    return _traced_chain(a, b, p, dev)
