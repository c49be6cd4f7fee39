"""Packed-batch PSA: host grouping and padding around the DP and walk
kernels, for the parameter sets of :func:`supports_params` (M > 0).

Counterpart of ``tsta_tpu/ops/psa_diff.py`` (single device, int32).  The
TPU packs P pairs along the sublanes of one tile; on the GPU a batch is
one launch over a (B, n_pad) byte matrix with a (B, 2) real-length table:

* score-only (:func:`psa_align_batch_diff`): ``csrc/psa_dp.cu``, each
  pair's columns cut into D shards on co-resident blocks
  (:func:`score_plan`); any pair length; each pair runs over its own
  real extent, so mixing lengths costs no padding;
* traced (:func:`psa_align_batch_traced_packed`): pairs grouped by padded
  width; each group's DP (``csrc/psa_dp_traced.cu``: each pair's columns
  cut into D shards on co-resident blocks, :func:`traced_plan`) writes a
  (P, m_pad, n_pad) uint8 code plane on the device, the walk kernel turns
  it into packed moves, and only the moves cross to the host.  A pair
  whose plane the device budget will not hold alone goes to
  ``ops/psa_chunked.py`` (row-chunks of the same traced body,
  rematerialised one at a time for the walk).

:func:`run_dp` is the DP kernels' wrapper: a CPU tensor takes the plain
version (``psa_scan.scan_rows``), a CUDA tensor launches the kernel or
raises.  :func:`dp_packed` is it behind the packed routes' gate; the
round-1 routes of ``ops/psa_pallas.py`` (any M), which also hold the
routers, call it behind theirs.

``use_int16=True``, or ``TSTA_DIFF_INT16`` set to any non-empty value,
sends a score-only batch to the difference method (JAX's ``_diff_kernel``):
:func:`run_dp_int16`, whose kernel ``csrc/psa_dp_diff.cu`` holds the
frontier as int16 offsets from per-segment int32 anchors, with the plain
version :func:`scan_rows_int16`.  It is exact, and so gives the int32
route's numbers, for the parameters of :func:`supports_params_int16`
(D <= 57); the switch raises ValueError outside them, as JAX's does.
The default stays int32, as in the JAX package.

``layout="striped"``, or ``TSTA_PSA_LAYOUT=striped``, sends a score-only
batch to the striped layout (JAX's ``_striped_kernel``): each pair's
columns as an (Sp, 128) tile, column j at ``[j % Sp, j // Sp]``
(:func:`pack_pairs_striped`), run by :func:`run_dp_striped`, whose kernel
``csrc/psa_dp_striped.cu`` gives lane l the stripe [l*Sp, (l+1)*Sp), with
the plain version :func:`scan_rows_striped`.  Every other layout
(``packed``, ``packed2``) is K1's function and takes K1, as JAX's
``_psa_diff_call`` sends every non-striped layout to ``_abs_kernel``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tsta_tpu_torch.device import device_budget, resolve_device
from tsta_tpu_torch.ops import _kernels, psa_scan
from tsta_tpu_torch.ops import traceback as tb
from tsta_tpu_torch.ops.psa_scan import A_PAD, B_PAD, NEG, as_params
from tsta_tpu_torch.parallel.mesh import refuse_data_axis

LANES = 128
T_R = 256               # row padding quantum (the JAX kernel's rows/step)
K_REANCHOR = 16         # rows between the int16 anchors' re-bases (JAX's)
SEG_MAX = 128           # widest segment one int32 anchor carries
DIFF_THREADS = 256      # csrc/psa_dp_diff.cu's block: one strip per thread
# csrc/psa_dp_traced.cu's plan: threads per block (one shard each), rows
# per packet, and the fewest columns per thread of a shard
TRACED_THREADS, TRACED_T, TRACED_MIN_W = 256, 32, 4
# csrc/psa_dp.cu's (the score-only body's): the same three, and the
# one-block-an-SM strips that take two blocks an SM instead
SCORE_THREADS, SCORE_T, SCORE_MIN_W = 256, 32, 2
SCORE_SPLIT_W, SCORE_SPLIT_MAX_W = 6, 48


def supports_params(params) -> bool:
    """True when the packed kernels handle ``params``: M > 0 > X, E < 0,
    O <= 0 (bucketed padding and the closed-form F are then exact)."""
    p = as_params(params)
    return not (p[1] >= 0 or p[2] >= 0 or p[3] > 0 or p[0] <= 0)


def _delta_bound(p):
    """D: bound on adjacent-column H differences for params p."""
    m_, x_, e_, o_ = p
    return max(m_, -x_, -(o_ + e_), -e_, 1)


def supports_params_int16(params) -> bool:
    """True when the int16 offsets are provably exact: :func:`supports_params`
    and D <= 57.  The offsets alone would allow D <= 72; 57 is the JAX
    package's gate (its arithmetic int16 max takes ``x - y``, up to 573*D),
    kept so that both packages take the same parameter sets."""
    p = as_params(params)
    return supports_params(p) and _delta_bound(p) <= 57


def diff_layout(n: int) -> tuple:
    """(W, G): ``csrc/psa_dp_diff.cu``'s strip width per thread and segment
    width for a pair of ``n`` real columns: W = ceil(n / 256) rounded up to
    4 (K1's strip), then cut into W / G segments of G <= SEG_MAX columns,
    G a multiple of 4, so the segments form one grid of width G."""
    w = -(-n // DIFF_THREADS)
    w = (w + 3) & ~3
    nseg = -(-w // SEG_MAX)
    g = (-(-w // nseg) + 3) & ~3
    return nseg * g, g


def traced_plan(P: int, n_pad: int, sms: int, min_w: int = TRACED_MIN_W,
                per_sm: int = 1) -> tuple:
    """(D, C, W, T): how ``csrc/psa_dp_traced.cu`` cuts each of P pairs of
    ``n_pad`` columns on a card of ``sms`` SMs (its
    ``tsta_psa_dp_traced_layout``).  max(1, sms // P) blocks a pair; W
    columns per thread: n_pad over those blocks' threads, at least
    TRACED_MIN_W, a multiple of 4; C = TRACED_THREADS * W columns per
    shard (n_pad when that is less); D = ceil(n_pad / C) shards, the last
    one n_pad - (D - 1) * C wide, so P * D <= sms whenever D >= 2; T =
    TRACED_T rows per packet, so the pipeline's fill is (D - 1) * T rows.
    At P = 1 it is ``psa_chunked.chunk_plan``.  ``min_w`` (the least W)
    and ``per_sm`` (blocks an SM: per_sm * sms // P blocks a pair) give
    the smoke's sweep its other plans; the kernel's are the defaults."""
    def round4(x):
        return (x + 3) // 4 * 4
    blocks = max(1, per_sm * sms // P)
    w0 = round4(max(min_w, -(-n_pad // (blocks * TRACED_THREADS))))
    C = min(w0 * TRACED_THREADS, n_pad)
    return -(-n_pad // C), C, round4(-(-C // TRACED_THREADS)), TRACED_T


def score_plan(P: int, n_pad: int, sms: int, min_w: int = SCORE_MIN_W,
               per_sm=None) -> tuple:
    """(D, C, W, T): how ``csrc/psa_dp.cu`` cuts each of P pairs of
    ``n_pad`` columns on a card of ``sms`` SMs for a score-only launch (its
    ``tsta_psa_dp_layout``).  max(1, per_sm * sms // P) blocks a pair; W
    columns per thread: n_pad over those blocks' threads, at least
    SCORE_MIN_W; C = SCORE_THREADS * W columns per shard (n_pad when that
    is less); D = ceil(n_pad / C) shards, the last one n_pad - (D - 1) * C
    wide; T = SCORE_T rows per packet, so the pipeline's fill is (D - 1) *
    T rows.  per_sm is 2 when one block an SM gives a strip of
    SCORE_SPLIT_W to SCORE_SPLIT_MAX_W columns, else 1 (PERF.md's sweep:
    a second block an SM hides the row's barriers where a strip's cells
    are many), so P * D <= 2 * sms whenever D >= 2.  The body needs no
    multiple of W: score-only has no code word.  ``min_w`` (the least W)
    and ``per_sm`` (forced) give the smoke's sweep its other plans; the
    kernel's are the defaults."""
    def width(k):
        blocks = max(1, k * sms // P)
        return max(min_w, -(-n_pad // (blocks * SCORE_THREADS)))
    if per_sm is None:
        w1 = width(1)
        per_sm = 2 if SCORE_SPLIT_W <= w1 <= SCORE_SPLIT_MAX_W else 1
    C = min(width(per_sm) * SCORE_THREADS, n_pad)
    return -(-n_pad // C), C, -(-C // SCORE_THREADS), SCORE_T


def _traced_n_pad(n_max: int) -> int:
    """Padded per-pair width of a traced group: LANES-rounded, then
    512-rounded when that costs < 25% padding, so near-miss lengths
    (the 10,000 bp example vs 10,240 bp reads) share one group."""
    np128 = (n_max + LANES - 1) // LANES * LANES
    np512 = -(-np128 // 512) * 512
    return np512 if np512 * 4 <= np128 * 5 else np128


def _lengths(seq_pairs):
    n_real = [int(a.shape[0]) for a, _ in seq_pairs]
    m_real = [int(b.shape[0]) for _, b in seq_pairs]
    for i in range(len(seq_pairs)):
        if n_real[i] < 1 or m_real[i] < 1:
            raise ValueError("pair %d has an empty sequence "
                             "(lengths %d, %d)" % (i, n_real[i], m_real[i]))
    return n_real, m_real


def dp_packed(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor, params,
              traced: bool = False):
    """:func:`run_dp` for the packed routes: parameters outside
    :func:`supports_params` raise."""
    p = as_params(params)
    if not supports_params(p):
        raise ValueError("packed DP requires M>0>X, E<0, O<=0 (got %s)"
                         % (p,))
    return run_dp(a, b, lens, p, traced)


def run_dp(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor, params,
           traced: bool = False, *, D=None, T=None):
    """Run the DP over B padded pairs.

    ``a``: (B, n_pad) uint8, ``b``: (B, m_pad) uint8, ``lens``: (B, 2)
    int32 real (n, m), all on one device.  Returns (scores, corners) as
    (B,) int32 and, when ``traced``, the (B, m_pad, n_pad) uint8 code
    plane of every padded cell.  Scores agree with the JAX kernels'
    (which include padded cells) whenever every move into padding lowers
    the score: X < 0, E < 0 and O <= 0, which the callers' gates hold.
    On the card score-only launches K1 (``_kernels.psa_dp``) and traced
    the traced DP (``_kernels.psa_dp_traced``), each pair's columns in
    shards on co-resident blocks; their plan ``D`` and ``T`` override,
    for tests and sweeps; the plain version takes neither.
    """
    p = as_params(params)
    if a.device.type == "cpu":
        if D is not None or T is not None:
            raise ValueError("D and T are the card kernel's overrides; the "
                             "plain version takes neither")
        best, corner, codes = psa_scan.scan_rows(a, b, lens[:, 0],
                                                 lens[:, 1], p, traced)
        return (best, corner, codes) if traced else (best, corner)
    B = a.shape[0]
    score = torch.empty((B,), dtype=torch.int32, device=a.device)
    corner = torch.empty((B,), dtype=torch.int32, device=a.device)
    if not traced:
        _kernels.psa_dp(a, b, lens, p, score, corner, D=D, T=T)
        return score, corner
    plane = torch.empty((B, b.shape[1], a.shape[1]), dtype=torch.uint8,
                        device=a.device)
    _kernels.psa_dp_traced(a, b, lens, p, score, corner, plane, D=D, T=T)
    return score, corner, plane


@torch.no_grad()
def scan_rows_int16(a: torch.Tensor, b: torch.Tensor, n_real: torch.Tensor,
                    m_real: torch.Tensor, params, seg: int):
    """The difference method's plain version: :func:`psa_scan.scan_rows`'s
    score-only DP with the H/E frontier as int16 offsets, in the kernel's
    design.

    Columns fall into segments of ``seg`` columns from column 0 (the
    kernel's segment width, :func:`diff_layout`), each with an int32
    anchor, H(-1, start) at first; after every K_REANCHOR-th row each
    anchor moves to its segment's first H of that row.  The cell
    arithmetic runs on torch.int16 tensors, whose additions wrap, so an
    offset that left int16 would show as a wrong score.  F's prefix max
    runs in int16 inside a segment and crosses segments in int32, entering
    each as ``clip(carry - beta, guard, 32767)``; the guard is -160 * D.
    The best H is folded into int32 per segment and row, before an anchor
    moves.  ``a``: (B, n) uint8, ``b``: (B, m) uint8, padded as for
    scan_rows; ``n_real``/``m_real``: (B,) real lengths.  Returns (best,
    corner) as (B,) int32, scan_rows' numbers for the parameters of
    :func:`supports_params_int16`.
    """
    if a.device.type == "cuda":
        psa_scan.plain_calls += 1
    p = as_params(params)
    m_, x_, e_, o_ = p
    guard = -160 * _delta_bound(p)
    dev = a.device
    i16, i32 = torch.int16, torch.int32
    B, n = a.shape
    m = b.shape[1]
    ns = -(-n // seg)
    if ns * seg > n:   # whole segments: the extra columns are padding too
        a = torch.cat([a, torch.full((B, ns * seg - n), A_PAD,
                                     dtype=a.dtype, device=dev)], 1)
    a3 = a.view(B, ns, seg).to(i32)
    b32 = b.to(i32)
    lane = torch.arange(seg, dtype=i32, device=dev)
    le = (lane * e_).to(i16)                     # l*e
    ole = (o_ + lane * e_).to(i16)               # o + l*e
    start_e = torch.arange(ns, dtype=i32, device=dev) * seg * e_
    alpha = (o_ + e_ + start_e).expand(B, ns).contiguous()
    h = le.expand(B, ns, seg).contiguous()
    ev = torch.full((B, ns, seg), guard, dtype=i16, device=dev)
    neg = torch.full((B, ns, 1), guard, dtype=i16, device=dev)
    best = torch.full((B,), NEG, dtype=i32, device=dev)
    corner = torch.full((B,), NEG, dtype=i32, device=dev)
    cn = n_real.to(device=dev, dtype=torch.int64) - 1
    cseg = (cn // seg).view(B, 1)
    mrow = m_real.to(device=dev, dtype=torch.int64) - 1
    corner_rows = set(mrow.tolist())
    col = torch.empty((B, 1), dtype=i32, device=dev)
    beta = alpha - start_e
    for i in range(m):
        bound_prev = 0 if i == 0 else o_ + i * e_    # H(i-1, -1)
        bound_cur = o_ + (i + 1) * e_                # H(i, -1)
        sub = torch.where(a3 == b32[:, i, None, None], m_, x_).to(i16)
        # H(i-1, start - 1) of each segment, in the segment's own frame
        left = torch.cat([col.fill_(bound_prev),
                          h[:, :-1, -1].to(i32) + alpha[:, :-1]], 1)
        hd = torch.cat([(left - alpha).to(i16)[..., None], h[..., :-1]], 2)
        diag = hd + sub
        e_row = torch.maximum(ev + e_, h + (o_ + e_))
        c = torch.maximum(diag, e_row)
        y = c - le
        pre = torch.cummax(torch.cat([neg, y[..., :-1]], 2), 2).values
        top = torch.maximum(pre[..., -1], y[..., -1]).to(i32) + beta
        carry = torch.cummax(torch.cat([col.fill_(bound_cur + e_),
                                        top[:, :-1]], 1), 1).values
        carry = torch.clamp(carry - beta, guard, 32767).to(i16)
        hr = torch.maximum(c, ole + torch.maximum(pre, carry[..., None]))
        best = torch.maximum(best, (hr.amax(2).to(i32) + alpha).amax(1))
        if i in corner_rows:
            here = hr.view(B, ns * seg).gather(1, cn.view(B, 1)).to(i32)
            corner = torch.where(mrow == i,
                                 (here + alpha.gather(1, cseg)).view(B),
                                 corner)
        if i % K_REANCHOR == K_REANCHOR - 1:
            delta = hr[..., :1]
            hr, e_row = hr - delta, e_row - delta
            alpha = alpha + delta[..., 0].to(i32)
            beta = alpha - start_e
        h, ev = hr, e_row
    return best, corner


def dp_int16_plain(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor,
                   params):
    """:func:`scan_rows_int16` over B padded pairs (the inputs of
    :func:`pack_pairs`), each pair at its own segment width in the kernel
    (:func:`diff_layout` of its n), on the tensors' device: (scores,
    corners) as (B,) int32."""
    widths = [diff_layout(n)[1] for n in lens[:, 0].tolist()]
    score = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    corner = torch.empty_like(score)
    for g in sorted(set(widths)):
        idx = torch.tensor([k for k, w in enumerate(widths) if w == g],
                           device=a.device)
        score[idx], corner[idx] = scan_rows_int16(
            a[idx], b[idx], lens[idx, 0], lens[idx, 1], params, g)
    return score, corner


def run_dp_int16(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor,
                 params):
    """The difference-method DP over B padded pairs, score-only, each
    over its real extent: the inputs of :func:`pack_pairs`; (scores,
    corners) as (B,) int32.  A CPU tensor takes the plain version
    (:func:`dp_int16_plain`); a CUDA tensor launches
    ``csrc/psa_dp_diff.cu`` or raises.  Parameters outside
    :func:`supports_params_int16` raise ValueError."""
    p = as_params(params)
    if not supports_params_int16(p):
        raise ValueError("int16 difference kernel requires M>0>X, E<0, "
                         "O<=0 and max(M,-X,-(O+E),-E) <= 57 (got %s)"
                         % (p,))
    if a.device.type == "cpu":
        return dp_int16_plain(a, b, lens, p)
    B = a.shape[0]
    score = torch.empty((B,), dtype=torch.int32, device=a.device)
    corner = torch.empty((B,), dtype=torch.int32, device=a.device)
    _kernels.psa_dp_diff(a, b, lens, p, score, corner)
    return score, corner


def _pad_pairs(seq_pairs, traced: bool = False, n_pad=None):
    """:func:`pack_pairs`' arrays in numpy; ``n_pad``, when given, replaces
    the width it would pick."""
    n_real, m_real = _lengths(seq_pairs)
    if n_pad is None:
        n_pad = (_traced_n_pad(max(n_real)) if traced
                 else (max(n_real) + LANES - 1) // LANES * LANES)
    elif n_pad < max(n_real):
        raise ValueError("n_pad %d is narrower than the widest pair, %d"
                         % (n_pad, max(n_real)))
    m_pad = (max(m_real) + T_R - 1) // T_R * T_R
    a = np.full((len(seq_pairs), n_pad), A_PAD, np.uint8)
    b = np.full((len(seq_pairs), m_pad), B_PAD, np.uint8)
    for k, (x, y) in enumerate(seq_pairs):
        a[k, :len(x)] = x
        b[k, :len(y)] = y
    return a, b, np.array([n_real, m_real], np.int32).T.copy()


def pack_pairs(seq_pairs, device, traced: bool = False):
    """Pad encoded (a, b) pairs into the DP kernel's inputs on ``device``:
    (a (B, n_pad) uint8, b (B, m_pad) uint8, lens (B, 2) int32 real
    (n, m)).  m_pad rounds to T_R; n_pad to LANES, or by
    :func:`_traced_n_pad` for a traced group."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in _pad_pairs(seq_pairs, traced))


def striped_columns(n_pad: int) -> np.ndarray:
    """The striped layout's column order, JAX's ``col``
    (``tsta_tpu/ops/psa_diff.py:1231``): entry u*128 + l is the logical
    column l*Sp + u, Sp = n_pad / 128, so a pair's row of n_pad bytes
    taken in this order is its (Sp, 128) tile, column j at [j % Sp,
    j // Sp]."""
    if n_pad < LANES or n_pad % LANES:
        raise ValueError("n_pad must be a positive multiple of %d, got %d"
                         % (LANES, n_pad))
    return np.arange(n_pad, dtype=np.int32).reshape(LANES,
                                                    n_pad // LANES).T.ravel()


def pack_pairs_striped(seq_pairs, device, n_pad=None):
    """Pad encoded (a, b) pairs into the striped DP's inputs on
    ``device``: (a_tile (B, Sp, 128) uint8, one tile per pair with column
    j at [j % Sp, j // Sp]; b (B, m_pad) uint8; lens (B, 2) int32 real
    (n, m)), Sp = n_pad / 128.  ``n_pad`` defaults to the widest pair
    rounded to 128; JAX widens it when a batch spans several packed
    groups, which moves every column, so a caller that compares tiles
    passes JAX's."""
    a, b, lens = _pad_pairs(seq_pairs, n_pad=n_pad)
    tile = np.ascontiguousarray(a[:, striped_columns(a.shape[1])])
    tile = tile.reshape(len(a), -1, LANES)
    return tuple(torch.from_numpy(t).to(device) for t in (tile, b, lens))


def _stripe_shift1(x: torch.Tensor, fill: int, edge: torch.Tensor):
    """Each column's left neighbour in the striped order: a roll along the
    stripe, with the stripe's first row taken from the last row of lane
    l - 1 and column 0 (lane 0, u = 0) given ``fill``."""
    first = torch.cat([edge.fill_(fill), x[:, -1, :-1]], 1)
    return torch.cat([first[:, None, :], x[:, :-1]], 1)


@torch.no_grad()
def scan_rows_striped(a_tile: torch.Tensor, b: torch.Tensor,
                      lens: torch.Tensor, params):
    """The striped DP's plain version, in the TPU kernel's design: the
    H/E frontier as (B, Sp, 128) tiles, column j = l*Sp + u at [u, l].
    Per row, the diagonal term is the frontier shifted one column
    (:func:`_stripe_shift1`); F's closed form is the exclusive prefix max
    of y = C - j*e down each stripe, then an exclusive prefix over the
    (B, 128) stripe totals across the lanes, seeded with H(i, -1) + e,
    and f = o + j*e + max(within-stripe prefix, carry).  ``a_tile``: (B,
    Sp, 128) uint8 (:func:`pack_pairs_striped`), ``b``: (B, m_pad) uint8,
    ``lens``: (B, 2) real (n, m).  Returns (best, corner) as (B,) int32:
    the max over every cell of the tile and row, padding included, and
    H(m-1, n-1) -- :func:`psa_scan.scan_rows`' numbers."""
    if a_tile.device.type == "cuda":
        psa_scan.plain_calls += 1
    m_, x_, e_, o_ = as_params(params)
    oe = o_ + e_
    dev = a_tile.device
    i32 = torch.int32
    B, sp, _ = a_tile.shape
    col = (torch.arange(LANES, dtype=i32, device=dev) * sp
           + torch.arange(sp, dtype=i32, device=dev)[:, None])   # (Sp, 128)
    col_e = col * e_
    h = (o_ + (col + 1) * e_).expand(B, sp, LANES).contiguous()
    ev = torch.full((B, sp, LANES), NEG, dtype=i32, device=dev)
    neg = torch.full((B, 1, LANES), NEG, dtype=i32, device=dev)
    edge = torch.empty((B, 1), dtype=i32, device=dev)
    best = torch.full((B,), NEG, dtype=i32, device=dev)
    corner = torch.full((B,), NEG, dtype=i32, device=dev)
    cn = lens[:, 0].to(device=dev, dtype=torch.int64) - 1
    cpos = ((cn % sp) * LANES + cn // sp).view(B, 1)   # (n-1)'s place
    mrow = lens[:, 1].to(device=dev, dtype=torch.int64) - 1
    corner_rows = set(mrow.tolist())
    a32 = a_tile.to(i32)
    b32 = b.to(i32)
    for i in range(b.shape[1]):
        bound_prev = 0 if i == 0 else o_ + i * e_    # H(i-1, -1)
        bound_cur = o_ + (i + 1) * e_                # H(i, -1)
        sub = torch.where(a32 == b32[:, i, None, None], m_, x_).to(i32)
        diag = _stripe_shift1(h, bound_prev, edge) + sub
        e_row = torch.maximum(ev + e_, h + oe)
        c = torch.maximum(diag, e_row)
        y = c - col_e
        q = torch.cummax(torch.cat([neg, y[:, :-1]], 1), 1).values
        top = torch.maximum(q[:, -1], y[:, -1])             # stripe totals
        carry = torch.cummax(torch.cat([edge.fill_(bound_cur + e_),
                                        top[:, :-1]], 1), 1).values
        h_row = torch.maximum(c, o_ + col_e + torch.maximum(q, carry[:, None]))
        best = torch.maximum(best, h_row.amax((1, 2)))
        if i in corner_rows:
            here = h_row.view(B, -1).gather(1, cpos).view(B)
            corner = torch.where(mrow == i, here, corner)
        h, ev = h_row, e_row
    return best, corner


def run_dp_striped(a_tile: torch.Tensor, b: torch.Tensor, lens: torch.Tensor,
                   params):
    """The striped DP over B pairs, score-only: the inputs of
    :func:`pack_pairs_striped`; (scores, corners) as (B,) int32.  A CPU
    tensor takes the plain version (:func:`scan_rows_striped`); a CUDA
    tensor launches ``csrc/psa_dp_striped.cu`` (each pair over its real
    extent) or raises.  Parameters outside :func:`supports_params` raise
    ValueError: only there is padding score-neutral, so that both give
    K1's numbers."""
    p = as_params(params)
    if not supports_params(p):
        raise ValueError("striped DP requires M>0>X, E<0, O<=0 (got %s)"
                         % (p,))
    if a_tile.device.type == "cpu":
        return scan_rows_striped(a_tile, b, lens, p)
    B = a_tile.shape[0]
    score = torch.empty((B,), dtype=torch.int32, device=a_tile.device)
    corner = torch.empty((B,), dtype=torch.int32, device=a_tile.device)
    _kernels.psa_dp_striped(a_tile, b, lens, p, score, corner)
    return score, corner


def psa_align_batch_diff(seq_pairs, params, use_int16=None, mesh=None,
                         layout=None, device=None):
    """Score-only batch through the DP kernel (any pair length).

    ``seq_pairs``: encoded uint8 (a, b) pairs.  Returns (scores,
    corners) int32 numpy arrays in input order.  ``use_int16`` (default:
    whether ``TSTA_DIFF_INT16`` is set to a non-empty value, as in the
    JAX package) selects the difference method, :func:`run_dp_int16`,
    exact for D <= 57 and a ValueError beyond.  Otherwise ``layout``
    (default: ``TSTA_PSA_LAYOUT``, else ``packed``, as in the JAX
    package) picks the striped DP, :func:`run_dp_striped`, for
    ``striped`` and K1 for any other value.  ``mesh`` (sharding the
    batch over cards) raises ``NotImplementedError``.
    """
    if use_int16 is None:
        use_int16 = bool(os.environ.get("TSTA_DIFF_INT16"))
    if layout is None:
        layout = os.environ.get("TSTA_PSA_LAYOUT", "packed")
    if use_int16:
        layout = "packed"   # the difference method has the packed form only
    refuse_data_axis(mesh, "a score-only batch")
    p = as_params(params)
    if not supports_params(p):
        raise ValueError("packed kernel requires M>0>X, E<0, O<=0 "
                         "(got %s)" % (p,))
    if use_int16 and not supports_params_int16(p):
        raise ValueError("int16 difference kernel additionally requires "
                         "max(M,-X,-(O+E),-E) <= 57 (got %s)" % (p,))
    if not seq_pairs:
        raise ValueError("empty pair batch")
    dev = resolve_device(device)
    if layout == "striped":
        scores, corners = run_dp_striped(*pack_pairs_striped(seq_pairs, dev),
                                         p)
    else:
        a, b, lens = pack_pairs(seq_pairs, dev)
        scores, corners = (run_dp_int16(a, b, lens, p) if use_int16
                           else dp_packed(a, b, lens, p, traced=False))
    return scores.cpu().numpy(), corners.cpu().numpy()


def _traced_groups(n_real, m_real, budget):
    """Group pair indices by padded width, longest rows first, as many
    per group as the budget allows: P pairs of an (m_pad, n_pad) group
    fit when 2 * P * m_pad * n_pad <= ``budget`` bytes (the JAX rule,
    ``tsta_tpu/ops/psa_diff.py:1090``: the plane and the walk's source).  Returns
    ``(groups, chunked)``; ``chunked`` holds the pairs that do not fit
    even alone."""
    order = sorted(range(len(n_real)),
                   key=lambda i: (-_traced_n_pad(n_real[i]), -m_real[i]))
    groups, chunked = [], []
    for i in order:
        n_pad = _traced_n_pad(n_real[i])
        m_pad = -(-m_real[i] // T_R) * T_R
        if 2 * m_pad * n_pad > budget:
            chunked.append(i)
            continue
        g = groups[-1] if groups else None
        # the group's m_pad is its first (longest) member's
        if (g is not None and _traced_n_pad(n_real[g[0]]) == n_pad
                and 2 * (len(g) + 1) * n_pad
                * (-(-m_real[g[0]] // T_R) * T_R) <= budget):
            g.append(i)
        else:
            groups.append([i])
    return groups, chunked


def psa_align_batch_traced_packed(seq_pairs, params, mesh=None,
                                  device=None):
    """Traced batch: DP with code plane, then the device walk.

    ``seq_pairs``: encoded uint8 (a, b) pairs, already swapped so the
    longer side is ``a``.  Returns [(score, corner, Alignment)] in input
    order.  Groups are cut to :func:`device.device_budget`; a pair whose
    plane will not fit alone runs through
    :func:`psa_chunked.psa_align_traced_chunked`.
    """
    from tsta_tpu_torch.ops import psa_chunked
    refuse_data_axis(mesh, "a traced batch")
    p = as_params(params)
    if not supports_params(p):
        raise ValueError("packed traced kernel requires M>0>X, E<0, O<=0"
                         " (got %s)" % (p,))
    dev = resolve_device(device)
    n_real, m_real = _lengths(seq_pairs)
    results = [None] * len(seq_pairs)
    groups, chunked = _traced_groups(n_real, m_real, device_budget(dev))
    for g in groups:
        a, b, nm = pack_pairs([seq_pairs[i] for i in g], dev, traced=True)
        scores, corners, plane = dp_packed(a, b, nm, p, traced=True)
        words, counts = tb.walk_packed(plane, nm)
        del plane
        head = torch.stack([scores, corners, counts], dim=1).cpu().numpy()
        words = words.cpu().numpy()
        for k, i in enumerate(g):
            moves = tb.unpack_moves(words[k], head[k, 2])
            aln = tb.emit_alignment(moves, seq_pairs[i][0], seq_pairs[i][1],
                                    n_real[i], m_real[i])
            results[i] = (int(head[k, 0]), int(head[k, 1]), aln)
    for i in chunked:
        results[i] = psa_chunked.psa_align_traced_chunked(
            seq_pairs[i][0], seq_pairs[i][1], p, device=dev)
    return results
