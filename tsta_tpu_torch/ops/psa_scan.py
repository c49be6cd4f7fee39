"""Exact affine-gap global alignment (Gotoh) as a PyTorch row scan.

The port's oracle and the plain version of the DP kernels
(``csrc/psa_dp.cu``, ``csrc/psa_dp_traced.cu``); counterpart of
``tsta_tpu/ops/psa_scan.py``, with the same recurrence, boundary terms,
padding and tie rules:

    H(i,j) = max(H(i-1,j-1) + sub(a_j, b_i), E(i,j), F(i,j))
    E(i,j) = max(E(i-1,j) + e,  H(i-1,j) + o + e)
    F(i,j) = max(F(i,j-1) + e,  H(i,j-1) + o + e)

with H(-1,-1) = 0, H(-1,j) = o + (j+1)e and H(i,-1) = o + (i+1)e.  F is
taken in closed form (needs o <= 0):

    F(i,j) = o + j*e + max_{-1 <= k <= j-1} (C(k) - k*e),
    C(j) = max(diag(j), E(i,j)),  C(-1) - (-1)*e = H(i,-1) + e,

one ``torch.cummax`` per row.  ``score`` is the max over all H cells
(the reference's ``maxsorce``), ``last`` is H(m-1, n-1).

:func:`scan_rows` is the batched core: it runs B pairs of one padded
shape in lockstep and, when traced, emits each cell's code
``back*9 + f*3 + e`` (back: 1 diag, 0 left, 2 up, precedence in that
order; f/e: 0 extend, 1 open, 2 open-tie) -- the DP kernel's contract.
:func:`psa_align` is the single-pair oracle API with the three int8
traceback planes of the JAX oracle.

:data:`plain_calls` counts the plain DP and walk calls made on CUDA
tensors (this module's scans, ``traceback``'s plain walks): on a card the
kernels' routes must leave it unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tsta_tpu_torch.device import resolve_device

# Large-negative guard that cannot overflow int32 when gap terms are
# added to it a few times.
NEG = -(2 ** 28)

# Right-padding bytes: a with 0, b with 1, so pad never matches pad.
# With M > 0 > X, E < 0 and O <= 0 every padded cell scores below the
# real region, which keeps scores and traceback planes exact.
A_PAD, B_PAD = 0, 1

plain_calls = 0


class PsaResult(NamedTuple):
    score: int                              # max over all H cells
    last: int                               # H(m-1, n-1)
    back: Optional[torch.Tensor] = None     # (m, n) int8
    fback: Optional[torch.Tensor] = None    # (m, n) int8
    eback: Optional[torch.Tensor] = None    # (m, n) int8


def bucket(n: int) -> int:
    if n <= 2048:
        return (n + 127) // 128 * 128
    return (n + 1023) // 1024 * 1024


def as_params(params) -> tuple:
    """(match, mismatch, gap_extend, gap_open) ints from an AlignParams
    or a 4-sequence."""
    if hasattr(params, "match"):
        params = (params.match, params.mismatch, params.gap_extend,
                  params.gap_open)
    return tuple(int(v) for v in params)


@torch.no_grad()
def scan_rows(a: torch.Tensor, b: torch.Tensor, n_real: torch.Tensor,
              m_real: torch.Tensor, params, traced: bool = False):
    """Row-scan DP over B pairs of one padded shape.

    ``a``: (B, n) uint8 columns, ``b``: (B, m) uint8 rows, already
    padded; ``n_real``/``m_real``: (B,) int lengths that place each
    pair's corner.  Returns ``(best, corner, codes)``: (B,) int32 matrix
    maxima over all n x m cells, (B,) int32 H(m_real-1, n_real-1), and,
    when ``traced``, the (B, m, n) uint8 cell codes (else None).
    """
    return scan_from(a, b, n_real, m_real, params, traced)[:3]


@torch.no_grad()
def scan_from(a: torch.Tensor, b: torch.Tensor, n_real: torch.Tensor,
              m_real: torch.Tensor, params, traced: bool = False,
              row_base: int = 0, h: Optional[torch.Tensor] = None,
              e: Optional[torch.Tensor] = None, col0: int = 0,
              left: Optional[torch.Tensor] = None,
              right: Optional[torch.Tensor] = None):
    """:func:`scan_rows` over rows ``row_base .. row_base + m - 1`` of the
    matrix (``b`` holds just those rows), started from the (B, n) int32
    H/E frontier of row ``row_base - 1`` (default: the top boundary, row
    -1).  ``corner`` is NEG for a pair whose row m_real-1 is not among
    them.  Returns ``(best, corner, codes, h, e)``, the last two the
    frontier of the last row.

    A column shard, as ``csrc/psa_dp_traced.cu`` and ``csrc/psa_dp.cu``
    cut a row (the tests' proof that their packets are enough): ``a``
    holds the global columns ``col0 .. col0 + n - 1``, the corner is the
    pair's only where they hold column n_real-1, and ``left`` ((B, m, 3)
    int32, default the matrix's left boundary) gives for each row i the
    shard's left edge as the traced kernel's packet: H(i-1, col0-1), the
    inclusive F prefix max(H(i,-1) + e, max_{k<col0} (C(k) - k*e)) and
    H(i, col0-1).  ``right``, a (B, m, 3) int32 tensor, receives the same
    three values at the shard's last column, the next shard's ``left``.
    Score-only, both may be (B, m, 2), the score-only kernel's two-lane
    packet: the third value feeds only the codes."""
    global plain_calls
    if a.device.type == "cuda":
        plain_calls += 1
    m_, x_, e_, o_ = as_params(params)
    oe = o_ + e_
    B, n = a.shape
    m = b.shape[1]
    dev = a.device
    i32 = torch.int32
    j_idx = torch.arange(col0, col0 + n, dtype=i32, device=dev)
    j_e = j_idx * e_
    if h is None:
        h = (o_ + (j_idx + 1) * e_).expand(B, n).contiguous()
        e = torch.full((B, n), NEG, dtype=i32, device=dev)
    e_prev = e
    best = torch.full((B,), NEG, dtype=i32, device=dev)
    corner = torch.full((B,), NEG, dtype=i32, device=dev)
    ncol = (n_real.to(device=dev, dtype=torch.int64) - 1 - col0).view(B, 1)
    mrow = m_real.to(device=dev, dtype=torch.int64) - 1
    # a pair whose corner column lies outside the shard never takes it
    mrow = torch.where((ncol.view(B) >= 0) & (ncol.view(B) < n), mrow, -1)
    ncol = ncol.clamp(0, n - 1)
    bound = torch.empty((B, 3), dtype=i32, device=dev)
    codes = (torch.empty((B, m, n), dtype=torch.uint8, device=dev)
             if traced else None)
    a32 = a.to(i32)
    b32 = b.to(i32)
    for r in range(m):
        i = row_base + r
        if left is None:   # H(i-1, -1), H(i, -1) + e, H(i, -1)
            edge = bound
            edge[:, 0] = 0 if i == 0 else o_ + i * e_
            edge[:, 1] = o_ + (i + 1) * e_ + e_
            edge[:, 2] = o_ + (i + 1) * e_
        else:
            edge = left[:, r]
        fill, seed, h_edge = edge[:, 0:1], edge[:, 1:2], edge[:, 2:3]
        sub = torch.where(a32 == b32[:, r:r + 1], m_, x_).to(i32)
        diag = torch.cat([fill, h[:, :-1]], dim=1) + sub
        e_row = torch.maximum(e_prev + e_, h + oe)
        c = torch.maximum(diag, e_row)
        g = torch.cat([seed, c[:, :-1] - j_e[:-1]], dim=1)
        run = torch.cummax(g, dim=1).values
        f = run + (o_ + j_e)
        h_row = torch.maximum(c, f)
        if right is not None:
            right[:, r, 0] = h[:, -1]
            right[:, r, 1] = torch.maximum(run[:, -1], c[:, -1] - j_e[-1])
            if right.shape[2] > 2:
                right[:, r, 2] = h_row[:, -1]
        best = torch.maximum(best, h_row.amax(dim=1))
        corner = torch.where(mrow == i,
                             h_row.gather(1, ncol).view(B), corner)
        if traced:
            back = torch.where(h_row == diag, 1,
                               torch.where(h_row == f, 0, 2))
            h_left = torch.cat([h_edge, h_row[:, :-1]], dim=1)
            f_tie = f + e_ == h_row + oe
            fcode = torch.where(f == h_left + oe,
                                torch.where(f_tie, 2, 1), 0)
            e_tie = e_row + e_ == h_row + oe
            ecode = torch.where(e_row == h + oe,
                                torch.where(e_tie, 2, 1), 0)
            codes[:, r] = back * 9 + fcode * 3 + ecode
        h, e_prev = h_row, e_row
    return best, corner, codes, h, e_prev


def planes_from_codes(codes: torch.Tensor):
    """Split cell codes into the JAX oracle's three int8 planes: back,
    and fback/eback as 1 (extend), 2 (open) or -2 (open with tie)."""
    c = codes.to(torch.int8)
    back = c // 9

    def signed(k):
        return torch.where(k == 0, 1, torch.where(k == 1, 2, -2)).to(
            torch.int8)
    return back, signed((c // 3) % 3), signed(c % 3)


def psa_align(a, b, params, traced: bool = False, device=None) -> PsaResult:
    """Align byte-encoded sequences ``a`` (columns) x ``b`` (rows).

    ``params`` is (match, mismatch, gap_extend, gap_open) or an
    AlignParams.  Returns scores and, when ``traced``, the three
    traceback planes of shape ``(len(b), len(a))`` on ``device``.
    """
    p = as_params(params)
    if p[3] > 0:
        # the closed-form F assumes re-opening a gap from inside a gap
        # never wins, which requires gap_open <= 0
        raise ValueError("scan kernel requires gap_open <= 0 "
                         "(got O=%d)" % p[3])
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    n_real, m_real = int(a.shape[0]), int(b.shape[0])
    if n_real == 0 or m_real == 0:
        raise ValueError("empty sequence")
    # bucketed padding is only score-preserving for sane signs
    can_pad = p[0] > 0 and p[1] < 0 and p[2] < 0 and p[3] <= 0
    n = bucket(n_real) if can_pad else n_real
    m = bucket(m_real) if can_pad else m_real
    a_pad = np.full(n, A_PAD, np.uint8)
    a_pad[:n_real] = a
    b_pad = np.full(m, B_PAD, np.uint8)
    b_pad[:m_real] = b
    dev = resolve_device(device)
    best, last, codes = scan_rows(
        torch.from_numpy(a_pad).to(dev).view(1, n),
        torch.from_numpy(b_pad).to(dev).view(1, m),
        torch.tensor([n_real]), torch.tensor([m_real]), p, traced)
    if not traced:
        return PsaResult(int(best[0]), int(last[0]))
    back, fback, eback = planes_from_codes(codes[0, :m_real, :n_real])
    return PsaResult(int(best[0]), int(last[0]), back, fback, eback)
