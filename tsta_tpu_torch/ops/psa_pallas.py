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
  ``csrc/psa_dp_short.cu``, one warp per pair.  JAX's PACK_SUBS (96
  sublanes, P = 96 // Rp pairs per tile) has no counterpart: a block holds
  four pairs whatever their width.
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


def psa_align_batch_packed(seq_pairs, params, device=None):
    """Score-only batch of short pairs (n <= ``_kernels.SHORT_MAX_N``, the
    kernel's shared memory) through :func:`dp_short`: (scores, corners)
    int32 numpy arrays."""
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
