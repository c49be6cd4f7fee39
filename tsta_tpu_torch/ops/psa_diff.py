"""Packed-batch PSA: host grouping and padding around the DP and walk
kernels, for the parameter sets of :func:`supports_params` (M > 0).

Counterpart of ``tsta_tpu/ops/psa_diff.py`` (single device, int32).  The
TPU packs P pairs along the sublanes of one tile; on the GPU each pair is
one thread block of ``csrc/psa_dp.cu``, so a batch is one launch over a
(B, n_pad) byte matrix with a (B, 2) real-length table:

* score-only (:func:`psa_align_batch_diff`): any pair length; each pair
  runs over its own real extent, so mixing lengths costs no padding;
* traced (:func:`psa_align_batch_traced_packed`): pairs grouped by padded
  width; each group's DP writes a (P, m_pad, n_pad) uint8 code plane on
  the device, the walk kernel turns it into packed moves, and only the
  moves cross to the host.  A pair whose plane the device budget will not
  hold alone goes to ``ops/psa_chunked.py`` (row-chunks, rematerialised
  one at a time for the walk).

:func:`run_dp` is the DP kernel's wrapper: a CPU tensor takes the plain
version (``psa_scan.scan_rows``), a CUDA tensor launches the kernel or
raises.  :func:`dp_packed` is it behind the packed routes' gate; the
round-1 routes of ``ops/psa_pallas.py`` (any M), which also hold the
routers, call it behind theirs.
"""

from __future__ import annotations

import numpy as np
import torch

from tsta_tpu_torch.device import device_budget, resolve_device
from tsta_tpu_torch.ops import _kernels, psa_scan
from tsta_tpu_torch.ops import traceback as tb
from tsta_tpu_torch.ops.psa_scan import A_PAD, B_PAD, as_params

LANES = 128
T_R = 256               # row padding quantum (the JAX kernel's rows/step)


def supports_params(params) -> bool:
    """True when the packed kernels handle ``params``: M > 0 > X, E < 0,
    O <= 0 (bucketed padding and the closed-form F are then exact)."""
    p = as_params(params)
    return not (p[1] >= 0 or p[2] >= 0 or p[3] > 0 or p[0] <= 0)


def _refuse_unported(use_int16=None, mesh=None, layout=None) -> None:
    if use_int16:
        raise NotImplementedError("the int16 difference kernel is a later "
                                  "slice of the port")
    if mesh is not None:
        raise NotImplementedError("multi-GPU batches are a later slice of "
                                  "the port")
    if layout not in (None, "packed"):
        raise NotImplementedError("layout %r is not ported" % (layout,))


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
           traced: bool = False):
    """Run the DP over B padded pairs.

    ``a``: (B, n_pad) uint8, ``b``: (B, m_pad) uint8, ``lens``: (B, 2)
    int32 real (n, m), all on one device.  Returns (scores, corners) as
    (B,) int32 and, when ``traced``, the (B, m_pad, n_pad) uint8 code
    plane of every padded cell.  Scores agree with the JAX kernels'
    (which include padded cells) whenever every move into padding lowers
    the score: X < 0, E < 0 and O <= 0, which the callers' gates hold.
    """
    p = as_params(params)
    if a.device.type == "cpu":
        best, corner, codes = psa_scan.scan_rows(a, b, lens[:, 0],
                                                 lens[:, 1], p, traced)
        return (best, corner, codes) if traced else (best, corner)
    B = a.shape[0]
    score = torch.empty((B,), dtype=torch.int32, device=a.device)
    corner = torch.empty((B,), dtype=torch.int32, device=a.device)
    plane = (torch.empty((B, b.shape[1], a.shape[1]), dtype=torch.uint8,
                         device=a.device) if traced else None)
    _kernels.psa_dp(a, b, lens, p, score, corner, plane)
    return (score, corner, plane) if traced else (score, corner)


def pack_pairs(seq_pairs, device, traced: bool = False):
    """Pad encoded (a, b) pairs into the DP kernel's inputs on ``device``:
    (a (B, n_pad) uint8, b (B, m_pad) uint8, lens (B, 2) int32 real
    (n, m)).  m_pad rounds to T_R; n_pad to LANES, or by
    :func:`_traced_n_pad` for a traced group."""
    n_real, m_real = _lengths(seq_pairs)
    n_pad = (_traced_n_pad(max(n_real)) if traced
             else (max(n_real) + LANES - 1) // LANES * LANES)
    m_pad = (max(m_real) + T_R - 1) // T_R * T_R
    a = np.full((len(seq_pairs), n_pad), A_PAD, np.uint8)
    b = np.full((len(seq_pairs), m_pad), B_PAD, np.uint8)
    for k, (x, y) in enumerate(seq_pairs):
        a[k, :len(x)] = x
        b[k, :len(y)] = y
    lens = np.array([n_real, m_real], np.int32).T.copy()
    return tuple(torch.from_numpy(t).to(device) for t in (a, b, lens))


def psa_align_batch_diff(seq_pairs, params, use_int16=None, mesh=None,
                         layout=None, device=None):
    """Score-only batch through the DP kernel (any pair length).

    ``seq_pairs``: encoded uint8 (a, b) pairs.  Returns (scores,
    corners) int32 numpy arrays in input order.  ``use_int16``, ``mesh``
    and a non-packed ``layout`` belong to later slices and raise.
    """
    _refuse_unported(use_int16, mesh, layout)
    p = as_params(params)
    if not supports_params(p):
        raise ValueError("packed kernel requires M>0>X, E<0, O<=0 "
                         "(got %s)" % (p,))
    if not seq_pairs:
        raise ValueError("empty pair batch")
    a, b, lens = pack_pairs(seq_pairs, resolve_device(device))
    scores, corners = dp_packed(a, b, lens, p, traced=False)
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
    _refuse_unported(mesh=mesh)
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
