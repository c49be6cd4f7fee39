"""State carried across from the JAX package.

The system has no weights; what crosses between the packages is the
scoring-parameter tuple and the traceback code plane.

* JAX plane: ``(m_pad // 4, P * Rp, 128)`` int32 words; byte k of
  ``plane[w, p*Rp + j // 128, j % 128]`` is the code of pair p's cell
  (4w + k, j) (``tsta_tpu/ops/psa_diff.py`` ``_psa_diff_traced_call``).
* Port plane: ``(P, m_pad, n_pad)`` uint8, one code per cell, row-major
  per pair (``csrc/psa_dp.cu``).

Both carry the same ``back*9 + f*3 + e`` codes, so either package's walk
can run on either package's plane.  Arrays cross as numpy (call
``np.asarray`` on a JAX array first); nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from tsta_tpu_torch.ops.psa_scan import as_params

LANES = 128


def params_from_jax(params) -> tuple:
    """An ``AlignParams`` or a 4-tuple -> the port's (match, mismatch,
    gap_extend, gap_open) int tuple."""
    p = as_params(params)
    if len(p) != 4:
        raise ValueError("expected 4 scoring parameters, got %d" % len(p))
    return p


def plane_from_jax(plane, P: int) -> torch.Tensor:
    """JAX ``(m_pad // 4, P*Rp, 128)`` int32 word plane -> the port's
    ``(P, m_pad, n_pad)`` uint8 plane (a CPU tensor)."""
    w = np.ascontiguousarray(np.asarray(plane), dtype=np.int32)
    if w.ndim != 3 or w.shape[2] != LANES or w.shape[1] % P:
        raise ValueError("expected (m_pad//4, P*Rp, %d) words for P=%d, "
                         "got %s" % (LANES, P, w.shape))
    m_w, S, _ = w.shape
    Rp = S // P
    # little-endian bytes: byte k of a word is row 4w + k
    by = w.astype("<i4").view(np.uint8).reshape(m_w, P, Rp, LANES, 4)
    out = by.transpose(1, 0, 4, 2, 3).reshape(P, 4 * m_w, Rp * LANES)
    return torch.from_numpy(np.ascontiguousarray(out))


def plane_to_jax(plane) -> np.ndarray:
    """The port's ``(P, m_pad, n_pad)`` uint8 plane -> the JAX
    ``(m_pad // 4, P*Rp, 128)`` int32 word plane (numpy; pass it to
    ``jnp.asarray``).  Needs m_pad % 4 == 0 and n_pad % 128 == 0."""
    if isinstance(plane, torch.Tensor):
        plane = plane.cpu().numpy()
    c = np.asarray(plane, dtype=np.uint8)
    if c.ndim != 3 or c.shape[1] % 4 or c.shape[2] % LANES:
        raise ValueError("expected (P, m_pad, n_pad) with m_pad % 4 == 0 "
                         "and n_pad % 128 == 0, got %s" % (c.shape,))
    P, m_pad, n_pad = c.shape
    Rp = n_pad // LANES
    by = c.reshape(P, m_pad // 4, 4, Rp, LANES).transpose(1, 0, 3, 4, 2)
    by = np.ascontiguousarray(by).reshape(m_pad // 4, P * Rp, LANES * 4)
    return by.view("<i4").astype(np.int32)
