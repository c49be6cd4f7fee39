"""State carried across from the JAX package.

The system has no weights; what crosses between the packages is the
scoring-parameter tuple, the PSA traceback code plane, the POA round's
traceback word plane and the striped DP's input tile.

* JAX PSA plane: ``(m_pad // 4, P * Rp, 128)`` int32 words; byte k of
  ``plane[w, p*Rp + j // 128, j % 128]`` is the code of pair p's cell
  (4w + k, j) (``tsta_tpu/ops/psa_diff.py`` ``_psa_diff_traced_call``).
* Port PSA plane: ``(P, m_pad, n_pad)`` uint8, one code per cell,
  row-major per pair (``csrc/psa_dp.cu``).
* JAX round-1 plane of one pair: ``(m_pad, R, 128)`` int8, the code of
  cell (i, j) at ``plane[i, j // 128, j % 128]``
  (``tsta_tpu/ops/psa_pallas.py`` ``_psa_pallas``); the port's is the
  ``(m_pad, n_pad)`` uint8 plane of one pair.
* JAX chunk plane of a long traced pair: ``(mc // 4, R, 128)`` int32,
  byte k of ``plane[w, j // 128, j % 128]`` the code of the chunk's row
  4w + k (``tsta_tpu/ops/psa_pallas.py`` ``_psa_chunk_call``); its H/E
  frontier ``(R, 128)`` int32, column j at ``[j // 128, j % 128]``.
* Port chunk plane: ``(mc, n_pad)`` uint8; frontier ``(n_pad,)`` int32.
* JAX striped a: ``(G*P*Sp, 128)`` int32, pair k's column j at
  ``[k*Sp + j % Sp, j // Sp]`` (``psa_diff.psa_align_batch_diff``,
  ``layout="striped"``); the port's: ``(B, Sp, 128)`` uint8, one tile per
  pair (``ops/psa_diff.py`` ``pack_pairs_striped``).
* JAX POA words: ``(N // 2, Rp, 128)`` int32, two nodes per word, the
  even node in the low half (``tsta_tpu/ops/msa_pallas.py``
  ``_poa_chunk_call``); word ``words[v // 2, j // 128, j % 128]`` holds
  node v's cell at column j.
* Port POA words: ``(N, n)`` int16, one 16-bit word per cell, row-major
  (``csrc/poa_dp.cu``).

Each pair of planes carries the same codes, so either package's walk can
run on either package's plane.  Arrays cross as numpy (call
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


def r1_plane_from_jax(plane) -> torch.Tensor:
    """JAX round-1 ``(m_pad, R, 128)`` int8 plane (one code per cell,
    column j at ``[:, j // 128, j % 128]``; ``psa_pallas._psa_pallas``
    traced) -> the port's ``(m_pad, n_pad)`` uint8 plane (a CPU tensor)."""
    c = np.asarray(plane)
    if c.ndim != 3 or c.shape[2] != LANES or c.dtype.itemsize != 1:
        raise ValueError("expected (m_pad, R, %d) int8 codes, got %s %s"
                         % (LANES, c.dtype, c.shape))
    m_pad, R, _ = c.shape
    return torch.from_numpy(np.ascontiguousarray(c).view(np.uint8)
                            .reshape(m_pad, R * LANES).copy())


def chunk_plane_from_jax(plane) -> torch.Tensor:
    """JAX ``(mc // 4, R, 128)`` int32 chunk plane -> the port's ``(mc,
    n_pad)`` uint8 chunk plane (a CPU tensor): the one-pair case of
    :func:`plane_from_jax`."""
    return plane_from_jax(plane, 1)[0]


def frontier_from_jax(state) -> torch.Tensor:
    """JAX ``(R, 128)`` int32 per-column state (H, E, best or last of
    the chunked traced DP) -> the port's ``(n_pad,)`` int32 (CPU)."""
    w = np.asarray(state)
    if w.ndim != 2 or w.shape[1] != LANES:
        raise ValueError("expected (R, %d) state, got %s" % (LANES, w.shape))
    return torch.from_numpy(np.array(w, dtype=np.int32).reshape(-1))


def frontier_to_jax(state) -> np.ndarray:
    """The port's ``(n_pad,)`` int32 frontier -> the JAX ``(R, 128)``
    int32 state (numpy; pass it to ``jnp.asarray``)."""
    if isinstance(state, torch.Tensor):
        state = state.cpu().numpy()
    c = np.asarray(state, dtype=np.int32)
    if c.ndim != 1 or c.shape[0] % LANES:
        raise ValueError("expected (n_pad,) with n_pad %% %d == 0, got %s"
                         % (LANES, c.shape))
    return c.reshape(-1, LANES).copy()


def striped_tile_from_jax(a32, P: int, Sp: int) -> torch.Tensor:
    """JAX's striped ``a32``, ``(G*P*Sp, 128)`` int32 with group g's pair
    p at rows ``[(g*P + p)*Sp, (g*P + p + 1)*Sp)`` and column j of a pair
    at ``[j % Sp, j // Sp]`` (``psa_align_batch_diff`` with
    ``layout="striped"``) -> the port's ``(G*P, Sp, 128)`` uint8 tiles (a
    CPU tensor), one per pair, JAX's padding pairs included."""
    w = np.asarray(a32)
    if w.ndim != 2 or w.shape[1] != LANES or w.shape[0] % (P * Sp):
        raise ValueError("expected (G*%d*%d, %d) int32, got %s"
                         % (P, Sp, LANES, w.shape))
    if w.min(initial=0) < 0 or w.max(initial=0) > 255:
        raise ValueError("a32 holds values outside a byte")
    return torch.from_numpy(w.astype(np.uint8).reshape(-1, Sp, LANES))


def poa_words_from_jax(words) -> torch.Tensor:
    """JAX ``(N // 2, Rp, 128)`` int32 pair-packed POA words -> the port's
    ``(N, n)`` int16 plane (a CPU tensor), n = Rp * 128."""
    w = np.ascontiguousarray(np.asarray(words), dtype=np.int32)
    if w.ndim != 3 or w.shape[2] != LANES:
        raise ValueError("expected (N//2, Rp, %d) int32 words, got %s"
                         % (LANES, w.shape))
    m_w, Rp, _ = w.shape
    # little-endian halves: [..., 0] is the even node, [..., 1] the odd
    halves = w.astype("<i4").view("<i2").reshape(m_w, Rp, LANES, 2)
    out = halves.transpose(0, 3, 1, 2).reshape(2 * m_w, Rp * LANES)
    return torch.from_numpy(np.ascontiguousarray(out).astype(np.int16))


def poa_words_to_jax(words) -> np.ndarray:
    """The port's ``(N, n)`` int16 POA plane (numpy or tensor) -> the JAX
    ``(N // 2, Rp, 128)`` int32 pair-packed words (numpy; pass it to
    ``jnp.asarray``).  Needs N even and n % 128 == 0."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    c = np.asarray(words)
    if c.dtype != np.int16 or c.ndim != 2 or c.shape[0] % 2 \
            or c.shape[1] % LANES:
        raise ValueError("expected (N, n) int16 with N even and n %% %d "
                         "== 0, got %s %s" % (LANES, c.dtype, c.shape))
    N, n = c.shape
    pairs = c.astype("<i2").reshape(N // 2, 2, n // LANES, LANES)
    pairs = np.ascontiguousarray(pairs.transpose(0, 2, 3, 1))
    return pairs.view("<i4").reshape(N // 2, n // LANES, LANES).astype(
        np.int32)
