"""Sequence byte encoding and padding helpers.

The device kernels operate on raw uint8 byte codes (the ASCII bytes of the
sequence).  Substitution scoring is equality-based (match/mismatch), mirroring
the reference's ``cmpeq`` substitution (psa/psa.c:253-254), so no 2-bit
packing is needed for correctness; padding uses a sentinel byte that never
equals a real base.

Reference padding semantics:
* PSA pads both sequences up to a multiple of the block width L
  (psa/psa.c:202-205).  Padded *columns* of seq0 hold uninitialised heap
  bytes in the reference; with any sensible scoring (X<0, E<0) those columns
  can never attain the matrix max, so we use PAD (0) which never matches.
  Padded *rows* are simply skipped (psa/psa.c:404-409).
* MSA pads the new sequence with ``'N'`` (msa/c-t-simd.c:46) and the kernel
  forces 'N' columns to contribute 0 to the running block anchor
  (c-t-simd.c:481), making right-padding score-neutral.

The port's own copy of ``tsta_tpu/io/encode.py``, so that the port
imports nothing of the JAX package; the tests hold the two against each
other.
"""

from __future__ import annotations

import numpy as np

PAD = np.uint8(0)     # never equals any sequence byte
N_BYTE = np.uint8(ord("N"))


def encode_dna(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Return the sequence as a uint8 array of its raw bytes."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode()
    return np.frombuffer(seq, dtype=np.uint8).copy()


def pad_to_multiple(a: np.ndarray, mult: int, fill: int = PAD) -> np.ndarray:
    """Right-pad a 1-D array to the next multiple of ``mult`` with ``fill``."""
    n = a.shape[0]
    if mult <= 0 or n % mult == 0:
        return a
    padded = np.full(((n + mult - 1) // mult) * mult, fill, dtype=a.dtype)
    padded[:n] = a
    return padded


def stripe_permutation(L: int, lanes: int) -> np.ndarray:
    """Logical->memory column permutation of the reference's striped layout.

    ``NUM2(j) = (j/L)*L + ((j%L) % W)*B + (j%L)/W`` with ``B=lanes``,
    ``W=L/B`` (psa/psa.c:112, msa/c-t-simd.c:14).  Only used by the compat
    engine and by tests that compare raw traceback planes; the TPU kernels
    use natural (row-major) layout.
    """
    W = L // lanes
    j = np.arange(L)
    return (j % W) * lanes + j // W
