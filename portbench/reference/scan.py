"""A running maximum along a long row, computed in parallel pieces.

``torch.cummax`` along a row scans it in one thread block, so a row of
200,000 cells takes ~0.4 ms however few rows there are.  Cut into
pieces of ``PIECE`` cells, the pieces scan side by side; each piece then
takes the running maximum of the pieces before it."""

from __future__ import annotations

import torch

PIECE = 512


def padded(n: int) -> int:
    """The row length ``prefix_max`` takes: n rounded up to a piece."""
    return -(-n // PIECE) * PIECE


def prefix_max(x: torch.Tensor) -> torch.Tensor:
    """The running maximum of ``x`` (..., n) along its last dim, n a
    multiple of ``PIECE``."""
    *lead, n = x.shape
    inner = torch.cummax(x.view(*lead, n // PIECE, PIECE), dim=-1).values
    carry = torch.cummax(inner[..., -1], dim=-1).values
    inner[..., 1:, :] = torch.maximum(inner[..., 1:, :],
                                      carry[..., :-1, None])
    return inner.view(*lead, n)
