"""Runtime configuration objects.

The reference has no config system beyond per-binary ``getopt`` flags
(psa/psa.c:546-581, msa/msa.c:81-113) and compile-time SIMD width macros.
Here all knobs live in dataclasses; scoring parameters are runtime values
(arrays fed to jitted kernels), block sizes are static shapes.

The port's own copy of ``tsta_tpu/config.py``, so that the port imports
nothing of the JAX package; the tests hold the two against each other.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignParams:
    """Affine-gap scoring parameters.

    Matches the reference defaults (psa/psa.c:114-117, msa/msa.c:21-24).
    A gap of length k costs ``O + k * E`` (open+extend charged together --
    ``ogap = O + E`` per reference psa/psa.c:241).
    """

    match: int = 2       # -M
    mismatch: int = -5   # -X
    gap_extend: int = -2  # -E
    gap_open: int = -4   # -O

    def __post_init__(self) -> None:
        if self.gap_extend > 0 or self.gap_open > 0:
            raise ValueError("gap penalties must be <= 0 (got E=%d O=%d)"
                             % (self.gap_extend, self.gap_open))

    @property
    def ogap(self) -> int:
        """Cost of the first gap column (open + extend)."""
        return self.gap_open + self.gap_extend

    @classmethod
    def linear(cls, match: int = 2, mismatch: int = -5,
               gap: int = -2) -> "AlignParams":
        """Linear gap model: gap of length k costs ``k * gap`` (O == 0)."""
        return cls(match=match, mismatch=mismatch, gap_extend=gap, gap_open=0)


# Engine-level knobs are plain keyword arguments on the pipeline entry
# points (models/psa.align_pair(kernel=...), models/msa.align_seqs(engine=,
# width=, mesh=, checkpoint_path=...)) rather than a config object: every
# knob is local to one call site and scoring params (AlignParams) are the
# only state shared across the stack.
