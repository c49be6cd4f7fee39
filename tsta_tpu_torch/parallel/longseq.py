"""Column-sharded PSA for one pair too long for one device's DP.

Counterpart of ``tsta_tpu/parallel/longseq.py``: the horizontal sequence
is sharded over the mesh's ``seq`` axis, rows advance in blocks of
``block`` rows, and at pipeline step s shard d runs row block s - d,
passing its right-edge state (each row's H at its last column and the
running F prefix) to shard d + 1 between steps.  JAX writes it at XLA
level (``shard_map`` + ``ppermute``); it replaces no Pallas kernel and its
values are the ring's (``ops/psa_ring.py``), so here it is the ring with
T = ``block``: a CPU mesh runs the shared plain schedule
(``psa_ring.ring_plain``), a one-card mesh one launch of the score-only
body ``csrc/psa_dp.cu`` at one pair, so that no plain DP runs on the card.
"""

from __future__ import annotations

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.ops import psa_ring


def align_long(a, b, params: AlignParams = AlignParams(), mesh=None,
               block: int = 32):
    """Score-only alignment of one long pair, columns sharded over the
    mesh's ``seq`` axis; ``(best, corner)`` as Python ints."""
    if mesh is None:
        raise ValueError("align_long requires a mesh with a 'seq' axis")
    return psa_ring.align_padded(a, b, params, mesh, block)
