"""TSTA on PyTorch + CUDA: the pairwise-alignment path of ``tsta_tpu``
ported to one NVIDIA Hopper card.

The package imports ``torch`` and never ``jax``.  Host code without jax
(``tsta_tpu.config``, ``tsta_tpu.io``, ``tsta_tpu.utils``) is shared
with the JAX package; the DP and the traceback walk run as hand-written
CUDA kernels (``csrc/``), each with a plain PyTorch version beside it
that the CPU runs.
"""

from tsta_tpu.config import AlignParams

__all__ = ["AlignParams"]
