"""TSTA on PyTorch + CUDA: the pairwise-alignment path and the native
MSA engine of ``tsta_tpu`` ported to one NVIDIA Hopper card.

The package imports ``torch`` and never ``jax``.  Host code without jax
(``tsta_tpu.config``, ``tsta_tpu.io``, ``tsta_tpu.utils``, the POA graph
``tsta_tpu.models.poa_graph`` with ``native/poa_fast.c``, and the compat
MSA engine of ``tsta_tpu.models.msa``) is shared with the JAX package;
the PSA DP and walk and the POA round DP and walk run as hand-written
CUDA kernels (``csrc/``), each with a plain PyTorch version beside it
that the CPU runs.
"""

from tsta_tpu.config import AlignParams

__all__ = ["AlignParams"]
