"""TSTA on PyTorch + CUDA: the pairwise-alignment path and the native
MSA engine of ``tsta_tpu`` ported to one NVIDIA Hopper card.

The package imports ``torch`` and never ``jax``, nor anything of the JAX
package: it keeps its own copies of the host code it needs (``config``,
``io`` with ``native/seqio_fast.c``, ``utils``, the POA graph
``models/poa_graph.py`` with ``native/poa_fast.c``, and the compat MSA
engine ``native/compat_msa.c``).  The PSA DP and walk and the POA round
DP and walks, chunked rounds included, run as hand-written CUDA kernels
(``csrc/``), each with a plain PyTorch version beside it that the CPU
runs.
"""

from tsta_tpu_torch.config import AlignParams

__all__ = ["AlignParams"]
