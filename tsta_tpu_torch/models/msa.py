"""Progressive POA multiple sequence alignment pipeline.

Counterpart of ``tsta_tpu/models/msa.py``: read N FASTA records, build a
linear POA graph from the first, fuse each further read through one
alignment round, and emit the row-wise MSA and the heaviest-bundle
consensus.  Two engines:

* ``compat``: the JAX package's bit-exact C engine
  (``tsta_tpu/native/compat_msa.c``, on the host; ``device`` and
  ``kernel`` do not apply);
* ``native``: the exact int32 engine of this package
  (``ops/msa_native.py``), its rounds on ``device`` through the POA
  kernels or, with ``kernel="plain"`` or on the CPU, their plain
  versions.
"""

from __future__ import annotations

from typing import List

import tsta_tpu.models.msa as compat_msa
from tsta_tpu.config import AlignParams
from tsta_tpu.io import read_records
from tsta_tpu.models.msa import MsaOutput, write_result
from tsta_tpu_torch.ops import msa_native

__all__ = ["MsaOutput", "align_file", "align_seqs", "write_result"]


def align_seqs(seqs: List[bytes], params: AlignParams = AlignParams(),
               engine: str = "compat", width: int = 10, mesh=None,
               checkpoint_path=None, threads: int = 0, progress=None,
               kernel: str = "auto", device=None) -> MsaOutput:
    """Progressive POA MSA of ``seqs`` (byte strings).  ``width`` and
    ``threads`` are the compat engine's stripe multiplier (reference -W)
    and OpenMP cap (-T); ``checkpoint_path``, ``progress``, ``kernel`` and
    ``device`` belong to the native engine.  ``mesh`` (multi-GPU) is not
    ported and raises ``NotImplementedError``."""
    if not seqs:
        raise ValueError("no sequences")
    for i, s in enumerate(seqs):
        if len(s) == 0:
            raise ValueError("sequence %d is empty" % i)
    if mesh is not None:
        raise NotImplementedError("multi-GPU MSA is a later slice of the "
                                  "port")
    if engine == "native":
        return msa_native.align_seqs(seqs, params,
                                     checkpoint_path=checkpoint_path,
                                     progress=progress, kernel=kernel,
                                     device=device)
    if engine != "compat":
        raise ValueError("unknown MSA engine %r" % engine)
    return compat_msa.align_seqs(seqs, params, engine="compat", width=width,
                                 checkpoint_path=checkpoint_path,
                                 threads=threads)


def align_file(path: str, params: AlignParams = AlignParams(),
               engine: str = "compat", width: int = 10, mesh=None,
               checkpoint_path=None, threads: int = 0, progress=None,
               kernel: str = "auto", device=None) -> MsaOutput:
    """Every record of a FASTA/FASTQ file (gzip ok) through
    :func:`align_seqs`."""
    seqs = [r.sequence for r in read_records(path)]
    return align_seqs(seqs, params, engine=engine, width=width, mesh=mesh,
                      checkpoint_path=checkpoint_path, threads=threads,
                      progress=progress, kernel=kernel, device=device)
