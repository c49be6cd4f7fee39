"""Progressive POA multiple sequence alignment pipeline.

Counterpart of ``tsta_tpu/models/msa.py``: read N FASTA records, build a
linear POA graph from the first, fuse each further read through one
alignment round, and emit the row-wise MSA and the heaviest-bundle
consensus.  Two engines:

* ``compat``: the bit-exact C engine (``native/compat_msa.c``, on the
  host; ``device`` and ``kernel`` do not apply);
* ``native``: the exact int32 engine of this package
  (``ops/msa_native.py``), its rounds on ``device`` through the POA
  kernels or, with ``kernel="plain"`` or on the CPU, their plain
  versions; with ``mesh``, each round's columns over the mesh's ``seq``
  axis (``parallel/msa_longseq.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.io import read_records

__all__ = ["MsaOutput", "align_file", "align_seqs", "write_result"]


@dataclasses.dataclass
class MsaOutput:
    rows: List[bytes]            # aligned rows, one per input sequence
    consensus: bytes
    round_scores: List[int]      # per-round absolute end scores (lastsorce)
    graph_len: List[int]         # graph size after each round's fusion
    add_len: List[int]           # nodes added per round (poa_add_len)


def align_seqs(seqs: List[bytes], params: AlignParams = AlignParams(),
               engine: str = "compat", width: int = 10, mesh=None,
               checkpoint_path=None, threads: int = 0, progress=None,
               kernel: str = "auto", device=None) -> MsaOutput:
    """Progressive POA MSA of ``seqs`` (byte strings).  ``width`` and
    ``threads`` are the compat engine's stripe multiplier (reference -W)
    and OpenMP cap (-T); ``checkpoint_path``, ``progress``, ``kernel``,
    ``device`` and ``mesh`` (each round's columns over the mesh's ``seq``
    axis, on its devices) belong to the native engine."""
    if not seqs:
        raise ValueError("no sequences")
    for i, s in enumerate(seqs):
        if len(s) == 0:
            raise ValueError("sequence %d is empty" % i)
    if engine == "native":
        from tsta_tpu_torch.ops import msa_native
        return msa_native.align_seqs(seqs, params,
                                     checkpoint_path=checkpoint_path,
                                     progress=progress, kernel=kernel,
                                     device=device, mesh=mesh)
    if engine != "compat":
        raise ValueError("unknown MSA engine %r" % engine)
    if mesh is not None:
        raise ValueError("mesh sharding requires engine='native'")
    if checkpoint_path is not None:
        raise ValueError("per-round checkpointing requires "
                         "engine='native'")
    return _align_compat(seqs, params, width, threads)


def _align_compat(seqs, params, width: int, threads: int) -> MsaOutput:
    """All rounds in one call of the C engine (``tsta_msa_run``)."""
    from tsta_tpu_torch.native import build
    lib = build.load()
    n = len(seqs)
    arr = (ctypes.c_char_p * n)(*[bytes(s) for s in seqs])
    lens = (ctypes.c_int * n)(*[len(s) for s in seqs])
    res = build.MsaResultStruct()
    rc = lib.tsta_msa_run(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), lens, n,
        params.match, params.mismatch, params.gap_extend, params.gap_open,
        width, threads, ctypes.byref(res))
    if rc != 0:
        # free the result arrays tsta_msa_run allocated before failing
        # (rows/msa/consensus are zero-initialised, so free is safe)
        lib.tsta_msa_free(ctypes.byref(res))
        if rc == -2:
            raise RuntimeError(
                "compat MSA engine: a graph node's in-degree exceeded the "
                "engine's 64-predecessor limit (very many divergent reads); "
                "use engine='native', which has no such limit")
        raise RuntimeError("compat MSA engine failed (rc=%d)" % rc)
    try:
        return MsaOutput(
            rows=[ctypes.string_at(res.msa[i]) for i in range(res.rows)],
            consensus=bytes(res.consensus),
            round_scores=[res.last_scores[i] for i in range(res.rounds)],
            graph_len=[res.graph_len[i] for i in range(res.rounds)],
            add_len=[res.add_len[i] for i in range(res.rounds)])
    finally:
        lib.tsta_msa_free(ctypes.byref(res))


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


def write_result(out: MsaOutput, path: str) -> None:
    """Write MSA rows + consensus in the reference's output format
    (result.c:68-78: '>%d' rows then 'consensus:' with no trailing
    newline)."""
    with open(path, "wb") as f:
        for i, row in enumerate(out.rows):
            f.write(b">%d\n" % (i + 1) + row + b"\n")
        f.write(b"consensus:\n" + out.consensus)
