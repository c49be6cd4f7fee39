"""Pairwise sequence alignment pipeline.

Counterpart of ``tsta_tpu/models/psa.py``: load two FASTA sequences,
orient the longer one horizontally (the reference's psa/psa.c:194-199),
run the DP, report the matrix-max score and, traced, the aligned pair.

``kernel`` selects the route:

* ``auto``: the CUDA kernels (DP, then the device walk) for every
  parameter set with X < 0, E < 0 and O <= 0 (the packed kernels of
  ``ops/psa_diff.py`` for M > 0, the round-1 ones of
  ``ops/psa_pallas.py`` for any M), the ``psa_scan`` oracle for X >= 0 or
  E >= 0; on a CPU device the kernels' plain PyTorch versions run
  instead.  A traced pair whose code plane exceeds the device budget (a
  ~200 kbp pair on an 80 GB card) runs in row-chunks
  (``ops/psa_chunked.py``);
* ``cuda``: the kernels only (a CUDA device, X < 0, E < 0, O <= 0);
* ``plain``: the ``psa_scan`` oracle and the host walk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.io import encode_dna, read_first_record
from tsta_tpu_torch.device import resolve_device
from tsta_tpu_torch.ops import psa_pallas, psa_scan, traceback
from tsta_tpu_torch.utils import profiling

KERNELS = ("auto", "plain", "cuda")

# The reference initialises its running max to -100 (psa/psa.c:110,590),
# so its printed `maxsorce` is floored there; the CLI applies the floor.
REFERENCE_SCORE_FLOOR = -100


@dataclasses.dataclass
class PsaOutput:
    score: int                      # max over all H cells (reference semantics)
    corner: int                     # H(m-1, n-1): the global alignment score
    swapped: bool                   # True if input order was swapped
    a_row: Optional[bytes] = None   # aligned horizontal sequence ('>1')
    b_row: Optional[bytes] = None   # aligned vertical sequence ('>2')


def align_pair(seq1: bytes, seq2: bytes, params: AlignParams = AlignParams(),
               traced: bool = False, swap: bool = True,
               kernel: str = "auto", device=None) -> PsaOutput:
    """Align two byte sequences on ``device`` (default CUDA).

    ``swap`` mirrors the reference: the longer sequence becomes the
    horizontal axis (columns).
    """
    if kernel not in KERNELS:
        raise ValueError("kernel must be one of %s (got %r)"
                         % (", ".join(KERNELS), kernel))
    dev = resolve_device(device)
    if kernel == "cuda":
        if dev.type != "cuda":
            raise ValueError("kernel='cuda' needs a CUDA device (got %s)"
                             % dev)
        if not psa_pallas.in_round1_domain(params):
            raise ValueError("kernel='cuda' requires X<0, E<0, O<=0; use "
                             "kernel='auto' or 'plain'")
    swapped = False
    if swap and len(seq2) > len(seq1):
        seq1, seq2 = seq2, seq1
        swapped = True
    a = encode_dna(seq1)
    b = encode_dna(seq2)
    kernels = kernel != "plain" and psa_pallas.in_round1_domain(params)
    with profiling.span("psa traced" if traced else "psa score"):
        if kernels and traced:
            score, corner, aln = psa_pallas.psa_align_traced_device(
                a, b, params, device=dev)
            return PsaOutput(score=score, corner=corner, swapped=swapped,
                             a_row=aln.a_row, b_row=aln.b_row)
        if kernels:
            sc, co = psa_pallas.psa_align_batch([(a, b)], params,
                                                device=dev)
            return PsaOutput(score=int(sc[0]), corner=int(co[0]),
                             swapped=swapped)
        res = psa_scan.psa_align(a, b, params, traced=traced, device=dev)
    out = PsaOutput(score=res.score, corner=res.last, swapped=swapped)
    if traced:
        aln = traceback.decode_pair(res.back.cpu().numpy(),
                                    res.fback.cpu().numpy(),
                                    res.eback.cpu().numpy(), a, b)
        out.a_row, out.b_row = aln.a_row, aln.b_row
    return out


def align_files(path1: str, path2: str, params: AlignParams = AlignParams(),
                traced: bool = False, kernel: str = "auto",
                device=None) -> PsaOutput:
    """Reference-compatible entry: first record of each input file
    (FASTA or FASTQ, gzip ok)."""
    rec1 = read_first_record(path1)
    rec2 = read_first_record(path2)
    if rec1 is None or rec2 is None:
        raise ValueError("empty sequence input")
    return align_pair(rec1.sequence, rec2.sequence, params, traced=traced,
                      kernel=kernel, device=device)


def write_alignment(out: PsaOutput, path: str) -> None:
    """Write the aligned pair in the reference's output format:
    '>1\\n<a>\\n>2\\n<b>' with no trailing newline (psa/psa.c:512-515)."""
    with open(path, "wb") as f:
        f.write(b">1\n" + out.a_row + b"\n>2\n" + out.b_row)
