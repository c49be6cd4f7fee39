"""Recover the reference's example reads from its golden alignments.

The reference ships a 10 kbp example pair and five ~5 kbp MSA reads; the
repository keeps only their alignments (``tests/golden/example_big``).
The reads are those alignments' rows with the gaps removed.  This script
wrote ``example_pair.fa`` and ``example_msa_reads.fa`` beside it once;
the benchmark reads those frozen copies and never the golden files.

    python3 portbench/data/recover_examples.py tests/golden/example_big
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def pair_reads(golden: str) -> list:
    """The example pair: rows >1 and >2 of ``psa_default.out``."""
    with open(os.path.join(golden, "psa_default.out"), "rb") as f:
        lines = f.read().split(b"\n")
    if len(lines) != 4 or lines[0] != b">1" or lines[2] != b">2":
        raise ValueError("unexpected layout of psa_default.out")
    return [lines[1].replace(b"-", b""), lines[3].replace(b"-", b"")]


def msa_reads(golden: str) -> list:
    """The MSA example: rows >1..>5 of ``msa_default.out``."""
    with open(os.path.join(golden, "msa_default.out"), "rb") as f:
        lines = f.read().split(b"\n")
    return [lines[lines.index(b">%d" % k) + 1].replace(b"-", b"")
            for k in range(1, 6)]


def write_fasta(path: str, reads: list) -> None:
    with open(path, "wb") as f:
        for k, r in enumerate(reads, 1):
            f.write(b">%d\n%s\n" % (k, r))


def main(argv: list) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    write_fasta(os.path.join(HERE, "example_pair.fa"), pair_reads(argv[0]))
    write_fasta(os.path.join(HERE, "example_msa_reads.fa"),
                msa_reads(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
