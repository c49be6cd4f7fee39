"""Seeded read makers and the frozen example reads.

Frozen copies of ``chip_smoke.py``'s ``random_pairs`` and ``long_reads``
(the mutation rates and draw order unchanged, so one seed gives the same
reads as there), and readers of the example reads recovered once into
``portbench/data`` (``data/recover_examples.py``).
"""

from __future__ import annotations

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def read_fasta(name: str) -> list:
    """The records of ``data/<name>``, as bytes, in file order."""
    with open(os.path.join(DATA, name), "rb") as f:
        lines = f.read().split(b"\n")
    return [lines[k + 1] for k, ln in enumerate(lines) if ln.startswith(b">")]


def example_pair() -> tuple:
    """The reference's 10 kbp example pair (10,000 x 10,000 bp)."""
    a, b = read_fasta("example_pair.fa")
    return a, b


def example_msa_reads() -> list:
    """The reference's five ~5 kbp MSA example reads."""
    return read_fasta("example_msa_reads.fa")


def random_pairs(rng, lengths, similar) -> list:
    """Seeded pairs of uint8 arrays; ``similar(k)`` ones are ~12%
    substituted and ~3% indel copies, the rest independent."""
    pairs = []
    for k, (n, m) in enumerate(lengths):
        a = rng.integers(0, 4, n).astype(np.uint8)
        if similar(k):
            b = a.copy()
            b[rng.integers(0, n, n // 8)] = rng.integers(0, 4, n // 8)
            b = np.delete(b, rng.integers(0, n, n // 60))
            b = np.insert(b, rng.integers(0, len(b), n // 60),
                          rng.integers(0, 4, n // 60).astype(np.uint8))
            b = np.resize(b, m)
        else:
            b = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((ACGT[a], ACGT[b]))
    return pairs


def long_reads(seed: int, length: int) -> list:
    """A base read of ``length`` bp and two copies with 5% and 8%
    substitutions, each then with ``length // 50`` deletions."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, length).tobytes()

    def mut(s, rate):
        s = np.frombuffer(s, np.uint8).copy()
        m = rng.random(len(s)) < rate
        s[m] = ACGT[rng.integers(0, 4, m.sum())]
        return np.delete(s, rng.integers(0, len(s), len(s) // 50)).tobytes()

    return [base, mut(base, 0.05), mut(base, 0.08)]
