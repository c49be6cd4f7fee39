"""The port's native MSA engine against the JAX package's on seeded
corpora (numpy), with zero tolerance on round scores, ``graph_len``,
``add_len``, rows and consensus: the 20 read sets of
``test_msa_quality.py`` (3-6 reads of 80-300 bp, 3-15% divergence,
insertions and deletions) under the JAX scan engine, and sets under
other scoring parameters under both JAX round engines (``poa`` is the
Pallas kernel in interpret mode)."""

from dataclasses import astuple

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu_torch.ops import msa_native


def _mutate(rng, base, div):
    s = bytearray(base)
    for i in rng.integers(0, len(s), max(1, int(len(s) * div))):
        s[i] = b"ACGT"[rng.integers(0, 4)]
    for _ in range(max(1, int(len(s) * div / 6))):
        j = int(rng.integers(0, len(s) - 2))
        if rng.random() < 0.5:
            del s[j]
        else:
            s.insert(j, b"ACGT"[rng.integers(0, 4)])
    return bytes(s)


def quality_corpus():
    """The read sets of test_msa_quality.test_native_vs_compat_quality_corpus
    (same generator and seed)."""
    rng = np.random.default_rng(0)
    sets = []
    for t in range(20):
        ln = int(rng.integers(80, 300))
        div = [0.03, 0.08, 0.15][t % 3]
        base = rng.choice(np.frombuffer(b"ACGT", np.uint8), ln).tobytes()
        nreads = int(rng.integers(3, 7))
        sets.append([_mutate(rng, base, div) for _ in range(nreads)])
    return sets


SETS = quality_corpus()


@pytest.mark.parametrize("k", range(len(SETS)))
def test_quality_corpus_matches_jax(k, monkeypatch):
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    want = jnative.align_seqs(SETS[k], AlignParams())
    got = msa_native.align_seqs(SETS[k], AlignParams(), device="cpu")
    assert astuple(got) == astuple(want)


@pytest.mark.parametrize("engine", ["scan", "poa"])
@pytest.mark.parametrize("seed,params", [
    (11, AlignParams(3, -2, -1, -6)), (12, AlignParams(1, -1, -1, 0)),
    (13, AlignParams(2, -3, -3, -1))])
def test_other_parameters_match_jax(seed, params, engine, monkeypatch):
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200).tobytes()
    seqs = [base] + [_mutate(rng, base, 0.1) for _ in range(3)]
    monkeypatch.setenv("TSTA_MSA_KERNEL", engine)
    want = jnative.align_seqs(seqs, params)
    got = msa_native.align_seqs(seqs, params, kernel="plain", device="cpu")
    assert astuple(got) == astuple(want)
