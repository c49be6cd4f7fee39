"""The port's native MSA engine against the JAX package's on the CPU, with
zero tolerance: round scores, ``graph_len``, ``add_len``, rows and
consensus on the MSA goldens' reads (each with its ``params.txt``) under
both JAX round engines (``TSTA_MSA_KERNEL=scan`` and ``poa``, the latter
the Pallas kernel in interpret mode); checkpoint resume; the fleet; the
in-degree > 64 route; the 'N' warning.  Seeded corpora are in
``test_torch_msa_corpora.py``."""

import logging
import os
from dataclasses import astuple

import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams
from tsta_tpu.io import read_records
from tsta_tpu.models.poa_graph import PoaGraph
from tsta_tpu_torch.models import poa_graph as tgraph
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu_torch.ops import msa_native

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MSA_CASES = ["msa_small%d" % k for k in range(1, 6)]


def fixture_input(case):
    """The golden case's reads and its ``params.txt`` parameters."""
    d = os.path.join(GOLDEN, case)
    seqs = [r.sequence for r in read_records(os.path.join(d, "seqs.fa"))]
    with open(os.path.join(d, "params.txt")) as f:
        toks = f.read().split()
    names = {"-M": "match", "-X": "mismatch", "-E": "gap_extend",
             "-O": "gap_open"}
    kw = {names[k]: int(v) for k, v in zip(toks[::2], toks[1::2])}
    return seqs, AlignParams(**kw)


def corpus(seed, n_reads=4, length=None, div=0.1):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    length = length or int(rng.integers(120, 300))
    base = rng.choice(acgt, length)
    reads = [base.tobytes()]
    for _ in range(n_reads - 1):
        s = base.copy()
        hit = rng.integers(0, length, int(length * div))
        s[hit] = rng.choice(acgt, hit.size)
        s = np.delete(s, rng.integers(0, length, int(length * div / 8)))
        ins = rng.integers(0, s.size, max(1, int(length * div / 10)))
        reads.append(np.insert(s, ins, rng.choice(acgt, ins.size))
                     .tobytes())
    return reads


def jax_run(seqs, params, engine, monkeypatch):
    monkeypatch.setenv("TSTA_MSA_KERNEL", engine)
    return jnative.align_seqs(seqs, params)


@pytest.mark.parametrize("engine", ["scan", "poa"])
@pytest.mark.parametrize("case", MSA_CASES)
def test_native_matches_jax_on_goldens(case, engine, monkeypatch):
    seqs, params = fixture_input(case)
    want = jax_run(seqs, params, engine, monkeypatch)
    got = msa_native.align_seqs(seqs, params, device="cpu")
    assert astuple(got) == astuple(want)


def test_single_read_and_bad_arguments(monkeypatch):
    seqs = corpus(5, n_reads=1)
    assert (astuple(msa_native.align_seqs(seqs, device="cpu"))
            == astuple(jax_run(seqs, AlignParams(), "scan", monkeypatch)))
    with pytest.raises(ValueError):
        msa_native.align_seqs([], device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        msa_native.align_seqs(seqs, kernel="fast", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        msa_native.align_seqs(seqs, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="empty read set"):
        msa_native.align_seqs_many([seqs, []], device="cpu")


class _Stop(Exception):
    pass


def _stop_at(k):
    def progress(done, total):
        if done == k and done < total:
            raise _Stop
    return progress


def test_checkpoint_resume(tmp_path, monkeypatch):
    seqs = corpus(21, n_reads=5)
    params = AlignParams()
    fresh = msa_native.align_seqs(seqs, params, device="cpu")
    ck = str(tmp_path / "g.npz")
    with pytest.raises(_Stop):
        msa_native.align_seqs(seqs, params, checkpoint_path=ck,
                              progress=_stop_at(2), device="cpu")
    seen = []
    resumed = msa_native.align_seqs(
        seqs, params, checkpoint_path=ck, device="cpu",
        progress=lambda d, t: seen.append((d, t)))
    assert resumed == fresh
    assert seen == [(2, 4), (3, 4), (4, 4)]
    # a snapshot of other reads or parameters is ignored
    other = msa_native.align_seqs(seqs, AlignParams(3, -2, -1, -6),
                                  checkpoint_path=ck, device="cpu")
    assert other == msa_native.align_seqs(seqs, AlignParams(3, -2, -1, -6),
                                          device="cpu")
    # the JAX package's snapshot resumes in the port
    ck2 = str(tmp_path / "j.npz")
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    with pytest.raises(_Stop):
        jnative.align_seqs(seqs, params, checkpoint_path=ck2,
                           progress=_stop_at(3))
    assert msa_native.align_seqs(seqs, params, checkpoint_path=ck2,
                                 device="cpu") == fresh


def test_align_seqs_many_equals_single_runs(monkeypatch):
    sets = [corpus(31), corpus(32, n_reads=2), corpus(33, n_reads=1),
            corpus(34, n_reads=5)]
    outs = msa_native.align_seqs_many(sets, device="cpu")
    assert len(outs) == len(sets)
    for seqs, out in zip(sets, outs):
        assert out == msa_native.align_seqs(seqs, device="cpu")
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    assert [astuple(o) for o in outs] == [
        astuple(o) for o in jnative.align_seqs_many(sets, AlignParams())]


def test_in_degree_over_64_takes_the_wide_plain_round(monkeypatch):
    """A graph past the 16-bit words' 64 preds runs the plain round with
    wide words (the JAX package routes it to its scan engine), counted in
    ``plain_rounds``."""
    def hacked(orig):
        def from_sequence(seq, n_seq):
            g = orig(seq, n_seq)
            tail = len(g) - 1
            for _ in range(65):
                g.add_edge(g.add_node(ord("A"), 0), tail)
            g.toposort()
            return g
        return staticmethod(from_sequence)

    for cls in (PoaGraph, tgraph.PoaGraph):
        monkeypatch.setattr(cls, "from_sequence", hacked(cls.from_sequence))
    seqs = corpus(41, n_reads=3, length=80)
    want = jax_run(seqs, AlignParams(), "scan", monkeypatch)
    p0 = msa_native.plain_rounds
    got = msa_native.align_seqs(seqs, device="cpu")
    assert astuple(got) == astuple(want)
    assert msa_native.plain_rounds == p0 + 2
    assert [astuple(o) for o in msa_native.align_seqs_many(
        [seqs], device="cpu")] == [astuple(want)]
    assert msa_native.plain_rounds == p0 + 4


def test_n_warning_only_for_uppercase_n(caplog):
    """A deliberate divergence from the JAX package, which warns on any
    non-ACGT byte: only 'N' scores differently between the engines."""
    base = corpus(51, n_reads=3, length=60)
    with_n = [base[0], base[1][:30] + b"N" + base[1][31:], base[2]]
    lower = [base[0], base[1][:30] + b"n" + base[1][31:], base[2]]
    other = [base[0], base[1][:30] + b"R" + base[1][31:], base[2]]
    for seqs, warned in ((with_n, True), (lower, False), (other, False),
                         (base, False)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="tsta"):
            msa_native.align_seqs(seqs, device="cpu")
        assert any("'N'" in r.getMessage()
                   for r in caplog.records) == warned
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="tsta"):
        msa_native.align_seqs_many([base, with_n], device="cpu")
    assert sum("'N'" in r.getMessage() for r in caplog.records) == 1


def test_round_clock_records_each_round():
    from tsta_tpu_torch.ops import msa_poa
    clock = msa_poa.RoundClock(torch.device("cpu"))
    out = msa_native.align_seqs(corpus(61), device="cpu", clock=clock)
    assert len(clock.rounds) == len(out.round_scores) == 3
    for r in clock.rounds:
        assert set(r) == {"prep_s", "dp_ms", "walk_ms", "wait_transfer_s",
                          "merge_s"}
        assert min(r.values()) >= 0
