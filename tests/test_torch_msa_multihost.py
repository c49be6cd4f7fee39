"""The port's multi-process MSA (``parallel/msa_multihost.py``) in
one process, against the JAX package on the CPU with zero tolerance; the
twin of ``tests/test_msa_multihost.py``.

With no process group it is ``parallel/msa_longseq.py``'s
single-process wavefront over the mesh's ``seq`` windows (the CPU
repeated, the plain versions), and its walk still crosses every window;
the real multi-process runs are ``tests/test_torch_multihost.py``."""

import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu.parallel import mesh as jmeshlib
from tsta_tpu.parallel.msa_multihost import align_seqs_multihost as jmh
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import msa_native, msa_poa
from tsta_tpu_torch.parallel import mesh as meshlib
from tsta_tpu_torch.parallel import msa_longseq
from tsta_tpu_torch.parallel.msa_multihost import (align_seqs_multihost,
                                                   world)

CPU = torch.device("cpu")


def _corpus(rng, n_reads, ln, div=0.08):
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), ln).tobytes()
    seqs = []
    for _ in range(n_reads):
        s = bytearray(base)
        for i in rng.integers(0, len(s), max(1, int(len(s) * div))):
            s[i] = b"ACGT"[rng.integers(0, 4)]
        for _ in range(max(1, int(len(s) * div / 6))):
            j = int(rng.integers(0, len(s) - 2))
            if rng.random() < 0.5:
                del s[j]
            else:
                s.insert(j, b"ACGT"[rng.integers(0, 4)])
        seqs.append(bytes(s))
    return seqs


def _same(got, want):
    assert got.round_scores == want.round_scores
    assert got.rows == want.rows
    assert got.consensus == want.consensus
    assert got.add_len == want.add_len
    assert got.graph_len == want.graph_len


@pytest.mark.parametrize("seq_ax", [2, 4])
def test_multihost_msa_matches_jax(seq_ax):
    rng = np.random.default_rng(3)
    params = AlignParams()
    seqs = _corpus(rng, 4, 180)
    mesh = meshlib.make_mesh(1, seq_ax, devices=[CPU] * seq_ax)
    assert world() == (0, 1)
    out = align_seqs_multihost(seqs, params, mesh=mesh, rows_per_chunk=64)
    _same(out, jmh(seqs, params, mesh=jmeshlib.make_mesh(data=1,
                                                         seq=seq_ax)))
    _same(out, jnative.align_seqs(seqs, params))
    _same(align_seqs_multihost(seqs, params, device="cpu"),
          msa_native.align_seqs(seqs, params, device="cpu"))


def test_multihost_walk_crosses_every_window():
    """A read long enough that the walk crosses every window that holds
    it, its last column inside window 2 of the four (window 3 wholly past
    the read, so it runs no cell)."""
    rng = np.random.default_rng(11)
    params = AlignParams()
    seqs = _corpus(rng, 3, 700, div=0.12)
    mesh = meshlib.make_mesh(1, 4, devices=[CPU] * 4)
    stats = []
    out = align_seqs_multihost(seqs, params, mesh=mesh, rows_per_chunk=128,
                               stats=stats)
    _same(out, jmh(seqs, params, mesh=jmeshlib.make_mesh(data=1, seq=4)))
    _same(out, jnative.align_seqs(seqs, params))
    for st in stats:
        assert (st["n"], st["C"], st["active"]) == (1024, 256, 3)
        assert sorted(st["windows"]) == [0, 1, 2]
        for w in st["windows"].values():
            assert w["cells"] == st["chunks"] >= 4
            assert w["walk_ms"] is not None


def test_windows_past_the_read_compute_nothing():
    """A short read leaves the last windows wholly past its last column:
    they run no cell, and the round equals the single call's."""
    rng = np.random.default_rng(17)
    params = AlignParams(3, -2, -1, -6)
    seqs = _corpus(rng, 3, 150)
    stats = []
    g = PoaGraph.from_sequence(seqs[0], 3)
    packed, order = msa_longseq.wavefront_round(
        g, seqs[1], params, [CPU] * 8, rows_per_chunk=32, stats=stats)
    assert stats[0]["active"] == 2 and set(stats[0]["windows"]) == {0, 1}
    _same(align_seqs_multihost(seqs, params, mesh=meshlib.make_mesh(
        1, 8, devices=[CPU] * 8)), jnative.align_seqs(seqs, params))


def test_align_seqs_takes_a_link():
    """``align_seqs(link=LocalLink(devices))`` runs every round as the
    wavefront over the link's windows, whatever the mesh: the MSA equals
    JAX's, one window a device, each round's stats appended."""
    rng = np.random.default_rng(23)
    params = AlignParams()
    seqs = _corpus(rng, 4, 300)
    stats = []
    out = msa_native.align_seqs(seqs, params, link=msa_longseq.LocalLink(
        [CPU] * 3), rows_per_chunk=64, stats=stats)
    _same(out, jnative.align_seqs(seqs, params))
    assert len(stats) == 3
    for st in stats:
        assert st["K"] == 3 and sorted(st["windows"]) == list(
            range(st["active"]))
        assert all(w["cells"] == st["chunks"] for w in st["windows"].values())
    with pytest.raises(ValueError, match="RoundClock"):
        msa_native.align_seqs(seqs, params, link=msa_longseq.LocalLink(
            [CPU] * 2), clock=msa_poa.RoundClock(CPU))


def test_apply_delta_is_merge():
    """apply_delta replays what the in-process merge did (the delta
    contract the multi-process MSA rests on)."""
    rng = np.random.default_rng(5)
    params = AlignParams()
    seqs = _corpus(rng, 2, 120)
    g1 = PoaGraph.from_sequence(seqs[0], 2)
    g2 = PoaGraph.from_sequence(seqs[0], 2)
    packed, order = msa_longseq.wavefront_round(g1, seqs[1], params,
                                                [CPU] * 2)
    align = packed[2:2 + len(seqs[1])]
    added1 = msa_native._merge(g1, seqs[1], 1, order, align)
    added2 = g2.apply_delta(seqs[1], 1, order, align)
    assert added1 == added2
    assert g1.bases == g2.bases and g1.preds == g2.preds
    assert g1.weights == g2.weights
    g1.toposort()
    g2.toposort()
    assert g1.msa_rows() == g2.msa_rows()
    assert g1.consensus() == g2.consensus()
