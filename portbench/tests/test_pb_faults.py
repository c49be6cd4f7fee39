"""Each fault a cell can have, planted in the program underneath a CPU
rehearsal, turns ``correct`` false: the check sees what the timed path
produced."""

import io
import json

import pytest

from conftest import TINY
from portbench import run


def rehearse(workload):
    out, err = io.StringIO(), io.StringIO()
    assert run.run(workload, 2 ** 31 + 3, 0.3, False, device="cpu",
                   mix=TINY[workload], out=out, err=err) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_unbroken_runs_are_correct():
    for w in TINY:
        assert rehearse(w)["correct"] is True


def test_batch_half_left_out(monkeypatch):
    from tsta_tpu_torch.parallel import batch
    orig = batch.align_batch

    def half(pairs, *a, **k):
        return orig(pairs[:len(pairs) // 2], *a, **k)
    monkeypatch.setattr(batch, "align_batch", half)
    line = rehearse("psa_affine.batch128_score")
    assert line["correct"] is False and line["checks"]["pairs_wrong"][
        "value"] > 0


def test_batch_score_altered_where_produced(monkeypatch):
    from tsta_tpu_torch.ops import psa_diff
    orig = psa_diff.psa_align_batch_diff

    def altered(*a, **k):
        scores, corners = orig(*a, **k)
        scores = scores.copy()
        scores[-1] += 1
        return scores, corners
    monkeypatch.setattr(psa_diff, "psa_align_batch_diff", altered)
    assert rehearse("psa_affine.batch128_score")["correct"] is False


def test_traced_row_altered_where_produced(monkeypatch):
    from tsta_tpu_torch.ops import psa_pallas
    orig = psa_pallas.psa_align_traced_device

    def altered(*a, **k):
        score, corner, aln = orig(*a, **k)
        row = bytearray(aln.a_row)
        k0 = next(i for i, c in enumerate(row) if c != ord("-"))
        row[k0] = ord("A") if row[k0] != ord("A") else ord("C")
        return score, corner, aln._replace(a_row=bytes(row))
    monkeypatch.setattr(psa_pallas, "psa_align_traced_device", altered)
    line = rehearse("psa_affine.pair200k_traced")
    assert line["correct"] is False
    assert line["checks"]["rows_not_reads"]["value"] > 0


def test_traced_score_altered_where_produced(monkeypatch):
    from tsta_tpu_torch.ops import psa_pallas
    orig = psa_pallas.psa_align_traced_device

    def altered(*a, **k):
        score, corner, aln = orig(*a, **k)
        return score, corner + 1, aln
    monkeypatch.setattr(psa_pallas, "psa_align_traced_device", altered)
    assert rehearse("psa_affine.pair200k_traced")["checks"]["corner_gap"][
        "value"] == 1


def test_msa_round_that_leaves_the_graph_unchanged(monkeypatch):
    from tsta_tpu_torch.ops import msa_native
    monkeypatch.setattr(msa_native, "_merge", lambda *a, **k: 0)
    line = rehearse("msa_poa.reads3x50k")
    assert line["correct"] is False


def test_msa_round_score_altered_where_produced(monkeypatch):
    from tsta_tpu_torch.ops import msa_native
    orig = msa_native._finish_round

    def altered(g, seq, seq_no, order, host, scores, glen, alen):
        orig(g, seq, seq_no, order, host, scores, glen, alen)
        scores[-1] += 1
    monkeypatch.setattr(msa_native, "_finish_round", altered)
    line = rehearse("msa_poa.reads3x50k")
    assert line["correct"] is False
    assert line["checks"]["round_score_gap"]["value"] == 1


@pytest.mark.parametrize("base", [0, 1])
def test_msa_row_altered_where_produced(monkeypatch, base):
    from tsta_tpu_torch.models import poa_graph
    orig = poa_graph.PoaGraph.msa_rows

    def altered(self):
        rows = orig(self)
        r = bytearray(rows[base])
        k0 = next(i for i, c in enumerate(r) if c != ord("-"))
        r[k0] = ord("A") if r[k0] != ord("A") else ord("C")
        rows[base] = bytes(r)
        return rows
    monkeypatch.setattr(poa_graph.PoaGraph, "msa_rows", altered)
    assert rehearse("msa_poa.reads3x50k")["correct"] is False
