"""MSA rounds past 64 preds (the wide forms: 32-bit words with 13-bit pred
fields) against the JAX package on the CPU, with zero tolerance.

A graph's in-degree is raised by a deletion staircase
(``test_torch_kernels._staircase``: edges into one node from each of the
k nodes before it in topo order, as reads with deletions of every length
up to k ending at one base make them), and reads with long deletions
ending at that node make the walk take a pred far down its table.  The
JAX package sends such rounds to its scan engine (``TSTA_MSA_KERNEL=scan``
here); the port runs them through the plain versions on the CPU
(``msa_native.round_dp_plain`` with 13-bit fields, ``walk_plain``) and
through the kernels' wide forms on a card (``tests/test_torch_kernels.py``
holds those to the plain versions).  Covered: single-call rounds at
in-degree 65, 100 and 128 through ``align_seqs`` and ``align_seqs_many``;
a chunked wide round against JAX's unchunked scan; the memory plan's word
size; the wide staged-walk replay against ``walk_plain``; ``kernel="cuda"``
on the CPU; and what JAX's int8 pred fields give past table index 127."""

import os
from dataclasses import astuple

import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams as JParams
from tsta_tpu.models.poa_graph import PoaGraph as JGraph
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import CPU_BUDGET
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import _kernels, msa_native, msa_poa

from test_torch_kernels import _staircase

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _deletion_set(seed, length, at, dels, subs=20):
    """A base read and one read per entry of ``dels``: ~``subs``
    substitutions and a deletion of that many bases ending just before
    position ``at``, so its walk enters the staircase node ``at`` from
    the pred ``dels[k]`` rows up."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, length)
    out = [base.tobytes()]
    for d in dels:
        s = base.copy()
        s[rng.integers(0, length, subs)] = rng.choice(ACGT, subs)
        out.append(np.concatenate([s[:at - d], s[at:]]).tobytes())
    return out


@pytest.fixture
def stair(monkeypatch):
    """``stair(k, at)``: both packages' ``PoaGraph.from_sequence`` give
    the read's chain with node ``at``'s in-degree raised to ``k``."""
    def patch(k, at):
        for cls in (JGraph, PoaGraph):
            orig = cls.from_sequence

            def from_sequence(seq, n_seq, orig=orig):
                g = orig(seq, n_seq)
                _staircase(g, k, at)
                return g
            monkeypatch.setattr(cls, "from_sequence",
                                staticmethod(from_sequence))
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    return patch


# (in-degree, the deletions that end at the staircase node): a deletion
# of d bases enters it from its pred at table index d (the chain edge is
# index 0, the staircase's nearest pred 1)
WIDE = [(65, (64, 30)), (100, (90, 70)), (128, (127, 100))]


@pytest.mark.parametrize("k,dels", WIDE)
def test_wide_rounds_match_jax_scan(stair, k, dels):
    stair(k, 200)
    seqs = _deletion_set(k, 300, 200, dels)
    other = _deletion_set(k + 1, 280, 150, (20,))
    want = jnative.align_seqs(seqs, JParams())
    p0 = msa_native.plain_rounds
    got = msa_native.align_seqs(seqs, AlignParams(), device="cpu")
    assert astuple(got) == astuple(want)
    assert msa_native.plain_rounds == p0 + len(dels)
    outs = msa_native.align_seqs_many([seqs, other], AlignParams(),
                                      device="cpu")
    assert astuple(outs[0]) == astuple(want)
    assert astuple(outs[1]) == astuple(jnative.align_seqs(other, JParams()))
    # the staircase node's round-1 pred is the deletion's (index dels[0])
    g = PoaGraph.from_sequence(seqs[0], 2)
    assert g.max_in_degree() == k
    prep, n, n_real, a, NC, _ = msa_poa.prep_round(g, seqs[1], AlignParams(),
                                                   CPU_BUDGET)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    words, scores = msa_native.round_dp_plain(*t, n_real, len(order),
                                              AlignParams(), W)
    assert words.dtype == torch.int32 and NC is None
    best = msa_poa.best_sink(scores, torch.from_numpy(
        msa_poa.sink_mask(g, order, N)))
    align = msa_poa.walk_plain(words, torch.from_numpy(preds), best, n_real)
    row = order.index(200)
    j = int(np.nonzero(align.numpy() == row)[0][0])
    assert (int(words[row, j]) >> 4) & 8191 == dels[0]


def test_pred_lists_hold_each_rows_valid_preds(stair):
    """``msa_poa.pred_lists``, the wide DP's pred lists: each row's valid
    table entries as (buffer row id, table index) in table order (a
    source's the virtual row at index 0), none for the padded rows; a
    chunked round's chunk reads the round's list through its rows' slice
    of the offsets."""
    from tsta_tpu_torch.ops import msa_chunked
    stair(100, 900)
    seqs = _deletion_set(3, 1600, 900, (90,), subs=60)
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(
        g, seqs[1], AlignParams(), 24_000_000)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    pcsr, poff = msa_poa.pred_lists(preds, pmaskT)
    assert pcsr.dtype == poff.dtype == np.int32 and poff.shape == (N + 1,)
    assert poff[0] == 0 and poff[-1] == len(pcsr) == int(pmaskT.sum())
    for i in range(N):
        k = np.nonzero(pmaskT[:, i])[0]
        assert pcsr[poff[i]:poff[i + 1]].tolist() == [
            [int(predsT[q, i]), int(q)] for q in k]
        assert (len(k) > 0) == (i < len(order))
    assert pcsr[poff[900]:poff[901]].shape == (100, 2)
    assert pcsr[0].tolist() == [0, 0]   # the source reads the virtual row
    r = msa_chunked.ChunkedRound(g, prep, a, n_real, NC, NWIN,
                                 AlignParams(), CPU)
    assert r.nchunks == 4
    for c in range(r.nchunks):
        for _, kw in (r.forward_call(c, None, None),
                      r.remat_call(c, 0, msa_poa.new_ring(W, n, CPU), None,
                                   None)):
            lc, lo = kw["lists"]
            assert lo.tolist() == poff[c * NC:(c + 1) * NC + 1].tolist()
            assert torch.equal(lc, torch.from_numpy(pcsr))


def test_chunked_wide_round_matches_jax_unchunked(stair):
    """A wide round the plan cuts into 4 chunks of 512 rows (at this
    budget its 16-bit plane would have run as one call), through the
    plain forward chunks, remats and bounded walks, equal to JAX's
    unchunked scan round in every output of the run."""
    stair(100, 900)
    seqs = _deletion_set(3, 1600, 900, (90, 40), subs=60)
    budget = 24_000_000
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(
        g, seqs[1], AlignParams(), budget)
    N, max_in, W = prep[4:7]
    assert (N, n, max_in, W, NC, NWIN) == (2048, 1536, 128, 128, 512, 0)
    assert msa_poa.round_plan(N, n, W, budget) is None
    want = jnative.align_seqs(seqs, JParams())
    clock = msa_poa.RoundClock(CPU)
    before = dict(_kernels.launches)
    got = msa_native.align_seqs(seqs, AlignParams(), device="cpu",
                                budget=budget, clock=clock)
    assert astuple(got) == astuple(want)
    assert _kernels.launches == before
    assert clock.rounds[0]["chunks"] == 4


@pytest.mark.parametrize("N,n,W,budget", [
    (2048, 1536, 128, 24_000_000), (2048, 1536, 16, 20_000_000),
    (51200, 51200, 64, 16 << 30), (100352, 102400, 128, 80 << 30)])
def test_round_plan_counts_the_word_size(N, n, W, budget):
    """A wide plane is int32: near the budget the wide plan chunks where
    the 16-bit one does not (4 bytes a cell against 2), and the 16-bit
    plan is the same with or without the word size given."""
    narrow = msa_poa.round_plan(N, n, W, budget)
    assert msa_poa.round_plan(N, n, W, budget, 2) == narrow
    wide = msa_poa.round_plan(N, n, W, budget, 4)
    if 2 * N * n <= budget // 2 < 4 * N * n:
        assert narrow is None and wide is not None
        assert (4 * wide * n) * 2 <= budget
    elif 4 * N * n <= budget // 2:
        assert narrow is None and wide is None


def _wide_round(k, seed=7):
    """Round 1 of a staircase graph of in-degree ``k`` through the plain
    version: the int32 plane, preds, best, n_real and maxdist."""
    seqs = _deletion_set(seed, 400, 250, (min(k - 1, 120), 20))
    g = PoaGraph.from_sequence(seqs[0], 2)
    _staircase(g, k, 250)
    prep, n, n_real, a, _, _ = msa_poa.prep_round(g, seqs[1], AlignParams(),
                                                  CPU_BUDGET)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    words, scores = msa_native.round_dp_plain(*t, n_real, len(order),
                                              AlignParams(), W)
    best = msa_poa.best_sink(scores, torch.from_numpy(
        msa_poa.sink_mask(g, order, N)))
    return (words, torch.from_numpy(preds), int(best), n_real,
            msa_poa.max_pred_distance(preds))


@pytest.mark.parametrize("k", [65, 129])
@pytest.mark.parametrize("S,R", [(8, 0), (8, 16), (16, 64), (32, 128),
                                 (64, 207)])
def test_wide_staged_walk_matches_plain_walk(k, S, R):
    """The walk kernels' schedule over a wide plane (words staged, every
    pred read from the table) gives ``walk_plain``'s align map; with R = 0
    every move misses, and at R = 2S * maxdist none does."""
    words, preds, best, n_real, maxdist = _wide_round(k)
    assert words.dtype == torch.int32 and preds.shape[1] > 64
    want = msa_poa.walk_plain(words, preds, best, n_real)
    align, exit_, counts = msa_poa.poa_walk_staged_plain(
        words, preds, best, n_real - 1, 0, S, R)
    assert torch.equal(align, want)
    assert exit_[0] < 0 or exit_[1] < 0
    steps, pred_moves, misses, phases = counts.tolist()
    assert steps >= n_real and 0 < pred_moves <= steps
    if R == 0:
        assert misses == steps
    full = msa_poa.poa_walk_staged_plain(words, preds, best, n_real - 1, 0,
                                         S, 2 * S * maxdist)[2].tolist()
    assert full[2] == 0 and full[:2] == [steps, pred_moves]


def test_wide_walk_plan_and_bytes():
    """The wide form's window holds 4-byte words and the first 4 preds of
    each row: 207 rows at S = 64 fit two buffers, 208 do not."""
    assert _kernels.poa_walk_bytes(64, 207, 128) == 2 * 207 * (136 * 4 + 16)
    assert _kernels.poa_walk_bytes(64, 208, 8192) > _kernels.MAX_DYNAMIC_SMEM
    assert _kernels.poa_walk_plan(65, 128) == (64, 207, 128)
    assert _kernels.poa_walk_plan(65, 8192) == (64, 207, 128)
    assert _kernels.poa_walk_plan(3, 128) == (64, 207, 128)
    assert _kernels.poa_walk_plan(1, 128) == (64, 128, 128)
    with pytest.raises(ValueError):
        _kernels.poa_walk_plan(65, 128, R=208)
    # the 16-bit form's plan is as before
    assert _kernels.poa_walk_plan(65, 64)[1] < 320
    assert _kernels.poa_walk_plan(2, 4) == (64, 256, 128)


def test_wide_kernel_route_refused_on_cpu(stair):
    stair(65, 100)
    seqs = _deletion_set(11, 160, 100, (64,))
    with pytest.raises(ValueError, match="CUDA"):
        msa_native.align_seqs(seqs, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        msa_native.align_seqs_many([seqs], kernel="cuda", device="cpu")
    g = PoaGraph.from_sequence(seqs[0], 2)
    with pytest.raises(ValueError, match="kernel"):
        msa_poa.poa_dp(*[torch.zeros((128, 64), dtype=torch.int32)] * 2,
                       torch.zeros((64,), dtype=torch.int32),
                       torch.zeros((4, 64), dtype=torch.int32),
                       torch.zeros((64,), dtype=torch.uint8), 10, 5,
                       AlignParams(), 2, D=2)
    assert g.max_in_degree() == 65


def test_in_degree_past_the_wide_words_raises(monkeypatch):
    """Past WIDE_MAX_IN (8,192; lowered here to 128 so the tables stay
    small) every route raises before it builds the round's tables."""
    monkeypatch.setattr(msa_poa, "WIDE_MAX_IN", 128)
    monkeypatch.setattr(msa_poa, "prepare", None)
    seq = _deletion_set(13, 300, 250, ())[0]
    g = PoaGraph.from_sequence(seq, 2)
    _staircase(g, 129, 250)
    for kernel in ("auto", "plain"):
        with pytest.raises(ValueError, match="129 exceeds"):
            msa_poa.run_round(g, seq[:50], AlignParams(), CPU, kernel,
                              CPU_BUDGET)


def test_jax_int8_pred_fields_past_index_127(stair):
    """The JAX scan engine keeps its pred fields as int8
    (``tsta_tpu/ops/msa_native.py`` ``_round_dp``): a first-max pred at
    table index >= 128 wraps negative, and ``_walk_host`` then takes the
    pred that many entries from the end of the row.  Pinned: JAX's fields
    are the port's 13-bit fields wrapped to int8 cell for cell, so the two
    differ exactly where the port's pass 127; a read whose deletion
    enters the staircase node from index 150 is merged along another path
    by JAX (same round scores, other rows), while the port's rows are its
    reads with gaps (a defect of the JAX package, left as it is)."""
    k, at = 200, 200
    stair(k, at)
    seqs = _deletion_set(17, 300, at, (150, 130))
    g = PoaGraph.from_sequence(seqs[0], 2)
    prep, n, n_real, a, _, _ = msa_poa.prep_round(g, seqs[1], AlignParams(),
                                                  CPU_BUDGET)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    words, scores = msa_native.round_dp_plain(*t, n_real, len(order),
                                              AlignParams(), W)
    jg = JGraph.from_sequence(seqs[0], 2)
    js, packed, h_pred, e_pred, _, jorder = jnative._scan_engine_round(
        jg, seqs[1], JParams())
    assert list(jorder) == list(order)
    nn = len(order)
    w = words[:nn, :n_real].numpy().astype(np.int64)
    mine_h, mine_e = (w >> 4) & 8191, (w >> 17) & 8191
    jh = h_pred[:nn, :n_real].astype(np.int64)
    je = e_pred[:nn, :n_real].astype(np.int64)
    assert (mine_h >= 128).any() and (mine_e >= 128).any()
    assert np.array_equal(jh, (mine_h + 128) % 256 - 128)
    assert np.array_equal(je, (mine_e + 128) % 256 - 128)
    assert np.array_equal(js[:nn], scores[:nn].numpy())
    got = msa_native.align_seqs(seqs, AlignParams(), device="cpu")
    want = jnative.align_seqs(seqs, JParams())
    assert got.round_scores == want.round_scores
    assert got.rows != want.rows
    assert [r.replace(b"-", b"") for r in got.rows] == seqs
    if os.environ.get("TSTA_MSA_KERNEL") != "scan":
        raise AssertionError("the fixture runs JAX's scan engine")


def test_ab_tools_compare_builds_and_time_the_wide_form():
    """The POA A/B tools match the two checkouts' SASS build by build
    (``kernel_key``: name and template arguments, whatever the spelling of
    the parameter types or the file's anonymous namespace), and their
    timed processes time the wide form where the checkout has it."""
    import ast

    from tsta_tpu_torch.tools import poa_dp_ab, poa_walk_ab
    from tsta_tpu_torch.tools.psa_dp_ab import kernel_key
    ns = "_ZN44_GLOBAL__N__edf5b106_11_poa_walk_cu_ff484f3c"
    assert kernel_key(ns + "15poa_walk_kernelILi0EEEvPKNSt11conditionalIXlt"
                      "T_Li0EEjtE4typeEPKiS7_iiiiPiS8_ii") \
        == kernel_key("_ZN4tsta15poa_walk_kernelILi0EEEvPKtPKiS4_iiiiPiS5_"
                      "ii") == "poa_walk_kernel<Li0E>"
    assert kernel_key(ns + "15poa_walk_kernelILin1EEEvPK") \
        == "poa_walk_kernel<Lin1E>"
    assert kernel_key("_ZN12_GLOBAL__N_113poa_dp_kernelILi8ELb1ELb0ELb0EEEv"
                      "NS_6LaunchE") == "poa_dp_kernel<Li8ELb1ELb0ELb0E>"
    assert kernel_key("_ZN12_GLOBAL__N_118poa_dp_wide_kernelILi32ELb0ELb0E"
                      "EEvNS_6LaunchE") == "poa_dp_wide_kernel<Li32ELb0ELb0E>"
    for child in (poa_dp_ab.CHILD, poa_walk_ab.CHILD):
        tree = ast.parse(child)
        names = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert "WIDE_50K" in names and "next_round" in names


def test_in_degree_tool_finds_the_wide_rounds():
    """``tools/in_degree.py``: an edited-amplicon pool's deletions of
    every length ending at one base pass 64 preds (the plain wide route
    on the CPU); mixed errors stay far below."""
    from tsta_tpu_torch.tools import in_degree
    sets = in_degree.read_sets(19)
    stair = in_degree.grow(sets["staircase"], "cpu")
    assert stair["rounds"] == 99 and stair["first_wide_round"] is not None
    assert stair["max_in_degree"]["last"] > 64
    mixed = in_degree.grow(sets["mixed"][:11], "cpu")
    assert mixed["first_wide_round"] is None
    assert mixed["max_in_degree"]["10"] < 16
