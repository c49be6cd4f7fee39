"""The POA walks' window ring (``csrc/poa_walk_stage.cuh``) on the CPU,
with exact equality.

``msa_poa.poa_walk_staged_plain`` replays the walk kernels' schedule
phase by phase: phases of S moves, the window of phase k anchored where
phase k - 1 began (``msa_poa.poa_walk_window``: R rows by 2S + 8
columns, clipped to the plane or the cell), every read inside the
walker's window asserted to be staged there and every read outside it
counted as a miss.  Its align map and exit state are held to the plain
walks (``walk_plain``, ``walk_bounded_plain``) and to the JAX package's
(``msa_pallas._walk``, ``_walk_banded`` and ``_walk_bounded_banded`` in
interpret mode, fed the port's plane through ``convert``) on seeded
graphs of ~700 bp (every round), on a graph whose reads carry a 300 bp
deletion (an edge that skips ~300 rows, so the miss path runs), and on
every cell of a small chunked round, over an (S, R) grid that includes R
= 0 (every move a miss).  Two broken schedules, a window a row short and
a stale anchor, must fail the replay.  The kernels themselves are held
to this replay on the card (``tests/test_torch_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import msa_pallas
from tsta_tpu_torch import convert
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import CPU_BUDGET
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import _kernels, msa_chunked, msa_native, msa_poa

# the card tests' seeded reads, and their graph with a 300 bp deletion
from test_torch_kernels import _deletion_reads, _reads

CPU = torch.device("cpu")
# (S, R): R = 0 every move a miss, small windows with misses, the plan's
GRID = [(8, 0), (8, 4), (8, 16), (16, 64), (32, 128), (64, 512)]


def _rounds(reads):
    """Each round of ``reads`` through the port's plain rounds: the
    word plane, the pred table, the best sink, n_real and the largest
    pred distance."""
    params = AlignParams()
    g = PoaGraph.from_sequence(reads[0], len(reads))
    out = []
    for sno in range(1, len(reads)):
        prep, n, n_real, a, NC, _ = msa_poa.prep_round(g, reads[sno], params,
                                                       CPU_BUDGET)
        assert NC is None
        predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
        t = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
        words, scores = msa_native.round_dp_plain(*t, n_real, len(order),
                                                  params, W)
        mask = torch.from_numpy(msa_poa.sink_mask(g, order, N))
        best = msa_poa.best_sink(scores, mask)
        pd = torch.from_numpy(preds)
        align = msa_poa.walk_plain(words, pd, best, n_real)
        out.append({"words": words, "preds": pd, "predsT": predsT,
                    "best": int(best), "n_real": n_real, "n": n,
                    "align": align,
                    "maxdist": msa_poa.max_pred_distance(preds)})
        msa_native._finish_round(g, reads[sno], sno, order,
                                 msa_poa.pack_round(scores, align,
                                                    best).numpy(), [], [], [])
    return out


@pytest.fixture(scope="module")
def graphs():
    return {"seed 0": _rounds(_reads(0, 4, 700)),
            "seed 1": _rounds(_reads(1, 4, 720, 0.15)),
            "deletion": _rounds(_deletion_reads())}


def _replay(r, S, R):
    return msa_poa.poa_walk_staged_plain(r["words"], r["preds"], r["best"],
                                         r["n_real"] - 1, 0, S, R)


def test_deletion_graph_skips_rows(graphs):
    last = graphs["deletion"][-1]
    assert last["maxdist"] >= 300
    assert max(r["maxdist"] for r in graphs["seed 0"]) < 16


@pytest.mark.parametrize("S,R", GRID)
@pytest.mark.parametrize("case", ["seed 0", "seed 1", "deletion"])
def test_staged_walk_matches_plain_walk(graphs, case, S, R):
    """Every round's replay equals ``walk_plain``; it ends off the plane;
    R = 0 misses every move, a window of 2S * maxdist rows none."""
    for r in graphs[case]:
        align, out, counts = _replay(r, S, R)
        assert torch.equal(align, r["align"])
        row, j, _ = out.tolist()
        assert row < 0 or j < 0
        steps, pred_moves, misses, phases = counts.tolist()
        consumed = int((r["align"][:r["n_real"]] != -1).sum())
        assert pred_moves <= steps and consumed <= steps
        assert phases == max(1, -(-steps // S))
        if R == 0:
            assert misses == steps
        wide = _replay(r, S, 2 * S * r["maxdist"])[2].tolist()
        assert wide[2] == 0 and wide[:2] == [steps, pred_moves]


def test_long_jump_takes_the_miss_path(graphs):
    """At the plan's window the deletion round misses (the ~300-row edge
    is past it) and the seeded rounds do not; the result is the same."""
    for case, want_miss in (("deletion", True), ("seed 0", False)):
        r = graphs[case][-1]
        S, R, _ = msa_poa.poa_walk_plan(r["maxdist"],
                                        r["preds"].shape[1])
        align, _, counts = _replay(r, S, R)
        assert torch.equal(align, r["align"])
        assert (counts[2] > 0) == want_miss


@pytest.mark.parametrize("case", ["seed 0", "seed 1", "deletion"])
def test_staged_walk_matches_jax_walks(graphs, case):
    """The replay at the plan's window equals JAX's ``_walk`` and its
    banded Pallas walk (interpret mode) on the same plane."""
    for r in graphs[case]:
        n, max_in = r["n"], r["preds"].shape[1]
        S, R, _ = msa_poa.poa_walk_plan(r["maxdist"], max_in)
        align, _, _ = _replay(r, S, R)
        jw = jnp.asarray(convert.poa_words_to_jax(r["words"]))
        want = msa_pallas._walk(jw, jnp.asarray(r["preds"].numpy()),
                                jnp.int32(r["best"]),
                                jnp.int32(r["n_real"]), n)
        assert np.array_equal(align.numpy(), np.asarray(want))
        assert msa_pallas._walk_banded_ok(r["words"].shape[0], max_in, n,
                                          n // 128)
        banded = msa_pallas._walk_banded(
            jw, jnp.asarray(r["predsT"]),
            jnp.asarray([[r["n_real"], r["best"]]], jnp.int32), n)
        assert np.array_equal(align.numpy(), np.asarray(banded))


@pytest.fixture(scope="module")
def chunked_cells():
    """Every cell the backward of a 2,000 bp round cut into 4 chunks of
    512 rows and 2 column windows walks (plain remats), with its entry
    state, and the round's align map."""
    params = AlignParams()
    reads = _reads(41, 2, 2000, 0.08)
    g = PoaGraph.from_sequence(reads[0], 2)
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, reads[1], params,
                                                      2 ** 30 // 100)
    assert (NC, NWIN) == (512, 2)
    r = msa_chunked.ChunkedRound(g, prep, a, n_real, NC, NWIN, params, CPU)
    snaps, scores, ckpt = r.forward(msa_native.round_dp_plain)
    hb = ckpt[:, :, 0].contiguous()
    row, j, state = int(msa_poa.best_sink(scores, r.mask)), n_real - 1, 0
    align = torch.full((n,), -1, dtype=torch.int32)
    cells = []
    while row >= 0 and j >= 0:
        c, w = r.cell(row, j)
        args, kw = r.remat_call(c, w, snaps[c], ckpt, hb)
        words, _ = msa_native.round_dp_plain(*args, **kw)
        cell = {"words": words, "preds": r.chunk_preds(c),
                "predsT": r.predsT[:, c * NC:(c + 1) * NC].contiguous(),
                "entry": (row, j, state), "base": c * NC, "col0": w * r.CW,
                "align_in": align.clone()}
        st = msa_poa.walk_bounded_plain(words, cell["preds"], row, j, state,
                                        c * NC, w * r.CW, align)
        cell["exit"], cell["align_out"] = st.tolist(), align.clone()
        cells.append(cell)
        row, j, state = st.tolist()
    assert len(cells) >= 4 and len({(c["base"], c["col0"])
                                    for c in cells}) >= 4
    return {"cells": cells, "n": n, "NC": NC, "n_real": n_real,
            "maxdist": r.maxdist, "align": align}


@pytest.mark.parametrize("S,R", GRID)
def test_staged_walk_matches_bounded_walk_in_every_cell(chunked_cells, S,
                                                        R):
    """Each cell's replay from its entry state leaves it as
    ``walk_bounded_plain`` does, with the same align entries; the whole
    backward, cell after cell, gives the round's align map."""
    for cell in chunked_cells["cells"]:
        align = cell["align_in"].clone()
        got, out, counts = msa_poa.poa_walk_staged_plain(
            cell["words"], cell["preds"], *cell["entry"], S, R,
            base=cell["base"], col0=cell["col0"], align=align)
        assert got is align and out.tolist() == cell["exit"]
        assert torch.equal(align, cell["align_out"])
        if R == 0:
            assert counts[2] == counts[0] > 0
    assert torch.equal(cell["align_out"], chunked_cells["align"])


def test_staged_walk_matches_jax_bounded_walk(chunked_cells):
    """Each cell's replay at the plan's window equals JAX's
    ``_walk_bounded_banded`` (interpret mode) on the cell's plane, with
    its column window."""
    n, NC = chunked_cells["n"], chunked_cells["NC"]
    for cell in chunked_cells["cells"]:
        S, R, _ = msa_poa.poa_walk_plan(chunked_cells["maxdist"],
                                        cell["preds"].shape[1])
        align = cell["align_in"].clone()
        _, out, _ = msa_poa.poa_walk_staged_plain(
            cell["words"], cell["preds"], *cell["entry"], S, R,
            base=cell["base"], col0=cell["col0"], align=align)
        row, j, state = cell["entry"]
        want = msa_pallas._walk_bounded_banded(
            jnp.asarray(convert.poa_words_to_jax(cell["words"])),
            jnp.asarray(cell["predsT"].numpy()), jnp.int32(row),
            jnp.int32(j), jnp.int32(state),
            jnp.asarray(cell["align_in"].numpy()), jnp.int32(cell["base"]),
            n, NC, cell["col0"])
        assert out.tolist() == [int(x) for x in want[:3]]
        assert np.array_equal(align.numpy(), np.asarray(want[3]))


def _row_short(orig):
    def window(r0, j0, S, R, rows, cols):
        lo, hi, c0, c1 = orig(r0, j0, S, R, rows, cols)
        return min(lo + 1, hi), hi, c0, c1
    return window


def _stale_anchor(orig):
    calls = []

    def window(r0, j0, S, R, rows, cols):
        calls.append((r0, j0))
        return orig(*calls[max(len(calls) - 2, 0)], S, R, rows, cols)
    return window


@pytest.mark.parametrize("mutation", [_row_short, _stale_anchor])
def test_broken_schedule_fails_the_replay(graphs, chunked_cells, monkeypatch,
                                          mutation):
    """Loaders that stage a row short, or at the anchor before the one
    the walker reads from, leave a read the walker takes from its window
    unstaged: the replay fails on a seeded round and on the chunked
    round's cells."""
    r = graphs["seed 0"][-1]
    monkeypatch.setattr(msa_poa, "poa_walk_window",
                        mutation(msa_poa.poa_walk_window))
    with pytest.raises(AssertionError, match="not staged"):
        _replay(r, 8, 16)
    with pytest.raises(AssertionError, match="not staged"):
        for cell in chunked_cells["cells"]:
            msa_poa.poa_walk_staged_plain(
                cell["words"], cell["preds"], *cell["entry"], 8, 16,
                base=cell["base"], col0=cell["col0"],
                align=cell["align_in"].clone())


def test_walk_window_clips_to_the_plane():
    w = msa_poa.poa_walk_window
    assert w(100, 500, 32, 128, 1000, 768) == (0, 101, 432, 504)
    assert w(500, 70, 32, 128, 1000, 768) == (373, 501, 0, 72)
    assert w(500, 765, 32, 128, 1000, 768) == (373, 501, 696, 768)
    assert w(500, 700, 8, 0, 1000, 768) == (501, 501, 680, 704)
    assert w(-1, 700, 8, 16, 1000, 768)[:2] == (0, 0)
    assert w(5, -1, 8, 16, 1000, 768)[:2] == (0, 0)
    assert w(1000, 5, 8, 16, 1000, 768)[:2] == (0, 0)


def test_walk_plan():
    plan = msa_poa.poa_walk_plan
    assert plan(None, 4) == (64, 320, 128)
    assert plan(1, 4) == (64, 128, 128)
    assert plan(2, 8) == (64, 256, 128)
    assert plan(300, 4) == (64, 320, 128)
    assert plan(300, 32) == (64, 290, 128)   # shared memory caps it
    assert plan(300, 64, S=128) == (128, 148, 128)
    assert plan(3, 4, S=64, R=0, threads=256) == (64, 0, 256)
    assert _kernels.poa_walk_bytes(32, 128, 4) == 41_024
    assert _kernels.poa_walk_bytes(64, 0, 4) == 2 * (136 * 2 + 8 * 4)
    for S, mi in ((8, 1), (32, 4), (64, 64), (128, 4)):
        cap = plan(None, mi, S=S, R=None)[1]
        top = max(R for R in range(0, 3000)
                  if _kernels.poa_walk_bytes(S, R, mi)
                  <= _kernels.MAX_DYNAMIC_SMEM)
        assert plan(None, mi, S=S, R=top)[1] == top
        assert cap <= top
        with pytest.raises(ValueError):
            plan(None, mi, S=S, R=top + 1)
    for bad in ({"S": 12}, {"S": 0}, {"threads": 96 + 1}, {"threads": 32},
                {"threads": 288}, {"R": -1}):
        with pytest.raises(ValueError):
            plan(4, 4, **bad)


def test_walk_wrappers_keep_overrides_for_the_kernel(graphs):
    r = graphs["seed 0"][0]
    best = torch.tensor([r["best"]], dtype=torch.int32)
    assert torch.equal(msa_poa.poa_walk(r["words"], r["preds"], best,
                                        r["n_real"], maxdist=3),
                       r["align"])
    for kw in ({"S": 32}, {"R": 0}, {"threads": 128},
               {"counts": torch.zeros(4, dtype=torch.int32)}):
        with pytest.raises(ValueError):
            msa_poa.poa_walk(r["words"], r["preds"], best, r["n_real"], **kw)
        with pytest.raises(ValueError):
            msa_poa.poa_walk_bounded(r["words"], r["preds"], r["best"],
                                     r["n_real"] - 1, 0, 0, 0,
                                     r["align"].clone(), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.poa_walk(r["words"], r["preds"], best, r["n_real"],
                          r["align"].clone())
    with pytest.raises(ValueError):
        msa_poa.poa_walk_staged_plain(r["words"].to(torch.int32), r["preds"],
                                      r["best"], r["n_real"] - 1, 0, 8, 8)


def test_max_pred_distance():
    preds = np.array([[0, 0], [1, 0], [2, 1], [0, 0], [4, 1]], np.int32)
    assert msa_poa.max_pred_distance(preds) == 4
    assert msa_poa.max_pred_distance(np.zeros((3, 1), np.int32)) == 1


def test_poa_walk_ab_child_parses_and_times_both_walks():
    """The POA walk A/B tool's timed process (run in either checkout on
    the card) is valid Python on ``psa_dp_ab``'s helpers, makes each plane
    with its checkout's DP and times Q2-5 through ``poa_walk`` and Q2-6's
    walk through ``poa_walk_bounded``; ``--sweep`` takes S:R:threads."""
    import ast
    from tsta_tpu_torch.tools import poa_walk_ab, psa_dp_ab
    assert poa_walk_ab.CHILD.startswith(psa_dp_ab.CHILD_HELPERS)
    tree = ast.parse(poa_walk_ab.CHILD)
    calls = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert {"poa_walk", "poa_walk_bounded", "poa_dp", "next_round",
            "ChunkedRound", "poa_walk_plan"} <= calls
    with pytest.raises(SystemExit):
        poa_walk_ab.main(["--help"])
