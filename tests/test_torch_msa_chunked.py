"""The port's chunked POA rounds against the JAX package on the CPU, with
zero tolerance.

A chunked round (``ops/msa_chunked.py``: forward DP in node chunks with
a carried ring and column-window checkpoints, then a backward that
rematerialises one (chunk, window) cell at a time and walks it) runs
through the plain versions of its kernels here, at small explicit
budgets, and must equal the JAX package's unchunked ``round_dp_fused``
(the Pallas kernels in interpret mode) in best row, score, align map and
so graph, rows and consensus.  Its pieces are held against the JAX
package's counterparts: the forward chunk's scores, ring and checkpoints
against ``_poa_chunk_call(..., NW > 0)``, the window fills, ring window
and remat words against ``_win_fills``, ``_ring_window`` and the remat
call, and the bounded walk against ``_walk_bounded_banded``.  Shapes are
those of ``tests/test_msa_pallas.py``'s chunked tests."""

from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams as JParams
from tsta_tpu.models.poa_graph import PoaGraph as JGraph
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu.ops import msa_pallas
from tsta_tpu_torch import convert
from tsta_tpu_torch.device import CPU_BUDGET
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import _kernels, msa_chunked, msa_native, msa_poa
from tsta_tpu_torch.ops import psa_diff
from tsta_tpu_torch.ops import traceback as tb

CPU = torch.device("cpu")
LANES = 128
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, base, div):
    b = bytearray(base)
    for i in rng.integers(0, len(b), max(1, int(len(b) * div))):
        b[i] = b"ACGT"[rng.integers(0, 4)]
    for _ in range(max(1, int(len(b) * div / 8))):
        j = int(rng.integers(0, len(b) - 2))
        del b[j]
    return bytes(b)


def _pair(seed, length, div=0.08):
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, length).tobytes()
    return [base, _mutate(rng, base, div)]


def _vertical_pair():
    """A 4,060 bp graph read and a ~1,990 bp read of half its columns:
    the walk consumes ~2 graph rows per read column (as
    ``test_windowed_remat_vertical_heavy``)."""
    rng = np.random.default_rng(47)
    base = rng.choice(ACGT, 4060).tobytes()
    s = np.frombuffer(base, np.uint8).copy()
    s = s[np.sort(rng.choice(len(s), 1990, replace=False))]
    m = rng.random(len(s)) < 0.15
    s[m] = ACGT[rng.integers(0, 4, int(m.sum()))]
    return [base, s.tobytes()]


# (reads, budget, NC, chunks, NWIN)
CASES = {
    "600bp_nwin0": (lambda: _pair(21, 600), 2_000_000, 512, 2, 0),
    "2000bp_nwin2": (lambda: _pair(41, 2000), 2 ** 30 // 100, 512, 4, 2),
    "vertical_4060_1990": (_vertical_pair, 14 * 2 ** 30 // 1000, 512, 8, 2),
}


def _jax_round(seqs):
    """The JAX package's unchunked round of ``seqs[1]`` against the linear
    graph of ``seqs[0]``, merged: (best, score, align, rows, consensus)."""
    g = JGraph.from_sequence(seqs[0], 2)
    scores, align, best, order = msa_pallas.round_dp_fused(g, seqs[1],
                                                           JParams())
    best = int(best)
    al = np.asarray(align)[:len(seqs[1])]
    score = int(np.asarray(scores)[0, best])
    jnative._merge(g, seqs[1], 1, order, al)
    g.toposort()
    return best, score, al, g.msa_rows(), g.consensus()


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_round_matches_jax_unchunked(case, monkeypatch):
    make, budget, NC, chunks, NWIN = CASES[case]
    seqs = make()
    want = _jax_round(seqs)
    g = PoaGraph.from_sequence(seqs[0], 2)
    prep, n, n_real, a, nc, nwin = msa_poa.prep_round(g, seqs[1],
                                                      AlignParams(), budget)
    assert (nc, -(-prep[4] // nc), nwin) == (NC, chunks, NWIN)
    spied = []
    orig = msa_chunked.ring_window
    monkeypatch.setattr(msa_chunked, "ring_window",
                        lambda *args: (spied.append(args[2:]), orig(*args))[1])
    before = dict(_kernels.launches)
    clock = msa_poa.RoundClock(CPU)
    packed, order, wide = msa_poa.run_round(g, seqs[1], AlignParams(), CPU,
                                            "auto", budget, clock)
    host = packed.numpy()
    assert not wide and _kernels.launches == before
    assert (int(host[0]), int(host[1])) == want[:2]
    assert np.array_equal(host[2:2 + n_real], want[2])
    assert np.all(host[2 + n_real:] == -1)
    # the windowed remat engaged exactly when the plan has windows
    assert bool(spied) == (NWIN > 0)
    assert all(cw == n // NWIN for _, cw in spied)
    clock.mark("got")
    msa_native._finish_round(g, seqs[1], 1, order, host, [], [], [])
    clock.mark("end")
    clock.close()
    rec = clock.rounds[0]
    assert (rec["NC"], rec["chunks"], rec["NWIN"]) == (NC, chunks, NWIN)
    assert rec["remats"] == rec["cells_walked"] >= chunks
    assert rec["forward_ms"] == rec["dp_ms"] > 0
    assert (g.msa_rows(), g.consensus()) == want[3:]


def _progressive_reads():
    """3 reads of ~1,400 bp whose round-2 graph passes 1,536 nodes, so
    that round has N = 2,048 rows: 4 chunks of 512."""
    rng = np.random.default_rng(29)
    base = rng.choice(ACGT, 1400).tobytes()
    return [base] + [_mutate(rng, base, 0.15) for _ in range(2)]


def test_chunked_progressive_run_matches_jax(monkeypatch):
    seqs = _progressive_reads()
    monkeypatch.setenv("TSTA_MSA_KERNEL", "poa")
    want = jnative.align_seqs(seqs, JParams())
    budget = 6_000_000
    clock = msa_poa.RoundClock(CPU)
    got = msa_native.align_seqs(seqs, AlignParams(), device="cpu",
                                budget=budget, clock=clock)
    assert astuple(got) == astuple(want)
    assert [r["chunks"] for r in clock.rounds] == [3, 4]
    assert all(r["NWIN"] == 0 for r in clock.rounds)


def test_align_seqs_many_chunked_equals_single():
    rng = np.random.default_rng(37)
    sets = []
    for length in (500, 600, 560):
        base = rng.choice(ACGT, length).tobytes()
        sets.append([base] + [_mutate(rng, base, 0.1) for _ in range(2)])
    budget = 2_000_000
    outs = msa_native.align_seqs_many(sets, AlignParams(), device="cpu",
                                      budget=budget)
    for seqs, out in zip(sets, outs):
        clock = msa_poa.RoundClock(CPU)
        single = msa_native.align_seqs(seqs, AlignParams(), device="cpu",
                                       budget=budget, clock=clock)
        assert out == single
        assert any("NC" in r for r in clock.rounds)
        assert out == msa_native.align_seqs(seqs, AlignParams(),
                                            device="cpu")


@pytest.mark.parametrize("seed", [3, 11])
def test_chunked_round_scores_match_pairwise_dp(seed):
    """What ``chip_smoke.py`` holds its 3 x 200 kbp run to: round 1
    aligns read 1 to read 0's chain, so its score is the pairwise global
    DP's corner and the score of MSA rows 0 and 1 without their common
    gaps; round 2's graph holds the paths of reads 0 and 1, so its score
    is at least either pairwise score of read 2."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, 2000).tobytes()
    seqs = [base] + [_mutate(rng, base, 0.1) for _ in range(2)]
    clock = msa_poa.RoundClock(CPU)
    out = msa_native.align_seqs(seqs, AlignParams(), device="cpu",
                                budget=2 ** 30 // 100, clock=clock)
    assert [r["NWIN"] for r in clock.rounds] == [2, 2]
    reads = [np.frombuffer(s, np.uint8) for s in seqs]
    a, b, lens = psa_diff.pack_pairs([(reads[1], reads[0]),
                                      (reads[2], reads[0]),
                                      (reads[2], reads[1])], CPU)
    _, corner = psa_diff.dp_packed(a, b, lens, AlignParams())
    r0, r1 = out.rows[0], out.rows[1]
    keep = [k for k in range(len(r0)) if r0[k] != 45 or r1[k] != 45]
    rescored = tb.score_alignment(bytes(r0[k] for k in keep),
                                  bytes(r1[k] for k in keep), AlignParams())
    assert out.round_scores[0] == int(corner[0]) == rescored
    assert out.round_scores[1] >= max(int(corner[1]), int(corner[2]))


# ---------------------------------------------------------------------
# The pieces of a chunked round, on the 2,000 bp case (n = 2,048 columns,
# NWIN = 2 windows of 1,024, 4 chunks of 512 rows), held against the JAX
# package's counterparts.
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunked_2000():
    seqs = _pair(41, 2000)
    params = AlignParams()
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    g = PoaGraph.from_sequence(seqs[0], 2)
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, seqs[1], params,
                                                      2 ** 30 // 100)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    assert (N % NC, NWIN) == (0, 2)
    Rp = n // LANES
    a2d = jnp.asarray(a.astype(np.int32).reshape(Rp, LANES))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        ("predsT", predsT), ("pmaskT", pmaskT), ("bases", bases.reshape(N)),
        ("fills", fills), ("preds", preds), ("a", a))}
    n_nodes = len(order)
    ring_j = jnp.zeros((W, 2 * Rp, LANES), jnp.int32)
    ring_p = msa_poa.new_ring(W, n, CPU)
    ck_p = torch.zeros((N, NWIN, 3), dtype=torch.int32)
    chunks = []
    for c in range(N // NC):
        sl = slice(c * NC, (c + 1) * NC)
        snap_j, snap_p = ring_j, ring_p.clone()
        scal = jnp.asarray([[n_real, c * NC, 0]], jnp.int32)
        tabs_j = [jnp.asarray(x[:, sl]) for x in (predsT, pmaskT, bases,
                                                   fills)]
        _, sc_j, ring_j, ck_j = msa_pallas._poa_chunk_call(
            *tabs_j, scal, a2d, ring_j, NC, n, W, max_in, p, NW=NWIN,
            ablate="noword")
        words_j, _, _, _ = msa_pallas._poa_chunk_call(
            *tabs_j, scal, a2d, snap_j, NC, n, W, max_in, p)
        rows = min(max(n_nodes - c * NC, 0), NC)
        tabs_p = [t["predsT"][:, sl].contiguous(),
                  t["pmaskT"][:, sl].contiguous(), t["bases"][sl],
                  t["fills"][:, sl].contiguous()]
        _, sc_p = msa_native.round_dp_plain(
            *tabs_p, t["a"], n_real, rows, params, W, ring=ring_p,
            chunk_base=c * NC, ckpt=ck_p[sl], with_words=False)
        chunks.append({"rows": rows, "snap_j": snap_j, "snap_p": snap_p,
                       "ring_j": ring_j, "ring_p": ring_p.clone(),
                       "sc_j": np.asarray(sc_j)[0], "sc_p": sc_p.numpy(),
                       "ck_j": np.asarray(ck_j), "words_j": words_j,
                       "tabs_p": tabs_p, "tabs_j": tabs_j})
    mask = torch.from_numpy(msa_poa.sink_mask(g, order, N))
    scores = torch.from_numpy(np.concatenate([c["sc_p"] for c in chunks]))
    align = _jax_round(seqs)[2]
    return {"n": n, "n_real": n_real, "NC": NC, "NWIN": NWIN, "W": W,
            "align": align,
            "max_in": max_in, "p": p, "params": params, "t": t, "a2d": a2d,
            "chunks": chunks, "ck_p": ck_p, "n_nodes": n_nodes,
            "best": int(msa_poa.best_sink(scores, mask)), "Rp": Rp}


def _ring_cols_jax(ring_j, Rp):
    """(W, 2, n) H and E rows of a JAX ring (W, 2*Rp, 128)."""
    r = np.asarray(ring_j)
    return r.reshape(r.shape[0], 2, Rp * LANES)


def test_forward_chunk_checkpoints_match_pallas(chunked_2000):
    """The plain forward chunk's sink scores, ring out and checkpoints
    equal ``_poa_chunk_call(..., NW=2, ablate='noword')``'s (checkpoint
    lanes 127 = H, 126 = q, 125 = F) on every real row."""
    d = chunked_2000
    pos = msa_poa.ring_positions(d["n"], CPU)
    for c, ch in enumerate(d["chunks"]):
        r = ch["rows"]
        assert np.array_equal(ch["sc_p"][:r], ch["sc_j"][:r])
        ck = d["ck_p"][c * d["NC"]:c * d["NC"] + r].numpy()
        for k, lane in enumerate((127, 126, 125)):
            assert np.array_equal(ck[:, :, k], ch["ck_j"][:r, :, lane]), \
                (c, lane)
        if r == d["NC"]:   # padded rows write ring slots in the JAX kernel
            got = ch["ring_p"][:, :, pos].numpy()
            assert np.array_equal(got, _ring_cols_jax(ch["ring_j"], d["Rp"]))
    assert d["chunks"][-1]["rows"] < d["NC"]


def test_walk_bounded_plain_matches_pallas(chunked_2000):
    """The plain bounded walk on each full-width chunk plane (the JAX
    forward's words, through ``convert.poa_words_from_jax``) leaves every
    cell in the state ``_walk_bounded_banded`` does, with the same align
    entries, over the whole backward from the best sink."""
    d = chunked_2000
    n, NC = d["n"], d["NC"]
    row, j, state = d["best"], d["n_real"] - 1, 0
    align_j = jnp.full((n,), -1, jnp.int32)
    align_p = torch.full((n,), -1, dtype=torch.int32)
    cells = 0
    while row >= 0 and j >= 0:
        c = row // NC
        ch = d["chunks"][c]
        out = msa_pallas._walk_bounded_banded(
            ch["words_j"], ch["tabs_j"][0], jnp.int32(row), jnp.int32(j),
            jnp.int32(state), align_j, jnp.int32(c * NC), n, NC)
        words_p = convert.poa_words_from_jax(ch["words_j"])
        st = msa_poa.walk_bounded_plain(
            words_p, d["t"]["preds"][c * NC:(c + 1) * NC], row, j, state,
            c * NC, 0, align_p)
        align_j = out[3]
        assert st.tolist() == [int(x) for x in out[:3]]
        assert np.array_equal(align_p.numpy(), np.asarray(align_j))
        row, j, state = st.tolist()
        cells += 1
    assert cells >= 3 and (align_p[:d["n_real"]] >= 0).sum() > 1900


@pytest.mark.parametrize("c", [2, 3])
def test_window_remat_matches_pallas(chunked_2000, c):
    """Window 1 of chunk ``c``: ``win_fills`` and ``ring_window`` equal
    ``_win_fills`` and ``_ring_window``, the plain remat's words equal
    the JAX remat's, and the bounded walk from the round's path where it
    leaves the cell (its last aligned column there) leaves the cell as
    ``_walk_bounded_banded`` does."""
    d = chunked_2000
    n, NC, NWIN, W, Rp = d["n"], d["NC"], d["NWIN"], d["W"], d["Rp"]
    CW, w = n // NWIN, 1
    col0 = w * CW
    ch = d["chunks"][c]
    sl = slice(c * NC, (c + 1) * NC)
    e_, o_ = d["p"][2], d["p"][3]
    ck_j = np.concatenate([x["ck_j"] for x in d["chunks"]])
    hb_j = jnp.asarray(ck_j[:, :, LANES - 1])
    fills_j = msa_pallas._win_fills(
        jnp.asarray(ck_j[sl]), hb_j, ch["tabs_j"][0], ch["tabs_j"][1],
        jnp.int32(w - 1), jnp.int32(col0), jnp.int32(e_), jnp.int32(o_))
    predsT_c, pmaskT_c, bases_c, _ = ch["tabs_p"]
    hb_p = d["ck_p"][:, :, 0].contiguous()
    fills_p = msa_chunked.win_fills(d["ck_p"][sl], hb_p, predsT_c, pmaskT_c,
                                    w - 1, col0, e_, o_)
    r = ch["rows"]
    assert np.array_equal(fills_p[:, :r].numpy(), np.asarray(fills_j)[:, :r])
    ring_wj = msa_pallas._ring_window(ch["snap_j"], jnp.int32(w), Rp,
                                      Rp // NWIN)
    ring_wp = msa_chunked.ring_window(ch["snap_p"], n, col0, CW)
    got = ring_wp[:, :, msa_poa.ring_positions(CW, CPU)].numpy()
    assert np.array_equal(got, _ring_cols_jax(ring_wj, Rp // NWIN))

    scal = jnp.asarray([[d["n_real"], c * NC, col0]], jnp.int32)
    a2d_w = d["a2d"][w * (Rp // NWIN):(w + 1) * (Rp // NWIN)]
    words_j, _, _, _ = msa_pallas._poa_chunk_call(
        ch["tabs_j"][0], ch["tabs_j"][1], ch["tabs_j"][2], fills_j, scal,
        a2d_w, ring_wj, NC, CW, W, d["max_in"], d["p"])
    words_p, _ = msa_native.round_dp_plain(
        predsT_c, pmaskT_c, bases_c, fills_p, d["t"]["a"][col0:col0 + CW],
        d["n_real"], r, d["params"], W, ring=ring_wp, chunk_base=c * NC,
        col0=col0)
    assert np.array_equal(words_p[:r].numpy(),
                          convert.poa_words_from_jax(words_j)[:r].numpy())

    j = max(k for k in range(col0, min(col0 + CW, d["n_real"]))
            if c * NC <= d["align"][k] < c * NC + r)
    row = int(d["align"][j])
    align_j = jnp.full((n,), -1, jnp.int32)
    out = msa_pallas._walk_bounded_banded(
        words_j, ch["tabs_j"][0], jnp.int32(row), jnp.int32(j), jnp.int32(0),
        align_j, jnp.int32(c * NC), n, NC, jnp.int32(col0))
    align_p = torch.full((n,), -1, dtype=torch.int32)
    st = msa_poa.walk_bounded_plain(words_p, d["t"]["preds"][sl], row, j, 0,
                                    c * NC, col0, align_p)
    assert st.tolist() == [int(x) for x in out[:3]]
    assert np.array_equal(align_p.numpy(), np.asarray(out[3]))
    assert (align_p >= 0).sum() > 100
    got = align_p[:d["n_real"]].numpy()
    assert np.array_equal(got[got >= 0], d["align"][got >= 0])


@pytest.mark.parametrize("n,cw", [(2048, 1024), (196608, 24576)])
def test_ring_window_round_trip(n, cw):
    """``poa_dp.cu`` keeps column d*C + t*S + k of an n-column launch (shard
    d of C = 256*S columns, thread t) at d*256*S + k*256 + t, the plan
    (D, C, S) a function of n alone (``msa_poa.poa_plan``: S = 8 at these
    widths); a window cut at one width and laid out for another keeps
    every column's value, and cutting the whole width is the identity."""
    W = 2

    def layout(width):
        S = 8
        C = 256 * S
        cols = np.arange(width)
        r = cols % C
        return ((cols // C) * C + (r % S) * 256 + r // S,
                -(-width // C) * C)

    pos, rs = layout(n)
    assert np.array_equal(msa_poa.ring_positions(n, CPU).numpy(), pos)
    vals = np.arange(W * 2 * n, dtype=np.int32).reshape(W, 2, n)
    snap = torch.full((W, 2, rs), -7, dtype=torch.int32)
    snap[:, :, torch.from_numpy(pos)] = torch.from_numpy(vals)
    assert torch.equal(msa_chunked.ring_window(snap, n, 0, n)[:, :, pos],
                       snap[:, :, pos])
    wpos, wrs = layout(cw)
    for col0 in range(0, n, cw):
        win = msa_chunked.ring_window(snap, n, col0, cw)
        assert win.shape == (W, 2, wrs)
        assert np.array_equal(win[:, :, wpos].numpy(),
                              vals[:, :, col0:col0 + cw])


def test_prep_round_plans_and_cpu_wrappers_take_the_plain_versions():
    """``prep_round`` gives NC and NWIN; on CPU tensors the DP wrapper's
    chunk and window uses and the bounded walk run the plain versions
    (no kernel launch)."""
    seqs = _pair(41, 2000)
    params = AlignParams()
    g = PoaGraph.from_sequence(seqs[0], 2)
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, seqs[1], params,
                                                      CPU_BUDGET)
    assert (NC, NWIN) == (None, 0)
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, seqs[1], params,
                                                      2 ** 30 // 100)
    assert (NC, NWIN) == (512, 2)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x[:, :NC]))
         for x in (predsT, pmaskT, bases, fills)]
    t[2] = t[2].reshape(NC)
    before = dict(_kernels.launches)
    ring = msa_poa.new_ring(W, n, CPU)
    ck = torch.zeros((NC, NWIN, 3), dtype=torch.int32)
    words, sc = msa_poa.poa_dp(*t, torch.from_numpy(a), n_real, NC, params,
                               W, ring=ring, ckpt=ck, with_words=False)
    assert words is None and (sc < 0).all() and ck.any() and ring.any()
    wp, _ = msa_poa.poa_dp(*t, torch.from_numpy(a[:1024]), n_real, NC,
                           params, W, ring=msa_poa.new_ring(W, 1024, CPU))
    align = torch.full((n,), -1, dtype=torch.int32)
    st = msa_poa.poa_walk_bounded(wp, torch.from_numpy(preds[:NC]), NC - 1,
                                  1023, 0, 0, 0, align)
    assert st.dtype == torch.int32 and st.shape == (3,)
    assert _kernels.launches == before
