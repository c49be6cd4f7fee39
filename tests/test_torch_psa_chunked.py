"""The port's chunked traced PSA (tsta_tpu_torch.ops.psa_chunked, plain
versions on the CPU) against the JAX package's: each chunk of the DP
against ``psa_pallas._psa_chunk_call`` (interpret mode), each bounded walk
against ``traceback._decode_moves_bounded_banded`` (the TPU kernel, in
interpret mode, on the chunk's native plane) and the XLA walk
``_decode_moves_bounded``, and the whole path against
``psa_pallas.psa_align_traced_chunked`` and the port's unchunked traced
path; the walk kernels' window rule (``traceback.walk_window``) at every
edge, and the bounded walk on the ring's schedule
(``traceback.walk_staged_plain``) against the plain bounded walk on the
JAX chunk planes and on synthetic chunks.  Exact integer equality
throughout."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu.ops import traceback as jtb
from tsta_tpu_torch import convert
from tsta_tpu_torch.ops import psa_chunked, psa_diff, psa_pallas
from tsta_tpu_torch.ops import traceback as tb

from test_torch_traceback import S_CASES, synthetic_plane

# tests/test_psa_pallas.py's parameter sets; its chunked cases draw
# seeds 100-102 with PARAMS[seed % 3]
PARAMS = [(2, -5, -2, -4), (3, -2, -1, -6), (1, -2, -2, 0)]
CPU = torch.device("cpu")


def _random_case(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(200, 900))
    m = int(rng.integers(520, 1200))
    return (rng.integers(65, 69, n).astype(np.uint8),
            rng.integers(65, 69, m).astype(np.uint8), PARAMS[seed % 3])


def _vertical_gap_case():
    """b is a with 350 bases inserted at row 200: the walk's up-run
    crosses the chunk boundaries at rows 256 and 512."""
    rng = np.random.default_rng(7)
    a = rng.integers(65, 69, 600).astype(np.uint8)
    ins = rng.integers(65, 69, 350).astype(np.uint8)
    return a, np.concatenate([a[:200], ins, a[200:]]), PARAMS[0]


CASES = {"seed0": lambda: _random_case(0), "seed1": lambda: _random_case(1),
         "seed2": lambda: _random_case(2), "vertical_gap": _vertical_gap_case}


def _jax_chunks(pair, p):
    """Each chunk of ``pair`` through ``_psa_chunk_call`` from the state
    JAX carries: [(plane (mc/4, R, 128), h, e, best, last)] after each."""
    R, mc = pair.n_pad // 128, pair.mc
    a2d = jnp.asarray(pair.a.numpy().astype(np.int32).reshape(R, 128))
    bcol = pair.b.numpy().astype(np.int32).reshape(-1, 1)
    h0, e0 = pair.entry()
    state = [jnp.asarray(convert.frontier_to_jax(x)) for x in (h0, e0)]
    state += [jnp.full((R, 128), psa_chunked.NEG, jnp.int32)] * 2
    out = []
    for c in range(pair.nchunks):
        nm3 = jnp.asarray([[pair.n_real, pair.m_real, c * mc]], jnp.int32)
        plane, *state = jpallas._psa_chunk_call(
            a2d, jnp.asarray(bcol[c * mc:(c + 1) * mc]), nm3, *state,
            pair.n_pad, mc, p)
        out.append((plane, *state))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_dp_matches_jax_chunk_call(case):
    """Every chunk of the plain chunk DP, carried from the entry, equals
    the JAX chunk kernel's: every code, the frontier out, and the
    running best and the corner."""
    a, b, p = CASES[case]()
    pair = psa_chunked.ChunkedPair(a, b, p, 256, CPU)
    assert pair.nchunks >= 3
    jax_chunks = _jax_chunks(pair, p)
    h, e = pair.entry()
    best = psa_chunked.NEG
    for c, (jplane, jh, je, jbest, jlast) in enumerate(jax_chunks):
        cbest, corner, codes, h, e = psa_chunked.chunk_dp_plain(
            *pair.chunk_call(c, h, e))
        assert torch.equal(codes, convert.chunk_plane_from_jax(jplane))
        assert torch.equal(h, convert.frontier_from_jax(jh))
        assert torch.equal(e, convert.frontier_from_jax(je))
        best = max(best, int(cbest))
        assert best == int(jnp.max(jbest))
        in_chunk = c == (pair.m_real - 1) // pair.mc
        want = (convert.frontier_from_jax(jlast)[pair.n_real - 1]
                if in_chunk else psa_chunked.NEG)
        assert int(corner) == int(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bounded_walk_matches_jax_walks(case):
    """Chunk by chunk from (m-1, n-1): the plain bounded walk equals the
    JAX bounded walk kernel (interpret mode, on the chunk's native word
    plane) and the XLA bounded walk, in every move and exit state."""
    a, b, p = CASES[case]()
    pair = psa_chunked.ChunkedPair(a, b, p, 256, CPU)
    jax_chunks = _jax_chunks(pair, p)
    planes = [convert.chunk_plane_from_jax(jc[0]) for jc in jax_chunks]
    last_rows = [pl[-1].clone() for pl in planes]
    L = pair.m_pad + pair.n_pad
    moves = torch.zeros(L, dtype=torch.int8)
    jm_banded = jm_xla = jnp.zeros((L,), jnp.int8)
    state = (pair.m_real - 1, pair.n_real - 1, 0, 0)
    walked = []
    while True:
        c = state[0] // pair.mc
        got = tb.walk_bounded_plain(*pair.walk_call(c, planes[c], last_rows,
                                                    *state, moves)).tolist()
        prev = (last_rows[c - 1] if c else torch.zeros(pair.n_pad,
                                                       dtype=torch.uint8))
        prev = jnp.asarray(prev.numpy().astype(np.int32))
        i, j, t, forced = (jnp.int32(v) for v in state)
        *jst, jm_banded = jtb._decode_moves_bounded_banded(
            jax_chunks[c][0], jpallas._pack_prev_row(prev), i, j, t, forced,
            jm_banded, jnp.int32(c * pair.mc), L + 16)
        *xst, jm_xla = jtb._decode_moves_bounded(
            jax_chunks[c][0].reshape(pair.mc // 4, pair.n_pad), i, j, t,
            forced, jm_xla, jnp.int32(c * pair.mc), prev)
        assert got == [int(v) for v in jst] == [int(v) for v in xst]
        walked.append(c)
        state = tuple(got)
        if state[0] < 0:
            break
    t = state[2]
    assert state[:2] == (-1, -1) and walked == sorted(walked, reverse=True)
    assert np.array_equal(moves.numpy()[:t], np.asarray(jm_banded)[:t])
    assert np.array_equal(moves.numpy()[:t], np.asarray(jm_xla)[:t])
    assert not moves[t:].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_pair_matches_jax_and_unchunked(case):
    """The whole chunked path at mc = 256 equals JAX's chunked path at
    mc = T_R and the port's unchunked traced path: score, corner, rows."""
    a, b, p = CASES[case]()
    want = jpallas.psa_align_traced_chunked(a, b, p, mc=jpallas.T_R)
    got = psa_chunked.psa_align_traced_chunked(a, b, p, mc=256, device="cpu")
    assert got == want
    assert got == psa_pallas.psa_align_traced_device(a, b, p, device="cpu")
    clock = psa_chunked.last_clock
    assert clock.remats == clock.walks - 1 >= clock.chunks - 1
    assert len(clock.launch_ms("dp")) == clock.chunks + clock.remats


@pytest.mark.parametrize("n", [2048, 3072])
def test_chunked_wide_pair_matches_jax(n):
    """``tests/test_psa_pallas.py``'s R % 8 == 0 widths at mc = 512."""
    rng = np.random.default_rng(3)
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = a.copy()
    hit = rng.random(n) < 0.05
    b[hit] = rng.integers(65, 69, int(hit.sum())).astype(np.uint8)
    b = np.delete(b, rng.integers(0, n, n // 50))
    p = PARAMS[0]
    want = jpallas.psa_align_traced_chunked(a, b, p, mc=512)
    got = psa_chunked.psa_align_traced_chunked(a, b, p, mc=512, device="cpu")
    assert got == want
    assert got == psa_pallas.psa_align_traced_device(a, b, p, device="cpu")


def test_chunk_rows_follow_the_jax_rule():
    """mc doubles from 256 while two planes of 2 * mc rows fit a quarter
    of the budget: 65,536 for a 200 kbp pair on an 80 GB card."""
    gb80 = int(85_029_158_912 * 0.85)
    assert psa_chunked.chunk_rows(196_352, 200_064, gb80) == 65_536
    assert psa_chunked.chunk_rows(1024, 896, 1 << 20) == 256
    assert psa_chunked.chunk_rows(1024, 896, 1 << 30) == 512
    pair = psa_chunked.ChunkedPair(np.ones(850, np.uint8),
                                   np.ones(1000, np.uint8), PARAMS[0],
                                   dev=CPU, budget=1 << 30)
    assert (pair.mc, pair.nchunks, pair.n_pad) == (512, 2, 896)
    with pytest.raises(ValueError):
        psa_chunked.ChunkedPair(np.ones(10, np.uint8), np.ones(10, np.uint8),
                                PARAMS[0], 384, CPU)
    # M <= 0 chunks too (the round-1 guard), as the JAX path does
    edit = (np.frombuffer(b"ACGTTAGCAT", np.uint8),
            np.frombuffer(b"ACTTAGGCAT", np.uint8), (0, -1, -1, -1))
    assert (psa_chunked.psa_align_traced_chunked(*edit, device="cpu")
            == jpallas.psa_align_traced_chunked(*edit))
    with pytest.raises(ValueError):
        psa_chunked.psa_align_traced_chunked(np.ones(10, np.uint8),
                                             np.ones(10, np.uint8),
                                             (0, 0, -1, -1), device="cpu")


@pytest.mark.parametrize("n_pad,sms,rows,want", [
    (200_064, 132, 65_536, (98, 2048, 8, 32)),   # the 200 kbp pair
    (10_112, 132, 512, (10, 1024, 4, 32)),       # the 10 kbp example, mc 512
    (1_024, 132, 256, (1, 1024, 4, 32)),         # under one shard
    (5_000, 132, 256, (5, 1024, 4, 32)),         # not a multiple of D * W
    (200_064, 16, 65_536, (16, 13_312, 52, 32)),
])
def test_chunk_plan_cuts_the_columns_into_shards(n_pad, sms, rows, want):
    """The chunk kernel's plan: at most one shard per SM, >= 4 columns
    per thread (a multiple of 4: whole code words), every column in
    exactly one shard, a shard's columns within its 256 threads' strips,
    T no more than the chunk's rows, the fill (D - 1) * T within them."""
    D, C, W, T = plan = psa_chunked.chunk_plan(n_pad, sms)
    assert plan == want
    assert 1 <= D <= sms and W >= 4 and W % 4 == 0 and C % 4 == 0
    assert C <= psa_diff.TRACED_THREADS * W
    cover = np.zeros(n_pad, np.int32)
    for d in range(D):
        assert d * C < n_pad   # no empty shard
        cover[d * C:(d + 1) * C] += 1
    assert (cover == 1).all()
    assert T <= rows and (D - 1) * T <= rows


def test_frontier_conversion_round_trip():
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.integers(-9, 9, 384).astype(np.int32))
    s = convert.frontier_to_jax(h)
    assert s.shape == (3, 128) and s[2, 5] == h[261]
    assert torch.equal(convert.frontier_from_jax(s), h)
    with pytest.raises(ValueError):
        convert.frontier_to_jax(h[:100])


@pytest.mark.parametrize("case", ["psa_small3", "psa_small5"])
def test_cli_routes_an_over_budget_pair_to_chunks(case, monkeypatch, capsys,
                                                  tmp_path):
    """With a device budget the pair's plane does not fit, ``tsta-torch
    psa`` and ``batch --traced`` run it in row-chunks, with no option, and
    give the reference's golden output."""
    import os

    from tsta_tpu_torch import cli as tcli
    from tsta_tpu_torch import device
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", case)
    with open(os.path.join(golden, "params.txt")) as f:
        flags = f.read().split()
    with open(os.path.join(golden, "ref.out"), "rb") as f:
        ref = f.read()
    with open(os.path.join(golden, "ref.stdout")) as f:
        ref_stdout = f.read().strip()
    fa, fb = (os.path.join(golden, x) for x in ("a.fa", "b.fa"))
    monkeypatch.setattr(device, "CPU_BUDGET", 1 << 16)
    psa_chunked.last_clock = None
    out = tmp_path / "o.txt"
    assert tcli.main(["psa", "--device", "cpu", "-1", fa, "-2", fb, "-o",
                      str(out)] + flags) == 0
    assert capsys.readouterr().out.strip() == ref_stdout
    assert out.read_bytes() == ref
    assert psa_chunked.last_clock.chunks >= 2
    psa_chunked.last_clock = None
    manifest = tmp_path / "pairs.tsv"
    manifest.write_text("p0\t%s\t%s\n" % (fa, fb))
    assert tcli.main(["batch", "--device", "cpu", "--pairs", str(manifest),
                      "--traced", "--out-dir", str(tmp_path / "alns")]
                     + flags) == 0
    assert (tmp_path / "alns" / "p0.txt").read_bytes() == ref
    assert psa_chunked.last_clock.chunks >= 2


@functools.lru_cache(maxsize=None)
def _jax_chunk_planes(case):
    a, b, p = CASES[case]()
    pair = psa_chunked.ChunkedPair(a, b, p, 256, CPU)
    planes = [convert.chunk_plane_from_jax(jc[0])
              for jc in _jax_chunks(pair, p)]
    return pair, planes, [pl[-1].clone() for pl in planes]


@pytest.mark.parametrize("S", S_CASES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_walk_matches_bounded_walks(case, S):
    """Chunk by chunk on the JAX chunk kernel's planes (which
    ``test_bounded_walk_matches_jax_walks`` holds to JAX's walks): the
    bounded walk on the ring's schedule equals the plain bounded walk in
    every move and exit state, reading only its windows."""
    pair, planes, last_rows = _jax_chunk_planes(case)
    L = pair.m_pad + pair.n_pad
    got, want = (torch.zeros(L, dtype=torch.int8) for _ in range(2))
    state = (pair.m_real - 1, pair.n_real - 1, 0, 0)
    while True:
        c = state[0] // pair.mc
        args = pair.walk_call(c, planes[c], last_rows, *state, got)
        st = tb.walk_staged_plain(*args, S).tolist()
        assert st == tb.walk_bounded_plain(*args[:-1], want).tolist()
        state = tuple(st)
        if state[0] < 0:
            break
    assert state[:2] == (-1, -1) and torch.equal(got, want)


def _chunked_walk(plane, mc, m, n, S):
    """Walk a whole synthetic plane cut into chunks of ``mc`` rows (the
    last one shorter), both ways, chunk by chunk; returns the entries."""
    m_pad, n_pad = plane.shape
    got = torch.zeros(m_pad + n_pad, dtype=torch.int8)
    want = torch.zeros_like(got)
    state, entries = (m - 1, n - 1, 0, 0), []
    while True:
        c = state[0] // mc
        base = c * mc
        prev = (plane[base - 1] if c else torch.zeros(n_pad,
                                                       dtype=torch.uint8))
        chunk = plane[base:base + mc]
        entries.append(state[0] - base)
        st = tb.walk_staged_plain(chunk, prev, base, *state, got, S).tolist()
        assert st == tb.walk_bounded_plain(chunk, prev, base, *state,
                                           want).tolist()
        assert st[0] < base
        state = tuple(st)
        if state[0] < 0:
            break
    assert state[:2] == (-1, -1) and torch.equal(got, want)
    return entries


@pytest.mark.parametrize("S", S_CASES)
@pytest.mark.parametrize("kind", ["left", "up", "diagonal", "random"])
def test_staged_walk_in_chunks_on_synthetic_planes(kind, S):
    """Pure-left, pure-up, diagonal and random-code planes cut into chunks
    of 7 and 16 rows (a last chunk of a few rows, chunks narrower than a
    window, a chunk entered at its first row), and one long left run in
    a wide chunk: the ring's schedule equals the plain bounded walk."""
    for mc, (m_pad, n_pad, m, n) in ((7, (45, 64, 45, 61)),
                                     (16, (40, 200, 37, 190)),
                                     (3, (10, 700, 10, 699))):
        plane = synthetic_plane(kind, m_pad, n_pad, mc + S)
        entries = _chunked_walk(plane, mc, m, n, S)
        if kind == "up":   # each chunk entered at its last row
            assert entries[1:] == [mc - 1] * (len(entries) - 1)
    plane = synthetic_plane(kind, 5, 8, S)
    assert _chunked_walk(plane, 1, 5, 8, S) == [0] * 5   # first-row entries


@pytest.mark.parametrize("S", S_CASES)
def test_staged_walk_from_any_entry_of_a_chunk(S):
    """Random entries (row, column, carried forced move) into random-code
    chunks, the chunk's first row and base 0 among them, and an entry
    already outside the chunk's walk (0 steps at base > 0)."""
    rng = np.random.default_rng(S)
    plane = synthetic_plane("random", 64, 96, S)
    for _ in range(24):
        base = int(rng.choice([0, 5, 17, 40]))
        rows = int(rng.integers(1, 64 - base + 1))
        i = base + int(rng.choice([0, rows - 1, rng.integers(0, rows)]))
        j = int(rng.choice([-1, 0, 95, rng.integers(0, 96)]))
        forced = int(rng.choice([0, 1, 3])) if j >= 0 else 0
        chunk, prev = plane[base:base + rows], (
            plane[base - 1] if base else torch.zeros(96, dtype=torch.uint8))
        got, want = torch.zeros(300, dtype=torch.int8), torch.zeros(
            300, dtype=torch.int8)
        st = tb.walk_staged_plain(chunk, prev, base, i, j, 3, forced, got, S)
        assert st.tolist() == tb.walk_bounded_plain(
            chunk, prev, base, i, j, 3, forced, want).tolist()
        assert torch.equal(got, want)
    moves = torch.zeros(8, dtype=torch.int8)
    st = tb.walk_staged_plain(plane[8:16], plane[7], 8, 7, 4, 2, 0, moves, S)
    assert st.tolist() == [7, 4, 2, 0] and not moves.any()


@pytest.mark.parametrize("i0,j0,S,row_lo,rows,n_pad", [
    (0, 0, 8, 0, 64, 128),            # the matrix's first cell
    (63, 127, 8, 0, 64, 128),         # the bottom-right corner
    (5, 200, 64, 0, 6, 256),          # a plane shorter than a window
    (40, 40, 64, 0, 48, 48),          # narrower than a window, both ways
    (70, 100, 4, 64, 8, 128),         # a chunk's rows only
    (64, 9, 32, 64, 512, 128),        # entry at the chunk's first row
    (71, 3, 2, 64, 8, 16),            # the chunk's last row, column 3
    (2000, 199_999, 64, 1536, 512, 200_064),   # phase 15 (b)'s chunks
    (-1, 5, 8, 0, 64, 128),           # outside the matrix: empty
    (10, -1, 8, 0, 64, 128),
])
def test_walk_window_is_clipped(i0, j0, S, row_lo, rows, n_pad):
    """The window never asks for a row outside [row_lo, row_lo + rows) or
    a column outside [0, n_pad), its columns start on a 16-byte boundary
    and span at most 2S + 16, and it holds every cell of the plane that
    the 2S steps after the anchor can read (rows i0 - 2S..i0, columns j0 -
    2S..j0), unless the anchor is outside the matrix."""
    r0, r1, c0, c1 = tb.walk_window(i0, j0, S, row_lo, rows, n_pad)
    assert row_lo <= r0 <= r1 <= row_lo + rows
    assert 0 <= c0 <= c1 <= n_pad and c0 % 16 == 0 and c1 - c0 <= 2 * S + 16
    assert r1 - r0 <= 2 * S + 1
    if i0 < 0 or j0 < 0:
        assert r1 == r0
        return
    assert r0 == max(i0 - 2 * S, row_lo) and r1 == min(i0 + 1, row_lo + rows)
    assert c0 <= max(j0 - 2 * S, 0) and c1 >= min(j0 + 1, n_pad)


def test_walk_window_covers_every_reachable_read():
    """Over a sweep of anchors, phase lengths and planes: every cell the
    2S steps after the anchor may read lies in the window or, in a chunk,
    is row row_lo - 1 (the staged ``prev_row``) or outside the plane."""
    rng = np.random.default_rng(11)
    for _ in range(400):
        S = int(rng.choice([2, 4, 8, 32, 64, 128]))
        n_pad = int(rng.integers(1, 300))
        row_lo = int(rng.choice([0, rng.integers(0, 500)]))
        rows = int(rng.integers(1, 300))
        i0 = int(rng.integers(row_lo, row_lo + rows))
        j0 = int(rng.integers(0, n_pad))
        r0, r1, c0, c1 = tb.walk_window(i0, j0, S, row_lo, rows, n_pad)
        assert row_lo <= r0 <= r1 <= row_lo + rows and c0 % 16 == 0
        for r in (i0 - 2 * S, i0 - S, i0):
            for c in (j0 - 2 * S, j0 - S, j0):
                if row_lo <= r < row_lo + rows and 0 <= c < n_pad:
                    assert r0 <= r < r1 and c0 <= c < c1
