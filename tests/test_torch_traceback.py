"""The port's traceback (tsta_tpu_torch.ops.traceback) against the JAX
package's: the plain lockstep walk on the JAX kernel's plane (through
convert.plane_from_jax) against the JAX banded Pallas walk (interpret
mode) and the JAX lockstep walk, the move rules, and the host helpers,
with zero tolerance; and the walk kernels' window schedule
(``walk_staged_plain``) against the plain walk on those planes and on
synthetic ones (pure-left, pure-up, diagonal, random codes, planes
narrower than a window)."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu.ops import traceback as jtb
from tsta_tpu_torch import convert
from tsta_tpu_torch.ops import traceback as ttb

P0 = (2, -5, -2, -4)


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _jax_group(pairs, params=P0):
    """JAX packed traced DP over one group -> (plane words, nm, Rp)."""
    P = len(pairs)
    n_real = [len(a) for a, _ in pairs]
    m_real = [len(b) for _, b in pairs]
    n_pad = max(jdiff._traced_n_pad(n) for n in n_real)
    m_pad = -(-max(m_real) // jdiff.T_R) * jdiff.T_R
    Rp = n_pad // jdiff.LANES
    a8 = np.full((P * Rp, jdiff.LANES), jdiff.A_PAD, np.uint8)
    b8 = np.full((m_pad, P), jdiff.B_PAD, np.uint8)
    nm = np.zeros((P, 2), np.int32)
    for k, (a, b) in enumerate(pairs):
        row = np.full(n_pad, jdiff.A_PAD, np.uint8)
        row[:len(a)] = a
        a8[k * Rp:(k + 1) * Rp] = row.reshape(Rp, jdiff.LANES)
        b8[:len(b), k] = b
        nm[k] = (len(a), len(b))
    _, _, plane = jdiff._psa_diff_traced_call(
        jnp.asarray(a8.astype(np.int32)), jnp.asarray(b8.astype(np.int32)),
        jnp.asarray(nm), n_pad, m_pad, P, params)
    return plane, nm, Rp


def _edited(rng, n, subs, dels):
    a = _rnd(rng, n)
    b = a.copy()
    idx = rng.integers(0, n, subs)
    b[idx] = _rnd(rng, len(idx))
    return a, np.delete(b, rng.integers(0, n, dels))


def _walk_cases():
    rng = np.random.default_rng(91)
    gap_runs = []
    for _ in range(3):
        n = int(rng.integers(200, 400))
        a = _rnd(rng, n)
        b = np.delete(a, rng.integers(0, n, n // 10))
        b = np.insert(b, rng.integers(0, len(b), n // 20), _rnd(rng, n // 20))
        gap_runs.append((a, b) if len(a) >= len(b) else (b, a))
    # move counts on and next to a 16-move word boundary
    flush = []
    for ln in (512, 496, 497):
        a = _rnd(rng, ln)
        flush.append((a, a.copy()))
    uneven = [_edited(rng, ln, ln // 20, ln // 30) for ln in (512, 480, 200)]
    return {"gap_runs": gap_runs, "word_flush": flush, "uneven": uneven}


@pytest.mark.parametrize("name", ["gap_runs", "word_flush", "uneven"])
def test_plain_walk_on_jax_plane_matches_jax_walks(name):
    pairs = _walk_cases()[name]
    plane, nm, Rp = _jax_group(pairs)
    P = len(pairs)
    tplane = convert.plane_from_jax(plane, P)
    words, counts = ttb.walk_packed_plain(tplane, torch.from_numpy(nm))
    words, counts = words.numpy(), counts.numpy()
    # JAX lockstep walk (XLA)
    jm, jc = jtb._decode_moves_packed(plane, jnp.asarray(nm), Rp)
    jm, jc = np.asarray(jm), np.asarray(jc)
    assert np.array_equal(counts, jc)
    for k in range(P):
        assert np.array_equal(ttb.unpack_moves(words[k], counts[k]),
                              jm[k, :jc[k]])
    assert np.array_equal(words, np.asarray(jtb.pack_moves_words(
        jnp.asarray(jm))))
    # JAX banded walk (Pallas, interpret mode) when its gate admits it
    if jdiff._banded_walk_gate(Rp, plane.shape[0] * 4, P, Rp * 128):
        bw, bc = jtb._decode_moves_banded_packed(plane, jnp.asarray(nm), Rp)
        bw, bc = np.asarray(bw), np.asarray(bc)
        assert np.array_equal(counts, bc)
        for k in range(P):
            n_used = (int(bc[k]) + 15) // 16
            assert np.array_equal(words[k, :n_used], bw[k, :n_used])
    # and the alignments equal the oracle's host walk
    for k, (a, b) in enumerate(pairs):
        aln = ttb.emit_alignment(ttb.unpack_moves(words[k], counts[k]),
                                 a, b, len(a), len(b))
        r = jscan.psa_align(a, b, P0, traced=True)
        assert aln == jtb.decode_pair(np.asarray(r.back), np.asarray(r.fback),
                                      np.asarray(r.eback), a, b)


def test_walk_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    pairs = [_edited(rng, 300, 15, 10), (_rnd(rng, 100), _rnd(rng, 60))]
    plane, nm, _ = _jax_group(pairs)
    tplane = convert.plane_from_jax(plane, 2)
    w1, c1 = ttb.walk_packed(tplane, torch.from_numpy(nm))
    w2, c2 = ttb.walk_packed_plain(tplane, torch.from_numpy(nm))
    assert torch.equal(w1, w2) and torch.equal(c1, c2)
    assert w1.shape == (2, ttb.packed_words_len(sum(tplane.shape[1:])))
    with pytest.raises(ValueError):
        ttb.walk_packed(tplane.to(torch.int32), torch.from_numpy(nm))
    with pytest.raises(ValueError):
        ttb.walk_packed(tplane, torch.from_numpy(nm).to(torch.int64))


def test_decode_step_matches_jax_exhaustively():
    grid = list(itertools.product(
        [False, True], [-1, 0, 1, 2], [-1, 0, 1, 2], [0, 1, 3],
        range(27), range(3), range(3)))
    cols = [np.array(c) for c in zip(*grid)]
    jm, jf = jtb._decode_step(*(jnp.asarray(c) for c in cols))
    tm, tf = ttb.decode_step(*(torch.from_numpy(c) for c in cols))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tf.numpy(), np.asarray(jf))


def test_move_packing_matches_jax():
    rng = np.random.default_rng(13)
    for L in (1, 15, 16, 17, 250):
        moves = rng.integers(0, 3, (3, L)).astype(np.int8)
        tw = ttb.pack_moves_words(torch.from_numpy(moves)).numpy()
        jw = np.asarray(jtb.pack_moves_words(jnp.asarray(moves)))
        assert tw.dtype == np.int32 and np.array_equal(tw, jw)
        assert ttb.packed_words_len(L) == jtb.packed_words_len(L)
        for k in range(3):
            for count in (0, L // 2, L):
                assert np.array_equal(ttb.unpack_moves(tw[k], count),
                                      jtb.unpack_moves(jw[k], count))


def _codes(back, fback, eback):
    """Three oracle planes -> packed cell codes back*9 + f*3 + e, with
    f/e 0 extend (+-1), 1 open (2), 2 open-tie (-2)."""
    def k(x):
        return np.where(x == 1, 0, np.where(x == 2, 1, 2))
    return (back * 9 + k(fback) * 3 + k(eback)).astype(np.int8)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(29)
    params = AlignParams()
    for _ in range(3):
        a, b = _edited(rng, int(rng.integers(50, 250)), 8, 6)
        r = jscan.psa_align(a, b, params, traced=True)
        planes = [np.asarray(x) for x in (r.back, r.fback, r.eback)]
        aln = ttb.decode_pair(*planes, a, b)
        assert aln == jtb.decode_pair(*planes, a, b)
        assert (ttb.score_alignment(aln.a_row, aln.b_row, params)
                == jtb.score_alignment(aln.a_row, aln.b_row, params)
                == int(r.last))
        moves, count = jtb._decode_moves(jnp.asarray(_codes(*planes)),
                                         len(b), len(a))
        mv = np.asarray(moves)[:int(count)]
        assert (ttb.emit_alignment(mv, a, b, len(a), len(b))
                == jtb.emit_alignment(mv, a, b, len(a), len(b)) == aln)
    with pytest.raises(ValueError):
        ttb.decode_pair(np.zeros((3, 3), np.int8), np.zeros((3, 3)),
                        np.zeros((3, 3)), np.zeros(2, np.uint8),
                        np.zeros(3, np.uint8))


# phase lengths of the staged walk: many phases on these small planes, and
# one window wider than most of them
S_CASES = [2, 4, 8, 64]


@functools.lru_cache(maxsize=None)
def _jax_walk_case(name):
    pairs = _walk_cases()[name]
    plane, nm, Rp = _jax_group(pairs)
    jm, jc = jtb._decode_moves_packed(plane, jnp.asarray(nm), Rp)
    return (convert.plane_from_jax(plane, len(pairs)), nm, np.asarray(jm),
            np.asarray(jc))


def _staged_packed(plane, nm, S):
    """``walk_staged_plain`` at base 0 over each pair's whole plane from
    (m-1, n-1), packed as the walk kernel packs: (words, counts)."""
    P, m_pad, n_pad = plane.shape
    moves = torch.zeros((P, m_pad + n_pad), dtype=torch.int8)
    zero = torch.zeros(n_pad, dtype=torch.uint8)
    counts = []
    for k in range(P):
        n, m = (int(x) for x in nm[k])
        st = ttb.walk_staged_plain(plane[k], zero, 0, m - 1, n - 1, 0, 0,
                                   moves[k], S).tolist()
        assert st[:2] == [-1, -1] and st[3] == 0
        counts.append(st[2])
    return ttb.pack_moves_words(moves), torch.tensor(counts, dtype=torch.int32)


@pytest.mark.parametrize("S", S_CASES)
@pytest.mark.parametrize("name", ["gap_runs", "word_flush", "uneven"])
def test_staged_walk_on_jax_plane_matches_plain_and_jax_walks(name, S):
    """The window ring's schedule on the JAX kernel's plane: every word
    and count equal to the plain lockstep walk's, and the moves to the
    JAX lockstep walk's, with no read outside a window."""
    plane, nm, jm, jc = _jax_walk_case(name)
    words, counts = _staged_packed(plane, nm, S)
    pw, pc = ttb.walk_packed_plain(plane, torch.from_numpy(nm))
    assert torch.equal(counts, pc) and torch.equal(words, pw)
    assert np.array_equal(counts.numpy(), jc)
    for k in range(len(nm)):
        assert np.array_equal(ttb.unpack_moves(words[k], counts[k]),
                              jm[k, :jc[k]])


def synthetic_plane(kind, rows, n_pad, seed):
    """A (rows, n_pad) uint8 code plane whose walk runs pure left (back 0,
    f open), pure up (back 2, e open), diagonally, or over random codes
    (every back, f and e code, so forced gap runs through ties)."""
    code = {"left": 0 * 9 + 1 * 3, "up": 2 * 9 + 1, "diagonal": 1 * 9}
    if kind == "random":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 27, (rows, n_pad))
                                .astype(np.uint8))
    return torch.full((rows, n_pad), code[kind], dtype=torch.uint8)


# (m_pad, n_pad, m, n): square, wide, tall, and narrower than one window
# at S = 64 in both directions (odd widths too)
SYNTH_SHAPES = [(48, 64, 48, 60), (12, 200, 9, 197), (160, 16, 150, 13),
                (5, 7, 5, 7)]


@pytest.mark.parametrize("S", S_CASES)
@pytest.mark.parametrize("kind", ["left", "up", "diagonal", "random"])
def test_staged_walk_matches_plain_walk_on_synthetic_planes(kind, S):
    """A whole-plane walk (base 0, to i < 0 and j < 0) on the ring's
    schedule equals the plain walk: every move and the exit state, on
    planes wider, taller and narrower than a window."""
    for k, (m_pad, n_pad, m, n) in enumerate(SYNTH_SHAPES):
        plane = synthetic_plane(kind, m_pad, n_pad, 31 * k + S)
        zero = torch.zeros(n_pad, dtype=torch.uint8)
        got = torch.zeros(m_pad + n_pad, dtype=torch.int8)
        want = torch.zeros_like(got)
        st = ttb.walk_staged_plain(plane, zero, 0, m - 1, n - 1, 0, 0, got,
                                   S)
        assert st.tolist() == ttb.walk_bounded_plain(
            plane, zero, 0, m - 1, n - 1, 0, 0, want).tolist()
        assert st.tolist()[:2] == [-1, -1] and torch.equal(got, want)
        w, c = ttb.walk_packed_plain(plane[None].contiguous(), torch.tensor(
            [[n, m]], dtype=torch.int32))
        assert int(c[0]) == st[2] and torch.equal(
            w[0], ttb.pack_moves_words(got[None])[0])
        if kind == "left":
            assert not got[:n].any()
        elif kind == "up":
            assert (got[:m] == 2).all()
        elif kind == "diagonal":
            assert (got[:min(m, n)] == 1).all()


def test_walk_wrappers_refuse_a_phase_length_on_cpu():
    plane = synthetic_plane("random", 8, 16, 0)
    nm = torch.tensor([[16, 8]], dtype=torch.int32)
    with pytest.raises(ValueError):
        ttb.walk_packed(plane[None].contiguous(), nm, S=8)
    with pytest.raises(ValueError):
        ttb.walk_packed(plane[None].contiguous(), nm, threads=64)
    moves = torch.zeros(24, dtype=torch.int8)
    with pytest.raises(ValueError):
        ttb.walk_bounded(plane, plane[0], 0, 7, 15, 0, 0, moves, S=8)


def test_psa_walk_ab_child_parses_and_times_each_walk():
    """The walk A/B tool's timed process (run in either checkout on the
    card) is valid Python on ``psa_dp_ab``'s helpers and times K3 through
    ``walk_packed`` (also on the route's groups of a traced batch) and
    Q2-8 through ``walk_bounded``; ``--sweep`` takes S:threads shapes."""
    import ast
    from tsta_tpu_torch.tools import psa_dp_ab, psa_walk_ab
    assert psa_walk_ab.CHILD.startswith(psa_dp_ab.CHILD_HELPERS)
    tree = ast.parse(psa_walk_ab.CHILD)
    calls = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert {"walk_packed", "walk_bounded", "_traced_groups", "dp_packed",
            "chunk_dp", "ChunkedPair"} <= calls
    with pytest.raises(SystemExit):
        psa_walk_ab.main(["--help"])
