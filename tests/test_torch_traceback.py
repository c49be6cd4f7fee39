"""The port's traceback (tsta_tpu_torch.ops.traceback) against the JAX
package's: the plain lockstep walk on the JAX kernel's plane (through
convert.plane_from_jax) against the JAX banded Pallas walk (interpret
mode) and the JAX lockstep walk, the move rules, and the host helpers,
with zero tolerance."""

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
