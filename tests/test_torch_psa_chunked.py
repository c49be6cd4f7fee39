"""The port's chunked traced PSA (tsta_tpu_torch.ops.psa_chunked, plain
versions on the CPU) against the JAX package's: each chunk of the DP
against ``psa_pallas._psa_chunk_call`` (interpret mode), each bounded walk
against ``traceback._decode_moves_bounded_banded`` (the TPU kernel, in
interpret mode, on the chunk's native plane) and the XLA walk
``_decode_moves_bounded``, and the whole path against
``psa_pallas.psa_align_traced_chunked`` and the port's unchunked traced
path.  Exact integer equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu.ops import traceback as jtb
from tsta_tpu_torch import convert
from tsta_tpu_torch.ops import psa_chunked, psa_pallas
from tsta_tpu_torch.ops import traceback as tb

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
