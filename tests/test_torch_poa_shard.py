"""The column shards of ``csrc/poa_dp.cu`` on the CPU, with zero tolerance.

The kernel cuts a POA round's columns into D shards, one co-resident block
each, and hands each shard's left boundary over as a packet of the four
``fills`` values per node.  Here, with the plain version alone:

* ``msa_poa.poa_plan`` against its definition, at the smoke's widths;
* ``ring_positions``: a shard's columns interleaved over its threads, every
  column in its own ring slot;
* the composition that makes the packet enough: a round cut into shards of
  C columns, shard 0 from the caller's fills and shard d >= 1 through
  ``round_dp_plain(..., col0=d*C)`` seeded by ``msa_chunked.win_fills`` of
  shard d - 1's checkpoint at column d*C - 1, equals the one-launch
  ``round_dp_plain`` in words, scores, ring and checkpoints, for the single
  call, a forward chunk from a carried ring and a window remat, on grown
  graphs with multi-pred nodes.
"""

import numpy as np
import pytest
import torch

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import msa_chunked, msa_native, msa_poa

CPU = torch.device("cpu")
AP = AlignParams()
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.mark.parametrize("n,want", [
    (768, (1, 2048, 8, 16)),        # a 700 bp read
    (5120, (3, 2048, 8, 16)),       # the 5 x 5 kbp example
    (24576, (12, 2048, 8, 16)),     # a 200 kbp round's window remat
    (57344, (28, 2048, 8, 16)),     # the 50 kbp round 2
    (196608, (96, 2048, 8, 16)),    # a 200 kbp round's forward chunk
    (204800, (100, 2048, 8, 16)),   # a 200 kbp single call's width
    (300000, (74, 4096, 16, 16)),   # past 132 shards S doubles
    (1048576, (128, 8192, 32, 16)),
    (2000000, (245, 8192, 32, 16)),   # S at its most: 245 shards, walked
                                      # by the card's co-resident blocks
])
def test_poa_plan_against_its_definition(n, want):
    D, C, S, T = msa_poa.poa_plan(n)
    assert (D, C, S, T) == want
    assert S in (8, 16, 32) and C == 256 * S
    assert D == -(-n // C) and (D - 1) * C < n <= D * C
    span = msa_poa.SHARD_MAX * msa_poa.SHARD_THREADS
    assert D <= msa_poa.SHARD_MAX or S == 32
    assert S == 8 or S == 32 or -(-n // span) <= S < 2 * -(-n // span)
    assert msa_poa.ring_width(n) == D * 256 * S


@pytest.mark.parametrize("n,D,want", [
    (2048, 1, (1, 2048, 8, 16)), (2048, 2, (2, 1024, 8, 16)),
    (2048, 5, (5, 412, 8, 16)), (2048, 3, (3, 684, 8, 16)),
    (196608, 48, (48, 4096, 16, 16)), (57344, 7, (7, 8192, 32, 16)),
    (24576, 4, (4, 6144, 32, 16)),
])
def test_poa_plan_forced_shards(n, D, want):
    assert msa_poa.poa_plan(n, D) == want
    assert msa_poa.poa_plan(n, D, T=64)[3] == 64
    with pytest.raises(ValueError):
        msa_poa.poa_plan(8, 3)   # 3 columns a shard round up to 4: 2 shards
    with pytest.raises(ValueError):
        msa_poa.poa_plan(196608, 2)   # 384 columns a thread


@pytest.mark.parametrize("n,D", [(768, None), (5120, None), (2048, 5),
                                 (24576, None)])
def test_ring_positions_interleave_each_shard(n, D):
    """Column d*C + t*S + k at d*256*S + k*256 + t: a permutation into the
    ring row, each shard inside its own 256*S ints, and at each k the
    threads of a warp on consecutive ints."""
    nd, C, S, _ = msa_poa.poa_plan(n, D)
    pos = msa_poa.ring_positions(n, CPU, D).numpy()
    assert len(np.unique(pos)) == n and pos.max() < msa_poa.ring_width(n, D)
    j = np.arange(n)
    d, t, k = j // C, (j % C) // S, (j % C) % S
    assert np.array_equal(pos, d * 256 * S + k * 256 + t)
    assert np.array_equal(pos // (256 * S), d)
    full = (t < 32) & (d == 0) & (k == 0) & ((j % C) < C)
    assert np.array_equal(np.diff(pos[full][:32]), np.ones(31))


def _grown_round(seed, length=700, reads=3):
    """A graph grown from ``reads - 1`` seeded reads (plain rounds on the
    CPU) and the next read: (g, read)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, length)
    seqs = [base.tobytes()]
    for _ in range(reads - 1):
        s = base.copy()
        hit = rng.integers(0, length, length // 8)
        s[hit] = rng.choice(ACGT, hit.size)
        s = np.delete(s, rng.integers(0, length, length // 60))
        seqs.append(np.insert(s, rng.integers(0, len(s), length // 60),
                              rng.choice(ACGT, length // 60)).tobytes())
    g = PoaGraph.from_sequence(seqs[0], reads)
    for sno in range(1, reads - 1):
        packed, order, _ = msa_poa.run_round(g, seqs[sno], AP, CPU, "plain",
                                             1 << 34)
        msa_native._finish_round(g, seqs[sno], sno, order, packed.numpy(),
                                 [], [], [])
    return g, seqs[-1]


def _tables(g, read, W=None):
    prep, n, n_real, a, _, _ = msa_poa.prep_round(g, read, AP, 1 << 34)
    predsT, pmaskT, bases, fills, N, max_in, Wp, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    return t, n, n_real, len(order), Wp if W is None else W


def _relay(ring, n_from, col0, n_to, D_to=None):
    """Columns [col0, col0 + n_to) of a ring laid out for an n_from-column
    launch, laid out for an n_to-column launch (D_to as poa_plan's D)."""
    out = torch.zeros((ring.shape[0], 2, msa_poa.ring_width(n_to, D_to)),
                      dtype=ring.dtype)
    src = msa_poa.ring_positions(n_from, CPU)[col0:col0 + n_to]
    out[:, :, msa_poa.ring_positions(n_to, CPU, D_to)] = ring[:, :, src]
    return out


def _sharded(tabs, n_real, n_nodes, W, C, bound, *, col0=0, ring=None,
             chunk_base=0, with_words=True):
    """One launch's DP as the kernel's shards compute it, with the plain
    version: the launch's columns [col0, col0 + n) cut into shards of C
    columns (col0 a multiple of C), shard 0 from the caller's fills, shard
    d >= 1 seeded by ``win_fills`` of shard d - 1's checkpoint at its last
    column.  ``bound``: (rows of the round, windows, 3) checkpoints at
    every global column k*C - 1, of every row (the earlier chunks' filled
    in), written here for the launch's rows.  Returns (words, scores,
    ring out)."""
    predsT, pmaskT, bases, fills, a = tabs
    n = a.shape[0]
    N = predsT.shape[1]
    rows = slice(chunk_base, chunk_base + N)
    words = torch.zeros((N, n), dtype=torch.int16) if with_words else None
    scores = torch.full((N,), msa_native.NEG, dtype=torch.int32)
    ring_out = None if ring is None else ring.clone()
    for d in range(-(-n // C)):
        c0 = col0 + d * C
        fl = fills if d == 0 else msa_chunked.win_fills(
            bound[rows], bound[:, :, 0], predsT, pmaskT, c0 // C - 1, c0,
            AP.gap_extend, AP.gap_open)
        cols = slice(d * C, min(n, (d + 1) * C))
        width = cols.stop - cols.start
        shard_ring = (None if ring is None
                      else _relay(ring, n, cols.start, width))
        ck = bound[rows]
        w, sc = msa_native.round_dp_plain(
            predsT, pmaskT, bases, fl, a[cols], n_real, n_nodes, AP, W,
            ring=shard_ring, chunk_base=chunk_base, col0=c0, ckpt=ck,
            with_words=with_words, cw=C)
        bound[rows] = ck
        if with_words:
            words[:, cols] = w
        scores = torch.where(sc != msa_native.NEG, sc, scores)
        if ring_out is not None:
            pos = msa_poa.ring_positions(n, CPU)[cols]
            ring_out[:, :, pos] = shard_ring[
                :, :, msa_poa.ring_positions(width, CPU)]
    return words, scores, ring_out


@pytest.mark.parametrize("seed,C", [(5, 256), (6, 384), (7, 128)])
def test_sharded_single_call_equals_one_launch(seed, C):
    g, read = _grown_round(seed)
    assert g.max_in_degree() > 1
    tabs, n, n_real, n_nodes, W = _tables(g, read)
    want_w, want_s = msa_native.round_dp_plain(*tabs, n_real, n_nodes, AP, W)
    D = -(-n // C)
    assert D >= 2
    bound = torch.zeros((tabs[0].shape[1], D, 3), dtype=torch.int32)
    got_w, got_s, _ = _sharded(tabs, n_real, n_nodes, W, C, bound)
    assert torch.equal(got_w[:n_nodes], want_w[:n_nodes])
    assert torch.equal(got_s, want_s)


@pytest.mark.parametrize("seed,C", [(8, 256), (9, 128)])
def test_sharded_forward_chunks_equal_one_launch(seed, C):
    """A round cut into node chunks of 512 rows (the ring carried from one
    to the next) with a checkpoint window per shard: per chunk the shards'
    scores, ring out and checkpoints equal the one-launch chunk's."""
    g, read = _grown_round(seed, 900)
    tabs, n, n_real, n_nodes, W = _tables(g, read)
    N = tabs[0].shape[1]
    NC, D = 512, -(-n // C)
    assert N % NC == 0 and N // NC >= 2 and D >= 2 and n % C == 0
    ring_1 = msa_poa.new_ring(W, n, CPU)
    ring_d = ring_1.clone()
    ck_1 = torch.zeros((N, D, 3), dtype=torch.int32)
    bound = torch.zeros_like(ck_1)
    for c in range(N // NC):
        sl = slice(c * NC, (c + 1) * NC)
        chunk = [tabs[0][:, sl].contiguous(), tabs[1][:, sl].contiguous(),
                 tabs[2][sl], tabs[3][:, sl].contiguous(), tabs[4]]
        rows = min(max(n_nodes - c * NC, 0), NC)
        _, s1 = msa_native.round_dp_plain(
            *chunk, n_real, rows, AP, W, ring=ring_1, chunk_base=c * NC,
            ckpt=ck_1[sl], with_words=False)
        _, sd, ring_d = _sharded(chunk, n_real, rows, W, C, bound,
                                 ring=ring_d, chunk_base=c * NC,
                                 with_words=False)
        assert torch.equal(sd, s1)
        assert torch.equal(ring_d, ring_1)
        assert torch.equal(bound[sl][:rows], ck_1[sl][:rows])


def test_sharded_window_remat_equals_one_launch():
    """Window 1 of 2 of a chunked round's chunk 1, its fills from the
    forward's checkpoints and its ring re-laid from the chunk's entry
    ring: cut into 4 shards it gives the one-launch remat's words, scores
    and ring."""
    g, read = _grown_round(10, 1700)
    tabs, n, n_real, n_nodes, W = _tables(g, read)
    N, NC, NWIN = tabs[0].shape[1], 512, 2
    CW = n // NWIN
    C = CW // 4
    assert n % NWIN == 0 and C % 4 == 0 and N // NC >= 2
    # the forward, twice: its NWIN windows, and every shard boundary (the
    # earlier chunk's rows are preds of the window's, whose H at a boundary
    # the kernel's left shard reads from the ring)
    ck = torch.zeros((N, NWIN, 3), dtype=torch.int32)
    bound = torch.zeros((N, n // C, 3), dtype=torch.int32)
    snaps = []
    for ckpt, cw in ((ck, None), (bound, C)):
        ring = msa_poa.new_ring(W, n, CPU)
        for c in range(2):
            sl = slice(c * NC, (c + 1) * NC)
            if cw is None:
                snaps.append(ring.clone())
            msa_native.round_dp_plain(
                tabs[0][:, sl].contiguous(), tabs[1][:, sl].contiguous(),
                tabs[2][sl], tabs[3][:, sl].contiguous(), tabs[4], n_real,
                min(n_nodes - c * NC, NC), AP, W, ring=ring,
                chunk_base=c * NC, ckpt=ckpt[sl], with_words=False, cw=cw)
    c, w = 1, 1
    sl = slice(c * NC, (c + 1) * NC)
    pt, pm = tabs[0][:, sl].contiguous(), tabs[1][:, sl].contiguous()
    fills = msa_chunked.win_fills(ck[sl], ck[:, :, 0].contiguous(), pt, pm,
                                  w - 1, w * CW, AP.gap_extend, AP.gap_open)
    win = [pt, pm, tabs[2][sl], fills, tabs[4][w * CW:(w + 1) * CW]]
    rows = min(n_nodes - c * NC, NC)
    ring_1 = msa_chunked.ring_window(snaps[c], n, w * CW, CW)
    want_w, want_s = msa_native.round_dp_plain(
        *win, n_real, rows, AP, W, ring=ring_1.clone(), chunk_base=c * NC,
        col0=w * CW)
    ring_out = ring_1.clone()
    msa_native.round_dp_plain(*win, n_real, rows, AP, W, ring=ring_out,
                              chunk_base=c * NC, col0=w * CW,
                              with_words=False)
    got_w, got_s, got_r = _sharded(win, n_real, rows, W, C, bound,
                                   col0=w * CW, ring=ring_1,
                                   chunk_base=c * NC)
    assert torch.equal(got_w[:rows], want_w[:rows])
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_r, ring_out)
    assert (got_w[:rows] != 0).any() and rows > 100


def test_poa_dp_ab_child_parses_and_runs_the_three_uses():
    """The A/B tool's timed process (run in either checkout on the card)
    is valid Python and times the DP in its three uses."""
    import ast
    from tsta_tpu_torch.tools import poa_dp_ab
    tree = ast.parse(poa_dp_ab.CHILD)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
             and n.attr in ("poa_dp", "forward_call", "remat_call")]
    assert {c.attr for c in calls} == {"poa_dp", "forward_call",
                                       "remat_call"}


def test_cpu_wrapper_refuses_the_kernel_overrides():
    """D and T force the kernel's plan and G its grid; on CPU tensors,
    which take the plain version, they raise rather than being
    ignored."""
    g, read = _grown_round(11, 300, 2)
    tabs, n, n_real, n_nodes, W = _tables(g, read)
    words, scores = msa_poa.poa_dp(*tabs, n_real, n_nodes, AP, W)
    assert words.shape == (tabs[0].shape[1], n) and (scores > -1e6).any()
    for kw in ({"D": 2}, {"T": 16}, {"G": 1}):
        with pytest.raises(ValueError, match="overrides"):
            msa_poa.poa_dp(*tabs, n_real, n_nodes, AP, W, **kw)
