"""The CUDA kernels of tsta_tpu_torch (PSA DP, the row-chunk DP, the
short-pair DP, the difference-method (int16) DP, the striped-layout DP,
PSA walk, two-pair walk and bounded walk (the walks on the window ring
at forced phase lengths too), the ring wavefront (one launch on one
card, and its linked build one launch a card across cards), POA round
DP in its single-call, forward-chunk and window-remat uses, POA walk and
bounded walk) against their plain PyTorch versions on the card, with
exact integer equality, and the kernel routes of the MSA engine, chunked
rounds included, of the chunked traced PSA, of the round-1 PSA (M <= 0)
and of the ring against the CPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (this file imports no jax, so it also runs on a host without it):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan
from tsta_tpu_torch.ops import traceback as tb
from tsta_tpu_torch.ops.psa_pallas import SHORT_WIDTHS

P0 = (2, -5, -2, -4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(seed, lengths, m_quantum=1, n_quantum=1, similar=False):
    rng = np.random.default_rng(seed)
    ns = [n for n, _ in lengths]
    ms = [m for _, m in lengths]
    n_pad = -(-max(ns) // n_quantum) * n_quantum
    m_pad = -(-max(ms) // m_quantum) * m_quantum
    a = np.full((len(ns), n_pad), psa_scan.A_PAD, np.uint8)
    b = np.full((len(ns), m_pad), psa_scan.B_PAD, np.uint8)
    for k, (n, m) in enumerate(lengths):
        a[k, :n] = rng.integers(65, 69, n)
        if similar:
            src = np.delete(a[k, :n], rng.integers(0, n, max(1, n // 15)))
            src = np.concatenate([src, rng.integers(65, 69, m)])[:m]
            src[rng.integers(0, m, max(1, m // 20))] = 65
            b[k, :m] = src
        else:
            b[k, :m] = rng.integers(65, 69, m)
    lens = np.array([ns, ms], np.int32).T.copy()
    return (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lens))


@pytest.mark.cuda
@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6), (1, -1, -1, 0)])
def test_dp_score_kernel_matches_plain(cuda, params):
    a, b, lens = _batch(1, [(1, 1), (7, 300), (300, 7), (1000, 950),
                            (513, 700), (2100, 1800)], 256, 128)
    want = psa_diff.dp_packed(a, b, lens, params)
    n0 = _kernels.launches["psa_dp_score"]
    got = psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens.to(cuda), params)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_dp_score"] == n0 + 1
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("similar", [False, True])
def test_dp_traced_kernel_and_walk_match_plain(cuda, similar):
    a, b, lens = _batch(2, [(512, 500), (400, 512), (130, 60), (9, 8)],
                        256, 512, similar=similar)
    ws, wc, wplane = psa_diff.dp_packed(a, b, lens, P0, traced=True)
    gs, gc, gplane = psa_diff.dp_packed(a.to(cuda), b.to(cuda),
                                        lens.to(cuda), P0, traced=True)
    torch.cuda.synchronize()
    assert torch.equal(gs.cpu(), ws) and torch.equal(gc.cpu(), wc)
    assert torch.equal(gplane.cpu(), wplane)
    n0 = _kernels.launches["psa_walk"]
    gw, gcnt = tb.walk_packed(gplane, lens.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.launches["psa_walk"] == n0 + 1
    pw, pcnt = tb.walk_packed_plain(wplane, lens)
    assert torch.equal(gcnt.cpu(), pcnt) and torch.equal(gw.cpu(), pw)


@pytest.mark.cuda
def test_traced_batch_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(65, 69, n).astype(np.uint8),
              rng.integers(65, 69, m).astype(np.uint8))
             for n, m in [(600, 580), (300, 200), (50, 50)]]
    want = psa_diff.psa_align_batch_traced_packed(pairs, P0, device="cpu")
    got = psa_diff.psa_align_batch_traced_packed(pairs, P0, device=cuda)
    assert got == want


@pytest.mark.cuda
def test_wrappers_refuse_bad_tensors(cuda):
    a, b, lens = _batch(3, [(100, 90)], 256, 128)
    with pytest.raises(ValueError):
        psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens, P0)
    with pytest.raises(ValueError):
        psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens.to(cuda).long(), P0)
    plane = torch.zeros((1, 256, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tb.walk_packed(plane[:, :, :64], lens.to(cuda))


_SCORE_INPUTS = {}


def _score_inputs(name):
    """The smoke's phase 3 shapes on the CPU with their plain outputs,
    made once: 64 mixed pairs of 100-3,000 bp (every other one similar)
    and a similar 40 kbp pair, packed as the score-only route packs
    them."""
    if name not in _SCORE_INPUTS:
        rng = np.random.default_rng(3)
        if name == "mixed":
            lengths = [(int(rng.integers(100, 3001)),
                        int(rng.integers(100, 3001))) for _ in range(64)]
        else:
            lengths = [(40000, 39700)]
        pairs = [_long_pair(k, n, m) if k % 2 == 0 else
                 (rng.integers(65, 69, n).astype(np.uint8),
                  rng.integers(65, 69, m).astype(np.uint8))
                 for k, (n, m) in enumerate(lengths)]
        group = psa_diff.pack_pairs(pairs, torch.device("cpu"))
        _SCORE_INPUTS[name] = (group, psa_diff.run_dp(*group, P0))
    return _SCORE_INPUTS[name]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 32])
@pytest.mark.parametrize("D", [None, 1, 2, 3, 5])
@pytest.mark.parametrize("name", ["mixed", "40 kbp"])
def test_psa_dp_score_kernel_matches_plain(cuda, name, D, T):
    """psa_dp.cu's K1 launch against the plain version on the smoke's
    phase 3 batch (pairs that end in an earlier shard than the widest)
    and a 40 kbp pair (at D = 1 past the shared-memory frontier), at the
    plan and at forced D = 1, 2, 3 and 5, T = 1, 16 and 32: every score
    and corner equal; one launch."""
    (a, b, lens), want = _score_inputs(name)
    got = [torch.empty((a.shape[0],), dtype=torch.int32, device=cuda)
           for _ in range(2)]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n0 = _kernels.launches["psa_dp_score"]
    ran = _kernels.psa_dp(a.to(cuda), b.to(cuda), lens.to(cuda), P0, *got,
                          D=D, T=T)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_dp_score"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    plan = psa_diff.score_plan(a.shape[0], a.shape[1], sms)
    assert ran == (D or plan[0], plan[1] if D is None
                   else -(-a.shape[1] // D), T)


@pytest.mark.cuda
def test_psa_dp_score_run_dp_routes_to_it(cuda):
    """``run_dp`` score-only on the card launches K1 (never the traced
    DP, never a plain scan) and takes the D/T overrides."""
    (a, b, lens), want = _score_inputs("mixed")
    n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
    for kw in ({}, {"D": 4, "T": 8}):
        got = psa_diff.run_dp(a.to(cuda), b.to(cuda), lens.to(cuda), P0,
                              **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert _kernels.launches["psa_dp_score"] == n0["psa_dp_score"] + 2
    assert _kernels.launches["psa_dp_traced"] == n0["psa_dp_traced"]
    assert psa_scan.plain_calls == p0


@pytest.mark.cuda
def test_psa_dp_layout_is_score_plan(cuda):
    """The kernel's exported plan equals psa_diff.score_plan, and at one
    pair of the example's width it cuts the columns over several SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for s in sorted({1, 16, 132, sms}):
        for P in (1, 2, 3, 32, 128, 200, 5000, 70000):
            for n_pad in (1, 4, 128, 1024, 9088, 10112, 10240, 30720,
                          100096, 200064):
                assert (_kernels.psa_dp_layout(P, n_pad, s)
                        == psa_diff.score_plan(P, n_pad, s)), (P, n_pad, s)
    assert _kernels.psa_dp_layout(1, 10112, sms)[0] >= 2


@pytest.mark.cuda
def test_psa_dp_score_past_the_sms_and_the_resident_limit(cuda):
    """More pairs than SMs: the plan's D = 1, an ordinary launch of every
    pair's block, equal to the plain version, also past the card's
    resident limit; D = 2 past the limit raises KernelError naming it,
    without launching."""
    rng = np.random.default_rng(8)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pairs = [(rng.integers(65, 69, int(rng.integers(20, 300))).astype(
              np.uint8), rng.integers(65, 69, int(rng.integers(20, 200)))
              .astype(np.uint8)) for _ in range(3 * sms)]
    a, b, lens = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    limit1 = _kernels.psa_dp_max_blocks(a.shape[1], 32, cuda)
    reps = -(-(limit1 + 5) // len(pairs))
    a, b, lens = (x.repeat(reps, 1) for x in (a, b, lens))
    P = a.shape[0]
    want = psa_diff.run_dp(a, b, lens, P0)
    got = [torch.empty((P,), dtype=torch.int32, device=cuda)
           for _ in range(2)]
    n0 = _kernels.launches["psa_dp_score"]
    ran = _kernels.psa_dp(a.to(cuda), b.to(cuda), lens.to(cuda), P0, *got)
    torch.cuda.synchronize()
    assert ran[0] == 1 and P > limit1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    C = -(-a.shape[1] // 2)
    limit = _kernels.psa_dp_max_blocks(C, 32, cuda)
    Q = limit // 2 + 1
    with pytest.raises(_kernels.KernelError, match="at most %d" % limit):
        _kernels.psa_dp(a[:Q].to(cuda), b[:Q].to(cuda), lens[:Q].to(cuda),
                        P0, got[0][:Q], got[1][:Q], D=2, T=32)
    assert _kernels.launches["psa_dp_score"] == n0 + 1
    with pytest.raises(ValueError):   # 128 columns make 128 shards of 1
        _kernels.psa_dp(a[:1].to(cuda)[:, :128].contiguous(), b[:1].to(cuda),
                        lens[:1].to(cuda), P0, got[0][:1], got[1][:1], D=200)


def _reads(seed, n_reads, length, div=0.12):
    """A seeded base read and ``n_reads - 1`` copies with ~``div``
    substitutions and ~``div``/8 deletions."""
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), length)
    reads = [base.tobytes()]
    for _ in range(n_reads - 1):
        s = base.copy()
        hit = rng.integers(0, length, int(length * div))
        s[hit] = rng.choice(np.frombuffer(b"ACGT", np.uint8), hit.size)
        reads.append(np.delete(s, rng.integers(0, length,
                                               int(length * div / 8)))
                     .tobytes())
    return reads


def _round_inputs(g, seq, params, dev):
    from tsta_tpu_torch.ops import msa_poa
    prep, n, n_real, a, _, _ = msa_poa.prep_round(g, seq, params, 1 << 34)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    return t, n_real, len(order), W, order, preds


# the POA walks' forced plans (S, R, threads): R = 0 misses every move
POA_WALK_FORCED = ((8, 0, 64), (8, 16, 256), (16, 64, 96), (32, 128, 128),
                   (64, 256, 256), (128, 128, 128), (32, 0, 128))


def _deletion_reads():
    """Four ~700 bp reads, then two that lack ~300 bp of the middle: the
    first makes an edge that skips the deleted rows, the second's walk
    takes it (tests/test_torch_poa_walk.py's graph)."""
    reads = _reads(3, 4, 700)
    cut = [bytearray(reads[1]), bytearray(reads[2])]
    del cut[0][200:500]
    del cut[1][205:505]
    return reads + [bytes(c) for c in cut]


def _staircase(g, k, m=None):
    """Raise the in-degree of the node at topo position ``m`` (default the
    middle) of ``g`` (either package's PoaGraph) to ``k``: edges into it
    from the nodes before it in topo order, nearest first, as reads with
    deletions of every length up to ~k ending at one base would make
    them.  The largest pred distance, and so the ring's W, stays about k.
    Returns the node."""
    order = list(g.topo)
    m = len(order) // 2 if m is None else m
    v = int(order[m])
    have = {int(p) for p in g._preds[v, :int(g._ndeg[v])]}
    q = 1
    while int(g._ndeg[v]) < k:
        u = int(order[m - q])
        q += 1
        if u not in have:
            g.add_edge(u, v)
            have.add(u)
    g.toposort()
    return v


def _walk_plans_match_replay(cuda, words, preds, best, n_real, want,
                             maxdist, forced=POA_WALK_FORCED):
    """``poa_walk.cu`` at its plan and each ``forced`` (S, R, threads) on
    the card: the align map equals ``want`` and the counters (moves, pred
    moves, misses, phases) equal ``poa_walk_staged_plain``'s replay of
    the same plan on the CPU plane ``words``.  Returns the plan's
    counters."""
    from tsta_tpu_torch.ops import msa_poa
    wd, pd, bd = words.to(cuda), preds.to(cuda), best.to(cuda)
    plan = None
    for S, R, threads in ((None, None, None),) + tuple(forced):
        counts = torch.zeros((4,), dtype=torch.int32, device=cuda)
        got = msa_poa.poa_walk(wd, pd, bd, n_real, maxdist=maxdist, S=S,
                               R=R, threads=threads, counts=counts)
        S, R, _ = msa_poa.poa_walk_plan(maxdist, preds.shape[1], S=S, R=R,
                                        threads=threads)
        align, out, rc = msa_poa.poa_walk_staged_plain(
            words, preds, int(best), n_real - 1, 0, S, R)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want) and torch.equal(align, want)
        assert counts.tolist() == rc.tolist(), (S, R, threads)
        if R == 0:
            assert counts[2] == counts[0] > 0
        plan = plan or counts.tolist()
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("seed,length", [(0, 300), (1, 1500)])
def test_poa_dp_and_walk_kernels_match_plain(cuda, seed, length):
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    AP = AlignParams()
    reads = _reads(seed, 5, length)
    g = PoaGraph.from_sequence(reads[0], len(reads))
    multi = 0
    for sno in range(1, len(reads)):
        (tk, n_real, n_nodes, W, order, preds) = _round_inputs(
            g, reads[sno], AP, cuda)
        tc = [x.cpu() for x in tk]
        multi += int((tc[1].sum(0) > 1).sum())
        n0 = dict(_kernels.launches)
        kw, ks = msa_poa.poa_dp(*tk, n_real, n_nodes, AP, W)
        pw, ps = msa_poa.poa_dp(*tc, n_real, n_nodes, AP, W)
        torch.cuda.synchronize()
        assert _kernels.launches["poa_dp"] == n0["poa_dp"] + 1
        assert torch.equal(kw.cpu()[:n_nodes], pw[:n_nodes])
        assert torch.equal(ks.cpu(), ps)
        N = tc[0].shape[1]
        mask = torch.from_numpy(msa_poa.sink_mask(g, order, N))
        best = msa_poa.best_sink(ps, mask)
        pd = torch.from_numpy(preds)
        kal = msa_poa.poa_walk(kw, pd.to(cuda), best.to(cuda), n_real)
        torch.cuda.synchronize()
        assert _kernels.launches["poa_walk"] == n0["poa_walk"] + 1
        pal = msa_poa.walk_plain(pw, pd, best, n_real)
        assert torch.equal(kal.cpu(), pal)
        _walk_plans_match_replay(cuda, pw, pd, best, n_real, pal,
                                 msa_poa.max_pred_distance(preds))
        host = msa_poa.pack_round(ps, pal, best).numpy()
        msa_native._finish_round(g, reads[sno], sno, order, host, [], [],
                                 [])
    assert multi > 0


@pytest.mark.cuda
def test_poa_walk_kernel_takes_the_long_jump(cuda):
    """A graph whose last read takes an edge that skips ~300 rows: each
    round's walk on the card at its plan and at every forced plan equals
    the plain walk, with the replay's counters, and the last round misses
    at its plan (the jump is past its window), the earlier rounds do
    not; the progressive run through the kernels equals the CPU's."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    reads = _deletion_reads()
    g = PoaGraph.from_sequence(reads[0], len(reads))
    misses = []
    for sno in range(1, len(reads)):
        tk, n_real, n_nodes, W, order, preds = _round_inputs(
            g, reads[sno], AP, cpu)
        pw, ps = msa_poa.poa_dp(*tk, n_real, n_nodes, AP, W)
        best = msa_poa.best_sink(ps, torch.from_numpy(
            msa_poa.sink_mask(g, order, tk[0].shape[1])))
        pd = torch.from_numpy(preds)
        pal = msa_poa.walk_plain(pw, pd, best, n_real)
        plan = _walk_plans_match_replay(cuda, pw, pd, best, n_real, pal,
                                        msa_poa.max_pred_distance(preds))
        misses.append(plan[2])
        msa_native._finish_round(g, reads[sno], sno, order,
                                 msa_poa.pack_round(ps, pal, best).numpy(),
                                 [], [], [])
    assert misses[-1] > 0 and not any(misses[:3])
    want = msa_native.align_seqs(reads, AP, device="cpu")
    n0 = _kernels.launches["poa_walk"]
    assert msa_native.align_seqs(reads, AP, kernel="cuda",
                                 device=cuda) == want
    assert _kernels.launches["poa_walk"] == n0 + len(reads) - 1


@pytest.mark.cuda
def test_poa_walks_refuse_shapes_the_copies_cannot_take(cuda):
    """The window ring's 16-byte copies: a plane width not a multiple of
    8, a pred table not a multiple of 4 ints, an unaligned plane and a
    plan that does not fit raise ValueError before any launch."""
    i32 = torch.int32
    best = torch.zeros((1,), dtype=i32, device=cuda)
    preds = torch.zeros((128, 4), dtype=i32, device=cuda)
    n0 = dict(_kernels.launches)
    for words, pr in ((torch.zeros((128, 132), dtype=torch.int16,
                                   device=cuda), preds),
                      (torch.zeros((128 * 128 + 1,), dtype=torch.int16,
                                   device=cuda)[1:].view(128, 128), preds),
                      (torch.zeros((3, 128), dtype=torch.int16,
                                   device=cuda), preds[:3, :1].contiguous())):
        n = words.shape[1]
        with pytest.raises(ValueError, match="16-byte"):
            _kernels.poa_walk(words, pr, best, 5,
                              torch.full((n,), -1, dtype=i32, device=cuda))
        with pytest.raises(ValueError, match="16-byte"):
            _kernels.poa_walk_bounded(
                words, pr, 0, 5, 0, 0, 0,
                torch.full((n,), -1, dtype=i32, device=cuda),
                torch.zeros((3,), dtype=i32, device=cuda))
    words = torch.zeros((128, 128), dtype=torch.int16, device=cuda)
    for kw in ({"S": 12}, {"R": 10_000}, {"threads": 320}):
        with pytest.raises(ValueError):
            _kernels.poa_walk(words, preds, best, 5,
                              torch.full((128,), -1, dtype=i32, device=cuda),
                              **kw)
    assert dict(_kernels.launches) == n0


@pytest.mark.cuda
def test_msa_kernel_route_matches_cpu(cuda):
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_native
    sets = [_reads(10 + k, 4, 400 + 150 * k) for k in range(3)]
    want = [msa_native.align_seqs(s, AlignParams(), device="cpu")
            for s in sets]
    p0 = msa_native.plain_rounds
    n0 = _kernels.launches["poa_dp"]
    got = [msa_native.align_seqs(s, AlignParams(), kernel="cuda",
                                 device=cuda) for s in sets]
    assert _kernels.launches["poa_dp"] == n0 + 9
    fleet = msa_native.align_seqs_many(sets, AlignParams(), device=cuda)
    plain = msa_native.align_seqs(sets[0], AlignParams(), kernel="plain",
                                  device=cuda)
    assert msa_native.plain_rounds == p0
    for w, g, f in zip(want, got, fleet):
        assert g == w and f == w
    assert plain == want[0]


# the wide walks' forced plans (S, R, threads): two buffers of 4-byte
# words, R = 0 misses every move
POA_WALK_FORCED_WIDE = ((8, 0, 64), (8, 16, 256), (16, 64, 96),
                        (32, 128, 128), (64, 207, 256), (32, 0, 128))
# in-degrees of the wide forms' card tests: the first wide table (128
# entries), its last index, a 256-entry table, and 1,024 entries
WIDE_IN = (65, 128, 129, 1000)


def _wide_graph(k, seed=1, rounds=2, at=1200, length=2000):
    """A grown graph: read 0's chain (``length`` bp) with node ``at``'s
    in-degree raised to ``k`` by a staircase, then ``rounds`` rounds of
    mutated copies through the plain versions; and the next read, a copy
    of read 0 with ~10% substitutions and a deletion that ends at node
    ``at``, so its walk enters that node from its pred at table index
    min(k - 1, 600)."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    reads = _reads(seed, rounds + 1, length)
    g = PoaGraph.from_sequence(reads[0], len(reads) + 1)
    _staircase(g, k, at)
    for sno in range(1, rounds + 1):
        packed, order, _ = msa_poa.run_round(g, reads[sno], AP, cpu, "plain",
                                             1 << 34)
        msa_native._finish_round(g, reads[sno], sno, order, packed.numpy(),
                                 [], [], [])
    assert g.max_in_degree() >= k
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s = np.frombuffer(reads[0], np.uint8).copy()
    s[rng.integers(0, len(s), 200)] = rng.choice(acgt, 200)
    d = min(k - 1, 600)
    return g, np.concatenate([s[:at - d], s[at:]]).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("k", WIDE_IN)
def test_wide_poa_dp_and_walks_match_plain(cuda, k):
    """The wide forms on a grown 2 kbp graph with a staircase of in-degree
    k: ``poa_dp.cu``'s single call at its plan and at forced D = 2, 3, 5
    (T = 16, 1, 32; 5 shards also on 2 blocks), every real word and score
    equal to the plain version's 13-bit words; the walk at its plan and at
    forced plans, R = 0 among them, its align map equal to the plain
    walk's and its counters to the wide replay's; and the bounded walk
    from the sink over the whole plane as one cell, equal to the plain
    bounded walk."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    g, seq = _wide_graph(k)
    tk, n_real, n_nodes, W, order, preds = _round_inputs(g, seq, AP, cpu)
    assert tk[0].shape[0] > 64
    pw, ps = msa_poa.poa_dp(*tk, n_real, n_nodes, AP, W)
    assert pw.dtype == torch.int32
    td = [x.to(cuda) for x in tk]
    lists = [torch.from_numpy(x).to(cuda)
             for x in msa_poa.pred_lists(preds, tk[1].numpy())]
    n0 = dict(_kernels.launches)
    for D, T, G in ((None, None, None), (2, 16, None), (3, 1, None),
                    (5, 32, None), (5, 16, 2)):
        kw, ks = msa_poa.poa_dp(*td, n_real, n_nodes, AP, W, lists=lists,
                                D=D, T=T, G=G)
        torch.cuda.synchronize()
        assert kw.dtype == torch.int32
        assert torch.equal(kw.cpu()[:n_nodes], pw[:n_nodes]), (D, T, G)
        assert torch.equal(ks.cpu(), ps), (D, T, G)
    assert _kernels.launches["poa_dp_wide"] == n0["poa_dp_wide"] + 5
    assert _kernels.launches["poa_dp"] == n0["poa_dp"]
    N = tk[0].shape[1]
    best = msa_poa.best_sink(ps, torch.from_numpy(
        msa_poa.sink_mask(g, order, N)))
    pd = torch.from_numpy(preds)
    want = msa_poa.walk_plain(pw, pd, best, n_real)
    maxdist = msa_poa.max_pred_distance(preds)
    _walk_plans_match_replay(cuda, pw, pd, best, n_real, want, maxdist,
                             POA_WALK_FORCED_WIDE)
    assert (_kernels.launches["poa_walk_wide"]
            == n0["poa_walk_wide"] + 1 + len(POA_WALK_FORCED_WIDE))
    assert _kernels.launches["poa_walk"] == n0["poa_walk"]
    al_p = torch.full((pw.shape[1],), -1, dtype=torch.int32)
    out_p = msa_poa.walk_bounded_plain(pw, pd, int(best), n_real - 1, 0, 0,
                                       0, al_p)
    al_k = torch.full((pw.shape[1],), -1, dtype=torch.int32, device=cuda)
    counts = torch.zeros((4,), dtype=torch.int32, device=cuda)
    out_k = msa_poa.poa_walk_bounded(pw.to(cuda), pd.to(cuda), int(best),
                                     n_real - 1, 0, 0, 0, al_k,
                                     maxdist=maxdist, counts=counts)
    S, R, _ = msa_poa.poa_walk_plan(maxdist, pd.shape[1])
    _, out_r, rc = msa_poa.poa_walk_staged_plain(pw, pd, int(best),
                                                 n_real - 1, 0, S, R)
    torch.cuda.synchronize()
    assert torch.equal(al_k.cpu(), al_p) and torch.equal(al_p, want)
    assert out_k.tolist() == out_p.tolist() == out_r.tolist()
    assert counts.tolist() == rc.tolist()
    assert (_kernels.launches["poa_walk_bounded_wide"]
            == n0["poa_walk_bounded_wide"] + 1)


@pytest.mark.cuda
def test_wide_walks_take_a_table_not_a_power_of_two(cuda):
    """The wide walks read a pred index from its 13-bit field whatever the
    table's width: the in-degree 129 round's (N, 256) table padded to 260
    columns walks as the 256-wide one, at the plan and with R = 0, its
    counters equal to the replay's.  The wide DP without its pred lists,
    a wide table not a multiple of 4 ints a row and a 16-bit one not a
    power of two are refused before any launch."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    g, seq = _wide_graph(129)
    tk, n_real, n_nodes, W, order, preds = _round_inputs(g, seq, AP, cpu)
    pw, ps = msa_poa.poa_dp(*tk, n_real, n_nodes, AP, W)
    N = tk[0].shape[1]
    best = msa_poa.best_sink(ps, torch.from_numpy(
        msa_poa.sink_mask(g, order, N)))
    pd = torch.from_numpy(preds)
    want = msa_poa.walk_plain(pw, pd, best, n_real)
    wide = torch.nn.functional.pad(pd, (0, 4))
    maxdist = msa_poa.max_pred_distance(preds)
    n0 = _kernels.launches["poa_walk_wide"]
    _walk_plans_match_replay(cuda, pw, wide, best, n_real, want, maxdist,
                             ((32, 0, 128),))
    assert _kernels.launches["poa_walk_wide"] == n0 + 2
    td = [x.to(cuda) for x in tk]
    with pytest.raises(ValueError, match="pred lists"):
        msa_poa.poa_dp(*td, n_real, n_nodes, AP, W)
    i32 = torch.int32
    align = torch.full((pw.shape[1],), -1, dtype=i32, device=cuda)
    for words, pr in ((pw.to(cuda), torch.zeros((N, 66), dtype=i32,
                                                device=cuda)),
                      (pw.to(cuda).to(torch.int16),
                       torch.zeros((N, 12), dtype=i32, device=cuda))):
        with pytest.raises(ValueError, match="power of two"):
            _kernels.poa_walk(words, pr, best.to(cuda), n_real, align)
        with pytest.raises(ValueError, match="power of two"):
            _kernels.poa_walk_bounded(words, pr, 0, 5, 0, 0, 0, align,
                                      torch.zeros((3,), dtype=i32,
                                                  device=cuda))
    assert _kernels.launches["poa_walk_wide"] == n0 + 2


@pytest.mark.cuda
def test_wide_chunked_round_on_card_matches_cpu(cuda):
    """A wide round (in-degree 129) the plan chunks at a small budget, on
    the card: forward chunks, window remats and bounded walks in their
    wide forms, the packed result equal to the CPU's plain chunked round
    and to the unchunked one; no 16-bit launch, no plain round."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    g, seq = _wide_graph(129)
    seq += _reads(9, 1, 160)[0]   # 2,048 columns: two column windows
    budget = 48_000_000   # 3 chunks of 1,024 rows at 4 bytes a word
    _, _, _, _, NC, NWIN = msa_poa.prep_round(g, seq, AP, budget)
    assert (NC, NWIN) == (1024, 2)
    want, order, plain = msa_poa.run_round(g, seq, AP, cpu, "auto", budget)
    whole, _, _ = msa_poa.run_round(g, seq, AP, cpu, "auto", 1 << 34)
    assert plain and torch.equal(want, whole)
    n0 = dict(_kernels.launches)
    got, _, plain = msa_poa.run_round(g, seq, AP, cuda, "cuda", budget)
    torch.cuda.synchronize()
    assert not plain and torch.equal(got.cpu(), want)
    moved = {k: _kernels.launches[k] - n0[k] for k in _kernels.KERNELS
             if _kernels.launches[k] != n0[k]}
    assert set(moved) == {"poa_dp_chunk_wide", "poa_dp_window_wide",
                          "poa_walk_bounded_wide"}, moved


@pytest.mark.cuda
def test_wide_route_on_card_matches_cpu(cuda, monkeypatch):
    """Progressive runs on graphs past 64 preds (a staircase of 65 from
    round 1 on) through the kernels' wide forms, ``kernel="cuda"`` and
    ``"auto"`` and the fleet, equal to the CPU's plain runs; no plain
    round on the card."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native
    orig = PoaGraph.from_sequence

    def stair(seq, n_seq):
        g = orig(seq, n_seq)
        _staircase(g, 65)
        return g

    monkeypatch.setattr(PoaGraph, "from_sequence", staticmethod(stair))
    reads = _reads(3, 4, 600)
    want = msa_native.align_seqs(reads, AlignParams(), device="cpu")
    p0 = msa_native.plain_rounds
    n0 = dict(_kernels.launches)
    for kernel in ("cuda", "auto"):
        got = msa_native.align_seqs(reads, AlignParams(), kernel=kernel,
                                    device=cuda)
        assert got == want
    fleet = msa_native.align_seqs_many([reads, reads[:2]], AlignParams(),
                                       device=cuda)
    assert fleet[0] == want
    assert msa_native.plain_rounds == p0
    assert _kernels.launches["poa_dp_wide"] == n0["poa_dp_wide"] + 3 * 3 + 1
    assert _kernels.launches["poa_dp"] == n0["poa_dp"]


@pytest.mark.cuda
def test_poa_wrappers_refuse_bad_tensors(cuda):
    i32 = torch.int32
    predsT = torch.zeros((2, 128), dtype=i32, device=cuda)
    bases = torch.zeros((128,), dtype=i32, device=cuda)
    fills = torch.zeros((4, 128), dtype=i32, device=cuda)
    a = torch.zeros((128,), dtype=torch.uint8, device=cuda)
    words = torch.zeros((128, 128), dtype=torch.int16, device=cuda)
    scores = torch.zeros((128,), dtype=i32, device=cuda)
    with pytest.raises(ValueError):
        _kernels.poa_dp(predsT, predsT, bases, fills, a.cpu(), 5, 10,
                        P0, 2, words, scores)
    with pytest.raises(ValueError):
        _kernels.poa_dp(predsT, predsT, bases, fills, a, 5, 10, P0, 2,
                        words.to(i32), scores)
    with pytest.raises(ValueError):
        _kernels.poa_dp(torch.zeros((128, 128), dtype=i32, device=cuda),
                        torch.zeros((128, 128), dtype=i32, device=cuda),
                        bases, fills, a, 5, 10, P0, 2, words, scores)
    with pytest.raises(ValueError):
        _kernels.poa_walk(words, predsT.T.contiguous(),
                          torch.zeros((1,), dtype=torch.int64, device=cuda),
                          5, torch.full((128,), -1, dtype=i32, device=cuda))


@pytest.mark.cuda
def test_poa_chunk_window_and_bounded_walk_kernels_match_plain(cuda):
    """A 2,048-column round cut into 4 chunks of 512 rows with 2 column
    windows: each forward chunk (scores, ring out, checkpoints), then the
    window remat of every cell on the round's path (words, ring out) and
    the bounded walk through it (align entries, exit state) on the card
    equal their plain versions on the CPU."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_chunked, msa_poa
    AP = AlignParams()
    reads = _reads(41, 2, 2000, 0.08)
    g = PoaGraph.from_sequence(reads[0], 2)
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(g, reads[1], AP,
                                                      2 ** 30 // 100)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    assert (NC, NWIN, N % NC) == (512, 2, 0)
    CW = n // NWIN
    devs = {"cpu": torch.device("cpu"), "cuda": cuda}
    tabs = {d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dv)
                for k, v in (("predsT", predsT), ("pmaskT", pmaskT),
                             ("bases", bases.reshape(N)), ("fills", fills),
                             ("preds", preds), ("a", a))}
            for d, dv in devs.items()}
    rings = {d: msa_poa.new_ring(W, n, dv) for d, dv in devs.items()}
    cks = {d: torch.zeros((N, NWIN, 3), dtype=torch.int32, device=dv)
           for d, dv in devs.items()}
    n0 = dict(_kernels.launches)

    def rows(c):
        return min(max(len(order) - c * NC, 0), NC)

    def chunk(t, c):
        return [t["predsT"][:, c * NC:(c + 1) * NC].contiguous(),
                t["pmaskT"][:, c * NC:(c + 1) * NC].contiguous(),
                t["bases"][c * NC:(c + 1) * NC]]

    snaps, scores = [], []
    for c in range(N // NC):
        snaps.append({d: r.clone() for d, r in rings.items()})
        sc = {}
        for d, t in tabs.items():
            _, sc[d] = msa_poa.poa_dp(
                *chunk(t, c), t["fills"][:, c * NC:(c + 1) * NC].contiguous(),
                t["a"], n_real, rows(c), AP, W, ring=rings[d],
                chunk_base=c * NC, ckpt=cks[d][c * NC:(c + 1) * NC],
                with_words=False)
        torch.cuda.synchronize()
        assert torch.equal(sc["cuda"].cpu(), sc["cpu"])
        assert torch.equal(rings["cuda"].cpu(), rings["cpu"])
        scores.append(sc["cpu"])
    assert torch.equal(cks["cuda"].cpu(), cks["cpu"])
    assert _kernels.launches["poa_dp_chunk"] == n0["poa_dp_chunk"] + N // NC

    mask = torch.from_numpy(msa_poa.sink_mask(g, order, N))
    row = int(msa_poa.best_sink(torch.cat(scores), mask))
    j, state = n_real - 1, 0
    aligns = {d: torch.full((n,), -1, dtype=torch.int32, device=dv)
              for d, dv in devs.items()}
    hb = {d: ck[:, :, 0].contiguous() for d, ck in cks.items()}
    cells = 0
    while row >= 0 and j >= 0:
        c, w = row // NC, min(j // CW, NWIN - 1)
        col0, sl = w * CW, slice(c * NC, (c + 1) * NC)
        out, words = {}, {}
        for d, t in tabs.items():
            pt, pm, bs = chunk(t, c)
            fl = (msa_chunked.win_fills(cks[d][sl], hb[d], pt, pm, w - 1,
                                        col0, AP.gap_extend, AP.gap_open)
                  if w else t["fills"][:, sl].contiguous())
            ring = msa_chunked.ring_window(snaps[c][d], n, col0, CW)
            words[d], _ = msa_poa.poa_dp(pt, pm, bs, fl,
                                         t["a"][col0:col0 + CW], n_real,
                                         rows(c), AP, W, ring=ring,
                                         chunk_base=c * NC, col0=col0)
            align_in = aligns[d].clone()
            out[d] = msa_poa.poa_walk_bounded(words[d], t["preds"][sl], row,
                                              j, state, c * NC, col0,
                                              aligns[d])
        torch.cuda.synchronize()
        assert torch.equal(words["cuda"].cpu(), words["cpu"])
        assert out["cuda"].tolist() == out["cpu"].tolist()
        assert torch.equal(aligns["cuda"].cpu(), aligns["cpu"])
        # each forced plan from the same entry, with the replay's counters
        for S, R, threads in POA_WALK_FORCED:
            counts = torch.zeros((4,), dtype=torch.int32, device=cuda)
            al = align_in.clone()
            got = msa_poa.poa_walk_bounded(
                words["cuda"], tabs["cuda"]["preds"][sl], row, j, state,
                c * NC, col0, al, S=S, R=R, threads=threads, counts=counts)
            wa, wo, wc = msa_poa.poa_walk_staged_plain(
                words["cpu"], tabs["cpu"]["preds"][sl], row, j, state, S, R,
                base=c * NC, col0=col0, align=align_in.cpu().clone())
            torch.cuda.synchronize()
            assert got.tolist() == wo.tolist() == out["cpu"].tolist()
            assert torch.equal(al.cpu(), wa) and torch.equal(wa,
                                                             aligns["cpu"])
            assert counts.tolist() == wc.tolist(), (S, R, threads)
        row, j, state = out["cpu"].tolist()
        cells += 1
    assert cells >= 4 and (aligns["cpu"] >= 0).sum() > 1900
    assert _kernels.launches["poa_dp_window"] == n0["poa_dp_window"] + cells
    assert (_kernels.launches["poa_walk_bounded"]
            == n0["poa_walk_bounded"] + cells * (1 + len(POA_WALK_FORCED)))


@pytest.mark.cuda
def test_chunked_kernel_route_matches_cpu(cuda):
    """Progressive runs whose rounds the plan chunks (a small explicit
    budget), NWIN = 0 and NWIN = 2, on the card through the kernels equal
    the CPU's plain runs; the fleet too."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_native
    AP = AlignParams()
    cases = [(_reads(29, 3, 1400, 0.15), 6_000_000),
             (_reads(41, 3, 2000, 0.08), 2 ** 30 // 100)]
    p0 = msa_native.plain_rounds
    for reads, budget in cases:
        want = msa_native.align_seqs(reads, AP, device="cpu", budget=budget)
        n0 = dict(_kernels.launches)
        got = msa_native.align_seqs(reads, AP, kernel="cuda", device=cuda,
                                    budget=budget)
        assert got == want
        for k in ("poa_dp_chunk", "poa_dp_window", "poa_walk_bounded"):
            assert _kernels.launches[k] > n0[k], k
        fleet = msa_native.align_seqs_many([reads, reads[:2]], AP,
                                           device=cuda, budget=budget)
        assert fleet[0] == want
    assert msa_native.plain_rounds == p0


@pytest.mark.cuda
def test_chunk_wrappers_refuse_bad_tensors(cuda):
    from tsta_tpu_torch.ops import msa_poa
    i32 = torch.int32
    predsT = torch.zeros((2, 128), dtype=i32, device=cuda)
    bases = torch.zeros((128,), dtype=i32, device=cuda)
    fills = torch.zeros((4, 128), dtype=i32, device=cuda)
    a = torch.zeros((2048,), dtype=torch.uint8, device=cuda)
    words = torch.zeros((128, 2048), dtype=torch.int16, device=cuda)
    scores = torch.zeros((128,), dtype=i32, device=cuda)
    ring = msa_poa.new_ring(2, 2048, cuda)
    ckpt = torch.zeros((128, 2, 3), dtype=i32, device=cuda)
    with pytest.raises(ValueError):   # ring laid out for another width
        _kernels.poa_dp(predsT, predsT, bases, fills,
                        torch.zeros((8192,), dtype=torch.uint8, device=cuda),
                        5, 10, P0, 2,
                        torch.zeros((128, 8192), dtype=torch.int16,
                                    device=cuda), scores, ring=ring)
    with pytest.raises(ValueError):   # checkpoint windows of no columns
        _kernels.poa_dp(predsT, predsT, bases, fills, a, 5, 10, P0, 2,
                        words, scores, ring=ring, ckpt=ckpt, cw=0)
    with pytest.raises(ValueError):   # a single call takes no checkpoints
        _kernels.poa_dp(predsT, predsT, bases, fills, a, 5, 10, P0, 2,
                        words, scores, ckpt=ckpt)
    out = torch.zeros((3,), dtype=i32, device=cuda)
    align = torch.full((1024,), -1, dtype=i32, device=cuda)
    with pytest.raises(ValueError):   # the cell reaches past the round
        _kernels.poa_walk_bounded(words, predsT.T.contiguous(), 5, 5, 0, 0,
                                  0, align, out)
    with pytest.raises(ValueError):
        _kernels.poa_walk_bounded(words, predsT.T.contiguous(), 5, 5, 3, 0,
                                  0, torch.full((2048,), -1, dtype=i32,
                                                device=cuda), out)


@pytest.fixture(scope="module")
def grown_2k():
    """Round 3 of 4 seeded 2 kbp reads (2,318 nodes, 345 with more than
    one pred, n = 2,048) and its plain version on the CPU in all three
    uses: the single call; the round cut into chunks of 512 rows with 2
    column windows, each forward chunk from its entry ring (scores, ring
    out, checkpoints); and every (chunk, window) cell's remat (words,
    ring out)."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_chunked, msa_native, msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    reads = _reads(7, 4, 2000, 0.12)
    g = PoaGraph.from_sequence(reads[0], 4)
    for sno in (1, 2):
        packed, order, _ = msa_poa.run_round(g, reads[sno], AP, cpu, "plain",
                                             1 << 34)
        msa_native._finish_round(g, reads[sno], sno, order, packed.numpy(),
                                 [], [], [])
    prep, n, n_real, a, _, _ = msa_poa.prep_round(g, reads[3], AP, 1 << 34)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    assert n == 2048 and (pmaskT.sum(0) > 1).sum() > 100
    tabs = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    single = msa_native.round_dp_plain(*tabs, n_real, len(order), AP, W)
    r = msa_chunked.ChunkedRound(g, prep, a, n_real, 512, 2, AP, cpu)
    ring = msa_poa.new_ring(W, n, cpu)
    ckpt = torch.zeros((r.nchunks * 512, 2, 3), dtype=torch.int32)
    snaps, forward = [], []
    for c in range(r.nchunks):
        snaps.append(ring.clone())
        args, kw = r.forward_call(c, ring, ckpt[c * 512:(c + 1) * 512])
        forward.append((msa_native.round_dp_plain(*args, **kw)[1],
                        ring.clone()))
    hb = ckpt[:, :, 0].contiguous()
    remats = {}
    for c in range(r.nchunks):
        for w in range(2):
            args, kw = r.remat_call(c, w, snaps[c], ckpt, hb)
            ring_in = kw["ring"].clone()
            remats[c, w] = (ring_in, msa_native.round_dp_plain(*args, **kw)[0],
                            kw["ring"])
    return {"g": g, "prep": prep, "a": a, "n": n, "n_real": n_real,
            "tabs": tabs, "single": single, "r": r, "snaps": snaps,
            "forward": forward, "ckpt": ckpt, "remats": remats, "AP": AP}


def _relaid(ring, n, D_from, D_to):
    """A ring of an n-column launch laid out for D_from shards, laid out
    for D_to (None: the plan's)."""
    from tsta_tpu_torch.ops import msa_poa
    dev = ring.device
    out = torch.zeros((ring.shape[0], 2, msa_poa.ring_width(n, D_to)),
                      dtype=ring.dtype, device=dev)
    out[:, :, msa_poa.ring_positions(n, dev, D_to)] = \
        ring[:, :, msa_poa.ring_positions(n, dev, D_from)]
    return out


@pytest.mark.cuda
def test_poa_bounded_walks_back_to_back(cuda, grown_2k):
    """2,000 bounded walks launched back to back on one stream, each into
    its own align row filled with -1: 250 seeded entries (row, column and
    state) in the cells of ``grown_2k``'s chunked round, each at 8 plans
    (the round's and ``POA_WALK_FORCED``'s).  Every exit state and align
    row equals the plain walk from that entry, and each entry's moves and
    pred moves are the same at every plan: a block whose threads left the
    ring at different phases would show here (``compute-sanitizer`` does
    not run on the card's machine)."""
    from tsta_tpu_torch.ops import msa_poa
    r, n, remats = grown_2k["r"], grown_2k["n"], grown_2k["remats"]
    rng = np.random.default_rng(20261017)
    plans = ((None, None, None),) + POA_WALK_FORCED
    entries = []
    for _ in range(250):
        c = int(rng.integers(0, -(-r.n_nodes // r.NC)))
        w = int(rng.integers(0, 2))
        rows = r.rows(c)
        row = c * r.NC + int(rng.integers(max(rows - 300, 0), rows))
        j = w * r.CW + int(rng.integers(r.CW // 2, r.CW))
        entries.append((c, w, row, j, int(rng.integers(0, 3))))
    dev_words = {k: v[1].to(cuda) for k, v in remats.items()}
    dev_preds = {c: r.chunk_preds(c).to(cuda) for c in range(r.nchunks)}
    launches = len(entries) * len(plans)
    aligns = torch.full((launches, n), -1, dtype=torch.int32, device=cuda)
    outs = torch.zeros((launches, 3), dtype=torch.int32, device=cuda)
    counts = torch.zeros((launches, 4), dtype=torch.int32, device=cuda)
    n0 = _kernels.launches["poa_walk_bounded"]
    k = 0
    for c, w, row, j, state in entries:
        for S, R, threads in plans:
            _kernels.poa_walk_bounded(
                dev_words[c, w], dev_preds[c], row, j, state, c * r.NC,
                w * r.CW, aligns[k], outs[k], maxdist=r.maxdist, S=S, R=R,
                threads=threads, counts=counts[k])
            k += 1
    torch.cuda.synchronize()
    assert _kernels.launches["poa_walk_bounded"] == n0 + launches == n0 + 2000
    aligns, outs, counts = aligns.cpu(), outs.cpu(), counts.cpu()
    moved = 0
    for e, (c, w, row, j, state) in enumerate(entries):
        want = torch.full((n,), -1, dtype=torch.int32)
        st = msa_poa.walk_bounded_plain(remats[c, w][1], r.chunk_preds(c),
                                        row, j, state, c * r.NC, w * r.CW,
                                        want)
        sl = slice(e * len(plans), (e + 1) * len(plans))
        assert (outs[sl] == st).all(), (c, w, row, j, state)
        assert (aligns[sl] == want).all(), (c, w, row, j, state)
        assert (counts[sl, :2] == counts[sl.start, :2]).all()
        moved += int(counts[sl.start, 0] > 0)
    assert moved > 200


@pytest.mark.cuda
@pytest.mark.parametrize("D,T", [(1, None), (2, 1), (2, 16), (5, 32), (5, 1),
                                 (None, None)])
def test_poa_dp_sharded_kernel_matches_plain(cuda, grown_2k, D, T):
    """``poa_dp.cu`` at forced D shards (narrow: 412 columns a shard at D
    = 5, 52 threads of 256 busy) and packet heights T, one block a shard,
    in its three uses on a grown graph, equals the plain version."""
    _three_uses_match_plain(cuda, grown_2k, D, T, None)


@pytest.mark.cuda
@pytest.mark.parametrize("D,T,G", [(5, 16, 2), (5, 1, 1), (5, 32, 3),
                                   (2, 16, 1)])
def test_poa_dp_blocks_walk_their_shards(cuda, grown_2k, D, T, G):
    """D shards on G < D blocks, block g walking shards g, g + G, ... in
    turn (a cooperative launch for G >= 2, a plain one at G = 1), equal
    the plain version in the three uses."""
    _three_uses_match_plain(cuda, grown_2k, D, T, G)


def _three_uses_match_plain(cuda, grown_2k, D, T, blocks):
    """Words and scores of the single call; scores, ring (in the forced
    layout, compared column by column) and checkpoints of every forward
    chunk, the ring carried on the card; words and ring of every cell's
    window remat: each equal to the plain version, with the launches
    counted."""
    from tsta_tpu_torch.ops import msa_chunked, msa_poa
    G = grown_2k
    AP, n, W = G["AP"], G["n"], G["prep"][6]
    nn = len(G["prep"][7])
    n0 = dict(_kernels.launches)
    kw, ks = msa_poa.poa_dp(*[t.to(cuda) for t in G["tabs"]], G["n_real"], nn,
                            AP, W, D=D, T=T, G=blocks)
    torch.cuda.synchronize()
    assert torch.equal(kw.cpu()[:nn], G["single"][0][:nn])
    assert torch.equal(ks.cpu(), G["single"][1])

    r = msa_chunked.ChunkedRound(G["g"], G["prep"], G["a"], G["n_real"], 512,
                                 2, AP, cuda)
    ring = msa_poa.new_ring(W, n, cuda, D)
    ckpt = torch.zeros((r.nchunks * 512, 2, 3), dtype=torch.int32,
                       device=cuda)
    for c in range(r.nchunks):
        args, kw_ = r.forward_call(c, ring, ckpt[c * 512:(c + 1) * 512])
        _, sc = msa_poa.poa_dp(*args, **kw_, D=D, T=T, G=blocks)
        torch.cuda.synchronize()
        assert torch.equal(sc.cpu(), G["forward"][c][0]), c
        assert torch.equal(_relaid(ring, n, D, None).cpu(),
                           G["forward"][c][1]), c
    assert torch.equal(ckpt.cpu(), G["ckpt"])

    cw = n // 2
    cells = 0
    for (c, w), (ring_in, words, ring_out) in G["remats"].items():
        args, kw_ = r.remat_call(c, w, G["snaps"][c].to(cuda),
                                 G["ckpt"].to(cuda),
                                 G["ckpt"][:, :, 0].contiguous().to(cuda))
        kw_["ring"] = _relaid(ring_in.to(cuda), cw, None, D)
        got, _ = msa_poa.poa_dp(*args, **kw_, D=D, T=T, G=blocks)
        torch.cuda.synchronize()
        rows = r.rows(c)
        assert torch.equal(got.cpu()[:rows], words[:rows]), (c, w)
        assert torch.equal(_relaid(kw_["ring"], cw, D, None).cpu(),
                           ring_out), (c, w)
        cells += 1
    assert _kernels.launches["poa_dp"] == n0["poa_dp"] + 1
    assert _kernels.launches["poa_dp_chunk"] == n0["poa_dp_chunk"] + r.nchunks
    assert _kernels.launches["poa_dp_window"] == n0["poa_dp_window"] + cells


@pytest.mark.cuda
def test_poa_dp_layout_is_poa_plan(cuda):
    from tsta_tpu_torch.ops import msa_poa
    for n in (128, 768, 2048, 5120, 24576, 57344, 196608, 204800, 270336,
              270340, 1048576, 4194304):
        assert _kernels.poa_dp_layout(n) == msa_poa.poa_plan(n), n


@pytest.mark.cuda
def test_poa_dp_past_the_resident_limit_raises(cuda):
    """One block more than the card holds resident raises KernelError
    before launching; the limit itself launches, and so do one shard more
    than the limit on the default grid (a block walks two), both equal to
    the plain version."""
    from tsta_tpu_torch.ops import msa_native, msa_poa
    limit = _kernels.poa_dp_max_blocks(32, 8, cuda)   # 4 columns a shard
    assert limit >= 132
    i32 = torch.int32
    rng = np.random.default_rng(3)
    n, N = 4 * (limit + 1), 128
    predsT = torch.zeros((1, N), dtype=i32)
    pmaskT = torch.ones((1, N), dtype=i32)
    predsT[0, 1:] = torch.arange(1, N, dtype=i32)   # a chain
    bases = torch.from_numpy(rng.integers(65, 69, N).astype(np.int32))
    fills = torch.tensor([[-4 + k * -2 for k in range(N)], [0] * N,
                          [-8 + k * -2 for k in range(N)], [psa_scan.NEG] * N],
                         dtype=i32)
    a = torch.from_numpy(rng.integers(65, 69, n).astype(np.uint8))
    tabs = [t.to(cuda) for t in (predsT, pmaskT, bases, fills, a)]
    n0 = dict(_kernels.launches)
    with pytest.raises(_kernels.KernelError, match="co-resident"):
        msa_poa.poa_dp(*tabs, n, N, P0, 2 * N, D=limit + 1, T=32,
                       G=limit + 1)
    assert _kernels.launches == n0
    for cols in (4 * limit, n):
        words, scores = msa_poa.poa_dp(*tabs[:4], tabs[4][:cols], cols, N,
                                       P0, 2 * N, D=cols // 4, T=32)
        want = msa_native.round_dp_plain(predsT, pmaskT, bases, fills,
                                         a[:cols], cols, N, P0, 2 * N)
        torch.cuda.synchronize()
        assert torch.equal(words.cpu(), want[0]), cols
        assert torch.equal(scores.cpu(), want[1]), cols


@pytest.mark.cuda
def test_poa_dp_past_132_shards_matches_plain(cuda):
    """A round wider than 132 shards of 8,192 columns (1,081,344): a 1.1
    Mbp read against a graph grown from two 300 bp reads plans 135 shards
    at S = 32, more than the card's co-resident blocks, so blocks walk
    two.  The single call's words and scores, and the round as one
    forward chunk (scores, ring, checkpoints), equal the plain version."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    AP, cpu = AlignParams(), torch.device("cpu")
    reads = _reads(11, 2, 300)
    g = PoaGraph.from_sequence(reads[0], 3)
    packed, order, _ = msa_poa.run_round(g, reads[1], AP, cpu, "plain",
                                         1 << 34)
    msa_native._finish_round(g, reads[1], 1, order, packed.numpy(), [], [],
                             [])
    rng = np.random.default_rng(12)
    wide = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1_100_000).tobytes()
    prep, n, n_real, a, _, _ = msa_poa.prep_round(g, wide, AP, 1 << 40)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    assert n == 1105920 and (pmaskT.sum(0) > 1).sum() > 0
    D, C, S, T = msa_poa.poa_plan(n)
    assert (D, S) == (135, 32)
    assert _kernels.poa_dp_max_blocks(T, S, cuda) < D
    tabs = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    nn = len(order)
    kw, ks = msa_poa.poa_dp(*tabs, n_real, nn, AP, W)
    pw, ps = msa_native.round_dp_plain(*tabs, n_real, nn, AP, W)
    assert torch.equal(kw[:nn], pw[:nn]) and torch.equal(ks, ps)
    del kw, pw
    rings = [msa_poa.new_ring(W, n, cuda) for _ in range(2)]
    ckpts = [torch.zeros((N, 4, 3), dtype=torch.int32, device=cuda)
             for _ in range(2)]
    _, ks = msa_poa.poa_dp(*tabs, n_real, nn, AP, W, ring=rings[0],
                           ckpt=ckpts[0], with_words=False)
    _, ps = msa_native.round_dp_plain(*tabs, n_real, nn, AP, W,
                                      ring=rings[1], ckpt=ckpts[1],
                                      with_words=False)
    assert torch.equal(ks, ps) and torch.equal(*rings)
    assert torch.equal(*ckpts)


@pytest.mark.cuda
def test_cli_kernel_pallas_on_card(cuda, capsys):
    """``--kernel pallas`` is ``cuda``: the kernels on the card, the JAX
    CLI's result (maxsorce=378 on psa_small5)."""
    import os
    from tsta_tpu_torch import cli
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                     "psa_small5")
    n0 = sum(_kernels.launches.values())
    assert cli.main(["psa", "--notrace", "--device", "cuda", "--kernel",
                     "pallas", "-1", d + "/a.fa", "-2", d + "/b.fa"]) == 0
    assert capsys.readouterr().out.strip() == "maxsorce=378"
    assert sum(_kernels.launches.values()) > n0


def _long_pair(seed, n, m):
    """A seeded pair: b a mutated copy of a stretch of a (~8% substituted,
    ~2% deleted, then cut or padded to m), so the walk has gap runs."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = a[rng.integers(0, max(1, n - m)):].copy()
    hit = rng.integers(0, len(b), len(b) // 12)
    b[hit] = rng.integers(65, 69, hit.size)
    b = np.delete(b, rng.integers(0, len(b), len(b) // 50))
    b = np.concatenate([b, rng.integers(65, 69, m).astype(np.uint8)])[:m]
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(100, 700), (1500, 1300), (9000, 600)])
def test_psa_chunk_dp_and_bounded_walk_kernels_match_plain(cuda, n, m):
    """Every chunk of a pair cut into 256-row chunks, from the same entry
    frontier: the chunk DP on the card equals its plain version on
    the CPU (best, corner, every code, frontier out); then every chunk's
    bounded walk (moves, exit state) from the same entry."""
    from tsta_tpu_torch.ops import psa_chunked
    a, b = _long_pair(n + m, n, m)
    pairs = {d: psa_chunked.ChunkedPair(a, b, P0, 256, torch.device(d))
             for d in ("cpu", cuda)}
    pc, pk = pairs["cpu"], pairs[cuda]
    h, e = pc.entry()
    n0 = dict(_kernels.launches)
    last_rows, planes = [], []
    for c in range(pc.nchunks):
        want = psa_chunked.chunk_dp_plain(*pc.chunk_call(c, h, e))
        got = psa_chunked.chunk_dp(*pk.chunk_call(c, h.to(cuda), e.to(cuda)))
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert torch.equal(g.cpu(), w)
        _, _, codes, h, e = want
        last_rows.append(codes[-1].clone())
        planes.append(codes)
    assert (_kernels.launches["psa_dp_chunk"]
            == n0["psa_dp_chunk"] + pc.nchunks)
    L = pc.m_pad + pc.n_pad
    moves = {"cpu": torch.zeros(L, dtype=torch.int8),
             "cuda": torch.zeros(L, dtype=torch.int8, device=cuda)}
    state = (m - 1, n - 1, 0, 0)
    walks = 0
    while True:
        c = state[0] // pc.mc
        want = tb.walk_bounded(*pc.walk_call(c, planes[c], last_rows, *state,
                                             moves["cpu"]))
        got = tb.walk_bounded(*pk.walk_call(
            c, planes[c].to(cuda), [r.to(cuda) for r in last_rows], *state,
            moves["cuda"]))
        torch.cuda.synchronize()
        assert got.tolist() == want.tolist()
        assert torch.equal(moves["cuda"].cpu(), moves["cpu"])
        state = tuple(want.tolist())
        walks += 1
        if state[0] < 0:
            break
    assert state[:2] == (-1, -1) and walks >= pc.nchunks
    assert (_kernels.launches["psa_walk_bounded"]
            == n0["psa_walk_bounded"] + walks)


@pytest.mark.cuda
def test_chunked_traced_on_card_matches_cpu(cuda, monkeypatch):
    """The whole chunked traced path on the card (kernels only) equals the
    CPU's plain run and the unchunked traced path; a budget the pair
    does not fit routes it there from the traced batch."""
    from tsta_tpu_torch.ops import psa_chunked, psa_pallas
    a, b = _long_pair(7, 2100, 1900)
    want = psa_pallas.psa_align_traced_device(a, b, P0, device="cpu")
    assert psa_chunked.psa_align_traced_chunked(a, b, P0, mc=512,
                                                device="cpu") == want
    n0 = dict(_kernels.launches)
    got = psa_chunked.psa_align_traced_chunked(a, b, P0, mc=512, device=cuda)
    assert got == want
    clock = psa_chunked.last_clock
    assert (_kernels.launches["psa_dp_chunk"] - n0["psa_dp_chunk"]
            == clock.chunks + clock.remats)
    assert (_kernels.launches["psa_walk_bounded"] - n0["psa_walk_bounded"]
            == clock.walks >= clock.chunks)
    assert _kernels.launches["psa_dp_traced"] == n0["psa_dp_traced"]
    small = (a[:300], b[:280])
    monkeypatch.setattr(psa_diff, "device_budget",
                        lambda dev: 2 * 2048 * 2304 - 1)
    res = psa_diff.psa_align_batch_traced_packed([(a, b), small], P0,
                                                 device=cuda)
    assert res[0] == want
    assert res[1] == psa_pallas.psa_align_traced_device(*small, P0,
                                                        device="cpu")
    assert _kernels.launches["psa_dp_traced"] == n0["psa_dp_traced"] + 1


@pytest.mark.cuda
def test_psa_chunk_wrappers_refuse_bad_tensors(cuda):
    i32 = torch.int32
    a = torch.zeros((256,), dtype=torch.uint8, device=cuda)
    b = torch.zeros((64,), dtype=torch.uint8, device=cuda)
    lens = torch.tensor([200, 60], dtype=i32, device=cuda)
    h = torch.zeros((256,), dtype=i32, device=cuda)
    one = torch.zeros((1,), dtype=i32, device=cuda)
    plane = torch.zeros((64, 256), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):   # a frontier of another width
        _kernels.psa_dp_chunk(a, b, lens, 0, P0, h[:128], h, h.clone(),
                              h.clone(), one, one.clone(), plane)
    with pytest.raises(ValueError):   # a plane of another row count
        _kernels.psa_dp_chunk(a, b, lens, 0, P0, h, h, h.clone(), h.clone(),
                              one, one.clone(), plane[:32])
    moves = torch.zeros((400,), dtype=torch.int8, device=cuda)
    out = torch.zeros((4,), dtype=i32, device=cuda)
    with pytest.raises(ValueError):   # the entry row is not in the chunk
        _kernels.psa_walk_bounded(plane, a, 64, 10, 10, 0, 0, moves, out)
    with pytest.raises(ValueError):   # too few moves for the walk left
        _kernels.psa_walk_bounded(plane, a, 0, 63, 255, 100, 0, moves, out)


def _chunk_cases(a, b, params, mc, dev):
    """Each chunk's DP arguments on ``dev`` and the plain version's
    outputs on the CPU, every chunk entered from the plain frontier."""
    from tsta_tpu_torch.ops import psa_chunked
    pc = psa_chunked.ChunkedPair(a, b, params, mc, torch.device("cpu"))
    pk = psa_chunked.ChunkedPair(a, b, params, mc, dev)
    h, e = pc.entry()
    for c in range(pc.nchunks):
        want = psa_chunked.chunk_dp_plain(*pc.chunk_call(c, h, e))
        yield pk.chunk_call(c, h.to(dev), e.to(dev)), want
        h, e = want[3], want[4]


def _chunk_launch(args, D=None, T=None):
    a, b, lens, row_base, h, e, params = args
    rows, n_pad = b.shape[0], a.shape[0]
    dev = a.device
    out = [torch.empty((1,), dtype=torch.int32, device=dev) for _ in range(2)]
    plane = torch.empty((rows, n_pad), dtype=torch.uint8, device=dev)
    h_out, e_out = torch.empty_like(h), torch.empty_like(e)
    plan = _kernels.psa_dp_chunk(a, b, lens, row_base, params, h, e, h_out,
                                 e_out, *out, plane, D=D, T=T)
    return plan, (out[0], out[1], plane, h_out, e_out)


@pytest.mark.cuda
@pytest.mark.parametrize("params", [P0, (0, -1, -1, 0)])
@pytest.mark.parametrize("D,T", [(1, None), (2, None), (7, 48), (None, None)])
def test_psa_dp_chunk_kernel_matches_plain(cuda, params, D, T):
    """psa_dp_traced.cu's chunk launch at D = 1, 2, 7 (T = 48: row blocks
    cut short) and the card's plan, against the plain version in every
    output: a pair of 9,000 columns (n_pad 9,088) cut into chunks of 256
    rows, so chunk 0 starts at row 0, chunk 1 at row 256 without row m -
    1, chunk 2 holds it; the first and the last shard in every D > 1."""
    from tsta_tpu_torch.ops import psa_chunked
    a, b = _long_pair(11, 9000, 700)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want_d = D or psa_chunked.chunk_plan(9088, sms)[0]
    n0 = _kernels.launches["psa_dp_chunk"]
    corners = []
    for k, (args, want) in enumerate(_chunk_cases(a, b, params, 256, cuda)):
        plan, got = _chunk_launch(args, D, T)
        torch.cuda.synchronize()
        assert plan[0] == want_d and plan[2] == (T or psa_diff.TRACED_T)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        corners.append(int(want[1]))
    assert _kernels.launches["psa_dp_chunk"] == n0 + 3
    assert corners[:2] == [psa_scan.NEG] * 2 and corners[2] > psa_scan.NEG


@pytest.mark.cuda
def test_psa_dp_chunk_wide_strips_take_the_global_frontier(cuda):
    """One shard of 25,600 columns: 100 columns per thread, past what
    shared memory holds, so the frontier is in global scratch."""
    from tsta_tpu_torch.ops import psa_chunked
    a, b = _long_pair(12, 25600, 300)
    for args, want in _chunk_cases(a, b, P0, 256, cuda):
        plan, got = _chunk_launch(args, D=1)
        torch.cuda.synchronize()
        assert plan[:2] == (1, 25600)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert psa_chunked.chunk_plan(25600, 1)[2] == 100


@pytest.mark.cuda
def test_psa_dp_chunk_layout_is_chunk_plan(cuda):
    """The kernel's exported plan equals psa_chunked.chunk_plan."""
    from tsta_tpu_torch.ops import psa_chunked
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for s in sorted({1, 7, 132, sms}):
        for n_pad in (4, 128, 1024, 2048, 4100, 9088, 10112, 33792 * 4,
                      200064, 1 << 22):
            assert (_kernels.psa_dp_chunk_layout(n_pad, s)
                    == psa_chunked.chunk_plan(n_pad, s)), (n_pad, s)


@pytest.mark.cuda
def test_psa_dp_chunk_past_the_resident_limit_raises(cuda):
    """One shard more than the card holds resident raises KernelError
    naming the limit, before launching; bad plans raise ValueError."""
    limit = _kernels.psa_dp_traced_max_blocks(4, 64, cuda)
    assert limit >= torch.cuda.get_device_properties(cuda).multi_processor_count
    n_pad = 4 * (limit + 1)
    i32 = torch.int32
    a = torch.zeros((n_pad,), dtype=torch.uint8, device=cuda)
    b = torch.ones((8,), dtype=torch.uint8, device=cuda)
    lens = torch.tensor([n_pad, 8], dtype=i32, device=cuda)
    h = torch.zeros((n_pad,), dtype=i32, device=cuda)
    args = (a, b, lens, 0, h, h.clone(), P0)
    n0 = _kernels.launches["psa_dp_chunk"]
    with pytest.raises(_kernels.KernelError, match="at most %d" % limit):
        _chunk_launch(args, D=limit + 1, T=64)
    assert _kernels.launches["psa_dp_chunk"] == n0
    with pytest.raises(ValueError):   # 12 columns make 3 shards of 4, not 7
        _chunk_launch((a[:12], b, lens, 0, h[:12], h[:12], P0), D=7)
    with pytest.raises(ValueError):   # T past the shared memory plan
        _chunk_launch(args, T=257)


def _traced_group(P, n, m, seed):
    """P seeded pairs of about n x m (similar and unrelated in turns, the
    last ones shorter), laid out as one traced group on the CPU."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(P):
        nk = n - (k * 37) % max(1, n // 3)
        mk = m - (k * 53) % max(1, m // 3)
        a, b = _long_pair(seed * 1000 + k, nk, mk)
        if k % 2:
            b = rng.integers(65, 69, mk).astype(np.uint8)
        pairs.append((a, b))
    return psa_diff.pack_pairs(pairs, torch.device("cpu"), traced=True)


def _traced_vs_plain(cuda, group, params, D=None, T=None):
    """The traced kernel at (D, T) against the plain version in every
    output; returns the (D, C, T) it ran."""
    a, b, nm = group
    want = psa_diff.run_dp(a, b, nm, params, traced=True)
    ga, gb, gnm = a.to(cuda), b.to(cuda), nm.to(cuda)
    got = [torch.empty((a.shape[0],), dtype=torch.int32, device=cuda)
           for _ in range(2)]
    plane = torch.empty((a.shape[0], b.shape[1], a.shape[1]),
                        dtype=torch.uint8, device=cuda)
    plan = _kernels.psa_dp_traced(ga, gb, gnm, params, *got, plane, D=D, T=T)
    torch.cuda.synchronize()
    for g, w in zip(got + [plane], want):
        assert torch.equal(g.cpu(), w)
    return plan


# (P, n, m): one pair, three and a batch of 32, narrow enough for CPU plain
TRACED_GROUPS = [(1, 1500, 1300), (3, 2100, 700), (32, 700, 500)]


@pytest.mark.cuda
@pytest.mark.parametrize("params", [P0, (0, -1, -1, 0)])
@pytest.mark.parametrize("D,T", [(1, None), (2, None), (5, 48), (2, 1),
                                 (None, None), (None, 32)])
@pytest.mark.parametrize("P,n,m", TRACED_GROUPS)
def test_psa_dp_traced_kernel_matches_plain(cuda, P, n, m, params, D, T):
    """psa_dp_traced.cu (K2, and Q2-13 traced at P = 1) at P = 1, 3 and
    32, D = 1, 2, 5 and the plan, T = 1, 32, 48 and the plan, default
    and edit scoring: every score, corner and plane byte equal to the
    plain version's; the first and the last shard in every D > 1 (C =
    n_pad / D rounded up to 4 leaves the last one narrower)."""
    group = _traced_group(P, n, m, P + n)
    n_pad = group[0].shape[1]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n0 = _kernels.launches["psa_dp_traced"]
    plan = _traced_vs_plain(cuda, group, params, D, T)
    assert _kernels.launches["psa_dp_traced"] == n0 + 1
    want = psa_diff.traced_plan(P, n_pad, sms)
    assert plan[0] == (D or want[0]) and plan[2] == (T or want[3])
    if D:
        assert plan[1] == (-(-n_pad // D) + 3) // 4 * 4


@pytest.mark.cuda
def test_psa_dp_traced_run_dp_routes_to_it(cuda):
    """``run_dp(traced=True)`` on the card launches the traced kernel
    (never K1, never a plain scan) and takes the D/T overrides."""
    a, b, nm = _traced_group(3, 900, 600, 4)
    want = psa_diff.run_dp(a, b, nm, P0, traced=True)
    n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
    for kw in ({}, {"D": 3, "T": 16}):
        got = psa_diff.run_dp(a.to(cuda), b.to(cuda), nm.to(cuda), P0,
                              traced=True, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert _kernels.launches["psa_dp_traced"] == n0["psa_dp_traced"] + 2
    assert _kernels.launches["psa_dp_score"] == n0["psa_dp_score"]
    assert psa_scan.plain_calls == p0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2])
def test_psa_dp_traced_wide_strips_take_the_global_frontier(cuda, D):
    """Strips past kSmemW (96 columns a thread): 2 pairs of 25,600
    columns at D = 1 and 51,200 at D = 2 (100 a thread), the frontier in
    global scratch; equal to the plain version."""
    group = _traced_group(2, 25600 * D, 260, 30 + D)
    plan = _traced_vs_plain(cuda, group, P0, D)
    assert -(-plan[1] // 256) > 96


@pytest.mark.cuda
def test_psa_dp_traced_layout_is_traced_plan(cuda):
    """The kernel's exported plan equals psa_diff.traced_plan, and at one
    pair the chunk's plan."""
    from tsta_tpu_torch.ops import psa_chunked
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for s in sorted({1, 16, 132, sms}):
        for P in (1, 2, 3, 32, 128, 200, 5000):
            for n_pad in (4, 128, 1024, 9088, 10240, 30720, 100352, 200064):
                assert (_kernels.psa_dp_traced_layout(P, n_pad, s)
                        == psa_diff.traced_plan(P, n_pad, s)), (P, n_pad, s)
        for n_pad in (1024, 10240, 200064):
            assert (_kernels.psa_dp_traced_layout(1, n_pad, s)
                    == _kernels.psa_dp_chunk_layout(n_pad, s)
                    == psa_chunked.chunk_plan(n_pad, s))


@pytest.mark.cuda
def test_psa_dp_traced_past_the_resident_limit(cuda):
    """D = 2 over more pairs than the card holds resident raises
    KernelError naming the limit, without launching; D = 1 over the same
    pairs, past the limit, is an ordinary launch and equals the plain
    version."""
    a, b, nm = _traced_group(1, 120, 60, 9)
    C = (-(-a.shape[1] // 2) + 3) // 4 * 4
    limit = _kernels.psa_dp_traced_max_blocks(C, 32, cuda)
    P = limit // 2 + 1
    group = (a.expand(P, -1).contiguous(), b.expand(P, -1).contiguous(),
             nm.expand(P, -1).contiguous())
    n0 = _kernels.launches["psa_dp_traced"]
    with pytest.raises(_kernels.KernelError, match="at most %d" % limit):
        _traced_vs_plain(cuda, group, P0, D=2, T=32)
    assert _kernels.launches["psa_dp_traced"] == n0
    limit1 = _kernels.psa_dp_traced_max_blocks(a.shape[1], 32, cuda)
    P = limit1 + 5
    group = tuple(x[:1].expand(P, -1).contiguous() for x in group)
    assert _traced_vs_plain(cuda, group, P0, D=1)[0] == 1
    assert _kernels.launches["psa_dp_traced"] == n0 + 1
    with pytest.raises(ValueError):   # 128 columns make 32 shards of 4
        _traced_vs_plain(cuda, tuple(x[:1] for x in group), P0, D=200)


# the round-1 domain's parameter sets: edit scoring, M < X, and one with M > 0
ROUND1 = [(0, -1, -1, 0), (0, -1, -1, -1), (-2, -1, -1, 0), P0]


def _short_edges(W):
    """Pairs of one tile less a column, a tile, a tile and a column, and
    two tiles and a column at strips of W (up to 2,048 columns), each at
    1, 7 (fewer rows than lanes), 31, 33 and 300 rows; and 1 x 1."""
    t = 32 * W
    return [(n, m) for n in (t - 1, t, t + 1, 2 * t + 1) if n <= 2048
            for m in (1, 7, 31, 33, 300)] + [(1, 1), (5, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [None] + list(SHORT_WIDTHS))
@pytest.mark.parametrize("params", ROUND1)
def test_dp_short_kernel_matches_plain(cuda, params, W):
    """The short-pair kernel (a lane wavefront, one warp a pair) against
    its plain version, each pair over its real extent, in one launch: at
    the plan's widths on pairs of 1-2,048 columns, and at each built strip
    width W, forced, on its edges (``_short_edges``)."""
    from tsta_tpu_torch.ops import psa_pallas
    rng = np.random.default_rng(5)
    if W is None:
        lengths = [(1, 1), (1, 9), (9, 1), (31, 33), (2048, 2000),
                   (2048, 7)]
        lengths += [(int(rng.integers(2, 2049)), int(rng.integers(2, 2100)))
                    for _ in range(13)]
    else:
        lengths = _short_edges(W)
    a, b, lens = _batch(6, lengths, 256, 128, similar=True)
    want = psa_pallas.dp_short(a, b, lens, params)
    n0 = _kernels.launches["psa_dp_short"]
    if W is None:
        got = psa_pallas.dp_short(a.to(cuda), b.to(cuda), lens.to(cuda),
                                  params)
    else:
        got = tuple(torch.empty(len(lens), dtype=torch.int32, device=cuda)
                    for _ in range(2))
        _kernels.psa_dp_short(a.to(cuda), b.to(cuda), lens.to(cuda), params,
                              *got, W=W)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_dp_short"] == n0 + 1
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_dp_short_width_is_the_replays(cuda):
    """The library's plan (``tsta_psa_dp_short_width``) picks the strip
    width of ``psa_pallas.short_width``, its twin."""
    from tsta_tpu_torch.ops import psa_pallas
    shapes = [(n, m) for n in (1, 31, 64, 150, 160, 257, 700, 1024, 1025,
                               1100, 1500, 2000, 2048)
              for m in (1, 7, 150, 1100, 2000, 9000)]
    assert [_kernels.psa_dp_short_width(n, m) for n, m in shapes] \
        == [psa_pallas.short_width(n, m) for n, m in shapes]


@pytest.mark.cuda
def test_dp_short_kernel_4096_pairs_equal_k1(cuda):
    """The smoke's batch shape: 4,096 pairs of 150-2,000 bp, more than the
    card holds warps at once, in one launch at the plan's blocks an SM and
    at 1 and 3, every score and corner equal to K1's (``psa_dp.cu``) on the
    same pairs."""
    from tsta_tpu_torch.ops import psa_pallas
    rng = np.random.default_rng(16)
    lengths = []
    for _ in range(4096):
        n = int(rng.integers(150, 2001))
        lengths.append((n, max(1, n + int(rng.integers(-40, 41)))))
    a, b, lens = (t.to(cuda) for t in _batch(17, lengths, 256, 128,
                                             similar=True))
    for params in (ROUND1[0], P0):
        k1 = psa_diff.run_dp(a, b, lens, params)
        for per_sm in (None, 1, 3):
            got = tuple(torch.empty(4096, dtype=torch.int32, device=cuda)
                        for _ in range(2))
            n0 = _kernels.launches["psa_dp_short"]
            blocks, used, most = _kernels.psa_dp_short(a, b, lens, params,
                                                       *got, per_sm=per_sm)
            torch.cuda.synchronize()
            assert _kernels.launches["psa_dp_short"] == n0 + 1
            assert 1 <= used <= most and blocks <= 1024
            assert per_sm is None or used == min(per_sm, most)
            for w, g in zip(k1, got):
                assert torch.equal(g, w)
        routed = psa_pallas.dp_short(a, b, lens, params)
        for w, g in zip(k1, routed):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("params", ROUND1[:3])
def test_round1_dp_and_walk_kernels_match_plain(cuda, params):
    """K1, K2 and K3 at M <= 0 against their plain versions: score-only
    over the real extent, traced over every padded cell, and the walk."""
    a, b, lens = _batch(7, [(1000, 950), (130, 60), (9, 8), (512, 700)],
                        256, 128, similar=True)
    for traced in (False, True):
        want = psa_diff.run_dp(a, b, lens, params, traced)
        got = psa_diff.run_dp(a.to(cuda), b.to(cuda), lens.to(cuda), params,
                              traced)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert torch.equal(g.cpu(), w)
    gw, gcnt = tb.walk_packed(got[2], lens.to(cuda))
    torch.cuda.synchronize()
    pw, pcnt = tb.walk_packed_plain(want[2], lens)
    assert torch.equal(gcnt.cpu(), pcnt) and torch.equal(gw.cpu(), pw)


@pytest.mark.cuda
@pytest.mark.parametrize("params", ROUND1[:3])
def test_round1_routes_on_card_match_cpu(cuda, params):
    """Every round-1 route on the card (the traced chain, chunks, the
    short-pair and the batch kernels) equals the CPU's plain run, and no
    plain DP or walk runs on the card."""
    from tsta_tpu_torch.ops import psa_chunked, psa_pallas
    a, b = _long_pair(11, 1300, 1250)
    short = [_long_pair(k, 300 + 50 * k, 280) for k in range(5)]
    wide = [_long_pair(20, 2300, 400), _long_pair(21, 2200, 500)]
    want = [psa_pallas.psa_align_traced_device(a, b, params, device="cpu"),
            psa_chunked.psa_align_traced_chunked(a, b, params, mc=512,
                                                 device="cpu"),
            psa_pallas.psa_align_batch(short, params, device="cpu"),
            psa_pallas.psa_align_batch(wide, params, device="cpu")]
    n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
    got = [psa_pallas.psa_align_traced_device(a, b, params, device=cuda),
           psa_chunked.psa_align_traced_chunked(a, b, params, mc=512,
                                                device=cuda),
           psa_pallas.psa_align_batch(short, params, device=cuda),
           psa_pallas.psa_align_batch(wide, params, device=cuda)]
    assert got[:2] == want[:2] and got[0] == got[1]
    for (gs, gc), (ws, wc) in zip(got[2:], want[2:]):
        assert np.array_equal(gs, ws) and np.array_equal(gc, wc)
    assert psa_scan.plain_calls == p0
    d = {k: _kernels.launches[k] - n0[k] for k in n0}
    assert (d["psa_dp_traced"], d["psa_walk"], d["psa_dp_short"],
            d["psa_dp_score"]) == (1, 1, 1, 1)
    assert d["psa_dp_chunk"] >= 3 and d["psa_walk_bounded"] >= 3


@pytest.mark.cuda
def test_cli_edit_scoring_on_card(cuda, tmp_path, capsys):
    """``tsta-torch psa`` and ``batch --traced`` with edit scoring give the
    CPU's stdout and bytes on the card, through the round-1 DP and walk,
    with no plain call on the card."""
    import os

    from tsta_tpu_torch import cli
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                     "psa_small3")
    fa, fb = os.path.join(d, "a.fa"), os.path.join(d, "b.fa")
    manifest = tmp_path / "pairs.tsv"
    manifest.write_text("p0\t%s\t%s\n" % (fa, fb))
    flags = ["-M", "0", "-X", "-1", "-E", "-1", "-O", "0"]
    got = {}
    for dev in ("cpu", "cuda"):
        n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
        out = tmp_path / (dev + ".out")
        assert cli.main(["psa", "--device", dev, "-1", fa, "-2", fb, "-o",
                         str(out)] + flags) == 0
        assert cli.main(["batch", "--device", dev, "--pairs", str(manifest),
                         "--traced", "--out-dir", str(tmp_path / dev)]
                        + flags) == 0
        got[dev] = (capsys.readouterr().out.splitlines()[0], out.read_bytes(),
                    (tmp_path / dev / "p0.txt").read_bytes())
    assert got["cuda"] == got["cpu"] and got["cpu"][1] == got["cpu"][2]
    assert psa_scan.plain_calls == p0
    assert (_kernels.launches["psa_dp_traced"] - n0["psa_dp_traced"],
            _kernels.launches["psa_walk"] - n0["psa_walk"]) == (2, 2)


@pytest.mark.cuda
def test_dp_short_wrapper_refuses_bad_tensors(cuda):
    a, b, lens = _batch(8, [(100, 90), (50, 60)], 256, 128)
    a, b, lens = a.to(cuda), b.to(cuda), lens.to(cuda)
    one = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):   # a score of another batch size
        _kernels.psa_dp_short(a, b, lens, P0, one[:1], one.clone())
    wide = torch.zeros((2, 2176), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):   # wider than the kernel's limit
        _kernels.psa_dp_short(wide, b, lens, P0, one, one.clone())
    n0 = _kernels.launches["psa_dp_short"]
    for kw in (dict(W=9), dict(W=1), dict(per_sm=0)):
        with pytest.raises(ValueError):   # no such build, no block an SM
            _kernels.psa_dp_short(a, b, lens, P0, one, one.clone(), **kw)
    assert _kernels.launches["psa_dp_short"] == n0


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113psa_dp_kernelILi1024ELb1ELb1EEEvPKhS2_PKiiiiNS_6ParamsEPiS6_PhS6_iNS_8FrontierE' for 'sm_90a'
ptxas info    : Used 57 registers, used 1 barriers, 8448 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113psa_dp_kernelILi256ELb0ELb0EEEvPKhS2_PKiiiiNS_6ParamsEPiS6_PhS6_iNS_8FrontierE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113psa_dp_kernelILi256ELb0ELb0EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 2112 bytes smem
"""

_SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113psa_dp_kernelILb0EEEvPKhS2_PKiiiNS_6ParamsEPiS6_PhS6_i
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe20000000800 */
        /*0010*/              @!P0 IMAD R3, R2, c[0x0][0x21c], RZ ;  /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_113psa_dp_kernelILb1EEEvPKhS2_PKiiiNS_6ParamsEPiS6_PhS6_i
        /*0000*/                   EXIT ;
"""


def test_psa_dp_ab_finds_k1_in_ptxas_and_sass():
    """The K1 A/B script picks K1's instantiation out of ptxas's report and
    the SASS dump, before and after the chunk mode's template argument,
    and masks the parameters' constant-bank offsets."""
    from tsta_tpu_torch.tools import psa_dp_ab as ab
    entries = ab.ptxas_entries(_PTXAS)
    k1 = [n for n in entries if ab.is_k1(n)]
    assert len(entries) == 2 and len(k1) == 1 and "Li256ELb0ELb0E" in k1[0]
    assert entries[k1[0]][-1].endswith("Used 40 registers, used 1 barriers, "
                                       "2112 bytes smem")
    funs = ab.sass_functions(_SASS)
    k1 = [n for n in funs if ab.is_k1(n)]
    assert len(funs) == 2 and len(k1) == 1
    assert funs[k1[0]] == ["LDC R1, c[0x0][.]",
                           "@!P0 IMAD R3, R2, c[0x0][.], RZ"]


def _layouts_vs_plain(cuda, a, b, lens, params, D, want, int16):
    """One launch of the difference-method (``int16``) or the striped DP
    at a forced D (None: the plan) on (a, b, lens), held to ``want`` and
    to K1 on the card; one launch of that kernel and no plain call.
    Returns the plan it ran."""
    dev_a, dev_b, dev_l = a.to(cuda), b.to(cuda), lens.to(cuda)
    name = "psa_dp_diff" if int16 else "psa_dp_striped"
    got = [torch.empty((a.shape[0],), dtype=torch.int32, device=cuda)
           for _ in range(2)]
    n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
    if int16:
        ran = _kernels.psa_dp_diff(dev_a, dev_b, dev_l, params, *got, D=D)
    else:
        tile = psa_diff.pack_pairs_striped(
            [(x[:n].numpy(), y[:m].numpy()) for x, y, (n, m) in
             zip(a, b, lens.tolist())], cuda, n_pad=a.shape[1])[0]
        ran = _kernels.psa_dp_striped(tile, dev_b, dev_l, params, *got, D=D)
    torch.cuda.synchronize()
    assert psa_scan.plain_calls == p0
    assert {k for k in _kernels.KERNELS
            if _kernels.launches[k] != n0[k]} == {name}
    assert _kernels.launches[name] == n0[name] + 1
    k1 = psa_diff.run_dp(dev_a, dev_b, dev_l, params)
    for g, w, k in zip(got, want, k1):
        assert torch.equal(g.cpu(), w.cpu()) and torch.equal(k, g)
    return ran


# the int16 gate's two edge sets (D = 57) and two sets inside it
DIFF16 = [P0, (57, -1, -1, 0), (2, -57, -2, -4), (24, -24, -24, -24)]
LAYOUT_LENGTHS = [(1, 1), (3, 300), (300, 3), (1000, 950), (513, 700),
                  (2100, 1800), (3000, 2990), (129, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [None, 1, 2, 8])
@pytest.mark.parametrize("params", DIFF16)
def test_dp_diff_kernel_matches_plain_and_k1(cuda, params, D):
    """The difference-method kernel (``psa_dp_diff.cu``, int16 offsets in
    P x D column shards) against its plain version on the CPU and K1 on
    the card, on mixed pairs of 1-3,000 bp (pairs that end in an earlier
    shard than the widest), similar ones, at its plan and at forced D = 1,
    2 and 8 (segments of 12, 8 and 4 columns)."""
    a, b, lens = _batch(9, LAYOUT_LENGTHS, 256, 128, similar=True)
    want = psa_diff.run_dp_int16(a, b, lens, params)
    ran = _layouts_vs_plain(cuda, a, b, lens, params, D, want, True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = psa_diff.diff_plan(a.shape[0], a.shape[1], sms)
    assert ran == (plan if D is None else (D,) + psa_diff.diff_shards(
        a.shape[1], D) + (plan[4],))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [None, 1, 2, 8])
def test_dp_diff_kernel_40kbp_pair(cuda, D):
    """A 40 kbp pair at the plan (40 shards of 4 columns a thread), D = 1
    (a strip of 160 columns in two segments), 2 and 8: the int16 kernel
    equals its plain version (run on the card, at the launch's G) and K1,
    under the default scoring and a D = 57 set."""
    a, b = _long_pair(40, 40000, 39700)
    ta, tb_, lens = psa_diff.pack_pairs([(a, b)], cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    G = (psa_diff.diff_plan(1, ta.shape[1], sms)[3] if D is None
         else psa_diff.diff_shards(ta.shape[1], D)[2])
    for params in (P0, (57, -1, -1, 0)):
        p0 = psa_scan.plain_calls
        want = psa_diff.dp_int16_plain(ta, tb_, lens, params, G)
        assert psa_scan.plain_calls == p0 + 1
        ran = _layouts_vs_plain(cuda, ta, tb_, lens, params, D, want, True)
        assert ran[3] == G


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [True, False])
def test_dp_layouts_wide_strips_take_the_global_frontier(cuda, int16):
    """A 52 kbp pair cut to 700 rows at D = 1: a strip of 204 columns
    (int16: 208 in two segments) whose frontier does not fit in shared
    memory, so the kernel keeps it in device memory and reads a from
    there (the striped DP through the tile's index map); equal to the
    plain version and K1."""
    a, b = _long_pair(52, 52000, 700)
    ta, tb_, lens = psa_diff.pack_pairs([(a, b)], torch.device("cpu"))
    if int16:
        want = psa_diff.dp_int16_plain(ta, tb_, lens, P0, 104)
        assert psa_diff.diff_shards(ta.shape[1], 1)[1:] == (208, 104)
        assert _kernels._lib().tsta_psa_dp_diff_scratch_words(208, 104, 32)
    else:
        want = psa_diff.run_dp(ta, tb_, lens, P0)
        assert _kernels._lib().tsta_psa_dp_scratch_words(ta.shape[1], 32)
    _layouts_vs_plain(cuda, ta, tb_, lens, P0, 1, want, int16)


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [True, False])
def test_dp_layouts_global_frontier_across_shards(cuda, int16):
    """The global frontier at D = 2: a 70 kbp pair cut to 300 rows beside
    a 20 kbp pair of 250 rows that ends in shard 0.  Strips of 137 columns
    (int16: 144 in two segments of 72, their anchors in the scratch), so
    shard 1 seeds a multi-segment strip from the packets with its
    frontier and anchors in device memory; equal to the plain version and
    K1."""
    pairs = [_long_pair(70, 70000, 300), _long_pair(71, 20000, 250)]
    ta, tb_, lens = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    n_pad = ta.shape[1]
    if int16:
        C, W, G = psa_diff.diff_shards(n_pad, 2)
        assert (W, G) == (144, 72) and 20000 < C < 70000
        assert _kernels._lib().tsta_psa_dp_diff_scratch_words(W, G, 32)
        want = psa_diff.dp_int16_plain(ta, tb_, lens, P0, G)
    else:
        C = -(-n_pad // 2)
        assert 20000 < C < 70000
        assert _kernels._lib().tsta_psa_dp_scratch_words(C, 32)
        want = psa_diff.run_dp(ta, tb_, lens, P0)
    assert _layouts_vs_plain(cuda, ta, tb_, lens, P0, 2, want,
                             int16)[0] == 2


@pytest.mark.cuda
def test_int16_switch_on_card(cuda, monkeypatch, capsys):
    """``TSTA_DIFF_INT16`` sends the score router and ``tsta-torch psa
    --notrace`` to the int16 kernel on the card, K1 not launched and no
    plain call, with the CPU's numbers."""
    import os

    from tsta_tpu_torch import cli
    from tsta_tpu_torch.ops import psa_pallas
    rng = np.random.default_rng(12)
    pairs = [(rng.integers(65, 69, n).astype(np.uint8),
              rng.integers(65, 69, m).astype(np.uint8))
             for n, m in [(900, 850), (300, 320), (1500, 20)]]
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                     "psa_small3")
    argv = ["psa", "--notrace", "-1", os.path.join(d, "a.fa"), "-2",
            os.path.join(d, "b.fa")]
    want = psa_pallas.psa_align_batch(pairs, P0, device="cpu")
    assert cli.main(argv + ["--device", "cpu"]) == 0
    monkeypatch.setenv("TSTA_DIFF_INT16", "1")
    n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
    got = psa_pallas.psa_align_batch(pairs, P0, device=cuda)
    assert cli.main(argv + ["--device", "cuda"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("maxsorce=")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert psa_scan.plain_calls == p0
    assert {k: _kernels.launches[k] - n0[k] for k in _kernels.KERNELS
            if _kernels.launches[k] != n0[k]} == {"psa_dp_diff": 2}


@pytest.mark.cuda
def test_dp_diff_layout_is_the_plain_versions(cuda):
    """The kernel's plan (D, C, W, G, T), read from the library, is
    ``diff_plan``'s at 4,000 (P, n_pad, SMs) and beyond, to 200 kbp, and
    at one pair of the example's width it cuts the columns over several
    SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = [(P, n, s) for s in sorted({1, 16, 132, sms})
             for P in (1, 2, 3, 32, 128, 200, 5000)
             for n in list(range(4, 4097, 12)) + [9088, 10112, 10240, 30720,
                                                  40064, 100096, 200064]]
    assert len(cases) > 4000
    assert [_kernels.psa_dp_diff_plan(*c) for c in cases] == [
        psa_diff.diff_plan(*c) for c in cases]
    assert _kernels.psa_dp_diff_plan(1, 10112, sms)[0] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [True, False])
def test_dp_layouts_past_the_resident_limit(cuda, int16):
    """Past the card's resident limit at D = 2 each kernel raises its own
    KernelError naming the limit, without launching; D = 1 over as many
    pairs runs (an ordinary launch) and equals K1."""
    rng = np.random.default_rng(30)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pairs = [(rng.integers(65, 69, int(rng.integers(20, 256))).astype(
              np.uint8), rng.integers(65, 69, int(rng.integers(20, 100)))
              .astype(np.uint8)) for _ in range(3 * sms)]
    a, b, lens = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    C, W, G = psa_diff.diff_shards(a.shape[1], 2)
    limit = (_kernels.psa_dp_diff_max_blocks(W, G, 32, cuda) if int16 else
             _kernels.psa_dp_striped_max_blocks(-(-a.shape[1] // 2), 32,
                                                cuda))
    reps = -(-(limit + 5) // len(pairs))
    a, b, lens = (x.repeat(reps, 1) for x in (a, b, lens))
    name = "psa_dp_diff" if int16 else "psa_dp_striped"
    want = psa_diff.run_dp(a, b, lens, P0)
    _layouts_vs_plain(cuda, a, b, lens, P0, 1, want, int16)
    Q = limit // 2 + 1
    one = torch.empty((Q,), dtype=torch.int32, device=cuda)
    n0 = _kernels.launches[name]
    with pytest.raises(_kernels.KernelError, match="at most %d" % limit):
        if int16:
            _kernels.psa_dp_diff(a[:Q].to(cuda), b[:Q].to(cuda),
                                 lens[:Q].to(cuda), P0, one, one.clone(),
                                 D=2)
        else:
            tile = psa_diff.pack_pairs_striped(pairs, cuda,
                                               n_pad=a.shape[1])[0]
            tile = tile.repeat(reps, 1, 1)[:Q].contiguous()
            _kernels.psa_dp_striped(tile, b[:Q].to(cuda), lens[:Q].to(cuda),
                                    P0, one, one.clone(), D=2)
    assert _kernels.launches[name] == n0


@pytest.mark.cuda
def test_dp_diff_refuses_bad_tensors_and_params(cuda):
    a, b, lens = _batch(10, [(100, 90), (50, 60)], 256, 128)
    a, b, lens = a.to(cuda), b.to(cuda), lens.to(cuda)
    one = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):   # a score of another batch size
        _kernels.psa_dp_diff(a, b, lens, P0, one[:1], one.clone())
    with pytest.raises(ValueError):   # a width that is not whole words
        _kernels.psa_dp_diff(a[:, :126].contiguous(), b, lens, P0, one,
                             one.clone())
    with pytest.raises(ValueError):   # D = 58: outside the gate
        psa_diff.run_dp_int16(a, b, lens, (2, -58, -2, -4))
    with pytest.raises(_kernels.KernelError):   # the C side's own gate
        _kernels.psa_dp_diff(a, b, lens, (2, -58, -2, -4), one, one.clone())
    with pytest.raises(ValueError):   # 128 columns make no 200 shards
        _kernels.psa_dp_diff(a, b, lens, P0, one, one.clone(), D=200)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [None, 1, 2, 8])
@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6), (1, -1, -1, 0)])
def test_dp_striped_kernel_matches_plain_and_k1(cuda, params, D):
    """The striped-layout kernel (``psa_dp_striped.cu``, K1's shards on
    the tile it reads itself) against its plain version on the CPU and K1
    on the card, on a mixed 100-3,000 bp batch (stripes of 24 columns; the
    short pairs in the first lanes only; shard edges that cut stripes) and
    at a wider tile (Sp 40), at K1's plan and at forced D = 1, 2 and 8."""
    rng = np.random.default_rng(21)
    pairs = [(rng.integers(65, 69, n).astype(np.uint8),
              rng.integers(65, 69, m).astype(np.uint8))
             for n, m in [(100, 120), (3000, 2900), (1500, 100), (129, 3000),
                          (2048, 2047), (1, 1), (257, 700), (2999, 3000)]]
    for n_pad in (None, 5120):
        tile, tb_, tl = psa_diff.pack_pairs_striped(pairs, "cpu", n_pad=n_pad)
        want = psa_diff.run_dp_striped(tile, tb_, tl, params)
        a = psa_diff.pack_pairs(pairs, "cpu")[0]
        a = torch.cat([a, torch.zeros((len(pairs), tile.shape[1] * 128
                                       - a.shape[1]), dtype=torch.uint8)], 1)
        ran = _layouts_vs_plain(cuda, a, tb_, tl, params, D, want, False)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        plan = psa_diff.score_plan(len(pairs), a.shape[1], sms)
        assert ran == ((plan[0], plan[1], plan[3]) if D is None else
                       (D, -(-a.shape[1] // D), plan[3]))


@pytest.mark.cuda
def test_dtype_max_probe_kernel_equals_numpy(cuda):
    """Q2-17d on the card: every form (the five dtypes' maxes, the four
    DPX forms) equal to numpy's plain version in every copy."""
    from tsta_tpu_torch.tools import dtype_max_probe as probe
    n0 = probe.launches
    res = probe.measure(iters=40, copies=3, reps=1, dev=cuda)
    assert set(res) == set(probe.FORMS)
    assert all(r["equal"] for r in res.values()), res
    assert probe.launches == n0 + 2 * len(probe.FORMS)


# the walk probes' small sizes (tests/test_torch_walk_probes.py's)
PROBE_SMALL = {"a": dict(N=64), "b": dict(N=96),
               "c": dict(N=300, P=2, M_ROWS=512, N_W=1024), "e": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("probe,mode", [
    (p, m) for p in "abce" for m in _kernels.WALK_PROBE_MODES[p]])
def test_walk_probe_kernel_equals_plain(cuda, probe, mode):
    """Q2-17a, b, c, e on the card at small sizes: the whole ``out``,
    every program's row and the INT32_MIN words, equal to the plain
    replay; one launch counted."""
    from tsta_tpu_torch.tools import walk_probes as wp
    sz = {**wp.SIZES[probe], **PROBE_SMALL[probe]}
    n = sz.get("N", sz.get("STEPS"))
    plane, host = wp.make_plane(probe, cuda, **sz)
    cols = _kernels.walk_probe_out_cols(probe, n)
    out = torch.full((sz.get("P", 1), cols), wp.INT32_MIN,
                     dtype=torch.int32, device=cuda)
    key = "walk_probe_" + probe
    n0 = _kernels.launches[key]
    wp.run(probe, mode, plane, out, n)
    torch.cuda.synchronize()
    assert _kernels.launches[key] == n0 + 1
    want, _ = wp.plain(probe, mode, host, **sz)
    assert np.array_equal(out.cpu().numpy(), want)


@pytest.mark.cuda
def test_walk_probe_sass_keeps_every_loop(cuda):
    """Every probe kernel's walker loop is in the library's SASS, with a
    step of at least one instruction."""
    from tsta_tpu_torch.tools import walk_probes as wp
    got = wp.sass_steps(wp.library_sass())
    for probe, modes in _kernels.WALK_PROBE_MODES.items():
        for mode in modes:
            loop = got.get((probe, mode))
            assert loop is not None and loop["per_step"] > 0, (probe, mode)


@pytest.mark.cuda
def test_walk_probe_refuses_bad_shapes(cuda):
    """Shapes the kernels do not take raise ValueError, with no launch."""
    n0 = dict(_kernels.launches)
    plane = torch.zeros((256, 1024), dtype=torch.int32, device=cuda)
    out = torch.full((8, 101), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.walk_probe_b(plane, out, "unroll8", 100)
    with pytest.raises(ValueError, match="1024"):
        _kernels.walk_probe_a(plane[:, :512].contiguous(), out, "rd", 100)
    with pytest.raises(ValueError, match="mode"):
        _kernels.walk_probe_a(plane, out, "dma18", 100)
    with pytest.raises(ValueError, match="out"):
        _kernels.walk_probe_c(plane, out, "nodma", 100)
    assert dict(_kernels.launches) == n0


@pytest.mark.cuda
def test_layout_variable_on_card(cuda, monkeypatch):
    """``TSTA_PSA_LAYOUT=striped`` sends ``psa_align_batch_diff`` to the
    striped kernel, K1 not launched and no plain call; ``packed2`` to K1;
    both with the CPU's numbers."""
    rng = np.random.default_rng(22)
    pairs = [(rng.integers(65, 69, n).astype(np.uint8),
              rng.integers(65, 69, m).astype(np.uint8))
             for n, m in [(900, 850), (300, 320), (1500, 20)]]
    want = psa_diff.psa_align_batch_diff(pairs, P0, device="cpu")
    for value, kernel in (("striped", "psa_dp_striped"),
                          ("packed2", "psa_dp_score")):
        monkeypatch.setenv("TSTA_PSA_LAYOUT", value)
        n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
        got = psa_diff.psa_align_batch_diff(pairs, P0, device=cuda)
        assert psa_scan.plain_calls == p0
        moved = {k for k in _kernels.KERNELS
                 if _kernels.launches[k] != n0[k]}
        assert moved == {kernel}
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def _traced_plane(cuda, lengths, seed):
    a, b, lens = _batch(seed, lengths, 256, 512, similar=True)
    *_, plane = psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens.to(cuda),
                                   P0, traced=True)
    return plane, lens.to(cuda)


def _tail_plane(cuda, lengths, params, seed):
    """A traced plane of similar pairs of the given (n, m) whose b ends in
    a mutated copy of a (m >> n ends a walk in a long run up outside the
    matrix, n >> m in one left): the card's traced DP's under the default
    scoring, the plain DP's moved to the card under any other."""
    rng = np.random.default_rng(seed)
    P = len(lengths)
    n_pad = -(-max(n for n, _ in lengths) // 512) * 512
    m_pad = -(-max(m for _, m in lengths) // 256) * 256
    a = np.full((P, n_pad), psa_scan.A_PAD, np.uint8)
    b = np.full((P, m_pad), psa_scan.B_PAD, np.uint8)
    for k, (n, m) in enumerate(lengths):
        a[k, :n] = rng.integers(65, 69, n)
        src = a[k, :n].copy()
        src[rng.integers(0, n, n // 20)] = rng.integers(65, 69, n // 20)
        src = np.delete(src, rng.integers(0, n, n // 30))
        b[k, :m] = np.concatenate([rng.integers(65, 69, m), src])[-m:]
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    nm = torch.tensor(lengths, dtype=torch.int32)
    if params == P0:
        *_, plane = psa_diff.dp_packed(a.to(cuda), b.to(cuda), nm.to(cuda),
                                       P0, traced=True)
    else:
        *_, plane = psa_scan.scan_rows(a, b, nm[:, 0], nm[:, 1], params,
                                       traced=True)
    return plane.contiguous().to(cuda), nm.to(cuda)


EDIT = (0, -1, -1, 0)
PAIR2_CASES = [
    [(512, 500), (400, 512), (130, 60), (9, 8)],
    [(1000, 990), (600, 1024), (1024, 30), (7, 700), (800, 812), (1, 1)],
    [(1, 1), (700, 690)],             # one pair drains in phase 0
    [(40, 900), (30, 700)],           # m >> n: long runs up
    [(900, 40), (700, 30)],           # n >> m: long runs left
]


@pytest.mark.cuda
@pytest.mark.parametrize("params", [P0, EDIT], ids=["default", "edit"])
@pytest.mark.parametrize("lengths", PAIR2_CASES)
def test_walk_pair2_matches_plain_and_k3(cuda, lengths, params):
    """The two-pair walk (``psa_walk_pair2.cu``) on traced planes of 2, 4
    and 6 uneven pairs under the default and the edit scoring (one pair
    drains while its partner walks on; long runs up and left outside the
    matrix): every word and count of the plain version and K3; then the
    first P - 1 pairs, an odd count, take K3."""
    plane, nm = _tail_plane(cuda, lengths, params, 23)
    pw, pc = tb.walk_packed_plain(plane.cpu(), nm.cpu())
    kw, kc = tb.walk_packed(plane, nm)
    n0 = dict(_kernels.launches)
    gw, gc = tb.walk_packed(plane, nm, pair2=True)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_walk_pair2"] == n0["psa_walk_pair2"] + 1
    assert _kernels.launches["psa_walk"] == n0["psa_walk"]
    for g, k, w in ((gw, kw, pw), (gc, kc, pc)):
        assert torch.equal(g.cpu(), w) and torch.equal(k.cpu(), w)
    P = len(lengths)
    n0 = dict(_kernels.launches)
    ow, oc = tb.walk_packed(plane[:P - 1], nm[:P - 1].contiguous(),
                            pair2=True)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_walk"] == n0["psa_walk"] + 1
    assert _kernels.launches["psa_walk_pair2"] == n0["psa_walk_pair2"]
    assert torch.equal(ow.cpu(), pw[:P - 1]) and torch.equal(oc.cpu(),
                                                             pc[:P - 1])


PAIR2_S_CASES = (8, 24, 32, 64, 112)


@pytest.mark.cuda
@pytest.mark.parametrize("S", PAIR2_S_CASES)
def test_walk_pair2_at_forced_plans_matches_plain(cuda, S):
    """The two-pair walk at a forced phase length and each block size, its
    words filled with -1 first: traced planes of uneven pairs, synthetic
    planes (pure-left, pure-up, diagonal and random runs; a plane of 16
    columns, narrower than any window) equal the plain walk in every word
    (the tail words the block zeroes among them) and count, one launch a
    call."""
    cases = [_tail_plane(cuda, PAIR2_CASES[1], P0, 31),
             _tail_plane(cuda, PAIR2_CASES[3], EDIT, 32)]
    for k, kind in enumerate(("left", "up", "diagonal", "random")):
        for P, m_pad, n_pad in ((4, 300, 256), (2, 40, 1040), (2, 9, 16)):
            plane = _code_plane(kind, (P, m_pad, n_pad), 7 * k + P)
            nm = torch.tensor([[n_pad - p * (n_pad // (P + 1)), m_pad - p]
                               for p in range(P)], dtype=torch.int32)
            cases.append((plane.to(cuda), nm.to(cuda)))
    for plane, nm in cases:
        pw, pc = tb.walk_packed_plain(plane.cpu(), nm.cpu())
        for threads in WALK_THREAD_CASES:
            words = torch.full(pw.shape, -1, dtype=torch.int32, device=cuda)
            counts = torch.full(pc.shape, -1, dtype=torch.int32, device=cuda)
            n0 = dict(_kernels.launches)
            _kernels.psa_walk_pair2(plane, nm, words, counts, S=S,
                                    threads=threads)
            torch.cuda.synchronize()
            assert _kernels.launches["psa_walk_pair2"] == \
                n0["psa_walk_pair2"] + 1
            assert sum(_kernels.launches.values()) == sum(n0.values()) + 1
            assert torch.equal(counts.cpu(), pc) and torch.equal(
                words.cpu(), pw), (S, threads)


@pytest.mark.cuda
def test_walk_pair2_many_blocks_an_sm_match_plain(cuda):
    """More than 2 x SMs pairs: traced pairs of 1 to 300 bp (P / 2 blocks
    past the SM count, so the plan takes its smaller S), and 2,048 random
    code planes of 1 to 60 bp at S = 8 and 16 on 64 threads, as many
    blocks an SM as the card holds: every word and count of the plain
    walk, in 10 launches into words filled with -1."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rng = np.random.default_rng(43)
    lengths = [(int(rng.integers(1, 301)), int(rng.integers(1, 301)))
               for _ in range(2 * sms + 6)]
    a, b, lens = _batch(44, lengths, 256, 512, similar=True)
    *_, traced = psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens.to(cuda),
                                    P0, traced=True)
    assert _kernels.psa_walk_layout(len(lengths), sms)[0] < \
        _kernels.psa_walk_layout(2, sms)[0]
    P, m_pad, n_pad = 2048, 64, 64
    codes = torch.from_numpy(rng.integers(0, 27, (P, m_pad, n_pad))
                             .astype(np.uint8))
    cnm = torch.from_numpy(rng.integers(1, 61, (P, 2)).astype(np.int32))
    for plane, nm, shapes in ((traced, lens.to(cuda), [(None, None)]),
                              (codes.to(cuda), cnm.to(cuda),
                               [(8, 64), (16, 64), (None, None)])):
        pw, pc = tb.walk_packed_plain(plane.cpu(), nm.cpu())
        for S, threads in shapes:
            for _ in range(10):
                words = torch.full(pw.shape, -1, dtype=torch.int32,
                                   device=cuda)
                counts = torch.full(pc.shape, -1, dtype=torch.int32,
                                    device=cuda)
                _kernels.psa_walk_pair2(plane, nm, words, counts, S=S,
                                        threads=threads)
                assert torch.equal(counts.cpu(), pc), (S, threads)
                assert torch.equal(words.cpu(), pw), (S, threads)


@pytest.mark.cuda
def test_walk_pair2_refuses_a_bad_plan(cuda):
    """A phase length whose four windows and guards pass a block's shared
    memory (120, 128) or that is not a multiple of 8, and a block that is
    not whole warps in 64-256, raise before any launch."""
    plane, nm = _traced_plane(cuda, [(300, 200), (100, 90)], 24)
    n0 = dict(_kernels.launches)
    for S in (0, 12, 120, 128):
        with pytest.raises(ValueError):
            tb.walk_packed(plane, nm, pair2=True, S=S)
    for threads in (32, 48, 288):
        with pytest.raises(ValueError):
            tb.walk_packed(plane, nm, pair2=True, threads=threads)
    assert _kernels.launches == n0
    # the library's own checks: its shared memory is pair2_bytes, and a
    # phase past 112 (its offset step past a byte) is refused even where
    # the windows would fit
    lib = _kernels._lib()
    for S in (8, 64, 112):
        assert lib.tsta_psa_walk_pair2_bytes(S) == _kernels.pair2_bytes(S)
    words = torch.zeros((2, tb.packed_words_len(sum(plane.shape[1:]))),
                        dtype=torch.int32, device=cuda)
    counts = torch.zeros((2,), dtype=torch.int32, device=cuda)
    args = _kernels._check_walk(plane, nm, words, counts, "psa_walk_pair2")
    for S in (120, 128):
        assert lib.tsta_psa_walk_pair2(*args[:-1], S, 128, args[-1]) != 0
    with pytest.raises(ValueError):
        _kernels.pair2_s(120)


@pytest.mark.cuda
def test_striped_and_pair2_wrappers_refuse_bad_tensors(cuda):
    tile, b, lens = psa_diff.pack_pairs_striped(
        [(np.full(300, 65, np.uint8), np.full(200, 66, np.uint8))] * 2, cuda)
    one = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):   # a flat (B, n_pad) row, not a tile
        _kernels.psa_dp_striped(tile.view(2, -1), b, lens, P0, one,
                                one.clone())
    with pytest.raises(ValueError):   # lens on the host
        _kernels.psa_dp_striped(tile, b, lens.cpu(), P0, one, one.clone())
    with pytest.raises(ValueError):   # a score of another batch size
        _kernels.psa_dp_striped(tile, b, lens, P0, one[:1], one.clone())
    with pytest.raises(ValueError):   # outside the packed gate
        psa_diff.run_dp_striped(tile, b, lens, (0, -1, -1, 0))
    plane, nm = _traced_plane(cuda, [(300, 200), (100, 90), (50, 40)], 24)
    words = torch.empty((3, tb.packed_words_len(256 + 512)),
                        dtype=torch.int32, device=cuda)
    counts = torch.empty((3,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):   # an odd number of pairs
        _kernels.psa_walk_pair2(plane, nm, words, counts)
    with pytest.raises(ValueError):   # words too short
        _kernels.psa_walk_pair2(plane[:2], nm[:2], words[:2, :8].contiguous(),
                                counts[:2])


# (D, T, n, m, params) for the ring: one shard (no packet), chains of 2, 8
# and 132 shards, T 32 and 256, ragged lengths, frontiers in shared memory
# and (C > 25,600 columns) in global scratch
RING_CASES = [
    (1, 32, 300, 200, P0), (1, 256, 1000, 700, (3, -2, -1, -6)),
    (1, 32, 30000, 150, P0),
    (2, 32, 1000, 100, (0, -1, -1, 0)), (2, 256, 513, 600, P0),
    (2, 32, 60000, 70, (3, -2, -1, -6)),
    (8, 32, 1000, 100, P0), (8, 256, 3000, 2900, (0, -1, -1, 0)),
    (8, 32, 5000, 333, (3, -2, -1, -6)),
    (132, 32, 20000, 300, P0), (132, 32, 17000, 250, (0, -1, -1, 0)),
    (132, 256, 17000, 600, (3, -2, -1, -6)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D,T,n,m,params", RING_CASES)
def test_ring_kernel_matches_plain(cuda, D, T, n, m, params):
    """``psa_ring.cu`` against ``psa_ring.ring_plain`` on the card: each
    shard's best and corner and every packet of every row block."""
    from tsta_tpu_torch.ops import psa_ring
    rng = np.random.default_rng(D * 1000 + n)
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = a[rng.integers(0, n, m)] if m < n else rng.integers(65, 69, m)
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(a, b.astype(np.uint8), D, T)
    a_t, b_t = torch.from_numpy(a_p).to(cuda), torch.from_numpy(b_p).to(cuda)
    want = psa_ring.ring_plain(a_t, b_t, n_real, m_real, params, D, T)
    n0 = _kernels.launches["psa_ring"]
    got = psa_ring.ring_kernel(a_t, b_t, n_real, m_real, params, D, T)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_ring"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_ring_routes_on_one_card(cuda):
    """``align_long_ring`` and ``align_long`` on a virtual one-card mesh:
    one ``psa_ring`` launch each (T = ``block`` for ``align_long``), no
    plain call, the CPU mesh's numbers."""
    from tsta_tpu_torch.ops import psa_ring
    from tsta_tpu_torch.parallel import longseq, mesh
    rng = np.random.default_rng(31)
    a = rng.integers(65, 69, 3000).astype(np.uint8)
    b = rng.integers(65, 69, 900).astype(np.uint8)
    card = mesh.make_mesh(2, 8, devices=[cuda] * 16)
    cpu = mesh.make_mesh(1, 8, devices=["cpu"] * 8)
    for fn, kw in ((psa_ring.align_long_ring, {"T": 64}),
                   (longseq.align_long, {"block": 32})):
        n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
        got = fn(a, b, P0, mesh=card, **kw)
        assert psa_scan.plain_calls == p0
        assert {k for k in _kernels.KERNELS
                if _kernels.launches[k] != n0[k]} == {"psa_ring"}
        assert _kernels.launches["psa_ring"] == n0["psa_ring"] + 1
        assert got == fn(a, b, P0, mesh=cpu, **kw)


@pytest.mark.cuda
def test_ring_past_the_resident_limit_raises(cuda):
    """One shard more than the card holds resident raises KernelError
    before launching, at once, instead of hanging."""
    import time

    from tsta_tpu_torch.ops import psa_ring
    from tsta_tpu_torch.parallel import mesh
    limit = _kernels.psa_ring_max_blocks(128, 32, cuda)
    assert limit >= torch.cuda.get_device_properties(cuda).multi_processor_count
    a = np.frombuffer(b"ACGT" * 50, np.uint8)
    card = mesh.make_mesh(1, limit + 1, devices=[cuda] * (limit + 1))
    n0 = _kernels.launches["psa_ring"]
    t0 = time.perf_counter()
    with pytest.raises(_kernels.KernelError, match="at most %d" % limit):
        psa_ring.align_long_ring(a, a, P0, mesh=card, T=32)
    assert time.perf_counter() - t0 < 10
    assert _kernels.launches["psa_ring"] == n0
    out = torch.empty((2, 2), dtype=torch.int32, device=cuda)
    comm = torch.empty((2, 1, 64), dtype=torch.int32, device=cuda)
    a_t = torch.zeros((256,), dtype=torch.uint8, device=cuda)
    b_t = torch.ones((32,), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):   # n not a multiple of 128 * D
        _kernels.psa_ring(a_t[:200], b_t, 2, 32, 100, 20, P0, comm, out)
    with pytest.raises(ValueError):   # comm of another shape
        _kernels.psa_ring(a_t, b_t, 2, 32, 100, 20, P0, comm[:1], out)
    with pytest.raises(ValueError):   # a real length past the padding
        _kernels.psa_ring(a_t, b_t, 2, 32, 300, 20, P0, comm, out)


# the ring across cards: (K cards, D_k, T, n, m, params); D_k None is the
# card's plan; 60,000 columns on 2 cards of one shard run the global
# frontier
RING_CARDS_CASES = [
    (2, 1, 32, 1000, 100, P0), (2, 2, 256, 3000, 700, (0, -1, -1, 0)),
    (2, 1, 32, 60000, 70, (3, -2, -1, -6)), (3, 3, 32, 5000, 333, P0),
    (4, None, 32, 20000, 300, (3, -2, -1, -6)), (4, 2, 256, 17000, 600, P0),
    (8, None, 256, 17000, 300, (0, -1, -1, 0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,T,n,m,params", RING_CARDS_CASES)
def test_ring_cards_match_plain(cuda, K, D, T, n, m, params):
    """``run_ring_cards`` over K cards of one card (the linked build of
    ``psa_dp.cu``, one launch a card in order on one stream) against the
    same over CPU devices (``ring_card_plain`` card by card): every card's
    shards' best, corner and packets, every link packet, no plain call on
    the card, K launches."""
    from tsta_tpu_torch.ops import psa_ring
    rng = np.random.default_rng(K * 1000 + n)
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = a[rng.integers(0, n, m)] if m < n else rng.integers(65, 69, m)
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(a, b.astype(np.uint8), K, T)
    a_t, b_t = torch.from_numpy(a_p), torch.from_numpy(b_p)
    n0, p0 = dict(_kernels.launches), psa_scan.plain_calls
    got = psa_ring.run_ring_cards(a_t, b_t, n_real, m_real, params,
                                  [cuda] * K, T, D=D)
    assert psa_scan.plain_calls == p0
    assert {k: _kernels.launches[k] - n0[k] for k in _kernels.KERNELS
            if _kernels.launches[k] != n0[k]} == {"psa_ring_linked": K}
    want = psa_ring.run_ring_cards(a_t, b_t, n_real, m_real, params,
                                   ["cpu"] * K, T, D=got.shards)
    assert (got.best, got.corner) == (want.best, want.corner)
    for g, w in zip(got.outs + got.comms + got.links,
                    want.outs + want.comms + want.links):
        assert torch.equal(g.cpu(), w)
    one = psa_ring.run_ring(a_t.to(cuda), b_t.to(cuda), n_real, m_real,
                            params, K, T)
    assert (got.best, got.corner) == one


@pytest.mark.cuda
def test_ring_on_distinct_cards(cuda):
    """A mesh of two distinct cards runs one linked launch a card, both
    enqueued before either is awaited, and equals the CPU mesh."""
    from tsta_tpu_torch.ops import psa_ring
    from tsta_tpu_torch.parallel import longseq, mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(41)
    a = rng.integers(65, 69, 9000).astype(np.uint8)
    b = rng.integers(65, 69, 700).astype(np.uint8)
    cards = mesh.make_mesh(1, 2, devices=["cuda:0", "cuda:1"])
    cpu = mesh.make_mesh(1, 2, devices=["cpu"] * 2)
    for fn, kw in ((psa_ring.align_long_ring, {"T": 64}),
                   (longseq.align_long, {"block": 32})):
        n0, p0 = _kernels.launches["psa_ring_linked"], psa_scan.plain_calls
        assert fn(a, b, P0, mesh=cards, **kw) == fn(a, b, P0, mesh=cpu, **kw)
        assert _kernels.launches["psa_ring_linked"] == n0 + 2
        assert psa_scan.plain_calls == p0


# the walks' forced phase lengths: the least, two below the plan's, and
# one whose windows need more than 48 KB of shared memory; K3's block
# sizes (the walker's warp and one, three or seven loader warps)
WALK_S_CASES = [8, 32, 64, 128]
WALK_THREAD_CASES = (64, 128, 256)


def _code_plane(kind, shape, seed):
    """A uint8 code plane whose walk runs pure left, pure up, diagonally,
    or over random codes (every back, f and e code: forced runs)."""
    if kind == "random":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 27, shape).astype(np.uint8))
    code = {"left": 3, "up": 19, "diagonal": 9}[kind]
    return torch.full(shape, code, dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("S", WALK_S_CASES)
def test_walk_kernel_at_forced_S_matches_plain(cuda, S):
    """K3 on the window ring at a forced phase length and each block size:
    traced planes of uneven pairs (a few dozen bp beside 1 kbp, so each
    block keeps its own phases), synthetic planes (pure-left, pure-up,
    diagonal and random runs; a plane of 16 columns, narrower than any
    window) equal the plain walk in every word and count, one launch a
    call."""
    cases = [_traced_plane(cuda, [(1000, 990), (600, 1024), (1024, 30),
                                  (7, 700), (40, 36), (1, 1)], 31)]
    for k, kind in enumerate(("left", "up", "diagonal", "random")):
        for P, m_pad, n_pad in ((3, 300, 256), (2, 40, 1040), (2, 9, 16)):
            plane = _code_plane(kind, (P, m_pad, n_pad), 7 * k + P)
            nm = torch.tensor([[n_pad - p * (n_pad // 3), m_pad - p]
                               for p in range(P)], dtype=torch.int32)
            cases.append((plane.to(cuda), nm.to(cuda)))
    for plane, nm in cases:
        pw, pc = tb.walk_packed_plain(plane.cpu(), nm.cpu())
        for threads in WALK_THREAD_CASES:
            n0 = dict(_kernels.launches)
            gw, gc = tb.walk_packed(plane, nm, S=S, threads=threads)
            torch.cuda.synchronize()
            assert _kernels.launches["psa_walk"] == n0["psa_walk"] + 1
            assert sum(_kernels.launches.values()) == sum(n0.values()) + 1
            assert torch.equal(gc.cpu(), pc) and torch.equal(gw.cpu(), pw)


@pytest.mark.cuda
def test_walk_kernel_many_blocks_an_sm_match_plain(cuda):
    """2,048 short pairs of 1 to 60 bp, walks of a few phases whose last
    is often one step, with as many K3 blocks an SM as the card holds (S =
    8 and 16 at 64 threads, and the plan, which takes a smaller S than at
    one pair): in each of 20 launches into words filled with -1 first,
    every word (the tail words the block zeroes after the walk among them)
    and count equals the plain walk's.  A block whose threads left the
    ring at different phases would zero from a stale count or not at
    all."""
    rng = np.random.default_rng(41)
    P, m_pad, n_pad = 2048, 64, 64
    plane = torch.from_numpy(rng.integers(0, 27, (P, m_pad, n_pad))
                             .astype(np.uint8))
    nm = torch.from_numpy(rng.integers(1, 61, (P, 2)).astype(np.int32))
    pw, pc = tb.walk_packed_plain(plane, nm)
    plane, nm = plane.to(cuda), nm.to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert _kernels.psa_walk_layout(P, sms)[0] < \
        _kernels.psa_walk_layout(1, sms)[0]
    for shape in ((8, 64), (16, 64), (None, None)):
        for _ in range(20):
            words = torch.full(pw.shape, -1, dtype=torch.int32, device=cuda)
            counts = torch.full((P,), -1, dtype=torch.int32, device=cuda)
            _kernels.psa_walk(plane, nm, words, counts, S=shape[0],
                              threads=shape[1])
            assert torch.equal(counts.cpu(), pc), shape
            assert torch.equal(words.cpu(), pw), shape


def _stretch_pair(seed, n, m):
    """Phase 15 (b)'s shape: ``n`` random columns against a mutated
    ``m`` bp stretch from their middle, so each chunk's walk runs mostly
    left along a few rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = a[n // 2:n // 2 + m].copy()
    hit = rng.integers(0, m, m // 12)
    b[hit] = rng.integers(65, 69, hit.size)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,mc", [(100, 700, 256), (1500, 1300, 256),
                                    (9000, 600, 256),
                                    (200_000, 2_000, 512)])
def test_bounded_walk_at_forced_S_matches_plain(cuda, n, m, mc):
    """Q2-8 on the window ring at each forced phase length, chunk by chunk
    from the same entries: every move and exit state equal to the plain
    bounded walk's, one launch a walk.  The last shape is phase 15 (b)'s
    2,048 x 200,064 chunks of 512 rows, with walks of ~100k steps mostly
    left; the others a last chunk of a few rows and chunks narrower than
    a window."""
    from tsta_tpu_torch.ops import psa_chunked
    a, b = _stretch_pair(n, n, m) if n > 10_000 else _long_pair(n + m, n, m)
    pair = psa_chunked.ChunkedPair(a, b, P0, mc, cuda)
    snaps, last_rows, _, _, _ = pair.forward(psa_chunked.chunk_dp)
    planes = [psa_chunked.chunk_dp(*pair.chunk_call(c, *snaps[c]))[2]
              for c in range(pair.nchunks)]
    L = pair.m_pad + pair.n_pad
    want = torch.zeros(L, dtype=torch.int8)
    moves = {S: torch.zeros(L, dtype=torch.int8, device=cuda)
             for S in WALK_S_CASES}
    state = (len(b) - 1, len(a) - 1, 0, 0)
    while True:
        c = state[0] // pair.mc
        args = pair.walk_call(c, planes[c], last_rows, *state, want)
        plain = tb.walk_bounded_plain(*args[:-1], want).tolist()
        for S in WALK_S_CASES:
            n0 = dict(_kernels.launches)
            got = tb.walk_bounded(*args[:-1], moves[S], S=S)
            torch.cuda.synchronize()
            assert got.tolist() == plain
            assert (_kernels.launches["psa_walk_bounded"]
                    == n0["psa_walk_bounded"] + 1)
            assert sum(_kernels.launches.values()) == sum(n0.values()) + 1
        state = tuple(plain)
        if state[0] < 0:
            break
    assert state[:2] == (-1, -1)
    for S in WALK_S_CASES:
        assert torch.equal(moves[S].cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["left", "up", "diagonal", "random"])
def test_bounded_walk_from_any_entry_matches_plain(cuda, kind):
    """Entries at a chunk's first and last rows, at base 0 and above it,
    chunks of one row and chunks narrower than a window, at each forced
    S; and a walk of 0 steps (an entry already past the matrix)."""
    rng = np.random.default_rng(len(kind))
    plane = _code_plane(kind, (64, 96), 5)
    for _ in range(12):
        base = int(rng.choice([0, 5, 17, 40]))
        rows = int(rng.choice([1, 3, 64 - base]))
        i = base + int(rng.choice([0, rows - 1]))
        j = int(rng.choice([0, 9, 95]))
        forced = int(rng.choice([0, 1, 3]))
        chunk = plane[base:base + rows].contiguous()
        prev = plane[base - 1] if base else torch.zeros(96, dtype=torch.uint8)
        want = torch.zeros(300, dtype=torch.int8)
        st = tb.walk_bounded_plain(chunk, prev, base, i, j, 3, forced,
                                   want).tolist()
        for S in WALK_S_CASES:
            got = torch.zeros(300, dtype=torch.int8, device=cuda)
            out = tb.walk_bounded(chunk.to(cuda), prev.to(cuda), base, i, j,
                                  3, forced, got, S=S)
            assert out.tolist() == st and torch.equal(got.cpu(), want)
    got = torch.zeros(8, dtype=torch.int8, device=cuda)
    out = tb.walk_bounded(plane[:8].to(cuda), torch.zeros(
        96, dtype=torch.uint8, device=cuda), 0, -1, -1, 2, 0, got)
    assert out.tolist() == [-1, -1, 2, 0] and not got.any()


@pytest.mark.cuda
def test_walk_wrappers_refuse_a_bad_phase_length(cuda):
    """S not a multiple of 8, or whose two windows pass a block's shared
    memory, a block size outside 64-256 or not whole warps, and a plane
    its 16-byte copies cannot stage (n_pad not a multiple of 16, a plane
    or prev_row not 16-byte aligned) raise before any launch; the bounded
    walk's S is ``WALK_S``."""
    assert _kernels.walk_s() == _kernels.WALK_S
    plane, nm = _traced_plane(cuda, [(300, 200), (100, 90)], 24)
    moves = torch.zeros(900, dtype=torch.int8, device=cuda)
    n0 = dict(_kernels.launches)
    for S in (0, 12, 4, 200):
        with pytest.raises(ValueError):
            tb.walk_packed(plane, nm, S=S)
        with pytest.raises(ValueError):
            tb.walk_bounded(plane[0], plane[0, 0], 0, 10, 10, 0, 0, moves,
                            S=S)
    for threads in (0, 32, 48, 288, 512):
        with pytest.raises(ValueError):
            tb.walk_packed(plane, nm, threads=threads)
    odd = torch.zeros((2, 9, 23), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tb.walk_packed(odd, torch.tensor([[20, 9], [5, 3]], dtype=torch.int32,
                                         device=cuda))
    with pytest.raises(ValueError):
        tb.walk_bounded(odd[0], odd[0, 0], 0, 5, 5, 0, 0, moves)
    flat = torch.zeros(1 + 2 * 9 * 32, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(2, 9, 32)
    with pytest.raises(ValueError):
        tb.walk_packed(shifted, torch.tensor([[20, 9], [5, 3]],
                                             dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        tb.walk_bounded(plane[0], flat[1:1 + plane.shape[2]], 0, 10, 10, 0,
                        0, moves)
    assert _kernels.launches == n0


def _mesh_round_graph(seed=7, length=2000):
    """Round 3 of 4 seeded reads of ``length`` bp: the graph after two
    plain rounds, and the third read."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    reads = _reads(seed, 4, length, 0.12)
    g = PoaGraph.from_sequence(reads[0], 4)
    for sno in (1, 2):
        packed, order, _ = msa_poa.run_round(
            g, reads[sno], AlignParams(), torch.device("cpu"), "plain",
            1 << 34)
        msa_native._finish_round(g, reads[sno], sno, order, packed.numpy(),
                                 [], [], [])
    return g, reads[3]


def _wavefront_vs_plain(cuda, g, seq, K, rows):
    """The wavefront's forward over [cuda] * K (each cell one poa_dp.cu
    launch: words, col0 > 0, the window's carried ring and the checkpoint
    at its last column) against the plain versions over [cpu] * K: every
    window's words, scores, ring and left edges; then the whole round
    (the walks window by window, poa_walk_bounded.cu) against the CPU's
    and the single call's packed result.  Returns the launches taken."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_poa
    from tsta_tpu_torch.parallel import msa_longseq
    AP, cpu = AlignParams(), torch.device("cpu")
    wide = g.max_in_degree() > msa_poa.MAX_IN
    n0 = dict(_kernels.launches)
    fk = msa_longseq._Forward(g, seq, AP, [cuda] * K,
                              msa_longseq.LocalLink(), True, None, rows)
    fp = msa_longseq._Forward(g, seq, AP, [cpu] * K,
                              msa_longseq.LocalLink(), True, None, rows)
    torch.cuda.synchronize()
    cell = "poa_dp_window_wide" if wide else "poa_dp_window"
    assert (_kernels.launches[cell] - n0[cell]
            == fk.A * fk.nchunks > fk.A)
    assert np.array_equal(fk.sink, fp.sink)
    for d, wk in fk.wins.items():
        wp = fp.wins[d]
        assert torch.equal(wk.words.cpu(), wp.words), d
        assert torch.equal(wk.scores.cpu(), wp.scores), d
        assert torch.equal(wk.ring.cpu(), wp.ring), d
        if d:
            assert torch.equal(wk.left.cpu(), wp.left), d
    n1 = dict(_kernels.launches)
    got, order = msa_longseq.wavefront_round(g, seq, AP, [cuda] * K,
                                             rows_per_chunk=rows)
    walk = "poa_walk_bounded_wide" if wide else "poa_walk_bounded"
    assert 1 <= _kernels.launches[walk] - n1[walk] <= fk.A
    want, _ = msa_longseq.wavefront_round(g, seq, AP, [cpu] * K,
                                          rows_per_chunk=rows)
    single, order1, _ = msa_poa.run_round(g, seq, AP, cpu, "plain", 1 << 34)
    assert order == order1
    single = single.numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[:2 + len(seq)], single[:2 + len(seq)])
    return {k: _kernels.launches[k] - n0[k] for k in n0
            if _kernels.launches[k] != n0[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("K,rows", [(2, 256), (4, 512), (3, None)])
def test_wavefront_cells_and_walks_match_plain(cuda, K, rows):
    g, seq = _mesh_round_graph()
    _wavefront_vs_plain(cuda, g, seq, K, rows)


@pytest.mark.cuda
def test_wide_wavefront_matches_plain(cuda):
    """The cells and walks in their wide forms (a staircase of 129)."""
    g, seq = _wide_graph(129)
    moved = _wavefront_vs_plain(cuda, g, seq, 3, 512)
    assert "poa_dp_window" not in moved and "poa_walk_bounded" not in moved


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_wavefront_cells_of_several_shards_match_plain(cuda, wide):
    """Windows of 2,560 columns (5 kbp reads over two windows): each cell a
    cooperative ``poa_dp.cu`` launch of two shards, the second narrower,
    in the 16-bit form and the wide one (a staircase of 129)."""
    from tsta_tpu_torch.parallel import msa_longseq
    g, seq = _wide_graph(129, length=5000) if wide else _mesh_round_graph(
        7, 5000)
    n = msa_longseq.mesh_columns(len(seq), 2)
    assert _kernels.poa_plan(n // 2)[:2] == (2, 2048)
    _wavefront_vs_plain(cuda, g, seq, 2, 1024)


@pytest.mark.cuda
def test_mesh_msa_routes_on_card_match_cpu(cuda):
    """``align_seqs(mesh=)`` on one card repeated (the single poa_dp.cu
    launch at D = K and the single-call walk), ``align_seqs(link=)`` and
    the wavefront over the card repeated equal the CPU's meshless run; no
    plain round; a read
    past K * 8,192 columns on one card raises."""
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_native
    from tsta_tpu_torch.parallel import mesh as meshlib
    from tsta_tpu_torch.parallel import msa_longseq
    AP = AlignParams()
    reads = _reads(5, 4, 2500)
    want = msa_native.align_seqs(reads, AP, device="cpu")
    p0 = msa_native.plain_rounds
    for K in (2, 5):
        n0 = dict(_kernels.launches)
        mesh = meshlib.make_mesh(1, K, devices=[cuda] * K)
        assert msa_native.align_seqs(reads, AP, mesh=mesh) == want
        assert _kernels.launches["poa_dp"] == n0["poa_dp"] + 3
        assert _kernels.launches["poa_walk"] == n0["poa_walk"] + 3
    for K in (2, 3):
        n0 = dict(_kernels.launches)
        stats = []
        assert msa_native.align_seqs(reads, AP, link=msa_longseq.LocalLink(
            [cuda] * K), stats=stats) == want
        assert (_kernels.launches["poa_dp_window"] - n0["poa_dp_window"]
                == sum(st["active"] * st["chunks"] for st in stats))
        assert (_kernels.launches["poa_walk_bounded"]
                - n0["poa_walk_bounded"]) >= len(stats) == 3
    g, seq = _mesh_round_graph(9, 600)
    for K in (2, 4):
        packed, _ = msa_longseq.wavefront_round(g, seq, AP, [cuda] * K)
        want1, _ = msa_longseq.wavefront_round(g, seq, AP, ["cpu"] * K)
        assert np.array_equal(packed, want1)
    assert msa_native.plain_rounds == p0
    with pytest.raises(ValueError, match="do not make 2 shards"):
        msa_native.align_seqs([seq, b"A" * 20000], AP, mesh=meshlib.make_mesh(
            1, 2, devices=[cuda] * 2))


@pytest.mark.cuda
def test_data_sharded_batches_on_card(cuda):
    """A batch shared over ``make_mesh(4, 1, [cuda] * 4)``: one K1 launch a
    share score-only, one K2 and one K3 a share traced, every score,
    corner and alignment equal to the CPU's meshless batch."""
    from tsta_tpu_torch.parallel import mesh as meshlib
    rng = np.random.default_rng(17)
    pairs = [(rng.integers(65, 69, int(rng.integers(200, 900))).astype(
        np.uint8), rng.integers(65, 69, int(rng.integers(200, 900))).astype(
        np.uint8)) for _ in range(10)]
    pairs = [(a, b) if len(a) >= len(b) else (b, a) for a, b in pairs]
    mesh = meshlib.make_mesh(4, 1, devices=[cuda] * 4)
    n0 = dict(_kernels.launches)
    got = psa_diff.psa_align_batch_diff(pairs, P0, mesh=mesh)
    want = psa_diff.psa_align_batch_diff(pairs, P0, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert _kernels.launches["psa_dp_score"] == n0["psa_dp_score"] + 4
    got = psa_diff.psa_align_batch_traced_packed(pairs, P0, mesh=mesh)
    assert got == psa_diff.psa_align_batch_traced_packed(pairs, P0,
                                                         device="cpu")
    assert _kernels.launches["psa_dp_traced"] >= n0["psa_dp_traced"] + 4
    assert _kernels.launches["psa_walk"] >= n0["psa_walk"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("nproc", [2, 3])
def test_multihost_ranks_share_the_card(cuda, nproc):
    """``align_seqs_multihost`` as ``nproc`` processes on cuda:0 over gloo,
    each owning one window of every round: every rank's MSA equals the
    single-process meshless run on the card."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from tsta_tpu_torch.config import AlignParams
    from tsta_tpu_torch.ops import msa_native
    _kernels.build()   # the ranks load the built library, not build it
    reads = _reads(13, 3, 1500)
    want = msa_native.align_seqs(reads, AlignParams(), device=cuda)
    prog = (
        "import json, sys\n"
        "from tsta_tpu_torch.parallel import mesh, msa_multihost as mh\n"
        "from tsta_tpu_torch.ops import _kernels\n"
        "assert mesh.maybe_init_distributed()\n"
        "seqs = [bytes.fromhex(h) for h in json.loads(sys.argv[1])]\n"
        "out = mh.align_seqs_multihost(seqs, device='cuda:0',\n"
        "                              rows_per_chunk=512)\n"
        "print('MSA', json.dumps([[r.decode() for r in out.rows],\n"
        "      out.round_scores, _kernels.launches['poa_dp_window']]))\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TSTA_COORDINATOR="127.0.0.1:%d" % port,
               TSTA_NUM_PROCESSES=str(nproc), TSTA_DIST_TIMEOUT_S="120",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", prog, json.dumps([r.hex() for r in reads])],
        cwd=root, env=dict(env, TSTA_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(nproc)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        rows, rounds, cells = json.loads(
            [ln for ln in out.splitlines() if ln.startswith("MSA ")][0][4:])
        assert [r.encode() for r in rows] == want.rows
        assert rounds == want.round_scores
        assert cells >= 2 * len(rounds)
