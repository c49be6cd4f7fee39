"""The column shards of ``csrc/psa_dp_traced.cu`` on the CPU, with zero
tolerance.

The traced DP cuts each pair's columns into D shards, one co-resident block
each, and hands a shard's left edge over as a packet of three values per
row: H(i-1, last column), the inclusive F prefix at it and H(i, last
column).  Here, with the plain version alone:

* ``psa_diff.traced_plan`` against its definition, at the smoke's shapes;
* the composition that makes the packet enough: a traced group's columns
  cut into D = 2 and 3 shards, shard 0 from the matrix's left boundary and
  shard d >= 1 through ``psa_scan.scan_from(..., col0=d*C, left=...)``
  seeded by shard d - 1's packets, equals ``run_dp``'s plain output and
  the JAX traced kernels in interpret mode (``_psa_diff_traced_call``,
  and round-1 ``_psa_pallas`` under edit scoring) in every score, corner
  and plane byte;
* the CPU route: ``run_dp(traced=True)`` takes ``psa_scan.scan_rows`` and
  refuses the card kernel's ``D``/``T`` overrides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu_torch import convert
from tsta_tpu_torch.ops import psa_chunked, psa_diff, psa_scan

P0 = (2, -5, -2, -4)
EDIT = (0, -1, -1, 0)


@pytest.mark.parametrize("P,n_pad,sms,want", [
    (1, 10240, 132, (10, 1024, 4, 32)),     # the example, one pair
    (32, 10240, 132, (4, 3072, 12, 32)),    # the traced batch
    (128, 10240, 132, (1, 10240, 40, 32)),  # the score batch's shape
    (1, 100352, 132, (98, 1024, 4, 32)),    # a traced 100 kbp pair
    (1, 1024, 132, (1, 1024, 4, 32)),       # under one shard's width
    (200, 10240, 132, (1, 10240, 40, 32)),  # past the SMs: D = 1
    (32, 30720, 132, (4, 8192, 32, 32)),
    (1, 10240, 16, (10, 1024, 4, 32)),      # a card of 16 SMs
    (4, 10240, 16, (4, 3072, 12, 32)),
    (16, 100352, 16, (1, 100352, 392, 32)),  # past kSmemW: global frontier
])
def test_traced_plan_against_its_definition(P, n_pad, sms, want):
    D, C, W, T = psa_diff.traced_plan(P, n_pad, sms)
    assert (D, C, W, T) == want
    blocks = max(1, sms // P)
    per_thread = -(-n_pad // (blocks * psa_diff.TRACED_THREADS))
    w0 = (max(psa_diff.TRACED_MIN_W, per_thread) + 3) // 4 * 4
    assert C == min(w0 * 256, n_pad) and W == (-(-C // 256) + 3) // 4 * 4
    assert D == -(-n_pad // C) and (D - 1) * C < n_pad <= D * C
    assert D == 1 or P * D <= sms
    assert T == psa_diff.TRACED_T
    assert psa_diff.traced_plan(1, n_pad, sms) == psa_chunked.chunk_plan(
        n_pad, sms)


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _similar(rng, n, subs, dels, ins):
    a = _rnd(rng, n)
    b = a.copy()
    b[rng.integers(0, n, subs)] = _rnd(rng, subs)
    b = np.delete(b, rng.integers(0, n, dels))
    b = np.insert(b, rng.integers(0, len(b), ins), _rnd(rng, ins))
    return (a, b) if len(a) >= len(b) else (b, a)


def _sharded(a, b, lens, params, D):
    """The traced DP over (P, n_pad) columns cut into D shards of C =
    n_pad / D rounded up to 4 (the kernel's forced cut), each shard's rows
    from its left neighbour's packets: (best, corner, plane)."""
    P, n_pad = a.shape
    m_pad = b.shape[1]
    C = (-(-n_pad // D) + 3) // 4 * 4
    assert -(-n_pad // C) == D
    best = torch.full((P,), psa_scan.NEG, dtype=torch.int32)
    corner = best.clone()
    planes, left = [], None
    for d in range(D):
        cols = slice(d * C, min((d + 1) * C, n_pad))
        right = torch.empty((P, m_pad, 3), dtype=torch.int32)
        sb, sc, codes, _, _ = psa_scan.scan_from(
            a[:, cols].contiguous(), b, lens[:, 0], lens[:, 1], params, True,
            col0=d * C, left=left, right=right)
        best = torch.maximum(best, sb)
        corner = torch.maximum(corner, sc)
        planes.append(codes)
        left = right
    return best, corner, torch.cat(planes, dim=2)


def _group(pairs):
    """One traced group of ``pairs`` laid out as both packages lay it."""
    n_pad = max(psa_diff._traced_n_pad(len(x)) for x, _ in pairs)
    m_pad = -(-max(len(y) for _, y in pairs) // psa_diff.T_R) * psa_diff.T_R
    a = np.full((len(pairs), n_pad), psa_scan.A_PAD, np.uint8)
    b = np.full((len(pairs), m_pad), psa_scan.B_PAD, np.uint8)
    for k, (x, y) in enumerate(pairs):
        a[k, :len(x)] = x
        b[k, :len(y)] = y
    nm = np.array([[len(x), len(y)] for x, y in pairs], np.int32)
    return a, b, nm


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6)])
def test_sharded_traced_group_equals_plain_and_jax(D, params):
    """A traced group of three pairs (one with gap runs, one unrelated,
    one short), its columns in D shards: every score, corner and plane
    byte equal to ``run_dp``'s plain output and JAX's traced kernel."""
    rng = np.random.default_rng(40 + D + params[0])
    pairs = [_similar(rng, 600, 60, 25, 12), (_rnd(rng, 520), _rnd(rng, 330)),
             (_rnd(rng, 140), _rnd(rng, 90))]
    a, b, nm = _group(pairs)
    ta, tb, tnm = (torch.from_numpy(x) for x in (a, b, nm))
    got = _sharded(ta, tb, tnm, params, D)
    want = psa_diff.run_dp(ta, tb, tnm, params, traced=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    P, n_pad = a.shape
    Rp = n_pad // jdiff.LANES
    js, jc, jplane = jdiff._psa_diff_traced_call(
        jnp.asarray(a.reshape(P * Rp, jdiff.LANES).astype(np.int32)),
        jnp.asarray(b.T.astype(np.int32)), jnp.asarray(nm), n_pad,
        b.shape[1], P, params)
    assert np.array_equal(got[0].numpy(), np.asarray(js)[0])
    assert np.array_equal(got[1].numpy(), np.asarray(jc)[0])
    assert torch.equal(got[2], convert.plane_from_jax(jplane, P))


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("seed,n", [(1, 700), (2, 333)])
def test_sharded_round1_pair_equals_plain_and_jax(D, seed, n):
    """Edit scoring, one pair at round-1 padding (Q2-13 traced), its
    columns in D shards: equal to the plain version and JAX's round-1
    kernel (``_psa_pallas`` traced), every plane byte."""
    rng = np.random.default_rng(seed)
    x, y = _similar(rng, n, n // 12, n // 40, n // 50)
    ta, tb, tnm = psa_diff.pack_pairs([(x, y)], torch.device("cpu"))
    got = _sharded(ta, tb, tnm, EDIT, D)
    want = psa_diff.run_dp(ta, tb, tnm, EDIT, traced=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n_pad, m_pad = ta.shape[1], tb.shape[1]
    ap = np.full(n_pad, jscan.A_PAD, np.uint8)
    ap[:len(x)] = x
    bp = np.full(m_pad, jscan.B_PAD, np.uint8)
    bp[:len(y)] = y
    jscore, jcorner, _, jplane = jpallas._psa_pallas(
        jnp.asarray(ap.astype(np.int32).reshape(-1, 128)),
        jnp.asarray(bp.astype(np.int32).reshape(-1, 1)),
        jnp.asarray([[len(x), len(y)]], np.int32), n_pad, m_pad, EDIT, True)
    assert (int(got[0][0]), int(got[1][0])) == (int(jscore[0, 0]),
                                                int(jcorner[0, 0]))
    assert torch.equal(got[2][0], convert.r1_plane_from_jax(jplane))


def test_sharded_chunk_rows_equal_one_launch():
    """A row-chunk from a carried frontier (row_base > 0), its columns in
    3 shards: codes, best and corner equal to the unsharded chunk, as the
    chunk DP's launch at P = 1 composes them."""
    rng = np.random.default_rng(5)
    x, y = _similar(rng, 650, 50, 20, 10)
    pair = psa_chunked.ChunkedPair(x, y, P0, 256, torch.device("cpu"))
    h, e = pair.entry()
    for c in range(pair.nchunks):
        a, b, lens, row_base, h, e, p = pair.chunk_call(c, h, e)
        want = psa_chunked.chunk_dp_plain(a, b, lens, row_base, h, e, p)
        C = (-(-a.shape[0] // 3) + 3) // 4 * 4
        best, corner, planes, left = [], [], [], None
        for d in range(3):
            cols = slice(d * C, min((d + 1) * C, a.shape[0]))
            right = torch.empty((1, b.shape[0], 3), dtype=torch.int32)
            sb, sc, codes, _, _ = psa_scan.scan_from(
                a[cols].view(1, -1), b.view(1, -1), lens[0:1], lens[1:2], p,
                True, row_base, h[cols].view(1, -1), e[cols].view(1, -1),
                col0=d * C, left=left, right=right)
            best.append(int(sb))
            corner.append(int(sc))
            planes.append(codes[0])
            left = right
        assert max(best) == int(want[0]) and max(corner) == int(want[1])
        assert torch.equal(torch.cat(planes, dim=1), want[2])
        h, e = want[3], want[4]


def test_cpu_traced_dp_takes_the_plain_scan_and_refuses_overrides(
        monkeypatch):
    rng = np.random.default_rng(3)
    a, b, nm = psa_diff.pack_pairs([(_rnd(rng, 90), _rnd(rng, 70))],
                                   torch.device("cpu"), traced=True)
    calls = []
    real = psa_scan.scan_rows

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(psa_scan, "scan_rows", spy)
    out = psa_diff.run_dp(a, b, nm, P0, traced=True)
    assert calls == [True] and len(out) == 3
    for kw in ({"D": 2}, {"T": 16}, {"D": 1, "T": 32}):
        with pytest.raises(ValueError):
            psa_diff.run_dp(a, b, nm, P0, traced=True, **kw)
    with pytest.raises(ValueError):
        psa_diff.run_dp(a, b, nm, P0, D=2)
    for kw in ({"T": 16}, {"D": 1, "T": 32}):   # score-only refuses them too
        with pytest.raises(ValueError, match="overrides"):
            psa_diff.run_dp(a, b, nm, P0, **kw)
    plane = torch.empty((1, b.shape[1], a.shape[1]), dtype=torch.uint8)
    one = torch.empty((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        from tsta_tpu_torch.ops import _kernels
        _kernels.psa_dp_traced(a, b, nm, P0, one, one.clone(), plane, D=1)
    assert calls == [True]


def test_psa_dp_ab_child_parses_and_times_each_kernel():
    """The A/B tool's timed process (run in either checkout on the card)
    is valid Python and times K1 and K2 through ``dp_packed``, the ring
    through ``ring_kernel`` and Q2-7 through ``chunk_dp``, as ``--kernel
    k1|ring|traced|chunk`` asks; any other kernel is refused."""
    import ast
    from tsta_tpu_torch.tools import psa_dp_ab
    tree = ast.parse(psa_dp_ab.CHILD)
    calls = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert {"dp_packed", "ring_kernel", "chunk_dp", "ChunkedPair"} <= calls
    kinds = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and n.value in ("k1", "ring", "traced")}
    assert kinds == {"k1", "ring", "traced"}
    with pytest.raises(SystemExit):
        psa_dp_ab.main(["--other", ".", "--kernel", "walk"])
