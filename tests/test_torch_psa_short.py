"""The short-pair DP's schedule (``csrc/psa_dp_short.cu``, Q2-15) on the
CPU, with exact equality.

``psa_pallas.dp_short_wavefront`` replays the kernel step by step: the
pairs taken longest first, each at its plan's strip width on a warp of
lanes, lane l on row s - l of its strip at step s, the H~ and F~ handed
from lane to lane, the boundary buffer between column tiles, the columns
past n_real kept below the real maximum (no byte matches them, and their
row-0 diagonal is NEG), and each result written at its pair's input
index.  Here it runs on 4 lanes at W = 1, 2 and 4 (the plan's
or forced), so pairs of <= 300 bp cross many tiles, and on the kernel's
32 lanes and widths, and is held to ``psa_scan.scan_rows`` and to JAX's
``psa_align_batch_packed`` (interpret mode) on every ``ROUND1`` parameter
set, on edge shapes (n = lanes*W - 1, lanes*W, lanes*W + 1; m < lanes,
m = 1, 1 x 1) and on a mixed batch whose order is not its input order.  A
boundary read from the wrong row, and padded columns whose row-0
diagonal is the top edge, must fail it.  The kernel is held to the plain
version on the card (``tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu_torch.ops import psa_diff, psa_pallas, psa_scan

ROUND1 = [(0, -1, -1, 0), (0, -1, -1, -1), (-2, -1, -1, 0), (2, -5, -2, -4)]
# a parameter set of the round-1 domain (M < X - |E|) under which a padded
# cell may beat every real one: only the real cells' max is the contract
ODD = (-10, -1, -1, -1)
SMALL = dict(lanes=4, widths=(1, 2, 4))


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _pairs(seed, shapes):
    """Seeded pairs of the given (n, m), b a ~10% edited copy of a's
    prefix where it is long enough."""
    rng = np.random.default_rng(seed)
    out = []
    for n, m in shapes:
        a = _rnd(rng, n)
        b = np.concatenate([a, _rnd(rng, max(0, m - n))])[:m].copy()
        b[rng.integers(0, m, max(1, m // 10))] = _rnd(rng, max(1, m // 10))
        out.append((a, b))
    return out


def _mixed(seed, count, hi):
    rng = np.random.default_rng(seed)
    return _pairs(seed, [(int(rng.integers(1, hi)), int(rng.integers(1, hi)))
                         for _ in range(count)])


def _scan(pairs, params):
    a, b, lens = psa_diff.pack_pairs(pairs, "cpu")
    return psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], params)[:2]


def _real_cells(pairs, params):
    """The plain DP of each pair alone, unpadded: the max over its real
    cells and its corner."""
    out = [psa_scan.scan_rows(torch.from_numpy(a)[None],
                              torch.from_numpy(b)[None],
                              torch.tensor([len(a)]), torch.tensor([len(b)]),
                              params)[:2] for a, b in pairs]
    return tuple(torch.cat([o[k] for o in out]) for k in (0, 1))


def _replay(pairs, params, **kw):
    a, b, lens = psa_diff.pack_pairs(pairs, "cpu")
    return psa_pallas.dp_short_wavefront(a, b, lens, params, **kw)


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def batch():
    """16 mixed pairs of 1-300 bp (the edge shapes among them), and JAX's
    packed kernel's (scores, corners) on them under each ROUND1 set."""
    pairs = _pairs(3, [(1, 1), (3, 2), (16, 1), (17, 300), (300, 17)])
    pairs += _mixed(4, 11, 301)
    jax = {p: tuple(torch.from_numpy(np.array(x, np.int32))
                    for x in jpallas.psa_align_batch_packed(pairs, p))
           for p in ROUND1}
    return pairs, jax


@pytest.mark.parametrize("n,m", [
    (1, 1), (150, 150), (160, 150), (257, 260), (640, 640), (1000, 1000),
    (1025, 1000), (1100, 1100), (2000, 2000), (2048, 7), (7, 2048),
    (64, 9000), (33, 2), (1500, 1490)])
def test_short_width_against_its_definition(n, m):
    """The plan's strip width is the least modelled cost among the built
    widths, the narrowest on a tie; the cost counts a tile of L lanes as
    m + L - 1 steps of 13 W + 40."""
    w = psa_pallas.short_width(n, m)
    costs = {v: psa_pallas.short_cost(n, m, v)
             for v in psa_pallas.SHORT_WIDTHS}
    assert w in costs and costs[w] == min(costs.values())
    assert all(costs[v] > costs[w] for v in costs if v < w)
    tile = 32 * w
    tiles = -(-n // tile)
    lanes_last = -(-(n - (tiles - 1) * tile) // w)
    assert costs[w] == ((tiles - 1) * (m + 31) + m + lanes_last - 1) * (
        13 * w + 40)


def test_short_plan_counts_each_width():
    lens = torch.tensor([[150, 150], [160, 150], [2000, 2000], [2000, 1990],
                         [1, 1]], dtype=torch.int32)
    plan = psa_pallas.short_plan(lens)
    assert sum(plan.values()) == 5
    assert plan == {w: [psa_pallas.short_width(int(n), int(m))
                        for n, m in lens.tolist()].count(w) for w in plan}


@pytest.mark.parametrize("params", ROUND1)
@pytest.mark.parametrize("schedule", [
    dict(SMALL), dict(SMALL, force_w=1), dict(SMALL, force_w=2),
    dict(SMALL, force_w=4), {}], ids=["4-lanes-plan", "4x1", "4x2", "4x4",
                                      "32-lanes-plan"])
def test_replay_matches_scan_and_jax(batch, params, schedule):
    """The replay equals the plain row scan and JAX's packed kernel in
    every score and corner, in input order."""
    pairs, jax = batch
    got = _replay(pairs, params, **schedule)
    assert _equal(got, _scan(pairs, params))
    assert _equal(got, jax[params])


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("params", [ROUND1[0], ROUND1[3]])
def test_replay_edge_shapes(params, W):
    """Widths one short of a tile, a tile, one past it (so the last tile
    has one lane of one column), rows fewer than the lanes, one row, and
    1 x 1, at a forced strip width of 4 lanes."""
    t = 4 * W
    shapes = [(t - 1, 9), (t, 9), (t + 1, 9), (t + 1, 1), (2 * t + 1, 3),
              (3 * t, 2), (1, 1), (1, 5), (5, 1), (2, 3), (3 * t + 1, 40)]
    pairs = _pairs(10 + W, [s for s in shapes if s[0] >= 1])
    got = _replay(pairs, params, force_w=W, **SMALL)
    assert _equal(got, _scan(pairs, params))
    assert _equal(got, _real_cells(pairs, params))


def test_replay_scatters_to_input_order():
    """A mixed batch whose longest-first order is far from its input
    order: each pair's result lands at its input index."""
    pairs = _mixed(21, 24, 260)
    cells = [len(a) * len(b) for a, b in pairs]
    assert sorted(cells, reverse=True) != cells
    got = _replay(pairs, ROUND1[0], **SMALL)
    assert _equal(got, _real_cells(pairs, ROUND1[0]))
    # one pair alone gives the batch's entry for it
    for k in (0, 7, 23):
        one = _replay([pairs[k]], ROUND1[0], **SMALL)
        assert (int(one[0][0]), int(one[1][0])) == (int(got[0][k]),
                                                    int(got[1][k]))


def test_replay_takes_the_real_cells_max():
    """Under ODD a padded cell beats every real one, so the padded plain
    scan's max differs; the replay gives the real cells' max, at every
    width of the kernel's set and of the small one."""
    pairs = _pairs(30, [(1, 1), (3, 2), (33, 40), (130, 129)])
    want = _real_cells(pairs, ODD)
    assert not torch.equal(_scan(pairs, ODD)[0], want[0])
    assert _equal(_replay(pairs, ODD), want)
    for W in (1, 2, 4):
        assert _equal(_replay(pairs, ODD, force_w=W, **SMALL), want)


def _wrong_row(bnd, r):
    return bnd[np.arange(len(r)), np.maximum(r - 1, 0)]


def _no_kill(orig):
    def columns(ap, j, n, o, e):
        ak, _, e0 = orig(ap, j, n, o, e)
        return ak, np.broadcast_to(o + (j + 2) * e, ak.shape).copy(), e0
    return columns


@pytest.mark.parametrize("mutation", ["wrong_row", "no_kill"])
def test_broken_schedule_fails_the_replay(batch, monkeypatch, mutation):
    """A lane 0 that reads the boundary row above the one it computes, or
    padded columns whose row-0 diagonal is the top edge, give wrong
    scores."""
    if mutation == "wrong_row":
        monkeypatch.setattr(psa_pallas, "_short_left", _wrong_row)
        pairs, params = batch[0], ROUND1[3]
        want = _scan(pairs, params)
    else:
        monkeypatch.setattr(psa_pallas, "_short_columns",
                            _no_kill(psa_pallas._short_columns))
        pairs, params = _pairs(30, [(1, 1), (3, 2), (33, 40)]), ODD
        want = _real_cells(pairs, params)
    assert not _equal(_replay(pairs, params, force_w=2, **SMALL), want)


def test_ab_child_times_the_short_kernel():
    """``tools/psa_dp_ab.py --kernel short`` times ``psa_pallas.dp_short``
    and K1 (``run_dp``) on the smoke's phase 16 (c) pairs."""
    import ast

    from tsta_tpu_torch.tools import psa_dp_ab
    tree = ast.parse(psa_dp_ab.CHILD)
    calls = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert {"dp_short", "run_dp", "short_pairs", "psa_dp_short"} <= calls
    assert "short" in {n.value for n in ast.walk(tree)
                       if isinstance(n, ast.Constant)}
