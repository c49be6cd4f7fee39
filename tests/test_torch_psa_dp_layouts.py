"""The opt-in score-only layouts on the sharded DP, on the CPU, with zero
tolerance: the striped DP (``csrc/psa_dp_striped.cu``, Q2-11) and the
difference method (``csrc/psa_dp_diff.cu``, Q2-9), each on K1's schedule
of P x D co-resident column shards.

* The striped kernel reads JAX's tile itself: ``psa_diff.striped_slab``
  (its shared-memory reader's twin: stripes read row by row of the tile,
  each byte scattered to its column's slot) and ``striped_at`` (the
  global frontier's index map) against ``striped_columns``, JAX's
  ``col``, at shard edges that cut stripes and at whole stripes.
* The difference method's shard schedule: ``psa_diff.dp_int16_shards``
  replays it, shard d seeded by shard d - 1's two int32 packet lanes a
  row in int16 torch arithmetic (an offset that left int16 shows as a
  wrong score), on mixed-length groups at D = 1, 2 and 3 (one pair
  ending in an earlier shard), held to the plain version
  ``scan_rows_int16``, to K1's plain output and to JAX's
  ``_psa_diff_call(use_int16=True)`` in interpret mode, at the default
  scoring and the gate's two D = 57 sets; and at the plan's own shards.
* ``diff_plan`` and ``diff_shards`` against their definitions at the
  smoke's shapes.
* The CPU routes take the plain versions and refuse the card kernels'
  D/T overrides.
"""

import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan

P0 = (2, -5, -2, -4)
D57 = [(57, -1, -1, 0), (2, -57, -2, -4)]


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _similar(rng, n, subs, dels, ins):
    a = _rnd(rng, n)
    b = a.copy()
    b[rng.integers(0, n, subs)] = _rnd(rng, subs)
    b = np.delete(b, rng.integers(0, n, dels))
    b = np.insert(b, rng.integers(0, len(b), ins), _rnd(rng, ins))
    return (a, b) if len(a) >= len(b) else (b, a)


@pytest.mark.parametrize("sp,col0,Cd,W", [
    (80, 0, 5120, 20),       # 128 x 10,240: shard 0 of the plan, 64 stripes
    (80, 5120, 5120, 20),    # shard 1
    (80, 2560, 1000, 4),     # edges that cut stripes 32 and 44
    (3, 7, 200, 1),          # narrow stripes, a partial first one
    (5, 0, 3, 1),            # less than one stripe
    (24, 300, 84, 1),        # a short pair's last shard
])
def test_striped_slab_reader_against_the_index_map(sp, col0, Cd, W):
    """The slab equals the shard's columns in order (``striped_columns``
    inverted), interleaved as K1's; the reads are the tile in its own
    order, each stripe the shard touches whole, nothing else."""
    rng = np.random.default_rng(sp * 1000 + col0)
    n_pad = sp * 128
    cols = rng.integers(0, 256, n_pad).astype(np.uint8)
    tile = torch.from_numpy(np.ascontiguousarray(
        cols[psa_diff.striped_columns(n_pad)]).reshape(sp, 128))
    assert Cd <= 256 * W and col0 + Cd <= n_pad
    slab, reads = psa_diff.striped_slab(tile, col0, Cd, W)
    want = torch.zeros(W * 256, dtype=torch.uint8)
    j = torch.arange(Cd)
    want[(j % W) * 256 + j // W] = torch.from_numpy(cols[col0:col0 + Cd])
    assert torch.equal(slab, want)
    lanes = sorted({g // sp for g in range(col0, col0 + Cd)})
    assert lanes == list(range(lanes[0], lanes[-1] + 1))
    assert reads.tolist() == [u * 128 + lane for u in range(sp)
                              for lane in lanes]
    for g in (col0, col0 + Cd - 1, col0 + Cd // 2):
        assert psa_diff.striped_at(tile, g) == int(cols[g])


def test_striped_index_map_covers_every_column():
    """The global frontier's index map, tile[(g % Sp) * 128 + g // Sp], is
    JAX's ``col`` inverted at every column of three widths."""
    for n_pad in (128, 1024, 10240):
        cols = np.arange(n_pad) % 251
        tile = torch.from_numpy(cols[psa_diff.striped_columns(n_pad)]
                                .astype(np.uint8)).reshape(-1, 128)
        assert [psa_diff.striped_at(tile, g) for g in range(n_pad)] == \
            cols.tolist()


def _groups(seed):
    """Mixed-length groups: similar pairs with gap runs, unrelated ones, a
    pair short enough to end in the first shard at D = 2 and 3, and pairs
    whose lengths are no multiple of 4."""
    rng = np.random.default_rng(seed)
    return [_similar(rng, 690, 70, 25, 12), (_rnd(rng, 521), _rnd(rng, 333)),
            (_rnd(rng, 141), _rnd(rng, 90)), _similar(rng, 402, 30, 9, 3)]


def _jax_int16(pairs, params, monkeypatch):
    """JAX's int16 route (``_psa_diff_call(use_int16=True)``, interpret
    mode on the CPU), its every call through the kernel recorded."""
    calls = []
    real = jdiff._psa_diff_call

    def spy(*args, **kw):
        calls.append(kw.get("use_int16", args[9] if len(args) > 9 else None))
        return real(*args, **kw)

    monkeypatch.setattr(jdiff, "_psa_diff_call", spy)
    js, jc = jdiff.psa_align_batch_diff(pairs, params, use_int16=True)
    assert calls and set(calls) == {True}
    return np.asarray(js), np.asarray(jc)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("params", [P0] + D57)
def test_int16_shard_replay_equals_plain_k1_and_jax(D, params, monkeypatch):
    """The shard schedule at D forced shards (``diff_shards``: C whole
    segments of G) on a mixed group: every score and corner equal to
    ``scan_rows_int16`` at G unsharded, to K1's plain output and to JAX's
    int16 kernel in interpret mode."""
    pairs = _groups(60 + D + params[0])
    a, b, lens = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    C, W, G = psa_diff.diff_shards(a.shape[1], D)
    assert C % G == 0 or D == 1
    if D >= 2:   # a pair ends in an earlier shard than the widest
        assert int(lens[:, 0].min()) <= (D - 1) * C < a.shape[1]
    got = psa_diff.dp_int16_shards(a, b, lens, params, D, C, G)
    whole = psa_diff.scan_rows_int16(a, b, lens[:, 0], lens[:, 1], params, G)
    k1 = psa_diff.run_dp(a, b, lens, params)
    for g, w, k in zip(got, whole, k1):
        assert torch.equal(g, w) and torch.equal(g, k)
    js, jc = _jax_int16(pairs, params, monkeypatch)
    assert np.array_equal(got[0].numpy(), js)
    assert np.array_equal(got[1].numpy(), jc)


@pytest.mark.parametrize("sms", [16, 132])
def test_int16_shard_replay_at_the_plans_shards(sms):
    """The plan's own shards (``diff_plan`` on a card of 16 and 132 SMs,
    one pair: D >= 2 shards of whole segments) on a 2,100-column pair
    climbing at D =
    57 past int16's range, and two near-identical pairs under the default
    scoring: the replay equals the int32 route and the unsharded plain
    version."""
    rng = np.random.default_rng(sms)
    x = _rnd(rng, 2100)
    cases = [([(x, x.copy())], D57[0]),
             ([_similar(rng, 1900, 40, 10, 10)], P0),
             ([_similar(rng, 2048, 200, 60, 30)], D57[1])]
    for pairs, params in cases:
        a, b, lens = psa_diff.pack_pairs(pairs, torch.device("cpu"))
        D, C, W, G, _ = psa_diff.diff_plan(1, a.shape[1], sms)
        assert D >= 2 and C % G == 0 and 256 * W >= C
        got = psa_diff.dp_int16_shards(a, b, lens, params, D, C, G)
        want = psa_diff.run_dp(a, b, lens, params)
        whole = psa_diff.dp_int16_plain(a, b, lens, params, G)
        for g, w, h in zip(got, want, whole):
            assert torch.equal(g, w) and torch.equal(g, h)
    assert int(got[0][0]) > 0
    assert int(psa_diff.run_dp(*psa_diff.pack_pairs(
        cases[0][0], torch.device("cpu")), D57[0])[0][0]) == 57 * 2100


def test_int16_packet_is_the_exact_f_prefix():
    """The second packet lane (R + beta at the shard's last column, formed
    in int16 as the kernel's thread forms it) is the exact int32 inclusive
    F prefix, and the first is H(i-1) there, row by row: the replay's
    right packet against ``psa_scan.scan_from``'s at the same column."""
    rng = np.random.default_rng(5)
    a_, b_ = _similar(rng, 600, 50, 20, 8)
    a, b, lens = psa_diff.pack_pairs([(a_, b_)], torch.device("cpu"))
    m = int(lens[0, 1])
    for params in [P0] + D57:
        for C in (128, 256, 512):
            want = torch.empty((1, m, 2), dtype=torch.int32)
            psa_scan.scan_from(a[:, :C].contiguous(), b[:, :m].contiguous(),
                               lens[:, 0], lens[:, 1], params, right=want)
            got = torch.empty_like(want)
            psa_diff.scan_rows_int16(a[:, :C].contiguous(),
                                     b[:, :m].contiguous(), lens[:, 0],
                                     lens[:, 1], params, 64, right=got)
            assert torch.equal(got, want)


@pytest.mark.parametrize("P,n_pad,sms,want", [
    (128, 10240, 132, (2, 5120, 20, 20, 32)),   # the smoke's 128 x 10,240
    (32, 10240, 132, (8, 1280, 8, 8, 32)),      # the int16 probe's shape
    (1, 10112, 132, (20, 508, 4, 4, 32)),       # the example, --notrace
    (64, 3072, 132, (4, 768, 4, 4, 32)),        # phase 3's mixed batch
    (1, 40064, 132, (79, 508, 4, 4, 32)),       # phase 3's 40 kbp pair
    (8, 10240, 132, (14, 732, 4, 4, 32)),       # the D = 57 identical pairs
    (200, 10240, 132, (1, 10240, 40, 40, 32)),  # past the SMs
    (264, 40064, 132, (1, 40064, 160, 80, 32)),  # two segments a strip
    (265, 200064, 132, (1, 200064, 784, 112, 32)),  # past shared memory
    (1, 200064, 132, (261, 768, 4, 4, 32)),     # the 200 kbp pair
    (1, 10112, 16, (14, 724, 4, 4, 32)),        # a card of 16 SMs
    (4, 10240, 16, (8, 1280, 8, 8, 32)),
])
def test_diff_plan_against_its_definition(P, n_pad, sms, want):
    """``diff_plan``: K1's shards (``score_plan``'s D), each ceil(n_pad /
    D) columns rounded up to whole segments; the strip that many columns
    over 256 threads, at least 4, rounded up to 4 and cut into equal
    segments of <= 128."""
    D, C, W, G, T = psa_diff.diff_plan(P, n_pad, sms)
    assert (D, C, W, G, T) == want
    k1_d = psa_diff.score_plan(P, n_pad, sms)[0]
    span = -(-n_pad // k1_d)
    w = -(-max(4, -(-span // 256)) // 4) * 4
    nseg = -(-w // 128)
    assert G == -(-(-(-w // nseg)) // 4) * 4 and W == nseg * G
    assert C == min(-(-span // G) * G, n_pad) and D == -(-n_pad // C)
    assert D <= k1_d and (D == 1 or C % G == 0) and 256 * W >= C
    assert psa_diff.diff_shards(n_pad, D) == (C, W, G)


@pytest.mark.parametrize("min_w,per_sm,want", [
    (2, 1, [(20, 512, 4), (4, 2568, 12), (1, 10240, 40)]),
    (2, 2, [(20, 512, 4), (8, 1280, 8), (2, 5120, 20)]),
    (4, 1, [(10, 1024, 4), (4, 2568, 12), (1, 10240, 40)]),
    (4, 2, [(10, 1024, 4), (8, 1280, 8), (2, 5120, 20)]),
    (8, 1, [(5, 2048, 8), (4, 2568, 12), (1, 10240, 40)]),
    (8, 2, [(5, 2048, 8), (5, 2048, 8), (2, 5120, 20)]),
])
def test_diff_plan_sweep_at_the_smoke_shapes(min_w, per_sm, want):
    """The smoke's sweep at 1, 32 and 128 x 10,240: K1's least W 2, 4 or
    8, one or two blocks an SM forced; each plan's D is K1's and fits
    per_sm blocks on each of 132 SMs."""
    got = [psa_diff.diff_plan(P, 10240, 132, min_w, per_sm)
           for P in (1, 32, 128)]
    assert [g[:3] for g in got] == want
    for P, g in zip((1, 32, 128), got):
        assert g[0] == psa_diff.score_plan(P, 10240, 132, min_w, per_sm)[0]
        assert g[0] == 1 or P * g[0] <= per_sm * 132


@pytest.mark.parametrize("n_pad,D,want", [
    (3072, 1, (3072, 12, 12)), (3072, 2, (1536, 8, 8)),
    (3072, 8, (384, 4, 4)), (10240, 2, (5120, 20, 20)),
    (10240, 8, (1280, 8, 8)), (40064, 1, (40064, 160, 80)),
    (40064, 2, (20080, 80, 80)), (40064, 8, (5020, 20, 20)),
])
def test_diff_shards_at_forced_d(n_pad, D, want):
    """A forced D: the strip of ceil(n_pad / D) columns over 256 threads,
    C whole segments, D shards; a D the segments cannot make raises."""
    C, W, G = psa_diff.diff_shards(n_pad, D)
    assert (C, W, G) == want
    assert -(-n_pad // C) == D and (D == 1 or C % G == 0)
    assert G * -(-C // (256 * G)) <= W
    with pytest.raises(ValueError, match="do not make"):
        psa_diff.diff_shards(128, 200)


def test_cpu_layout_routes_take_the_plain_versions_and_refuse_overrides():
    rng = np.random.default_rng(4)
    pairs = [(_rnd(rng, 90), _rnd(rng, 70)), (_rnd(rng, 30), _rnd(rng, 40))]
    a, b, lens = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    tile, tb_, tl = psa_diff.pack_pairs_striped(pairs, torch.device("cpu"))
    want = psa_diff.run_dp(a, b, lens, P0)
    p0 = psa_scan.plain_calls
    for got in (psa_diff.run_dp_int16(a, b, lens, P0),
                psa_diff.run_dp_striped(tile, tb_, tl, P0)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert psa_scan.plain_calls == p0   # counted on CUDA tensors only
    for kw in ({"D": 2}, {"T": 16}, {"D": 1, "T": 32}):
        with pytest.raises(ValueError, match="overrides"):
            psa_diff.run_dp_int16(a, b, lens, P0, **kw)
        with pytest.raises(ValueError, match="overrides"):
            psa_diff.run_dp_striped(tile, tb_, tl, P0, **kw)
    one = torch.empty((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.psa_dp_diff(a, b, lens, P0, one, one.clone(), D=1)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.psa_dp_striped(tile, tb_, tl, P0, one, one.clone(), D=1)
