"""The column shards of ``csrc/psa_dp.cu`` (the score-only DP, K1 and the
ring) on the CPU, with zero tolerance.

The score-only DP cuts each pair's columns into D shards, one co-resident
block each, and hands a shard's left edge over as a packet of two values
per row: H(i-1, last column) and the inclusive F prefix at it.  A K1
launch runs each pair over its real extent, so a shard wholly past a
pair's columns runs nothing.  Here, with the plain version alone:

* ``psa_diff.score_plan`` against its definition, at the smoke's shapes,
  on a card of 16 SMs and past the SMs;
* the composition that makes the two-lane packet enough: a group of three
  pairs of mixed lengths (one ending in an earlier shard) cut into D = 2
  and 3 shards, shard 0 from the matrix's left boundary and shard d >= 1
  through ``psa_scan.scan_from(..., col0=d*C, left=...)`` seeded by shard
  d - 1's packets, equals ``run_dp``'s plain output and JAX's K1
  (``_psa_diff_call``, interpret mode) in every score and corner, and
  JAX's round-1 batch kernel (``_psa_pallas_batch``) under edit scoring;
* the CPU route: ``run_dp`` score-only takes ``psa_scan.scan_rows`` and
  refuses the card kernel's ``D``/``T`` overrides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan

P0 = (2, -5, -2, -4)
EDIT = (0, -1, -1, 0)


@pytest.mark.parametrize("P,n_pad,sms,want", [
    (1, 10112, 132, (20, 512, 2, 32)),      # the example, --notrace
    (32, 10240, 132, (8, 1280, 5, 32)),     # the int16 probe's int32 side
    (128, 10240, 132, (2, 5120, 20, 32)),   # the score batch
    (1, 40064, 132, (79, 512, 2, 32)),      # phase 3's 40 kbp pair
    (64, 3072, 132, (4, 768, 3, 32)),       # phase 3's mixed batch
    (1, 100096, 132, (131, 768, 3, 32)),    # the 100 kbp pair
    (1, 200064, 132, (261, 768, 3, 32)),    # the 200 kbp pair
    (3, 200064, 132, (87, 2304, 9, 32)),    # check_200k's pairwise DP
    (8, 10240, 132, (14, 768, 3, 32)),      # narrow strips: one block an SM
    (16, 10240, 132, (8, 1280, 5, 32)),
    (1, 100, 132, (1, 100, 1, 32)),         # under one thread's column each
    (200, 10240, 132, (1, 10240, 40, 32)),  # past the SMs: D = 1
    (4096, 2048, 132, (1, 2048, 8, 32)),    # phase 16's short pairs
    (64, 50048, 132, (2, 25088, 98, 32)),   # wide strips: one block an SM
    (128, 200064, 132, (1, 200064, 782, 32)),  # past shared memory
    (1, 10112, 16, (14, 768, 3, 32)),       # a card of 16 SMs
    (4, 10240, 16, (8, 1280, 5, 32)),
    (20, 10240, 16, (1, 10240, 40, 32)),    # past its SMs
    (16, 100096, 16, (1, 100096, 391, 32)),
])
def test_score_plan_against_its_definition(P, n_pad, sms, want):
    D, C, W, T = psa_diff.score_plan(P, n_pad, sms)
    assert (D, C, W, T) == want

    def width(per_sm):
        blocks = max(1, per_sm * sms // P)
        per_thread = -(-n_pad // (blocks * psa_diff.SCORE_THREADS))
        return max(psa_diff.SCORE_MIN_W, per_thread)
    per_sm = 2 if psa_diff.SCORE_SPLIT_W <= width(1) <= \
        psa_diff.SCORE_SPLIT_MAX_W else 1
    assert C == min(width(per_sm) * 256, n_pad)
    assert W == -(-C // 256) and T == psa_diff.SCORE_T
    assert D == -(-n_pad // C) and (D - 1) * C < n_pad <= D * C
    assert D == 1 or P * D <= per_sm * sms
    assert psa_diff.score_plan(P, n_pad, sms, per_sm=per_sm) == want


@pytest.mark.parametrize("min_w,per_sm,want", [
    (2, 1, [(20, 512, 2), (4, 2560, 10), (1, 10240, 40)]),
    (2, 2, [(20, 512, 2), (8, 1280, 5), (2, 5120, 20)]),
    (4, 1, [(10, 1024, 4), (4, 2560, 10), (1, 10240, 40)]),
    (4, 2, [(10, 1024, 4), (8, 1280, 5), (2, 5120, 20)]),
    (8, 1, [(5, 2048, 8), (4, 2560, 10), (1, 10240, 40)]),
    (8, 2, [(5, 2048, 8), (5, 2048, 8), (2, 5120, 20)]),
])
def test_score_plan_sweep_at_the_smoke_shapes(min_w, per_sm, want):
    """The smoke's phase 6 sweep at 1, 32 and 128 x 10,240: the least W 2,
    4 and 8, one or two blocks an SM forced; every D >= 2 plan fits
    per_sm blocks on each of 132 SMs."""
    got = [psa_diff.score_plan(P, 10240, 132, min_w, per_sm)
           for P in (1, 32, 128)]
    assert [g[:3] for g in got] == want
    for P, (D, _, _, _) in zip((1, 32, 128), got):
        assert D == 1 or P * D <= per_sm * 132


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _similar(rng, n, subs, dels, ins):
    a = _rnd(rng, n)
    b = a.copy()
    b[rng.integers(0, n, subs)] = _rnd(rng, subs)
    b = np.delete(b, rng.integers(0, n, dels))
    b = np.insert(b, rng.integers(0, len(b), ins), _rnd(rng, ins))
    return (a, b) if len(a) >= len(b) else (b, a)


def _score_sharded(a, b, lens, params, D):
    """The score-only DP of a K1 launch over (P, n_pad) columns cut into D
    shards of C = ceil(n_pad / D) columns: each pair over its real extent,
    a shard wholly past its columns skipped, each later shard's rows
    seeded by its left neighbour's two-lane packets.  (best, corner) as
    (P,) int32, the max over the shards."""
    P, n_pad = a.shape
    C = -(-n_pad // D)
    assert -(-n_pad // C) == D
    best = torch.full((P,), psa_scan.NEG, dtype=torch.int32)
    corner = best.clone()
    for k in range(P):
        n_real, m_real = (int(v) for v in lens[k])
        left = None
        for d in range(D):
            if d * C >= n_real:
                break
            cols = slice(d * C, min((d + 1) * C, n_real))
            right = torch.empty((1, m_real, 2), dtype=torch.int32)
            sb, sc, _, _, _ = psa_scan.scan_from(
                a[k:k + 1, cols].contiguous(),
                b[k:k + 1, :m_real].contiguous(), lens[k:k + 1, 0],
                lens[k:k + 1, 1], params, col0=d * C, left=left, right=right)
            best[k] = max(int(best[k]), int(sb[0]))
            corner[k] = max(int(corner[k]), int(sc[0]))
            left = right
    return best, corner


def _mixed(seed):
    """Three pairs: similar with gap runs, unrelated, and short enough to
    end in the first shard at D = 2 and 3."""
    rng = np.random.default_rng(seed)
    return [_similar(rng, 600, 60, 25, 12), (_rnd(rng, 520), _rnd(rng, 330)),
            (_rnd(rng, 140), _rnd(rng, 90))]


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6)])
def test_sharded_score_group_equals_plain_and_jax_k1(D, params, monkeypatch):
    """A K1 group of three mixed-length pairs, its columns in D shards:
    every score and corner equal to ``run_dp``'s plain output and JAX's
    K1 in interpret mode, reached through ``_psa_diff_call``."""
    pairs = _mixed(50 + D + params[0])
    ta, tb, tnm = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    got = _score_sharded(ta, tb, tnm, params, D)
    assert ta.shape[1] > (D - 1) * -(-ta.shape[1] // D) > int(tnm[2, 0])
    want = psa_diff.run_dp(ta, tb, tnm, params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    calls = []
    real = jdiff._psa_diff_call

    def spy(*args, **kw):
        calls.append(kw.get("layout", "packed"))
        return real(*args, **kw)

    monkeypatch.setattr(jdiff, "_psa_diff_call", spy)
    js, jc = jdiff.psa_align_batch_diff(pairs, params, use_int16=False,
                                        layout="packed")
    assert calls and set(calls) == {"packed"}
    assert np.array_equal(got[0].numpy(), np.asarray(js))
    assert np.array_equal(got[1].numpy(), np.asarray(jc))


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("seed", [1, 2])
def test_sharded_score_group_equals_round1_batch_under_edit_scoring(D, seed):
    """Edit scoring (Q2-14's domain, M = 0): the group in D shards equals
    the plain version and JAX's round-1 batch kernel
    (``_psa_pallas_batch``, every padded cell run) in every score and
    corner."""
    pairs = _mixed(seed)
    ta, tb, tnm = psa_diff.pack_pairs(pairs, torch.device("cpu"))
    got = _score_sharded(ta, tb, tnm, EDIT, D)
    want = psa_diff.run_dp(ta, tb, tnm, EDIT)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, b, nm = (x.numpy() for x in (ta, tb, tnm))
    B, n_pad = a.shape
    m_pad = b.shape[1]
    js, jc = jpallas._psa_pallas_batch(
        jnp.asarray(a.astype(np.int32).reshape(B, n_pad // 128, 128)),
        jnp.asarray(b.astype(np.int32).reshape(B * m_pad, 1)),
        jnp.asarray(nm), n_pad, m_pad, EDIT)
    assert np.array_equal(got[0].numpy(), np.asarray(js)[:, 0])
    assert np.array_equal(got[1].numpy(), np.asarray(jc)[:, 0])


def test_cpu_score_dp_takes_the_plain_scan_and_refuses_overrides(
        monkeypatch):
    rng = np.random.default_rng(4)
    a, b, nm = psa_diff.pack_pairs([(_rnd(rng, 90), _rnd(rng, 70))],
                                   torch.device("cpu"))
    calls = []
    real = psa_scan.scan_rows

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(psa_scan, "scan_rows", spy)
    out = psa_diff.run_dp(a, b, nm, P0)
    assert calls == [False] and len(out) == 2
    for kw in ({"D": 2}, {"T": 16}, {"D": 1, "T": 32}):
        with pytest.raises(ValueError, match="overrides"):
            psa_diff.run_dp(a, b, nm, P0, **kw)
    one = torch.empty((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.psa_dp(a, b, nm, P0, one, one.clone(), D=1)
    assert calls == [False]
