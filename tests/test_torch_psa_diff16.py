"""The port's difference method (int16 offsets; ``psa_diff.run_dp_int16``,
plain version on the CPU) against the JAX package's ``use_int16=True``
route in interpret mode, the port's int32 route and the JAX scan oracle,
with zero tolerance; the int16 gate and the ``TSTA_DIFF_INT16`` switch on
every route that reads it."""

import os

import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu_torch import cli
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.ops import psa_diff as tdiff
from tsta_tpu_torch.ops import psa_pallas as tpallas
from tsta_tpu_torch.ops import psa_scan
from tsta_tpu_torch.parallel import batch as tbatch

P0 = (2, -5, -2, -4)
EDGE = [(57, -1, -1, 0), (2, -57, -2, -4)]   # D = 57, the gate's edge
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "psa_small3")


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


@pytest.mark.parametrize("params", [
    P0, (1, -1, -1, 0), (5, -4, -1, -6), (24, -24, -24, -24),
    (3, -2, -11, -46), (2, -57, -2, -4),
])
def test_int16_batch_matches_jax(params):
    """JAX's six int16 parameter sets (tests/test_psa_diff.py) on 5 seeded
    pairs of 5-700 bp: JAX's int16 route, the port's and its int32 route."""
    rng = np.random.default_rng(sum(abs(v) for v in params))
    pairs = [(_rnd(rng, int(rng.integers(5, 700))),
              _rnd(rng, int(rng.integers(5, 700)))) for _ in range(5)]
    js, jc = jdiff.psa_align_batch_diff(pairs, params, use_int16=True)
    ts, tc = tdiff.psa_align_batch_diff(pairs, params, use_int16=True,
                                        device="cpu")
    assert ts.dtype == np.int32 and tc.dtype == np.int32
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))
    s32, c32 = tdiff.psa_align_batch_diff(pairs, params, use_int16=False,
                                          device="cpu")
    assert np.array_equal(ts, s32) and np.array_equal(tc, c32)


def _edge_pairs(seed, n=1500):
    """An identical pair and a near-identical one (~4% substituted, ~1%
    deleted): the scores climb across the rows, ~90 re-anchor intervals."""
    rng = np.random.default_rng(seed)
    a = _rnd(rng, n)
    b = a.copy()
    hit = rng.integers(0, n, n // 25)
    b[hit] = _rnd(rng, hit.size)
    b = np.delete(b, rng.integers(0, n, n // 100))
    return [(a, a.copy()), (a, b)]


@pytest.mark.parametrize("params", EDGE)
def test_int16_edge_of_gate(params):
    """D = 57, the largest upward drift ((57, -1, -1, 0): identical rows
    gain 57 per row, 85,500 in all) and the steepest mismatch: equal to
    the port's int32 route and the JAX scan oracle."""
    pairs = _edge_pairs(params[0])
    ts, tc = tdiff.psa_align_batch_diff(pairs, params, use_int16=True,
                                        device="cpu")
    s32, c32 = tdiff.psa_align_batch_diff(pairs, params, device="cpu")
    assert np.array_equal(ts, s32) and np.array_equal(tc, c32)
    for (a, b), s, c in zip(pairs, ts, tc):
        ref = jscan.psa_align(a, b, params)
        assert (int(ref.score), int(ref.last)) == (int(s), int(c))
    if params[0] == 57:
        assert int(ts[0]) == 57 * 1500 > 32767


@pytest.mark.parametrize("seg", [4, 8, 12])
def test_plain_narrow_segments_equal_int32(seg):
    """The plain version at narrow segment widths (several segments per
    kernel strip, many int32 carries and anchors per row) equals the
    int32 scan, at the default and the D = 57 sets."""
    rng = np.random.default_rng(seg)
    pairs = [(_rnd(rng, 150), _rnd(rng, 140)), (_rnd(rng, 61), _rnd(rng, 90)),
             (_rnd(rng, 7), _rnd(rng, 3))] + _edge_pairs(seg, 200)
    a, b, lens = tdiff.pack_pairs(pairs, "cpu")
    for params in [P0] + EDGE:
        want = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], params)[:2]
        got = tdiff.scan_rows_int16(a, b, lens[:, 0], lens[:, 1], params, seg)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)


def test_kernel_layouts_group_the_plain_version():
    """``diff_plan`` gives the kernel's shards, strip and segment widths
    (every segment <= 128 columns and a divisor of the strip and, at D >=
    2, of the shard, 256 strips cover a shard; K1's shards); past the SMs
    one block a pair, as the kernel had before its shards; and the
    wrapper's plain
    version runs a batch of pairs of three widths at one segment width,
    equal to the int32 route."""
    for P in (1, 3, 32, 128, 265):
        for n in (4, 128, 1024, 10240, 32768, 40064, 200064):
            D, C, W, G, T = tdiff.diff_plan(P, n, 132)
            assert G % 4 == 0 and W % G == 0 and G <= tdiff.SEG_MAX
            assert 256 * W >= C and (D == 1 or C % G == 0)
            assert D == -(-n // C)
            assert (D - 1) * C < n <= D * C and T == tdiff.SCORE_T
    assert tdiff.diff_plan(264, 40064, 132) == (1, 40064, 160, 80, 32)
    assert tdiff.diff_plan(265, 200064, 132) == (1, 200064, 784, 112, 32)
    assert tdiff.diff_plan(128, 10240, 132) == (2, 5120, 20, 20, 32)
    assert tdiff.diff_plan(32, 10240, 132) == (8, 1280, 8, 8, 32)
    rng = np.random.default_rng(7)
    pairs = [(_rnd(rng, n), _rnd(rng, 40)) for n in (100, 1100, 2100)]
    a, b, lens = tdiff.pack_pairs(pairs, "cpu")
    assert tdiff.diff_segments(-(-a.shape[1] // 256)) == (12, 12)
    got = tdiff.run_dp_int16(a, b, lens, P0)
    want = tdiff.run_dp(a, b, lens, P0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_supports_params_int16_matches_jax():
    grid = [(m, x, e, o) for m in (1, 2, 57, 58) for x in (-1, -5, -57, -58)
            for e in (-1, -2, -57, -58) for o in (0, -4, -55, -56, -57)]
    grid += [(2, -5, -2, 4), (0, -5, -2, -4), (2, 0, -2, -4), (100, -100,
                                                              -60, -60)]
    assert any(jdiff._delta_bound(p) == 57 for p in grid)
    assert any(jdiff._delta_bound(p) == 58 for p in grid)
    for p in grid:
        assert tdiff._delta_bound(p) == jdiff._delta_bound(p), p
        assert tdiff.supports_params_int16(p) == jdiff.supports_params_int16(
            p), p
    assert tdiff.K_REANCHOR == jdiff.K_REANCHOR


def _spy(monkeypatch):
    calls = []
    orig = tdiff.run_dp_int16

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return orig(*args, **kw)

    monkeypatch.setattr(tdiff, "run_dp_int16", spy)
    return calls


@pytest.mark.parametrize("value", ["1", "0"])
def test_switch_reaches_int16_on_every_route(monkeypatch, capsys, value):
    """``TSTA_DIFF_INT16`` set to any non-empty value ("0" included, as in
    the JAX package) takes ``psa_align_batch_diff``, the score router,
    ``parallel/batch.align_batch`` and ``tsta-torch psa --notrace`` to the
    int16 route, with the int32 route's numbers; unset, none of them."""
    rng = np.random.default_rng(3)
    pairs = [(_rnd(rng, 300), _rnd(rng, 280)), (_rnd(rng, 120), _rnd(rng, 90))]
    argv = ["psa", "--notrace", "--device", "cpu", "-1",
            os.path.join(GOLDEN, "a.fa"), "-2", os.path.join(GOLDEN, "b.fa")]

    def routes():
        out = [tdiff.psa_align_batch_diff(pairs, P0, device="cpu"),
               tpallas.psa_align_batch(pairs, P0, device="cpu"),
               [(r.score, r.last) for r in tbatch.align_batch(
                   pairs, AlignParams(), device="cpu")]]
        assert cli.main(argv) == 0
        return out, capsys.readouterr().out

    calls = _spy(monkeypatch)
    monkeypatch.delenv("TSTA_DIFF_INT16", raising=False)
    want, want_out = routes()
    assert calls == []
    monkeypatch.setenv("TSTA_DIFF_INT16", value)
    got, got_out = routes()
    assert len(calls) >= 4
    assert got_out == want_out and got_out.startswith("maxsorce=")
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("value", ["1", "0"])
def test_switch_raises_past_the_gate_in_both_packages(monkeypatch, value):
    """With the switch set, D = 58 is a ValueError from
    ``psa_align_batch_diff`` of both packages; unset, both give the int32
    kernel's numbers."""
    a = np.frombuffer(b"ACGTACGTTA", np.uint8)
    params = (2, -58, -2, -4)
    monkeypatch.setenv("TSTA_DIFF_INT16", value)
    with pytest.raises(ValueError):
        jdiff.psa_align_batch_diff([(a, a)], params)
    with pytest.raises(ValueError):
        tdiff.psa_align_batch_diff([(a, a)], params, device="cpu")
    with pytest.raises(ValueError):
        tdiff.run_dp_int16(*tdiff.pack_pairs([(a, a)], "cpu"), params)
    monkeypatch.delenv("TSTA_DIFF_INT16")
    js, jc = jdiff.psa_align_batch_diff([(a, a)], params)
    ts, tc = tdiff.psa_align_batch_diff([(a, a)], params, device="cpu")
    assert (int(ts[0]), int(tc[0])) == (int(js[0]), int(jc[0])) == (20, 20)


def test_switch_past_the_gate_cli_diverges_from_jax(monkeypatch, capsys):
    """A recorded divergence (ROADMAP.md, deliberate divergences): with the
    switch set and D > 57, JAX's ``tsta psa --notrace`` still prints a
    score wherever its ``auto`` takes its scan (every pair off the TPU,
    pairs under 5,120 bp on it), while ``tsta-torch psa --notrace`` takes
    the kernel route on every device and fails with JAX's ValueError.
    Unset, both print the same score."""
    from tsta_tpu import cli as jcli
    from tsta_tpu_torch.models import psa as tpsa
    fa, fb = os.path.join(GOLDEN, "a.fa"), os.path.join(GOLDEN, "b.fa")
    argv = ["psa", "--notrace", "-1", fa, "-2", fb, "-X", "-60"]
    monkeypatch.delenv("TSTA_DIFF_INT16", raising=False)
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert want.startswith("maxsorce=")
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    monkeypatch.setenv("TSTA_DIFF_INT16", "1")
    assert jcli.main(argv) == 0
    assert capsys.readouterr().out == want
    assert cli.main(argv + ["--device", "cpu"]) == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="<= 57"):
        tpsa.align_files(fa, fb, AlignParams(mismatch=-60), device="cpu")
