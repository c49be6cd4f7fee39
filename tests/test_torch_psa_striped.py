"""The port's striped layout and two-pair walk against the JAX package.

``psa_diff.psa_align_batch_diff(layout="striped")`` (plain version
``scan_rows_striped`` on the CPU) against JAX's ``layout="striped"`` in
interpret mode; the port's striped tile against the ``a32`` JAX hands
``_psa_diff_call`` (captured by a spy); ``TSTA_PSA_LAYOUT`` (``striped`` and
``packed2``) through ``psa_align_batch_diff`` and ``parallel.batch.
align_batch`` of both packages; ``traceback.walk_packed(pair2=True)``
against JAX's ``_decode_moves_banded_packed(pair2=True)``.  Zero tolerance:
every score, corner, tile byte, move and count equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu.ops import traceback as jtb
from tsta_tpu.parallel import batch as jbatch
from tsta_tpu_torch import convert
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.ops import psa_diff as tdiff
from tsta_tpu_torch.ops import psa_scan
from tsta_tpu_torch.ops import traceback as ttb
from tsta_tpu_torch.parallel import batch as tbatch

P0 = (2, -5, -2, -4)


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _layout_pairs():
    """JAX's own striped case (``tests/test_psa_diff.py:39``): 7 pairs of
    10-800 bp, one packed group; and 20 pairs of 5-100 bp, two groups."""
    rng = np.random.default_rng(31)
    seven = [(_rnd(rng, int(rng.integers(10, 800))),
              _rnd(rng, int(rng.integers(10, 800)))) for _ in range(7)]
    rng = np.random.default_rng(32)
    twenty = [(_rnd(rng, int(rng.integers(5, 100))),
               _rnd(rng, int(rng.integers(5, 100)))) for _ in range(20)]
    rng = np.random.default_rng(0)
    uneven = [(_rnd(rng, 1024), _rnd(rng, 1000))]
    return {"seven": seven, "two_groups": twenty, "uneven_1k": uneven}


@pytest.mark.parametrize("name", ["seven", "two_groups", "uneven_1k"])
def test_striped_batch_matches_jax(name):
    pairs = _layout_pairs()[name]
    js, jc = jdiff.psa_align_batch_diff(pairs, P0, layout="striped")
    ts, tc = tdiff.psa_align_batch_diff(pairs, P0, layout="striped",
                                        device="cpu")
    assert ts.dtype == np.int32 and tc.dtype == np.int32
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))
    for (a, b), s, c in zip(pairs, ts, tc):
        ref = jscan.psa_align(a, b, P0)
        assert (int(ref.score), int(ref.last)) == (int(s), int(c))


class _Captured(Exception):
    pass


def _jax_a32(monkeypatch, pairs):
    """The (a32, n_pad, P) JAX's striped route hands ``_psa_diff_call``,
    caught by a spy that stops the call there."""
    seen = {}

    def spy(a32, brows, cmask, mlast, flags, n_pad, m_pad, P, params,
            use_int16=False, layout="packed"):
        seen.update(a32=np.asarray(a32), n_pad=n_pad, P=P, layout=layout)
        raise _Captured

    monkeypatch.setattr(jdiff, "_psa_diff_call", spy)
    with pytest.raises(_Captured):
        jdiff.psa_align_batch_diff(pairs, P0, layout="striped")
    assert seen["layout"] == "striped"
    return seen["a32"], seen["n_pad"], seen["P"]


@pytest.mark.parametrize("case", ["seven", "two_groups", "widened"])
def test_striped_tile_equals_jax_a32(monkeypatch, case):
    """``pack_pairs_striped`` at JAX's n_pad gives JAX's tile byte for byte
    (through ``convert.striped_tile_from_jax``), and ``striped_columns``
    is JAX's column order.  ``widened``: 16 pairs of 3,100-3,200 bp make
    JAX pack 15 pairs per group of Sp 25, which it widens to Sp 32 so that
    a group's sublanes are a multiple of 8."""
    if case == "widened":
        rng = np.random.default_rng(5)
        pairs = [(_rnd(rng, int(rng.integers(3100, 3201))), _rnd(rng, 3))
                 for _ in range(16)]
    else:
        pairs = _layout_pairs()[case]
    a32, n_pad, P = _jax_a32(monkeypatch, pairs)
    sp = n_pad // jdiff.LANES
    if case == "widened":
        assert (P, sp) == (15, 32)
    assert n_pad == sp * 128 >= max(len(a) for a, _ in pairs)
    want = convert.striped_tile_from_jax(a32, P, sp)
    tile, b, lens = tdiff.pack_pairs_striped(pairs, "cpu", n_pad=n_pad)
    assert tile.dtype == torch.uint8 and tile.shape == (len(pairs), sp, 128)
    assert tile.is_contiguous() and b.is_contiguous()
    # JAX pads the batch to whole groups by repeating the last pair
    assert torch.equal(want[:len(pairs)], tile)
    assert all(torch.equal(w, tile[-1]) for w in want[len(pairs):])
    assert lens.tolist() == [[len(a), len(b_)] for a, b_ in pairs]
    col = np.arange(n_pad, dtype=np.int32).reshape(128, sp).T.reshape(-1)
    assert np.array_equal(tdiff.striped_columns(n_pad), col)


def test_striped_tile_conversion():
    rng = np.random.default_rng(9)
    a32 = rng.integers(0, 256, (2 * 3 * 4, 128)).astype(np.int32)
    tiles = convert.striped_tile_from_jax(a32, 3, 4)
    assert tiles.shape == (6, 4, 128) and tiles.dtype == torch.uint8
    assert int(tiles[4, 2, 7]) == a32[4 * 4 + 2, 7]
    with pytest.raises(ValueError):
        convert.striped_tile_from_jax(a32, 5, 4)
    with pytest.raises(ValueError):
        convert.striped_tile_from_jax(a32 + 256, 3, 4)
    with pytest.raises(ValueError):
        tdiff.striped_columns(100)
    with pytest.raises(ValueError):
        tdiff.pack_pairs_striped([(_rnd(rng, 300), _rnd(rng, 5))], "cpu",
                                 n_pad=256)


@pytest.mark.parametrize("params", [P0, (1, -1, -1, 0), (5, -4, -1, -6),
                                    (3, -2, -11, -46)])
def test_scan_rows_striped_equals_scan_rows(params):
    """The striped plain version equals ``psa_scan.scan_rows`` at its own
    width and at wider tiles (a short pair's columns in the first lanes),
    the degenerate 1 x 1 and 129 x 1 pairs included."""
    rng = np.random.default_rng(params[0] + 40)
    pairs = [(_rnd(rng, n), _rnd(rng, m)) for n, m in
             [(1, 1), (7, 300), (300, 7), (513, 700), (129, 1), (260, 255)]]
    a, b, lens = tdiff.pack_pairs(pairs, "cpu")
    want = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], params)[:2]
    for n_pad in (None, 1024, 1152):
        tile, tb_, tl = tdiff.pack_pairs_striped(pairs, "cpu", n_pad=n_pad)
        got = tdiff.scan_rows_striped(tile, tb_, tl, params)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
    with pytest.raises(ValueError):
        tdiff.run_dp_striped(tile, tb_, tl, (0, -1, -1, 0))


def _spy_both(monkeypatch):
    """Record the layout of every JAX ``_psa_diff_call`` and the batch
    size of every port ``run_dp_striped`` call."""
    jax_layouts, port_calls = [], []
    jorig, torig = jdiff._psa_diff_call, tdiff.run_dp_striped

    def jspy(*args, **kw):
        jax_layouts.append(args[10] if len(args) > 10 else kw["layout"])
        return jorig(*args, **kw)

    def tspy(*args, **kw):
        port_calls.append(args[0].shape[0])
        return torig(*args, **kw)

    monkeypatch.setattr(jdiff, "_psa_diff_call", jspy)
    monkeypatch.setattr(tdiff, "run_dp_striped", tspy)
    return jax_layouts, port_calls


@pytest.mark.parametrize("value", ["striped", "packed2"])
def test_layout_variable_matches_jax(monkeypatch, value):
    """``TSTA_PSA_LAYOUT`` through ``psa_align_batch_diff`` and
    ``parallel.batch.align_batch`` of both packages (JAX's batch with its
    kernel route, ``kernel="pallas"``): the same scores and corners, JAX
    on the layout named, the port on the striped DP for ``striped`` only
    (``packed2`` is K1's function)."""
    monkeypatch.delenv("TSTA_DIFF_INT16", raising=False)
    monkeypatch.setenv("TSTA_PSA_LAYOUT", value)
    rng = np.random.default_rng(8)
    pairs = [(_rnd(rng, 300), _rnd(rng, 280)), (_rnd(rng, 120), _rnd(rng, 90)),
             (_rnd(rng, 250), _rnd(rng, 260))]
    jax_layouts, port_calls = _spy_both(monkeypatch)
    js, jc = jdiff.psa_align_batch_diff(pairs, P0)
    ts, tc = tdiff.psa_align_batch_diff(pairs, P0, device="cpu")
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))
    params = AlignParams()
    want = [(r.score, r.last) for r in jbatch.align_batch(
        pairs, params, kernel="pallas")]
    got = [(r.score, r.last) for r in tbatch.align_batch(pairs, params,
                                                         device="cpu")]
    assert got == want
    assert jax_layouts and set(jax_layouts) == {value}
    n_calls = len(jax_layouts)   # one per call, one per batch bucket
    assert len(port_calls) == (n_calls if value == "striped" else 0)
    # unset, JAX's default layout and the port's K1
    monkeypatch.delenv("TSTA_PSA_LAYOUT")
    assert np.array_equal(tdiff.psa_align_batch_diff(pairs, P0,
                                                     device="cpu")[0], ts)
    jdiff.psa_align_batch_diff(pairs, P0)
    assert jax_layouts[-1] == "packed" and len(port_calls) == (
        n_calls if value == "striped" else 0)


def test_layout_variable_in_batch_cli(monkeypatch, tmp_path, capsys):
    """``TSTA_PSA_LAYOUT=striped tsta-torch batch`` writes the default
    run's scores TSV through the striped DP, and JSON with the launch
    counters (all 0 on the CPU)."""
    from tsta_tpu_torch import cli
    rng = np.random.default_rng(14)
    rows = []
    for k, (n, m) in enumerate([(300, 280), (90, 120), (500, 510)]):
        for side, ln in (("a", n), ("b", m)):
            (tmp_path / ("%d%s.fa" % (k, side))).write_bytes(
                b">s\n" + _rnd(rng, ln).tobytes() + b"\n")
        rows.append("p%d\t%s/%da.fa\t%s/%db.fa\n" % (k, tmp_path, k,
                                                     tmp_path, k))
    (tmp_path / "m.tsv").write_text("".join(rows))
    argv = ["batch", "--device", "cpu", "--pairs", str(tmp_path / "m.tsv"),
            "--scores"]
    _, port_calls = _spy_both(monkeypatch)
    monkeypatch.delenv("TSTA_DIFF_INT16", raising=False)
    monkeypatch.delenv("TSTA_PSA_LAYOUT", raising=False)
    assert cli.main(argv + [str(tmp_path / "d.tsv")]) == 0
    capsys.readouterr()
    assert port_calls == []
    monkeypatch.setenv("TSTA_PSA_LAYOUT", "striped")
    assert cli.main(argv + [str(tmp_path / "s.tsv")]) == 0
    js = json.loads(capsys.readouterr().out)
    assert js["pairs"] == 3 and set(js["launches"].values()) == {0}
    assert len(port_calls) >= 1
    assert (tmp_path / "s.tsv").read_text() == \
        (tmp_path / "d.tsv").read_text()


def test_layout_keyword_and_int16():
    """``layout=`` overrides the variable; ``use_int16`` forces the
    packed layout in both packages; every layout gives K1's numbers."""
    rng = np.random.default_rng(12)
    pairs = [(_rnd(rng, 200), _rnd(rng, 190)), (_rnd(rng, 60), _rnd(rng, 70))]
    want = tdiff.psa_align_batch_diff(pairs, P0, layout="packed",
                                      device="cpu")
    for layout in ("striped", "packed2", "anything"):
        for use_int16 in (False, True):
            got = tdiff.psa_align_batch_diff(pairs, P0, layout=layout,
                                             use_int16=use_int16,
                                             device="cpu")
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _pair2_group(lengths, seed=91):
    """A traced group as JAX's ``test_pair2_walk_matches_default`` makes
    it (similar pairs, ~5% substituted, ~3% deleted): JAX's word plane and
    the (P, 2) lengths."""
    rng = np.random.default_rng(seed)
    pairs = []
    for ln in lengths:
        a = _rnd(rng, ln)
        b = a.copy()
        idx = rng.integers(0, ln, ln // 20)
        b[idx] = _rnd(rng, len(idx))
        b = np.delete(b, rng.integers(0, ln, ln // 30))
        pairs.append((a, b))
    P = len(pairs)
    n_pad = max(jdiff._traced_n_pad(len(a)) for a, _ in pairs)
    m_pad = -(-max(len(b) for _, b in pairs) // jdiff.T_R) * jdiff.T_R
    Rp = n_pad // jdiff.LANES
    a8 = np.full((P, n_pad), jdiff.A_PAD, np.uint8)
    brows8 = np.full((m_pad, P), jdiff.B_PAD, np.uint8)
    for k, (a, b) in enumerate(pairs):
        a8[k, :len(a)] = a
        brows8[:len(b), k] = b
    nm = np.array([[len(a), len(b)] for a, b in pairs], np.int32)
    _, _, plane = jdiff._psa_diff_traced_call(
        jnp.asarray(a8.reshape(P * Rp, jdiff.LANES).astype(np.int32)),
        jnp.asarray(brows8.astype(np.int32)), jnp.asarray(nm),
        n_pad, m_pad, P, P0)
    return plane, nm, Rp


@pytest.mark.parametrize("lengths,pairs_walked", [
    ((512, 512, 480, 200), True),   # JAX's P = 4 group, uneven walks
    ((512, 480, 200), False),       # P = 3: the default walk in both
])
def test_pair2_walk_matches_jax(monkeypatch, lengths, pairs_walked):
    """``walk_packed(pair2=True)`` against JAX's
    ``_decode_moves_banded_packed(pair2=True)`` and its default walk: the
    same decoded moves and counts; JAX's two-pair kernel traced only for
    an even P, and the port's gate (``uses_pair2``) the same."""
    plane, nm, Rp = _pair2_group(lengths)
    traced = []
    orig = jtb._walk_kernel_packed_pair2

    def spy(*args, **kw):
        traced.append(True)
        return orig(*args, **kw)

    monkeypatch.setattr(jtb, "_walk_kernel_packed_pair2", spy)
    jtb._decode_moves_banded_packed.clear_cache()   # so that it traces anew
    nm_d = jnp.asarray(nm)
    wp, cp = map(np.asarray, jtb._decode_moves_banded_packed(
        plane, nm_d, Rp, True, pair2=True))
    assert bool(traced) == pairs_walked
    wr, cr = map(np.asarray, jtb._decode_moves_banded_packed(plane, nm_d, Rp,
                                                             True))
    P = len(lengths)
    assert ttb.uses_pair2(P, True) == pairs_walked
    tplane = convert.plane_from_jax(plane, P)
    gw, gc = ttb.walk_packed(tplane, torch.from_numpy(nm), pair2=True)
    dw, dc = ttb.walk_packed(tplane, torch.from_numpy(nm))
    assert torch.equal(gw, dw) and torch.equal(gc, dc)
    assert gc.tolist() == cp.tolist() == cr.tolist()
    for k in range(P):   # decoded payloads, not JAX's unwritten tail words
        moves = ttb.unpack_moves(gw[k].numpy(), int(gc[k]))
        assert np.array_equal(moves, jtb.unpack_moves(wp[k], cp[k]))
        assert np.array_equal(moves, jtb.unpack_moves(wr[k], cr[k]))


def test_pair2_gate():
    assert [ttb.uses_pair2(P, True) for P in range(1, 7)] == [
        False, True, False, True, False, True]
    assert not any(ttb.uses_pair2(P, False) for P in range(1, 7))
