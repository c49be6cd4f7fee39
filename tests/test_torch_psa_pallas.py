"""The port's round-1 PSA (tsta_tpu_torch.ops.psa_pallas, plain versions on
the CPU) against the JAX package's round-1 kernels in interpret mode, for
parameter sets with M <= 0: the single-pair DP's scores, corners and every
plane byte (padding included, through convert.r1_plane_from_jax), the
score-only batch and short-pair batch, the routers' choices, the walk
move for move, the traced chain, the chunked path and the CLI.  Exact
integer equality throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu import cli as jcli
from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu.ops import traceback as jtb
from tsta_tpu.parallel import batch as jbatch
from tsta_tpu_torch import convert, device
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.models import psa as tpsa
from tsta_tpu_torch.ops import psa_chunked, psa_diff, psa_scan
from tsta_tpu_torch.ops import psa_pallas as tpallas
from tsta_tpu_torch.ops import traceback as tb
from tsta_tpu_torch.parallel import batch as tbatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDIT = (0, -1, -1, 0)   # edit distance: the corner is minus the Levenshtein
ROUND1 = [EDIT, (0, -1, -1, -1), (-1, -3, -2, -1), (-2, -1, -1, 0)]
DIRECT = ROUND1 + [(2, -5, -2, -4)]


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _similar(rng, n, subs, dels, ins):
    a = _rnd(rng, n)
    b = a.copy()
    b[rng.integers(0, n, subs)] = _rnd(rng, subs)
    b = np.delete(b, rng.integers(0, n, dels))
    return a, np.insert(b, rng.integers(0, len(b), ins), _rnd(rng, ins))


def _padded(a, b):
    """``a``/``b`` at round-1 padding, as ``psa_pallas.psa_align`` lays
    them out for ``_psa_pallas``."""
    n_pad = -(-len(a) // 128) * 128
    m_pad = -(-len(b) // 256) * 256
    ap = np.full(n_pad, jscan.A_PAD, np.uint8)
    ap[:len(a)] = a
    bp = np.full(m_pad, jscan.B_PAD, np.uint8)
    bp[:len(b)] = b
    return (jnp.asarray(ap.astype(np.int32).reshape(-1, 128)),
            jnp.asarray(bp.astype(np.int32).reshape(-1, 1)),
            jnp.asarray([[len(a), len(b)]], np.int32), n_pad, m_pad)


@pytest.mark.parametrize("params", DIRECT)
def test_single_pair_matches_jax(params):
    """Q2-13: score, corner and the three planes of the real cells, and
    score-only, against ``psa_pallas.psa_align``; the padded code plane
    against ``_psa_pallas(traced=True)``, every byte."""
    rng = np.random.default_rng(31 + sum(abs(v) for v in params))
    a, b = _similar(rng, 420, 50, 20, 12)
    want = jpallas.psa_align(a, b, params, traced=True)
    got = tpallas.psa_align(a, b, params, traced=True, device="cpu")
    assert (got.score, got.last) == (int(want.score), int(want.last))
    for name in ("back", "fback", "eback"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    ws = jpallas.psa_align(a, b, params)
    assert tpallas.psa_align(a, b, params, device="cpu") == (
        int(ws.score), int(ws.last), None, None, None)
    jscore, jcorner, _, jplane = jpallas._psa_pallas(*_padded(a, b), params,
                                                     True)
    score, corner, plane, nm = tpallas.dp_pair(a, b, params, True, "cpu")
    assert (int(score), int(corner)) == (int(jscore[0, 0]),
                                         int(jcorner[0, 0]))
    assert plane.shape == (512, 512) and nm.tolist() == [[420, len(b)]]
    assert torch.equal(plane, convert.r1_plane_from_jax(jplane))


def test_r1_plane_conversion():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 27, (8, 3, 128)).astype(np.int8)
    plane = convert.r1_plane_from_jax(codes)
    assert plane.dtype == torch.uint8 and plane.shape == (8, 384)
    assert plane[5, 2 * 128 + 7] == codes[5, 2, 7]
    with pytest.raises(ValueError):
        convert.r1_plane_from_jax(codes.astype(np.int32))
    with pytest.raises(ValueError):
        convert.r1_plane_from_jax(codes[:, :, :64])


@pytest.mark.parametrize("params", ROUND1)
@pytest.mark.parametrize("shape", ["one_pair", "wide"])
def test_score_batch_kernel_matches_jax(params, shape):
    """Q2-14 (K1): one pair, and pairs with n of 2,100-2,400 (R > 16),
    against ``psa_pallas.psa_align_batch``."""
    rng = np.random.default_rng(53)
    if shape == "one_pair":
        pairs = [_similar(rng, 600, 60, 15, 9)]
    else:
        pairs = [(_rnd(rng, int(rng.integers(2100, 2401))),
                  _rnd(rng, int(rng.integers(100, 300)))) for _ in range(3)]
    assert tpallas.batch_route(pairs, params) == "batch"
    js, jc = jpallas.psa_align_batch(pairs, params)
    ts, tc = tpallas.psa_align_batch(pairs, params, device="cpu")
    assert ts.dtype == tc.dtype == np.int32
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))


@pytest.mark.parametrize("params", DIRECT)
def test_short_batch_matches_jax(params):
    """Q2-15: nine mixed pairs of 20-1,400 bp against
    ``psa_align_batch_packed``."""
    rng = np.random.default_rng(12)
    pairs = [(_rnd(rng, int(rng.integers(20, 1400))),
              _rnd(rng, int(rng.integers(20, 1400)))) for _ in range(9)]
    js, jc = jpallas.psa_align_batch_packed(pairs, params)
    ts, tc = tpallas.psa_align_batch_packed(pairs, params, device="cpu")
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))
    wide = pairs + [(_rnd(rng, 2049), pairs[0][1])]
    with pytest.raises(ValueError):
        tpallas.psa_align_batch_packed(wide, params, device="cpu")


def test_batch_routes_match_jax(monkeypatch):
    """Over a grid of (B, n_max, params) the port's score router picks the
    kernel the JAX router does: the packed kernel for M > 0, the
    short-pair one for two or more pairs of at most PACK_RMAX segments,
    the batch kernel otherwise."""
    picked = {}

    def spy(side, route, out):
        def fn(*args, **kw):
            picked[side] = route
            return out, out
        return fn

    zeros = np.zeros(5, np.int32)
    monkeypatch.setattr(jdiff, "psa_align_batch_diff",
                        spy("jax", "packed", zeros))
    monkeypatch.setattr(jpallas, "psa_align_batch_packed",
                        spy("jax", "short", zeros))
    monkeypatch.setattr(jpallas, "_psa_pallas_batch",
                        spy("jax", "batch", zeros.reshape(5, 1)))
    monkeypatch.setattr(psa_diff, "psa_align_batch_diff",
                        spy("port", "packed", zeros))
    monkeypatch.setattr(tpallas, "psa_align_batch_packed",
                        spy("port", "short", zeros))
    monkeypatch.setattr(psa_diff, "run_dp",
                        spy("port", "batch", torch.from_numpy(zeros)))
    rng = np.random.default_rng(0)
    routes = set()
    for B in (1, 2, 5):
        for n_max in (100, 2048, 2049, 3000):
            pairs = [(_rnd(rng, n_max - 7 * k), _rnd(rng, 90))
                     for k in range(B)]
            for params in ((2, -5, -2, -4), EDIT, (-2, -1, -1, 0)):
                picked.clear()
                jpallas.psa_align_batch(pairs, params)
                tpallas.psa_align_batch(pairs, params, device="cpu")
                want = picked["jax"]
                assert picked["port"] == want, (B, n_max, params)
                assert tpallas.batch_route(pairs, params) == want
                routes.add(want)
    assert routes == {"packed", "short", "batch"}
    with pytest.raises(ValueError):
        tpallas.psa_align_batch(pairs, (2, 1, -1, -3), device="cpu")


@pytest.mark.parametrize("params", ROUND1)
def test_walk_matches_jax_walks(params):
    """Q2-16: the walk (``traceback.walk_packed`` at P = 1) over the
    round-1 plane equals the banded TPU walk ``_decode_moves_banded``
    (interpret mode, where its gate lets it run: m >= 64, n_pad % 512 ==
    0) and the XLA walk ``_decode_moves``, move for move."""
    rng = np.random.default_rng(71)
    a, b = _similar(rng, 500, 40, 25, 10)
    a, b = a[:500], b[:230]
    _, _, plane, nm = tpallas.dp_pair(a, b, params, True, "cpu")
    words, counts = tb.walk_packed(plane[None], nm)
    got = tb.unpack_moves(words[0].numpy(), int(counts[0]))
    jplane = jnp.asarray(plane.numpy().view(np.int8))
    mv1, c1 = jtb._decode_moves(jplane, len(b), len(a))
    mv2, c2 = jtb._decode_moves_banded(jplane, len(b), len(a), n_stride=512)
    assert len(got) == int(c1) == int(c2) >= len(a)
    assert np.array_equal(got, np.asarray(mv1)[:int(c1)])
    assert np.array_equal(got, np.asarray(mv2)[:int(c2)])


@pytest.mark.parametrize("params", ROUND1)
def test_traced_device_matches_jax(params):
    """The traced chain (Q2-13 traced, then the walk) through
    ``psa_align_traced_device``, and a traced batch through
    ``align_batch_traced_device``, against the JAX package's."""
    rng = np.random.default_rng(83)
    a, b = _similar(rng, 380, 40, 20, 20)
    want = jpallas.psa_align_traced_device(a, b, params)
    got = tpallas.psa_align_traced_device(a, b, params, device="cpu")
    assert got == want
    assert tb.score_alignment(got[2].a_row, got[2].b_row,
                              AlignParams(*params)) == got[1]
    seqs = [(b"ACGTTACG", b"ACGTACG"), (b"A", b"T"),
            (bytes(_rnd(rng, 300)), bytes(_rnd(rng, 410)))]
    ap = AlignParams(*params)
    assert (tbatch.align_batch_traced_device(seqs, ap, device="cpu")
            == jbatch.align_batch_traced_device(seqs, ap))
    with pytest.raises(ValueError):
        tpallas.psa_align_traced_device(a, b, (0, 0, -1, -1), device="cpu")


@pytest.mark.parametrize("params", [EDIT, (-2, -1, -1, 0)])
def test_chunked_round1_pair_matches_jax(params):
    """A pair with M <= 0 in row-chunks of T_R against
    ``psa_pallas.psa_align_traced_chunked``, and against the unchunked
    chain."""
    rng = np.random.default_rng(7)
    a = _rnd(rng, 600)
    b = np.concatenate([a[:200], _rnd(rng, 350), a[200:]])
    want = jpallas.psa_align_traced_chunked(a, b, params, mc=jpallas.T_R)
    got = psa_chunked.psa_align_traced_chunked(a, b, params, mc=tpallas.T_R,
                                               device="cpu")
    assert got == want
    assert psa_chunked.last_clock.chunks == 4
    assert got == tpallas.psa_align_traced_device(a, b, params, device="cpu")


def test_traced_router_chunks_over_half_the_budget(monkeypatch):
    """A traced pair whose m_pad * n_pad is over half the budget runs in
    chunks (JAX's ``_traced_submit`` rule), at the limit it does not."""
    rng = np.random.default_rng(4)
    a, b = _similar(rng, 300, 30, 10, 5)   # n_pad 384, m_pad 512
    want = jpallas.psa_align_traced_device(a, b, EDIT)
    for budget, chunked in ((2 * 384 * 512 - 2, True), (2 * 384 * 512, False)):
        monkeypatch.setattr(device, "CPU_BUDGET", budget)
        psa_chunked.last_clock = None
        got = tpallas.psa_align_traced_device(a, b, EDIT, device="cpu")
        assert got == want
        assert (psa_chunked.last_clock is not None) == chunked


def _jax_cli(argv, capsys):
    """``python -m tsta_tpu`` with ``argv``, in this process: its stdout."""
    capsys.readouterr()
    assert jcli.main(argv) == 0
    return capsys.readouterr().out


EDIT_FLAGS = ["-M", "0", "-X", "-1", "-E", "-1", "-O", "0"]


@pytest.mark.parametrize("params", ROUND1)
def test_cli_matches_jax_cli(params, tmp_path, capsys):
    """``tsta-torch psa`` (traced and ``--notrace``) and ``batch --traced``
    on ``tests/golden/psa_small3`` give the output bytes and stdout of
    ``python -m tsta_tpu psa`` with the same flags."""
    from tsta_tpu_torch import cli as tcli
    d = os.path.join(ROOT, "tests", "golden", "psa_small3")
    fa, fb = os.path.join(d, "a.fa"), os.path.join(d, "b.fa")
    flags = [x for k, v in zip("MXEO", params) for x in ("-" + k, str(v))]
    jout = tmp_path / "j.txt"
    want = _jax_cli(["psa", "-1", fa, "-2", fb, "-o", str(jout)] + flags,
                    capsys)
    tout = tmp_path / "t.txt"
    assert tcli.main(["psa", "--device", "cpu", "-1", fa, "-2", fb, "-o",
                      str(tout)] + flags) == 0
    assert capsys.readouterr().out == want
    assert tout.read_bytes() == jout.read_bytes()
    assert tcli.main(["psa", "--device", "cpu", "--notrace", "-1", fa, "-2",
                      fb] + flags) == 0
    assert capsys.readouterr().out == want
    manifest = tmp_path / "pairs.tsv"
    manifest.write_text("p0\t%s\t%s\n" % (fa, fb))
    assert tcli.main(["batch", "--device", "cpu", "--pairs", str(manifest),
                      "--traced", "--out-dir", str(tmp_path / "alns")]
                     + flags) == 0
    assert (tmp_path / "alns" / "p0.txt").read_bytes() == jout.read_bytes()
    capsys.readouterr()
    # score-only batches refuse M <= 0, as the JAX package's do
    assert tcli.main(["batch", "--device", "cpu", "--pairs", str(manifest)]
                     + flags) == 1


def test_cli_chunks_edit_scoring(monkeypatch, tmp_path, capsys):
    """With a CPU budget the pair's plane does not fit in half of,
    ``tsta-torch psa --device cpu -M 0 -X -1 -E -1 -O 0`` runs in
    row-chunks and gives the JAX CLI's bytes and stdout."""
    from tsta_tpu_torch import cli as tcli
    d = os.path.join(ROOT, "tests", "golden", "psa_small3")
    fa, fb = os.path.join(d, "a.fa"), os.path.join(d, "b.fa")
    jout = tmp_path / "j.txt"
    want = _jax_cli(["psa", "-1", fa, "-2", fb, "-o", str(jout)]
                    + EDIT_FLAGS, capsys)
    monkeypatch.setattr(device, "CPU_BUDGET", 1 << 16)
    psa_chunked.last_clock = None
    out = tmp_path / "o.txt"
    assert tcli.main(["psa", "--device", "cpu", "-1", fa, "-2", fb, "-o",
                      str(out)] + EDIT_FLAGS) == 0
    assert capsys.readouterr().out == want
    assert out.read_bytes() == jout.read_bytes()
    assert psa_chunked.last_clock.chunks >= 2


def test_model_routes(monkeypatch):
    """``models.psa.align_pair``: ``auto`` takes the round-1 routes for
    M <= 0 and the ``psa_scan`` oracle for X >= 0 or E >= 0, each equal
    to the JAX package's ``align_pair``; ``cuda`` refuses a CPU device."""
    from tsta_tpu.config import AlignParams as JParams
    from tsta_tpu.models import psa as jpsa
    seq1, seq2 = b"ACGTTGCAACGTAGGCT" * 7, b"ACGTGCAACGTTAGGT" * 7
    calls = []
    monkeypatch.setattr(psa_scan, "psa_align",
                        lambda *a, **k: calls.append(1) or
                        _ORACLE(*a, **k))
    for params, oracle in ((EDIT, False), ((-2, -1, -1, 0), False),
                           ((2, 1, -2, -4), True), ((1, -1, 0, -2), True)):
        for traced in (True, False):
            calls.clear()
            want = jpsa.align_pair(seq1, seq2, JParams(*params),
                                   traced=traced, kernel="scan")
            got = tpsa.align_pair(seq1, seq2, AlignParams(*params),
                                  traced=traced, device="cpu")
            assert got == tpsa.PsaOutput(int(want.score), int(want.corner),
                                         want.swapped, want.a_row,
                                         want.b_row)
            assert bool(calls) == oracle, (params, traced)
    with pytest.raises(ValueError):
        tpsa.align_pair(seq1, seq2, AlignParams(*EDIT), kernel="cuda",
                        device="cpu")


_ORACLE = psa_scan.psa_align


def test_plain_calls_count_only_card_tensors():
    """The plain DP and walks run on CPU tensors without touching the
    counter of plain calls on a card."""
    n0 = psa_scan.plain_calls
    rng = np.random.default_rng(1)
    a, b = _similar(rng, 200, 20, 5, 5)
    tpallas.psa_align_traced_device(a, b, EDIT, device="cpu")
    psa_chunked.psa_align_traced_chunked(a, b, EDIT, mc=256, device="cpu")
    assert psa_scan.plain_calls == n0
