"""The port's mesh routes against the JAX package on the CPU, with zero
tolerance; the twin of ``tests/test_parallel.py``.

JAX runs its meshes on the eight virtual CPU devices of
``tests/conftest.py``; the port runs the same shapes on a virtual mesh of
the CPU repeated, which takes the plain versions: a batch's ``data``
shares each on its row's device, a POA round's ``seq`` windows as the
column-window wavefront (``parallel/msa_longseq.py``).  Scores, corners,
traceback planes, move lists, sink scores, word planes, align maps, rows,
consensus and ``add_len`` are compared exactly."""

import os

import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams
from tsta_tpu.models.poa_graph import PoaGraph as JPoaGraph
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.parallel import batch as jbatch
from tsta_tpu.parallel import mesh as jmeshlib
from tsta_tpu.parallel import msa_longseq as jlongseq
from tsta_tpu_torch import cli as tcli
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.ops import msa_native, psa_diff
from tsta_tpu_torch.parallel import batch, msa_longseq
from tsta_tpu_torch.parallel import mesh as meshlib

CPU = torch.device("cpu")
P0 = (2, -5, -2, -4)


def _mesh(data, seq):
    return meshlib.make_mesh(data, seq, devices=[CPU] * (data * seq))


@pytest.fixture(scope="module")
def mesh24():
    return _mesh(2, 4)


@pytest.fixture(scope="module")
def mesh81():
    return _mesh(8, 1)


@pytest.fixture(scope="module")
def jmesh24():
    return jmeshlib.make_mesh(data=2, seq=4)


@pytest.fixture(scope="module")
def jmesh81():
    return jmeshlib.make_mesh(data=8, seq=1)


def _pairs(seed, count, lo, hi, swapped=False):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        m = int(rng.integers(lo, n + 1 if swapped else hi))
        pairs.append((rng.integers(65, 69, n).astype(np.uint8),
                      rng.integers(65, 69, m).astype(np.uint8)))
    return pairs


def _reads(seed, n_reads, length, rate=0.1):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    first = bases[rng.integers(0, 4, length)]
    seqs = [first.tobytes()]
    for _ in range(n_reads - 1):
        s = first.copy()
        hit = rng.random(length) < rate
        s[hit] = bases[rng.integers(0, 4, hit.sum())]
        seqs.append(s.tobytes())
    return seqs


def test_mesh_shapes(mesh24):
    assert mesh24.shape == {"data": 2, "seq": 4}
    assert meshlib.make_mesh(data=None, seq=2,
                             devices=[CPU] * 8).shape == {"data": 4,
                                                          "seq": 2}
    with pytest.raises(ValueError, match="mesh 3x3 needs 9 devices, have 8"):
        meshlib.make_mesh(3, 3, devices=[CPU] * 8)


def test_data_sharding_and_replicated(mesh81, mesh24):
    """JAX's P("data") split: contiguous shares of ceil(n / rows), the
    last ones short or empty; replicated puts a tensor on every device."""
    shares = meshlib.data_sharding(mesh81, 11)
    assert [(i, j) for i, j, _ in shares] == [
        (0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 11), (11, 11),
        (11, 11)]
    assert all(d == CPU for _, _, d in shares)
    assert [(i, j) for i, j, _ in meshlib.data_sharding(mesh24, 5)] == [
        (0, 3), (3, 5)]
    t = torch.arange(4)
    reps = meshlib.replicated(mesh24, t)
    assert len(reps) == 8 and all(torch.equal(r, t) for r in reps)
    assert meshlib.cli_mesh("1x1", "cpu") is None
    assert meshlib.cli_mesh("2X3", "cpu").shape == {"data": 2, "seq": 3}


def test_batch_sharded_matches_jax(mesh81, jmesh81):
    pairs = _pairs(11, 11, 20, 300)   # deliberately not a multiple of 8
    got = batch.align_batch(pairs, AlignParams(), mesh=mesh81)
    want = jbatch.align_batch(pairs, AlignParams(), mesh=jmesh81)
    plain = batch.align_batch(pairs, AlignParams(), device="cpu")
    assert [(r.score, r.last) for r in got] == [
        (int(r.score), int(r.last)) for r in want]
    assert [(r.score, r.last) for r in got] == [(r.score, r.last)
                                               for r in plain]


def test_batch_traced_planes(mesh81, jmesh81):
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(65, 69, 100).astype(np.uint8),
              rng.integers(65, 69, 80).astype(np.uint8)) for _ in range(4)]
    got = batch.align_batch(pairs, AlignParams(), traced=True, mesh=mesh81)
    want = jbatch.align_batch(pairs, AlignParams(), traced=True,
                              mesh=jmesh81)
    for g, w in zip(got, want):
        assert (g.score, g.last) == (int(w.score), int(w.last))
        for name in ("back", "fback", "eback"):
            assert np.array_equal(getattr(g, name).numpy(),
                                  np.asarray(getattr(w, name)))


@pytest.mark.parametrize("which", ["81", "24"])
def test_diff_kernel_sharded_matches_jax(which, mesh81, mesh24, jmesh81,
                                         jmesh24):
    mesh, jmesh = (mesh81, jmesh81) if which == "81" else (mesh24, jmesh24)
    pairs = _pairs(21, 13, 30, 400)   # not a multiple of 8 groups
    s1, c1 = psa_diff.psa_align_batch_diff(pairs, P0, device="cpu")
    s2, c2 = psa_diff.psa_align_batch_diff(pairs, P0, mesh=mesh)
    js, jc = jdiff.psa_align_batch_diff(pairs, P0, mesh=jmesh)
    assert np.array_equal(s2, s1) and np.array_equal(c2, c1)
    assert np.array_equal(s2, np.asarray(js))
    assert np.array_equal(c2, np.asarray(jc))


def test_diff_int16_and_striped_sharded(mesh24):
    """The opt-in score-only routes take their shares the same way."""
    pairs = _pairs(23, 7, 30, 300)
    s1, c1 = psa_diff.psa_align_batch_diff(pairs, P0, device="cpu")
    for kw in ({"use_int16": True}, {"layout": "striped"}):
        s2, c2 = psa_diff.psa_align_batch_diff(pairs, P0, mesh=mesh24, **kw)
        assert np.array_equal(s2, s1) and np.array_equal(c2, c1)


def test_traced_packed_sharded_matches_jax(mesh24, jmesh24):
    pairs = _pairs(41, 5, 60, 260, swapped=True)
    ref = psa_diff.psa_align_batch_traced_packed(pairs, P0, device="cpu")
    shd = psa_diff.psa_align_batch_traced_packed(pairs, P0, mesh=mesh24)
    want = jdiff.psa_align_batch_traced_packed(pairs, P0, mesh=jmesh24)
    assert shd == ref
    assert shd == want


def test_traced_sharded_via_batch_api(mesh81, jmesh81):
    rng = np.random.default_rng(43)
    pairs = [(rng.integers(65, 69, 150).astype(np.uint8),
              rng.integers(65, 69, 120).astype(np.uint8)) for _ in range(3)]
    params = AlignParams()
    ref = batch.align_batch_traced_device(pairs, params, device="cpu")
    shd = batch.align_batch_traced_device(pairs, params, mesh=mesh81)
    want = jbatch.align_batch_traced_device(pairs, params, mesh=jmesh81)
    assert shd == ref == want
    # the round-1 chain (M <= 0) takes its shares pair by pair
    edit = AlignParams(0, -1, -1, 0)
    assert (batch.align_batch_traced_device(pairs, edit, mesh=mesh81)
            == jbatch.align_batch_traced_device(pairs, edit))


def test_traced_sharded_chunks_over_budget(mesh24, jmesh24, monkeypatch):
    """``TSTA_HBM_BUDGET_GB`` cuts a sharded traced batch in both packages:
    at 0.0016 JAX into sequential shard_map calls and the port each
    share's groups by the budget it reads (``device_budget``); at 0.0001
    the port's pairs whose plane passes it run chunked inside their
    share (``psa_chunked``).  Values equal the unconstrained run's."""
    from tsta_tpu_torch.ops import psa_chunked
    pairs = _pairs(47, 24, 60, 260, swapped=True)
    ref = psa_diff.psa_align_batch_traced_packed(pairs, P0, device="cpu")
    budgets, chunked = [], []
    orig_groups = psa_diff._traced_groups
    orig_chunked = psa_chunked.psa_align_traced_chunked

    def spy_groups(n_real, m_real, budget):
        budgets.append(budget)
        return orig_groups(n_real, m_real, budget)

    def spy_chunked(*args, **kw):
        chunked.append(1)
        return orig_chunked(*args, **kw)
    monkeypatch.setattr(psa_diff, "_traced_groups", spy_groups)
    monkeypatch.setattr(psa_chunked, "psa_align_traced_chunked", spy_chunked)
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", "0.0016")
    shd = psa_diff.psa_align_batch_traced_packed(pairs, P0, mesh=mesh24)
    want = jdiff.psa_align_batch_traced_packed(pairs, P0, mesh=jmesh24)
    assert budgets == [int(0.0016 * 2 ** 30)] * 2
    assert shd == ref == want
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", "0.0001")
    assert psa_diff.psa_align_batch_traced_packed(pairs, P0,
                                                  mesh=mesh24) == ref
    assert budgets[2:] == [int(0.0001 * 2 ** 30)] * 2 and len(chunked) > 1


def _words_fields(words):
    w = words.astype(np.int64) & 0xFFFF
    return w & 15, (w >> 4) & 63, (w >> 10) & 63


def _grown(seed, length, rounds=2):
    """The same grown graph in both packages (JAX's scan-engine rounds,
    each delta applied to both), and a further read."""
    seqs = _reads(seed, rounds + 2, length)
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    jg = JPoaGraph.from_sequence(seqs[0], len(seqs))
    for k in range(1, rounds + 1):
        sc, pk, hp, ep, preds, order = jnative._scan_engine_round(
            jg, seqs[k], AlignParams())
        sinks = set(jg.sinks())
        best = max((i for i, v in enumerate(order) if v in sinks),
                   key=lambda i: sc[i])
        align = jnative._walk_host(pk, hp, ep, preds, best, len(seqs[k]))
        for gr in (g, jg):
            gr.apply_delta(seqs[k], k, order, align)
            gr.toposort()
    assert g.max_in_degree() >= 2
    return g, jg, seqs[-1]


@pytest.mark.parametrize("rows", [32, None])
def test_sharded_round_matches_jax_round_dp(mesh24, jmesh24, rows):
    """The wavefront's sink scores and word planes equal JAX's
    ``msa_longseq.round_dp`` on the (2, 4) mesh, at 32-row chunks (preds
    many chunks back) and at the default plan."""
    g, jg, seq = _grown(3, 330)
    sink, words, order, preds = msa_longseq.round_dp(
        g, seq, AlignParams(), mesh24, rows_per_chunk=rows)
    jsink, jpk, jhp, jep, jorder, jpreds = jlongseq.round_dp(
        jg, seq, AlignParams(), jmesh24)
    assert order == jorder
    n_nodes, n = len(order), words.shape[1]
    assert n == jpk.shape[1] == msa_longseq.mesh_columns(len(seq), 4)
    C = n // 4
    cols = -(-len(seq) // C) * C     # the windows that hold the read
    r = slice(0, n_nodes)
    assert np.array_equal(sink[r], np.asarray(jsink)[r])
    flags, hp, ep = _words_fields(words[r, :cols])
    assert np.array_equal(flags, jpk[r, :cols].astype(np.int64))
    assert np.array_equal(hp, jhp[r, :cols].astype(np.int64))
    assert np.array_equal(ep, jep[r, :cols].astype(np.int64))


def _same(got, want):
    assert got.round_scores == want.round_scores
    assert got.rows == want.rows
    assert got.consensus == want.consensus
    assert got.add_len == want.add_len
    assert got.graph_len == want.graph_len


def test_msa_sharded_round_matches_native(mesh24, jmesh24):
    seqs = _reads(31, 4, 250)
    want = jnative.align_seqs(seqs, AlignParams(), mesh=jmesh24)
    _same(msa_native.align_seqs(seqs, AlignParams(), mesh=mesh24), want)
    _same(msa_native.align_seqs(seqs, AlignParams(), device="cpu"), want)


def test_msa_sharded_gap_run_crosses_window_boundary(mesh24, jmesh24):
    """An F gap run across a window boundary decodes as the unsharded
    engine's: the boundary cell's extend mark needs the left window's F
    at its last column (the checkpoint's third value)."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s1 = bases[rng.integers(0, 4, 120)].tobytes()
    s2 = s1[:60] + bases[rng.integers(0, 4, 300)].tobytes() + s1[60:]
    want = jnative.align_seqs([s1, s2], AlignParams(), mesh=jmesh24)
    got = msa_native.align_seqs([s1, s2], AlignParams(), mesh=mesh24)
    _same(got, want)
    _same(got, jnative.align_seqs([s1, s2], AlignParams()))
    stats = []
    g = PoaGraph.from_sequence(s1, 2)
    msa_longseq.wavefront_round(g, s2, AlignParams(), [CPU] * 4,
                                rows_per_chunk=32, stats=stats)
    assert stats[0]["active"] == 4 and stats[0]["chunks"] == 4


def test_window_past_the_budget_raises(mesh24, monkeypatch):
    seqs = _reads(5, 2, 300)
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", "0.00001")
    with pytest.raises(ValueError, match="window 0 .*budget of 0.01 MB"):
        msa_native.align_seqs(seqs, AlignParams(), mesh=mesh24)


def test_mesh_needs_the_native_engine(mesh24):
    from tsta_tpu_torch.models import msa
    seqs = _reads(5, 2, 40)
    with pytest.raises(ValueError, match="requires engine='native'"):
        msa.align_seqs(seqs, AlignParams(), engine="compat", mesh=mesh24)
    out = msa.align_seqs(seqs, AlignParams(), engine="native", mesh=mesh24)
    _same(out, jnative.align_seqs(seqs, AlignParams()))


def test_cli_meshes_on_cpu_match_jax(tmp_path, capsys):
    """``msa --engine native --mesh 1x4`` and ``batch --mesh 4x1`` with
    ``--device cpu``: the JAX CLI's outputs on its virtual mesh."""
    from tsta_tpu import cli as jcli
    seqs = _reads(9, 3, 200)
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, s)
                            for i, s in enumerate(seqs)))
    outs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        out = tmp_path / (name + ".txt")
        assert main(["msa", "--engine", "native", "--mesh", "1x4", "-i",
                     str(fa), "-o", str(out)] + extra) == 0
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    assert tcli.main(["msa", "--mesh", "1x4", "--device", "cpu", "-i",
                      str(fa), "-o", str(tmp_path / "x.txt")]) == 1
    lines = []
    for i, (a, b) in enumerate(_pairs(3, 6, 40, 200)):
        for tag, s in (("a", a), ("b", b)):
            (tmp_path / ("%s%d.fa" % (tag, i))).write_bytes(
                b">s\n" + s.tobytes() + b"\n")
        lines.append("p%d\t%s\t%s" % (i, tmp_path / ("a%d.fa" % i),
                                      tmp_path / ("b%d.fa" % i)))
    man = tmp_path / "pairs.tsv"
    man.write_text("\n".join(lines) + "\n")
    capsys.readouterr()
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        for traced in ([], ["--traced", "--out-dir",
                            str(tmp_path / (name + "_alns"))]):
            assert main(["batch", "--pairs", str(man), "--mesh", "4x1",
                         "--scores", str(tmp_path / (name + ".tsv"))]
                        + traced + extra) == 0
    capsys.readouterr()
    assert (tmp_path / "port.tsv").read_text() == (
        tmp_path / "jax.tsv").read_text()
    for i in range(6):
        assert (tmp_path / "port_alns" / ("p%d.txt" % i)).read_bytes() == (
            tmp_path / "jax_alns" / ("p%d.txt" % i)).read_bytes()
    assert os.path.exists(tmp_path / "port_alns")
