"""The port's POA round against the JAX package on the CPU, with zero
tolerance: the per-round tables and memory plan, the plain round DP
against ``msa_native._round_dp`` and against the Pallas kernel (interpret
mode, through ``convert``), the plain walk against ``msa_pallas._walk``
and ``_walk_banded``, the merge, and the POA word-plane conversion.

Graphs are grown from seeded reads (numpy) through the port's own
rounds, so they hold multi-pred nodes; every comparison covers the real
rows, and the padded columns of each real row."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams
from tsta_tpu.models.poa_graph import PoaGraph
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu.ops import msa_pallas
from tsta_tpu.ops.psa_scan import bucket
from tsta_tpu_torch import convert
from tsta_tpu_torch.device import CPU_BUDGET
from tsta_tpu_torch.ops import _kernels, msa_native, msa_poa

CPU = torch.device("cpu")
CASES = [(0, 150, AlignParams()), (1, 260, AlignParams(3, -2, -1, -6)),
         (2, 200, AlignParams(2, -3, -2, 0))]


def _reads(seed, n_reads, length, div=0.12):
    """A seeded base read and ``n_reads - 1`` copies with ~``div``
    substitutions and ~``div``/8 deletions."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    reads = [base.tobytes()]
    for _ in range(n_reads - 1):
        s = base.copy()
        hit = rng.integers(0, length, int(length * div))
        s[hit] = rng.choice(acgt, hit.size)
        reads.append(np.delete(s, rng.integers(0, length,
                                               int(length * div / 8)))
                     .tobytes())
    return reads


def _grown(seed, length, params, rounds=3):
    """A graph after ``rounds`` port rounds, and a further read."""
    reads = _reads(seed, rounds + 2, length)
    g = PoaGraph.from_sequence(reads[0], len(reads))
    for sno in range(1, rounds + 1):
        packed, order, _ = msa_poa.run_round(g, reads[sno], params, CPU,
                                             "auto", CPU_BUDGET)
        msa_native._finish_round(g, reads[sno], sno, order, packed.numpy(),
                                 [], [], [])
    assert g.max_in_degree() >= 2
    return g, reads[-1]


def _port_round(g, seq, params):
    prep, n, n_real, a, NC, _ = msa_poa.prep_round(g, seq, params,
                                                   CPU_BUDGET)
    assert NC is None
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (predsT, pmaskT, bases.reshape(N), fills, a)]
    words, scores = msa_native.round_dp_plain(*t, n_real, len(order),
                                              params, W)
    return words, scores, prep, n, n_real


def _fields(words):
    w = words.numpy().astype(np.int64) & 0xFFFF
    return w & 0xF, (w >> 4) & 0x3F, (w >> 10) & 0x3F


@pytest.mark.parametrize("seed,length,params", CASES)
def test_prepare_matches_jax(seed, length, params):
    g, _ = _grown(seed, length, params)
    got = msa_poa.prepare(g, params)
    want = msa_pallas._prepare(g, params)
    assert len(got) == len(want) == 9
    for k, (x, y) in enumerate(zip(got, want)):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


_PLANS = [(51200, 51200, 64, None), (100352, 102400, 64, None),
          (1 << 21, 1 << 20, 1 << 18, None), (384, 384, 2, 500_000),
          (384, 384, 2, 300_000), (1024, 768, 16, 2 ** 30 // 400),
          (4096, 2048, 8, 2 ** 30 // 1000)]


@pytest.mark.parametrize("N,n,W,budget", _PLANS)
def test_round_plan_matches_jax(N, n, W, budget, monkeypatch):
    if budget is None:
        monkeypatch.delenv("TSTA_HBM_BUDGET_GB", raising=False)
        budget = CPU_BUDGET
    else:
        monkeypatch.setenv("TSTA_HBM_BUDGET_GB", repr(budget / 2 ** 30))
    jbudget = msa_pallas._hbm_budget()
    assert abs(jbudget - budget) <= 1
    try:
        want = msa_pallas._round_plan(N, n, W)
    except ValueError:
        with pytest.raises(ValueError, match="compat"):
            msa_poa.round_plan(N, n, W, jbudget)
        return
    assert msa_poa.round_plan(N, n, W, jbudget) == want


def test_prep_round_refuses_a_chunked_plan():
    """A round the plan chunks is no longer refused: ``prep_round``
    returns the plan's chunk size and column windows (none: n is not a
    multiple of 1,024), the same tables, and the chunked round runs."""
    g, seq = _grown(0, 600, AlignParams(), rounds=1)
    N, W = msa_poa.prepare(g, AlignParams())[4:7:2]
    NC = msa_poa.round_plan(N, bucket(len(seq)), W, 2_000_000)
    assert NC
    prep, n, n_real, a, nc, nwin = msa_poa.prep_round(g, seq, AlignParams(),
                                                      2_000_000)
    assert (nc, nwin, n % 1024 != 0) == (NC, 0, True)
    assert msa_poa._ckpt_windows(2048) == 2
    assert msa_poa._ckpt_windows(49152) == 8
    assert msa_poa._ckpt_windows(196608) == 8
    packed, _, _ = msa_poa.run_round(g, seq, AlignParams(), CPU, "auto",
                                     2_000_000)
    want, _, _ = msa_poa.run_round(g, seq, AlignParams(), CPU, "auto",
                                   CPU_BUDGET)
    assert torch.equal(packed, want)
    assert msa_poa.round_columns(16384) == 16384
    assert msa_poa.round_columns(16385) == 24576


@pytest.mark.parametrize("seed,length,params", CASES)
def test_plain_round_matches_round_dp(seed, length, params):
    g, seq = _grown(seed, length, params)
    words, scores, prep, n, n_real = _port_round(g, seq, params)
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    (bases, preds, pmask, hm1, valid, N, N_real, max_in, pos,
     order) = jnative._prepare_round(g, params)
    assert order == prep[7] and bucket(n_real) == n
    a = np.zeros((n,), np.uint8)
    a[:n_real] = np.frombuffer(seq, np.uint8)
    ss, packed, hp, ep = (np.asarray(x) for x in jnative._round_dp(
        jnp.asarray(bases), jnp.asarray(preds), jnp.asarray(pmask),
        jnp.asarray(hm1), jnp.asarray(valid), jnp.asarray(a),
        jnp.int32(n_real), p, N, n, max_in))
    flags, h_pred, e_pred = _fields(words)
    r = slice(0, N_real)
    assert np.array_equal(scores.numpy()[r], ss[r])
    assert np.array_equal(flags[r], packed[r].astype(np.int64))
    assert np.array_equal(h_pred[r], hp[r].astype(np.int64))
    assert np.array_equal(e_pred[r], ep[r].astype(np.int64))


@pytest.mark.parametrize("seed,length,params", CASES)
def test_plain_round_and_walks_match_pallas(seed, length, params):
    """The plain round's words equal the Pallas kernel's (interpret
    mode) decoded through ``convert.poa_words_from_jax``; the plain walk
    equals ``_walk`` and the banded ``_walk_banded`` kernel."""
    g, seq = _grown(seed, length, params)
    words, scores, prep, n, n_real = _port_round(g, seq, params)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    jw, js, jorder, jpreds, jn, jn_real = msa_pallas._dispatch_round(
        g, seq, params)
    assert (jorder, jn, jn_real) == (order, n, n_real)
    r = slice(0, len(order))
    assert np.array_equal(convert.poa_words_from_jax(jw)[r], words[r])
    assert np.array_equal(np.asarray(js)[0, r], scores.numpy()[r])

    mask = torch.from_numpy(msa_poa.sink_mask(g, order, N))
    best = msa_poa.best_sink(scores, mask)
    want = msa_pallas._best_and_walk(
        jw, jnp.asarray(preds), js, jnp.asarray(mask.numpy(), jnp.int32),
        jnp.int32(n_real), n)
    assert int(want[0]) == int(best)
    assert msa_pallas._walk_banded_ok(N, max_in, n, n // 128)
    banded = msa_pallas._walk_banded(
        jw, jnp.asarray(predsT),
        jnp.asarray([[n_real, int(best)]], jnp.int32), n)
    got = msa_poa.walk_plain(words, torch.from_numpy(preds), best, n_real)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), np.asarray(want[1]))
    assert np.array_equal(got.numpy(), np.asarray(banded))
    # the port's walk on the JAX plane, through the conversion
    assert torch.equal(msa_poa.walk_plain(convert.poa_words_from_jax(jw),
                                          torch.from_numpy(preds), best,
                                          n_real), got)


def test_wrappers_take_the_plain_versions_on_cpu():
    params = AlignParams()
    g, seq = _grown(3, 180, params)
    words, scores, prep, n, n_real = _port_round(g, seq, params)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep
    before = dict(_kernels.launches)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (predsT, pmaskT, bases.reshape(N), fills)]
    a = torch.zeros((n,), dtype=torch.uint8)
    a[:n_real] = torch.frombuffer(bytearray(seq), dtype=torch.uint8)
    w2, s2 = msa_poa.poa_dp(*t, a, n_real, len(order), params, W)
    assert torch.equal(w2, words) and torch.equal(s2, scores)
    assert w2.dtype == torch.int16 and not w2[len(order):].any()
    best = msa_poa.best_sink(scores, torch.from_numpy(
        msa_poa.sink_mask(g, order, N)))
    pd = torch.from_numpy(preds)
    assert torch.equal(msa_poa.poa_walk(words, pd, best, n_real),
                       msa_poa.walk_plain(words, pd, best, n_real))
    packed = msa_poa.pack_round(scores, msa_poa.walk_plain(
        words, pd, best, n_real), best)
    assert int(packed[0]) == int(best)
    assert int(packed[1]) == int(scores[int(best)])
    assert _kernels.launches == before


def _graph_state(g):
    n = len(g)
    return [g._bases[:n].copy(), g._ndeg[:n].copy(),
            g.preds, g.weights, g._passing[:n].copy(), g.variants]


def _align_rows(kind, g, seq, params):
    n_nodes, n = len(g), len(seq)
    rng = np.random.default_rng(len(seq))
    if kind == "walk":
        packed, order, _ = msa_poa.run_round(g, seq, params, CPU, "auto",
                                             CPU_BUDGET)
        return packed.numpy()[2:2 + n]
    if kind == "hot_column":   # one column hit 12 times: the Python path
        rows = np.full(n, -1, np.int64)
        rows[rng.choice(n, 12, replace=False)] = n_nodes // 2
        return rows
    # a monotone partial path with insertions
    rows = np.sort(rng.choice(n_nodes, min(n, n_nodes), replace=False))[:n]
    rows = np.concatenate([rows, np.full(n - rows.size, -1)])
    rows[rng.random(n) < 0.2] = -1
    return rows


@pytest.mark.parametrize("kind", ["walk", "hot_column", "partial"])
def test_merge_matches_jax(kind):
    params = AlignParams()
    g, seq = _grown(4, 160, params, rounds=2)
    g.toposort()
    rows = _align_rows(kind, g, seq, params)
    g1, g2 = copy.deepcopy(g), copy.deepcopy(g)
    sno = g.n_seq - 1
    got = msa_native._merge(g1, seq, sno, g.topo, rows)
    want = jnative._merge(g2, seq, sno, g.topo, rows)
    assert got == want > 0
    for x, y in zip(_graph_state(g1), _graph_state(g2)):
        assert np.array_equal(np.asarray(x, dtype=object),
                              np.asarray(y, dtype=object))
    with pytest.raises(ValueError):
        msa_native._merge(copy.deepcopy(g), seq, sno, g.topo, rows[:-1])
    with pytest.raises(ValueError):
        msa_native._merge(copy.deepcopy(g), seq, sno, g.topo,
                          np.full(len(seq), len(g)))


@pytest.mark.parametrize("shape", [(2, 1), (6, 3), (64, 8)])
def test_poa_words_round_trip(shape):
    m_w, Rp = shape
    rng = np.random.default_rng(m_w)
    jw = rng.integers(-2 ** 31, 2 ** 31, (m_w, Rp, 128)).astype(np.int32)
    port = convert.poa_words_from_jax(jw)
    assert port.shape == (2 * m_w, Rp * 128) and port.dtype == torch.int16
    assert np.array_equal(convert.poa_words_to_jax(port), jw)
    assert np.array_equal(convert.poa_words_to_jax(port.numpy()), jw)
    # even node in the low half, column j at [j // 128, j % 128]
    v, j = 2 * m_w - 1, Rp * 128 - 5
    word = int(jw[v // 2, j // 128, j % 128])
    assert int(port[v, j]) & 0xFFFF == (word >> 16) & 0xFFFF
    assert int(port[v - 1, j]) & 0xFFFF == word & 0xFFFF
    with pytest.raises(ValueError):
        convert.poa_words_to_jax(port[:-1])
    with pytest.raises(ValueError):
        convert.poa_words_from_jax(jw[..., :64])


def test_host_library_without_openmp(monkeypatch, tmp_path):
    """Where the C compiler has no OpenMP runtime, the port's builder
    compiles its native sources without ``-fopenmp``, into its own build
    directory, and the rounds and the graph's native helpers run on that
    build; the compat engine, the one source that calls OpenMP, gives the
    same output on one thread."""
    from tsta_tpu_torch.models import msa as tmsa
    from tsta_tpu_torch.native import build as tbuild

    seqs = _reads(8, 3, 300)
    want = tmsa.align_seqs(seqs, engine="compat")
    monkeypatch.setattr(tbuild, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tbuild, "_LIBS", {})
    monkeypatch.setattr(tbuild, "_OPENMP", {tbuild.compiler(): False})
    lib = tbuild.load_poa()
    assert lib._name.startswith(str(tmp_path))
    assert os.path.basename(lib._name).startswith("libpoa_fast_")
    g, seq = _grown(6, 150, AlignParams())
    monkeypatch.setenv("TSTA_NATIVE_TOPO", "force")
    native = list(g.toposort())
    monkeypatch.setenv("TSTA_NATIVE_TOPO", "0")
    assert list(g.toposort()) == native
    got = tmsa.align_seqs(seqs, engine="compat")
    assert tbuild.load()._name.startswith(str(tmp_path))
    assert got == want
