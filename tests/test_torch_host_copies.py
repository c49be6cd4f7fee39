"""The port's own copies of the JAX package's host modules against their
originals, on the CPU: ``config``, ``utils``, ``io`` (the native and the
Python FASTA/FASTQ parsers on every golden input), the POA graph
(``models/poa_graph.py`` with ``native/poa_fast.c``: toposort, MSA rows,
consensus and snapshots on the 20 read sets of ``test_msa_quality.py``),
the compat MSA engine (``native/compat_msa.c``, byte-identical to the
reference's golden outputs) and the CLI's argument shim."""

import glob
import io
import os

import numpy as np
import pytest

from tsta_tpu import cli as jcli
from tsta_tpu import config as jconfig
from tsta_tpu.io import encode as jencode
from tsta_tpu.io import seqio as jseqio
from tsta_tpu.models import poa_graph as jgraph
from tsta_tpu.utils import checkpoint as jcheckpoint
from tsta_tpu.utils import logging as jlogging
from tsta_tpu_torch import cli as tcli
from tsta_tpu_torch import config as tconfig
from tsta_tpu_torch.io import encode as tencode
from tsta_tpu_torch.io import seqio as tseqio
from tsta_tpu_torch.models import poa_graph as tgraph
from tsta_tpu_torch.ops import msa_native
from tsta_tpu_torch.utils import checkpoint as tcheckpoint
from tsta_tpu_torch.utils import logging as tlogging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FASTA = sorted(glob.glob(os.path.join(GOLDEN, "*", "*.fa")))


def test_config_matches_jax():
    for args in [(), (3, -2, -1, -6), (1, -1, -1, 0)]:
        j, t = jconfig.AlignParams(*args), tconfig.AlignParams(*args)
        assert (t.match, t.mismatch, t.gap_extend, t.gap_open, t.ogap) == (
            j.match, j.mismatch, j.gap_extend, j.gap_open, j.ogap)
    j, t = jconfig.AlignParams.linear(3, -4, -2), tconfig.AlignParams.linear(
        3, -4, -2)
    assert (t.gap_open, t.gap_extend) == (j.gap_open, j.gap_extend) == (0, -2)
    for bad in [dict(gap_extend=1), dict(gap_open=2)]:
        with pytest.raises(ValueError):
            tconfig.AlignParams(**bad)


def test_utils_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    reads = [rng.integers(65, 91, k).astype(np.uint8).tobytes()
             for k in (0, 1, 17, 300)]
    assert tcheckpoint.seqs_digest(reads) == jcheckpoint.seqs_digest(reads)
    recs = [{"name": "p%d" % k, "score": k * 3} for k in range(4)]
    for mod, name in ((jcheckpoint, "j.jsonl"), (tcheckpoint, "t.jsonl")):
        store = mod.ShardedResults(str(tmp_path / "d" / name))
        for r in recs:
            store.record(r)
    t = tcheckpoint.ShardedResults(str(tmp_path / "d" / "t.jsonl"))
    assert t.results() == recs and t.done("p2") and not t.done("p9")
    assert (tmp_path / "d" / "t.jsonl").read_bytes() == \
        (tmp_path / "d" / "j.jsonl").read_bytes()
    outs = []
    for mod in (jlogging, tlogging):
        buf = io.StringIO()
        mod.emit_json({"a": 1, "b": [2, "x"]}, buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert tlogging.get_logger("tsta_copy").handlers


def test_encode_matches_jax():
    for seq in (b"ACGTN", "acgt", np.frombuffer(b"GATTACA", np.uint8)):
        assert np.array_equal(tencode.encode_dna(seq),
                              jencode.encode_dna(seq))
    a = np.arange(13, dtype=np.uint8)
    for mult in (1, 4, 16):
        assert np.array_equal(tencode.pad_to_multiple(a, mult, 7),
                              jencode.pad_to_multiple(a, mult, 7))
    assert np.array_equal(tencode.stripe_permutation(64, 16),
                          jencode.stripe_permutation(64, 16))


def _records(mod, path):
    return [(r.name, r.sequence, r.comment, r.quality)
            for r in mod.read_records(path)]


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("path", FASTA,
                         ids=[os.path.relpath(p, GOLDEN) for p in FASTA])
def test_read_records_matches_jax(path, engine, monkeypatch, tmp_path):
    if engine == "python":
        monkeypatch.setenv("TSTA_NATIVE_SEQIO", "0")
    got = _records(tseqio, path)
    assert got and got == _records(jseqio, path)
    first = tseqio.read_first_record(path)
    assert (first.name, first.sequence) == got[0][:2]
    # the writer's bytes, wrapped, read back the same
    out = tmp_path / "w.fa"
    tseqio.write_fasta(str(out), tseqio.read_records(path), line_width=60)
    jout = tmp_path / "j.fa"
    jseqio.write_fasta(str(jout), jseqio.read_records(path), line_width=60)
    assert out.read_bytes() == jout.read_bytes()


def _mutate(rng, base, div):
    s = bytearray(base)
    for i in rng.integers(0, len(s), max(1, int(len(s) * div))):
        s[i] = b"ACGT"[rng.integers(0, 4)]
    for _ in range(max(1, int(len(s) * div / 6))):
        j = int(rng.integers(0, len(s) - 2))
        if rng.random() < 0.5:
            del s[j]
        else:
            s.insert(j, b"ACGT"[rng.integers(0, 4)])
    return bytes(s)


def _quality_corpus():
    """The 20 read sets of ``test_msa_quality.py`` (seed 0)."""
    rng = np.random.default_rng(0)
    sets = []
    for t in range(20):
        ln = int(rng.integers(80, 300))
        div = [0.03, 0.08, 0.15][t % 3]
        base = rng.choice(np.frombuffer(b"ACGT", np.uint8), ln).tobytes()
        nreads = int(rng.integers(3, 7))
        sets.append([_mutate(rng, base, div) for _ in range(nreads)])
    return sets


SETS = _quality_corpus()


def _graph_view(g):
    return (list(g.topo), list(g.toposort()), g.msa_rows(), g.consensus(),
            sorted(g.sinks()), [x.tolist() for x in g.csr()])


@pytest.mark.parametrize("k", range(len(SETS)))
def test_poa_graph_matches_jax(k, tmp_path, monkeypatch):
    """A graph grown by the port's native engine, saved, loads in both
    packages' ``load_graph``; both graphs give the same toposort, MSA
    rows, consensus, sinks and CSR, through the C helpers and through the
    Python paths, and the port's snapshot of the JAX graph is the same
    graph again."""
    ck = str(tmp_path / "g.npz")
    out = msa_native.align_seqs(SETS[k], checkpoint_path=ck, device="cpu")
    tg, textra = tgraph.load_graph(ck)
    jg, jextra = jgraph.load_graph(ck)
    assert textra == jextra and textra["round_scores"] == out.round_scores
    monkeypatch.setenv("TSTA_NATIVE_TOPO", "force")
    native = _graph_view(tg)
    assert native == _graph_view(jg)
    assert native[2] == out.rows and native[3] == out.consensus
    monkeypatch.setenv("TSTA_NATIVE_TOPO", "0")
    assert _graph_view(tg) == _graph_view(jg) == native
    ck2 = str(tmp_path / "t.npz")
    tgraph.save_graph(ck2, jg, extra=jextra)
    assert _graph_view(tgraph.load_graph(ck2)[0]) == native


@pytest.mark.parametrize("case", ["msa_small%d" % k for k in range(1, 6)])
def test_compat_engine_matches_golden(case, tmp_path):
    """The port's compat engine (its own build of ``compat_msa.c``),
    through the library and the CLI, byte-identical to the reference's
    output."""
    d = os.path.join(GOLDEN, case)
    with open(os.path.join(d, "params.txt")) as f:
        flags = f.read().split()
    with open(os.path.join(d, "ref.out"), "rb") as f:
        want = f.read()
    out = tmp_path / "o.txt"
    assert tcli.main(["msa", "-i", os.path.join(d, "seqs.fa"), "-o",
                      str(out)] + flags) == 0
    assert out.read_bytes() == want
    from tsta_tpu_torch.models import msa
    opts = dict(zip(flags[::2], map(int, flags[1::2])))
    params = tconfig.AlignParams(opts.get("-M", 2), opts.get("-X", -5),
                                 opts.get("-E", -2), opts.get("-O", -4))
    res = msa.align_file(os.path.join(d, "seqs.fa"), params,
                         width=opts.get("-W", 10), threads=opts.get("-T", 0))
    lib_out = tmp_path / "l.txt"
    msa.write_result(res, str(lib_out))
    assert lib_out.read_bytes() == want


@pytest.mark.parametrize("argv", [
    ["psa", "-X", "-3", "-1", "a.fa"], ["msa", "-O", "-6", "-E", "-1"],
    ["-M", "3", "-W", "20", "-T", "-1"], ["-X"], ["-X", "abc", "-1", "-2"]])
def test_merge_negative_values_matches_jax(argv):
    assert tcli._merge_negative_values(argv) == \
        jcli._merge_negative_values(argv)
