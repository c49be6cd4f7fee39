"""The port's command line on the CPU: byte parity with the reference's
golden outputs, the same results as the JAX package's CLI, batch resume,
and the rule that ``tsta_tpu_torch`` never imports jax."""

import ast
import json
import os
import runpy
import subprocess
import sys

import pytest

from tsta_tpu import cli as jcli
from tsta_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
PKG = os.path.join(ROOT, "tsta_tpu_torch")
PSA_CASES = ["psa_small%d" % k for k in range(1, 8)]


def _params_flags(d):
    with open(os.path.join(d, "params.txt")) as f:
        return f.read().split()


def _psa_argv(d, out):
    return (["psa", "--device", "cpu", "-1", os.path.join(d, "a.fa"),
             "-2", os.path.join(d, "b.fa"), "-o", str(out)]
            + _params_flags(d))


def _assert_golden(d, stdout, out):
    with open(os.path.join(d, "ref.stdout")) as f:
        assert stdout.strip() == f.read().strip()
    with open(os.path.join(d, "ref.out"), "rb") as f:
        assert out.read_bytes() == f.read()


@pytest.mark.parametrize("case", PSA_CASES)
def test_module_psa_cpu_matches_golden(case, tmp_path, capsys, monkeypatch):
    """``python -m tsta_tpu_torch psa --device cpu`` (run in-process)."""
    d = os.path.join(GOLDEN, case)
    out = tmp_path / "o.txt"
    monkeypatch.setattr(sys, "argv", ["tsta_tpu_torch"] + _psa_argv(d, out))
    with pytest.raises(SystemExit) as ex:
        runpy.run_module("tsta_tpu_torch", run_name="__main__")
    assert ex.value.code == 0
    _assert_golden(d, capsys.readouterr().out, out)


def test_module_psa_in_subprocess(tmp_path):
    d = os.path.join(GOLDEN, "psa_small4")   # generated with -X -3
    out = tmp_path / "o.txt"
    proc = subprocess.run([sys.executable, "-m", "tsta_tpu_torch"]
                          + _psa_argv(d, out), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _assert_golden(d, proc.stdout, out)


@pytest.mark.parametrize("kernel", ["auto", "plain"])
def test_psa_notrace_json_matches_jax_cli(kernel, capsys):
    d = os.path.join(GOLDEN, "psa_small5")
    args = ["psa", "--notrace", "--json", "-1", d + "/a.fa",
            "-2", d + "/b.fa"] + _params_flags(d)
    assert jcli.main(args + ["--kernel", "scan"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(args + ["--kernel", kernel, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert (got["score"], got["corner"]) == (want["score"], want["corner"])
    assert got["output"] is None and got["device"] == "cpu"
    assert set(got["launches"]) == {
        "psa_dp_score", "psa_dp_traced", "psa_dp_chunk", "psa_dp_short",
        "psa_dp_diff", "psa_dp_striped", "psa_walk", "psa_walk_pair2",
        "psa_walk_bounded", "poa_dp", "poa_walk", "poa_dp_chunk",
        "poa_dp_window", "poa_walk_bounded", "psa_ring", "psa_ring_linked",
        "walk_probe_a",
        "walk_probe_b", "walk_probe_c", "walk_probe_e", "poa_dp_wide",
        "poa_walk_wide", "poa_dp_chunk_wide", "poa_dp_window_wide",
        "poa_walk_bounded_wide"}


@pytest.mark.parametrize("traced", [False, True])
def test_psa_kernel_scan_matches_jax_cli(traced, tmp_path, capsys):
    """``--kernel scan`` (the JAX CLI's value) runs the plain route and
    prints what the JAX CLI prints with it: maxsorce=378 on psa_small5,
    and the same alignment file when traced."""
    d = os.path.join(GOLDEN, "psa_small5")
    args = ["psa", "-1", d + "/a.fa", "-2", d + "/b.fa",
            "--kernel", "scan"] + ([] if traced else ["--notrace"])
    assert jcli.main(args + ["-o", str(tmp_path / "j.out")]) == 0
    want = capsys.readouterr().out
    assert want.strip() == "maxsorce=378"
    assert tcli.main(args + ["--device", "cpu",
                             "-o", str(tmp_path / "t.out")]) == 0
    assert capsys.readouterr().out == want
    if traced:
        assert ((tmp_path / "t.out").read_bytes()
                == (tmp_path / "j.out").read_bytes())


@pytest.mark.parametrize("cmd,extra", [
    ("psa", ["-1", "a.fa", "-2", "b.fa"]), ("msa", ["-i", "r.fa"]),
    ("msa-batch", ["--inputs", "l.txt", "--out-dir", "o"]),
    ("batch", ["--pairs", "m.tsv"])])
def test_kernel_aliases_resolve(cmd, extra, monkeypatch):
    """Every subcommand takes the JAX CLI's --kernel values: scan is the
    plain route, pallas the kernels-only one (which needs a card)."""
    seen = []
    fn = {"psa": "cmd_psa", "msa": "cmd_msa", "msa-batch": "cmd_msa_batch",
          "batch": "cmd_batch"}[cmd]
    monkeypatch.setattr(tcli, fn, lambda args: seen.append(args.kernel) or 0)
    for value, want in (("scan", "plain"), ("pallas", "cuda"),
                        ("auto", "auto"), ("cuda", "cuda")):
        assert tcli.main([cmd, *extra, "--kernel", value]) == 0
        assert seen.pop() == want


def test_psa_profile_writes_a_trace(tmp_path, capsys):
    """``--profile DIR`` leaves a torch.profiler trace in DIR and prints
    the same result as without it."""
    d = os.path.join(GOLDEN, "psa_small5")
    args = ["psa", "--device", "cpu", "-1", d + "/a.fa", "-2", d + "/b.fa"]
    outs = []
    for extra in ([], ["--profile", str(tmp_path / "prof")]):
        out = tmp_path / ("o%d.txt" % len(outs))
        assert tcli.main(args + ["-o", str(out)] + extra) == 0
        outs.append((capsys.readouterr().out, out.read_bytes()))
    assert outs[0] == outs[1] and outs[0][0].strip() == "maxsorce=378"
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "psa traced" for e in events)


def test_psa_errors_exit_1(capsys, tmp_path):
    assert tcli.main(["psa", "--device", "cpu", "-1", "/nonexistent.fa",
                      "-2", "/also.fa"]) == 1
    assert tcli.main(["psa", "--device", "cpu", "-E", "1", "-1", "x",
                      "-2", "y"]) == 1
    d = os.path.join(GOLDEN, "psa_small1")
    # kernel=cuda on the CPU is refused, not quietly run elsewhere
    assert tcli.main(["psa", "--device", "cpu", "--kernel", "cuda",
                      "-1", d + "/a.fa", "-2", d + "/b.fa",
                      "-o", str(tmp_path / "o.txt")]) == 1


def _manifest(tmp_path, cases):
    m = tmp_path / "m.tsv"
    m.write_text("".join("%s\t%s/a.fa\t%s/b.fa\n"
                         % (c, os.path.join(GOLDEN, c), os.path.join(GOLDEN, c))
                         for c in cases))
    return m


def test_batch_resume_and_traced_outputs(tmp_path, capsys):
    cases = ["psa_small1", "psa_small2", "psa_small3"]
    m = _manifest(tmp_path, cases)
    store = tmp_path / "r.jsonl"
    base = ["batch", "--pairs", str(m), "--device", "cpu"]
    assert tcli.main(base + ["--resume", str(store), "--scores",
                             str(tmp_path / "s1.tsv")]) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["pairs"] == 3
    recs = [json.loads(ln) for ln in store.read_text().splitlines()]
    assert [r["name"] for r in recs] == cases
    # a restart skips every recorded pair and reports the same scores
    assert tcli.main(base + ["--resume", str(store), "--scores",
                             str(tmp_path / "s2.tsv")]) == 0
    capsys.readouterr()
    assert len(store.read_text().splitlines()) == 3
    assert (tmp_path / "s1.tsv").read_text() == \
        (tmp_path / "s2.tsv").read_text()
    # the JAX package's batch gives the same scores
    assert jcli.main(["batch", "--pairs", str(m), "--scores",
                      str(tmp_path / "sj.tsv")]) == 0
    capsys.readouterr()
    assert (tmp_path / "sj.tsv").read_text() == \
        (tmp_path / "s1.tsv").read_text()
    for line in (tmp_path / "s1.tsv").read_text().splitlines():
        name, score = line.split("\t")
        with open(os.path.join(GOLDEN, name, "ref.stdout")) as f:
            assert "maxsorce=%s" % score == f.read().strip()
    # traced batch writes the reference's output files
    out_dir = tmp_path / "alns"
    assert tcli.main(base + ["--traced", "--out-dir", str(out_dir)]) == 0
    capsys.readouterr()
    for c in cases:
        with open(os.path.join(GOLDEN, c, "ref.out"), "rb") as f:
            assert (out_dir / (c + ".txt")).read_bytes() == f.read()
    # the pairs shared over a mesh's data axis give the same scores
    assert tcli.main(base + ["--mesh", "2x1", "--scores",
                             str(tmp_path / "s3.tsv")]) == 0
    capsys.readouterr()
    assert (tmp_path / "s3.tsv").read_text() == \
        (tmp_path / "s1.tsv").read_text()


# the port imports neither jax nor any module of the JAX package; it
# keeps its own copies of the host code it needs
_FORBIDDEN = ("jax", "jaxlib", "tsta_tpu")


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from ("%s.%s" % (node.module, a.name) for a in node.names)


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_never_import_jax():
    files = list(_py_files())
    assert len(files) >= 12
    for path in files:
        for name in _imported_names(path):
            for bad in _FORBIDDEN:
                assert not (name == bad or name.startswith(bad + ".")), \
                    "%s imports %s" % (os.path.relpath(path, ROOT), name)


_NO_JAX_PROBE = r"""
import importlib, pkgutil, sys
BLOCKED = ('jax', 'jaxlib', 'tsta_tpu')
for k in [k for k in sys.modules if k.split('.')[0] in BLOCKED]:
    del sys.modules[k]
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('import blocked: ' + name)
sys.meta_path.insert(0, _Block())
import tsta_tpu_torch
for m in pkgutil.walk_packages(tsta_tpu_torch.__path__, 'tsta_tpu_torch.'):
    if m.name != 'tsta_tpu_torch.__main__':
        importlib.import_module(m.name)
from tsta_tpu_torch.models import msa, psa
out = psa.align_pair(b'ACGTACGTTA', b'ACGTCGTTA', traced=True, device='cpu')
print(out.score, out.a_row.decode(), out.b_row.decode())
m = msa.align_seqs([b'ACGTACGTTA', b'ACGTCGTTA', b'ACGGACGTTA'],
                   engine='native', device='cpu')
print(m.round_scores, m.consensus.decode())
c = msa.align_seqs([b'ACGTACGTTA', b'ACGTCGTTA', b'ACGGACGTTA'],
                   engine='compat')
print(c.round_scores, c.consensus.decode())
assert not [k for k in sys.modules if k.split('.')[0] in BLOCKED]
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[:3] == ["12", "ACGTACGTTA", "ACGT-CGTTA"]
    native, compat = proc.stdout.splitlines()[1:3]
    assert native.endswith("ACGTACGTTA")
    from tsta_tpu.models import msa as jmsa
    want = jmsa.align_seqs([b"ACGTACGTTA", b"ACGTCGTTA", b"ACGGACGTTA"],
                           engine="compat")
    assert compat == "%s %s" % (want.round_scores, want.consensus.decode())


def test_batch_library_matches_jax(monkeypatch):
    import numpy as np

    from tsta_tpu.config import AlignParams
    from tsta_tpu.parallel import batch as jbatch
    from tsta_tpu_torch.parallel import batch as tbatch

    rng = np.random.default_rng(77)
    pairs = [(rng.integers(65, 69, n).astype(np.uint8),
              rng.integers(65, 69, m).astype(np.uint8))
             for n, m in [(300, 280), (120, 260), (700, 650), (90, 95)]]
    params = AlignParams()
    for traced in (False, True):
        want = jbatch.align_batch(pairs, params, traced=traced,
                                  kernel="scan")
        for kernel in ("auto", "plain"):
            got = tbatch.align_batch(pairs, params, traced=traced,
                                     kernel=kernel, device="cpu")
            for w, g in zip(want, got):
                assert (g.score, g.last) == (int(w.score), int(w.last))
                if traced:
                    for name in ("back", "fback", "eback"):
                        assert np.array_equal(getattr(g, name).numpy(),
                                              np.asarray(getattr(w, name)))
    assert (tbatch.align_batch_traced_device(pairs, params, device="cpu")
            == jbatch.align_batch_traced_device(pairs, params))
    from tsta_tpu.parallel import mesh as jmeshlib
    from tsta_tpu_torch.parallel import mesh as tmeshlib
    got = tbatch.align_batch(pairs, params, mesh=tmeshlib.make_mesh(
        2, 1, devices=["cpu"] * 2))
    want = jbatch.align_batch(pairs, params, mesh=jmeshlib.make_mesh(2, 1))
    assert [(g.score, g.last) for g in got] == [
        (int(w.score), int(w.last)) for w in want]
    with pytest.raises(ValueError):
        tbatch.align_batch(pairs, AlignParams(match=0), device="cpu")
    items = list(range(10))
    monkeypatch.setenv("TSTA_NUM_PROCESSES", "3")
    monkeypatch.setenv("TSTA_PROCESS_ID", "1")
    assert (tbatch.stride_for_process(items)
            == jbatch.stride_for_process(items) == [1, 4, 7])
