"""``tsta-torch msa`` and ``msa-batch`` on the CPU: the output files equal
``tsta msa --engine native`` / ``tsta msa-batch`` of the JAX package (the
compat engine's equal the goldens), and the flags and errors match."""

import json
import os
import subprocess
import sys

import pytest

from tsta_tpu import cli as jcli
from tsta_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
MSA_CASES = ["msa_small%d" % k for k in range(1, 6)]


def _flags(case):
    with open(os.path.join(GOLDEN, case, "params.txt")) as f:
        return f.read().split()


def _seqs(case):
    return os.path.join(GOLDEN, case, "seqs.fa")


@pytest.mark.parametrize("case", MSA_CASES)
def test_msa_native_output_matches_jax_cli(case, tmp_path, monkeypatch):
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    want, got = tmp_path / "jax.txt", tmp_path / "port.txt"
    assert jcli.main(["msa", "--engine", "native", "-i", _seqs(case),
                      "-o", str(want)] + _flags(case)) == 0
    assert tcli.main(["msa", "--engine", "native", "--device", "cpu",
                      "-i", _seqs(case), "-o", str(got)]
                     + _flags(case)) == 0
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("case", ["msa_small1", "msa_small3"])
def test_msa_compat_output_matches_golden(case, tmp_path):
    out = tmp_path / "o.txt"
    assert tcli.main(["msa", "-i", _seqs(case), "-o", str(out)]
                     + _flags(case)) == 0
    with open(os.path.join(GOLDEN, case, "ref.out"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_msa_json_record(tmp_path, capsys, monkeypatch):
    out = tmp_path / "o.txt"
    argv = ["msa", "--engine", "native", "-i", _seqs("msa_small2"),
            "-o", str(out), "--json"]
    assert tcli.main(argv + ["--device", "cpu", "--kernel", "plain"]) == 0
    got = json.loads(capsys.readouterr().out)
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    for k in ("rounds", "graph_len", "consensus_len", "output"):
        assert got[k] == want[k]
    assert len(got["add_len"]) == len(got["rounds"])
    assert got["device"] == "cpu" and got["plain_rounds"] == 0
    assert got["launches"]["poa_dp"] == 0


def test_msa_errors_exit_1(tmp_path):
    out = str(tmp_path / "o.txt")
    seqs = _seqs("msa_small1")
    assert tcli.main(["msa", "--engine", "native", "--device", "cpu",
                      "-i", "/nonexistent.fa", "-o", out]) == 1
    # --mesh needs the native engine, as in the JAX package
    assert tcli.main(["msa", "--device", "cpu", "--mesh", "1x4", "-i", seqs,
                      "-o", out]) == 1
    # the native engine over a mesh of 4 seq windows writes the meshless
    # run's MSA
    for mesh, path in (("1x4", out + ".mesh"), ("1x1", out + ".one")):
        assert tcli.main(["msa", "--engine", "native", "--device", "cpu",
                          "--mesh", mesh, "-i", seqs, "-o", path]) == 0
    with open(out + ".mesh", "rb") as f, open(out + ".one", "rb") as g:
        assert f.read() == g.read()
    # kernel=cuda on the CPU is refused, not quietly run elsewhere
    assert tcli.main(["msa", "--engine", "native", "--device", "cpu",
                      "--kernel", "cuda", "-i", seqs, "-o", out]) == 1
    assert not os.path.exists(out)


def test_msa_batch_matches_jax(tmp_path, capsys, monkeypatch):
    lst = tmp_path / "inputs.txt"
    # a repeated basename gets the JAX package's rename
    lst.write_text("# fixtures\n" + "".join(
        _seqs(c) + "\n" for c in MSA_CASES[:3] + ["msa_small1"]))
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    assert tcli.main(["msa-batch", "--inputs", str(lst), "--out-dir",
                      str(mine), "--device", "cpu", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["problems"] == 4 and rec["device"] == "cpu"
    monkeypatch.setenv("TSTA_MSA_KERNEL", "scan")
    assert jcli.main(["msa-batch", "--inputs", str(lst), "--out-dir",
                      str(theirs)]) == 0
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names and len(names) == 4
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    empty = tmp_path / "empty.txt"
    empty.write_text("\n# nothing\n")
    assert tcli.main(["msa-batch", "--inputs", str(empty), "--out-dir",
                      str(mine), "--device", "cpu"]) == 1


def test_module_msa_in_subprocess(tmp_path):
    case = "msa_small4"
    out = tmp_path / "o.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "tsta_tpu_torch", "msa", "--engine",
         "native", "--device", "cpu", "-i", _seqs(case), "-o", str(out)]
        + _flags(case), cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = tmp_path / "j.txt"
    assert jcli.main(["msa", "--engine", "native", "-i", _seqs(case),
                      "-o", str(want)] + _flags(case)) == 0
    assert out.read_bytes() == want.read_bytes()
