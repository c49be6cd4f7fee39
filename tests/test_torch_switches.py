"""The JAX package's build and plan switches, read by the port:

* ``TSTA_NATIVE_CFLAGS`` and ``CC`` in the native build
  (``native/build.py``, as ``tsta_tpu/native/build.py`` reads them): the
  twin of ``tests/test_error_paths.py::test_compat_rmax_overflow_raises_not_exits``
  through the port's CLI, ``$CC`` the compiler that runs, both in the
  cache key;
* ``TSTA_HBM_BUDGET_GB`` in ``device.device_budget``, which the POA
  round plan, the traced PSA groups and the chunked traced pair read:
  the budget moves the route, and the values stay the JAX package's;
* ``TSTA_POA_PROFILE``: a chunked round prints the JAX package's
  ``[poa_chunked]`` lines."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams as JParams
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import CPU_BUDGET, device_budget
from tsta_tpu_torch.native import build as tbuild
from tsta_tpu_torch.ops import msa_chunked, msa_native, psa_chunked
from tsta_tpu_torch.ops import psa_pallas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _rmax_reads():
    """The 12 reads of ``test_compat_rmax_overflow_raises_not_exits``."""
    rng = np.random.default_rng(3)

    def junk(n):
        return rng.choice(ACGT, n).tobytes()
    return [b"C" * 16] + [junk(4 + i) + b"C" * 16 for i in range(1, 12)]


def test_native_cflags_reach_the_compat_build(tmp_path):
    """``TSTA_NATIVE_CFLAGS=-DTSTA_RMAX=2`` compiles the compat engine's
    in-degree limit down to 2: ``msa --engine compat`` stops with the JAX
    package's in-degree error and rc 1, where without the flag it writes
    an MSA."""
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, s)
                            for i, s in enumerate(_rmax_reads())))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-m", "tsta_tpu_torch", "msa", "--engine",
           "compat", "--device", "cpu", "-i", str(fa)]
    proc = subprocess.run(cmd + ["-o", str(tmp_path / "a.txt")], cwd=REPO,
                          env=dict(env, TSTA_NATIVE_CFLAGS="-DTSTA_RMAX=2"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert "in-degree exceeded" in proc.stderr
    assert not (tmp_path / "a.txt").exists()
    env.pop("TSTA_NATIVE_CFLAGS", None)
    proc = subprocess.run(cmd + ["-o", str(tmp_path / "b.txt")], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "b.txt").read_bytes().startswith(b">1\n")


def test_cc_is_the_compiler_and_in_the_key(tmp_path, monkeypatch):
    """``$CC`` compiles the native sources, and the compiler and the extra
    flags are both part of a library's cache key."""
    log = tmp_path / "cc.log"
    cc = tmp_path / "mycc"
    cc.write_text("#!/bin/sh\necho \"$@\" >> %s\nexec %s \"$@\"\n"
                  % (log, tbuild.compiler()))
    cc.chmod(0o755)
    monkeypatch.setattr(tbuild, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("TSTA_NATIVE_CFLAGS", raising=False)
    first = tbuild.build("poa_fast.c")
    monkeypatch.setenv("CC", str(cc))
    assert tbuild.compiler() == str(cc)
    second = tbuild.build("poa_fast.c")
    assert second != first and os.path.exists(second)
    assert "poa_fast.c" in log.read_text()
    monkeypatch.setenv("TSTA_NATIVE_CFLAGS", "-DTSTA_UNUSED=1  -O2")
    assert tbuild.cflags() == tbuild.CFLAGS + ["-DTSTA_UNUSED=1", "-O2"]
    third = tbuild.build("poa_fast.c")
    assert third not in (first, second)
    assert "-DTSTA_UNUSED=1 -O2" in log.read_text().splitlines()[-1]
    assert tbuild.build("poa_fast.c") == third   # cached: no rebuild
    assert len(log.read_text().splitlines()) == 2


def test_budget_variable_sets_device_budget(monkeypatch):
    monkeypatch.delenv("TSTA_HBM_BUDGET_GB", raising=False)
    assert device_budget("cpu") == CPU_BUDGET
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", "0.5")
    assert device_budget("cpu") == 2 ** 29
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", "0.0016")
    assert device_budget(torch.device("cpu")) == int(0.0016 * 2 ** 30)


def _pair(seed, length, div=0.08):
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, length).tobytes()
    b = bytearray(base)
    for i in rng.integers(0, len(b), int(len(b) * div)):
        b[i] = b"ACGT"[rng.integers(0, 4)]
    for _ in range(int(len(b) * div / 8)):
        del b[int(rng.integers(0, len(b) - 2))]
    return [base, bytes(b)]


@pytest.mark.parametrize("length,gb,windowed", [(600, "0.00186", False),
                                                (2000, "0.01", True)])
def test_budget_chunks_a_round_and_the_profile_prints(
        length, gb, windowed, monkeypatch, capsys):
    """At a small ``TSTA_HBM_BUDGET_GB`` the round runs chunked with the
    unchunked round's values (JAX's native engine's), and
    ``TSTA_POA_PROFILE=1`` prints the JAX package's forward and backward
    lines; ``0`` prints nothing."""
    seqs = _pair(21, length)
    want = jnative.align_seqs(seqs, JParams())
    calls = []
    orig = msa_chunked.round_chunked

    def spy(*a, **kw):
        calls.append(a[4:6])   # (NC, NWIN)
        return orig(*a, **kw)
    monkeypatch.setattr(msa_chunked, "round_chunked", spy)
    monkeypatch.setenv("TSTA_POA_PROFILE", "0")
    assert msa_native.align_seqs(seqs, AlignParams(),
                                 device="cpu").rows == want.rows
    assert calls == []
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", gb)
    out = msa_native.align_seqs(seqs, AlignParams(), device="cpu")
    assert len(calls) == 1 and (calls[0][1] > 0) == windowed
    assert capsys.readouterr().out == ""
    assert (out.rows, out.round_scores, out.consensus) == (
        want.rows, want.round_scores, want.consensus)
    monkeypatch.setenv("TSTA_POA_PROFILE", "1")
    msa_native.align_seqs(seqs, AlignParams(), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    NC, NWIN = calls[-1]
    assert re.fullmatch(
        r"\[poa_chunked\] forward \d+ chunks \(NC=%d, n=\d+, W=\d+, "
        r"NWIN=%d\): \d+\.\d{3} s" % (NC, NWIN), lines[0]), lines
    back = (r"windowed backward NWIN=%d K=1" % NWIN if windowed
            else r"backward K=1")
    m = re.fullmatch(r"\[poa_chunked\] %s: \d+\.\d{3} s \((\d+) syncs, "
                     r"(\d+) remats\)" % back, lines[1])
    assert m and int(m.group(1)) == int(m.group(2)) >= 1, lines
    assert len(lines) == 2


def test_budget_chunks_a_traced_pair(monkeypatch):
    """A traced pair whose plane passes ``TSTA_HBM_BUDGET_GB`` runs
    through the chunked pair, with JAX's alignment."""
    rng = np.random.default_rng(9)
    a = rng.integers(65, 69, 700).astype(np.uint8)
    b = a[rng.random(700) < 0.9]
    p = (2, -5, -2, -4)
    want = jpallas.psa_align_traced_device(a, b, p)
    calls = []
    orig = psa_chunked.psa_align_traced_chunked

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    monkeypatch.setattr(psa_chunked, "psa_align_traced_chunked", spy)
    assert psa_pallas.psa_align_traced_device(a, b, p, device="cpu") == want
    assert calls == []
    monkeypatch.setenv("TSTA_HBM_BUDGET_GB", "0.0002")
    assert psa_pallas.psa_align_traced_device(a, b, p, device="cpu") == want
    assert calls == [1]
