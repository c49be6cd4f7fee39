"""One MSA across real processes on the CPU: ``parallel/msa_multihost.py``
over a gloo process group that ``parallel.mesh.maybe_init_distributed``
joins from ``TSTA_COORDINATOR``, ``TSTA_NUM_PROCESSES`` and
``TSTA_PROCESS_ID``.

Two and four ranks, each a child process with ``jax`` and ``tsta_tpu``
blocked, each owning one window of every round: every rank's output must
equal the single-process port's and the JAX package's (rows, consensus,
round scores, graph and add lengths).  A rank that dies makes the others
exit non-zero, at the latest at the process group's timeout, not hang;
the CLI runs one MSA across two processes.  The rendezvous
binds 127.0.0.1 on a port the OS picked free."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import msa_native as jnative
from tsta_tpu_torch.parallel import mesh as meshlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
BLOCKED = ('jax', 'jaxlib', 'tsta_tpu')
for k in [k for k in sys.modules if k.split('.')[0] in BLOCKED]:
    del sys.modules[k]
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('import blocked: ' + name)
sys.meta_path.insert(0, _Block())
import numpy as np
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.parallel import mesh
from tsta_tpu_torch.parallel.msa_multihost import align_seqs_multihost, world
assert mesh.maybe_init_distributed()
seqs = [bytes.fromhex(h) for h in json.loads(sys.argv[1])]
die = int(sys.argv[2])
rank, size = world()
if rank == die:
    sys.exit(3)
out = align_seqs_multihost(seqs, AlignParams(), device='cpu',
                           rows_per_chunk=64)
print('MSA ' + json.dumps({
    'rank': rank, 'size': size, 'rows': [r.decode() for r in out.rows],
    'consensus': out.consensus.decode(), 'rounds': out.round_scores,
    'graph_len': out.graph_len, 'add_len': out.add_len}))
assert not [k for k in sys.modules if k.split('.')[0] in BLOCKED]
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reads(seed, n_reads, length, div=0.1):
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), length).tobytes()
    seqs = []
    for _ in range(n_reads):
        s = bytearray(base)
        for i in rng.integers(0, len(s), int(len(s) * div)):
            s[i] = b"ACGT"[rng.integers(0, 4)]
        for _ in range(4):
            j = int(rng.integers(0, len(s) - 2))
            if rng.random() < 0.5:
                del s[j]
            else:
                s.insert(j, b"ACGT"[rng.integers(0, 4)])
        seqs.append(bytes(s))
    return seqs


def _run(nproc: int, seqs, die: int = -1, timeout_s: int = 60):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(TSTA_COORDINATOR="127.0.0.1:%d" % _free_port(),
               TSTA_NUM_PROCESSES=str(nproc), GLOO_SOCKET_IFNAME="lo",
               TSTA_DIST_TIMEOUT_S=str(timeout_s), OMP_NUM_THREADS="1")
    arg = json.dumps([s.hex() for s in seqs])
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, arg, str(die)], cwd=REPO,
        env=dict(env, TSTA_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s + 120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_init_does_nothing_without_a_coordinator(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("TSTA_COORDINATOR", raising=False)
    monkeypatch.setenv("TSTA_NUM_PROCESSES", "2")
    assert meshlib.maybe_init_distributed() is False
    assert not (dist.is_available() and dist.is_initialized())


@pytest.mark.parametrize("nproc", [2, 4])
def test_processes_match_single_process_and_jax(nproc):
    """Every rank's MSA equals the port's single-process run and JAX's; at
    4 ranks the walk's hand-off crosses three process boundaries."""
    from tsta_tpu_torch.ops import msa_native
    seqs = _reads(7, 4, 260 + 120 * nproc)
    outs = _run(nproc, seqs)
    want = jnative.align_seqs(seqs, AlignParams())
    mine = msa_native.align_seqs(seqs, AlignParams(), device="cpu")
    assert (mine.rows, mine.round_scores) == (want.rows, want.round_scores)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("MSA ")]
        got = json.loads(line[0][4:])
        assert (got["rank"], got["size"]) == (rank, nproc)
        assert [r.encode() for r in got["rows"]] == want.rows
        assert got["consensus"].encode() == want.consensus
        assert got["rounds"] == want.round_scores
        assert got["graph_len"] == want.graph_len
        assert got["add_len"] == want.add_len


def test_a_dead_rank_fails_the_others():
    """Rank 1 exits before its first round: rank 0's first exchange with
    it fails (the closed connection, at the latest the process group's
    15 s timeout), and it exits non-zero."""
    outs = _run(2, _reads(3, 3, 300), die=1, timeout_s=15)
    assert outs[1][0] == 3
    assert outs[0][0] != 0
    assert "MSA " not in outs[0][1]


def test_cli_msa_across_two_processes(tmp_path):
    """``msa --engine native --device cpu`` started in two processes with
    the coordinator variables: rank 0 writes the JAX native engine's MSA
    and the JSON line (two processes, no plain round), rank 1 writes
    nothing."""
    from tsta_tpu import cli as jcli
    seqs = _reads(19, 3, 400)
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, s)
                            for i, s in enumerate(seqs)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(TSTA_COORDINATOR="127.0.0.1:%d" % _free_port(),
               TSTA_NUM_PROCESSES="2", GLOO_SOCKET_IFNAME="lo",
               TSTA_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tsta_tpu_torch", "msa", "--engine", "native",
         "--device", "cpu", "--json", "-i", str(fa), "-o",
         str(tmp_path / ("out%d.txt" % r))], cwd=REPO,
        env=dict(env, TSTA_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert not (tmp_path / "out1.txt").exists()
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert (got["processes"], got["plain_rounds"]) == (2, 0)
    assert got["rounds"] == jnative.align_seqs(seqs, AlignParams()).round_scores
    assert not outs[1][0].strip()
    assert jcli.main(["msa", "--engine", "native", "-i", str(fa), "-o",
                      str(tmp_path / "jax.txt")]) == 0
    assert (tmp_path / "out0.txt").read_bytes() == (
        tmp_path / "jax.txt").read_bytes()
