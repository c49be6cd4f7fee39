"""The port's PSA ring across cards and processes against the JAX package.

``ops.psa_ring.run_ring_cards`` over CPU devices runs each card's plain
version (``psa_ring.ring_card_plain``, one card's launch of the linked
build ``csrc/psa_dp.cu``), the cards joined by ``_kernels.RingLink``s:
held to JAX's ``align_long_ring`` on its virtual 8-device mesh in
interpret mode (one call a card count, each at one of three scorings), to
JAX's scan oracle and the port's ``psa_scan`` at every (K, D_k, scoring),
its link packets to the port's one-launch ring at D = K
(``psa_ring.ring_plain``, whose packets ``tests/test_torch_psa_ring.py``
holds to full rows) and to full-row values of ``psa_scan``; the cards
route of ``align_long_ring`` and ``longseq.align_long`` against JAX's
``longseq`` on its (2, 4) mesh; and ``align_long_ring_ranks`` as two gloo
processes on the CPU, joined by a link without a name that rank 0 makes,
against one process and JAX.  Zero tolerance: every score, corner and
packet equal.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams as JParams
from tsta_tpu.ops import psa_ring as jring
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu.parallel import longseq as jlongseq
from tsta_tpu.parallel import mesh as jmesh
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.ops import _kernels, psa_ring, psa_scan
from tsta_tpu_torch.parallel import longseq
from tsta_tpu_torch.parallel import mesh as meshlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DEFAULT, OTHER, EDIT = (2, -5, -2, -4), (3, -2, -1, -6), (0, -1, -1, 0)
T = 32
# card count -> (n, m, the scoring JAX's ring is called at): ragged real
# lengths inside the padding (128 columns a card, two row blocks), small
# because JAX's ring takes 3-11 s a call in interpret mode
SHAPES = {2: (250, 60, DEFAULT), 4: (500, 60, OTHER), 8: (1000, 60, EDIT)}


def _pair(K):
    n, m, _ = SHAPES[K]
    rng = np.random.default_rng(K)
    return (rng.integers(65, 69, n).astype(np.uint8),
            rng.integers(65, 69, m).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _jax_ring(K):
    """JAX's ring on K of its virtual devices, in interpret mode (several
    seconds a call, so once a card count)."""
    a, b = _pair(K)
    return jring.align_long_ring(a, b, JParams(*SHAPES[K][2]),
                                 mesh=jax.make_mesh((K,), ("seq",)), T=T)


def _oracle(a, b, params):
    ref = jscan.psa_align(a, b, JParams(*params))
    return int(ref.score), int(ref.last)


@functools.lru_cache(maxsize=None)
def _want(K, params):
    """JAX's scan oracle on the K-card pair at ``params``, equal to the
    port's ``psa_scan`` (once a (K, params): the D_k cases share it)."""
    a, b = _pair(K)
    want = _oracle(a, b, params)
    assert want == _port_scan(a, b, params)
    return want


@functools.lru_cache(maxsize=None)
def _ring_plain(K, params, D):
    """The port's one-launch ring's plain version at D shards on the
    K-card pair: ``(out, comm)``."""
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(*_pair(K), K, T)
    return psa_ring.ring_plain(torch.from_numpy(a_p), torch.from_numpy(b_p),
                               n_real, m_real, params, D, T)


def _port_scan(a, b, params):
    a_t = torch.from_numpy(a).view(1, -1)
    b_t = torch.from_numpy(b).view(1, -1)
    s, c, _ = psa_scan.scan_rows(a_t, b_t, torch.tensor([a.size]),
                                 torch.tensor([b.size]), params)
    return int(s[0]), int(c[0])


def _cards(a, b, params, K, D, devices=None):
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(a, b, K, T)
    run = psa_ring.run_ring_cards(torch.from_numpy(a_p), torch.from_numpy(b_p),
                                  n_real, m_real, params,
                                  devices or [CPU] * K, T, D=D)
    return run, (a_p, b_p, n_real, m_real)


@pytest.mark.parametrize("params", [DEFAULT, OTHER, EDIT])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("K", [2, 4, 8])
def test_cards_match_jax_and_scan(K, D, params):
    """Best and corner over K cards of D shards each equal JAX's scan
    oracle and the port's ``psa_scan`` (and JAX's ring where it ran at
    this scoring); every link packet equals the one-launch ring's packet
    of shard k at D = K; card k's shards' packets, where C_card splits
    evenly, equal shards k*D .. k*D + D - 1 of that ring at D = K * D."""
    a, b = _pair(K)
    run, (a_p, b_p, n_real, m_real) = _cards(a, b, params, K, D)
    assert (run.best, run.corner) == _want(K, params)
    if params == SHAPES[K][2]:
        assert (run.best, run.corner) == _jax_ring(K)
    assert run.shards == [D] * K
    out, comm = _ring_plain(K, params, K)
    assert len(run.links) == K - 1
    for k, pkts in enumerate(run.links):
        assert torch.equal(pkts, comm[k])
        assert torch.equal(run.comms[k][-1], comm[k])
    assert torch.equal(torch.stack([o.amax(dim=0) for o in run.outs]),
                       out)
    if (a_p.size // K) % D == 0:
        assert torch.equal(torch.cat(run.comms), _ring_plain(K, params,
                                                             K * D)[1])


def test_link_packets_are_full_row_values():
    """Card k's link of row i: H(i - 1, its last column) and the inclusive
    F prefix of row i there, from one-row ``psa_scan.scan_from`` passes
    over the whole padded pair (at ragged D_k = 3)."""
    m_, x_, e_, o_ = DEFAULT
    K = 4
    a, b = _pair(K)
    run, (a_p, b_p, n_real, m_real) = _cards(a, b, DEFAULT, K, 3)
    n, m = a_p.size, b_p.size
    a_t = torch.from_numpy(a_p).view(1, n)
    j = np.arange(n, dtype=np.int64)
    h_prev = o_ + (j + 1) * e_
    lasts = (np.arange(1, K) * (n // K)) - 1
    h = e = None
    for i in range(m):
        _, _, _, h, e = psa_scan.scan_from(
            a_t, torch.from_numpy(b_p[i:i + 1]).view(1, 1),
            torch.tensor([n]), torch.tensor([1]), DEFAULT, row_base=i, h=h,
            e=e)
        bound_prev = 0 if i == 0 else o_ + i * e_
        diag = np.concatenate([[bound_prev], h_prev[:-1]]) + np.where(
            a_p == b_p[i], m_, x_)
        c = np.maximum(diag, e[0].numpy().astype(np.int64))
        prefix = np.maximum(o_ + (i + 2) * e_,
                            np.maximum.accumulate(c - j * e_))
        rb, r = divmod(i, T)
        for k, last in enumerate(lasts):
            assert run.links[k][rb, r] == h_prev[last]
            assert run.links[k][rb, T + r] == prefix[last]
        h_prev = h[0].numpy().astype(np.int64)


def test_cards_route_through_the_entry_points(monkeypatch):
    """``align_long_ring`` and ``longseq.align_long`` on a mesh whose seq
    row routes to "cards" (here the CPU repeated, routed as a row of
    distinct cards is) run ``run_ring_cards`` and equal JAX's
    ``longseq.align_long`` on its (2, 4) mesh and the scan oracle."""
    calls = []
    real = psa_ring.run_ring_cards

    def spy(*args, **kw):
        calls.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(psa_ring, "seq_route",
                        lambda mesh: ("cards", list(mesh.devices[0])))
    monkeypatch.setattr(psa_ring, "run_ring_cards", spy)
    mesh = meshlib.make_mesh(2, 4, devices=[CPU] * 8)
    for seed in range(2):
        rng = np.random.default_rng(seed)
        n, m = int(rng.integers(64, 1200)), int(rng.integers(20, 300))
        a = rng.integers(65, 69, n).astype(np.uint8)
        b = rng.integers(65, 69, m).astype(np.uint8)
        params = DEFAULT if seed == 0 else OTHER
        want = jlongseq.align_long(a, b, JParams(*params),
                                   mesh=jmesh.make_mesh(data=2, seq=4))
        assert want == _oracle(a, b, params)
        assert longseq.align_long(a, b, AlignParams(*params),
                                  mesh=mesh) == want
        assert psa_ring.align_long_ring(a, b, AlignParams(*params),
                                        mesh=mesh, T=T) == want
    assert calls == [[CPU] * 4] * 4


def test_link_wait_times_out():
    """A card whose left neighbour never writes its link fails at the
    link's timeout instead of hanging."""
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(b"ACGT" * 40, b"ACGT" * 8,
                                                 2, T)
    link = _kernels.RingLink(b_p.size // T, T)
    try:
        with pytest.raises(TimeoutError, match="row block 0"):
            psa_ring.ring_card_plain(
                torch.from_numpy(a_p[128:]), torch.from_numpy(b_p), n_real,
                m_real, DEFAULT, 1, T, col_base=128, link_in=link,
                timeout_s=0.2)
    finally:
        link.close()


def test_link_round_trip():
    """A link holds zeroed flags and packets in memory without a name
    (a memfd), a second mapping opened from its path sees the first's
    writes, a mapping of the wrong size is refused, and once the maker
    closes it the path is gone."""
    w = _kernels.RingLink(3, 4)
    assert w.path == "/proc/%d/fd/%d" % (os.getpid(), w._fd)
    assert os.readlink(w.path).startswith("/memfd:")
    r = _kernels.RingLink(3, 4, w.path)
    assert not r.flags.any() and not r.pkts.any()
    w.put(1, torch.arange(8, dtype=torch.int32))
    assert r.flags.tolist() == [0, 1, 0]
    assert r.get(1, 1.0).tolist() == list(range(8))
    with pytest.raises(ValueError, match="bytes"):
        _kernels.RingLink(4, 4, w.path)
    path = w.path
    w.close()
    assert not os.path.exists(path)
    assert r.get(1, 1.0).tolist() == list(range(8))   # its mapping stays
    r.close()


def test_linked_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors the route is the plain version; the linked kernel's
    wrapper itself takes CUDA tensors only."""
    a = torch.zeros(256, dtype=torch.uint8)
    b = torch.zeros(32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.psa_ring_linked(
            a, b, torch.tensor([[256, 32]], dtype=torch.int32), DEFAULT, 1,
            T, 0, 0, None, None, torch.empty((1, 1, 2 * T), dtype=torch.int32),
            torch.empty((1, 2), dtype=torch.int32))


CHILD = r"""
import json, os, signal, sys
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
from tsta_tpu_torch.ops import _kernels, psa_ring
from tsta_tpu_torch.parallel import mesh
from tsta_tpu_torch.parallel.msa_multihost import world
class _Reported(_kernels.RingLink):   # each link this rank maps, reported
    def __init__(self, *args):
        super().__init__(*args)
        print('LINK ' + json.dumps([self.path, os.readlink(self.path)]),
              flush=True)
_kernels.RingLink = _Reported
assert mesh.maybe_init_distributed()
a, b = (np.frombuffer(bytes.fromhex(h), np.uint8) for h in sys.argv[1:3])
params, D, die = json.loads(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
rank, size = world()
if rank == die:   # killed once its links are mapped, before writing one
    def _die(*args, **kw):
        os.kill(os.getpid(), signal.SIGKILL)
    psa_ring.ring_card_plain = _die
got = psa_ring.align_long_ring_ranks(a, b, AlignParams(*params), T=32,
                                     device='cpu', D=D)
print('RING ' + json.dumps({'rank': rank, 'size': size, 'got': got}))
assert not [k for k in sys.modules if k.split('.')[0] in BLOCKED]
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(nproc, a, b, params, D, die=-1, timeout_s=60):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(TSTA_COORDINATOR="127.0.0.1:%d" % _free_port(),
               TSTA_NUM_PROCESSES=str(nproc), GLOO_SOCKET_IFNAME="lo",
               TSTA_DIST_TIMEOUT_S=str(timeout_s), OMP_NUM_THREADS="1")
    argv = [a.tobytes().hex(), b.tobytes().hex(), json.dumps(params), str(D),
            str(die)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD] + argv, cwd=REPO,
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
    return [p.pid for p in procs], outs


def _links_gone(pids, outs):
    """The links the ranks report mapping: each a memfd of rank 0's, and,
    now that the ranks have ended, none left to open."""
    links = [json.loads(ln[5:]) for _, out, _ in outs
             for ln in out.splitlines() if ln.startswith("LINK ")]
    assert links
    for path, target in links:
        assert path.startswith("/proc/%d/fd/" % pids[0]), path
        assert target.startswith("/memfd:"), target
        assert not os.path.exists(path)


def test_two_ranks_match_one_process_and_jax():
    """Two gloo ranks, each one card shard on the CPU (D_k = 2), joined by
    a link rank 0 makes: both return the single process's cards route,
    JAX's ring and the scan oracle, and leave no link behind."""
    a, b = _pair(2)
    pids, outs = _ranks(2, a, b, DEFAULT, 2)
    want = _jax_ring(2)
    run, _ = _cards(a, b, DEFAULT, 2, 2)
    assert (run.best, run.corner) == want == _oracle(a, b, DEFAULT)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RING ")]
        got = json.loads(line[0][5:])
        assert (got["rank"], got["size"]) == (rank, 2)
        assert tuple(got["got"]) == want
    _links_gone(pids, outs)


def test_a_dead_rank_fails_the_other():
    """Rank 0 is killed (SIGKILL) once the links are mapped, before it
    writes a packet: rank 1's wait on its in-link fails at the 2 s
    timeout, and it exits non-zero; no link is left behind."""
    a, b = _pair(2)
    pids, outs = _ranks(2, a, b, DEFAULT, 1, die=0, timeout_s=2)
    assert outs[0][0] == -9
    assert outs[1][0] != 0
    assert "RING " not in outs[1][1]
    assert "TimeoutError" in outs[1][2]
    _links_gone(pids, outs)
