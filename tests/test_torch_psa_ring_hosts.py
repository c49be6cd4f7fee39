"""The port's PSA ring across ranks on different nodes against the JAX
package.

``ops.psa_ring.align_long_ring_ranks`` as gloo processes on the CPU over
loopback, each rank given the node the test wants by patching
``parallel.ring_relay.node_id`` inside its process: a link between ranks
of two nodes is relayed (``parallel/ring_relay.py``: a sender thread on
the rank to the left, a receiver thread on the rank to the right, the
link's own two-rank gloo group), a link between ranks of one node stays
shared memory.  Every rank's (best, corner) is held to JAX's
``align_long_ring`` on as many virtual devices in interpret mode (one
call a rank count, each at one of the two scorings), to JAX's scan oracle
and to the single-process ``run_ring_cards`` over as many CPU devices,
and every receiver's in-link to that run's link, packet for packet.  A
sender killed once the links are set up makes its receiver fail within
the timeout and leaves nothing behind.  The relay's loops on their own
run over an in-process transport.  Zero tolerance.
"""

import functools
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams as JParams
from tsta_tpu.ops import psa_ring as jring
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu_torch.ops import _kernels, psa_ring
from tsta_tpu_torch.parallel import ring_relay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DEFAULT, OTHER = (2, -5, -2, -4), (3, -2, -1, -6)
T = 32
# rank count -> (n, m, the scoring JAX's ring is called at): ragged real
# lengths inside the padding, 128 columns a card and two row blocks, as
# in tests/test_torch_psa_ring_cards.py
SHAPES = {2: (250, 60, DEFAULT), 3: (375, 60, OTHER)}


def _pair(K):
    n, m, _ = SHAPES[K]
    rng = np.random.default_rng(K)
    return (rng.integers(65, 69, n).astype(np.uint8),
            rng.integers(65, 69, m).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _jax_ring(K):
    """JAX's ring on K of its virtual devices, in interpret mode (several
    seconds a call, so once a rank count)."""
    a, b = _pair(K)
    mesh = jax.make_mesh((K,), ("seq",), devices=jax.devices()[:K])
    return jring.align_long_ring(a, b, JParams(*SHAPES[K][2]), mesh=mesh,
                                 T=T)


def _oracle(a, b, params):
    ref = jscan.psa_align(a, b, JParams(*params))
    return int(ref.score), int(ref.last)


def _one_process(a, b, params, K, D):
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(a, b, K, T)
    return psa_ring.run_ring_cards(torch.from_numpy(a_p),
                                   torch.from_numpy(b_p), n_real, m_real,
                                   params, [CPU] * K, T, D=D)


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
from tsta_tpu_torch.parallel import mesh, ring_relay
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
nodes = json.loads(sys.argv[6])
rank, size = world()
node = ('node-' + nodes[rank], 'boot-' + nodes[rank], 'pid:' + nodes[rank])
ring_relay.node_id = lambda: node
card = psa_ring._card
def _card(*args):   # the in-link's packets, once the card's step is done
    got = card(*args)
    if args[9] is not None:
        print('INLINK ' + json.dumps(args[9].pkts.tolist()), flush=True)
    return got
psa_ring._card = _card
if rank == die:   # killed once its links are set up, before writing one
    def _die(*args, **kw):
        os.kill(os.getpid(), signal.SIGKILL)
    psa_ring._card = _die
got = psa_ring.align_long_ring_ranks(a, b, AlignParams(*params), T=32,
                                     device='cpu', D=D)
print('RING ' + json.dumps({'rank': rank, 'size': size, 'got': got,
                            'relays': ring_relay.stats}))
assert not [k for k in sys.modules if k.split('.')[0] in BLOCKED]
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(nodes, a, b, params, D, die=-1, timeout_s=60):
    """``CHILD`` as one process a letter of ``nodes`` (rank r on node
    ``nodes[r]``); returns the pids and each rank's (rc, out, err)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(TSTA_COORDINATOR="127.0.0.1:%d" % _free_port(),
               TSTA_NUM_PROCESSES=str(len(nodes)), GLOO_SOCKET_IFNAME="lo",
               TSTA_DIST_TIMEOUT_S=str(timeout_s), OMP_NUM_THREADS="1")
    argv = [a.tobytes().hex(), b.tobytes().hex(), json.dumps(params), str(D),
            str(die), json.dumps(list(nodes))]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD] + argv, cwd=REPO,
        env=dict(env, TSTA_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(len(nodes))]
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


def _lines(out, tag):
    return [json.loads(ln[len(tag) + 1:]) for ln in out.splitlines()
            if ln.startswith(tag + " ")]


def _links(pids, outs):
    """Per rank, the links it maps as (maker's rank, memfd target); once
    the ranks have ended, none is left to open."""
    maps = []
    for _, out, _ in outs:
        mine = []
        for path, target in _lines(out, "LINK"):
            assert target.startswith("/memfd:"), target
            assert not os.path.exists(path), path
            maker = [r for r, pid in enumerate(pids)
                     if path.startswith("/proc/%d/fd/" % pid)]
            assert len(maker) == 1, path
            mine.append(maker[0])
        maps.append(mine)
    return maps


@pytest.mark.parametrize("params", [DEFAULT, OTHER])
@pytest.mark.parametrize("nodes", ["AB", "AAB"])
def test_ranks_on_two_nodes_match_one_process_and_jax(nodes, params):
    """Ranks on nodes (A, B): one relayed link; on (A, A, B): a shared
    link from rank 0 to rank 1 and a relayed one from rank 1 to rank 2.
    Every rank returns the single process's ``run_ring_cards``, JAX's
    scan oracle and (at the rank count's scoring) JAX's ring; each
    receiver's in-link holds that run's link packet for packet; each
    relay forwarded every row block; nothing is left behind."""
    K = len(nodes)
    a, b = _pair(K)
    pids, outs = _ranks(nodes, a, b, params, 2)
    run = _one_process(a, b, params, K, 2)
    want = (run.best, run.corner)
    assert want == _oracle(a, b, params)
    if params == SHAPES[K][2]:
        assert want == _jax_ring(K)
    mb = run.links[0].shape[0]
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        got = _lines(out, "RING")[0]
        assert (got["rank"], got["size"]) == (rank, K)
        assert tuple(got["got"]) == want
        inlink = _lines(out, "INLINK")
        if rank:
            assert torch.equal(torch.tensor(inlink[0], dtype=torch.int32),
                               run.links[rank - 1])
        else:
            assert not inlink
        relays = {(r["role"], r["link"]): r for r in got["relays"]}
        want_relays = set()
        if rank and nodes[rank - 1] != nodes[rank]:
            want_relays.add(("recv", rank - 1))
        if rank < K - 1 and nodes[rank] != nodes[rank + 1]:
            want_relays.add(("send", rank))
        assert set(relays) == want_relays
        for r in relays.values():
            assert r["packets"] == mb and 1 <= r["messages"] <= mb
            assert r["wall_s"] > 0
    # who made each link a rank maps: a shared in-link the sender's, a
    # relayed in-link the receiver's own
    maps = _links(pids, outs)
    for rank in range(K):
        made = [rank] * (rank < K - 1)
        if rank:
            made.append(rank if nodes[rank - 1] != nodes[rank]
                        else rank - 1)
        assert sorted(maps[rank]) == sorted(made)


def test_a_killed_sender_fails_its_receiver():
    """Ranks on nodes (A, B); rank 0 is killed (SIGKILL) once the links
    are set up, before it writes a packet: rank 1 fails within the 2 s
    timeout with a TimeoutError or gloo's error in its stderr, exits
    non-zero, and no link is left behind."""
    a, b = _pair(2)
    t0 = time.monotonic()
    pids, outs = _ranks("AB", a, b, DEFAULT, 1, die=0, timeout_s=2)
    assert outs[0][0] == -9
    rc, out, err = outs[1]
    assert rc != 0
    assert "RING " not in out
    assert "TimeoutError" in err or "gloo" in err.lower(), err[-3000:]
    assert time.monotonic() - t0 < 60
    _links(pids, outs)


def _card_writes(link, pkts, pause_s=0.0):
    """A card's writes into ``link``: each row block's packet, then its
    flag, in order."""
    for rb in range(link.mb):
        link.put(rb, pkts[rb])
        if pause_s:
            time.sleep(pause_s)


def _loops(link_out, link_in, timeout_s=10.0):
    """:func:`send_loop` on ``link_out`` and :func:`recv_loop` on
    ``link_in`` in two threads joined by a queue; returns their records
    once both end (raising what either raised)."""
    q = queue.Queue()
    recs = [{"messages": 0, "packets": 0},
            {"messages": 0, "packets": 0, "lag_ms_max": 0.0}]
    errors = []

    def run(fn, *args):
        try:
            fn(*args)
        except BaseException as exc:
            errors.append(exc)

    threads = [
        threading.Thread(target=run, args=(
            ring_relay.send_loop, link_out, lambda t: q.put(t.clone()),
            timeout_s, threading.Event(), recs[0])),
        threading.Thread(target=run, args=(
            ring_relay.recv_loop, link_in,
            lambda t: t.copy_(q.get(timeout=timeout_s)), recs[1]))]
    return threads, recs, errors


def test_relay_loops_forward_every_packet_in_order():
    """A card writing 37 row blocks one by one: the receiver's link ends
    with every packet and every flag, the messages cover each row block
    once, and the lag is recorded."""
    mb, Tl = 37, 4
    src, dst = _kernels.RingLink(mb, Tl), _kernels.RingLink(mb, Tl)
    pkts = torch.randint(-1000, 1000, (mb, 2 * Tl), dtype=torch.int32)
    try:
        threads, recs, errors = _loops(src, dst)
        for t in threads:
            t.start()
        _card_writes(src, pkts, 1e-3)
        for t in threads:
            t.join(30)
        assert not errors
        assert torch.equal(dst.pkts, pkts)
        assert dst.flags.tolist() == [1] * mb
        assert recs[0]["packets"] == recs[1]["packets"] == mb
        assert recs[0]["messages"] == recs[1]["messages"] <= mb
        assert recs[1]["lag_ms_mean"] >= 0
    finally:
        src.close()
        dst.close()


def test_relay_batches_what_is_already_written():
    """Every flag set before the sender starts: one message carries all
    the link's packets."""
    mb, Tl = 9, 2
    src, dst = _kernels.RingLink(mb, Tl), _kernels.RingLink(mb, Tl)
    pkts = torch.arange(mb * 2 * Tl, dtype=torch.int32).view(mb, 2 * Tl)
    try:
        _card_writes(src, pkts)
        threads, recs, errors = _loops(src, dst)
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors
        assert recs[0]["messages"] == recs[1]["messages"] == 1
        assert torch.equal(dst.pkts, pkts)
    finally:
        src.close()
        dst.close()


def test_relay_sets_flags_after_the_packets():
    """While a message's packets are being received, none of their flags
    is set yet."""
    mb, Tl = 5, 2
    dst = _kernels.RingLink(mb, Tl)
    msgs = [torch.tensor([0, 2, time.time_ns()]),
            torch.ones((2, 2 * Tl), dtype=torch.int32),
            torch.tensor([2, 3, time.time_ns()]),
            torch.full((3, 2 * Tl), 2, dtype=torch.int32)]
    seen = []

    def recv(t):
        if t.dtype == torch.int32:
            seen.append(dst.flags.tolist())
        t.copy_(msgs.pop(0))

    try:
        ring_relay.recv_loop(dst, recv, {"messages": 0, "packets": 0,
                                         "lag_ms_max": 0.0})
        assert seen == [[0] * 5, [1, 1, 0, 0, 0]]
        assert dst.flags.tolist() == [1] * 5
        assert dst.pkts[:2].eq(1).all() and dst.pkts[2:].eq(2).all()
    finally:
        dst.close()


@pytest.mark.parametrize("header", [[1, 1, 0], [0, 0, 0], [0, 4, 0]])
def test_relay_refuses_a_message_that_does_not_continue(header):
    """A message that skips a row block, is empty or runs past the link
    raises ValueError and sets no flag."""
    dst = _kernels.RingLink(3, 2)
    try:
        with pytest.raises(ValueError, match="expected 0 of 3"):
            ring_relay.recv_loop(
                dst, lambda t: t.copy_(torch.tensor(header)),
                {"messages": 0, "packets": 0, "lag_ms_max": 0.0})
        assert not dst.flags.any()
    finally:
        dst.close()


def test_relay_sender_times_out_and_stops():
    """A sender whose card never writes fails at its timeout; one that
    is stopped returns without sending."""
    src = _kernels.RingLink(3, 2)
    sent = []
    rec = {"messages": 0, "packets": 0}
    try:
        with pytest.raises(TimeoutError, match="row block 0 of 3"):
            ring_relay.send_loop(src, sent.append, 0.2, threading.Event(),
                                 rec)
        stop = threading.Event()
        stop.set()
        ring_relay.send_loop(src, sent.append, 60, stop, rec)
        assert not sent and rec["messages"] == 0
    finally:
        src.close()


def test_relay_errors_reach_the_caller():
    """A relay's failure is kept and re-raised: by ``finish`` after a step
    that succeeded, by ``fail`` from the step's own error; ``fail``
    returns where no relay failed."""
    link = _kernels.RingLink(2, 2)
    try:
        relay = ring_relay.Relay(link, 0, "recv", None, 1.0)

        def broken():
            raise ConnectionError("peer gone")

        relay._call = broken
        relay.start()
        with pytest.raises(ConnectionError, match="peer gone"):
            ring_relay.finish([relay], 10.0)
        step = TimeoutError("row block 0 not written")
        with pytest.raises(ConnectionError) as info:
            ring_relay.fail([relay], step)
        assert info.value.__cause__ is step
        ok = ring_relay.Relay(link, 0, "send", None, 1.0)
        ok._call = lambda: None
        ok.start()
        ring_relay.fail([ok], step)
        ring_relay.finish([ok], 10.0)
    finally:
        link.close()


def test_node_id_is_the_same_in_a_child_process():
    """Two processes of one host and PID namespace name one node: the
    host name, the boot id and the namespace."""
    here = ring_relay.node_id()
    assert here[0] == socket.gethostname()
    assert all(here)
    out = subprocess.run(
        [sys.executable, "-c", "import json; from tsta_tpu_torch.parallel "
         "import ring_relay; print(json.dumps(ring_relay.node_id()))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert tuple(json.loads(out.stdout)) == here
