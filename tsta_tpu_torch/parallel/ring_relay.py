"""The PSA ring's links between ranks on different nodes.

``ops/psa_ring.py``'s :func:`~tsta_tpu_torch.ops.psa_ring.align_long_ring_ranks`
joins rank k's card to rank k + 1's by a link, ``_kernels.RingLink``: each
row block's edge packet, 2T int32, and its flag in shared memory, which
the sender's card writes behind a system-scope release and the
receiver's card reads after a system-scope acquire
(``csrc/ring_common.cuh``).  Two ranks that can open each other's
``/proc/<pid>/fd`` (:func:`node_id`) map one link.  Ranks on two nodes
cannot, so each maps a link of its own, the sender's out-link and the
receiver's in-link, and a :class:`Relay` on each side moves the packets
between the two over the link's own two-rank gloo group
(:func:`link_groups`):

* the sender's thread polls its out-link's flags in row-block order and
  sends every packet whose flag it finds set as one message: a header
  (the first row block, the count, the host clock's ns when it saw the
  flags) and the (count, 2T) int32 packets, read after their flags;
* the receiver's thread receives each message straight into its
  in-link's packet rows, then sets their flags, the order
  ``RingLink.put`` keeps.

An x86 host keeps loads in order and stores in order, so the flag is read
before its packet and the packet stored before its flag with no fence.
An Arm host (Grace) would need a load fence in the sender and a store
fence in the receiver between the two; this module does not run there.

A relay's thread that fails (the group's timeout, a peer gone, a message
that does not fit) keeps its exception, and :func:`finish` or
:func:`fail` re-raises it in the caller's thread after the card's step.
The threads are daemons and each of their waits is bounded (the group's
timeout, the sender's poll by ``timeout_s``), so they never keep a failed
process alive.  :data:`stats` gets each relay's figures, on the host
clock, when it ends.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import time

import numpy as np
import torch

# the sender's poll: back-off from PAUSE_S, doubling to PAUSE_CAP_S, well
# below a row block's time on a card (~0.22 ms at T = 256 on the 200 kbp
# pair); the host's timer slack (~50 us) sets the real floor of a sleep
PAUSE_S = 2e-6
PAUSE_CAP_S = 2e-5
BOOT_ID = "/proc/sys/kernel/random/boot_id"

# one record a relay that ended: ``{"link": k, "role": "send" | "recv",
# "messages", "packets", "wall_s"}``, the receiver's also ``lag_ms_max``
# and ``lag_ms_mean``: how long after the sender saw a row block's flag
# the receiver set it (host clocks; across hosts their offset too)
stats: list = []


def node_id() -> tuple:
    """Where this process runs, as far as a link can be shared: the host
    name, the boot id (two containers with one host name on two machines
    differ there) and the PID namespace (``/proc/<pid>/fd`` of a process
    opens only within its own)."""
    try:
        with open(BOOT_ID) as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    try:
        pid_ns = os.readlink("/proc/self/ns/pid")
    except OSError:
        pid_ns = ""
    return socket.gethostname(), boot, pid_ns


def link_groups(relayed, timeout_s: float) -> dict:
    """A two-rank gloo group ``[k, k + 1]`` for each link k with
    ``relayed[k]``, made by every rank of the default group in link order
    (``dist.new_group`` needs every rank); returns ``{k: group}`` for the
    links this rank is an end of."""
    import torch.distributed as dist
    rank, groups = dist.get_rank(), {}
    for k, r in enumerate(relayed):
        if r:
            g = dist.new_group([k, k + 1], backend="gloo",
                               timeout=datetime.timedelta(seconds=timeout_s))
            if rank in (k, k + 1):
                groups[k] = g
    return groups


def send_loop(link, send, timeout_s: float, stop: threading.Event,
              rec: dict) -> None:
    """Send ``link``'s packets in row-block order as their flags are set:
    ``send(tensor)`` a message's (3,) int64 header, then its (count, 2T)
    int32 packets.  Returns after the last row block, or at once when
    ``stop`` is set; TimeoutError when no flag is set for ``timeout_s``."""
    flags, pkts, mb = link.flags.numpy(), link.pkts, link.mb
    nxt, pause, t_last = 0, PAUSE_S, time.monotonic()
    while nxt < mb:
        unset = np.flatnonzero(flags[nxt:] == 0)
        count = int(unset[0]) if unset.size else mb - nxt
        if count == 0:
            if stop.is_set():
                return
            if time.monotonic() - t_last > timeout_s:
                raise TimeoutError(
                    "ring relay: row block %d of %d of link %s not written "
                    "within %g s" % (nxt, mb, link.path, timeout_s))
            time.sleep(pause)
            pause = min(2 * pause, PAUSE_CAP_S)
            continue
        send(torch.tensor([nxt, count, time.time_ns()], dtype=torch.int64))
        send(pkts[nxt:nxt + count])
        nxt += count
        rec["messages"] += 1
        rec["packets"] += count
        pause, t_last = PAUSE_S, time.monotonic()


def recv_loop(link, recv, rec: dict) -> None:
    """Receive every row block of ``link`` from :func:`send_loop`'s
    messages: ``recv(tensor)`` fills a header, then the packets straight
    into the link's rows; their flags are set after the packet words.
    ValueError on a message that does not continue the link."""
    flags, pkts, mb = link.flags.numpy(), link.pkts, link.mb
    hdr = torch.empty(3, dtype=torch.int64)
    got, lag_sum = 0, 0
    while got < mb:
        recv(hdr)
        first, count, t_ns = hdr.tolist()
        if first != got or not 1 <= count <= mb - got:
            raise ValueError(
                "ring relay: a message of row blocks [%d, %d) on link %s, "
                "expected %d of %d next" % (first, first + count, link.path,
                                            got, mb))
        recv(pkts[first:first + count])
        flags[first:first + count] = 1       # after the packet words
        lag = time.time_ns() - t_ns
        got += count
        lag_sum += lag * count
        rec["messages"] += 1
        rec["packets"] += count
        rec["lag_ms_max"] = max(rec["lag_ms_max"], lag / 1e6)
    rec["lag_ms_mean"] = lag_sum / max(got, 1) / 1e6


class Relay:
    """One end of a relayed link k: a daemon thread that runs
    :func:`send_loop` (``role="send"``, on rank k's out-link) or
    :func:`recv_loop` (``role="recv"``, on rank k + 1's in-link) over
    ``group``, from :meth:`start` to the link's last row block.  A failure
    is kept in :attr:`error`."""

    def __init__(self, link, k: int, role: str, group, timeout_s: float):
        import torch.distributed as dist
        self.k, self.role, self.error = k, role, None
        self.rec = {"link": k, "role": role, "messages": 0, "packets": 0,
                    "wall_s": None}
        if role == "recv":
            self.rec.update(lag_ms_max=0.0, lag_ms_mean=None)
        self._stop = threading.Event()
        if role == "send":
            self._call = lambda: send_loop(
                link, lambda t: dist.send(t, dst=k + 1, group=group),
                timeout_s, self._stop, self.rec)
        else:
            self._call = lambda: recv_loop(
                link, lambda t: dist.recv(t, src=k, group=group), self.rec)
        self._thread = threading.Thread(
            target=self._run, name="ring-relay-%s-%d" % (role, k),
            daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            self._call()
        except BaseException as exc:   # re-raised by finish() or fail()
            self.error = exc
        else:
            self.rec["wall_s"] = time.perf_counter() - t0
            stats.append(self.rec)

    def stop(self) -> None:
        """Make a sender return at its next poll."""
        self._stop.set()

    def join(self, timeout_s: float) -> bool:
        """Wait up to ``timeout_s`` for the thread; whether it ended."""
        self._thread.join(timeout_s)
        return not self._thread.is_alive()


def finish(relays, timeout_s: float) -> None:
    """After a card's step that succeeded: wait for every relay (a sender
    may still send its last messages) and raise the first one's error,
    or TimeoutError for one still running after ``timeout_s``."""
    for r in relays:
        if not r.join(timeout_s):
            r.stop()
            raise TimeoutError("ring relay: the %s thread of link %d still "
                               "runs after %g s" % (r.role, r.k, timeout_s))
        if r.error is not None:
            raise r.error


def fail(relays, exc: BaseException, grace_s: float = 2.0) -> None:
    """After a card's step that raised ``exc``: stop every relay, give
    each ``grace_s`` to end, and raise the first relay's error, from
    ``exc``, where one failed (a dead relay is why a card's step times
    out or traps); return where none did."""
    for r in relays:
        r.stop()
    for r in relays:
        r.join(grace_s)
        if r.error is not None:
            raise r.error from exc
