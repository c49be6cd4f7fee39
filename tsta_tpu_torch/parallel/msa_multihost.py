"""One progressive MSA across processes: a replicated graph, each round's
columns over the processes' windows, and each round's graph delta
replayed on every process.

Counterpart of ``tsta_tpu/parallel/msa_multihost.py``.  The reference
shares one POA graph between pthreads under a lock
(msa/c-t-simd.c:659-977); across processes there is no shared memory, so:

* the graph is replicated: every process holds its own host copy and
  replays the same mutations;
* each round runs as ``parallel/msa_longseq.py``'s column-window
  wavefront with one window a process, on that process's device: rank d
  holds the columns [d*C, (d+1)*C) and its words plane stays there;
  :class:`GlooLink` carries a chunk's edge from rank d to rank d + 1 by
  ``send``/``recv`` and takes the sink scores' maximum by ``all_reduce``;
* the walk runs window by window from the rank that holds the read's
  last column down to rank 0, each rank's (row, j, state) exit and align
  segment broadcast from it (JAX's ``_distributed_walk``), so every rank
  assembles the round's align map;
* that map is the round's delta: every rank merges it into its graph
  (``msa_native._merge``, the merge ``PoaGraph.apply_delta`` replays), a
  pure function of (graph, read, order, map), so the graphs stay
  bit-identical and the next round's tables equal.

The round loop is ``msa_native.align_seqs``'s, given the link; every rank
returns the same ``MsaOutput``.  The processes join through
``parallel.mesh.maybe_init_distributed`` (``TSTA_COORDINATOR``,
``TSTA_NUM_PROCESSES``, ``TSTA_PROCESS_ID``); with one process, or none
joined, it is ``align_seqs`` over the mesh.  Only host tensors of a few
KB cross processes, by gloo, whatever the device; a rank that fails
makes the others' next wait fail at the process group's timeout instead
of hanging.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import resolve_device


class GlooLink:
    """One window a process, over the default ``torch.distributed``
    process group: rank d owns window d, on ``device`` in this process
    (``devices``: None at the other ranks' windows)."""

    def __init__(self, device):
        import torch.distributed as dist
        self.dist = dist
        self.rank = dist.get_rank()
        self.devices = [None] * dist.get_world_size()
        self.devices[self.rank] = resolve_device(device)

    def owns(self, d: int) -> bool:
        return d == self.rank

    def send_edge(self, d: int, c: int, edge: torch.Tensor) -> None:
        self.dist.send(edge.cpu().contiguous(), dst=d + 1)

    def recv_edge(self, d: int, c: int, shape, dev) -> torch.Tensor:
        buf = torch.empty(shape, dtype=torch.int32)
        self.dist.recv(buf, src=d - 1)
        return buf.to(dev)

    def max_scores(self, scores: list, N: int) -> np.ndarray:
        """The maximum of every rank's (N,) sink scores (NEG where a rank
        owns no window holding the read)."""
        from tsta_tpu_torch.ops.psa_scan import NEG
        mine = (scores[0].cpu().clone() if scores
                else torch.full((N,), NEG, dtype=torch.int32))
        self.dist.all_reduce(mine, op=self.dist.ReduceOp.MAX)
        return mine.numpy()

    def share(self, d: int, payload: torch.Tensor) -> torch.Tensor:
        """Window d's hand-off, broadcast from rank d."""
        payload = payload.contiguous()
        self.dist.broadcast(payload, src=d)
        return payload


def world() -> tuple:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None, mesh=None) -> torch.device:
    """This rank's device: ``device`` (``cuda`` without an index: card
    rank % the visible cards, one process a card), else its place in
    ``mesh``'s ``seq`` row, else ``cuda``."""
    rank, _ = world()
    if device is None and mesh is not None:
        return resolve_device(mesh.devices[0][rank])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        return torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(dev)


def align_seqs_multihost(seqs: List[bytes],
                         params: AlignParams = AlignParams(), mesh=None,
                         device=None, kernel: str = "auto",
                         rows_per_chunk: int | None = None, stats=None):
    """Progressive POA MSA with each round's columns over every process's
    window and the graph deltas replayed on each.

    Every process calls this with the same ``seqs`` and ``params``.  With
    a process group of P > 1 ranks the round has P windows, rank d's on
    its device (:func:`rank_device`; a ``mesh``, if given, has a ``seq``
    axis of P); with one process it is ``msa_native.align_seqs`` over
    ``mesh`` (default every visible card, or ``device`` alone).
    ``kernel``: "plain" runs the plain versions on the card.
    ``rows_per_chunk`` and ``stats`` as in ``msa_longseq.wavefront_round``,
    which appends each round's plan and this rank's window times to
    ``stats`` when given.  Returns the ``MsaOutput``, the same on every
    rank."""
    from tsta_tpu_torch.ops import msa_native
    from tsta_tpu_torch.parallel import mesh as meshlib

    rank, size = world()
    link = None
    if size > 1:
        if mesh is not None and mesh.shape["seq"] != size:
            raise ValueError("a mesh of %d seq shards for %d processes"
                             % (mesh.shape["seq"], size))
        link, mesh = GlooLink(rank_device(device, mesh)), None
    elif mesh is None:
        mesh = (meshlib.make_mesh(1, 1, devices=[device]) if device is not None
                else meshlib.make_mesh(1, max(1, torch.cuda.device_count())))
    return msa_native.align_seqs(seqs, params, kernel=kernel, mesh=mesh,
                                 link=link, rows_per_chunk=rows_per_chunk,
                                 stats=stats)
