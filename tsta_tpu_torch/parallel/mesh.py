"""Device mesh construction and the joining of processes.

Counterpart of ``tsta_tpu/parallel/mesh.py``.  A :class:`Mesh` has the
JAX mesh's two logical axes:

* ``data`` -- independent alignment problems: a batch of pairs is cut
  into one contiguous share per row of devices (:func:`data_sharding`,
  JAX's ``P("data")``), each share run on its row's first device;
* ``seq``  -- column sharding of one long problem: one long pair
  (``ops/psa_ring.py``, ``parallel/longseq.py``), the reference's
  anti-diagonal tile wavefront, or one POA round's columns
  (``parallel/msa_longseq.py``).

A device may repeat: ``make_mesh(1, 8, devices=[torch.device("cuda", 0)]
* 8)`` is a virtual mesh of eight ``seq`` shards on one card, each shard a
co-resident thread block of one kernel launch, the counterpart of the JAX
tests' eight virtual CPU devices; ``[torch.device("cpu")] * 8`` runs the
plain versions.  :func:`seq_route` picks the PSA ring's route from the
devices: the CPU, one card repeated, or distinct cards, each card a
launch of its columns (``ops/psa_ring.py``); a POA round's ``seq`` axis
also runs over distinct cards (``parallel/msa_longseq.py``).

Several processes (one a card, or several on one card or the CPU) join
through :func:`maybe_init_distributed`, which reads the JAX package's
``TSTA_COORDINATOR``, ``TSTA_NUM_PROCESSES`` and ``TSTA_PROCESS_ID`` and
starts a ``torch.distributed`` process group on the gloo backend: only
small host tensors cross processes (chunk edges, sink scores, walk
hand-offs, align segments), gloo carries them on any device, and NCCL
refuses two ranks on one card.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from tsta_tpu_torch.device import resolve_device

AXES = ("data", "seq")
# seconds a rank waits on another before the process group gives up, so a
# rank that died fails the others instead of hanging them
DIST_TIMEOUT_S = 600


def maybe_init_distributed() -> bool:
    """Join the processes named by ``TSTA_COORDINATOR`` (``host:port`` of
    rank 0), ``TSTA_NUM_PROCESSES`` and ``TSTA_PROCESS_ID`` in a gloo
    process group; without ``TSTA_COORDINATOR`` do nothing, as the JAX
    package does.  ``TSTA_DIST_TIMEOUT_S`` (default
    :data:`DIST_TIMEOUT_S`) bounds every wait on another rank.  Returns
    whether a process group is up."""
    import torch.distributed as dist
    addr = os.environ.get("TSTA_COORDINATOR")
    if not addr:
        return False
    if dist.is_initialized():
        return True
    timeout_s = float(os.environ.get("TSTA_DIST_TIMEOUT_S", DIST_TIMEOUT_S))
    dist.init_process_group(
        "gloo", init_method="tcp://" + addr,
        world_size=int(os.environ.get("TSTA_NUM_PROCESSES", "1")),
        rank=int(os.environ.get("TSTA_PROCESS_ID", "0")),
        timeout=datetime.timedelta(seconds=timeout_s))
    # an exit that leaves the group to the interpreter's teardown can
    # abort in gloo's threads
    atexit.register(_leave)
    return True


def _leave() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """A (data, seq) grid of ``torch.device``s: ``devices`` is an object
    array of that shape, ``shape`` the dict ``{"data": ..., "seq": ...}``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))


def make_mesh(data: Optional[int] = None, seq: int = 1,
              devices=None) -> Mesh:
    """Build a (data, seq) mesh over ``devices`` (default: every CUDA
    device; raises ``DeviceError`` where there is none)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // seq
    if data < 1 or seq < 1 or data * seq > n:
        raise ValueError("mesh %dx%d needs %d devices, have %d"
                         % (data, seq, data * seq, n))
    grid = np.empty(data * seq, dtype=object)
    grid[:] = devices[:data * seq]
    return Mesh(grid.reshape(data, seq))


def cli_mesh(spec: str, device) -> Optional[Mesh]:
    """The CLI's ``--mesh DATAxSEQ``: None for ``1x1``; on ``--device
    cpu`` the CPU repeated DATA * SEQ times (the plain versions), else the
    visible cards, ``mesh %dx%d needs %d devices, have %d`` past them."""
    data, seq = (int(v) for v in spec.lower().split("x"))
    if (data, seq) == (1, 1):
        return None
    if torch.device(device).type == "cpu":
        return make_mesh(data, seq, devices=["cpu"] * (data * seq))
    return make_mesh(data, seq)


def data_sharding(mesh: Mesh, n: int) -> List[Tuple[int, int,
                                                     torch.device]]:
    """JAX's ``P("data")`` split of n items over ``mesh``'s ``data`` axis:
    for each row of devices, ``(start, stop, device)``, its contiguous
    share of ceil(n / rows) items (the last shares shorter or empty) and
    the row's first device, which runs it."""
    rows = mesh.shape["data"]
    per = -(-n // rows) if n else 0
    return [(min(r * per, n), min((r + 1) * per, n),
             resolve_device(mesh.devices[r, 0])) for r in range(rows)]


def shares(mesh, n: int, device=None) -> List[Tuple[int, int,
                                                     torch.device]]:
    """:func:`data_sharding` of n items over ``mesh``, or without a mesh
    one share of all of them on ``device``."""
    if mesh is None:
        return [(0, n, resolve_device(device))]
    return data_sharding(mesh, n)


def on_device(dev):
    """A context that makes ``dev`` the current card (nothing for the
    CPU), so that every launch of a share or window on a mesh of distinct
    cards goes to its own card."""
    dev = torch.device(dev)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def replicated(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` on each device of ``mesh``, row by row (JAX's ``P()``): one
    tensor a mesh position, the same tensor where a device repeats."""
    return [t.to(resolve_device(d)) for d in mesh.devices.flat]


def seq_route(mesh: Mesh) -> Tuple[str, List[torch.device]]:
    """The route of a long pair's ``seq`` axis, from ``mesh``'s first row
    of devices (the ``data`` axis only replicates a long pair), touching
    no card: ``("cpu", row)`` where the row is all the CPU (the plain
    versions), ``("one_card", row)`` where it is one card repeated (every
    shard a block of one launch), ``("cards", row)`` where it holds
    distinct cards (one launch a card, ``psa_ring.run_ring_cards``).  A
    row of the CPU and cards raises ``ValueError``; the caller resolves
    the devices, so a card on a host without one raises ``DeviceError``
    there."""
    row = [torch.device(d) for d in mesh.devices[0]]
    kinds = {d.type for d in row}
    if kinds == {"cpu"}:
        return "cpu", row
    if kinds != {"cuda"}:
        raise ValueError("a seq axis runs on one device type, got %s"
                         % sorted(str(d) for d in row))
    return ("one_card" if len({d.index for d in row}) == 1 else "cards"), row
