"""Device mesh construction.

Counterpart of ``tsta_tpu/parallel/mesh.py``.  A :class:`Mesh` has the
JAX mesh's two logical axes:

* ``data`` -- independent alignment problems;
* ``seq``  -- column sharding of one long pair (``ops/psa_ring.py``,
  ``parallel/longseq.py``), the reference's anti-diagonal tile wavefront.

A device may repeat: ``make_mesh(1, 8, devices=[torch.device("cuda", 0)]
* 8)`` is a virtual mesh of eight ``seq`` shards on one card, each shard a
co-resident thread block of ``csrc/psa_dp.cu``, the counterpart of the
JAX tests' eight virtual CPU devices; ``[torch.device("cpu")] * 8`` runs
the plain versions.  :func:`seq_device` picks the route from the devices.

Not here yet: ``maybe_init_distributed`` (``jax.distributed`` for several
hosts), ``data_sharding`` and ``replicated`` (XLA shardings of the ``data``
axis) and a ``seq`` axis over distinct cards.  They belong to the
multi-GPU slice (ROADMAP Queue 1 step 5), with ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tsta_tpu_torch.device import resolve_device

AXES = ("data", "seq")


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


def seq_device(mesh: Mesh) -> torch.device:
    """The one device that runs ``mesh``'s ``seq`` axis: its first row of
    devices (the ``data`` axis only replicates a long pair) must be all
    the CPU, which runs the plain versions, or all one card, which runs
    every shard as a block of one launch.  Distinct cards raise
    ``NotImplementedError``: the cross-card ring is not ported."""
    row = [torch.device(d) for d in mesh.devices[0]]
    kinds = {d.type for d in row}
    if kinds == {"cpu"}:
        return torch.device("cpu")
    if kinds != {"cuda"}:
        raise ValueError("a seq axis runs on one device type, got %s"
                         % sorted(str(d) for d in row))
    if len({d.index for d in row}) > 1:
        raise NotImplementedError(
            "a seq axis over distinct cards (%s) is not ported: the ring's "
            "packets stored into a peer card's buffer wait for the "
            "multi-GPU slice (ROADMAP Queue 1 step 5); put every seq shard "
            "on one card" % ", ".join(str(d) for d in row))
    return resolve_device(row[0])


def refuse_data_axis(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` is given to ``what``,
    whose JAX counterpart shards its problems over the ``data`` axis."""
    if mesh is not None:
        raise NotImplementedError(
            "%s over a mesh is not ported: sharding the data axis across "
            "cards waits for the multi-GPU slice (ROADMAP Queue 1 step 5). "
            "A mesh runs one long pair's seq axis on one card or the CPU: "
            "parallel.mesh.make_mesh, ops.psa_ring.align_long_ring, "
            "parallel.longseq.align_long" % what)
