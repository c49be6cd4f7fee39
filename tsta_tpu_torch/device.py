"""Device selection for the port.

Every entry point takes ``device=`` (the CLI's ``--device``).  A request
for CUDA on a host without a card raises: nothing falls back to the CPU
on its own.  The CPU runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"
DEVICE_SHARE = 0.85            # of the card's memory, as the TPU plans
CPU_BUDGET = 12 * 2 ** 30      # the TPU plans' budget without device stats


class DeviceError(RuntimeError):
    """The requested device is not available."""


def resolve_device(device=None) -> torch.device:
    """``None`` means :data:`DEFAULT_DEVICE`; ``"cuda"`` means the
    current card.  Raises :class:`DeviceError` when CUDA is asked for
    and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                "device %r requested but torch.cuda.is_available() is "
                "false; pass device='cpu' (CLI: --device cpu) to run the "
                "plain PyTorch versions on the host" % str(dev))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceError("unsupported device %r (use 'cuda' or 'cpu')"
                          % str(dev))
    return dev


def device_budget(device) -> int:
    """Bytes the memory plans (a POA round's planes, a traced PSA group's
    code planes, a chunked traced pair's chunks) may take on ``device``:
    ``TSTA_HBM_BUDGET_GB`` GiB when that variable is set, on either
    device (the JAX package's ``msa_pallas._hbm_budget``), else 0.85 of
    the card's total memory (``torch.cuda.mem_get_info``), or the TPU
    plans' 12 GiB default on the CPU.  Total, not free, memory: a route
    must not depend on what the caching allocator happens to hold."""
    env = os.environ.get("TSTA_HBM_BUDGET_GB")
    if env:
        return int(float(env) * 2 ** 30)
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1] * DEVICE_SHARE)
    return CPU_BUDGET
