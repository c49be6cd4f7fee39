"""The ring wavefront: one long pair's DP with its columns sharded.

Counterpart of ``tsta_tpu/ops/psa_ring.py``.  The pair's columns are cut
into D shards of C = n / D columns, D the mesh's ``seq`` size.  Rows
advance in blocks of T; shard d runs row block rb once shard d - 1 has
sent that block's *edge packet*, 2T int32 (JAX's layout, ``comm_ref``):

* lanes [0, T): H(rb*T - 1 + r, last column of the sender), the
  receiver's diagonal shift-in for row rb*T + r;
* lanes [T, 2T): the inclusive F prefix of row rb*T + r at the sender's
  last column, ``max(H(i,-1) + e, max_{k <= last} (C(k) - k*e))`` in
  global column space (the closed-form F of ``ops/psa_scan.py``), the
  receiver's F seed.

On the TPU each shard is a chip and the packet travels by remote DMA.
Here every ``seq`` shard of a one-card mesh is a co-resident thread block
of one launch of the score-only body ``csrc/psa_dp.cu`` at one pair (K1's
kernel, with C = n / D and T the caller's), and a packet is a store to
global memory published behind a release flag (no slot is reused, so no
ack).
A CPU mesh runs the plain version :func:`ring_plain`, JAX's ``longseq``
schedule as torch ops: at pipeline step s every shard d runs row block
s - d at once, so it costs (m + (D - 1) T) rows of (D, C) tensor ops.
Distinct cards raise (``parallel.mesh.seq_device``).

Score-only and exact: ``best`` is the max of H over the rows i < m_real
and every padded column, ``corner`` is H(m_real - 1, n_real - 1), as in
JAX (``psa_ring.py:216-224, 247-250, 303-304``).  Values stay int32.
"""

from __future__ import annotations

import numpy as np
import torch

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.io import encode_dna
from tsta_tpu_torch.ops import _kernels, psa_scan
from tsta_tpu_torch.ops.psa_scan import A_PAD, B_PAD, NEG, as_params
from tsta_tpu_torch.parallel.mesh import seq_device

LANES = 128


def pad_pair(a, b, D: int, T: int):
    """Encode and pad as JAX does: ``a`` to a multiple of 128 * D columns
    with A_PAD, ``b`` to a multiple of T rows with B_PAD.  Returns
    ``(a_pad, b_pad, n_real, m_real)``, the first two uint8 numpy."""
    a = encode_dna(a)
    b = encode_dna(b)
    n_real, m_real = int(a.shape[0]), int(b.shape[0])
    if n_real < 1 or m_real < 1:
        raise ValueError("empty sequence")
    if D < 1 or T < 1:
        raise ValueError("need D >= 1 shards and T >= 1 rows per block "
                         "(got %d, %d)" % (D, T))
    n = -(-n_real // (LANES * D)) * (LANES * D)
    m = -(-m_real // T) * T
    a_p = np.full(n, A_PAD, np.uint8)
    a_p[:n_real] = a
    b_p = np.full(m, B_PAD, np.uint8)
    b_p[:m_real] = b
    return a_p, b_p, n_real, m_real


@torch.no_grad()
def ring_plain(a: torch.Tensor, b: torch.Tensor, n_real: int, m_real: int,
               params, D: int, T: int):
    """The plain version of the ring's launch of ``csrc/psa_dp.cu``: ``a``
    (n,) uint8, n a multiple of D, ``b`` (m,) uint8, m a multiple of T,
    both padded.
    Returns ``(out, comm)``: ``out`` (D, 2) int32, each shard's best and
    its corner (NEG where the corner is not in the shard), and ``comm``
    (D, m // T, 2T) int32, the packet each shard sent for each row block.
    Each row is JAX's ``longseq._row_update`` on every active shard."""
    if a.device.type == "cuda":
        psa_scan.plain_calls += 1
    m_, x_, e_, o_ = as_params(params)
    oe = o_ + e_
    n, m = a.numel(), b.numel()
    C, mb = n // D, m // T
    dev, i32 = a.device, torch.int32
    a32 = a.to(i32).view(D, C)
    b32 = b.to(i32)
    col = torch.arange(n, dtype=i32, device=dev).view(D, C)
    col_e = col * e_
    h = o_ + (col + 1) * e_                       # H(-1, col)
    e = torch.full((D, C), NEG, dtype=i32, device=dev)
    best = torch.full((D,), NEG, dtype=i32, device=dev)
    corner = torch.full((D,), NEG, dtype=i32, device=dev)
    comm = torch.full((D, mb, 2 * T), NEG, dtype=i32, device=dev)
    shard = torch.arange(D, device=dev)
    first = shard == 0
    left = (shard - 1).clamp(min=0)
    has_corner = shard == (n_real - 1) // C
    ccol = (n_real - 1) % C
    for s in range(mb + D - 1):
        rb = s - shard
        active = (rb >= 0) & (rb < mb)
        rbc = rb.clamp(0, mb - 1)
        pkt = comm[left, rbc]          # shard d - 1's packet of block rb
        out = torch.empty((D, 2 * T), dtype=i32, device=dev)
        for r in range(T):
            i = (rbc * T + r).to(i32)
            out[:, r] = h[:, -1]                                # H(i-1, last)
            bound_prev = torch.where(i == 0, 0, o_ + i * e_)     # H(i-1, -1)
            seed_first = o_ + (i + 1) * e_ + e_                 # H(i, -1) + e
            fill = torch.where(first, bound_prev, pkt[:, r])
            seed = torch.where(first, seed_first, pkt[:, T + r])
            sub = torch.where(a32 == b32[i.long()].view(D, 1), m_, x_)
            diag = torch.cat([fill.view(D, 1), h[:, :-1]], dim=1) + sub
            e_row = torch.maximum(e + e_, h + oe)
            c = torch.maximum(diag, e_row)
            y = c - col_e
            p = torch.cummax(torch.cat([seed.view(D, 1), y[:, :-1]], dim=1),
                             dim=1).values
            h_row = torch.maximum(c, p + (o_ + col_e))
            out[:, T + r] = torch.maximum(p[:, -1], y[:, -1])
            valid = active & (i < m_real)
            best = torch.where(valid, torch.maximum(best, h_row.amax(dim=1)),
                               best)
            corner = torch.where(valid & (i == m_real - 1) & has_corner,
                                 h_row[:, ccol], corner)
            h = torch.where(active.view(D, 1), h_row, h)
            e = torch.where(active.view(D, 1), e_row, e)
        comm[shard[active], rbc[active]] = out[active]
    return torch.stack([best, corner], dim=1), comm


def ring_kernel(a: torch.Tensor, b: torch.Tensor, n_real: int, m_real: int,
                params, D: int, T: int):
    """One launch of ``csrc/psa_dp.cu`` at one pair, D blocks on one
    card: the arguments and outputs of :func:`ring_plain`."""
    mb = b.numel() // T
    out = torch.empty((D, 2), dtype=torch.int32, device=a.device)
    comm = torch.empty((D, mb, 2 * T), dtype=torch.int32, device=a.device)
    _kernels.psa_ring(a, b, D, T, n_real, m_real, as_params(params), comm,
                      out)
    return out, comm


def run_ring(a: torch.Tensor, b: torch.Tensor, n_real: int, m_real: int,
             params, D: int, T: int):
    """The ring over padded ``a`` and ``b``: a CPU tensor takes
    :func:`ring_plain`, a CUDA tensor launches the kernel or raises.
    Returns ``(best, corner)``, the max over the shards (JAX's ``pmax``)."""
    fn = ring_plain if a.device.type == "cpu" else ring_kernel
    out = fn(a, b, n_real, m_real, params, D, T)[0]
    best, corner = out.amax(dim=0).tolist()
    return best, corner


def align_padded(a, b, params, mesh, T: int):
    """Pad ``a`` and ``b`` for ``mesh``'s ``seq`` axis and run the ring on
    its device; ``(best, corner)`` as Python ints."""
    dev = seq_device(mesh)
    D = mesh.shape["seq"]
    a_p, b_p, n_real, m_real = pad_pair(a, b, D, T)
    return run_ring(torch.from_numpy(a_p).to(dev),
                    torch.from_numpy(b_p).to(dev), n_real, m_real, params,
                    D, T)


def align_long_ring(a, b, params: AlignParams = AlignParams(), mesh=None,
                    T: int = 256):
    """Score-only alignment of one long pair by the ring wavefront, its
    columns sharded over the mesh's ``seq`` axis (``parallel.mesh``).

    Returns ``(best, corner)`` with the reference's matrix-max semantics.
    A one-card mesh runs one launch of ``csrc/psa_dp.cu`` with D =
    ``mesh.shape["seq"]`` blocks; a CPU mesh the plain version."""
    if mesh is None:
        raise ValueError("align_long_ring requires a mesh with a 'seq' axis")
    return align_padded(a, b, params, mesh, T)
