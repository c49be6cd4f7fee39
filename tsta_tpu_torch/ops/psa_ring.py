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
The route follows the mesh's ``seq`` row (``parallel.mesh.seq_route``):

* **One card repeated**: every shard is a co-resident thread block of one
  launch of the score-only body ``csrc/psa_dp.cu`` at one pair (K1's
  kernel, with C = n / D and T the caller's), and a packet is a store to
  global memory published behind a release flag (no slot is reused, so
  no ack).
* **Distinct cards** (:func:`run_ring_cards`): card k holds JAX's chip
  shard, the columns [k*C, (k+1)*C), and runs one launch of the body's
  linked build over them, cut into the blocks of the card's own plan.
  The packets at a card's right edge go into a link in mapped host memory
  (``_kernels.RingLink``), which block 0 of the next card reads at system
  scope.  A slot is written once and a card waits only on the card to its
  left, so the launches may run in order on one card, overlap on several,
  or run in several processes (:func:`align_long_ring_ranks`), with the
  same build: ranks of one node map one link, ranks on two nodes each
  their own, and a relay thread at each end forwards the packets over
  gloo (``parallel/ring_relay.py``).
* **The CPU**: the plain version :func:`ring_plain`, JAX's ``longseq``
  schedule as torch ops: at pipeline step s every shard d runs row block
  s - d at once, so it costs (m + (D - 1) T) rows of (D, C) tensor ops;
  :func:`ring_card_plain` is the plain version of one card's linked
  launch.

Score-only and exact: ``best`` is the max of H over the rows i < m_real
and every padded column, ``corner`` is H(m_real - 1, n_real - 1), as in
JAX (``psa_ring.py:216-224, 247-250, 303-304``).  Values stay int32.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import resolve_device
from tsta_tpu_torch.io import encode_dna
from tsta_tpu_torch.ops import _kernels, psa_scan
from tsta_tpu_torch.ops.psa_scan import A_PAD, B_PAD, NEG, as_params
from tsta_tpu_torch.parallel.mesh import on_device, seq_route

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


def _row(h, e, a32, bi, fill, seed, col_e, params):
    """One DP row over S strips of columns (``h``, ``e``: (S, W) int32,
    the row above; ``a32`` (S, W); ``bi`` the row's base, broadcast to
    (S, 1); ``fill`` and ``seed`` (S,): each strip's diagonal shift-in
    H(i-1, first column - 1) and F seed; ``col_e`` (S, W), each column's
    global index times e).  Returns (H, E, p, y) of the row: p the
    exclusive F prefix (the running max of C(k) - k*e left of each column,
    seeded), y = C - col*e, so max(p, y) is the inclusive prefix.  JAX's
    ``longseq._row_update``."""
    m_, x_, e_, o_ = params
    S = h.shape[0]
    sub = torch.where(a32 == bi, m_, x_)
    diag = torch.cat([fill.view(S, 1), h[:, :-1]], dim=1) + sub
    e_row = torch.maximum(e + e_, h + (o_ + e_))
    c = torch.maximum(diag, e_row)
    y = c - col_e
    p = torch.cummax(torch.cat([seed.view(S, 1), y[:, :-1]], dim=1),
                     dim=1).values
    return torch.maximum(c, p + (o_ + col_e)), e_row, p, y


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
    params = as_params(params)
    m_, x_, e_, o_ = params
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
            h_row, e_row, p, y = _row(h, e, a32, b32[i.long()].view(D, 1),
                                      fill, seed, col_e, params)
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


@torch.no_grad()
def ring_card_plain(a: torch.Tensor, b: torch.Tensor, n_real: int,
                    m_real: int, params, D: int, T: int, col_base: int = 0,
                    link_in=None, link_out=None, timeout_s: float = 600.0):
    """The plain version of one card's launch of the ring's linked build
    (``_kernels.psa_ring_linked``): ``a`` (n,) uint8, the pair's global
    columns [col_base, col_base + n), in D shards of C = ceil(n / D)
    columns (the last one narrower where C does not divide n); ``b`` (m,)
    uint8, m a multiple of T; ``n_real`` and ``m_real`` the pair's.  Row
    block rb's left edge is the DP's boundary on the first card
    (``link_in`` None), else the packet ``link_in.get(rb)`` returns, which
    blocks until the card to the left has written it (TimeoutError past
    ``timeout_s``).  Returns ``(out, comm, link_pkts)``: ``out`` (D, 2)
    int32, each shard's best over the rows < m_real and its corner (NEG
    where the corner is not in it), ``comm`` (D, m // T, 2T) int32, each
    shard's packet of each row block, values at its last column, and the
    packets put into ``link_out`` row block by row block (the last
    shard's; None without ``link_out``).  One row of the card's columns
    at a time, :func:`ring_plain`'s row body."""
    if a.device.type == "cuda":
        psa_scan.plain_calls += 1
    params = as_params(params)
    m_, x_, e_, o_ = params
    n, m = a.numel(), b.numel()
    C = -(-n // max(D, 1))
    if D < 1 or -(-n // C) != D or m % T:
        raise ValueError("ring_card_plain: %d columns in %d shards, m %d a "
                         "multiple of T %d" % (n, D, m, T))
    mb = m // T
    dev, i32 = a.device, torch.int32
    a32 = a.to(i32).view(1, n)
    b32 = b.to(i32)
    col = col_base + torch.arange(n, dtype=i32, device=dev).view(1, n)
    col_e = col * e_
    h = o_ + (col + 1) * e_                       # H(-1, col)
    e = torch.full((1, n), NEG, dtype=i32, device=dev)
    lasts = torch.tensor([min((d + 1) * C, n) - 1 for d in range(D)],
                         device=dev)
    pad = D * C - n                                # the last shard's gap
    best = torch.full((D,), NEG, dtype=i32, device=dev)
    corner = torch.full((D,), NEG, dtype=i32, device=dev)
    comm = torch.empty((D, mb, 2 * T), dtype=i32, device=dev)
    ccol = n_real - 1 - col_base                   # the corner's column here
    for rb in range(mb):
        pkt = None if link_in is None else link_in.get(rb, timeout_s).to(dev)
        blk = comm[:, rb]
        for r in range(T):
            i = rb * T + r
            if pkt is None:
                fill = torch.tensor([0 if i == 0 else o_ + i * e_],
                                    dtype=i32, device=dev)
                seed = torch.tensor([o_ + (i + 2) * e_], dtype=i32,
                                    device=dev)
            else:
                fill, seed = pkt[r:r + 1], pkt[T + r:T + r + 1]
            blk[:, r] = h[0, lasts]                 # H(i-1, each last column)
            h_row, e, p, y = _row(h, e, a32, b32[i], fill, seed, col_e,
                                  params)
            blk[:, T + r] = torch.maximum(p[0, lasts], y[0, lasts])
            if i < m_real:
                rows = (torch.cat([h_row, torch.full((1, pad), NEG, dtype=i32,
                                                     device=dev)], dim=1)
                        if pad else h_row)
                best = torch.maximum(best, rows.view(D, C).amax(dim=1))
            if i == m_real - 1 and 0 <= ccol < n:
                corner[ccol // C] = h_row[0, ccol]
            h = h_row
        if link_out is not None:
            link_out.put(rb, blk[D - 1].cpu())
    return (torch.stack([best, corner], dim=1), comm,
            None if link_out is None else comm[D - 1])


def card_shards(C_card: int, T: int, dev, D=None) -> int:
    """The blocks of one card's linked launch over ``C_card`` columns:
    ``D`` when given, else on a card the score-only plan at one pair
    (``psa_diff.score_plan``, the library's ``tsta_psa_dp_layout``) capped
    at the card's resident limit, on the CPU one shard."""
    dev = torch.device(dev)
    if D is None:
        if dev.type == "cpu":
            return 1
        from tsta_tpu_torch.ops import psa_diff
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        D, C, _, _ = psa_diff.score_plan(1, C_card, sms)
        D = min(D, _kernels.psa_ring_linked_max_blocks(C, T, dev))
        D = -(-C_card // -(-C_card // D))   # the shards C = ceil(n / D) make
    C = -(-C_card // max(D, 1))
    if D < 1 or -(-C_card // C) != D:
        raise ValueError("%d columns do not make %d shards" % (C_card, D))
    return D


class CardsRun(NamedTuple):
    """What :func:`run_ring_cards` returns: ``best`` and ``corner`` (the
    max over the cards, JAX's ``pmax``), and per card k its ``outs[k]``
    ((D_k, 2) int32) and ``comms[k]`` ((D_k, m // T, 2T) int32), on its
    device, and ``shards[k]``, D_k; ``links[k]`` ((m // T, 2T) int32, on
    the host) the packets of the link from card k to card k + 1."""
    best: int
    corner: int
    outs: list
    comms: list
    shards: list
    links: list


def run_ring_cards(a: torch.Tensor, b: torch.Tensor, n_real: int,
                   m_real: int, params, devices, T: int, D=None,
                   stats=None) -> CardsRun:
    """The ring across cards over padded ``a`` ((n,) uint8, n a multiple
    of K = ``len(devices)``) and ``b`` ((m,) uint8, m a multiple of T), on
    the host or any device: card k runs the columns [k*C, (k+1)*C), C = n
    / K, on ``devices[k]``, in D_k shards (``D``: one count or one a card;
    default :func:`card_shards`), and writes the link to card k + 1 (K - 1
    in-process ``_kernels.RingLink``s, made here and closed before
    returning), each card :func:`_card`.

    * CPU devices: :func:`ring_card_plain` card by card.
    * Cards (a card may repeat): every link registered on its cards first,
      then one launch of ``psa_dp.cu``'s linked build a card, enqueued in
      card order, each on its card's current stream, before any is
      awaited.  So a card's launches follow one another on one stream, and
      a launch never waits on one queued behind it: K launches on one card
      run one after the other, on K cards they overlap.

    ``stats``, a list, gets ``{"ms": [...], "shards": [...]}``: each
    card's milliseconds (CUDA events around its launch; the host clock on
    the CPU) and D_k.  Nothing falls back: a registration or a launch that
    fails raises."""
    devices = [torch.device(d) for d in devices]
    K = len(devices)
    kinds = {d.type for d in devices}
    if K < 1 or len(kinds) != 1:
        raise ValueError("the ring's cards run on one device type, got %s"
                         % [str(d) for d in devices])
    n, m = a.numel(), b.numel()
    if n % K or m % T:
        raise ValueError("%d columns over %d cards, %d rows in blocks of %d"
                         % (n, K, m, T))
    C_card, mb = n // K, m // T
    params = as_params(params)
    Ds = list(D) if isinstance(D, (list, tuple)) else [D] * K
    Ds = [card_shards(C_card, T, dv, d) for dv, d in zip(devices, Ds)]
    links = [_kernels.RingLink(mb, T) for _ in range(K - 1)]
    cuda = kinds == {"cuda"}
    try:
        if cuda:
            for k, dev in enumerate(devices):
                for lk in links[max(k - 1, 0):k + 1]:
                    lk.attach(dev)
        cards = [_card(a[k * C_card:(k + 1) * C_card], b, n_real, m_real,
                       params, Ds[k], T, k * C_card, sum(Ds[:k]),
                       links[k - 1] if k else None,
                       links[k] if k < K - 1 else None, dev)
                 for k, dev in enumerate(devices)]
        if cuda:
            for dev in set(devices):
                torch.cuda.synchronize(dev)
        if stats is not None:
            stats.append({"ms": [t if isinstance(t, float)
                                 else t[0].elapsed_time(t[1])
                                 for _, _, t in cards], "shards": Ds})
        best = max(int(o[:, 0].max()) for o, _, _ in cards)
        corner = max(int(o[:, 1].max()) for o, _, _ in cards)
        pkts = [lk.pkts.clone() for lk in links]
    finally:
        if cuda:   # no launch may still use a link's memory
            for dev in set(devices):
                try:
                    torch.cuda.synchronize(dev)
                except RuntimeError:
                    pass
        for lk in links:
            lk.close()
    return CardsRun(best, corner, [c[0] for c in cards],
                    [c[1] for c in cards], Ds, pkts)


def _card(a_k, b, n_real, m_real, params, D, T, col_base, shard_base,
          link_in, link_out, dev, timeout_s: float = 600.0):
    """One card of the ring across cards, the columns [col_base, col_base
    + n) of the padded pair in ``a_k`` (n,), in D shards, the global index
    of its first ``shard_base``, its left packets from ``link_in`` (None
    on the first card), its right edge into ``link_out`` (None on the
    last): on the CPU :func:`ring_card_plain`, run to its end; on a card
    one launch of ``psa_dp.cu``'s linked build on the card's current
    stream, not awaited.  Returns ``(out, comm, time)``: ``out`` (D, 2)
    and ``comm`` (D, m // T, 2T) int32 on ``dev``, ``time`` the
    milliseconds on the CPU, else the (start, end) CUDA events around the
    launch."""
    if dev.type == "cpu":
        t0 = time.perf_counter()
        out, comm, _ = ring_card_plain(a_k.cpu(), b.cpu(), n_real, m_real,
                                       params, D, T, col_base, link_in,
                                       link_out, timeout_s)
        return out, comm, (time.perf_counter() - t0) * 1e3
    with on_device(dev):
        a_k, b = a_k.to(dev), b.to(dev)
        lens = torch.tensor([[n_real, m_real]], dtype=torch.int32, device=dev)
        comm = torch.empty((D, b.numel() // T, 2 * T), dtype=torch.int32,
                           device=dev)
        out = torch.empty((D, 2), dtype=torch.int32, device=dev)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _kernels.psa_ring_linked(a_k, b, lens, params, D, T, col_base,
                                 shard_base, link_in, link_out, comm, out)
        ev[1].record()
    return out, comm, ev


def align_padded(a, b, params, mesh, T: int):
    """Pad ``a`` and ``b`` for ``mesh``'s ``seq`` axis and run the ring on
    its route (``parallel.mesh.seq_route``): the CPU the plain version, one
    card repeated one launch of D = K blocks, distinct cards
    :func:`run_ring_cards`; ``(best, corner)`` as Python ints."""
    route, row = seq_route(mesh)
    devs = [resolve_device(d) for d in row]
    K = mesh.shape["seq"]
    a_p, b_p, n_real, m_real = pad_pair(a, b, K, T)
    a_t, b_t = torch.from_numpy(a_p), torch.from_numpy(b_p)
    if route == "cards":
        run = run_ring_cards(a_t, b_t, n_real, m_real, params, devs, T)
        return run.best, run.corner
    return run_ring(a_t.to(devs[0]), b_t.to(devs[0]), n_real, m_real, params,
                    K, T)


def align_long_ring(a, b, params: AlignParams = AlignParams(), mesh=None,
                    T: int = 256):
    """Score-only alignment of one long pair by the ring wavefront, its
    columns sharded over the mesh's ``seq`` axis (``parallel.mesh``).

    Returns ``(best, corner)`` with the reference's matrix-max semantics.
    A one-card mesh runs one launch of ``csrc/psa_dp.cu`` with D =
    ``mesh.shape["seq"]`` blocks, a mesh of distinct cards one launch a
    card (:func:`run_ring_cards`), a CPU mesh the plain version."""
    if mesh is None:
        raise ValueError("align_long_ring requires a mesh with a 'seq' axis")
    return align_padded(a, b, params, mesh, T)


def align_long_ring_ranks(a, b, params: AlignParams = AlignParams(),
                          T: int = 256, device=None, D=None):
    """The ring across the processes of the default ``torch.distributed``
    group (``parallel.mesh.maybe_init_distributed``: ``TSTA_COORDINATOR``,
    ``TSTA_NUM_PROCESSES``, ``TSTA_PROCESS_ID``), the counterpart of JAX's
    ``align_long_ring`` on a ``jax.distributed`` mesh: rank k of K is card
    shard k, the columns [k*C, (k+1)*C) of ``a`` padded to a multiple of
    128 * K, on its device (``msa_multihost.rank_device(device)``: a card
    or, with ``device="cpu"``, the plain version), in ``D`` shards
    (default :func:`card_shards`), one :func:`_card` step.

    Link k, rank k to rank k + 1, is a ``_kernels.RingLink`` (shared
    memory without a name) that rank k makes.  Where both ranks run on one
    node (``parallel.ring_relay.node_id``), rank k + 1 maps it from its
    path (``/proc/<rank k's pid>/fd/<fd>``, sent over the group), and the
    cards read and write it directly.  Where they do not, rank k + 1 makes
    an in-link of its own and a ``ring_relay.Relay`` at each end forwards
    each row block's packet and flag over the link's two-rank gloo group.
    Each rank maps its links before any rank goes on, and nothing is left
    behind however a rank ends.  ``best`` and ``corner`` come from an
    ``all_reduce(MAX)``, so every rank returns the same ``(best,
    corner)``.  Without a group of two or more ranks it is
    :func:`run_ring_cards` on the one device.  A rank that dies makes the
    others fail at their next wait (the groups' timeout,
    ``TSTA_DIST_TIMEOUT_S``; the plain version's wait on a link; the
    kernel's watchdog); a relay that fails is re-raised after the card's
    step.  Nothing falls back to one rank or to the CPU."""
    from tsta_tpu_torch.parallel import mesh as meshlib
    from tsta_tpu_torch.parallel import ring_relay
    from tsta_tpu_torch.parallel.msa_multihost import rank_device, world

    rank, K = world()
    dev = rank_device(device)
    a_p, b_p, n_real, m_real = pad_pair(a, b, K, T)
    a_t, b_t = torch.from_numpy(a_p), torch.from_numpy(b_p)
    if K == 1:
        run = run_ring_cards(a_t, b_t, n_real, m_real, params, [dev], T, D=D)
        return run.best, run.corner
    import torch.distributed as dist
    C_card, mb = a_t.numel() // K, b_t.numel() // T
    Dk = card_shards(C_card, T, dev, D)
    timeout_s = float(os.environ.get("TSTA_DIST_TIMEOUT_S",
                                     meshlib.DIST_TIMEOUT_S))
    ranks = [None] * K        # (node, D_k) of every rank
    dist.all_gather_object(ranks, (ring_relay.node_id(), Dk))
    relayed = [ranks[k][0] != ranks[k + 1][0] for k in range(K - 1)]
    groups = ring_relay.link_groups(relayed, timeout_s)
    links, relays = [], []
    try:
        link_out = _kernels.RingLink(mb, T) if rank < K - 1 else None
        if link_out is not None:
            links.append(link_out)
        paths = [None] * K
        dist.all_gather_object(paths, link_out.path if link_out else None)
        link_in = None
        if rank:
            link_in = _kernels.RingLink(
                mb, T, None if relayed[rank - 1] else paths[rank - 1])
            links.append(link_in)
        dist.barrier()   # every rank has mapped its links
        if rank and relayed[rank - 1]:
            relays.append(ring_relay.Relay(link_in, rank - 1, "recv",
                                           groups[rank - 1], timeout_s))
        if rank < K - 1 and relayed[rank]:
            relays.append(ring_relay.Relay(link_out, rank, "send",
                                           groups[rank], timeout_s))
        for r in relays:
            r.start()
        try:
            out = _card(a_t[rank * C_card:(rank + 1) * C_card], b_t, n_real,
                        m_real, as_params(params), Dk, T, rank * C_card,
                        sum(d for _, d in ranks[:rank]), link_in, link_out,
                        dev, timeout_s)[0]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except BaseException as exc:
            ring_relay.fail(relays, exc)
            raise
        ring_relay.finish(relays, timeout_s)
        mine = out.amax(dim=0).cpu()
    finally:
        for lk in links:
            lk.close()
    dist.all_reduce(mine, op=dist.ReduceOp.MAX)
    for g in groups.values():   # every relay of every rank has ended
        dist.destroy_process_group(g)
    best, corner = mine.tolist()
    return best, corner
