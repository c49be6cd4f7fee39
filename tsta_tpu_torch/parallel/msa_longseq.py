"""Column-sharded POA rounds: one round's read columns over the mesh's
``seq`` axis.

Counterpart of ``tsta_tpu/parallel/msa_longseq.py`` (``round_dp_arrays``,
``round_dp``).  The route depends on where the ``seq`` row of devices
lives (``mesh.devices[0]``; the ``data`` axis only replicates a round):

* **All one card** (``[cuda:0] * K``): the meshless round
  (``msa_poa.run_round``) with its single ``poa_dp.cu`` launch at D = K
  column shards (``msa_poa.poa_dp``'s ``D``), each shard a co-resident
  block, then the single-call walk (``poa_walk.cu``), as the PSA ring's
  one-card route does (``parallel.mesh.seq_route``).  One launch holds at
  most K * 8,192 columns (32 a thread), and the round is not chunked.
* **Distinct devices, or the CPU** (a CPU row runs the plain versions):
  the column-window wavefront below, window d on device d.

The wavefront.  The read pads, as JAX pads it, to n, a multiple of 128 *
K columns, and window d holds the columns [d*C, (d+1)*C), C = n / K, on
its device: its slice of the read, its own ring (``poa_dp.cu``'s node
state, carried from chunk to chunk), its (N, C) words plane, which stays
on that device, and a table of its left neighbour's right edge by row.
The round's nodes go in chunks of NC rows in topo order, and cell (c, d)
is one ``poa_dp.cu`` launch over chunk c's rows and window d's columns
(``col0`` = d*C) with words on and the checkpoint (H, the F running max q,
F) at the window's last column, the edge window d + 1 needs.  Its fills
come from window d - 1's edges (``ops/msa_chunked.win_fills``); a node's
preds may lie many chunks back, so the edges are kept by row, not by
packet, as in JAX (which pipelines T_BLK = 32-row blocks by ``ppermute``).
Cells run in wavefront order: at step s window d runs chunk s - d, so
window d runs chunk c while window d + 1 runs chunk c - 1.  A window wholly
past the read's last column computes nothing.  The sink scores are the
maximum over windows (JAX's ``pmax``; only the window that holds column
n_real - 1 has any).  The walk goes window by window from that window
down to window 0: each runs ``poa_walk_bounded.cu`` over its own plane
(all rows, its columns) from the (row, j, state) the window to its right
left, and writes its segment of the round's (n,) align map.

One interface, a link, carries the edges and the hand-offs from window to
window, so the same code serves two cases: :class:`LocalLink`, every
window in this process (an edge is a copy between devices), and
``parallel.msa_multihost.GlooLink``, one window a process, over
``torch.distributed``.  The values are the single-call round's, bit for
bit: each cell repeats the single call's arithmetic on its rows and
columns, from the same left boundary.

The words planes of the windows on one device take at most half its
budget (``device.device_budget``, ``TSTA_HBM_BUDGET_GB``); past it the
round raises, naming the budget and the window (a window does not chunk
itself as ``ops/msa_chunked.py`` does).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tsta_tpu_torch.device import device_budget, resolve_device
from tsta_tpu_torch.ops import _kernels, msa_chunked, msa_poa
from tsta_tpu_torch.ops.psa_scan import NEG, as_params, bucket
from tsta_tpu_torch.parallel.mesh import on_device

LANES = 128


def mesh_columns(n_real: int, K: int) -> int:
    """Padded columns of a round over K windows: ``bucket``, at least 128
    * K, rounded up to a multiple of 128 * K (JAX's rule,
    ``msa_longseq.py:253-254``)."""
    q = LANES * K
    return -(-max(bucket(n_real), q) // q) * q


def wavefront_rows(N: int, A: int) -> int:
    """Rows a chunk of the wavefront over A active windows: about N / 4A
    as a power of two from 256 to 8,192, so the pipeline's fill (A - 1
    chunks) stays a small share of its steps."""
    nc = 256
    while nc < 8192 and nc * 4 * A < N:
        nc *= 2
    return nc


def seq_row(mesh) -> list:
    """The devices of ``mesh``'s ``seq`` axis (its first row), resolved;
    raises ValueError for a mix of the CPU and cards."""
    row = [resolve_device(d) for d in mesh.devices[0]]
    if len({d.type for d in row}) > 1:
        raise ValueError("a seq axis runs on one device type, got %s"
                         % sorted(str(d) for d in row))
    return row


def one_card(row) -> bool:
    """Whether a ``seq`` row is one card repeated (the single launch at D =
    K) rather than distinct devices or the CPU (the wavefront)."""
    return row[0].type == "cuda" and len(set(row)) == 1


class LocalLink:
    """Every window in this process, window d on ``devices[d]`` (a device
    may repeat): an edge is a copy to the next window's device, a
    hand-off stays where it is."""

    def __init__(self, devices=()):
        self.devices = [resolve_device(d) for d in devices]
        self._edges: dict = {}

    def owns(self, d: int) -> bool:
        return True

    def send_edge(self, d: int, c: int, edge: torch.Tensor) -> None:
        self._edges[(d + 1, c)] = edge

    def recv_edge(self, d: int, c: int, shape, dev) -> torch.Tensor:
        return self._edges.pop((d, c)).to(dev)

    def max_scores(self, scores: list, N: int) -> np.ndarray:
        """The sink scores, the maximum over the windows' (N,) scores."""
        host = [s.cpu() for s in scores]
        return torch.stack(host).max(0).values.numpy()

    def share(self, d: int, payload: torch.Tensor) -> torch.Tensor:
        """Window d's walk hand-off, as every window's owner sees it."""
        return payload


class Window:
    """Window ``d`` of a wavefront round: columns [d*C, (d+1)*C) of the
    round on ``dev``, whose tables ``cr`` (an ``msa_chunked.ChunkedRound``
    of the round's node chunks, one a device) holds.  ``last``: no window
    to its right runs, so its cells take no checkpoint."""

    def __init__(self, d: int, dev, cr, C: int, params, use_kernel: bool,
                 last: bool):
        self.d, self.dev, self.cr, self.C, self.col0 = d, dev, cr, C, d * C
        self.params, self.use_kernel, self.last = params, use_kernel, last
        self.a = cr.a[self.col0:self.col0 + C]
        self.ring = msa_poa.new_ring(cr.W, C, dev)
        Np = cr.nchunks * cr.NC
        wide = cr.preds.shape[1] > msa_poa.MAX_IN
        self.words = torch.zeros((Np, C), dtype=torch.int32 if wide
                                 else torch.int16, device=dev)
        self.scores = torch.full((Np,), NEG, dtype=torch.int32, device=dev)
        # the left neighbour's (H, q, F) at column col0 - 1, by row
        self.left = (torch.full((Np, 1, 3), NEG, dtype=torch.int32,
                                device=dev) if d else None)
        self.cells = 0
        self.timer = _Timer(dev)
        self.walk_counts = None

    def nbytes(self) -> int:
        return (self.words.numel() * self.words.element_size()
                + self.ring.numel() * 4 + self.scores.numel() * 16)

    def cell(self, c: int, edge) -> torch.Tensor | None:
        """Cell (c, d): chunk ``c``'s rows over this window's columns from
        ``edge``, the left neighbour's (NC, 1, 3) edge of chunk c (None in
        window 0).  Returns this window's edge of chunk c, or None."""
        from tsta_tpu_torch.ops.msa_native import round_dp_plain
        cr, NC = self.cr, self.cr.NC
        r0, r1 = c * NC, (c + 1) * NC
        pt = cr.predsT[:, r0:r1].contiguous()
        pm = cr.pmaskT[:, r0:r1].contiguous()
        if self.d:
            _, _, e_, o_ = as_params(self.params)
            self.left[r0:r1] = edge
            fills = msa_chunked.win_fills(self.left[r0:r1],
                                          self.left[:, :, 0], pt, pm, 0,
                                          self.col0, e_, o_)
        else:
            fills = cr.fills[:, r0:r1].contiguous()
        ckpt = None if self.last else torch.zeros(
            (NC, 1, 3), dtype=torch.int32, device=self.dev)
        args = (pt, pm, cr.bases[r0:r1], fills, self.a, cr.n_real,
                cr.rows(c), self.params, cr.W)
        # the checkpoint lands at global column cw - 1: this window's last
        kw = {"ring": self.ring, "chunk_base": r0, "col0": self.col0,
              "ckpt": ckpt, "cw": self.col0 + self.C}
        with on_device(self.dev):
            self.timer.start()
            if self.use_kernel:
                # the kernel writes the chunk's rows of the window's plane
                _kernels.poa_dp(*args[:-2], as_params(self.params), cr.W,
                                self.words[r0:r1], self.scores[r0:r1],
                                lists=cr.chunk_lists(c), **kw)
            else:
                words, scores = round_dp_plain(*args, **kw)
                self.words[r0:r1] = words
                self.scores[r0:r1] = scores
            self.timer.stop("dp")
        self.cells += 1
        return ckpt

    def walk(self, row: int, j: int, state: int) -> torch.Tensor:
        """The walk through this window's plane from (row, j, state): an
        int32 host tensor of the window's C align entries and the exit
        (row, j, state).  The kernel's counters (moves, pred moves,
        misses, phases) go to ``walk_counts``."""
        align = torch.full((self.cr.n,), -1, dtype=torch.int32,
                           device=self.dev)
        preds = self.cr.preds
        with on_device(self.dev):
            self.timer.start()
            if self.use_kernel:
                self.walk_counts = torch.zeros((4,), dtype=torch.int32,
                                               device=self.dev)
                st = msa_poa.poa_walk_bounded(
                    self.words, preds, row, j, state, 0, self.col0, align,
                    maxdist=self.cr.maxdist, counts=self.walk_counts)
            else:
                st = msa_poa.walk_bounded_plain(self.words, preds, row, j,
                                                state, 0, self.col0, align)
            self.timer.stop("walk")
        return torch.cat([align[self.col0:self.col0 + self.C], st]).cpu()


class _Timer:
    """A window's device milliseconds, DP and walk: CUDA events around
    each of its launches on its card, the host clock on the CPU."""

    def __init__(self, dev):
        self.dev, self.cuda = dev, dev.type == "cuda"
        self.spans: dict = {"dp": [], "walk": []}
        self._open = None

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.dev))
        return ev

    def start(self) -> None:
        self._open = self._now()

    def stop(self, kind: str) -> None:
        self.spans[kind].append((self._open, self._now()))

    def ms(self, kind: str) -> float | None:
        spans = self.spans[kind]
        if not spans:
            return None
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            return sum(a.elapsed_time(b) for a, b in spans)
        return sum(b - a for a, b in spans) * 1e3


class _Forward:
    """The wavefront's forward over the windows ``link`` owns: the
    round's tables, the windows and the sink scores."""

    def __init__(self, g, seq: bytes, params, devices, link, use_kernel,
                 budget, rows_per_chunk):
        K = len(devices)
        self.prep = prep = msa_poa.prepare(g, params)
        self.n_real = n_real = len(seq)
        if n_real == 0:
            raise ValueError("cannot align an empty read")
        self.n = n = mesh_columns(n_real, K)
        self.K, self.C = K, n // K
        self.A = A = -(-n_real // self.C)   # windows holding a real column
        NC = rows_per_chunk or wavefront_rows(prep[4], A)
        a = np.zeros((n,), np.uint8)
        a[:n_real] = np.frombuffer(bytes(seq), np.uint8)
        owned = [d for d in range(A) if link.owns(d)]
        crs: dict = {}   # the tables, once a device
        self.wins = {}
        for d in owned:
            dev = resolve_device(devices[d])
            if dev not in crs:
                crs[dev] = msa_chunked.ChunkedRound(g, prep, a, n_real, NC,
                                                    0, params, dev)
            self.wins[d] = Window(d, dev, crs[dev], self.C, params,
                                  use_kernel and dev.type == "cuda",
                                  d + 1 == A)
        self.NC, self.nchunks = NC, -(-prep[4] // NC)
        self.mask = msa_poa.sink_mask(g, prep[7], self.nchunks * NC)
        _check_budget(self.wins, budget)
        t0 = time.perf_counter()
        # step s: window d runs chunk s - d
        for s in range(self.nchunks + A - 1):
            for d in owned:
                c = s - d
                if not 0 <= c < self.nchunks:
                    continue
                w = self.wins[d]
                edge = (link.recv_edge(d, c, (NC, 1, 3), w.dev) if d
                        else None)
                out = w.cell(c, edge)
                if d + 1 < A:
                    link.send_edge(d, c, out)
        self.sink = link.max_scores([w.scores for w in self.wins.values()],
                                    self.nchunks * NC)
        self.dp_wall_s = time.perf_counter() - t0


def wavefront_round(g, seq: bytes, params, devices, link=None,
                    use_kernel: bool = True, budget=None,
                    rows_per_chunk: int | None = None, stats=None):
    """One round of ``seq`` against ``g`` as the column-window wavefront
    over K = ``len(devices)`` windows, window d on ``devices[d]`` (a
    device may repeat).  ``link`` (default :class:`LocalLink`) says which
    windows this process owns and carries their edges and hand-offs;
    ``devices`` entries of windows it does not own are not read.
    ``use_kernel``: the CUDA kernels, else their plain versions (the CPU
    always takes the plain versions).  ``budget``: bytes a device's
    planes may take, by default its ``device.device_budget``;
    ``rows_per_chunk``: NC, by default :func:`wavefront_rows`.  Appends a
    dict of the round's plan and each owned window's cells, DP and walk
    milliseconds to ``stats`` when given.  Returns ``(packed, order)``:
    the (2 + n,) int32 ``[best, score, align...]`` numpy array, the
    single-call round's, and the topo order."""
    link = LocalLink() if link is None else link
    f = _Forward(g, seq, params, devices, link, use_kernel, budget,
                 rows_per_chunk)
    t1 = time.perf_counter()
    n, C = f.n, f.C
    best = int(np.argmax(np.where(f.mask, f.sink, NEG)))
    align = np.full((n,), -1, np.int32)
    row, j, state = best, f.n_real - 1, 0
    # window by window, right to left, each from its right neighbour's exit
    for d in range(f.A - 1, -1, -1):
        if row < 0 or j < 0:
            break
        if link.owns(d):
            payload = f.wins[d].walk(row, j, state)
        else:
            payload = torch.zeros((C + 3,), dtype=torch.int32)
        payload = link.share(d, payload).numpy()
        align[d * C:(d + 1) * C] = payload[:C]
        row, j, state = (int(v) for v in payload[C:])
    if stats is not None:
        preds, pmaskT = f.prep[8], f.prep[1]
        nodes = len(f.prep[7])
        stats.append({
            "n": n, "K": f.K, "C": C, "active": f.A, "NC": f.NC,
            "chunks": f.nchunks, "nodes": nodes, "max_in": preds.shape[1],
            "maxdist": msa_poa.max_pred_distance(preds),
            "preds_in": int(pmaskT[:, :nodes].sum()),
            "dp_wall_s": f.dp_wall_s, "walk_wall_s": time.perf_counter() - t1,
            "windows": {d: {"device": str(w.dev), "cells": w.cells,
                            "dp_ms": w.timer.ms("dp"),
                            "walk_ms": w.timer.ms("walk"),
                            "walk_counts": (None if w.walk_counts is None
                                            else w.walk_counts.tolist())}
                        for d, w in f.wins.items()}})
    packed = np.concatenate([[best, int(f.sink[best])], align])
    return packed.astype(np.int32), f.prep[7]


def _check_budget(wins: dict, budget) -> None:
    """Raise ValueError when the windows on one device need more than half
    its budget."""
    held: dict = {}
    for d, w in sorted(wins.items()):
        cap = device_budget(w.dev) if budget is None else budget
        held[w.dev] = held.get(w.dev, 0) + w.nbytes()
        if held[w.dev] > cap // 2:
            raise ValueError(
                "window %d (columns %d-%d, %d rows) brings the planes on %s "
                "to %.2f MB, past half its budget of %.2f MB "
                "(TSTA_HBM_BUDGET_GB or the card's memory); spread the seq "
                "axis over more devices" % (
                    d, w.col0, w.col0 + w.C - 1, w.words.shape[0], w.dev,
                    held[w.dev] / 2 ** 20, cap / 2 ** 20))


def run_round(g, seq: bytes, params, mesh, kernel: str = "auto",
              budget=None, link=None, rows_per_chunk: int | None = None,
              stats=None):
    """One round over a ``seq`` axis.  Without ``link``, ``mesh``'s ``seq``
    row: one card repeated K times runs ``msa_poa.run_round`` at D = K
    (the single call; past 8,192 columns a shard ``poa_plan`` raises
    ValueError, and so does a round the one-call plan cannot hold; K = 1
    is the meshless round), other rows :func:`wavefront_round` over their
    devices.  With ``link`` (a :class:`LocalLink` over its devices, or
    ``msa_multihost.GlooLink``, one window a process) the wavefront over
    ``link.devices``, whatever ``mesh``.  ``kernel``: "plain" runs the
    plain versions on the card; ``rows_per_chunk`` and ``stats`` are
    :func:`wavefront_round`'s.  Returns ``(packed, order, plain_wide)``:
    as :func:`wavefront_round`, and whether the round ran the plain
    versions with wide words."""
    row = axis_devices(mesh, link)
    dev = next(d for d in row if d is not None)
    use_kernel = kernel != "plain"
    plain_wide = g.max_in_degree() > msa_poa.MAX_IN and not (
        use_kernel and dev.type == "cuda")
    if g.max_in_degree() > msa_poa.WIDE_MAX_IN:
        raise ValueError("in-degree %d exceeds the wide words' %d"
                         % (g.max_in_degree(), msa_poa.WIDE_MAX_IN))
    if link is None and one_card(row):
        packed, order, _ = msa_poa.run_round(
            g, seq, params, dev, kernel,
            device_budget(dev) if budget is None else budget,
            D=len(row) if len(row) > 1 else None)
        packed = packed.cpu().numpy()
    else:
        packed, order = wavefront_round(g, seq, params, row, link,
                                        use_kernel, budget, rows_per_chunk,
                                        stats)
    return packed, order, plain_wide


def axis_devices(mesh, link=None) -> list:
    """The windows' devices: ``link.devices`` (None where another process
    owns the window), else :func:`seq_row` of ``mesh``."""
    return list(link.devices) if link is not None else seq_row(mesh)


def round_dp(g, seq: bytes, params, mesh, rows_per_chunk=None):
    """The wavefront's DP of one round over ``mesh``'s ``seq`` row, planes
    and all, for comparison with JAX's ``msa_longseq.round_dp``: ``(sink,
    words, order, preds)``, sink the (N,) sink scores (the windows'
    maximum), words the (N, n) plane gathered from the windows (16-bit,
    or 32-bit past 64 preds, ``msa_native.round_dp_plain``'s words; the
    columns of windows past the read zero) and preds the (N, max_in)
    table, all numpy."""
    row = seq_row(mesh)
    f = _Forward(g, seq, params, row, LocalLink(), True, None,
                 rows_per_chunk)
    N = f.prep[4]
    words = np.zeros((N, f.n), f.wins[0].words.cpu().numpy().dtype)
    for d, w in f.wins.items():
        words[:, d * f.C:(d + 1) * f.C] = w.words[:N].cpu().numpy()
    return f.sink[:N], words, f.prep[7], f.prep[8]
