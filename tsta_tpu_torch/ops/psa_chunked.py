"""Chunked traced PSA: a pair whose code plane the card cannot hold.

Counterpart of ``tsta_tpu/ops/psa_pallas.py`` ``psa_align_traced_chunked``
(:778-920), with its chunk DP ``_psa_chunk_call`` (:720) and bounded walk
``traceback._decode_moves_bounded_banded`` (:930).  The pair's rows are cut
into chunks of ``mc`` and the DP runs in two passes:

1. **Forward.**  For each chunk in order: keep the H/E frontier that
   enters it (the snapshot, 2 x n_pad int32), run the chunk's rows from it
   (:func:`chunk_dp`, ``csrc/psa_dp.cu``'s chunk mode), which writes the
   chunk's code plane and the frontier out, and keep the chunk's last code
   row.  The pair's score is the max of the chunks' bests, its corner the
   last chunk's.  The last chunk's plane is kept for the walk; the others
   are dropped.
2. **Backward.**  From (m-1, n-1), in chunk ``i // mc``: rematerialise the
   chunk's plane from its snapshot (the same DP, the same values), walk it
   (:func:`traceback.walk_bounded`, ``csrc/psa_walk_bounded.cu``) until the
   walk leaves the chunk, read the exit (i, j, t, forced) back, 16 bytes,
   and go on in the chunk the walk entered.  The moves gather on the
   device in one (m_pad + n_pad) int8 buffer that crosses to the host
   once, for :func:`traceback.emit_alignment`.

A chunked pair gives the same score, corner and alignment as the unchunked
traced path, bit for bit: each chunk repeats the unchunked DP's arithmetic
on the same inputs, and the walk its steps.  ``mc`` follows the JAX rule:
it doubles from T_R while two planes of ``2 * mc`` rows fit in a quarter of
the budget.  On an 80 GB H100 (budget 0.85 x its memory) a 200 kbp pair
gets mc = 65,536: 3 chunks of 13.1 GB.

Left behind from the TPU host loop, each a TPU limit or a cost of its host
link: the row-block shrink for VMEM, n_pad rounded to 1,024 for the band's
alignment, the 4-rows-per-word plane, the CAP-bounded SMEM move log, the
SMEM band, two chunks per dispatch and the speculative remat.  Here a
chunk of the backward costs one DP launch, one walk launch and one read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tsta_tpu_torch.device import device_budget, resolve_device
from tsta_tpu_torch.ops import _kernels, psa_pallas, psa_scan
from tsta_tpu_torch.ops import traceback as tb
from tsta_tpu_torch.ops.psa_diff import LANES, T_R
from tsta_tpu_torch.ops.psa_scan import A_PAD, B_PAD, NEG, as_params

# The clock of the last chunked pair (:class:`ChunkClock`), for callers
# that reach this module through an entry point (the CLI, a batch).
last_clock = None


def chunk_rows(m_pad: int, n_pad: int, budget: int) -> int:
    """Rows per chunk, as ``psa_align_traced_chunked`` chooses them:
    double from T_R while two chunk planes of twice the rows fit in a
    quarter of ``budget`` bytes, and while the pair has more rows."""
    mc = T_R
    while (mc * 2) * n_pad <= budget // 4 and mc * 2 < m_pad:
        mc *= 2
    return mc


def chunk_dp_plain(a, b_chunk, lens, row_base: int, h, e, params):
    """One row-chunk of the traced DP in PyTorch (``psa_scan.scan_from``):
    the plain version of ``csrc/psa_dp.cu``'s chunk mode and the
    counterpart of ``psa_pallas._psa_chunk_call``.

    ``a``: (n_pad,) uint8; ``b_chunk``: (rows,) uint8, rows [row_base,
    row_base + rows) of the padded b; ``lens``: (2,) int32 real (n, m);
    ``h``/``e``: (n_pad,) int32 frontier of row row_base - 1.  Returns
    ``(best, corner, codes, h_out, e_out)``: (1,) int32 max over the
    chunk's cells, (1,) int32 H(m-1, n-1) or NEG when the chunk does not
    hold row m-1, the (rows, n_pad) uint8 codes and the frontier of the
    chunk's last row."""
    best, corner, codes, h_out, e_out = psa_scan.scan_from(
        a.view(1, -1), b_chunk.view(1, -1), lens[0:1], lens[1:2], params,
        True, row_base, h.view(1, -1), e.view(1, -1))
    return best, corner, codes[0], h_out[0], e_out[0]


def chunk_dp(a, b_chunk, lens, row_base: int, h, e, params):
    """:func:`chunk_dp_plain`'s function: CPU tensors take it; CUDA
    tensors launch ``csrc/psa_dp.cu``'s chunk mode (one block) or
    raise."""
    if a.device.type == "cpu":
        return chunk_dp_plain(a, b_chunk, lens, row_base, h, e, params)
    dev = a.device
    i32 = torch.int32
    best = torch.empty((1,), dtype=i32, device=dev)
    corner = torch.empty((1,), dtype=i32, device=dev)
    plane = torch.empty((b_chunk.shape[0], a.shape[0]), dtype=torch.uint8,
                        device=dev)
    h_out, e_out = torch.empty_like(h), torch.empty_like(e)
    _kernels.psa_dp_chunk(a, b_chunk, lens, row_base, as_params(params), h,
                          e, h_out, e_out, best, corner, plane)
    return best, corner, plane, h_out, e_out


class ChunkClock:
    """What a chunked pair spent: host seconds of the forward (ending in
    the read of score and corner) and of the backward (ending in the read
    of the moves), the forward chunks, remats and walks, and each
    launch's device milliseconds (CUDA events on the card, the host clock
    on the CPU) with each walk's entry state (i, j, t, forced) and steps;
    and the pair's plan (mc, n_pad), score and corner."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.score = self.corner = None
        self.mc = self.n_pad = 0
        self.forward_s = self.backward_s = 0.0
        self.chunks = self.remats = self.walks = 0
        self._launches: dict = {"dp": [], "walk": []}
        self.walk_from: list = []
        self.walk_steps: list = []

    def run(self, kind: str, fn, *args):
        """``fn(*args)``, timed as one ``kind`` ("dp" or "walk") launch."""
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args)
            ev[1].record()
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            ev = (t0, time.perf_counter())
        self._launches[kind].append(ev)
        return out

    def launch_ms(self, kind: str) -> list:
        """Device ms of each ``kind`` launch so far (after a sync)."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self._launches[kind]]
        return [(b - a) * 1e3 for a, b in self._launches[kind]]

    def record(self) -> dict:
        return {"score": self.score, "corner": self.corner, "mc": self.mc,
                "n_pad": self.n_pad,
                "forward_s": self.forward_s, "backward_s": self.backward_s,
                "chunks": self.chunks, "remats": self.remats,
                "walks": self.walks, "dp_ms": self.launch_ms("dp"),
                "walk_ms": self.launch_ms("walk"),
                "walk_from": self.walk_from, "walk_steps": self.walk_steps}


class ChunkedPair:
    """One pair's padded inputs on ``dev``, cut into chunks of ``mc``
    rows, and the arguments of its launches: :meth:`chunk_call` for a
    chunk's DP (forward or remat, :func:`chunk_dp` or
    :func:`chunk_dp_plain`), :meth:`walk_call` for its walk
    (:func:`traceback.walk_bounded` or ``walk_bounded_plain``).  ``a``
    (columns) and ``b`` (rows) are encoded uint8 arrays; n pads to
    LANES, m to whole chunks (a multiple of T_R).  ``mc``: rows per chunk,
    by default :func:`chunk_rows` of ``budget`` (itself by default
    :func:`device.device_budget` of ``dev``)."""

    def __init__(self, a: np.ndarray, b: np.ndarray, params, mc=None, dev=None,
                 budget=None):
        dev = resolve_device(dev)
        self.n_real, self.m_real = int(a.shape[0]), int(b.shape[0])
        if self.n_real < 1 or self.m_real < 1:
            raise ValueError("empty sequence")
        self.n_pad = -(-self.n_real // LANES) * LANES
        if mc is None:
            mc = chunk_rows(-(-self.m_real // T_R) * T_R, self.n_pad,
                            device_budget(dev) if budget is None else budget)
        if mc < T_R or mc % T_R:
            raise ValueError("rows per chunk must be a multiple of %d, got "
                             "%d" % (T_R, mc))
        self.mc = mc
        self.nchunks = -(-self.m_real // mc)
        self.m_pad = self.nchunks * mc
        self.params, self.dev = as_params(params), dev
        a_pad = np.full(self.n_pad, A_PAD, np.uint8)
        a_pad[:self.n_real] = a
        b_pad = np.full(self.m_pad, B_PAD, np.uint8)
        b_pad[:self.m_real] = b
        lens = np.array([self.n_real, self.m_real], np.int32)
        self.a, self.b, self.lens = (torch.from_numpy(x).to(dev)
                                     for x in (a_pad, b_pad, lens))

    def entry(self):
        """The frontier of row -1: H(-1, j) = o + (j+1)e, E = NEG."""
        _, _, e_, o_ = self.params
        j = torch.arange(self.n_pad, dtype=torch.int32, device=self.dev)
        return (o_ + (j + 1) * e_, torch.full_like(j, NEG))

    def chunk_call(self, c: int, h, e) -> tuple:
        """Chunk ``c``'s DP from the frontier (h, e) that enters it."""
        mc = self.mc
        return (self.a, self.b[c * mc:(c + 1) * mc], self.lens, c * mc, h, e,
                self.params)

    def forward(self, dp, clock: ChunkClock | None = None):
        """The forward pass through ``dp``: the snapshots ((h, e) entering
        each chunk), each chunk's last code row, the pair's score and
        corner ((1,) int32 on the device) and the last chunk's plane."""
        h, e = self.entry()
        snaps, last_rows, bests = [], [], []
        plane = None
        for c in range(self.nchunks):
            snaps.append((h, e))
            del plane   # the allocator hands its block to the next chunk
            args = self.chunk_call(c, h, e)
            best, corner, plane, h, e = (clock.run("dp", dp, *args) if clock
                                         else dp(*args))
            bests.append(best)
            last_rows.append(plane[-1].clone())
        # the last chunk holds row m-1: m_pad - m < T_R <= mc
        return snaps, last_rows, torch.cat(bests).max().reshape(1), corner, \
            plane

    def walk_call(self, c: int, plane, last_rows, i: int, j: int, t: int,
                  forced: int, moves) -> tuple:
        """Chunk ``c``'s walk over its ``plane`` from (i, j, t, forced);
        the codes of the row above the chunk are the previous chunk's last
        row (zeros above chunk 0)."""
        prev = (last_rows[c - 1] if c > 0 else
                torch.zeros((self.n_pad,), dtype=torch.uint8, device=self.dev))
        return (plane, prev, c * self.mc, i, j, t, forced, moves)


@torch.no_grad()
def psa_align_traced_chunked(a, b, params, mc: int | None = None, device=None,
                             budget: int | None = None):
    """Traced alignment of one pair through row-chunks, for a pair whose
    code plane exceeds the device budget.

    ``a`` (columns) and ``b`` (rows): encoded uint8 sequences, already
    swapped so the longer is ``a``.  ``mc``: rows per chunk (default from
    ``budget``, itself by default :func:`device.device_budget`); tests pin
    it small to cross many chunks.  CPU tensors run the plain versions,
    CUDA tensors the kernels (or raise).  Parameters are those of the
    round-1 guard (``psa_pallas._traced_params``: X < 0, E < 0, O <= 0,
    any M).  Returns (score, corner, Alignment), the contract of
    ``psa_pallas.psa_align_traced_device``; the run's :class:`ChunkClock`
    is left in :data:`last_clock`."""
    global last_clock
    p = psa_pallas._traced_params(params)
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    pair = ChunkedPair(a, b, p, mc, device, budget)
    dev = pair.dev
    clock = ChunkClock(dev)
    clock.chunks, clock.mc, clock.n_pad = pair.nchunks, pair.mc, pair.n_pad

    t0 = time.perf_counter()
    snaps, last_rows, score, corner, plane = pair.forward(chunk_dp, clock)
    score, corner = torch.cat([score, corner]).tolist()
    clock.score, clock.corner = score, corner
    t1 = time.perf_counter()

    moves = torch.zeros((pair.m_pad + pair.n_pad,), dtype=torch.int8,
                        device=dev)
    i, j, t, forced = pair.m_real - 1, pair.n_real - 1, 0, 0
    c = pair.nchunks - 1
    while True:
        if plane is None:
            plane = clock.run("dp", chunk_dp,
                              *pair.chunk_call(c, *snaps[c]))[2]
            clock.remats += 1
        clock.walk_from.append((i, j, t, forced))
        exit_state = clock.run("walk", tb.walk_bounded, *pair.walk_call(
            c, plane, last_rows, i, j, t, forced, moves))
        i, j, t, forced = exit_state.tolist()
        clock.walks += 1
        clock.walk_steps.append(t - clock.walk_from[-1][2])
        plane = None
        if i < 0:   # only chunk 0's walk leaves at i < 0, and it ends there
            break
        c = i // pair.mc
    moves_np = moves[:t].cpu().numpy()
    clock.forward_s, clock.backward_s = t1 - t0, time.perf_counter() - t1
    last_clock = clock
    aln = tb.emit_alignment(moves_np, a, b, pair.n_real, pair.m_real)
    return int(score), int(corner), aln
