"""The native MSA engine: progressive partial-order alignment with an
exact int32 DP per round.

Counterpart of ``tsta_tpu/ops/msa_native.py``.  Each read after the first
runs one round against the graph (``ops/msa_poa.py``: tables, the DP and
walk kernels or their plain versions, one device-to-host transfer; a
round over the memory plan in chunks, ``ops/msa_chunked.py``), then the
host merges the read into the graph (:func:`_merge`, in C through
``poa_fast.c``) and re-sorts it.  The recurrence, per topo-ordered node v
and read column j::

    E(v,j) = max_p max(E(p,j) + e, H(p,j) + o + e)
    F(v,j) = o + j*e + max(H(v,-1) + e, max_{k<j}(C(k) - k*e)),
    C = max(diag, E)
    H(v,j) = max(max_p H(p,j-1) + sub(v, a_j), E(v,j), F(v,j))

with H(v,-1) the shortest pred chain's gap cost and a virtual row
H(-1,j) = o + (j+1)e for source nodes.

:func:`round_dp_plain` is the DP's plain PyTorch version (one topo row at
a time), :func:`align_seqs` the round loop with checkpoint resume, and
:func:`align_seqs_many` the fleet, whose problems each run on their own
CUDA stream so one problem's host merge overlaps the others' rounds.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import List

import numpy as np
import torch

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.models.msa import MsaOutput
from tsta_tpu_torch.models.poa_graph import PoaGraph, load_graph, save_graph
from tsta_tpu_torch.utils.checkpoint import seqs_digest
from tsta_tpu_torch.utils.logging import get_logger
from tsta_tpu_torch.device import device_budget, resolve_device
from tsta_tpu_torch.ops import msa_poa
from tsta_tpu_torch.native.build import load_poa
from tsta_tpu_torch.ops.psa_scan import NEG, as_params

KERNELS = ("auto", "plain", "cuda")

# Rounds whose graph in-degree exceeded 64 preds and that ran the plain
# versions with wide words (msa_poa.run_round: on the CPU or with
# kernel="plain"; the kernels' routes on a card run the wide forms).
plain_rounds = 0


def _warn_ambiguity(seqs) -> None:
    """Warn when a read holds 'N'.

    The reference scores read-'N' columns as score-neutral through its
    difference normalisation (c-t-simd.c:461,481), which the compat
    engine reproduces; the native engine scores 'N' as an ordinary
    mismatch, so the engines' scores differ on such reads.  Other
    non-ACGT bytes score alike in both engines, so unlike the JAX
    package's ``_warn_ambiguity`` (which warns on any non-ACGT byte,
    once per process) this warns on uppercase 'N' only, on each call."""
    if any(b"N" in bytes(s) for s in seqs):
        get_logger().warning(
            "input contains 'N': the native engine scores it as an "
            "ordinary mismatch; use engine='compat' for the reference's "
            "score-neutral 'N' handling")


@torch.no_grad()
def round_dp_plain(predsT, pmaskT, bases, fills, a, n_real, n_nodes, params,
                   W, *, ring=None, chunk_base=0, col0=0, ckpt=None,
                   with_words=True, cw=None, lists=None):
    """One round's DP in PyTorch, one topo row at a time: the plain
    version of ``csrc/poa_dp.cu`` in all three of its uses, and the
    counterpart of the JAX package's ``_round_dp``, with the kernel's
    inputs and outputs.

    ``predsT``/``pmaskT``: (max_in, N) int32 (buffer row ids, 0 = the
    virtual row); ``bases``: (N,) int32; ``fills``: (4, N) int32
    left-boundary seeds; ``a``: (n,) uint8, the read's columns [col0,
    col0 + n).  Rows < ``n_nodes`` are computed, local row i being the
    round's topo row ``chunk_base + i``; pred rows live in a ring of
    ``W`` slots indexed by global row: ``ring`` None is a private one,
    else the kernel's (W, 2, ring width) int32 ring
    (:func:`msa_poa.ring_positions`), read and written in place.
    ``ckpt`` ((N, nwin, 3) int32 or None) gets H, the running max q and F
    at global column (w + 1) * cw - 1 of each window w < nwin the launch
    holds, ``cw`` by default n / nwin (a forward chunk's windows).
    Returns ``(words, scores)``: per cell ``(h_type*4 + e_ext*2 + f_ext)
    | h_pred << 4 | e_pred << (4 + b)``, an (N, n) int16 plane with b = 6
    when max_in <= 64, else int32 with b = 13 (None without
    ``with_words``); scores (N,) int32 H(v, n_real-1) where the launch
    holds that column, NEG elsewhere.  ``lists``, the wide kernel's pred
    lists, is taken for the kernel's signature and not read: this
    version reads the table."""
    m_, x_, e_, o_ = as_params(params)
    max_in, N = predsT.shape
    n = a.shape[0]
    dev = a.device
    i32 = torch.int32
    bits = 6 if max_in <= msa_poa.MAX_IN else 13
    pt = predsT.cpu().numpy()
    pm = pmaskT.cpu().numpy()
    bs = bases.cpu().numpy()
    j = torch.arange(n, dtype=i32, device=dev) + col0
    col_e = j * e_
    o_col_e = o_ + col_e
    h_virt = o_ + (j + 1) * e_
    neg = torch.full((n,), NEG, dtype=i32, device=dev)
    zero = torch.zeros((n,), dtype=i32, device=dev)
    a32 = a.to(i32)
    subs = {}
    if ring is None:
        ring_h = [None] * W
        ring_e = [None] * W
    else:
        pos = msa_poa.ring_positions(n, dev)
        cols = ring[:, :, pos]
        ring_h = list(cols[:, 0].unbind(0))
        ring_e = list(cols[:, 1].unbind(0))
    words = None
    if with_words:
        words = torch.zeros((N, n), dtype=torch.int16 if bits == 6 else i32,
                            device=dev)
    scores = torch.full((N,), NEG, dtype=i32, device=dev)
    sink = n_real - 1 - col0
    if ckpt is not None:
        nwin = ckpt.shape[1]
        cw = n // nwin if cw is None else cw
        ck_w = [w for w in range(nwin) if 0 <= (w + 1) * cw - 1 - col0 < n]
        ck_j = torch.tensor([(w + 1) * cw - 1 - col0 for w in ck_w],
                            dtype=torch.long, device=dev)
    for i in range(n_nodes):
        hb, ha, eb, ea, ex = neg, zero, neg, zero, zero
        for kk in range(max_in):
            if not pm[kk, i]:
                continue
            r = int(pt[kk, i])
            hp, ep = (h_virt, neg) if r == 0 else (ring_h[r % W],
                                                   ring_e[r % W])
            upd = hp > hb
            hb = torch.maximum(hb, hp)
            ha = torch.where(upd, kk, ha)
            ec = torch.maximum(ep + e_, hp + (o_ + e_))
            upd = ec > eb
            eb = torch.maximum(eb, ec)
            ea = torch.where(upd, kk, ea)
            ex = torch.where(upd, (ep + e_ == ec).to(i32), ex)
        base = int(bs[i])
        if base not in subs:
            subs[base] = torch.where(a32 == base, m_, x_).to(i32)
        diag = torch.cat([fills[0, i:i + 1], hb[:-1]]) + subs[base]
        c = torch.maximum(diag, eb)
        y = c - col_e
        p = torch.cummax(torch.cat([fills[2, i:i + 1], y[:-1]]), 0).values
        f = o_col_e + p
        h = torch.maximum(c, f)
        if with_words:
            h_pred = torch.cat([fills[1, i:i + 1], ha[:-1]])
            f_ext = (f == torch.cat([fills[3, i:i + 1], f[:-1]]) + e_).to(i32)
            # precedence: diagonal > E > F
            h_type = (h != diag).to(i32) * (1 + (h != eb).to(i32))
            w = (h_type * 4 + ex * 2 + f_ext + (h_pred << 4)
                 + (ea << (4 + bits)))
            if bits == 6:
                w = torch.where(w >= 1 << 15, w - (1 << 16), w)
            words[i] = w
        if ckpt is not None and ck_w:
            q = torch.maximum(p, y)
            ckpt[i, ck_w] = torch.stack([h[ck_j], q[ck_j], f[ck_j]], 1)
        slot = (chunk_base + i + 1) % W
        ring_h[slot] = h
        ring_e[slot] = eb
        if 0 <= sink < n:
            scores[i] = h[sink]
    if ring is not None:
        ring[:, :, pos] = torch.stack([torch.stack(ring_h),
                                       torch.stack(ring_e)], 1)
    return words, scores


def _merge(g: PoaGraph, seq: bytes, seq_no: int, order, align_rows) -> int:
    """Merge ``seq`` into the graph along the per-column aligned topo rows
    (-1 for an insertion); returns the nodes added.  The same merge as the
    JAX package's ``msa_native._merge``: in C (``poa_fast.c``
    ``tsta_poa_merge``) on the graph's buffers after a pre-grow that keeps
    the C pass from reallocating, or in Python when one graph column is
    hit more than 8 times (only for align rows that are not a walk's
    path), which grows on demand instead."""
    n = len(seq)
    before = len(g)
    ar = np.asarray(align_rows, np.int64)
    if ar.shape[0] != n:
        raise ValueError("align_rows length != len(seq)")
    if not 0 <= seq_no < g.n_seq:
        raise ValueError("seq_no %d outside the graph's %d reads"
                         % (seq_no, g.n_seq))
    if int(ar.max(initial=-1)) >= len(order):
        # a row past the real node count is a padded row: merging it
        # would corrupt every later round
        raise ValueError("align_rows contains topo row %d >= %d nodes"
                         % (int(ar.max()), len(order)))
    if len(order):
        order_arr = np.asarray(order, np.int64)
        align = np.where(ar >= 0, order_arr[np.maximum(ar, 0)],
                         np.int64(-1))
    else:
        align = np.full(n, -1, np.int64)
    # pre-grow: the most hits on one variant group bounds both the new
    # pred slots of a node and its ring's growth this round
    if before and n:
        hit = align[align >= 0]
        if hit.size:
            vn = g._nvar[:before].astype(np.int64)
            vmask = np.arange(g._vars.shape[1]) < vn[:, None]
            ring_min = np.where(vmask, g._vars[:before], before).min(axis=1)
            gid = np.minimum(np.arange(before, dtype=np.int64), ring_min)
            extra = int(np.bincount(gid[hit], minlength=before).max(
                initial=0))
        else:
            extra = 0
    else:
        extra = 1 if n else 0
    extra = max(extra, 1)
    g._grow(n_cap=before + n,
            pmax=g.max_in_degree() + min(extra, 8),
            vmax=int(g._nvar[:before].max(initial=0)) + min(extra, 8))
    seq_arr = (np.frombuffer(bytes(seq), np.uint8)
               if isinstance(seq, (bytes, bytearray))
               else np.asarray(list(seq), np.uint8))
    g._csr = None
    g._succs = None
    if extra <= 8:
        g._n = before + _merge_native(g, seq_arr, seq_no, align)
        return len(g) - before
    bases, ndeg, passing = g._bases, g._ndeg, g._passing
    nvar, vars_ = g._nvar, g._vars
    nn = before
    prev = -1
    for jj in range(n):
        v = int(align[jj])
        ch = int(seq_arr[jj])
        if v >= 0:
            if bases[v] == ch:
                passing[v, seq_no] = True
                if ndeg[v] and g._preds[v, 0] == prev:   # chain edge
                    g._weights[v, 0] += 1
                else:
                    _edge_py(g, prev, v)
                prev = v
                continue
            # mismatch: reuse an aligned variant with this base or create
            k = int(nvar[v])
            ring = vars_[v, :k].copy()
            cand = next((int(w) for w in ring if bases[w] == ch), -1)
            if cand < 0:
                w = nn
                nn += 1
                g._n = nn   # an on-demand _grow copies rows [:_n] only
                bases[w] = ch
                # the new node's ring is [v] + v's ring, and w joins
                # every member's ring
                if k + 1 >= vars_.shape[1]:
                    g._grow(vmax=k + 2)
                    nvar, vars_ = g._nvar, g._vars
                vars_[w, 0] = v
                vars_[w, 1:k + 1] = ring
                nvar[w] = k + 1
                vars_[v, k] = w
                nvar[v] = k + 1
                for r in ring:
                    kr = int(nvar[r])
                    if kr >= vars_.shape[1]:
                        g._grow(vmax=kr + 1)
                        nvar, vars_ = g._nvar, g._vars
                    vars_[r, kr] = w
                    nvar[r] = kr + 1
                v = w
            else:
                v = cand
        else:
            v = nn
            nn += 1
            g._n = nn
            bases[v] = ch
        passing[v, seq_no] = True
        _edge_py(g, prev, v)
        prev = v
    g._n = nn
    return nn - before


def _edge_py(g: PoaGraph, src: int, dst: int) -> None:
    """Add or weight the edge src -> dst, growing the pred slots on
    demand; the caller invalidates the graph's caches."""
    if src < 0:
        return
    nd = int(g._ndeg[dst])
    row = g._preds[dst]
    for k in range(nd):
        if row[k] == src:
            g._weights[dst, k] += 1
            return
    if nd >= g._preds.shape[1]:
        g._grow(pmax=nd + 1)
        row = g._preds[dst]
    row[nd] = src
    g._weights[dst, nd] = 1
    g._ndeg[dst] = nd + 1


def _merge_native(g: PoaGraph, seq_arr: np.ndarray, seq_no: int,
                  align: np.ndarray) -> int:
    """``tsta_poa_merge`` over the graph's buffers; returns the nodes
    added.  A capacity breach (impossible after the pre-grow) raises."""
    lib = load_poa()
    ub = ctypes.POINTER(ctypes.c_ubyte)
    ip = ctypes.POINTER(ctypes.c_int)
    added = lib.tsta_poa_merge(
        len(g), g._bases.shape[0], g._preds.shape[1], g._vars.shape[1],
        g._bases.ctypes.data_as(ub), g._ndeg.ctypes.data_as(ip),
        g._preds.ctypes.data_as(ip), g._weights.ctypes.data_as(ip),
        g._passing.ctypes.data_as(ub), g.n_seq, seq_no,
        g._nvar.ctypes.data_as(ip), g._vars.ctypes.data_as(ip),
        seq_arr.ctypes.data_as(ub), seq_arr.shape[0],
        np.ascontiguousarray(align, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_long)))
    if added < 0:
        raise RuntimeError(
            "tsta_poa_merge failed (%d): the alignment consumed a graph "
            "column more than once (invalid align_rows?)" % added)
    return int(added)


def _finish_round(g: PoaGraph, seq: bytes, seq_no: int, order, host,
                  scores, glen, alen) -> None:
    """Apply one round's packed ``[best, score, align...]`` to the graph
    and the per-round records."""
    scores.append(int(host[1]))
    alen.append(_merge(g, seq, seq_no, order, host[2:2 + len(seq)]))
    glen.append(len(g))
    g.toposort()


def _check_args(kernel: str, device):
    if kernel not in KERNELS:
        raise ValueError("kernel must be one of %s (got %r)"
                         % (", ".join(KERNELS), kernel))
    dev = resolve_device(device)
    if kernel == "cuda" and dev.type != "cuda":
        raise ValueError("kernel='cuda' needs a CUDA device (got %s)" % dev)
    return dev


def align_seqs(seqs: List[bytes], params: AlignParams = AlignParams(),
               checkpoint_path: str | None = None, progress=None,
               kernel: str = "auto", device=None,
               clock: msa_poa.RoundClock | None = None,
               budget: int | None = None, mesh=None, link=None,
               rows_per_chunk: int | None = None,
               stats=None) -> MsaOutput:
    """Progressive POA MSA of ``seqs`` on ``device`` (default CUDA).

    ``kernel`` as in :func:`msa_poa.run_round`; a round plans for
    ``budget`` bytes (default :func:`device.device_budget` of
    ``device``): a round whose words plane the plan will not hold runs
    chunked (``ops/msa_chunked.py``).  With ``mesh`` every round runs its
    columns over the mesh's ``seq`` axis
    (``parallel/msa_longseq.run_round``, as the JAX package sends every
    round of a meshed MSA to its ``msa_longseq``), on the mesh's devices
    (``device`` and ``clock`` then do not apply); with ``link`` every round
    runs the column-window wavefront over the link's windows
    (``msa_longseq.LocalLink`` in this process,
    ``parallel.msa_multihost.GlooLink`` one window a process), and
    ``rows_per_chunk`` and ``stats`` are the wavefront's
    (``msa_longseq.wavefront_round``).  With
    ``checkpoint_path`` the graph is saved after every round and a
    snapshot of the same reads and parameters resumes the run (the JAX
    package's format, so either package resumes the other's).
    ``progress(done, total)`` is called before each round and at the end;
    ``clock`` collects each round's wall split."""
    global plain_rounds
    if mesh is None and link is None:
        dev = _check_args(kernel, device)
        if budget is None:
            budget = device_budget(dev)
    else:
        from tsta_tpu_torch.parallel import msa_longseq
        row = msa_longseq.axis_devices(mesh, link)
        _check_args(kernel, next(d for d in row if d is not None))
        if clock is not None:
            raise ValueError("a mesh round keeps no RoundClock; "
                             "pass stats=")
    if not seqs:
        raise ValueError("no sequences")
    _warn_ambiguity(seqs)
    n_seq = len(seqs)
    digest = seqs_digest(seqs)
    g = PoaGraph.from_sequence(seqs[0], n_seq)
    p = list(as_params(params))
    round_scores, graph_lens, add_lens = [], [], []
    # a single read still runs one self-alignment round
    reads = list(range(1, n_seq)) if n_seq > 1 else [0]
    if n_seq < 2:
        checkpoint_path = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        g2, extra = load_graph(checkpoint_path)
        if extra.get("digest") == digest and extra.get("params") == p:
            g = g2
            round_scores = extra["round_scores"]
            graph_lens = extra["graph_len"]
            add_lens = extra["add_len"]
            reads = reads[extra["next_read_idx"]:]
    n_rounds = max(n_seq - 1, len(reads))
    done0 = n_rounds - len(reads)
    for read_idx, seq_no in enumerate(reads):
        seq = bytes(seqs[seq_no])
        if progress is not None:
            progress(done0 + read_idx, n_rounds)
        if mesh is None and link is None:
            packed, order, plain_wide = msa_poa.run_round(
                g, seq, params, dev, kernel, budget, clock)
            host = packed.cpu().numpy()
        else:
            host, order, plain_wide = msa_longseq.run_round(
                g, seq, params, mesh, kernel, budget, link, rows_per_chunk,
                stats)
        plain_rounds += plain_wide
        if clock:
            clock.mark("got")
        _finish_round(g, seq, seq_no, order, host, round_scores,
                      graph_lens, add_lens)
        if clock:
            clock.mark("end")
            clock.close()
        if checkpoint_path:
            save_graph(checkpoint_path, g, extra={
                "digest": digest, "params": p,
                "round_scores": round_scores, "graph_len": graph_lens,
                "add_len": add_lens, "next_read_idx": done0 + read_idx + 1})
    if progress is not None:
        progress(n_rounds, n_rounds)
    return MsaOutput(rows=g.msa_rows(), consensus=g.consensus(),
                     round_scores=round_scores, graph_len=graph_lens,
                     add_len=add_lens)


def align_seqs_many(seq_sets: List[List[bytes]],
                    params: AlignParams = AlignParams(), kernel: str = "auto",
                    device=None, budget: int | None = None) -> List[MsaOutput]:
    """Progressive MSA of many independent read sets, pipelined.

    Within one problem a round needs the graph of the round before; across
    problems nothing does.  On a CUDA device every problem gets its own
    stream: each round is dispatched as one chain ending in a copy of its
    packed result to pinned host memory and an event, so while the host
    merges problem i's round, the rounds of the other problems run on
    other SMs.  A chunked round (``budget`` as in :func:`align_seqs`)
    reads 12 bytes back per cell it walks, so its host waits on its
    problem's stream inside the round, while the other streams run on.
    Returns one MsaOutput per read set, in input order."""
    dev = _check_args(kernel, device)
    if budget is None:
        budget = device_budget(dev)
    cuda = dev.type == "cuda"
    states = []
    for seqs in seq_sets:
        if not seqs:
            raise ValueError("empty read set")
        states.append({
            "seqs": seqs, "g": PoaGraph.from_sequence(seqs[0], len(seqs)),
            "reads": list(range(1, len(seqs))) if len(seqs) > 1 else [0],
            "next": 0, "scores": [], "glen": [], "alen": [],
            "pending": None,
            "stream": torch.cuda.Stream(dev) if cuda else None})
    _warn_ambiguity([s for seqs in seq_sets for s in seqs])

    def dispatch(st):
        global plain_rounds
        seq_no = st["reads"][st["next"]]
        seq = bytes(st["seqs"][seq_no])
        ctx = (torch.cuda.stream(st["stream"]) if cuda
               else contextlib.nullcontext())
        with ctx:
            packed, order, plain_wide = msa_poa.run_round(
                st["g"], seq, params, dev, kernel, budget)
            done = None
            if cuda:
                host = torch.empty(packed.shape, dtype=torch.int32,
                                   pin_memory=True)
                host.copy_(packed, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = packed
        plain_rounds += plain_wide
        st["pending"] = (seq_no, seq, order, host, done)

    for st in states:
        dispatch(st)
    while any(st["pending"] is not None for st in states):
        for st in states:
            if st["pending"] is None:
                continue
            seq_no, seq, order, host, done = st["pending"]
            st["pending"] = None
            if done is not None:
                done.synchronize()   # this problem's round only
            _finish_round(st["g"], seq, seq_no, order, host.numpy(),
                          st["scores"], st["glen"], st["alen"])
            st["next"] += 1
            if st["next"] < len(st["reads"]):
                dispatch(st)   # runs while the host merges the others
    return [MsaOutput(rows=st["g"].msa_rows(), consensus=st["g"].consensus(),
                      round_scores=st["scores"], graph_len=st["glen"],
                      add_len=st["alen"]) for st in states]
