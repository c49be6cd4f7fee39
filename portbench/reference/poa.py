"""Plain progressive partial-order MSA, in PyTorch and Python.

The reference that the MSA cells are judged by.  It imports nothing of
the program under test.  The semantics are TSTA_msa's native engine as
the port states them (``ops/msa_native.py``, ``models/poa_graph.py``);
every step is written out here once more:

* the graph starts as read 0's chain; each further read runs one round:
  the DP against the graph in topological order, the traceback from the
  best sink, and the merge of the read along the traced path;
* the DP, per topo row v (a node) and read column j, with a virtual row
  H(-1, j) = O + (j+1)E above the sources and H(v, -1) the boundary
  (O + E for a source, else the largest over its preds plus E)::

      E(v,j) = max over preds p of max(E(p,j) + E, H(p,j) + O + E)
      F(v,j) = max(F(v,j-1) + E, H(v,j-1) + O + E)
      H(v,j) = max(max_p H(p,j-1) + s(v, a_j), E(v,j), F(v,j))

  ties resolved as the engine does: the first pred (in the node's
  insertion order) that reaches a maximum, extension before opening,
  and for H the diagonal, then E, then F;
* the round's score is H(sink, n-1) of the first best sink;
* the merge: a read base traced to a node with the same base joins it; to
  a node with another base, it joins the variant of that node's ring
  that has its base or becomes a new variant; an untraced base becomes a
  new node; consecutive bases are joined by an edge, whose weight counts
  the reads over it;
* the topological order after each round: Kahn's order taking the least
  ready node id first, each placed node followed at once by the ready,
  unplaced members of its variant ring;
* the consensus: the heaviest bundle with the reference's re-scoring;
* the rows: one column per variant group, the columns in Kahn order of
  the group graph by each group's least topo rank.

The DP keeps each node's H and E rows in a ring as deep as the longest
pred edge, and one word a cell for the traceback; a round whose words
pass the memory budget keeps a copy of the ring every K rows instead and
the walk recomputes one K-row segment at a time.  ``dtype`` narrower
than int32 clamps every value to its range after each step: the control.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from portbench.reference.scan import padded, prefix_max

NEG = -(2 ** 28)


class Graph:
    """A POA graph: per node its base, preds and edge weights (insertion
    order), the reads through it, and its variant ring."""

    def __init__(self, seq: bytes, n_seq: int):
        n = len(seq)
        self.n_seq = n_seq
        self.bases = list(seq)
        self.preds = [[]] + [[v - 1] for v in range(1, n)]
        self.weights = [[]] + [[1] for _ in range(1, n)]
        self.passing = [[0] for _ in range(n)]
        self.ring = [[] for _ in range(n)]
        self.topo = list(range(n))

    def __len__(self) -> int:
        return len(self.bases)

    def succs(self) -> list:
        out = [[] for _ in range(len(self))]
        for v, ps in enumerate(self.preds):
            for p in ps:
                out[p].append(v)
        return out

    def add_node(self, base: int) -> int:
        self.bases.append(base)
        self.preds.append([])
        self.weights.append([])
        self.passing.append([])
        self.ring.append([])
        return len(self.bases) - 1

    def add_edge(self, src: int, dst: int) -> None:
        if src < 0:
            return
        ps = self.preds[dst]
        if src in ps:
            self.weights[dst][ps.index(src)] += 1
        else:
            ps.append(src)
            self.weights[dst].append(1)

    def merge(self, seq: bytes, seq_no: int, align_nodes) -> int:
        """Merge ``seq`` along ``align_nodes`` (a node a base, -1 for an
        insertion); returns the nodes added."""
        before = len(self)
        prev = -1
        for ch, v in zip(seq, align_nodes):
            if v >= 0 and self.bases[v] != ch:
                cand = [w for w in self.ring[v] if self.bases[w] == ch]
                if cand:
                    v = cand[0]
                else:
                    w = self.add_node(ch)
                    members = list(self.ring[v])
                    self.ring[w] = [v] + members
                    for r in members:
                        self.ring[r].append(w)
                    self.ring[v].append(w)
                    v = w
            elif v < 0:
                v = self.add_node(ch)
            self.passing[v].append(seq_no)
            self.add_edge(prev, v)
            prev = v
        return len(self) - before

    def toposort(self) -> list:
        n = len(self)
        indeg = [len(p) for p in self.preds]
        succs = self.succs()
        placed = [False] * n
        ready = [v for v in range(n) if indeg[v] == 0]
        heapq.heapify(ready)
        order = []
        while ready:
            v = heapq.heappop(ready)
            if placed[v]:
                continue
            group = [v] + [w for w in self.ring[v]
                           if not placed[w] and indeg[w] == 0]
            for w in group:
                if placed[w]:
                    continue
                placed[w] = True
                order.append(w)
                for s in succs[w]:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        heapq.heappush(ready, s)
        if len(order) != n:
            raise ValueError("the graph has a cycle")
        self.topo = order
        return order

    def consensus(self) -> bytes:
        n = len(self)
        topo = self.topo
        pos = {v: i for i, v in enumerate(topo)}
        succs = self.succs()
        score = [0] * n
        cfrom = [-1] * n
        P, W = self.preds, self.weights

        def rescore(v):
            mx, mj = 0, -1
            for j, (p, w) in enumerate(zip(P[v], W[v])):
                if score[p] >= 0 and (mx < w or (
                        mx == w and mj >= 0 and score[P[v][mj]] <= score[p])):
                    mx, mj = w, j
            if mj < 0:
                score[v], cfrom[v] = 0, -1
            else:
                score[v], cfrom[v] = score[P[v][mj]] + mx, P[v][mj]

        for v in topo:
            rescore(v)
        for _ in range(4 * n + 4):
            top, mx = topo[0], score[topo[0]]
            for v in topo:
                if score[v] >= mx:
                    top, mx = v, score[v]
            if not succs[top]:
                break
            marked = set()
            for nx in succs[top]:
                for p in P[nx]:
                    if 0 < score[p] < score[top]:
                        score[p] = -score[p]
                marked.add(nx)
            for v in topo[pos[top] + 1:]:
                if score[v] >= 0 or v in marked:
                    rescore(v)
        else:
            sinks = [v for v in range(n) if not succs[v]]
            top = max(sinks, key=lambda v: score[v])
        out = bytearray()
        v = top
        while v >= 0:
            out.append(self.bases[v])
            v = cfrom[v]
        return bytes(reversed(out))

    def rows(self) -> list:
        n = len(self)
        rank = {v: i for i, v in enumerate(self.topo)}
        gid = [min([v] + self.ring[v]) for v in range(n)]
        groups = sorted(set(gid))
        g_rank = {g: n for g in groups}
        for v in range(n):
            g_rank[gid[v]] = min(g_rank[gid[v]], rank[v])
        arcs = {g: set() for g in groups}
        for v, ps in enumerate(self.preds):
            for p in ps:
                if gid[p] != gid[v]:
                    arcs[gid[p]].add(gid[v])
        indeg = {g: 0 for g in groups}
        for g in groups:
            for s in arcs[g]:
                indeg[s] += 1
        heap = [(g_rank[g], g) for g in groups if indeg[g] == 0]
        heapq.heapify(heap)
        col = {}
        while heap:
            _, g = heapq.heappop(heap)
            col[g] = len(col)
            for s in arcs[g]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, (g_rank[s], s))
        if len(col) != len(groups):
            raise ValueError("the column graph has a cycle")
        mat = np.full((self.n_seq, len(col)), ord("-"), np.uint8)
        # within a column, a read through two variants keeps the later one
        for v in sorted(range(n), key=lambda v: (col[gid[v]], rank[v])):
            for s in self.passing[v]:
                mat[s, col[gid[v]]] = self.bases[v]
        return [bytes(r) for r in mat]


def _narrow(dtype) -> tuple:
    """(the dtype computed in, the clamp after each step, its range): a
    narrow type is computed in int32 and clamped to its range."""
    if dtype in (torch.int32, torch.int64):
        return dtype, (lambda t: t), (NEG, -NEG)
    info = torch.iinfo(dtype)
    return torch.int32, (lambda t: t.clamp_(info.min, info.max)), (
        info.min, info.max)


@torch.no_grad()
def round_dp(g: Graph, seq: bytes, params, device, dtype=torch.int32,
             budget: int = 16 << 30):
    """One round of ``seq`` against ``g``: (score, the topo row of each
    read base or -1).  The word plane is kept whole up to ``budget``
    bytes; past it the DP keeps a copy of the ring every K rows and the
    walk recomputes the words of one K-row segment at a time."""
    M, X, E, O = (int(x) for x in params)
    dtype, sat, (lo, hi) = _narrow(dtype)

    def cst(v):
        return max(lo, min(hi, int(v)))

    order = g.topo
    N, n = len(order), len(seq)
    dev = torch.device(device)
    row_of = {v: i for i, v in enumerate(order)}
    prow = [[row_of[p] for p in g.preds[v]] for v in order]
    hm1 = []
    for i in range(N):
        hm1.append(O + E if not prow[i] else max(hm1[r] for r in prow[i]) + E)
    depth = max([i - r for i in range(N) for r in prow[i]] + [1])
    W = depth + 1
    K = N if N * n * 4 <= budget else max(1, budget // (4 * n))
    a = torch.from_numpy(np.frombuffer(bytes(seq), np.uint8).astype(
        np.int16)).to(dev)
    j = torch.arange(n, device=dev, dtype=torch.int64)
    jE = (j * E).clamp(lo, hi).to(dtype)
    OjE = (O + j * E).clamp(lo, hi).to(dtype)
    h_virt = (O + (j + 1) * E).clamp(lo, hi).to(dtype)
    neg = torch.full((n,), cst(NEG), dtype=dtype, device=dev)
    ring_h = torch.empty((W, n), dtype=dtype, device=dev)
    ring_e = torch.empty((W, n), dtype=dtype, device=dev)
    words = torch.empty((min(K, N), n), dtype=torch.int32, device=dev)
    last = torch.empty((N,), dtype=dtype, device=dev)
    diag = torch.empty((n,), dtype=dtype, device=dev)
    y = torch.full((padded(n),), lo, dtype=dtype, device=dev)
    zero = torch.zeros((n,), dtype=torch.int32, device=dev)
    f_ext = torch.zeros((n,), dtype=torch.int32, device=dev)
    # each row's inputs, on the device, read at the row counter ``at``, so
    # a row of one in-degree is the same kernels whatever row it is
    letters = sorted(set(g.bases))
    subtab = torch.stack([torch.where(a == x, cst(M), cst(X)).to(dtype)
                          for x in letters])
    hm1p = [[hm1[r] for r in prow[i]] or [0] for i in range(N)]
    D = max(len(p) for p in prow) or 1

    def table(rows, dt):
        return torch.tensor(rows, dtype=dt, device=dev)
    letter = {x: k for k, x in enumerate(letters)}
    t_base = table([letter[g.bases[v]] for v in order], torch.int64)
    t_slot = table([i % W for i in range(N)], torch.int64)
    t_pred = table([[r % W for r in p] + [0] * (D - len(p)) for p in prow],
                   torch.int64)
    t_fill0 = table([cst(max(h)) for h in hm1p], dtype)
    t_fill1 = table([h.index(max(h)) for h in hm1p], torch.int32)
    t_y0 = table([cst(x + E) for x in hm1], dtype)
    at = torch.zeros((1,), dtype=torch.int64, device=dev)
    wat = torch.zeros((1,), dtype=torch.int64, device=dev)

    def node(d, with_words):
        """One row of in-degree ``d`` (0: a source, under the virtual row)
        at row ``at``, its word at row ``wat`` of the plane."""
        slots = t_pred.index_select(0, at)[0]
        hb = eb = None
        ha = ea = ex = zero
        for k in range(max(d, 1)):
            if d == 0:
                hp, ep = h_virt, neg
            else:
                hp = ring_h.index_select(0, slots[k:k + 1])[0]
                ep = ring_e.index_select(0, slots[k:k + 1])[0]
            ee = sat(ep + E)
            ec = torch.maximum(ee, sat(hp + cst(O + E)))
            ext = (ee == ec).to(torch.int32)
            if hb is None:
                hb, eb, ex = hp, ec, ext
                continue
            up = hp > hb
            hb = torch.maximum(hb, hp)
            ha = torch.where(up, k, ha)
            up = ec > eb
            eb = torch.maximum(eb, ec)
            ea = torch.where(up, k, ea)
            ex = torch.where(up, ext, ex)
        diag[0:1] = t_fill0.index_select(0, at)
        diag[1:] = hb[:-1]
        sat(diag.add_(subtab.index_select(0, t_base.index_select(0, at))[0]))
        c = torch.maximum(diag, eb)
        y[0:1] = t_y0.index_select(0, at)
        torch.sub(c[:-1], jE[:-1], out=y[1:n])
        sat(y)
        f = sat(prefix_max(y)[:n] + OjE)
        h = torch.maximum(c, f)
        if with_words:
            h_pred = ha.roll(1)
            h_pred[0:1] = t_fill1.index_select(0, at)
            f_ext[1:] = f[1:] == sat(f[:-1] + E)
            word = torch.where(h == diag, 0, torch.where(h == eb, 4, 8)).to(
                torch.int32) + ex * 2 + f_ext
            if d > 1:
                word += (h_pred << 4) + (ea << 17)
            words.index_copy_(0, wat, word[None])
        slot = t_slot.index_select(0, at)
        ring_h.index_copy_(0, slot, h[None])
        ring_e.index_copy_(0, slot, eb[None])
        last.index_copy_(0, at, h[n - 1:n])
        at.add_(1)
        wat.add_(1)

    graphs = {}

    def step(i, with_words):
        """Row i (``at`` must be i): on the card each kind of row is
        captured once as a CUDA graph and replayed."""
        key = (len(prow[i]), with_words)
        if key in graphs:
            graphs[key].replay()
            return
        node(*key)
        if dev.type == "cuda":
            graph = _capture(lambda: node(*key))
            if graph is not None:
                graphs[key] = graph

    snaps = {}
    for i in range(N):
        if K < N and i % K == 0:
            snaps[i] = (ring_h.clone(), ring_e.clone())
            wat.zero_()
        step(i, K == N)
    succs = g.succs()
    sink_rows = [i for i, v in enumerate(order) if not succs[v]]
    sc = last[sink_rows].cpu().tolist()
    best = sink_rows[sc.index(max(sc))]
    seg = [0 if K == N else -1]

    def plane(row):
        """(the word plane of the segment holding ``row``, its first
        row)."""
        s0 = row // K * K
        if seg[0] != s0:
            ring_h.copy_(snaps[s0][0])
            ring_e.copy_(snaps[s0][1])
            at.fill_(s0)
            wat.zero_()
            for i in range(s0, min(N, s0 + K)):
                step(i, True)
            seg[0] = s0
        return words, s0

    return int(max(sc)), _walk(plane, prow, best, n)


def _walk(plane, prow, row: int, n: int) -> list:
    """The traceback from ``row`` at column n-1: the topo row of each
    read base, -1 for an insertion.  ``plane(row)`` gives the words of
    the segment holding ``row`` and its first row; they are read to the
    host in windows."""
    align = [-1] * n
    j, state = n - 1, 0
    win, r0, c0 = None, 0, 0
    R = C = 256
    while j >= 0 and row >= 0:
        if win is None or not (r0 <= row < r0 + win.shape[0]
                               and c0 <= j < c0 + win.shape[1]):
            words, s0 = plane(row)
            r0, c0 = max(s0, row - R + 1), max(0, j - C + 1)
            win = words[r0 - s0:row + 1 - s0, c0:j + 1].cpu().numpy()
        w = int(win[row - r0, j - c0])
        if state == 0:
            h_type = (w >> 2) & 3
            if h_type == 0:
                align[j] = row
                k = (w >> 4) & 0x1FFF
                row = prow[row][k] if prow[row] else -1
                j -= 1
            else:
                state = h_type
        elif state == 1:
            k = (w >> 17) & 0x1FFF
            row = prow[row][k] if prow[row] else -1
            state = (w >> 1) & 1
        else:
            align[j] = -1
            j -= 1
            state = 2 if w & 1 else 0
    return align


def _capture(fn):
    """``fn``'s kernels captured as one CUDA graph, or None where they
    cannot be (the rows then run eagerly).  Capturing runs nothing."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError:
        return None
    return graph


def align_seqs(seqs, params, device, dtype=torch.int32,
               budget: int = 16 << 30) -> dict:
    """The progressive MSA of ``seqs``: ``rows``, ``consensus`` and
    ``round_scores``."""
    g = Graph(bytes(seqs[0]), len(seqs))
    scores = []
    for k in range(1, len(seqs)):
        seq = bytes(seqs[k])
        score, rows = round_dp(g, seq, params, device, dtype, budget)
        scores.append(score)
        order = g.topo
        g.merge(seq, k, [order[r] if r >= 0 else -1 for r in rows])
        g.toposort()
    return {"rows": g.rows(), "consensus": g.consensus(),
            "round_scores": scores}
