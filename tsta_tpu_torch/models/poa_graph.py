"""Host-side POA graph for the TPU-native MSA engine.

A clean partial-order graph with the reference's capabilities (node merge,
edge weights, per-read passing sets, aligned-variant rings capped at one
per base, heaviest-bundle consensus -- reference structures poa.h:100-134,
fusion c-t-simd.c:659-977, topo.c, result.c) but with simplified,
documented tie rules: the device DP (ops/msa_native.py) is the exact
int32 recurrence, and fusion walks a 3-state (H/E/F) textbook traceback.

Storage is ARRAY-BACKED (r4 host-tail rework): bases/in-degrees/pred
rows/weights/passing/variant rings live in capacity-doubling numpy
buffers rather than Python lists-of-lists, so (a) the per-round fusion
loop can run in C (native/poa_fast.c tsta_poa_merge) writing the
buffers in place, and (b) csr()/toposort/_prepare/msa_rows consume the
adjacency with vectorised numpy instead of flattening ~50-200k Python
lists per round (the flatten alone was ~20 ms/round at 50k nodes,
~80 ms at 200k).  ``bases``/``preds``/``weights``/``variants``/
``passing`` remain available as list-style READ accessors for tests and
cold paths; the device only ever sees dense per-round tensors derived
from the buffers.

Buffer invariants (the C merge relies on them):
  * nodes are never removed; rows >= _n have never been written and are
    all-zero (fresh allocations are zeroed, growth copies only [:_n]);
  * per-node pred order is insertion order (argmax tie-breaking in the
    round DP depends on it);
  * a merge round grows any single node's in-degree and variant-ring
    size by at most 1 (fusion consumes each column once), so pre-growing
    pmax/vmax by 1 before the round makes in-place C fusion safe.

The port's own copy of ``tsta_tpu/models/poa_graph.py``, so that the
port imports nothing of the JAX package; the tests hold the two against
each other.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

_PMAX0 = 4   # initial pred slots per node
_VMAX0 = 4   # initial variant-ring slots (A/C/G/T alternates; grows for
             # exotic alphabets -- the reference hard-caps at 4,
             # poa.h:109 mismatch_node[4])


class PoaGraph:
    __slots__ = ("n_seq", "_n", "_bases", "_ndeg", "_preds", "_weights",
                 "_passing", "_nvar", "_vars", "topo", "_succs", "_csr")

    def __init__(self, n_seq: int, cap: int = 64):
        self.n_seq = int(n_seq)
        self._n = 0
        cap = max(int(cap), 1)
        self._bases = np.zeros(cap, np.uint8)
        self._ndeg = np.zeros(cap, np.int32)
        self._preds = np.zeros((cap, _PMAX0), np.int32)
        self._weights = np.zeros((cap, _PMAX0), np.int32)
        self._passing = np.zeros((cap, self.n_seq), bool)
        self._nvar = np.zeros(cap, np.int32)
        self._vars = np.zeros((cap, _VMAX0), np.int32)
        self.topo: List[int] = []
        self._succs: Optional[List[List[int]]] = None
        self._csr: Optional[tuple] = None

    # -- capacity management ------------------------------------------

    def _grow(self, n_cap: int = 0, pmax: int = 0, vmax: int = 0) -> None:
        """Ensure capacities; no-op when already sufficient.  New rows /
        columns are zero-filled (rows >= _n stay all-zero)."""
        n = self._n
        cap = self._bases.shape[0]
        if n_cap > cap:
            new = max(n_cap, 2 * cap)
            for name in ("_bases", "_ndeg", "_nvar"):
                old = getattr(self, name)
                a = np.zeros(new, old.dtype)
                a[:n] = old[:n]
                setattr(self, name, a)
            for name in ("_preds", "_weights", "_vars", "_passing"):
                old = getattr(self, name)
                a = np.zeros((new, old.shape[1]), old.dtype)
                a[:n] = old[:n]
                setattr(self, name, a)
            cap = new
        if pmax > self._preds.shape[1]:
            new = max(pmax, 2 * self._preds.shape[1])
            for name in ("_preds", "_weights"):
                old = getattr(self, name)
                a = np.zeros((cap, new), old.dtype)
                a[:n, :old.shape[1]] = old[:n]
                setattr(self, name, a)
        if vmax > self._vars.shape[1]:
            new = max(vmax, 2 * self._vars.shape[1])
            a = np.zeros((cap, new), self._vars.dtype)
            a[:n, :self._vars.shape[1]] = self._vars[:n]
            self._vars = a

    # -- list-style read accessors (tests, serialisation, cold paths) --

    def __len__(self) -> int:
        return self._n

    @property
    def bases(self) -> List[int]:
        return self._bases[:self._n].tolist()

    @property
    def preds(self) -> List[List[int]]:
        nd, P = self._ndeg, self._preds
        return [P[v, :nd[v]].tolist() for v in range(self._n)]

    @property
    def weights(self) -> List[List[int]]:
        nd, W = self._ndeg, self._weights
        return [W[v, :nd[v]].tolist() for v in range(self._n)]

    @property
    def variants(self) -> List[List[int]]:
        nv, V = self._nvar, self._vars
        return [V[v, :nv[v]].tolist() for v in range(self._n)]

    @property
    def passing(self) -> List[np.ndarray]:
        return list(self._passing[:self._n])

    def max_in_degree(self) -> int:
        """Max in-degree over current nodes (0 for an empty graph)."""
        return int(self._ndeg[:self._n].max(initial=0))

    # -- mutation -------------------------------------------------------

    def add_node(self, base: int, seq_no: int,
                 preds: Optional[List[int]] = None) -> int:
        ps = list(preds or [])
        idx = self._n
        self._grow(n_cap=idx + 1, pmax=len(ps))
        self._n = idx + 1
        self._csr = None
        self._bases[idx] = int(base)
        k = len(ps)
        self._ndeg[idx] = k
        if k:
            self._preds[idx, :k] = ps
            self._weights[idx, :k] = 1
        self._passing[idx, seq_no] = True
        if self._succs is not None:
            self._succs.append([])
            for pv in ps:
                self._succs[pv].append(idx)
        return idx

    def add_edge(self, src: int, dst: int, w: int = 1) -> None:
        if src < 0:
            return
        self._csr = None
        nd = int(self._ndeg[dst])
        row = self._preds[dst]
        for k in range(nd):
            if row[k] == src:
                self._weights[dst, k] += w
                return
        if nd >= self._preds.shape[1]:
            self._grow(pmax=nd + 1)
        self._preds[dst, nd] = src
        self._weights[dst, nd] = w
        self._ndeg[dst] = nd + 1
        if self._succs is not None:
            self._succs[src].append(dst)

    @classmethod
    def from_sequence(cls, seq: bytes, n_seq: int) -> "PoaGraph":
        # bulk-built: a chain's topo order is the identity, so the
        # initial Kahn pass is skipped too
        n = len(seq)
        g = cls(n_seq=n_seq, cap=max(n, 1))
        g._n = n
        if n:
            g._bases[:n] = np.frombuffer(bytes(seq), np.uint8) \
                if isinstance(seq, (bytes, bytearray)) \
                else np.asarray(list(seq), np.uint8)
            g._ndeg[1:n] = 1
            g._preds[1:n, 0] = np.arange(n - 1, dtype=np.int32)
            g._weights[1:n, 0] = 1
            g._passing[:n, 0] = True
        g.topo = list(range(n))
        return g

    # -- derived structure ---------------------------------------------

    def csr(self):
        """Flattened adjacency ``(nd, ptr, flat, wflat, sptr, sidx)``
        (all int64; node order): predecessor CSR + edge weights +
        successor CSR.  Cached until the next edge mutation (add_edge
        weight bumps also invalidate, so ``wflat`` stays current).
        Vectorised extraction from the padded buffers (boolean-mask,
        row-major: per-node pred order is preserved)."""
        if self._csr is None:
            n = self._n
            nd = self._ndeg[:n].astype(np.int64)
            ptr = np.zeros(n + 1, np.int64)
            np.cumsum(nd, out=ptr[1:])
            pmax = self._preds.shape[1]
            mask = np.arange(pmax) < nd[:, None]
            flat = self._preds[:n][mask].astype(np.int64)
            wflat = self._weights[:n][mask].astype(np.int64)
            dst = np.repeat(np.arange(n, dtype=np.int64), nd)
            srt = np.argsort(flat, kind="stable")
            sidx = np.ascontiguousarray(dst[srt])
            sptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(flat, minlength=n), out=sptr[1:])
            self._csr = (nd, ptr, flat, wflat, sptr, sidx)
        return self._csr

    def succs(self) -> List[List[int]]:
        if self._succs is None:
            _, _, _, _, sptr, sidx = self.csr()
            self._succs = [sidx[sptr[v]:sptr[v + 1]].tolist()
                           for v in range(self._n)]
        return self._succs

    def sinks(self) -> List[int]:
        _, _, _, _, sptr, _ = self.csr()
        return np.flatnonzero(sptr[1:] == sptr[:-1]).tolist()

    def toposort(self) -> List[int]:
        """Deterministic Kahn order, keeping aligned-variant rings
        adjacent so they share an output column.

        Runs the NATIVE Kahn (native/poa_fast.c, bit-identical order --
        the engines' round-score parity depends on it) when available;
        the Python path below remains the semantics reference and the
        fallback for the rare variants-not-ready case the C main path
        does not replicate.  TSTA_NATIVE_TOPO=0 opts out."""
        import os
        n = self._n
        gate = os.environ.get("TSTA_NATIVE_TOPO", "1")
        if gate not in ("", "0") and (n > 2048 or gate == "force"):
            order = self._toposort_native(n)
            if order is not None:
                self.topo = order
                return order
        nd_arr, _, _, _, _, _ = self.csr()
        indeg = nd_arr.tolist()
        succs = self.succs()
        nvar = self._nvar
        vars_ = self._vars
        ready = [v for v in range(n) if indeg[v] == 0]
        order: List[int] = []
        placed = [False] * n
        import heapq
        heapq.heapify(ready)
        while ready:
            v = heapq.heappop(ready)
            if placed[v]:
                continue
            group = [v] + [int(w) for w in vars_[v, :nvar[v]]
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
            # variants not yet ready break grouping; fall back to pure Kahn
            P, nd = self._preds, self._ndeg
            remaining = [v for v in range(n) if not placed[v]]
            indeg2 = {v: sum(1 for p in P[v, :nd[v]] if not placed[p])
                      for v in remaining}
            ready = sorted(v for v in remaining if indeg2[v] == 0)
            while ready:
                v = ready.pop(0)
                placed[v] = True
                order.append(v)
                for s in succs[v]:
                    if not placed[s]:
                        indeg2[s] -= 1
                        if indeg2[s] == 0:
                            ready.append(s)
                            ready.sort()
        self.topo = order
        return order

    def _rank_kahn_native(self, ng, rank, indeg, eptr, gb, emit_pos):
        """C rank-keyed Kahn for msa_rows' condensed column DAG;
        returns ncols or None (library unavailable / cycle -- the
        Python paths handle both).  TSTA_NATIVE_TOPO=0 opts out."""
        import os
        if os.environ.get("TSTA_NATIVE_TOPO", "1") in ("", "0"):
            return None
        try:
            from tsta_tpu_torch.native.build import load_poa
            lib = load_poa()
        except Exception:  # pragma: no cover - toolchain-less host
            return None
        import ctypes
        lp = ctypes.POINTER(ctypes.c_long)

        def P(a):
            return np.ascontiguousarray(a, np.int64).ctypes.data_as(lp)

        ncols = lib.tsta_poa_rank_kahn(int(ng), P(rank), P(indeg),
                                       P(eptr), P(gb), P(emit_pos))
        if ncols < 0:
            return None
        return int(ncols)

    def _toposort_native(self, n: int) -> Optional[List[int]]:
        """CSR-marshal the graph and run the C Kahn; None on any
        shortfall (library unavailable, or the C main path placed fewer
        than n nodes -- the caller's Python fallback handles those)."""
        try:
            from tsta_tpu_torch.native.build import load_poa
            lib = load_poa()
        except Exception:  # pragma: no cover - toolchain-less host
            return None
        import ctypes
        nd, _, _, _, sptr, sidx = self.csr()
        vn = self._nvar[:n].astype(np.int64)
        vmask = np.arange(self._vars.shape[1]) < vn[:, None]
        vidx = self._vars[:n][vmask].astype(np.int64)
        vptr = np.zeros(n + 1, np.int64)
        np.cumsum(vn, out=vptr[1:])
        order = np.empty(n, np.int64)
        lp = ctypes.POINTER(ctypes.c_long)

        def P(a):
            return a.ctypes.data_as(lp)

        placed = lib.tsta_poa_toposort(n, P(sptr), P(sidx), P(nd),
                                       P(vptr), P(vidx), P(order))
        if placed != n:
            return None
        return order.tolist()

    def apply_delta(self, seq: bytes, seq_no: int, order,
                    align_rows) -> int:
        """Replay one round's graph mutation from its delta.

        The delta of a fusion round is the alignment column map
        ``align_rows`` ((len(seq),) topo rows, -1 for insertions): the
        merge itself is a deterministic pure function of
        ``(graph, seq, seq_no, order, align_rows)``, so replicated
        graphs on every host stay bit-identical when each replays the
        same few-KB delta (parallel/msa_multihost.py broadcasts it;
        the TPU-native replacement for the reference's shared-memory
        graph that all threads mutate in place, c-t-simd.c:659-977).
        Returns the number of nodes added.
        """
        from tsta_tpu_torch.ops.msa_native import _merge
        return _merge(self, seq, seq_no, order, align_rows)

    def consensus(self) -> bytes:
        """Heaviest-bundle consensus with the reference's re-scoring
        semantics (tp1 + modify, topo.c:7-177): per node take the
        max-edge-weight predecessor among non-negated ones (ties go to
        the later predecessor when its score is >= the held one); while
        the global best is not a sink, negate the lighter competing
        predecessors of its successors and re-score downstream.  With
        the tp1+modify rules adopted, consensus matches the compat
        engine on 20/20 random quality corpora (asserted in
        tests/test_msa_quality.py); byte parity on goldens remains the
        compat engine's contract.  The 4n+4 iteration bound is a safety
        net against inputs where the reference's recursive modify()
        would never terminate (e.g. a competing predecessor with score 0
        or tied with the global max is never negated); on exhaustion we
        fall back to tracing from the best-scoring sink instead of
        emitting a truncated consensus from a stuck non-sink."""
        n = self._n
        topo = self.topo
        native = self._consensus_native(n)
        if native is not None:
            top, cfrom_arr = native
            out = bytearray()
            v = top
            while v >= 0:
                out.append(self._bases[v])
                v = int(cfrom_arr[v])
            out.reverse()
            return bytes(out)
        pos = {v: i for i, v in enumerate(topo)}
        succs = self.succs()
        sinks = set(self.sinks())
        score = [0] * n
        cfrom = [-1] * n
        Pr, Wt, nd = self._preds, self._weights, self._ndeg

        def rescore(v):
            mx, mx_j = 0, -1
            k = nd[v]
            ps, ws = Pr[v, :k], Wt[v, :k]
            for j in range(k):
                p, w = ps[j], ws[j]
                if score[p] >= 0:
                    if mx < w or (mx == w and mx_j >= 0
                                  and score[ps[mx_j]] <= score[p]):
                        mx, mx_j = w, j
            if mx_j < 0:
                score[v], cfrom[v] = 0, -1
            else:
                score[v], cfrom[v] = score[ps[mx_j]] + int(mx), int(ps[mx_j])

        for v in topo:
            rescore(v)
        for _ in range(4 * n + 4):     # modify loop; bound is a safety net
            top, mx = topo[0], score[topo[0]]
            for v in topo:
                if score[v] >= mx:
                    top, mx = v, score[v]
            if top in sinks:
                break
            marked = set()
            for nx in succs[top]:
                for p in Pr[nx, :nd[nx]]:
                    if 0 < score[p] < score[top]:
                        score[p] = -score[p]
                marked.add(nx)
            for v in topo[pos[top] + 1:]:
                if score[v] >= 0 or v in marked:
                    rescore(v)
        else:
            # bound exhausted (see docstring): trace from the heaviest
            # sink rather than a stuck interior node, which would emit a
            # silently truncated consensus.
            top = max(sinks, key=lambda v: score[v]) if sinks else top
        out = bytearray()
        v = top
        while v >= 0:
            out.append(self._bases[v])
            v = cfrom[v]
        out.reverse()
        return bytes(out)

    def _consensus_native(self, n: int):
        """C consensus scoring (native/poa_fast.c tsta_poa_consensus,
        same rescore/modify semantics); returns (top, cfrom) or None
        (library unavailable, empty graph, or the 4n+4 modify bound
        exhausted -- the Python path then applies its best-sink
        rescue).  TSTA_NATIVE_TOPO=0 opts out."""
        import os
        if n == 0 or os.environ.get("TSTA_NATIVE_TOPO", "1") in ("",
                                                                 "0"):
            return None
        try:
            from tsta_tpu_torch.native.build import load_poa
            lib = load_poa()
        except Exception:  # pragma: no cover - toolchain-less host
            return None
        import ctypes
        nd, ptr, flat, wflat, sptr, sidx = self.csr()
        topo_arr = np.ascontiguousarray(self.topo, np.int64)
        score = np.zeros(n, np.int64)
        cfrom = np.full(n, -1, np.int64)
        lp = ctypes.POINTER(ctypes.c_long)

        def P(a):
            return a.ctypes.data_as(lp)

        top = lib.tsta_poa_consensus(n, P(topo_arr), P(ptr), P(flat),
                                     P(wflat), P(sptr), P(sidx),
                                     P(score), P(cfrom))
        if top < 0:
            return None
        return int(top), cfrom

    def msa_rows(self) -> List[bytes]:
        """Row-wise MSA: one column per variant ring (reference
        result.c:42-66 semantics).

        Columns are ordered by a topological sort of the *condensed*
        column graph (variant groups as vertices, node edges as arcs):
        ordering raw nodes by graph topo order -- as the reference does
        -- can emit a variant group before an intervening node of some
        read's path when the variant was created in a later round,
        swapping adjacent bases in that read's row.  The reference's
        custom tp/tp1 visit order avoids this for its own fusion rules;
        the condensed sort is the general guarantee.  On a (degenerate)
        cyclic column graph it falls back to node-topo order.
        """
        n = self._n
        if n == 0:
            return [b""] * self.n_seq
        topo = np.asarray(self.topo, np.int64)
        topo_rank = np.empty(n, np.int64)
        topo_rank[topo] = np.arange(n)

        # variant groups = connected components of the variant relation.
        # Rings are mutual CLIQUES by construction (_merge registers a
        # new variant in every member's ring and hands it the full
        # ring), so the component id is simply min(member ids) -- one
        # vectorised reduction instead of the per-node union-find loop
        # (which was ~25 ms of the 3x50k final emit).  The fixed-point
        # check guards the clique invariant; on a violation (foreign
        # graph state) the union-find fallback below restores full
        # transitive-closure semantics.
        nvar = self._nvar[:n]
        vars_ = self._vars
        vmax = vars_.shape[1]
        ids = np.arange(n, dtype=np.int64)
        ring_min = np.where(np.arange(vmax) < nvar[:, None],
                            vars_[:n], n).min(axis=1)
        gid = np.minimum(ids, ring_min)
        # clique guard: roots must be fixed points AND every member's
        # ring size must equal its group size - 1 (catches asymmetric /
        # partially-written relations that happen to be idempotent,
        # e.g. a member missing its back-edge)
        ok = np.array_equal(gid[gid], gid)
        if ok:
            counts = np.bincount(gid, minlength=n)
            ok = bool(np.array_equal(nvar + 1, counts[gid]))
        if not ok:  # pragma: no cover
            gid = ids.copy()

            def find(a):
                while gid[a] != a:
                    gid[a] = gid[gid[a]]
                    a = gid[a]
                return a

            for v in np.nonzero(nvar)[0]:
                for w in vars_[v, :nvar[v]]:
                    ra, rb = find(v), find(w)
                    if ra != rb:
                        gid[max(ra, rb)] = min(ra, rb)
            while True:
                nxt = gid[gid]
                if np.array_equal(nxt, gid):
                    break
                gid = nxt
        group_of = gid

        # condensed DAG (variant groups as vertices, node edges as arcs);
        # group ids are root node ids (fixed points of gid), so the
        # sorted-unique + inverse reduces to flatnonzero + searchsorted
        roots = np.flatnonzero(group_of == np.arange(n))
        gidx = np.searchsorted(roots, group_of)
        ng = roots.shape[0]
        rank = np.full(ng, n, np.int64)
        np.minimum.at(rank, gidx, topo_rank)
        nd, _, flat = self.csr()[:3]
        if int(nd.sum()):
            src = flat
            dst = np.repeat(np.arange(n, dtype=np.int64), nd)
            ga, gb = gidx[src], gidx[dst]
            keep = ga != gb
            e = np.unique(ga[keep] * ng + gb[keep])
            ga, gb = e // ng, e % ng
        else:
            ga = gb = np.zeros(0, np.int64)
        indeg = np.bincount(gb, minlength=ng)
        esrt = np.argsort(ga, kind="stable")
        ga, gb = ga[esrt], gb[esrt]
        eptr = np.searchsorted(ga, np.arange(ng + 1))

        # Kahn with min-topo-rank heap (ranks are distinct, so the order
        # is deterministic); emit position per group.  When every group
        # is a singleton (no variants) the condensed DAG IS the node DAG
        # and rank-heap Kahn provably re-emits the node topo order --
        # skip the heap entirely.
        import heapq
        emit_pos = np.full(ng, -1, np.int64)
        if ng == n and not nvar.any():
            emit_pos[gidx[topo]] = np.arange(n)
            ncols = n
        elif (ncols := self._rank_kahn_native(
                ng, rank, indeg, eptr, gb, emit_pos)) is not None:
            pass   # native rank-heap Kahn filled emit_pos (same order:
            #        ranks are distinct, so (rank, g) order == rank order)
        else:
            rank_l = rank.tolist()
            indeg_l = indeg.tolist()
            gb_l = gb.tolist()
            eptr_l = eptr.tolist()
            heap = [(rank_l[g], g)
                    for g in np.nonzero(indeg == 0)[0].tolist()]
            heapq.heapify(heap)
            ncols = 0
            while heap:
                _, g = heapq.heappop(heap)
                emit_pos[g] = ncols
                ncols += 1
                for s in gb_l[eptr_l[g]:eptr_l[g + 1]]:
                    indeg_l[s] -= 1
                    if indeg_l[s] == 0:
                        heapq.heappush(heap, (rank_l[s], s))
        if ncols != ng:  # cycle: fall back to node order
            printed = [False] * n
            cols = []
            for v in self.topo:
                if printed[v]:
                    continue
                group = [v] + [int(w) for w in vars_[v, :nvar[v]]
                               if not printed[w]]
                for w in group:
                    printed[w] = True
                cols.append(group)
            ncols = len(cols)
            col_of = np.empty(n, np.int64)
            order = np.empty(n, np.int64)
            flat = np.fromiter((w for g in cols for w in g), np.int64, n)
            col_of[flat] = np.repeat(np.arange(ncols),
                                     [len(g) for g in cols])
            order[flat] = np.arange(n)
        else:
            # within a column, members are emitted in topo order; a later
            # write wins for a sequence passing two variants of one
            # column, as the reference's per-node print loop does
            # (result.c:42-66).  Sorting the passing entries directly by
            # the (column, topo rank) key is equivalent to ranking every
            # node first (keys are distinct per node; duplicates of one
            # node share a key and keep their stable seq order) and
            # saves two full-length argsorts.
            col_of = emit_pos[gidx]
            order = None

        rows_mat = np.full((self.n_seq, ncols), ord("-"), np.uint8)
        nodes, seqs = np.nonzero(self._passing[:n])
        key = (order[nodes] if order is not None
               else col_of[nodes] * np.int64(n) + topo_rank[nodes])
        srt = np.argsort(key, kind="stable")
        nodes, seqs = nodes[srt], seqs[srt]
        rows_mat[seqs, col_of[nodes]] = self._bases[nodes]
        return [bytes(r) for r in rows_mat]


def save_graph(path: str, g: PoaGraph, extra: Optional[Dict] = None) -> None:
    """Serialise the graph to npz (CSR edges) for resume/debugging.

    The file is written to ``path`` verbatim (np.savez would silently
    append '.npz' otherwise, and the resume existence-check in
    ops/msa_native.align_seqs would then never see the snapshot).
    """
    with open(path, "wb") as fh:
        _savez_to(fh, g, extra)


def _savez_to(fh, g: PoaGraph, extra):
    import json
    n = len(g)
    nd, ptr, flat, wflat, _, _ = g.csr()
    vn = g._nvar[:n].astype(np.int64)
    vmask = np.arange(g._vars.shape[1]) < vn[:, None]
    np.savez_compressed(
        fh,
        n_seq=g.n_seq,
        bases=g._bases[:n].copy(),
        indptr=ptr,
        indices=flat,
        weights=wflat,
        passing=g._passing[:n].copy(),
        var_indptr=np.concatenate([[0], np.cumsum(vn)]).astype(np.int64),
        var_indices=g._vars[:n][vmask].astype(np.int64),
        extra=np.frombuffer(json.dumps(extra or {}).encode(), np.uint8),
    )


def load_graph(path: str) -> tuple:
    """Load a graph snapshot; returns (PoaGraph, extra_dict)."""
    import json
    z = np.load(path)
    bases = z["bases"]
    n = bases.shape[0]
    g = PoaGraph(n_seq=int(z["n_seq"]), cap=max(n, 1))
    indptr = z["indptr"].astype(np.int64)
    nd = np.diff(indptr)
    var_indptr = z["var_indptr"].astype(np.int64)
    vn = np.diff(var_indptr)
    g._grow(pmax=int(nd.max(initial=0)), vmax=int(vn.max(initial=0)))
    g._n = n
    if n:
        g._bases[:n] = bases
        g._ndeg[:n] = nd
        pm = np.arange(g._preds.shape[1]) < nd[:, None]
        g._preds[:n][pm] = z["indices"]
        g._weights[:n][pm] = z["weights"]
        g._passing[:n] = z["passing"]
        g._nvar[:n] = vn
        vm = np.arange(g._vars.shape[1]) < vn[:, None]
        g._vars[:n][vm] = z["var_indices"]
    g.toposort()
    extra = json.loads(bytes(z["extra"]).decode() or "{}")
    return g, extra
