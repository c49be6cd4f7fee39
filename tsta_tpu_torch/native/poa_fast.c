/* Native Kahn toposort for the POA graph host path.
 *
 * Replicates models/poa_graph.PoaGraph.toposort's MAIN path exactly --
 * min-heap of node ids, variant-ring members placed with their group
 * head when already ready (indeg == 0 at group-formation time) -- so
 * the emitted order is bit-identical to the Python implementation (the
 * round-score parity of the native MSA engine depends on the order:
 * per-pred argmax ties break by topo position).  The Python fallback
 * path (variants not ready at emission time, a cycle-ish corner) is
 * NOT replicated: on any shortfall this returns the partial count and
 * the caller redoes the sort in Python.
 *
 * Rationale (r4 profile): the Python heap Kahn costs ~80 ms per call
 * at 52k nodes and ~0.4 s at 207k (three calls per 2-round run); this
 * runs the same algorithm in ~2 ms / ~10 ms.  Reference counterpart:
 * t_sort/toposort (msa/topo.c:179-260).
 *
 * Build: gcc -O3 -march=native -fPIC -shared (native/build.py, ctypes).
 */

#include <stdlib.h>
#include <string.h>

/* array binary min-heap of longs */
typedef struct {
  long *a;
  long n;
} Heap;

static void heap_push(Heap *h, long v) {
  long i = h->n++;
  h->a[i] = v;
  while (i > 0) {
    long p = (i - 1) >> 1;
    if (h->a[p] <= h->a[i]) break;
    long t = h->a[p];
    h->a[p] = h->a[i];
    h->a[i] = t;
    i = p;
  }
}

static long heap_pop(Heap *h) {
  long top = h->a[0];
  h->a[0] = h->a[--h->n];
  long i = 0;
  for (;;) {
    long l = 2 * i + 1, r = l + 1, m = i;
    if (l < h->n && h->a[l] < h->a[m]) m = l;
    if (r < h->n && h->a[r] < h->a[m]) m = r;
    if (m == i) break;
    long t = h->a[m];
    h->a[m] = h->a[i];
    h->a[i] = t;
    i = m;
  }
  return top;
}

/* n nodes; successors CSR (sptr[n+1], sidx); initial in-degrees
 * indeg_in[n]; variant rings CSR (vptr[n+1], vidx); order[n] out.
 * Returns the number of nodes placed (n == success). */
long tsta_poa_toposort(long n, const long *sptr, const long *sidx,
                       const long *indeg_in, const long *vptr,
                       const long *vidx, long *order) {
  if (n <= 0) return 0;
  long *indeg = (long *)malloc((size_t)n * sizeof(long));
  char *placed = (char *)calloc((size_t)n, 1);
  /* every node enters the heap at most once (when indeg hits 0), plus
   * the initial ready set: n slots suffice */
  long *harr = (long *)malloc((size_t)n * sizeof(long));
  long *group = (long *)malloc((size_t)(n ? n : 1) * sizeof(long));
  if (!indeg || !placed || !harr || !group) {
    free(indeg); free(placed); free(harr); free(group);
    return -1;
  }
  memcpy(indeg, indeg_in, (size_t)n * sizeof(long));
  Heap h = {harr, 0};
  for (long v = 0; v < n; v++)
    if (indeg[v] == 0) heap_push(&h, v);
  long count = 0;
  while (h.n > 0) {
    long v = heap_pop(&h);
    if (placed[v]) continue;
    /* group = [v] + ready unplaced variant-ring members (checked with
     * the CURRENT indeg, as the Python list comprehension does) */
    long gn = 0;
    group[gn++] = v;
    for (long k = vptr[v]; k < vptr[v + 1]; k++) {
      long w = vidx[k];
      if (!placed[w] && indeg[w] == 0) group[gn++] = w;
    }
    for (long gi = 0; gi < gn; gi++) {
      long w = group[gi];
      if (placed[w]) continue;
      placed[w] = 1;
      order[count++] = w;
      for (long k = sptr[w]; k < sptr[w + 1]; k++) {
        long s = sidx[k];
        if (--indeg[s] == 0) heap_push(&h, s);
      }
    }
  }
  free(indeg);
  free(placed);
  free(harr);
  free(group);
  return count;
}

/* Boundary column H(v,-1) recurrence (ops/msa_pallas._prepare): in topo
 * order, hm1[i+1] = o+e for sources, else max over preds' hm1 plus e --
 * preds[] entries are buffer ids (topo pos + 1; 0 = the virtual row,
 * hm1[0] = 0), so they index hm1 directly.  The Python version
 * vectorises chain runs but still pays ~25-30 ms of per-breaker work
 * at 50k nodes; this is the same recurrence in one pass. */
void tsta_poa_hm1(long n_real, long max_in, const int *preds,
                  const long *lens, long e, long o, long *hm1) {
  hm1[0] = 0;
  for (long i = 0; i < n_real; i++) {
    long li = lens[i];
    long v;
    if (li == 0) {
      v = o + e;
    } else {
      const int *row = preds + i * max_in;
      long mx = hm1[row[0]];
      for (long k = 1; k < li; k++) {
        long x = hm1[row[k]];
        if (x > mx) mx = x;
      }
      v = mx + e;
    }
    hm1[i + 1] = v;
  }
}

/* Rank-keyed Kahn over the condensed column DAG
 * (models/poa_graph.msa_rows): pops the ready group with the smallest
 * topo rank (ranks are distinct, so the (rank, g) tuple order the
 * Python heap uses reduces to rank order), assigns emit positions.
 * Returns the number of groups emitted (== ng unless cyclic). */
long tsta_poa_rank_kahn(long ng, const long *rank, const long *indeg_in,
                        const long *eptr, const long *gb,
                        long *emit_pos) {
  if (ng <= 0) return 0;
  long *indeg = (long *)malloc((size_t)ng * sizeof(long));
  /* heap entries pack (rank, g): rank * (ng + 1) + g keeps order by
   * rank (distinct) and decodes g exactly */
  long *harr = (long *)malloc((size_t)ng * sizeof(long));
  if (!indeg || !harr) {
    free(indeg);
    free(harr);
    return -1;
  }
  memcpy(indeg, indeg_in, (size_t)ng * sizeof(long));
  Heap h = {harr, 0};
  long base = ng + 1;
  for (long g = 0; g < ng; g++)
    if (indeg[g] == 0) heap_push(&h, rank[g] * base + g);
  long ncols = 0;
  while (h.n > 0) {
    long g = heap_pop(&h) % base;
    emit_pos[g] = ncols++;
    for (long k = eptr[g]; k < eptr[g + 1]; k++) {
      long s = gb[k];
      if (--indeg[s] == 0) heap_push(&h, rank[s] * base + s);
    }
  }
  free(indeg);
  free(harr);
  return ncols;
}

/* Heaviest-bundle consensus scoring (models/poa_graph.consensus):
 * rescore every node in topo order (max-edge-weight predecessor among
 * non-negated ones; ties go to the later predecessor when its score is
 * >= the held one), then the reference's modify loop (topo.c:119-177
 * semantics): while the global best is not a sink, negate lighter
 * competing predecessors of its successors and re-score downstream.
 * Returns the trace start node, or -1 when the 4n+4 bound exhausts
 * (the Python fallback then redoes the whole consensus, including its
 * best-sink rescue).  score[] and cfrom[] are outputs. */
static void poa_rescore(long v, const long *pptr, const long *pidx,
                        const long *pw, long *score, long *cfrom) {
  long mx = 0, mxj = -1;
  for (long j = pptr[v]; j < pptr[v + 1]; j++) {
    long p = pidx[j], w = pw[j];
    if (score[p] >= 0) {
      if (mx < w || (mx == w && mxj >= 0 && score[pidx[mxj]] <= score[p])) {
        mx = w;
        mxj = j;
      }
    }
  }
  if (mxj < 0) {
    score[v] = 0;
    cfrom[v] = -1;
  } else {
    score[v] = score[pidx[mxj]] + mx;
    cfrom[v] = pidx[mxj];
  }
}

long tsta_poa_consensus(long n, const long *topo, const long *pptr,
                        const long *pidx, const long *pw,
                        const long *sptr, const long *sidx,
                        long *score, long *cfrom) {
  if (n <= 0) return -1;
  char *marked = (char *)calloc((size_t)n, 1);
  long *pos = (long *)malloc((size_t)n * sizeof(long));
  if (!marked || !pos) {
    free(marked);
    free(pos);
    return -1;
  }
  for (long i = 0; i < n; i++) pos[topo[i]] = i;
  for (long i = 0; i < n; i++)
    poa_rescore(topo[i], pptr, pidx, pw, score, cfrom);
  long top = -1;
  long iter;
  long bound = 4 * n + 4;
  for (iter = 0; iter < bound; iter++) {
    top = topo[0];
    long mx = score[top];
    for (long i = 0; i < n; i++) {
      long v = topo[i];
      if (score[v] >= mx) {
        top = v;
        mx = score[v];
      }
    }
    if (sptr[top + 1] == sptr[top]) break;   /* top is a sink */
    memset(marked, 0, (size_t)n);
    for (long k = sptr[top]; k < sptr[top + 1]; k++) {
      long nx = sidx[k];
      for (long j = pptr[nx]; j < pptr[nx + 1]; j++) {
        long p = pidx[j];
        if (0 < score[p] && score[p] < score[top]) score[p] = -score[p];
      }
      marked[nx] = 1;
    }
    for (long i = pos[top] + 1; i < n; i++) {
      long v = topo[i];
      if (score[v] >= 0 || marked[v])
        poa_rescore(v, pptr, pidx, pw, score, cfrom);
    }
  }
  free(marked);
  free(pos);
  return iter >= bound ? -1 : top;
}

/* One fusion round over the graph's array-backed buffers
 * (models/poa_graph.PoaGraph storage; semantics reference:
 * ops/msa_native._merge's Python loop, itself the TPU-side
 * re-design of the reference's node_fuse, msa/c-t-simd.c:659-977).
 * Writes bases/ndeg/preds/weights/passing/nvar/vars in place; the
 * caller pre-grows capacities (n + slen nodes, max in-degree + 1 pred
 * slots, max ring + 1 variant slots) so no reallocation happens here.
 * Returns nodes added, or -2 on a capacity breach (pre-grow invariant
 * violated -- the caller raises; buffers may be partially mutated).
 *
 * align[j] is the graph node aligned to seq[j] (-1 = insertion). */
static int poa_merge_edge(long prev, long v, long pmax, int *ndeg,
                          int *preds, int *weights) {
  if (prev < 0) return 0;
  int nd = ndeg[v];
  int *row = preds + v * pmax;
  for (int k = 0; k < nd; k++) {
    if (row[k] == prev) {
      weights[v * pmax + k] += 1;
      return 0;
    }
  }
  if (nd >= pmax) return -1;
  row[nd] = (int)prev;
  weights[v * pmax + nd] = 1;
  ndeg[v] = nd + 1;
  return 0;
}

long tsta_poa_merge(long n, long cap, long pmax, long vmax,
                    unsigned char *bases, int *ndeg, int *preds,
                    int *weights, unsigned char *passing, long n_seq,
                    long seq_no, int *nvar, int *vars,
                    const unsigned char *seq, long slen,
                    const long *align) {
  long nn = n;
  long prev = -1;
  if (n + slen > cap) return -2;
  for (long jj = 0; jj < slen; jj++) {
    long v = align[jj];
    unsigned char ch = seq[jj];
    if (v >= 0) {
      if (bases[v] == ch) {
        passing[v * n_seq + seq_no] = 1;
        if (ndeg[v] > 0 && preds[v * pmax] == prev) {
          weights[v * pmax] += 1; /* chain edge exists (fast path) */
        } else if (poa_merge_edge(prev, v, pmax, ndeg, preds, weights)) {
          return -2;
        }
        prev = v;
        continue;
      }
      /* mismatch: reuse an aligned variant with this base or create */
      int k = nvar[v];
      int *ring = vars + v * vmax;
      long cand = -1;
      for (int t = 0; t < k; t++) {
        if (bases[ring[t]] == ch) {
          cand = ring[t];
          break;
        }
      }
      if (cand < 0) {
        if (k + 1 > vmax) return -2;
        long w = nn++;
        bases[w] = ch;
        /* new node's ring = [v] + v's ring; register w in every
         * member's ring (rings of one column share size k) */
        int *wr = vars + w * vmax;
        wr[0] = (int)v;
        for (int t = 0; t < k; t++) {
          long r = ring[t];
          wr[t + 1] = (int)r;
          int kr = nvar[r];
          if (kr >= vmax) return -2;
          vars[r * vmax + kr] = (int)w;
          nvar[r] = kr + 1;
        }
        nvar[w] = k + 1;
        ring[k] = (int)w; /* after the copy loop: ring aliases v's row */
        nvar[v] = k + 1;
        v = w;
      } else {
        v = cand;
      }
    } else {
      v = nn++;
      bases[v] = ch;
    }
    passing[v * n_seq + seq_no] = 1;
    if (poa_merge_edge(prev, v, pmax, ndeg, preds, weights)) return -2;
    prev = v;
  }
  return nn - n;
}
