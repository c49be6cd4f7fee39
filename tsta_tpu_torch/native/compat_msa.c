/* Bit-exact CPU engine for TSTA-style progressive POA multiple alignment.
 *
 * This is the "compat" engine of TSTA-TPU: it reproduces, value for value,
 * the observable semantics of the reference's striped int8 difference-method
 * POA kernel and its graph machinery (reference: msa/c-t-simd.c,
 * msa/topo.c, msa/result.c, msa/msa.c), so that golden outputs match the
 * reference byte for byte.  It is a fresh implementation: plain-C lane
 * loops instead of SSE/AVX intrinsics, one arena-free graph, no threads
 * (tiles are computed in dependency order; the reference's anti-diagonal
 * thread-pool schedule computes identical values).
 *
 * Faithfully mirrored behaviors (see SURVEY.md section 2.1), including
 * ones that only make sense as bit-compatibility:
 *  - saturating int8 arithmetic with the two-level carry ladder (vc1/vc2,
 *    top = 127) for differences beyond the int8 range
 *    (c-t-simd.c:384-405);
 *  - the entry-column clamp v0 <= Logo = 100 with carries
 *    (c-t-simd.c:190-261);
 *  - the heuristic v > Logo1 = 60 => candidate replaced by ogap
 *    (c-t-simd.c:371-372, 475-476);
 *  - the lazy-F cross-lane fix-up clamped at 125 whose loop stops one
 *    lane short (x < B-1; c-t-simd.c:412);
 *  - 42-base traceback encoding source = 42*type + pred_index and signed
 *    open/extend esource/fsource (c-t-simd.c:451-456, 485-567);
 *  - 'N' columns forced to contribute 0 *after* max selection but the
 *    blended value participating in trace-plane equality tests
 *    (c-t-simd.c:481-505);
 *  - the init-node boundary poke keyed on tile diagonal 0 rather than
 *    column block 0 (c-t-simd.c:176-188);
 *  - wrapping int8 accumulation of per-lane row sums before widening
 *    (c-t-simd.c:482, 572-574).
 *
 * Striping geometry matches the SSE4.2 build that produced the golden
 * fixtures: B = 16 int8 lanes, W = bS stripes, L = B * W columns per
 * block.  (The reference's outputs were verified lane-width independent:
 * SSE4.2 and AVX512 builds emit byte-identical files.)
 */

#include <limits.h>
#ifdef _OPENMP
#include <omp.h>
#endif
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define BB 16 /* int8 lanes per stripe vector (SSE4.2 geometry) */

/* ------------------------------------------------------------------ */
/* Lane-vector helpers: BB bytes, signed/unsigned int8 element ops.    */
/* ------------------------------------------------------------------ */

typedef uint8_t vec[BB];

/* GCC generic vectors: each helper compiles to a handful of SIMD
 * instructions without hand-written intrinsics.  Saturation is done with
 * the standard overflow-mask trick; semantics are bit-identical to the
 * scalar definitions (fuzz-compared in tests). */
typedef uint8_t u8v __attribute__((vector_size(BB), aligned(1)));
typedef int8_t s8v __attribute__((vector_size(BB), aligned(1)));

static inline u8v vld(const uint8_t* p) {
  u8v v;
  memcpy(&v, p, BB);
  return v;
}
static inline void vst(uint8_t* d, u8v v) { memcpy(d, &v, BB); }
static inline s8v s_splat(int8_t x) {
  s8v v;
  for (int k = 0; k < BB; k++) v[k] = x;
  return v;
}

static inline void v_set1(uint8_t* d, int x) { memset(d, (uint8_t)x, BB); }
static inline void v_zero(uint8_t* d) { memset(d, 0, BB); }
static inline void v_copy(uint8_t* d, const uint8_t* a) { memcpy(d, a, BB); }

/* wrapping add/sub (two's complement, same bits signed or unsigned) */
static inline void v_add(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  vst(d, vld(a) + vld(b));
}
static inline void v_sub(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  vst(d, vld(a) - vld(b));
}
/* signed saturating add/sub: overflow where operand signs agree (add) /
 * differ (sub) and the result sign flips; saturate to sign-selected
 * extreme ((x >> 7) ^ 127 = -128 for negative x, 127 otherwise). */
static inline void v_adds(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  s8v x = (s8v)vld(a), y = (s8v)vld(b);
  s8v r = (s8v)((u8v)x + (u8v)y); /* wrap in unsigned: defined behavior */
  s8v ov = (~(x ^ y) & (x ^ r)) >> 7; /* -1 where overflow */
  s8v sat = (x >> 7) ^ s_splat(127);
  vst(d, (u8v)((r & ~ov) | (sat & ov)));
}
static inline void v_subs(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  s8v x = (s8v)vld(a), y = (s8v)vld(b);
  s8v r = (s8v)((u8v)x - (u8v)y); /* wrap in unsigned: defined behavior */
  s8v ov = ((x ^ y) & (x ^ r)) >> 7; /* -1 where overflow */
  s8v sat = (x >> 7) ^ s_splat(127);
  vst(d, (u8v)((r & ~ov) | (sat & ov)));
}
/* unsigned saturating sub */
static inline void v_subs_u(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  u8v x = vld(a), y = vld(b);
  u8v m = (u8v)(x > y);
  vst(d, (x - y) & m);
}
static inline void v_max(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  s8v x = (s8v)vld(a), y = (s8v)vld(b);
  s8v m = x > y; /* vector compare: -1/0 mask */
  vst(d, (u8v)((x & m) | (y & ~m)));
}
static inline void v_cmpeq(uint8_t* m, const uint8_t* a, const uint8_t* b) {
  vst(m, (u8v)(vld(a) == vld(b)));
}
static inline void v_cmpgt(uint8_t* m, const uint8_t* a, const uint8_t* b) {
  vst(m, (u8v)((s8v)vld(a) > (s8v)vld(b)));
}
static inline void v_and(uint8_t* d, const uint8_t* a, const uint8_t* b) {
  vst(d, vld(a) & vld(b));
}
/* d[k] = mask[k] ? b[k] : a[k]  (blendv semantics; mask bytes 0xFF/0) */
static inline void v_blend(uint8_t* d, const uint8_t* a, const uint8_t* b,
                           const uint8_t* m) {
  u8v mm = vld(m);
  vst(d, (vld(b) & mm) | (vld(a) & ~mm));
}
/* shift the whole vector up one byte (lane k <- lane k-1, lane 0 <- 0) */
static inline void v_shift1(uint8_t* d, const uint8_t* a) {
  for (int k = BB - 1; k >= 1; k--) d[k] = a[k - 1];
  d[0] = 0;
}

/* ------------------------------------------------------------------ */
/* POA graph                                                          */
/* ------------------------------------------------------------------ */

typedef struct Node Node;
struct Node {
  Node** pre;
  Node** next;
  int in, out;
  int in_cap, out_cap;
  int sub;           /* index in sorted order; -1 for virtual/new nodes */
  char base;
  uint8_t* hrow;     /* int8 H-difference row for current block (L bytes, */
  uint8_t* erow;     /*  or full seq length once promoted)                */
  int promoted;      /* reference node_logo==3: rows are full-length */
  int logo;          /* reference node_logo (0 normal, 1 printed-variant,
                        3 promoted, 4 modify mark, -1 init) */
  uint8_t* src;      /* traceback planes, one byte per new-seq column */
  uint8_t* esrc;
  uint8_t* fsrc;
  int* blockabs;     /* absolute score anchors per column block
                        (reference simple_sorce), maxtag+2 entries */
  int col0abs;       /* reference frist_col_sorce: absolute H at column -1 */
  int8_t* fseed;     /* per-pred F seed entering current block (f0) */
  int fseed_cap;
  int* eweight;      /* per-pred edge weight */
  uint8_t* passing_seq; /* bitmap over input sequences */
  Node** variants;   /* aligned mismatch variants in this column
                        (reference caps at 4 for A/C/G/T, poa.h:109;
                        grown dynamically here so arbitrary alphabets
                        cannot overflow the ring) */
  int n_variants;
  int var_cap;
  int last_score;    /* absolute score at (this sink, last real column) */
  int indeg_tmp;     /* toposort working counter */
  int pass_flag;     /* toposort 'passing' */
  int cons_score;    /* heaviest-bundle consensus score (node_sorce) */
  int cons_from;     /* consensus backpointer (node_sorce_source) */
  int cons_len;      /* consensus length (node_base_len) */
};

typedef struct {
  int len;
  int n_sinks;
  Node** sorted;
  Node** unsorted;
  int cap;
} Graph;

static Node* node_new(void) {
  Node* n = (Node*)calloc(1, sizeof(Node));
  n->sub = -1;
  return n;
}

static void pre_reserve(Node* n, int cap) {
  if (cap > n->in_cap) {
    n->in_cap = cap < 4 ? 4 : cap * 2;
    n->pre = (Node**)realloc(n->pre, n->in_cap * sizeof(Node*));
    n->eweight = (int*)realloc(n->eweight, n->in_cap * sizeof(int));
    n->fseed = (int8_t*)realloc(n->fseed, n->in_cap * sizeof(int8_t));
  }
}
static void var_reserve(Node* n, int cap) {
  if (cap > n->var_cap) {
    n->var_cap = cap < 4 ? 4 : cap * 2;
    n->variants = (Node**)realloc(n->variants, n->var_cap * sizeof(Node*));
  }
}
static void next_reserve(Node* n, int cap) {
  if (cap > n->out_cap) {
    n->out_cap = cap < 4 ? 4 : cap * 2;
    n->next = (Node**)realloc(n->next, n->out_cap * sizeof(Node*));
  }
}

/* ------------------------------------------------------------------ */
/* Engine state                                                       */
/* ------------------------------------------------------------------ */

typedef struct {
  int8_t M, X, E, O;
  int B, W, L;
  int n_seq;
  Graph g;
  /* per-round state */
  uint8_t* sseq;   /* striped, 'N'-padded new sequence */
  int len1;        /* padded new-seq length */
  int real1;       /* real new-seq length */
  int len2;        /* padded graph length */
  int maxtag, fmaxtag, lmaxtag;
  /* node registry for freeing */
  Node** all;
  int n_all, all_cap;
  /* virtual boundary nodes (sub == -1): their hrow[0]/erow[0] are poked
   * once per anti-diagonal (see round_dp) */
  Node* inits[2];
  int n_inits;
  int threads; /* wavefront thread cap; 0 = OpenMP default */
} Ctx;

static Node* reg_node(Ctx* c) {
  if (c->n_all == c->all_cap) {
    c->all_cap = c->all_cap ? c->all_cap * 2 : 1024;
    c->all = (Node**)realloc(c->all, c->all_cap * sizeof(Node*));
  }
  Node* n = node_new();
  c->all[c->n_all++] = n;
  return n;
}

/* striped column index within the padded new sequence
 * (reference NUM2, c-t-simd.c:14) */
static inline int stripe_idx(const Ctx* c, int j) {
  int L = c->L, W = c->W, B = c->B;
  return (j / L) * L + ((j % L) % W) * B + ((j % L) / W);
}

static inline int min_tag(const Ctx* c, int n) {
  /* reference nconvert: min(n, maxtag), 0 if maxtag == 0 */
  if (c->maxtag <= 0) return 0;
  return n >= c->maxtag ? c->maxtag : n;
}

/* ------------------------------------------------------------------ */
/* Graph construction from the first sequence (poa_build_init equiv)  */
/* ------------------------------------------------------------------ */

static void build_chain(Ctx* c, const char* s, int len) {
  Graph* g = &c->g;
  g->cap = len * 2 + 16;
  g->sorted = (Node**)malloc(g->cap * sizeof(Node*));
  g->unsorted = (Node**)malloc(g->cap * sizeof(Node*));
  g->len = len;
  g->n_sinks = 1;

  Node* init = reg_node(c);
  init->hrow = (uint8_t*)malloc(c->L);
  init->erow = (uint8_t*)malloc(c->L);
  memset(init->hrow, (uint8_t)c->E, c->L);
  memset(init->erow, (uint8_t)(c->E + c->E + c->O), c->L);
  init->blockabs = (int*)malloc(sizeof(int));
  init->blockabs[0] = 0;
  init->sub = -1;
  init->logo = -1;
  init->in = init->out = -1;
  init->base = 'N';
  c->inits[c->n_inits++] = init;

  Node* prev = NULL;
  for (int i = 0; i < len; i++) {
    Node* n = reg_node(c);
    n->hrow = (uint8_t*)malloc(c->L);
    n->erow = (uint8_t*)malloc(c->L);
    n->base = s[i];
    n->sub = i;
    n->passing_seq = (uint8_t*)calloc(c->n_seq, 1);
    n->passing_seq[0] = 1;
    pre_reserve(n, 1);
    if (i == 0) {
      n->pre[0] = init;
      n->in = 0; /* reference: head->in = 0 with pre[0] = init */
      n->eweight[0] = 0;
    } else {
      n->pre[0] = prev;
      n->in = 1;
      n->eweight[0] = 1;
      next_reserve(prev, prev->out + 1);
      prev->next[prev->out++] = n;
    }
    n->out = 0;
    g->sorted[i] = g->unsorted[i] = n;
    prev = n;
  }
}

/* ------------------------------------------------------------------ */
/* One (node-row x column-block) DP step: reference                   */
/* block_line_alignment (c-t-simd.c:165-599), transcribed op for op.  */
/* ------------------------------------------------------------------ */

typedef struct {
  /* scratch sized to max in-degree, reused across rows */
  uint8_t** f_lane;  /* [pred][B]: lane-entry/exit F (f_temp) */
  uint8_t** vcar1;   /* [pred][B]: lane carry 1 (VC1) */
  uint8_t** vcar2;   /* [pred][B]: lane carry 2 (VC2) */
  uint8_t** lsum;    /* [pred][B]: per-lane sums of pred H-diffs (r_s) */
  uint8_t* subsc;    /* [L]: substitution scores for this block (h_g) */
  int8_t* v0;        /* [pred]: entry-column v */
  int8_t* car1;      /* [pred]: entry carries (vc_1 / vc_2) */
  int8_t* car2;
  int* pd;           /* [pred]: byte offset into pred rows */
  int* te;           /* [pred]: scalar temps */
  int cap;
} Scratch;

static void scratch_ensure(Scratch* s, int cap, int L) {
  if (cap <= s->cap) return;
  s->f_lane = (uint8_t**)realloc(s->f_lane, cap * sizeof(uint8_t*));
  s->vcar1 = (uint8_t**)realloc(s->vcar1, cap * sizeof(uint8_t*));
  s->vcar2 = (uint8_t**)realloc(s->vcar2, cap * sizeof(uint8_t*));
  s->lsum = (uint8_t**)realloc(s->lsum, cap * sizeof(uint8_t*));
  for (int i = s->cap; i < cap; i++) {
    s->f_lane[i] = (uint8_t*)malloc(BB);
    s->vcar1[i] = (uint8_t*)malloc(BB);
    s->vcar2[i] = (uint8_t*)malloc(BB);
    s->lsum[i] = (uint8_t*)malloc(BB);
  }
  s->v0 = (int8_t*)realloc(s->v0, cap);
  s->car1 = (int8_t*)realloc(s->car1, cap);
  s->car2 = (int8_t*)realloc(s->car2, cap);
  s->pd = (int*)realloc(s->pd, cap * sizeof(int));
  s->te = (int*)realloc(s->te, cap * sizeof(int));
  if (!s->subsc) s->subsc = (uint8_t*)malloc(L);
  s->cap = cap;
}

#define MINVAL (-120) /* reference poa.h:8 */

/* Returns 0 on success, -1 if the node's in-degree exceeds RMAX (the
 * reference would corrupt memory here; we propagate an error instead of
 * exit(1) so the ctypes host process survives pathological inputs). */
static int row_block(Ctx* c, int blk_i, int blk_j, int blk_l, Node* row,
                     int nv, Scratch* sc) {
  const int B = c->B, W = c->W, L = c->L;
  const int8_t E = c->E, O = c->O, M = c->M, X = c->X;
  const int8_t logo = -6, Logo1 = 60;
  const int Logo = 100;
  const int col0 = nv * L; /* byte offset of this block's columns */

  int pre_num = row->in;
  if (pre_num == 0) {
    /* the virtual init node's boundary bytes were poked for this
     * diagonal by round_dp (reference pokes per tile, racily with
     * same values: c-t-simd.c:176-188) */
    pre_num = 1;
    row->col0abs = row->blockabs[0] = E + O;
  }
  scratch_ensure(sc, pre_num, L);
  int8_t* v0 = sc->v0;
  int8_t* car1 = sc->car1;
  int8_t* car2 = sc->car2;
  int* pd = sc->pd;
  int* te = sc->te;

  for (int i = 0; i < pre_num; i++)
    pd[i] = row->pre[i]->promoted ? col0 : 0;
  const int pc1 = row->promoted ? col0 : 0;

  const int first_col_tile =
      (blk_i <= c->lmaxtag && blk_l == blk_j - 1 && row->in != 0);
  if (first_col_tile) {
    /* recompute absolute boundary column score from preds
     * (c-t-simd.c:194-225) */
    int fc = row->pre[0]->col0abs + E;
    for (int i = 1; i < pre_num; i++)
      if (fc < row->pre[i]->col0abs + E) fc = row->pre[i]->col0abs + E;
    row->col0abs = row->blockabs[0] = fc;
    for (int i = 0; i < pre_num; i++) {
      te[i] = fc - row->pre[i]->col0abs;
      if (te[i] > Logo) {
        v0[i] = (int8_t)Logo;
        if (te[i] - Logo > 127) {
          car2[i] = (int8_t)((te[i] - Logo - 127) > 127 ? 127
                                                        : te[i] - Logo - 127);
          car1[i] = 127;
        } else {
          car2[i] = 0;
          car1[i] = (int8_t)(te[i] - Logo);
        }
      } else {
        v0[i] = (int8_t)te[i];
        car2[i] = 0;
        car1[i] = 0;
      }
      sc->vcar2[i][0] = (uint8_t)car2[i];
      sc->vcar1[i][0] = (uint8_t)car1[i];
    }
  } else {
    if (row->pre[0]->sub == -1) {
      /* source-less row: entry relative to the virtual boundary row
       * H(-1,j) = O + (j+1)E (c-t-simd.c:228-233) */
      v0[0] = (int8_t)(row->blockabs[nv] - (nv * L * E + (nv > 0 ? O : 0)));
      car2[0] = car1[0] = 0;
      sc->vcar2[0][0] = sc->vcar1[0][0] = 0;
    } else {
      for (int i = 0; i < pre_num; i++) {
        te[i] = row->blockabs[nv] - row->pre[i]->blockabs[nv];
        if (te[i] > Logo) {
          v0[i] = (int8_t)Logo;
          if (te[i] - Logo > 127) {
            car2[i] = (int8_t)((te[i] - Logo - 127) > 127
                                   ? 127
                                   : te[i] - Logo - 127);
            car1[i] = 127;
          } else {
            car2[i] = 0;
            car1[i] = (int8_t)(te[i] - Logo);
          }
        } else {
          v0[i] = (int8_t)te[i];
          car2[i] = 0;
          car1[i] = 0;
        }
        sc->vcar2[i][0] = (uint8_t)car2[i];
        sc->vcar1[i][0] = (uint8_t)car1[i];
      }
    }
  }

  if (blk_i <= c->lmaxtag && blk_l == blk_j - 1 && blk_i < c->len2 / L) {
    /* seed F at the block boundary (c-t-simd.c:263-270) */
    if (row->in == 0)
      row->fseed[0] = (int8_t)(v0[0] + E + O);
    else
      for (int i = 0; i < row->in; i++)
        row->fseed[i] = (int8_t)(v0[i] + E + O);
  }

  /* --- vector state ------------------------------------------------ */
  vec zero, top, smin, egap, ogap, matv, misv, basev, nv_, zlogo;
  v_zero(zero);
  v_set1(top, 127);
  v_set1(smin, MINVAL);
  v_set1(egap, E);
  v_set1(ogap, O + E);
  v_set1(matv, M);
  v_set1(misv, X);
  v_set1(basev, row->base);
  v_set1(nv_, 'N');
  v_set1(zlogo, Logo1);

  /* per-pred vector registers; TSTA_RMAX is overridable at compile time
   * so the error path is testable without a 64-in-degree corpus */
#ifndef TSTA_RMAX
#define TSTA_RMAX 64
#endif
  enum { RMAX = TSTA_RMAX };
  /* stack-allocated (13 * 64 * 16 B = 13 KB): row_block must be
   * reentrant for the OpenMP wavefront */
  vec t_[RMAX], e_[RMAX], f_[RMAX], v_[RMAX], vc1_[RMAX], vc2_[RMAX],
      vc0_[RMAX], y_[RMAX], dif_[RMAX], fv_[RMAX], eu_[RMAX], ev_[RMAX],
      q_[RMAX];
  if (pre_num > RMAX) {
    fprintf(stderr, "tsta compat: in-degree %d exceeds %d\n", pre_num, RMAX);
    return -1;
  }

  /* per-lane sums of pred H-diffs over this block (c-t-simd.c:278-287) */
  for (int i = 0; i < pre_num; i++) {
    vec s;
    v_zero(s);
    for (int x = 0; x < W; x++)
      v_add(s, s, row->pre[i]->hrow + pd[i] + x * B);
    v_copy(sc->lsum[i], s);
  }

  /* lane-entry v values (c-t-simd.c:289-343) */
  if (pre_num != 1) {
    for (int i = 0; i < pre_num; i++) sc->f_lane[i][0] = (uint8_t)v0[i];
    for (int x = 1; x < B; x++) {
      for (int i = 0; i < pre_num; i++)
        te[i] = te[i] - (int8_t)sc->lsum[i][x - 1] + W * E;
      int m1 = te[0];
      for (int i = 1; i < pre_num; i++)
        if (te[i] < m1) m1 = te[i];
      int m2 = logo - m1;
      for (int i = 0; i < pre_num; i++) {
        if (te[i] + m2 > Logo) {
          sc->f_lane[i][x] = (uint8_t)Logo;
          if (te[i] + m2 - Logo > 127) {
            sc->vcar2[i][x] = (uint8_t)((te[i] + m2 - Logo - 127) > 127
                                            ? 127
                                            : te[i] + m2 - Logo - 127);
            sc->vcar1[i][x] = 127;
          } else {
            sc->vcar2[i][x] = 0;
            sc->vcar1[i][x] = (uint8_t)(te[i] + m2 - Logo);
          }
        } else {
          sc->f_lane[i][x] = (uint8_t)(int8_t)(te[i] + m2);
          sc->vcar2[i][x] = 0;
          sc->vcar1[i][x] = 0;
        }
      }
    }
    for (int i = 0; i < pre_num; i++) v_copy(v_[i], sc->f_lane[i]);
  } else {
    for (int x = 0; x < B; x++) sc->vcar2[0][x] = sc->vcar1[0][x] = 0;
    car1[0] = car2[0] = 0;
    v_set1(v_[0], E);
    v_[0][0] = (uint8_t)v0[0];
  }

  for (int j = 0; j < pre_num; j++) {
    v_copy(vc2_[j], sc->vcar2[j]);
    v_copy(vc1_[j], sc->vcar1[j]);
    v_copy(f_[j], smin);
    f_[j][0] = (uint8_t)row->fseed[j];
  }

  /* --- pass 1: lazy-F forward sweep (c-t-simd.c:357-406) ----------- */
  for (int x = 0; x < W; x++) {
    vec h, s1, tmp, tmp1, tmp2, m4, m5;
    v_cmpeq(tmp, c->sseq + col0 + x * B, basev);
    v_blend(h, misv, matv, tmp);
    v_copy(sc->subsc + x * B, h);
    v_copy(s1, smin);
    for (int j = 0; j < pre_num; j++) {
      v_copy(t_[j], row->pre[j]->hrow + pd[j] + x * B);
      v_copy(e_[j], row->pre[j]->erow + pd[j] + x * B);
      v_max(tmp, f_[j], h);
      v_max(tmp, e_[j], tmp);
      v_subs(tmp, tmp, v_[j]);
      v_cmpgt(m4, v_[j], zlogo);
      v_blend(tmp, tmp, ogap, m4);
      v_max(s1, s1, tmp);
    }
    for (int j = 0; j < pre_num; j++) {
      v_sub(tmp, t_[j], egap);
      v_subs(tmp, f_[j], tmp);
      v_adds(tmp1, s1, ogap);
      v_subs(tmp1, tmp1, t_[j]);
      v_adds(tmp1, v_[j], tmp1);
      v_max(f_[j], tmp, tmp1);

      v_subs(tmp1, s1, t_[j]);
      v_adds(vc0_[j], v_[j], tmp1);

      v_cmpgt(m4, tmp1, zero);
      v_blend(tmp1, zero, tmp1, m4);
      v_subs(tmp2, top, v_[j]);
      v_subs_u(y_[j], tmp1, tmp2);

      v_adds(v_[j], vc0_[j], vc1_[j]);

      v_cmpeq(m5, vc1_[j], zero);
      v_subs_u(tmp2, top, vc0_[j]);
      v_blend(dif_[j], tmp2, zero, m5);

      v_copy(tmp2, vc1_[j]);
      v_subs_u(vc1_[j], vc1_[j], dif_[j]);
      v_adds(vc1_[j], vc1_[j], vc2_[j]);
      v_subs_u(tmp2, vc1_[j], tmp2);
      v_subs_u(vc2_[j], vc2_[j], dif_[j]);
      v_adds(vc2_[j], vc2_[j], y_[j]);
      v_subs_u(vc2_[j], vc2_[j], tmp2);
    }
  }

  /* --- cross-lane lazy-F fix-up (c-t-simd.c:408-448) --------------- */
  for (int j = 0; j < pre_num; j++) {
    v_copy(sc->f_lane[j], f_[j]);
    te[j] = (int8_t)sc->f_lane[j][0];
    for (int x = 1; x < B - 1; x++) { /* note: stops one lane short */
      te[j] = te[j] - (int8_t)sc->lsum[j][x] + W * E;
      int cur = (int8_t)sc->f_lane[j][x];
      if (te[j] > cur && te[j] > 125) {
        sc->f_lane[j][x] = 125;
      } else if (te[j] > cur && te[j] <= 125) {
        sc->f_lane[j][x] = (uint8_t)(int8_t)te[j];
      } else if (te[j] <= cur && cur > 125) {
        te[j] = cur;
        sc->f_lane[j][x] = 125;
      } else {
        te[j] = cur;
      }
    }
    vec tmp1;
    v_copy(f_[j], sc->f_lane[j]);
    v_subs(tmp1, f_[j], egap);
    v_shift1(f_[j], f_[j]);
    f_[j][0] = (uint8_t)row->fseed[j];

    v_max(vc0_[j], tmp1, v_[j]);
    v_shift1(vc0_[j], vc0_[j]);
    vc0_[j][0] = (uint8_t)v0[j];

    v_shift1(vc1_[j], vc1_[j]);
    vc1_[j][0] = (uint8_t)car1[j];
    v_adds(v_[j], vc0_[j], vc1_[j]);

    v_shift1(vc2_[j], vc2_[j]);
    vc2_[j][0] = (uint8_t)car2[j];
  }

  /* --- pass 2: final scores + traceback planes (c-t-simd.c:450-569) */
  vec rowsum;
  v_zero(rowsum);
  vec c42, c84, c126, c1, c43, c2;
  v_set1(c42, 42);
  v_set1(c84, 84);
  v_set1(c126, 126);
  v_set1(c1, 1);
  v_set1(c43, 43);
  v_set1(c2, 2);

  for (int x = 0; x < W; x++) {
    vec sn, sm, sx, h, maxv, eumax, tmp, tmp1, tmp2, m, m1, m2, m3, m4, m5;
    v_cmpeq(sn, c->sseq + col0 + x * B, nv_);
    v_copy(h, sc->subsc + x * B);
    v_cmpeq(sm, matv, h);
    v_cmpeq(sx, misv, h);
    v_copy(maxv, smin);
    v_copy(eumax, smin);
    for (int j = 0; j < pre_num; j++) {
      v_copy(t_[j], row->pre[j]->hrow + pd[j] + x * B);
      v_copy(e_[j], row->pre[j]->erow + pd[j] + x * B);
      v_subs(fv_[j], f_[j], v_[j]);
      v_subs(eu_[j], e_[j], v_[j]);
      v_subs(q_[j], h, v_[j]);
      v_max(tmp, fv_[j], eu_[j]);
      v_max(tmp, tmp, q_[j]);
      v_cmpgt(m4, v_[j], zlogo);
      v_blend(tmp, tmp, ogap, m4);
      v_max(maxv, maxv, tmp);
      v_subs(ev_[j], e_[j], t_[j]);
      v_max(eumax, eumax, eu_[j]);
    }
    v_blend(maxv, maxv, zero, sn); /* 'N' columns contribute 0 */
    v_add(rowsum, rowsum, maxv);   /* wrapping int8 accumulation */

    /* source plane: priority F-gap < E-gap < mismatch < match, smaller
     * pred index wins (descending loops, last blend wins) */
    vec src, srcnum;
    v_copy(src, c126);
    v_zero(srcnum);
    for (int j = pre_num - 1; j >= 0; j--) {
      v_cmpeq(m, maxv, eu_[j]);
      v_blend(src, src, zero, m);
      vec jj;
      v_set1(jj, j);
      v_blend(srcnum, srcnum, jj, m);
    }
    for (int j = pre_num - 1; j >= 0; j--) {
      v_cmpeq(m, maxv, q_[j]);
      v_and(m, m, sx);
      v_blend(src, src, c84, m);
      vec jj;
      v_set1(jj, j);
      v_blend(srcnum, srcnum, jj, m);
    }
    for (int j = pre_num - 1; j >= 0; j--) {
      v_cmpeq(m, maxv, q_[j]);
      v_and(m, m, sm);
      v_blend(src, src, c42, m);
      vec jj;
      v_set1(jj, j);
      v_blend(srcnum, srcnum, jj, m);
    }
    v_add(src, src, srcnum);
    v_copy(row->src + col0 + x * B, src);
    v_copy(row->hrow + pc1 + x * B, maxv);

    /* esource / fsource planes + f/e state advance */
    vec esrc, fsrc, esnum, emax;
    v_set1(esrc, 1);
    v_set1(fsrc, 1);
    v_zero(esnum);
    v_adds(tmp, maxv, ogap); /* open candidate */
    v_copy(emax, smin);
    memset(m1, 0, BB);
    for (int j = pre_num - 1; j >= 0; j--) {
      vec s1v;
      v_adds(f_[j], f_[j], egap);
      v_adds(s1v, tmp, v_[j]);
      v_cmpeq(m1, f_[j], s1v);
      v_max(f_[j], f_[j], s1v);
      v_subs(f_[j], f_[j], t_[j]);
      v_cmpeq(m, fv_[j], ogap);
      v_blend(fsrc, fsrc, c2, m);

      v_adds(e_[j], e_[j], egap);
      v_subs(e_[j], e_[j], v_[j]);
      v_cmpeq(m2, tmp, e_[j]);
      v_max(tmp1, tmp, e_[j]);
      v_max(emax, emax, tmp1);

      v_cmpeq(m3, eu_[j], eumax);
      vec jj;
      v_set1(jj, j);
      v_blend(esnum, esnum, jj, m3);
      v_cmpeq(m, ev_[j], ogap);
      v_blend(tmp1, c1, c43, m);
      v_add(tmp1, tmp1, esnum);
      v_blend(esrc, esrc, tmp1, m3);
      v_sub(tmp1, zero, esrc);
      v_and(m, m3, m2);
      v_blend(esrc, esrc, tmp1, m);

      v_subs(tmp1, maxv, t_[j]);
      v_adds(vc0_[j], v_[j], tmp1);

      v_cmpgt(m4, tmp1, zero);
      v_blend(tmp1, zero, tmp1, m4);
      v_subs(tmp2, top, v_[j]);
      v_subs_u(y_[j], tmp1, tmp2);

      v_adds(v_[j], vc0_[j], vc1_[j]);

      v_cmpeq(m5, vc1_[j], zero);
      v_subs_u(tmp2, top, vc0_[j]);
      v_blend(dif_[j], tmp2, zero, m5);

      v_copy(tmp2, vc1_[j]);
      v_subs_u(vc1_[j], vc1_[j], dif_[j]);
      v_adds(vc1_[j], vc1_[j], vc2_[j]);
      v_subs_u(tmp2, vc1_[j], tmp2);
      v_subs_u(vc2_[j], vc2_[j], dif_[j]);
      v_adds(vc2_[j], vc2_[j], y_[j]);
      v_subs_u(vc2_[j], vc2_[j], tmp2);
    }
    v_sub(tmp1, zero, fsrc);
    v_blend(fsrc, fsrc, tmp1, m1); /* m1 left from pred 0's iteration */
    v_copy(row->fsrc + col0 + x * B, fsrc);
    v_copy(row->esrc + col0 + x * B, esrc);
    v_copy(row->erow + pc1 + x * B, emax);
  }

  for (int j = 0; j < pre_num; j++)
    row->fseed[j] = (int8_t)f_[j][B - 1];

  /* widen the wrapped int8 lane sums and fold into the block anchor
   * (c-t-simd.c:572-575) */
  int reduce = 0;
  for (int k = 0; k < BB; k++) reduce += (int8_t)rowsum[k];
  row->blockabs[nv + 1] = row->blockabs[nv] + reduce;

  if (row->out == 0 && blk_i >= c->maxtag && blk_l == 0)
    row->last_score = row->blockabs[nv + 1];

  /* promote rows whose successor lives in a later block
   * (c-t-simd.c:580-598) */
  int kk = (row->sub / L + 1) * L;
  for (int i = 0; i < row->out; i++) {
    if (row->next[i]->sub >= kk && !row->promoted) {
      uint8_t* nh = (uint8_t*)malloc(c->len1);
      memcpy(nh, row->hrow, L);
      free(row->hrow);
      row->hrow = nh;
      uint8_t* ne = (uint8_t*)malloc(c->len1);
      memcpy(ne, row->erow, L);
      free(row->erow);
      row->erow = ne;
      row->promoted = 1;
      row->logo = 3;
    }
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* One alignment round: stripe-encode, wavefront DP, fuse             */
/* (reference control(), c-t-simd.c:979-1049)                         */
/* ------------------------------------------------------------------ */

static void stripe_encode(Ctx* c, const char* a, int alen) {
  int L = c->L;
  c->real1 = alen;
  c->len1 = (alen % L) ? alen + (L - alen % L) : alen;
  free(c->sseq);
  char* lin = (char*)malloc(c->len1 + 1);
  memset(lin, 'N', c->len1 + 1);
  memcpy(lin, a, alen);
  c->sseq = (uint8_t*)malloc(c->len1 + 1);
  for (int i = 0; i < c->len1; i++)
    c->sseq[i] = (uint8_t)lin[i / L * L + ((i % L) % c->B) * c->W +
                              ((i % L) / c->B)];
  c->sseq[c->len1] = 0;
  free(lin);
}

/* Returns 0 on success, -1 if any row_block hit the RMAX limit. */
static int round_dp(Ctx* c) {
  Graph* g = &c->g;
  int L = c->L;
  c->len2 = (g->len % L) ? g->len + (L - g->len % L) : g->len;
  int tsl = (c->len1 + c->len2) / L - 1;
  if (c->len1 >= c->len2) {
    c->fmaxtag = c->len2 / L - 1;
    c->lmaxtag = c->len1 / L - 1;
  } else {
    c->fmaxtag = c->len1 / L - 1;
    c->lmaxtag = c->len2 / L - 1;
  }
  c->maxtag = c->len1 / L - 1;

  /* (re)allocate traceback planes + block anchors per node.  Promotion
   * state resets every round: the reference's toposort zeroes node_logo
   * for every node (topo.c:10,182), so logo==3 never survives into the
   * next round -- a stale flag here would index buffers sized for the
   * previous round's (possibly shorter) padded read length. */
  for (int i = 0; i < g->len; i++) {
    Node* n = g->sorted[i];
    n->promoted = 0;
    n->logo = 0;
    free(n->src);
    free(n->esrc);
    free(n->fsrc);
    free(n->blockabs);
    n->src = (uint8_t*)malloc(c->len1);
    n->esrc = (uint8_t*)malloc(c->len1);
    n->fsrc = (uint8_t*)malloc(c->len1);
    n->blockabs = (int*)malloc((c->maxtag + 2) * sizeof(int));
  }

  /* anti-diagonal tile wavefront: tiles of one diagonal touch disjoint
   * row-blocks, so they run in parallel (the reference's thread-pool
   * axis, c-t-simd.c:1019-1043) and compute identical values in any
   * order.  The only shared write is the in==0 boundary poke
   * (c-t-simd.c:176-188), where every tile of a diagonal stores the
   * same bytes -- benign, as in the reference.  Each thread gets its
   * own scratch. */
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = c->threads > 0 ? c->threads : omp_get_max_threads();
  if (nthreads > 16) nthreads = 16;
  if (nthreads < 1) nthreads = 1;
#endif
  Scratch* pool = (Scratch*)calloc(nthreads, sizeof(Scratch));
  int err = 0; /* stores are atomic (threads may race each other); the
                * outer-loop read happens after the parallel region's
                * implicit barrier, so it never races the writes */
  int j = 0;
  for (int i = 0; i < tsl && !err; i++) {
    if (i <= c->fmaxtag)
      j++;
    else if (i <= c->lmaxtag)
      ;
    else
      j--;
    /* boundary poke for source rows, hoisted out of the parallel loop
     * (the value depends only on the diagonal index i) */
    for (int t = 0; t < c->n_inits; t++) {
      Node* ini = c->inits[t];
      if (i == 0) {
        ini->hrow[0] = (uint8_t)(int8_t)(c->O + c->E);
        ini->erow[0] = (uint8_t)(int8_t)(2 * (c->O + c->E));
      } else {
        ini->hrow[0] = (uint8_t)c->E;
        ini->erow[0] = (uint8_t)(int8_t)(c->E + c->O + c->E);
      }
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) num_threads(nthreads)
#endif
    for (int l = 0; l < j; l++) {
      int tid = 0;
#ifdef _OPENMP
      tid = omp_get_thread_num();
#endif
      int nv = min_tag(c, i) - l;
      int a1 = (((i - c->maxtag) > 0 ? i - c->maxtag : 0) + l) * L;
      for (int r = 0; r < L; r++) {
        int a2 = a1 + r;
        if (a2 >= g->len) break;
        if (row_block(c, i, j, l, g->sorted[a2], nv, &pool[tid]) != 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
          err = 1;
          break;
        }
      }
    }
  }
  for (int t = 0; t < nthreads; t++) {
    Scratch* s = &pool[t];
    for (int k = 0; k < s->cap; k++) {
      free(s->f_lane[k]);
      free(s->vcar1[k]);
      free(s->vcar2[k]);
      free(s->lsum[k]);
    }
    free(s->f_lane); free(s->vcar1); free(s->vcar2); free(s->lsum);
    free(s->subsc); free(s->v0); free(s->car1); free(s->car2);
    free(s->pd); free(s->te);
  }
  free(pool);
  return err ? -1 : 0;
}

/* ------------------------------------------------------------------ */
/* Graph fusion: walk the traceback of the best sink and merge the    */
/* new sequence into the graph (reference node_fuse,                  */
/* c-t-simd.c:659-977).                                               */
/* ------------------------------------------------------------------ */

static int fuse_round(Ctx* c, const char* b, int len_b, int seq_no,
                      int* out_last_score) {
  Graph* g = &c->g;
  int added = 0;

  Node* init = reg_node(c); /* local virtual head for the new chain */
  init->sub = -1;
  init->in = -1;
  init->logo = -1;
  /* replaces the previous round-local init as a poke target; the global
   * chain-head init (inits[0]) stays */
  c->inits[1] = init;
  c->n_inits = 2;
  /* boundary difference rows, poked per diagonal by round_dp
   * (c-t-simd.c:669-672) */
  init->hrow = (uint8_t*)malloc(c->L);
  init->erow = (uint8_t*)malloc(c->L);
  memset(init->hrow, (uint8_t)c->E, c->L);
  memset(init->erow, (uint8_t)(c->E + c->E + c->O), c->L);
  init->blockabs = (int*)malloc(sizeof(int));
  init->blockabs[0] = 0;

  if (g->len + len_b > g->cap) {
    g->cap = (g->len + len_b) * 2;
    g->unsorted = (Node**)realloc(g->unsorted, g->cap * sizeof(Node*));
    g->sorted = (Node**)realloc(g->sorted, g->cap * sizeof(Node*));
  }

  /* linear chain of the new sequence */
  Node** chain = (Node**)malloc(len_b * sizeof(Node*));
  for (int i = 0; i < len_b; i++) {
    Node* n = reg_node(c);
    n->base = b[i];
    n->sub = -1;
    pre_reserve(n, 1);
    next_reserve(n, 1);
    if (i == 0) {
      n->pre[0] = init;
      n->in = 0;
    } else {
      n->pre[0] = chain[i - 1];
      chain[i - 1]->next[0] = n;
      n->in = 1;
    }
    n->out = 1;
    chain[i] = n;
  }
  chain[len_b - 1]->out = 0;

  /* pick the best-scoring sink among the last n_sinks sinks
   * (ties: the later-scanned = smaller index wins; c-t-simd.c:733-750) */
  int gnode = g->len - 1;   /* topo index of the graph node being visited */
  int bcol = len_b - 1;     /* new-seq column being consumed */
  int best_score = INT_MIN, sinks_seen = 0;
  for (int i = g->len - 1; i > 0; i--) {
    if (g->sorted[i]->out == 0) {
      if (best_score <= g->sorted[i]->last_score) {
        best_score = g->sorted[i]->last_score;
        gnode = g->sorted[i]->sub;
      }
      sinks_seen++;
    }
    if (sinks_seen >= g->n_sinks) break;
  }
  *out_last_score = best_score;

  /* What the PREVIOUS iteration did to the column to our right.  The
   * walk wires each fused column to its right neighbour, and how (new
   * edge vs reuse) depends on whether the right column ended up on a
   * fresh chain node or on an existing graph node:
   *   PREV_INSERT       inserted the chain node as-is (gap in graph)
   *   PREV_MATCH        merged into an existing node (exact base)
   *   PREV_VAR_NEW      created a new aligned-variant node
   *   PREV_UP           vertical move -- no column consumed
   *   PREV_VAR_EDGE     reused a variant, adding a new pred edge
   *   PREV_VAR_BUMP     reused a variant, bumping an existing edge
   * After PREV_MATCH/PREV_VAR_BUMP the right column already holds its
   * own wiring to this column's eventual node, so the current fuse must
   * NOT add a duplicate successor edge.  (The reference keeps this
   * machine in an undocumented int; semantics recovered by tracing
   * c-t-simd.c:753-956 against its golden outputs.) */
  enum { PREV_INSERT = 0, PREV_MATCH = 1, PREV_VAR_NEW = 2,
         PREV_UP = 3, PREV_VAR_EDGE = 4, PREV_VAR_BUMP = 5 };
  int prev = PREV_INSERT;

#define SRC(nd, col) ((int8_t)(nd)->src[stripe_idx(c, col)])
#define ESRC(nd, col) ((int8_t)(nd)->esrc[stripe_idx(c, col)])
#define FSRC(nd, col) ((int8_t)(nd)->fsrc[stripe_idx(c, col)])

  while (gnode != -1 && bcol != -1) {
    Node* cur = g->sorted[gnode];
    int code = SRC(cur, bcol);
    int type = code / 42, pidx = code % 42;
    if (type == 3) {
      /* insertion: new-seq base consumed against a gap -> new node */
      prev = PREV_INSERT;
      Node* n = chain[bcol];
      n->hrow = (uint8_t*)malloc(c->L);
      n->erow = (uint8_t*)malloc(c->L);
      n->passing_seq = (uint8_t*)calloc(c->n_seq, 1);
      n->passing_seq[seq_no] = 1;
      n->eweight[0] = 1;
      g->unsorted[g->len + added] = n;
      n->sub = g->len + added;
      added++;
      /* horizontal gap-run propagation (c-t-simd.c:767-769) */
      int fb = FSRC(cur, bcol);
      if (stripe_idx(c, bcol - 1) > 0 &&
          ((fb == 1 || fb == -1) ||
           ((fb == 2 || fb == -2) && FSRC(cur, bcol - 1) < 0)))
        cur->src[stripe_idx(c, bcol - 1)] = 126;
      bcol--;
      continue;
    } else if (type == 0) {
      /* up move: graph base skipped; vertical gap-run propagation
       * rewrites the predecessor's move to continue the gap run,
       * preserving the pred index from its esrc code
       * (c-t-simd.c:773-784) */
      prev = PREV_UP;
      Node* pre = cur->pre[pidx];
      int eb = ESRC(cur, bcol);
      if (pre->sub > 0 &&
          ((eb <= 42 && eb >= -42) ||
           ((eb > 42 || eb < -42) && ESRC(g->sorted[pre->sub], bcol) < 0))) {
        int8_t prop_pidx = (int8_t)(ESRC(g->sorted[pre->sub], bcol) % 42);
        prop_pidx = (int8_t)((prop_pidx >= 0 ? prop_pidx : -prop_pidx) - 1);
        g->sorted[pre->sub]->src[stripe_idx(c, bcol)] = (uint8_t)prop_pidx;
      }
      gnode = pre->sub;
      continue;
    } else if (type == 1) {
      /* match: merge into existing node */
      Node* pre = cur->pre[pidx];
      if (bcol == len_b - 1) {
        if (SRC(g->sorted[pre->sub], bcol - 1) / 42 == 1) {
          cur->eweight[pidx]++;
        } else {
          pre_reserve(cur, cur->in + 1);
          cur->pre[cur->in] = chain[bcol - 1];
          cur->eweight[cur->in] = 1;
          cur->in++;
          chain[bcol - 1]->next[chain[bcol - 1]->out - 1] = cur;
          chain[bcol] = cur;
        }
      } else if (bcol == 0) {
        if (prev == PREV_MATCH || prev == PREV_VAR_BUMP) {
          chain[bcol] = cur;   /* right column already wired to us */
        } else {
          next_reserve(cur, cur->out + 1);
          cur->next[cur->out] = chain[bcol + 1];
          cur->out++;
          chain[bcol + 1]->pre[chain[bcol + 1]->in - 1] = cur;
        }
      } else {
        if (pre->sub != -1 && SRC(g->sorted[pre->sub], bcol - 1) / 42 == 1) {
          cur->eweight[pidx]++;
        } else {
          pre_reserve(cur, cur->in + 1);
          cur->pre[cur->in] = chain[bcol - 1];
          cur->eweight[cur->in] = 1;
          cur->in++;
          chain[bcol - 1]->next[chain[bcol - 1]->out - 1] = cur;
        }
        if (!(prev == PREV_MATCH || prev == PREV_VAR_BUMP)) {
          next_reserve(cur, cur->out + 1);
          cur->next[cur->out] = chain[bcol + 1];
          cur->out++;
          chain[bcol + 1]->pre[chain[bcol + 1]->in - 1] = cur;
        }
        chain[bcol] = cur;
      }
      prev = PREV_MATCH;
      cur->passing_seq[seq_no] = 1;
      gnode = pre->sub;
      bcol--;
    } else {
      /* mismatch: fuse into an aligned variant of this column, or
       * create one (c-t-simd.c:862-956).  var_state: 0 = no variant
       * with this base (create one), 1 = reused a variant and its
       * successor edge still needs wiring, 2 = reused a variant whose
       * successor edge already existed (weight bumped instead). */
      int var_state = 0;
      for (int s = 0; s < cur->n_variants; s++) {
        Node* var = cur->variants[s];
        if (chain[bcol]->base == var->base) {
          int bumped = 0;   /* pred edge weight-bumped (vs newly added) */
          if (bcol != 0) {
            Node* pre = cur->pre[pidx];
            if (pre->sub != -1 &&
                SRC(pre, bcol - 1) / 42 == 1) {
              for (int ss = 0; ss < var->in; ss++)
                if (var->pre[ss] == pre) {
                  var->eweight[ss]++;
                  bumped = 1;
                }
            }
            if (!bumped) {
              pre_reserve(var, var->in + 1);
              var->pre[var->in] = chain[bcol - 1];
              var->eweight[var->in] = 1;
              var->in++;
              chain[bcol - 1]->next[chain[bcol - 1]->out - 1] = var;
            }
          }
          var_state = 1;
          if (prev == PREV_MATCH || prev == PREV_VAR_EDGE) {
            for (int ss = 0; ss < chain[bcol + 1]->in; ss++)
              if (chain[bcol + 1]->pre[ss] == var) {
                var_state = 2;
                chain[bcol + 1]->eweight[ss]++;
                chain[bcol + 1]->in--;
              }
          }
          if (var_state == 1 && bcol != len_b - 1) {
            chain[bcol + 1]->pre[chain[bcol + 1]->in - 1] = var;
            next_reserve(var, var->out + 1);
            var->next[var->out] = chain[bcol + 1];
            var->out++;
          }
          var->passing_seq[seq_no] = 1;
          prev = bumped ? PREV_VAR_BUMP : PREV_VAR_EDGE;
          chain[bcol] = var;
        }
      }
      if (var_state == 0) {
        prev = PREV_VAR_NEW;
        Node* n = chain[bcol];
        n->hrow = (uint8_t*)malloc(c->L);
        n->erow = (uint8_t*)malloc(c->L);
        n->passing_seq = (uint8_t*)calloc(c->n_seq, 1);
        n->passing_seq[seq_no] = 1;
        n->eweight[0] = 1;
        g->unsorted[g->len + added] = n;
        n->sub = g->len + added;
        added++;
        /* cross-register in every variant's ring (cap 4: one per base) */
        var_reserve(cur, cur->n_variants + 1);
        cur->variants[cur->n_variants] = n;
        cur->n_variants++;
        n->n_variants = cur->n_variants;
        var_reserve(n, n->n_variants);
        n->variants[n->n_variants - 1] = cur;
        for (int s = 0; s < cur->n_variants - 1; s++) {
          Node* sib = cur->variants[s];
          sib->n_variants++;
          var_reserve(sib, cur->n_variants);
          sib->variants[cur->n_variants - 1] = n;
          n->variants[s] = sib;
        }
      }
      gnode = cur->pre[pidx]->sub;
      bcol--;
    }
  }

  /* remaining new-seq prefix becomes fresh nodes (c-t-simd.c:959-972) */
  while (bcol > -1) {
    Node* n = chain[bcol];
    n->hrow = (uint8_t*)malloc(c->L);
    n->erow = (uint8_t*)malloc(c->L);
    n->passing_seq = (uint8_t*)calloc(c->n_seq, 1);
    n->passing_seq[seq_no] = 1;
    n->eweight[0] = 1;
    g->unsorted[g->len + added] = n;
    added++;
    bcol--;
  }
  g->len += added;
  free(chain);
  return added;

#undef SRC
#undef ESRC
#undef FSRC
}

/* ------------------------------------------------------------------ */
/* Topological sorts (reference topo.c)                               */
/* ------------------------------------------------------------------ */

/* normal-round DFS (reference tp, topo.c:179-203) */
static int tp_visit(Graph* g, Node* p, int subs) {
  g->sorted[subs] = p;
  p->logo = 0;
  p->sub = subs;
  p->indeg_tmp = -1;
  subs++;
  for (int j = 0; j < p->out; j++) {
    Node* nx = p->next[j];
    if (nx->out == 0 && nx->pass_flag == 1 && nx->indeg_tmp - 1 == 0) {
      nx->indeg_tmp--;
      if (nx->indeg_tmp == 0) subs = tp_visit(g, nx, subs);
    }
  }
  for (int j = 0; j < p->out; j++) {
    Node* nx = p->next[j];
    nx->indeg_tmp--;
    if (nx->indeg_tmp == 0 && nx->pass_flag != 2) subs = tp_visit(g, nx, subs);
  }
  return subs;
}

static void toposort_normal(Graph* g) {
  for (int i = 0; i < g->len; i++) {
    Node* n = g->unsorted[i];
    n->indeg_tmp = n->in;
    n->pass_flag = 0;
    if (n->out == 0 && n->n_variants > 0) {
      int s1 = 0;
      for (int j = 0; j < n->n_variants; j++)
        if (n->variants[j]->out != 0) {
          n->pass_flag = 1;
          s1 = 1;
        }
      if (s1 != 1) n->pass_flag = 2;
    }
  }
  int subs = 0;
  while (subs < g->len)
    for (int i = 0; i < g->len; i++)
      if (g->unsorted[i]->indeg_tmp == 0) {
        subs = tp_visit(g, g->unsorted[i], subs);
        if (subs + g->n_sinks == g->len) {
          for (int k = 0; k < g->len; k++)
            if (g->unsorted[k]->indeg_tmp == 0)
              subs = tp_visit(g, g->unsorted[k], subs);
        }
        break;
      }
}

/* final-round DFS with consensus scoring (reference tp1, topo.c:7-64) */
static int tp1_visit(Graph* g, Node* p, int subs) {
  g->sorted[subs] = p;
  p->logo = 0;
  p->sub = subs;

  int max = 0, max_i = 0;
  for (int i = 0; i < p->in; i++) {
    if (p->pre[i]->cons_score >= 0) {
      if (max < p->eweight[i]) {
        max = p->eweight[i];
        max_i = i;
      } else if (max == p->eweight[i] &&
                 p->pre[max_i]->cons_score <= p->pre[i]->cons_score) {
        max = p->eweight[i];
        max_i = i;
      }
    }
  }
  p->cons_score = p->pre[max_i]->cons_score + max;
  p->cons_len = p->pre[max_i]->cons_len + 1;
  p->cons_from = p->pre[max_i]->sub;

  p->indeg_tmp = -1;
  subs++;
  for (int j = 0; j < p->out; j++) {
    Node* nx = p->next[j];
    nx->indeg_tmp--;
    if (nx->indeg_tmp == 0 && nx->n_variants == 0 && nx->pass_flag != 2) {
      subs = tp1_visit(g, nx, subs);
    } else if (nx->indeg_tmp == 0 && nx->n_variants > 0 &&
               nx->pass_flag != 2) {
      int cnt = 0;
      for (int s = 0; s < nx->n_variants; s++)
        if (nx->variants[s]->indeg_tmp == 0) cnt++;
      if (cnt == nx->n_variants) {
        subs = tp1_visit(g, nx, subs);
        for (int ss = 0; ss < nx->n_variants; ss++)
          if (nx->variants[ss]->indeg_tmp == 0)
            subs = tp1_visit(g, nx->variants[ss], subs);
      }
    }
  }
  return subs;
}

static void toposort_final(Graph* g) {
  for (int i = 0; i < g->len; i++) {
    Node* n = g->unsorted[i];
    n->indeg_tmp = n->in;
    n->pass_flag = 0;
    if (n->out == 0 && n->n_variants > 0) {
      int s1 = 0;
      for (int j = 0; j < n->n_variants; j++)
        if (n->variants[j]->out != 0) s1 = 1;
      if (s1 != 1) n->pass_flag = 2;
    }
  }
  int subs = 0;
  while (subs < g->len)
    for (int i = 0; i < g->len; i++) {
      Node* n = g->unsorted[i];
      if (n->indeg_tmp == 0) {
        if (n->n_variants == 0) {
          subs = tp1_visit(g, n, subs);
          break;
        } else {
          int cnt = 0;
          for (int j = 0; j < n->n_variants; j++)
            if (n->variants[j]->indeg_tmp == 0) cnt++;
          if (cnt == n->n_variants) {
            subs = tp1_visit(g, n, subs);
            for (int ss = 0; ss < n->n_variants; ss++)
              if (n->variants[ss]->indeg_tmp == 0)
                subs = tp1_visit(g, n->variants[ss], subs);
            break;
          }
        }
      }
    }
}

/* heaviest-bundle re-scoring until the global max sits on a sink
 * (reference modify, topo.c:119-177; recursion turned into a loop) */
static void consensus_modify(Graph* g) {
  for (;;) {
    int max = INT_MIN, max_i = 0;
    for (int i = 0; i < g->len; i++)
      if (max <= g->sorted[i]->cons_score) {
        max = g->sorted[i]->cons_score;
        max_i = g->sorted[i]->sub;
      }
    Node* top = g->sorted[max_i];
    if (top->out == 0) return;
    for (int i = 0; i < top->out; i++) {
      Node* nx = top->next[i];
      for (int j = 0; j < nx->in; j++)
        if (nx->pre[j]->cons_score < top->cons_score &&
            nx->pre[j]->cons_score > 0)
          nx->pre[j]->cons_score = -nx->pre[j]->cons_score;
      nx->logo = 4;
    }
    for (int i = max_i + 1; i < g->len; i++) {
      Node* n = g->sorted[i];
      if (n->cons_score >= 0 || n->logo == 4) {
        int Max = 0, Max_i = 0;
        for (int j = 0; j < n->in; j++) {
          if (n->pre[j]->cons_score >= 0) {
            if (Max < n->eweight[j]) {
              Max = n->eweight[j];
              Max_i = j;
            } else if (Max == n->eweight[j] &&
                       n->pre[Max_i]->cons_score <= n->pre[j]->cons_score) {
              Max = n->eweight[j];
              Max_i = j;
            }
          }
        }
        n->cons_score = n->pre[Max_i]->cons_score + Max;
        n->cons_len = n->pre[Max_i]->cons_len + 1;
        n->cons_from = n->pre[Max_i]->sub;
        n->logo = 0;
      }
    }
  }
}

static void t_sort(Graph* g, int final_round) {
  g->n_sinks = 0;
  for (int i = 0; i < g->len; i++)
    if (g->unsorted[i]->out == 0) g->n_sinks++;
  if (!final_round)
    toposort_normal(g);
  else {
    toposort_final(g);
    consensus_modify(g);
  }
  for (int i = 0; i < g->len; i++) g->unsorted[i] = g->sorted[i];
}

/* ------------------------------------------------------------------ */
/* Result emission (reference result.c)                               */
/* ------------------------------------------------------------------ */

typedef struct {
  int rows;
  int cols;
  char** msa;        /* rows x (cols+1) aligned strings */
  char* consensus;
  int rounds;
  int* last_scores;  /* per round */
  int* graph_len;    /* per round, after fusion */
  int* add_len;      /* per round */
} MsaResult;

static void emit_result(Ctx* c, MsaResult* out) {
  Graph* g = &c->g;
  int num = c->n_seq;
  char** r = (char**)malloc(num * sizeof(char*));
  for (int i = 0; i < num; i++) {
    r[i] = (char*)malloc(g->len + 1);
    memset(r[i], '-', g->len);
  }
  int len = 0;
  for (int i = 0; i < g->len; i++) {
    Node* n = g->sorted[i];
    if (n->logo == 0) {
      for (int j = 0; j < num; j++)
        if (n->passing_seq && n->passing_seq[j] == 1) r[j][len] = n->base;
      for (int l = 0; l < n->n_variants; l++) {
        Node* var = n->variants[l];
        for (int j = 0; j < num; j++)
          if (var->passing_seq && var->passing_seq[j] == 1)
            r[j][len] = var->base;
        var->logo = 1;
      }
      len++;
    }
  }
  for (int i = 0; i < num; i++) r[i][len] = '\0';
  out->rows = num;
  out->cols = len;
  out->msa = r;

  /* consensus: heaviest path from the best sink (reference printf_con) */
  int max = g->sorted[g->len - 1]->cons_score;
  int max_i = g->sorted[g->len - 1]->sub;
  int s = 0;
  for (int i = g->len - 2; i >= 0; i--) {
    if (g->sorted[i]->out == 0) {
      if (max <= g->sorted[i]->cons_score) {
        max = g->sorted[i]->cons_score;
        max_i = g->sorted[i]->sub;
      }
      s++;
    }
    if (s >= g->n_sinks) break;
  }
  int clen = g->sorted[max_i]->cons_len;
  char* cons = (char*)malloc(clen + 1);
  cons[clen] = '\0';
  for (int k = clen - 1; k > -1; k--) {
    cons[k] = g->sorted[max_i]->base;
    max_i = g->sorted[max_i]->cons_from;
  }
  out->consensus = cons;
}

/* ------------------------------------------------------------------ */
/* Public API (ctypes)                                                */
/* ------------------------------------------------------------------ */

int tsta_msa_run(const char** seqs, const int* lens, int n_seq, int m, int x,
                 int e, int o, int bS, int threads, MsaResult* out) {
  if (n_seq < 1 || bS < 1) return -1;
  Ctx c;
  memset(&c, 0, sizeof(c));
  c.M = (int8_t)m;
  c.X = (int8_t)x;
  c.E = (int8_t)e;
  c.O = (int8_t)o;
  c.B = BB;
  c.W = bS;
  c.L = BB * bS;
  c.n_seq = n_seq;
  c.threads = threads;

  build_chain(&c, seqs[0], lens[0]);

  int rounds = n_seq - 1 > 0 ? n_seq - 1 : 1;
  out->rounds = rounds;
  out->last_scores = (int*)calloc(rounds, sizeof(int));
  out->graph_len = (int*)calloc(rounds, sizeof(int));
  out->add_len = (int*)calloc(rounds, sizeof(int));

  /* progressive rounds (reference msa.c:130-141): reads 1..n-2 with
   * normal topo re-sort, final read with consensus scoring */
  int r = 0;
  int rc = 0;
  for (int i = 1; i < n_seq - 1; i++, r++) {
    stripe_encode(&c, seqs[i], lens[i]);
    if (round_dp(&c) != 0) {
      rc = -2; /* in-degree > RMAX: raise in Python, don't kill the host */
      goto teardown;
    }
    out->add_len[r] = fuse_round(&c, seqs[i], lens[i], i,
                                 &out->last_scores[r]);
    out->graph_len[r] = c.g.len;
    t_sort(&c.g, 0);
  }
  {
    int i = n_seq - 1 > 0 ? n_seq - 1 : 0;
    stripe_encode(&c, seqs[i], lens[i]);
    if (round_dp(&c) != 0) {
      rc = -2;
      goto teardown;
    }
    out->add_len[r] = fuse_round(&c, seqs[i], lens[i], i,
                                 &out->last_scores[r]);
    out->graph_len[r] = c.g.len;
    t_sort(&c.g, 1);
  }

  emit_result(&c, out);

teardown:
  for (int i = 0; i < c.n_all; i++) {
    Node* n = c.all[i];
    free(n->pre);
    free(n->next);
    free(n->hrow);
    free(n->erow);
    free(n->src);
    free(n->esrc);
    free(n->fsrc);
    free(n->blockabs);
    free(n->fseed);
    free(n->eweight);
    free(n->passing_seq);
    free(n->variants);
    free(n);
  }
  free(c.all);
  free(c.g.sorted);
  free(c.g.unsorted);
  free(c.sseq);
  return rc;
}

void tsta_msa_free(MsaResult* out) {
  if (!out) return;
  for (int i = 0; i < out->rows; i++) free(out->msa[i]);
  free(out->msa);
  free(out->consensus);
  free(out->last_scores);
  free(out->graph_len);
  free(out->add_len);
  memset(out, 0, sizeof(*out));
}
