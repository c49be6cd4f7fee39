// POA round DP (exact int32), one thread block per launch.
//
// Replaces the TPU kernel tsta_tpu/ops/msa_pallas.py:_poa_kernel in its
// three uses (launched through _poa_chunk_call, :400):
//   single call   the whole round, words on (_poa_round_call, NW = 0);
//   forward chunk one node chunk of a chunked round (_round_chunked,
//                 :1366): ring carried in and out, column-window
//                 checkpoints on (NW > 0), no words (ablate="noword");
//   window remat  one (chunk, column window) cell of the chunked round's
//                 backward (:1445): the chunk's entry ring cut to the
//                 window, fills from the checkpoints, words on.
// One launch computes the DP of its topo-ordered graph nodes (rows)
// against the read's columns, the recurrence of
// tsta_tpu/ops/msa_native.py:
//   E(v,j) = max_p max(E(p,j) + e, H(p,j) + o + e)
//   C(v,j) = max(max_p H(p,j-1) + sub(v, a_j), E(v,j))
//   F(v,j) = o + j*e + max(H(v,-1) + e, max_{k<j} (C(v,k) - k*e))
//   H(v,j) = max(C(v,j), F(v,j))
// with the virtual row H(-1,j) = o + (j+1)e, E(-1,j) = NEG for source
// nodes (pred id 0).  The left boundary comes from the caller's fills
// table, per node: [0] max over preds of H(p, col0-1), [1] its first-max
// pred index, [2] the F running-max seed (H(v,-1) + e, or the
// checkpointed prefix q at col0-1), [3] the F(v, col0-1) fill of the
// f_ext test (NEG at column 0).
//
// Columns: the launch covers the n columns [col0, col0 + n) of the round.
// The arithmetic uses the global column col0 + j (virtual row, j*e in F
// and its running max, the sink column n_real-1); the words, the ring and
// the read are addressed by the local column j.  Rows: the launch covers
// the nodes [chunk_base, chunk_base + n_nodes) of the round; the pred
// table, bases, fills, words, scores and checkpoints are addressed by the
// local row i, the ring by the global buffer row id (chunk_base + i + 1).
//
// Tie rules, bit for bit as the TPU kernel (msa_pallas.py:239-259, :309):
// the preds are reduced in table order with strict '>' updates (first max
// wins) for both H and the E candidate; e_ext is taken from the winning
// E pred; h_type is 0 if H == diag, else 1 if H == E, else 2; f_ext is
// F(v,j) == F(v,j-1) + e.  Per cell one 16-bit word
//   (h_type*4 + e_ext*2 + f_ext) | h_pred << 4 | e_pred << 10
// (pred indices in 6 bits: in-degree <= 64) into a row-major (rows, n)
// plane, and per node the sink score H(v, n_real-1).
//
// Checkpoints (msa_pallas.py:337-369): with nwin > 0, after global column
// (w+1)*cw - 1 of each window w < nwin, the thread that owns that column
// writes H, the inclusive running max q = max(F prefix, C - j*e) and F
// into ckpt[i][w][0..2], an (rows, nwin, 3) int32 tensor.  A window
// remat starting at column col0 = w*cw takes its fills from them.
//
// Block layout: thread t owns the strip of S consecutive columns starting
// at t*S (S a multiple of 4), as in psa_dp.cu.  Per node:
//   pass 1  each thread reduces its strip's preds and takes the strip max
//           of C(k) - k*e;
//   scan    block-wide exclusive prefix max, seeded with fills[2]
//           (dp_common.cuh);
//   pass 2  the strip again: F, H, the words (four per 8-byte store), the
//           checkpoints and the node's H and E rows into its ring slot;
//   barrier then each strip's first word gets its f_ext from the left
//           neighbour's last F (shared memory) and is stored.
// Node state lives in a global ring of W slots (slot = buffer row id % W,
// W > the largest topo distance of an edge, from the host), so a pred's
// rows are complete and never overwritten while a successor reads them;
// the node's closing barrier orders its ring writes before the next
// node's reads.  A chunked round hands the ring from one launch to the
// next; the slots are indexed by global row, so a chunk's first nodes
// read their preds' rows from the previous chunk's launch.  The diagonal
// term at a strip's first column, max over the preds of H(p, t*S - 1), is
// read from the ring directly.  Ring layout: slot s holds H then E, each
// interleaved for the launch width (column t*S+k at k*kThreads+t) so a
// warp's accesses coalesce; a ring taken at one width is re-laid for
// another on the host side (msa_poa.ring_window).  Thread 0 compacts the
// next node's valid preds into shared memory before the closing barrier.
//
// What bounds it on the H100: the rows are a sequential chain (each node
// waits for its preds), so one block on one SM runs the launch: per node
// three barriers and two passes over the ring rows of its preds (L1 and
// L2 hits), ~30 integer operations per cell and pred, and 2 bytes of
// words per cell written as strided 8-byte stores (none in a forward
// chunk).  Later work: several blocks per round over independent nodes or
// column tiles, DPX max-plus instructions, shared-memory frontiers for
// chain nodes.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kNeg;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIn = 64;

__host__ __device__ inline int strip_width(int n) {
  int w = (n + kThreads - 1) / kThreads;
  return (w + 3) & ~3;
}

struct Params {
  int m, x, e, o;
};

// One node's valid predecessors in table order: ring slot (-1 for the
// virtual row) and index in the pred table (the traceback's pred field).
struct Preds {
  int slot[kMaxIn];
  int idx[kMaxIn];
  int deg;
};

__device__ void load_preds(Preds& P, const int32_t* __restrict__ predsT,
                           const int32_t* __restrict__ pmaskT, int N,
                           int max_in, int i, int W) {
  int d = 0;
  for (int kk = 0; kk < max_in; ++kk) {
    if (pmaskT[(size_t)kk * N + i] == 0) continue;
    const int r = predsT[(size_t)kk * N + i];
    P.slot[d] = r == 0 ? -1 : r % W;
    P.idx[d] = kk;
    ++d;
  }
  P.deg = d;
}

// The pred reduction at column j (ring index k): first-max H over the
// preds and its index; first-max E candidate, its index and whether it
// extends E.
struct Red {
  int hb, ha, eb, ea, ex;
};

__device__ __forceinline__ Red reduce_preds(const Preds& P,
                                            const int32_t* ring, int RS,
                                            int k, int j, const Params& p) {
  Red r{kNeg, 0, kNeg, 0, 0};
  for (int c = 0; c < P.deg; ++c) {
    const int s = P.slot[c];
    int hp, ep;
    if (s < 0) {
      hp = p.o + (j + 1) * p.e;
      ep = kNeg;
    } else {
      const int32_t* h = ring + (size_t)s * 2 * RS;
      hp = h[k];
      ep = h[RS + k];
    }
    if (hp > r.hb) {
      r.hb = hp;
      r.ha = P.idx[c];
    }
    const int ec = max(ep + p.e, hp + p.o + p.e);
    if (ec > r.eb) {
      r.eb = ec;
      r.ea = P.idx[c];
      r.ex = ep + p.e == ec;
    }
  }
  return r;
}

// Columns and rows of one launch (see the header): global column col0 + j,
// global row chunk_base + i; checkpoints every cw columns, nwin of them.
struct Span {
  int chunk_base, col0, nwin, cw;
};

template <bool kWords, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
poa_dp_kernel(const int32_t* __restrict__ predsT,
              const int32_t* __restrict__ pmaskT,
              const int32_t* __restrict__ bases,
              const int32_t* __restrict__ fills,
              const uint8_t* __restrict__ a, int N, int n_nodes, int n,
              int n_real, int W, int max_in, Params p, Span sp,
              uint16_t* __restrict__ words, int32_t* __restrict__ scores,
              int32_t* ring, int32_t* __restrict__ ckpt) {
  __shared__ int s_warp[2 * kWarps];
  __shared__ Preds s_preds[2];
  __shared__ int s_edge[kThreads];

  const int t = threadIdx.x;
  const int S = strip_width(n);
  const int RS = S * kThreads;
  const int j0 = t * S;
  const int jend = min(j0 + S, n);  // jend <= j0: no columns
  const int g0 = sp.col0 + j0;      // global column of j0

  if (t == 0 && n_nodes > 0) load_preds(s_preds[0], predsT, pmaskT, N,
                                        max_in, 0, W);
  __syncthreads();

  for (int i = 0; i < n_nodes; ++i) {
    const Preds& P = s_preds[i & 1];
    const int base = __ldg(bases + i);
    int32_t* own = ring + (size_t)((sp.chunk_base + i + 1) % W) * 2 * RS;

    // max over the preds of H(p, j0 - 1) and its first-max index
    int hd0 = kNeg, ad0 = 0;
    if (t == 0) {
      hd0 = __ldg(fills + i);
      ad0 = __ldg(fills + N + i);
    } else if (jend > j0) {
      const int k = (S - 1) * kThreads + (t - 1);
      for (int c = 0; c < P.deg; ++c) {
        const int s = P.slot[c];
        const int hp =
            s < 0 ? p.o + g0 * p.e : ring[(size_t)s * 2 * RS + k];
        if (hp > hd0) {
          hd0 = hp;
          ad0 = P.idx[c];
        }
      }
    }

    // pass 1: strip max of C(k) - k*e
    int agg = kNeg;
    int hd = hd0;
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kThreads + t;
      const int jg = sp.col0 + j;
      const Red r = reduce_preds(P, ring, RS, k, jg, p);
      const int diag = hd + (__ldg(a + j) == base ? p.m : p.x);
      agg = max(agg, max(diag, r.eb) - jg * p.e);
      hd = r.hb;
    }
    int run = tsta::block_excl_max<kThreads>(agg, __ldg(fills + 2 * N + i),
                                             s_warp);

    // pass 2: F, H, words, checkpoints, ring rows
    hd = hd0;
    int ad = ad0;
    int fl = 0;  // F(v, j-1)
    int f0 = 0;
    uint64_t acc = 0, first = 0;
    // the next checkpoint column at or after g0
    int nb = kCkpt ? (g0 / sp.cw + 1) * sp.cw - 1 : 0;
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kThreads + t;
      const int jg = sp.col0 + j;
      const Red r = reduce_preds(P, ring, RS, k, jg, p);
      const int diag = hd + (__ldg(a + j) == base ? p.m : p.x);
      const int c = max(diag, r.eb);
      const int f = p.o + jg * p.e + run;
      const int h = max(c, f);
      run = max(run, c - jg * p.e);
      own[k] = h;
      own[RS + k] = r.eb;
      if (jg == n_real - 1) scores[i] = h;
      if constexpr (kCkpt) {
        if (jg == nb) {
          const int w = nb / sp.cw;
          if (w < sp.nwin) {
            int32_t* ck = ckpt + ((size_t)i * sp.nwin + w) * 3;
            ck[0] = h;
            ck[1] = run;  // q: the running max including this column
            ck[2] = f;
          }
          nb += sp.cw;
        }
      }
      if constexpr (kWords) {
        const int htype = h == diag ? 0 : (h == r.eb ? 1 : 2);
        int w = (htype * 4 + r.ex * 2) | (ad << 4) | (r.ea << 10);
        if (j == j0) {
          f0 = f;  // its f_ext needs the neighbour's F(v, j0-1)
        } else {
          w |= f == fl + p.e;
        }
        const int q = (j - j0) & 3;
        acc |= (uint64_t)(uint16_t)w << (16 * q);
        if (q == 3) {
          if (j - j0 == 3) {
            first = acc;
          } else {
            *reinterpret_cast<uint64_t*>(words + (size_t)i * n + j - 3) =
                acc;
          }
          acc = 0;
        }
        ad = r.ha;
        fl = f;
      }
      hd = r.hb;
    }
    if constexpr (kWords) s_edge[t] = fl;  // F(v, jend - 1)
    if (t == 0 && i + 1 < n_nodes) {
      load_preds(s_preds[(i + 1) & 1], predsT, pmaskT, N, max_in, i + 1, W);
    }
    __syncthreads();
    if constexpr (kWords) {
      if (jend > j0) {
        const int fleft = t == 0 ? __ldg(fills + 3 * N + i) : s_edge[t - 1];
        first |= (uint64_t)(f0 == fleft + p.e);
        *reinterpret_cast<uint64_t*>(words + (size_t)i * n + j0) = first;
      }
    }
  }
}

}  // namespace

// predsT, pmaskT: (max_in, N) int32 buffer row ids (0 = virtual) and
// validity; bases: (N,) int32; fills: (4, N) int32; a: (n,) uint8, the
// read's columns [col0, col0 + n), n % 4 == 0; scores: (N,) int32, rows <
// n_nodes written where the launch holds column n_real - 1; ring: (W, 2,
// strip_width(n) * kThreads) int32, read and written in place.  words:
// (N, n) uint16 or null; ckpt: (N, nwin, 3) int32 or null (cw > 0, nwin
// windows of cw columns).  words and ckpt are not both given.  Returns
// cudaGetLastError() after the launch.
extern "C" int tsta_poa_dp(const void* predsT, const void* pmaskT,
                           const void* bases, const void* fills,
                           const void* a, int N, int n_nodes, int n,
                           int n_real, int W, int max_in, int M, int X,
                           int E, int O, int chunk_base, int col0, int nwin,
                           int cw, void* words, void* scores, void* ring,
                           void* ckpt, void* stream) {
  if (max_in > kMaxIn || (words && ckpt) || (ckpt && (nwin < 1 || cw < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{M, X, E, O};
  const Span sp{chunk_base, col0, nwin, cw};
  auto* pt = static_cast<const int32_t*>(predsT);
  auto* pm = static_cast<const int32_t*>(pmaskT);
  auto* bs = static_cast<const int32_t*>(bases);
  auto* fl = static_cast<const int32_t*>(fills);
  auto* rd = static_cast<const uint8_t*>(a);
  auto* wd = static_cast<uint16_t*>(words);
  auto* sc = static_cast<int32_t*>(scores);
  auto* rg = static_cast<int32_t*>(ring);
  auto* ck = static_cast<int32_t*>(ckpt);
  auto st = static_cast<cudaStream_t>(stream);
  if (words) {
    poa_dp_kernel<true, false><<<1, kThreads, 0, st>>>(
        pt, pm, bs, fl, rd, N, n_nodes, n, n_real, W, max_in, p, sp, wd, sc,
        rg, ck);
  } else if (ckpt) {
    poa_dp_kernel<false, true><<<1, kThreads, 0, st>>>(
        pt, pm, bs, fl, rd, N, n_nodes, n, n_real, W, max_in, p, sp, wd, sc,
        rg, ck);
  } else {
    poa_dp_kernel<false, false><<<1, kThreads, 0, st>>>(
        pt, pm, bs, fl, rd, N, n_nodes, n, n_real, W, max_in, p, sp, wd, sc,
        rg, ck);
  }
  return static_cast<int>(cudaGetLastError());
}
