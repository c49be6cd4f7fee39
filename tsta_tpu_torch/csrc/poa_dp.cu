// POA round DP (exact int32), one thread block per round.
//
// Replaces the TPU kernel tsta_tpu/ops/msa_pallas.py:_poa_kernel on its
// single-call path (launched through _poa_chunk_call/_poa_round_call with
// NW = 0 and no ablation).  One launch computes the DP of every topo-ordered
// graph node (rows) against the round's read (columns), the recurrence of
// tsta_tpu/ops/msa_native.py:
//   E(v,j) = max_p max(E(p,j) + e, H(p,j) + o + e)
//   C(v,j) = max(max_p H(p,j-1) + sub(v, a_j), E(v,j))
//   F(v,j) = o + j*e + max(H(v,-1) + e, max_{k<j} (C(v,k) - k*e))
//   H(v,j) = max(C(v,j), F(v,j))
// with the virtual row H(-1,j) = o + (j+1)e, E(-1,j) = NEG for source
// nodes (pred id 0).  The left boundary comes from the host's fills table,
// per node: [0] max over preds of H(p,-1), [1] its first-max pred index,
// [2] the F seed H(v,-1) + e, [3] the F(v,-1) fill of the f_ext test.
//
// Tie rules, bit for bit as the TPU kernel (msa_pallas.py:239-259, :309):
// the preds are reduced in table order with strict '>' updates (first max
// wins) for both H and the E candidate; e_ext is taken from the winning
// E pred; h_type is 0 if H == diag, else 1 if H == E, else 2; f_ext is
// F(v,j) == F(v,j-1) + e.  Per cell one 16-bit word
//   (h_type*4 + e_ext*2 + f_ext) | h_pred << 4 | e_pred << 10
// (pred indices in 6 bits: in-degree <= 64) into a row-major (N, n) plane,
// and per node the sink score H(v, n_real-1).
//
// Block layout: thread t owns the strip of S consecutive columns starting
// at t*S (S a multiple of 4), as in psa_dp.cu.  Per node:
//   pass 1  each thread reduces its strip's preds and takes the strip max
//           of C(k) - k*e;
//   scan    block-wide exclusive prefix max, seeded with fills[2]
//           (dp_common.cuh);
//   pass 2  the strip again: F, H, the words (four per 8-byte store) and
//           the node's H and E rows into its ring slot;
//   barrier then each strip's first word gets its f_ext from the left
//           neighbour's last F (shared memory) and is stored.
// Node state lives in a global ring of W slots (slot = buffer row id % W,
// W > the largest topo distance of an edge, from the host), so a pred's
// rows are complete and never overwritten while a successor reads them;
// the node's closing barrier orders its ring writes before the next
// node's reads.  The diagonal term at a strip's first column, max over the
// preds of H(p, t*S - 1), is read from the ring directly.  Ring layout:
// slot s holds H then E, each interleaved (column t*S+k at k*kThreads+t)
// so a warp's accesses coalesce.  Thread 0 compacts the next node's valid
// preds into shared memory before the closing barrier.
//
// What bounds it on the H100: the rows are a sequential chain (each node
// waits for its preds), so one block on one SM runs the whole round: per
// node three barriers and two passes over the ring rows of its preds (L1
// and L2 hits), ~30 integer operations per cell and pred, and 2 bytes of
// words per cell written as strided 8-byte stores.  Later work: several
// blocks per round over independent nodes or column tiles, DPX max-plus
// instructions, shared-memory frontiers for chain nodes.

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

__global__ void __launch_bounds__(kThreads)
poa_dp_kernel(const int32_t* __restrict__ predsT,
              const int32_t* __restrict__ pmaskT,
              const int32_t* __restrict__ bases,
              const int32_t* __restrict__ fills,
              const uint8_t* __restrict__ a, int N, int n_nodes, int n,
              int n_real, int W, int max_in, Params p,
              uint16_t* __restrict__ words, int32_t* __restrict__ scores,
              int32_t* ring) {
  __shared__ int s_warp[2 * kWarps];
  __shared__ Preds s_preds[2];
  __shared__ int s_edge[kThreads];

  const int t = threadIdx.x;
  const int S = strip_width(n);
  const int RS = S * kThreads;
  const int j0 = t * S;
  const int jend = min(j0 + S, n);  // jend <= j0: no columns

  if (t == 0 && n_nodes > 0) load_preds(s_preds[0], predsT, pmaskT, N,
                                        max_in, 0, W);
  __syncthreads();

  for (int i = 0; i < n_nodes; ++i) {
    const Preds& P = s_preds[i & 1];
    const int base = __ldg(bases + i);
    int32_t* own = ring + (size_t)((i + 1) % W) * 2 * RS;

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
            s < 0 ? p.o + j0 * p.e : ring[(size_t)s * 2 * RS + k];
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
      const Red r = reduce_preds(P, ring, RS, k, j, p);
      const int diag = hd + (__ldg(a + j) == base ? p.m : p.x);
      agg = max(agg, max(diag, r.eb) - j * p.e);
      hd = r.hb;
    }
    int run = tsta::block_excl_max<kThreads>(agg, __ldg(fills + 2 * N + i),
                                             s_warp);

    // pass 2: F, H, words, ring rows
    hd = hd0;
    int ad = ad0;
    int fl = 0;  // F(v, j-1)
    int f0 = 0;
    uint64_t acc = 0, first = 0;
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kThreads + t;
      const Red r = reduce_preds(P, ring, RS, k, j, p);
      const int diag = hd + (__ldg(a + j) == base ? p.m : p.x);
      const int c = max(diag, r.eb);
      const int f = p.o + j * p.e + run;
      const int h = max(c, f);
      run = max(run, c - j * p.e);
      own[k] = h;
      own[RS + k] = r.eb;
      if (j == n_real - 1) scores[i] = h;
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
          *reinterpret_cast<uint64_t*>(words + (size_t)i * n + j - 3) = acc;
        }
        acc = 0;
      }
      hd = r.hb;
      ad = r.ha;
      fl = f;
    }
    s_edge[t] = fl;  // F(v, jend - 1)
    if (t == 0 && i + 1 < n_nodes) {
      load_preds(s_preds[(i + 1) & 1], predsT, pmaskT, N, max_in, i + 1, W);
    }
    __syncthreads();
    if (jend > j0) {
      const int fleft = t == 0 ? __ldg(fills + 3 * N + i) : s_edge[t - 1];
      first |= (uint64_t)(f0 == fleft + p.e);
      *reinterpret_cast<uint64_t*>(words + (size_t)i * n + j0) = first;
    }
  }
}

}  // namespace

extern "C" int tsta_poa_dp_ring_words(int n, int W) {
  return 2 * W * strip_width(n) * kThreads;
}

// predsT, pmaskT: (max_in, N) int32 buffer row ids (0 = virtual) and
// validity; bases: (N,) int32; fills: (4, N) int32; a: (n,) uint8, n % 4
// == 0; words: (N, n) uint16, rows < n_nodes written; scores: (N,) int32,
// rows < n_nodes written; ring: tsta_poa_dp_ring_words(n, W) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int tsta_poa_dp(const void* predsT, const void* pmaskT,
                           const void* bases, const void* fills,
                           const void* a, int N, int n_nodes, int n,
                           int n_real, int W, int max_in, int M, int X,
                           int E, int O, void* words, void* scores,
                           void* ring, void* stream) {
  if (max_in > kMaxIn) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{M, X, E, O};
  poa_dp_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(predsT), static_cast<const int32_t*>(pmaskT),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(fills),
      static_cast<const uint8_t*>(a), N, n_nodes, n, n_real, W, max_in, p,
      static_cast<uint16_t*>(words), static_cast<int32_t*>(scores),
      static_cast<int32_t*>(ring));
  return static_cast<int>(cudaGetLastError());
}
