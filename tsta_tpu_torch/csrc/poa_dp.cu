// POA round DP (exact int32), its columns cut into D shards on G <= D
// co-resident 256-thread blocks (a cooperative launch for G >= 2), one
// shard a block up to the card's resident limit, past it a block walks
// several in turn.
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
// and in a fourth, on the POA round of tsta_tpu/parallel/msa_longseq.py
// (:21 _round_dp_sharded, XLA, its columns over the mesh's seq axis):
//   wavefront cell one node chunk over one column window of the
//                 column-window wavefront (parallel/msa_longseq.py): the
//                 window's ring carried in and out, fills from the left
//                 window's checkpoints, words on, and the checkpoint at
//                 the window's last column on (nwin = 1, cw = its end).
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
// and its running max, the sink column n_real-1, the checkpoints); the
// words and the read are addressed by the local column j.  Rows: the
// launch covers the nodes [chunk_base, chunk_base + n_nodes) of the round;
// the pred table, bases, fills, words, scores and checkpoints are
// addressed by the local row i, the ring by the global buffer row id
// (chunk_base + i + 1).
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
// The wide form (in-degree 65 to 8,192; msa_native.round_dp_plain's
// 13-bit words, the JAX package's scan engine's rounds) writes one 32-bit
// word a cell,
//   (h_type*4 + e_ext*2 + f_ext) | h_pred << 4 | e_pred << 17,
// with the same arithmetic and tie rules.  Its preds come from a
// compacted list (CSR: per node the (buffer row id, table index) of each
// valid entry, in table order, built once a round on the host,
// msa_poa.pred_lists), so a node reads its preds, not max_in rows: at
// in-degree 1,000 the table is 1,024 rows, and most nodes of such a graph
// have one or two preds.  A node streams its list through the same
// 64-entry shared buffer in table-order passes, carrying the first-max
// reductions (hb, eb, pk) across passes, so ties and the shared memory
// stay as in the 16-bit form; a pass after the first costs two barriers.
// Its kernels are separate (poa_dp_wide_kernel, always built to walk its
// shards), so the 16-bit builds keep their code (their SASS compared with
// tools/poa_dp_ab.py).
//
// Checkpoints (msa_pallas.py:337-369): with nwin > 0, after global column
// (w+1)*cw - 1 of each window w < nwin, the thread that owns that column
// writes H, the inclusive running max q = max(F prefix, C - j*e) and F
// into ckpt[i][w][0..2], an (rows, nwin, 3) int32 tensor.  A window
// remat starting at column col0 = w*cw takes its fills from them.
//
// Plan (tsta_poa_dp_layout, from n alone; msa_poa.poa_plan is its twin):
// S columns per thread, a power of two from kMinS to kMaxS (the strip's
// state lives in registers, one build per S): the least with n <= 256 *
// S * kMaxShards; C = 256 * S columns per shard; D = ceil(n / C) shards,
// the last one possibly narrower (past kMaxShards only at S = kMaxS); T =
// kT = 16 nodes per packet (the fastest of 16, 32 and 64 at the main
// shapes: a taller packet adds D - 1 nodes of fill a node, a shorter one
// more waits).  At 196,608 columns: S = 8, C = 2,048, D = 96; at
// the 50 kbp round 2's 49,152: D = 24; at a 24,576-column window: D = 12.
// The grid: G = min(D, the card's co-resident limit) blocks (the
// wrapper's default; 132 at S = 32 on an H100 SXM, so G = D up to
// 1,081,344 columns), block g walking the shards g, g + G, g + 2G, ...
// in turn (a build of its own, kWalk, launched only when G < D).  The
// wrapper may force D (C = n / D rounded up to 4, S = C / 256 rounded up
// to a power of two, at least kMinS), T and G, for the tests and the
// smoke's sweeps; a G past the limit is refused by the cooperative
// launch itself (cudaErrorCooperativeLaunchTooLarge).
//
// Shard d covers the launch's columns [d*C, d*C + C_d); thread t the
// strip of S consecutive columns from d*C + t*S, whose read bytes it keeps
// in registers for the shard.  Per node, each shard runs the one-block
// body over its own columns:
//   preds   each thread reduces the node's preds over its strip and the
//           column left of it, preds outer: one pred's S + 1 H and S E
//           values are loads in flight together, and the reductions stay
//           in registers for both passes;
//   pass 1  the strip max of C(k) - k*e;
//   scan    block-wide exclusive prefix max (dp_common.cuh), seeded with
//           fills[2] on shard 0 and the packet's q on shard d >= 1;
//   pass 2  F, H, the words (four per 8-byte store), the checkpoints and
//           the node's H and E into its ring slot;
//   barrier then each strip's first word gets its f_ext from the left
//           neighbour's last F (shared memory; the packet's or fills[3]
//           for thread 0) and is stored.
// Warp 0 reads the next node's pred-table row (a lane per entry) when a
// node starts and compacts its valid preds into shared memory before the
// node's closing barrier.
//
// The ring.  Node state lives in a global ring of W slots (slot = buffer
// row id % W, W > the largest topo distance of an edge, from the host).
// Each H or E row is D * 256 * S ints: shard d's columns at [d*256*S,
// (d+1)*256*S), column d*C + t*S + k at offset k*256 + t, so a warp's
// accesses coalesce (msa_poa.ring_positions).  A chunked round hands the
// ring from one launch to the next (the same width each time: the plan is
// a function of n); the window remat's ring is re-laid for its width on
// the host side (msa_chunked.ring_window).
//
// Packets.  comm is (D, ceil(n_nodes / T), 4T) int32, one slot per block
// of T nodes; slot b of shard d holds, for node i = b*T + r, the four
// fills values of shard d+1's first column: [r] the max over preds of
// H(p, last column) and [T + r] its first-max index (the last column's
// pred reduction), [2T + r] the inclusive running max q after the last
// column, [3T + r] F(v, last column).  The thread that owns the shard's
// last column writes them as it goes, then, after the block's last node,
// publishes flags[d][b] (ring_common.cuh: fence, release store); thread
// 0 of shard d+1's block waits on it at the start of node block b, the
// block meets at a barrier and reads the slot past L1 (__ldcg) into
// shared memory.  Slots are never reused.  The last shard publishes
// nothing; D = 1 needs no packet and is a plain launch.
//
// Why no shard touches another's ring columns, whatever the lag.  The
// diagonal term of a shard's first column, max over preds of H(p, dC-1),
// is the packet's [0], not a ring read: shard d reads and writes only its
// own columns of every slot.  Within a shard the one-block argument holds
// unchanged: node i's pred rows are complete (written by the same block
// at an earlier node, before that node's closing barrier) and not yet
// overwritten (slot reuse needs W more nodes, and W exceeds every edge's
// topo distance).  Across shards the only data is the packet, written
// once, published behind a release flag and read after the acquire.  So
// shard d may run any number of nodes behind shard d-1 -- the pipeline's
// fill lets shard d start (d * T nodes late at the least; shard 0 never
// waits and may finish a launch before shard D-1 starts it), and no lag
// can make a shard read a slot its left neighbour has reused.
//
// Why a block that walks several shards cannot deadlock.  Shard d waits
// only on shard d-1, and every block takes its shards in increasing
// order.  By induction on d: shard 0 waits on nothing; if every shard
// below d completes, then shard d's block completes its earlier shards
// (all below d), reaches d, and every wait of d is on d-1, which
// completes.  All G blocks are resident (the cooperative launch), so a
// spinning block never keeps another from running.  Ring and packets are
// per shard, so the walk changes nothing above; the shared memory a
// shard leaves (s_preds, s_edge, s_pkt) is re-seeded behind the barrier
// that opens the next one.
//
// Watchdog: a wait on the left neighbour past tsta::wait_limit_ns traps.
// A POA node reads up to max_in pred rows per column, so the limit takes
// S * max_in as its per-row column count, and the shard index d (not the
// block's) as its fill: a walked shard starts later, never further
// behind its left neighbour.
//
// What bounds it on the H100: ~9 integer operations per cell and valid
// pred (E candidate, H and E first-max updates) and ~20 per cell (diag,
// C, F, H, running max, the word), so a 50 kbp round 2 is bound at ~4.5
// ms by operations; the words (2 bytes a cell) bound the window remats by
// bytes.  The nodes are a sequential chain: per node a shard pays three
// barriers, a block scan, one round trip to L2 for its preds' ring rows
// and the strip's dependent integer chain, which with one 256-thread
// block an SM sets the pace (~2.3 us a node at S = 8, ~4.3 at S = 16),
// and the pipeline adds (D - 1) * T nodes of fill.  Later work: more
// warps an SM for the same columns (512 threads at S = 4), the ring rows
// of chain nodes (one pred, the node before) in shared memory, DPX
// max-plus instructions.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"
#include "ring_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIn = 64;        // preds a pass (the 16-bit form's all)
constexpr int kWideMaxIn = 1 << 13;  // the wide form's 13-bit fields
constexpr int kMinS = 8;         // columns per thread, at least
constexpr int kMaxS = 32;        // at most (the strip lives in registers)
constexpr int kMaxShards = 132;  // past this many shards S grows
constexpr int kT = 16;           // nodes per packet: PERF.md's sweep
constexpr int kTMax = 256;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The smallest power of two >= x and >= kMinS.
__host__ __device__ inline int pow2_at_least(int x) {
  int s = kMinS;
  while (s < x) s *= 2;
  return s;
}

struct Params {
  int m, x, e, o;
};

// The words of a form: 16-bit with 6-bit pred fields, or the wide form's
// 32-bit with 13-bit ones.
template <bool kWide>
struct WordFmt {
  using T = uint16_t;
  static constexpr int kBits = 6;
};
template <>
struct WordFmt<true> {
  using T = uint32_t;
  static constexpr int kBits = 13;
};

// One node's valid predecessors in table order (one pass of them in the
// wide form): ring slot (-1 for the virtual row) and index in the pred
// table (the traceback's pred field).
struct Preds {
  int slot[kMaxIn];
  int idx[kMaxIn];
  int deg;
};

struct Launch {
  const int32_t* predsT;  // (max_in, N)
  const int32_t* pmaskT;  // (max_in, N)
  const int32_t* bases;   // (N,)
  const int32_t* fills;   // (4, N)
  const uint8_t* a;       // (n,)
  void* words;            // (N, n) uint16 (uint32 wide) or null
  int32_t* scores;        // (N,)
  int32_t* ring;          // (W, 2, D * 256 * S)
  int32_t* ckpt;          // (N, nwin, 3) or null
  int32_t* comm;          // (D, n_blocks, 4T) or null (D = 1)
  int32_t* flags;         // (D, n_blocks), zero, or null
  int N, n_nodes, n, n_real, W, max_in;
  int chunk_base, col0, nwin, cw;  // global row/column origin, windows
  int D, C, S, T, n_blocks;  // shards, their columns, a thread's, a packet's
  Params p;
  const int2* pcsr;       // wide: (nnz,) (buffer row id, table index)
  const int32_t* poff;    // wide: (N + 1,), row i's at [poff[i], poff[i+1])
};

// Node i's pred-table entries kk = lane and lane + 32, read by warp 0 a
// node ahead, so the loads' latency hides behind the node before.
struct PredRow {
  int r0, r1;
  bool v0, v1;
};

__device__ __forceinline__ PredRow fetch_preds(const Launch& L, int i,
                                               int lane) {
  PredRow q{0, 0, false, false};
  if (i < L.n_nodes) {
    if (lane < L.max_in) {
      q.v0 = __ldg(L.pmaskT + (size_t)lane * L.N + i) != 0;
      q.r0 = __ldg(L.predsT + (size_t)lane * L.N + i);
    }
    if (lane + 32 < L.max_in) {
      q.v1 = __ldg(L.pmaskT + (size_t)(lane + 32) * L.N + i) != 0;
      q.r1 = __ldg(L.predsT + (size_t)(lane + 32) * L.N + i);
    }
  }
  return q;
}

// Warp 0 compacts the valid entries into P in table order.
__device__ __forceinline__ void store_preds(Preds& P, const PredRow& q,
                                            int lane, int W) {
  const unsigned m0 = __ballot_sync(kFull, q.v0);
  const unsigned m1 = __ballot_sync(kFull, q.v1);
  const unsigned below = (1u << lane) - 1;
  if (q.v0) {
    const int k = __popc(m0 & below);
    P.slot[k] = q.r0 == 0 ? -1 : q.r0 % W;
    P.idx[k] = lane;
  }
  if (q.v1) {
    const int k = __popc(m0) + __popc(m1 & below);
    P.slot[k] = q.r1 == 0 ? -1 : q.r1 % W;
    P.idx[k] = lane + 32;
  }
  if (lane == 0) P.deg = __popc(m0) + __popc(m1);
}

// The wide form's pass of node i's list from its entry q0: entries q0 +
// lane and q0 + lane + 32, and the pass's length n (warp-uniform).
struct CsrRow {
  int2 e0, e1;
  int n;
};

__device__ __forceinline__ CsrRow fetch_csr(const Launch& L, int i, int q0,
                                            int lane) {
  CsrRow q{{0, 0}, {0, 0}, 0};
  if (i < L.n_nodes) {
    const int o = __ldg(L.poff + i) + q0;
    q.n = min(kMaxIn, __ldg(L.poff + i + 1) - o);
    if (lane < q.n) q.e0 = __ldg(L.pcsr + o + lane);
    if (lane + 32 < q.n) q.e1 = __ldg(L.pcsr + o + lane + 32);
  }
  return q;
}

// Warp 0 writes a pass (already compacted, in table order) into P.
__device__ __forceinline__ void store_csr(Preds& P, const CsrRow& q,
                                          int lane, int W) {
  if (lane < q.n) {
    P.slot[lane] = q.e0.x == 0 ? -1 : q.e0.x % W;
    P.idx[lane] = q.e0.y;
  }
  if (lane + 32 < q.n) {
    P.slot[lane + 32] = q.e1.x == 0 ? -1 : q.e1.x % W;
    P.idx[lane + 32] = q.e1.y;
  }
  if (lane == 0) P.deg = q.n;
}

template <bool kWide>
__device__ __forceinline__ auto fetch_next(const Launch& L, int i, int lane) {
  if constexpr (kWide)
    return fetch_csr(L, i, 0, lane);
  else
    return fetch_preds(L, i, lane);
}

template <bool kWide, class Row>
__device__ __forceinline__ void store_next(Preds& P, const Row& q, int lane,
                                           int W) {
  if constexpr (kWide)
    store_csr(P, q, lane, W);
  else
    store_preds(P, q, lane, W);
}

// The wide form's reductions of P's preds over a strip's kS columns and
// the column left of it (hl, al), preds outer so that one pred's loads
// are in flight together: first-max H and its index; first-max E
// candidate, its index and whether it extends E (pk: ha | ea << kB | ex
// << 2kB).  The 16-bit form's loop is the same, inline in run_shard.
template <int kS, int kB>
__device__ __forceinline__ void reduce_preds(const Preds& P, const Params& p,
                                             const int32_t* ring0, int RS,
                                             int g0, int (&hb)[kS],
                                             int (&eb)[kS], int (&pk)[kS],
                                             int& hl, int& al) {
  constexpr int kMask = (1 << kB) - 1;
  for (int c = 0; c < P.deg; ++c) {
    const int s = P.slot[c], idx = P.idx[c];
    int hp[kS], ep[kS], hq;
    if (s < 0) {
      hq = p.o + g0 * p.e;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        hp[k] = p.o + (g0 + k + 1) * p.e;
        ep[k] = kNeg;
      }
    } else {
      const int32_t* h = ring0 + (size_t)s * 2 * RS;
      hq = h[(kS - 1) * kThreads - 1];  // thread t-1's last column
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        hp[k] = h[k * kThreads];
        ep[k] = h[RS + k * kThreads];
      }
    }
    if (hq > hl) {
      hl = hq;
      al = idx;
    }
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      if (hp[k] > hb[k]) {
        hb[k] = hp[k];
        pk[k] = (pk[k] & ~kMask) | idx;
      }
      const int ec = max(ep[k] + p.e, hp[k] + p.o + p.e);
      if (ec > eb[k]) {
        eb[k] = ec;
        pk[k] = (pk[k] & kMask) | idx << kB | (ep[k] + p.e == ec) << (2 * kB);
      }
    }
  }
}

// One shard's DP, all the launch's nodes, by the whole block.  Shared
// memory: the left shard's packet (4T ints), the block scan's warp
// totals, the current and next node's preds (and, wide, a node's later
// passes in s_more), each thread's last F.
template <int kS, bool kWords, bool kCkpt, bool kWide>
__device__ __forceinline__ void run_shard(const Launch& L, const int d,
                                          const int D, int32_t* s_pkt,
                                          int* s_warp, Preds* s_preds,
                                          int* s_edge, Preds* s_more) {
  using Word = typename WordFmt<kWide>::T;
  constexpr int kB = WordFmt<kWide>::kBits;
  constexpr int kMask = (1 << kB) - 1;
  constexpr int kPer = 8 / sizeof(Word);  // words a 64-bit store
  const Params p = L.p;
  const int t = threadIdx.x, lane = t & 31;
  const int T = L.T, N = L.N, W = L.W;
  const int RS = D * kThreads * kS;     // ints per ring H or E row
  const int c0 = d * L.C;               // the shard's first local column
  const int Cd = min(L.C, L.n - c0);    // its columns
  const int j0 = c0 + t * kS;
  const int ncol = min(kS, c0 + Cd - j0);  // <= 0: no columns
  const int t_last = (Cd - 1) / kS;        // owns the shard's last column
  const int g0 = L.col0 + j0;              // global column of j0
  const bool pub = d + 1 < D && t == t_last;
  const unsigned long long wait_ns = tsta::wait_limit_ns(d, T, kS * L.max_in);
  // this thread's column k of ring slot s's H row: ring0[s*2*RS + k*256]
  const int32_t* ring0 = L.ring + (size_t)d * kThreads * kS + t;
  // the strip's read bytes, four a word, for the whole shard
  uint32_t a4[kS / 4];
#pragma unroll
  for (int q = 0; q < kS / 4; ++q)
    a4[q] = 4 * q < ncol
                ? __ldg(reinterpret_cast<const uint32_t*>(L.a + j0) + q)
                : 0u;

  decltype(fetch_next<kWide>(L, 0, 0)) next{};
  if (t < 32) store_next<kWide>(s_preds[0], fetch_next<kWide>(L, 0, lane),
                                lane, W);
  __syncthreads();
  for (int b = 0; b < L.n_blocks; ++b) {
    if (d > 0) {
      const size_t slot = (size_t)(d - 1) * L.n_blocks + b;
      if (t == 0) tsta::wait_flag(L.flags + slot, wait_ns);
      __syncthreads();
      for (int q = t; q < 4 * T; q += kThreads)
        s_pkt[q] = __ldcg(L.comm + slot * 4 * T + q);
      __syncthreads();
    }
    int32_t* pkt = pub ? L.comm + ((size_t)d * L.n_blocks + b) * 4 * T
                       : nullptr;
    const int i_end = min(L.n_nodes, (b + 1) * T);
    for (int i = b * T; i < i_end; ++i) {
      const int r = i - b * T;
      const Preds& P = s_preds[i & 1];
      const int base = __ldg(L.bases + i);
      if (t < 32) next = fetch_next<kWide>(L, i + 1, lane);

      // The pred reductions of the strip's columns and of the column left
      // of it (j0 - 1); the wide form's later passes each between two
      // barriers, every thread at each.
      int hb[kS], eb[kS], pk[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        hb[k] = kNeg;
        eb[k] = kNeg;
        pk[k] = 0;
      }
      int hl = kNeg, al = 0;
      if constexpr (kWide) {
        const int deg = __ldg(L.poff + i + 1) - __ldg(L.poff + i);
        for (int q0 = 0;; q0 += kMaxIn) {
          if (ncol > 0)
            reduce_preds<kS, kB>(q0 == 0 ? P : *s_more, p, ring0, RS, g0, hb,
                                 eb, pk, hl, al);
          if (q0 + kMaxIn >= deg) break;
          __syncthreads();  // every thread done with the last pass
          if (t < 32)
            store_csr(*s_more, fetch_csr(L, i, q0 + kMaxIn, lane), lane, W);
          __syncthreads();
        }
      } else if (ncol > 0) {
        // the 16-bit form's loop, inline: as a call of reduce_preds its
        // SASS moved (the same function, other registers and schedule)
        for (int c = 0; c < P.deg; ++c) {
          const int s = P.slot[c], idx = P.idx[c];
          int hp[kS], ep[kS], hq;
          if (s < 0) {
            hq = p.o + g0 * p.e;
#pragma unroll
            for (int k = 0; k < kS; ++k) {
              hp[k] = p.o + (g0 + k + 1) * p.e;
              ep[k] = kNeg;
            }
          } else {
            const int32_t* h = ring0 + (size_t)s * 2 * RS;
            hq = h[(kS - 1) * kThreads - 1];  // thread t-1's last column
#pragma unroll
            for (int k = 0; k < kS; ++k) {
              hp[k] = h[k * kThreads];
              ep[k] = h[RS + k * kThreads];
            }
          }
          if (hq > hl) {
            hl = hq;
            al = idx;
          }
#pragma unroll
          for (int k = 0; k < kS; ++k) {
            if (hp[k] > hb[k]) {
              hb[k] = hp[k];
              pk[k] = (pk[k] & ~63) | idx;
            }
            const int ec = max(ep[k] + p.e, hp[k] + p.o + p.e);
            if (ec > eb[k]) {
              eb[k] = ec;
              pk[k] = (pk[k] & 63) | idx << 6 | (ep[k] + p.e == ec) << 12;
            }
          }
        }
      }
      // max over the preds of H(p, j0 - 1) and its first-max index
      const int hd0 = t > 0 ? hl : (d == 0 ? __ldg(L.fills + i) : s_pkt[r]);
      const int ad0 =
          t > 0 ? al : (d == 0 ? __ldg(L.fills + N + i) : s_pkt[T + r]);
      const int seed = d == 0 ? __ldg(L.fills + 2 * N + i) : s_pkt[2 * T + r];

      // pass 1: strip max of C(k) - k*e
      int agg = kNeg;
      int hd = hd0;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        if (k < ncol) {
          const int aj = (a4[k / 4] >> (8 * (k % 4))) & 0xff;
          const int diag = hd + (aj == base ? p.m : p.x);
          agg = max(agg, max(diag, eb[k]) - (g0 + k) * p.e);
          hd = hb[k];
        }
      }
      int run = tsta::block_excl_max<kThreads>(agg, seed, s_warp);

      // pass 2: F, H, words, checkpoints, ring rows
      int32_t* own = L.ring + (size_t)((L.chunk_base + i + 1) % W) * 2 * RS +
                     (ring0 - L.ring);
      hd = hd0;
      int ad = ad0;
      int fl = 0;  // F(v, j-1)
      int f0 = 0;
      uint64_t acc = 0, first = 0;
      // the next checkpoint column at or after g0
      int nb = kCkpt ? (g0 / L.cw + 1) * L.cw - 1 : 0;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        if (k < ncol) {
          const int jg = g0 + k;
          const int aj = (a4[k / 4] >> (8 * (k % 4))) & 0xff;
          const int diag = hd + (aj == base ? p.m : p.x);
          const int c = max(diag, eb[k]);
          const int f = p.o + jg * p.e + run;
          const int h = max(c, f);
          run = max(run, c - jg * p.e);
          own[k * kThreads] = h;
          own[RS + k * kThreads] = eb[k];
          if (jg == L.n_real - 1) L.scores[i] = h;
          if constexpr (kCkpt) {
            if (jg == nb) {
              const int w = nb / L.cw;
              if (w < L.nwin) {
                int32_t* ck = L.ckpt + ((size_t)i * L.nwin + w) * 3;
                ck[0] = h;
                ck[1] = run;  // q: the running max including this column
                ck[2] = f;
              }
              nb += L.cw;
            }
          }
          if constexpr (kWords) {
            const int htype = h == diag ? 0 : (h == eb[k] ? 1 : 2);
            int w = (htype * 4 + ((pk[k] >> (2 * kB)) & 1) * 2) | (ad << 4) |
                    (((pk[k] >> kB) & kMask) << (4 + kB));
            if (k == 0) {
              f0 = f;  // its f_ext needs the neighbour's F(v, j0-1)
            } else {
              w |= f == fl + p.e;
            }
            acc |= (uint64_t)(Word)w << (8 * sizeof(Word) * (k % kPer));
            if (k % kPer == kPer - 1) {
              if (k == kPer - 1) {
                first = acc;
              } else {
                *reinterpret_cast<uint64_t*>(static_cast<Word*>(L.words) +
                                             (size_t)i * L.n + j0 + k -
                                             (kPer - 1)) = acc;
              }
              acc = 0;
            }
          }
          ad = pk[k] & kMask;
          fl = f;
          hd = hb[k];
        }
      }
      if (pub) {  // shard d+1's fills: this shard's last column
        pkt[r] = hd;
        pkt[T + r] = ad;
        pkt[2 * T + r] = run;
        pkt[3 * T + r] = fl;
      }
      if constexpr (kWords) s_edge[t] = fl;  // F(v, j0 + ncol - 1)
      if (t < 32) store_next<kWide>(s_preds[(i + 1) & 1], next, lane, W);
      __syncthreads();
      if constexpr (kWords) {
        if (ncol > 0) {
          const int fleft =
              t > 0 ? s_edge[t - 1]
                    : (d == 0 ? __ldg(L.fills + 3 * N + i) : s_pkt[3 * T + r]);
          first |= (uint64_t)(f0 == fleft + p.e);
          *reinterpret_cast<uint64_t*>(static_cast<Word*>(L.words) +
                                       (size_t)i * L.n + j0) = first;
        }
      }
    }
    if (pub) tsta::publish(L.flags + (size_t)d * L.n_blocks + b);
  }
}

// Dynamic shared memory: the left shard's packet, 4T ints.  Block g runs
// shard g; with kWalk (a grid narrower than the shards) then g + G, g +
// 2G, ... in turn.  A separate build: the loop costs the one-shard launch
// registers and time (on an H100, a one-shard loop, or a second inlined
// copy of the shard, ran the 50 kbp round 9-15% slower).
template <int kS, bool kWords, bool kCkpt, bool kWalk>
__global__ void __launch_bounds__(kThreads) poa_dp_kernel(const Launch L) {
  extern __shared__ int32_t s_pkt[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ Preds s_preds[2];
  __shared__ int s_edge[kThreads];
  if constexpr (kWalk) {
    for (int d = blockIdx.x; d < L.D; d += gridDim.x)
      run_shard<kS, kWords, kCkpt, false>(L, d, L.D, s_pkt, s_warp, s_preds,
                                          s_edge, nullptr);
  } else {
    run_shard<kS, kWords, kCkpt, false>(L, blockIdx.x, gridDim.x, s_pkt,
                                        s_warp, s_preds, s_edge, nullptr);
  }
}

// The wide form, walking its shards (one each at G = D): one build per
// use and strip width (a build without the shard loop ran the 50 kbp
// round ~1.5% faster, not worth its compile time).
template <int kS, bool kWords, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
    poa_dp_wide_kernel(const Launch L) {
  extern __shared__ int32_t s_pkt[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ Preds s_preds[2];
  __shared__ Preds s_more;
  __shared__ int s_edge[kThreads];
  for (int d = blockIdx.x; d < L.D; d += gridDim.x)
    run_shard<kS, kWords, kCkpt, true>(L, d, L.D, s_pkt, s_warp, s_preds,
                                       s_edge, &s_more);
}

// The kernel of one use, strip width and grid kind, or null for an S it
// has none of.
template <bool kWords, bool kCkpt, bool kWalk>
const void* kernel_for(int S) {
  switch (S) {
    case 8: return (const void*)poa_dp_kernel<8, kWords, kCkpt, kWalk>;
    case 16: return (const void*)poa_dp_kernel<16, kWords, kCkpt, kWalk>;
    case 32: return (const void*)poa_dp_kernel<32, kWords, kCkpt, kWalk>;
    default: return nullptr;
  }
}

template <bool kWords, bool kCkpt>
const void* wide_kernel_for(int S) {
  switch (S) {
    case 8: return (const void*)poa_dp_wide_kernel<8, kWords, kCkpt>;
    case 16: return (const void*)poa_dp_wide_kernel<16, kWords, kCkpt>;
    case 32: return (const void*)poa_dp_wide_kernel<32, kWords, kCkpt>;
    default: return nullptr;
  }
}

// The kernel of a launch: with words (window remat, single call), with
// checkpoints (forward chunk), with both (a cell of the column-window
// wavefront, parallel/msa_longseq.py: its words and the checkpoint at its
// window's last column) or neither; the wide form, or walking its shards
// or not.  The cell builds are instantiations of their own, so the other
// builds' code is unchanged by them.
const void* kernel_of(bool words, bool ckpt, bool walk, int S,
                      bool wide = false) {
  if (wide)
    return words ? (ckpt ? wide_kernel_for<true, true>(S)
                         : wide_kernel_for<true, false>(S))
           : ckpt ? wide_kernel_for<false, true>(S)
                  : wide_kernel_for<false, false>(S);
  if (walk)
    return words ? (ckpt ? kernel_for<true, true, true>(S)
                         : kernel_for<true, false, true>(S))
           : ckpt ? kernel_for<false, true, true>(S)
                  : kernel_for<false, false, true>(S);
  return words ? (ckpt ? kernel_for<true, true, false>(S)
                       : kernel_for<true, false, false>(S))
         : ckpt ? kernel_for<false, true, false>(S)
                : kernel_for<false, false, false>(S);
}

}  // namespace

// The plan for an n-column launch: D shards of C columns (the last one
// n - (D-1)*C), S columns per thread, T nodes per packet.  The wrapper's
// twin is msa_poa.poa_plan.
extern "C" void tsta_poa_dp_layout(int n, int* D, int* C, int* S, int* T) {
  const int span = kMaxShards * kThreads;
  const int s = pow2_at_least((n + span - 1) / span);
  *S = s > kMaxS ? kMaxS : s;
  *C = *S * kThreads;
  *D = (n + *C - 1) / *C;
  *T = kT;
}

// The most blocks of S columns a thread with T-node packets the current
// card holds resident at once, the least over the kernel's four builds
// (words, checkpoints, both, neither), each walking its shards or not, or
// with ``wide`` over the wide form's four (for
// the wrapper's default grid and its error message; the launch itself is
// refused with cudaErrorCooperativeLaunchTooLarge); a negative value is
// minus a CUDA error.
extern "C" int tsta_poa_dp_max_blocks(int T, int S, int wide) {
  if (!kernel_of(false, false, false, S))
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  for (int k = 0; k < (wide ? 4 : 8); ++k) {
    int per_sm = 0;
    const void* fn = kernel_of(k % 4 == 0 || k % 4 == 2,
                               k % 4 == 1 || k % 4 == 2, k >= 4, S, wide);
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kThreads, sizeof(int32_t) * 4 * (size_t)T);
    if (rc != cudaSuccess) return -static_cast<int>(rc);
    if (k == 0 || per_sm * sms < limit) limit = per_sm * sms;
  }
  return coop ? limit : 0;
}

// predsT, pmaskT: (max_in, N) int32 buffer row ids (0 = virtual) and
// validity; bases: (N,) int32; fills: (4, N) int32; a: (n,) uint8, the
// read's columns [col0, col0 + n), n % 4 == 0; scores: (N,) int32, rows <
// n_nodes written where the launch holds column n_real - 1; ring: (W, 2,
// D * 256 * S) int32, read and written in place.  words: (N, n) uint16 or
// null; ckpt: (N, nwin, 3) int32 or null (cw > 0, nwin windows of cw
// columns: the checkpoint of window w after global column (w+1)*cw - 1),
// with or without words.  D shards of C columns
// (C a multiple of 4, D = ceil(n / C)) on G blocks (1 <= G <= D), S
// columns a thread (8, 16 or 32; C <= 256 * S), T nodes per packet
// (1..256); comm: (D, ceil(n_nodes / T), 4T) int32 and flags: (D,
// ceil(n_nodes / T)) int32, zero, both null for D = 1 or no nodes.
// The wide form (max_in up to 8,192): pcsr, (nnz, 2) int32, the valid
// entries (buffer row id, table index) of the table in row-major order,
// and poff, (N + 1,) int32, row i's entries [poff[i], poff[i + 1]) of
// pcsr (a chunk's poff is its rows' slice of the round's);
// words uint32; predsT and pmaskT unread.  Both null: the 16-bit form.
// Returns cudaGetLastError() after the launch (cooperative for G >= 2),
// or the launch's error: cudaErrorCooperativeLaunchTooLarge, without
// launching, when G blocks cannot be resident together.
extern "C" int tsta_poa_dp(const void* predsT, const void* pmaskT,
                           const void* bases, const void* fills,
                           const void* a, int N, int n_nodes, int n,
                           int n_real, int W, int max_in, int M, int X,
                           int E, int O, int chunk_base, int col0, int nwin,
                           int cw, void* words, void* scores, void* ring,
                           void* ckpt, int D, int C, int S, int T, int G,
                           void* comm, void* flags, const void* pcsr,
                           const void* poff, void* stream) {
  const bool wide = poff != nullptr;
  const void* fn = kernel_of(words, ckpt, G < D, S, wide);
  if (!fn || max_in > (wide ? kWideMaxIn : kMaxIn) || (wide && !pcsr) ||
      (ckpt && (nwin < 1 || cw < 1)) || T < 1 || T > kTMax || C % 4 ||
      C > S * kThreads || D < 1 || (D - 1) * C >= n || D * C < n || G < 1 ||
      G > D || (D > 1 && n_nodes > 0 && !(comm && flags)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{static_cast<const int32_t*>(predsT),
                 static_cast<const int32_t*>(pmaskT),
                 static_cast<const int32_t*>(bases),
                 static_cast<const int32_t*>(fills),
                 static_cast<const uint8_t*>(a),
                 words,
                 static_cast<int32_t*>(scores),
                 static_cast<int32_t*>(ring),
                 static_cast<int32_t*>(ckpt),
                 static_cast<int32_t*>(comm),
                 static_cast<int32_t*>(flags),
                 N, n_nodes, n, n_real, W, max_in,
                 chunk_base, col0, nwin, cw,
                 D, C, S, T, (n_nodes + T - 1) / T,
                 Params{M, X, E, O},
                 static_cast<const int2*>(pcsr),
                 static_cast<const int32_t*>(poff)};
  const size_t smem = sizeof(int32_t) * 4 * (size_t)T;
  auto st = static_cast<cudaStream_t>(stream);
  void* args[] = {(void*)&L};
  const cudaError_t rc =
      G == 1 ? cudaLaunchKernel(fn, dim3(1), dim3(kThreads), args, smem, st)
             : cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), args,
                                           smem, st);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
