// The score-only sharded Gotoh DP: the kernel body, plan and launch shared by
// psa_dp.cu (K1 and the ring: a pair's columns as (P, n_pad) bytes) and
// psa_dp_striped.cu (Q2-11: each pair's columns as JAX's striped tile).
// The two differ only in how a shard reads its columns of `a`, a Reader
// (below), so the schedule cannot drift between them.  psa_dp_diff.cu
// (Q2-9, a body of its own) takes its shard count from plan() and launches
// through launch_shards().
//
// Recurrence (i the row over b, j the GLOBAL column over a):
//   E(i,j) = max(E(i-1,j) + e, H(i-1,j) + o + e)
//   C(j)   = max(H(i-1,j-1) + sub(a_j, b_i), E(i,j))
//   F(i,j) = o + j*e + max(H(i,-1) + e, max_{0<=k<j} (C(k) - k*e))
//   H(i,j) = max(C(j), F(i,j))
// with H(-1,j) = o + (j+1)e, H(i,-1) = o + (i+1)e, H(-1,-1) = 0 and
// E(-1,j) = NEG (-2^28, not INT_MIN: gap terms are added to it).  The
// closed-form F composes across shards: shard d's seed is shard d-1's
// inclusive prefix.
//
// Plan (plan(), from P, n_pad and the SM count alone; the wrapper's twin is
// psa_diff.score_plan): max(1, per_sm * SMs / P) blocks a pair; W =
// ceil(n_pad / (256 * blocks)) columns per thread, at least kMinW; C = 256
// * W columns per shard (n_pad when that is less); D = ceil(n_pad / C)
// shards, the last one possibly narrower; T = kT rows per packet.  per_sm
// is 2 when one block an SM would give a strip of kSplitW to kSplitMaxW
// columns, else 1: a second block an SM hides a row's barriers where the
// strip's cells are many, and costs fill and packets where they are few
// (PERF.md's sweep, which also gives kMinW and kT).  So P * D <= 2 * SMs
// whenever D >= 2.  The ring takes C = n / D from the mesh and T = the
// caller's block.
//
// Grid.  One dimension, block pair * D + d (a batch of more than 65,535
// pairs, the y limit, launches at once).  D = 1: an ordinary launch, as no
// block waits on another, so any P runs.  D >= 2: one cooperative launch of
// P * D blocks, refused without launching past the card's co-resident
// limit (ring_common.cuh).
//
// Block d of a pair owns the global columns [d*C, d*C + Cd), Cd its
// columns to run; thread t the strip [t*W, t*W + W) of them, W = ceil(Cd /
// 256) (so a short pair of a wide batch runs narrow strips, as K1's one
// block a pair did).  Per row: pass 1 takes each strip's max of C(k) -
// k*e, block_excl_max (dp_common.cuh) seeds the exclusive prefix with the
// incoming F prefix (H(i,-1) + e on shard 0), pass 2 writes H and E.  The
// H/E frontier and the shard's slab of a live in shared memory,
// interleaved (column t*W+k at k*256+t, so a warp's accesses are
// consecutive), when they fit beside the packet, else the frontier in a
// global scratch and a read of a through the Reader.  The diagonal term of
// a strip's first column comes from the neighbour thread through a
// double-buffered shared edge array, at the shard's first column from the
// packet.
//
// Packets.  comm is (P, D, m_blocks, 2T) int32, one slot per row block of
// T rows (JAX's comm_ref layout); slot rb of shard d holds, for row r of
// the block (i = rb*T + r), H(i-1, its last column) in lane r and the
// inclusive F prefix of row i at its last column in lane T + r.  The
// thread that owns the last column writes both as it goes, then, after
// the block's last row, publishes flags[pair][d][rb] (ring_common.cuh);
// thread 0 of block d+1 waits on it at the start of row block rb, the
// block meets at a barrier and reads the slot past L1 (__ldcg) into
// shared memory.  Slots are never reused.  A wait past the watchdog's
// limit traps.  At D = 1 a K1 launch has no comm and no flags.
//
// Result: out (P, D, 2) int32, each block's best over its cells and its
// corner H(m_real-1, n_real-1), NEG where that cell is not in its shard.
// The max over D is taken after the launch, as JAX's pmax.
//
// DPX (sm_90): E = max(E + e, H + o + e) is __viaddmax_s32, the running
// max of C(k) - k*e one more, and H = max(diag, E, F) __vimax3_s32; the
// same int32 values as the plain max.
//
// Linked build (kLinked, psa_dp.cu's tsta_psa_dp_linked: the ring across
// cards and processes, one launch a card at one pair and full = 1).  The
// launch runs its card's columns of the pair, which begin at global
// column col_base: the values (row -1, the closed-form F, the corner test)
// are in global column space, the Reader and the shards in the card's.
// Block 0 of a card that is not the first takes its left packet of each
// row block from the in-link, the packets and flags the card to its left
// wrote into mapped host memory (wait_flag_system, then uncached loads);
// the last block writes each packet into its comm slot as always and,
// where a card lies to its right, into the out-link too, then publishes
// its flag at system scope.  A link slot is written once, so a card never
// waits on a card to its right; the watchdog counts the block's global
// shard index, shard_base + d.  The other builds' code is unchanged: the
// link is a second kernel argument only this build has.
//
// A Reader is constructed in the block as Reader(k, pair, col0) and gives
//   stage_col(s_a, q, j): called at row -1 for each column j of the
//     thread's strip, q its slot in the slab (the shared-memory frontier
//     only);
//   stage_all(s_a, Cd, W): called by every thread after that loop, before
//     the barrier that ends row -1 (the shared-memory frontier only);
//   at(j): column j of the shard, read from device memory (the global
//     frontier).
// Between them a Reader fills s_a[(j % W) * 256 + j / W] with column j of
// the shard, j < Cd, in whichever order its input holds the bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"
#include "ring_common.cuh"

namespace {

using tsta::kNeg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;     // rows per packet: PERF.md's sweep
constexpr int kMinW = 2;   // columns per thread of a shard, at least
                           // (PERF.md's sweep)
// one-block-an-SM strips that take two blocks an SM instead (PERF.md's
// sweep); at kSplitMaxW / 2 columns four blocks' frontiers fit an SM
constexpr int kSplitW = 6, kSplitMaxW = 48;
// dynamic shared memory a block may take: the packet, then the frontier
// and a when they fit (227 KB a block, less the static arrays and a margin)
constexpr size_t kSmemMax = 220 * 1024;

__host__ __device__ inline int strip_width(int C) {
  return (C + kThreads - 1) / kThreads;
}

struct Params {
  int m, x, e, o;
};

struct Score {
  const uint8_t* a;      // (P, n_pad): the pairs' columns, in the Reader's
                         // layout
  const uint8_t* b;      // (P, m_stride)
  const int32_t* lens;   // (P, 2): real n, m
  int32_t* out;          // (P, D, 2): each shard's best and corner
  int32_t* comm;         // (P, D, m_blocks, 2T), or null (K1 at D = 1)
  int32_t* flags;        // (P, D, m_blocks), zero; null with comm
  int32_t* scratch;      // (P, D, 2 * strip_width(C) * kThreads) or null
  int n_pad, m_stride, C, D, T, m_blocks, full;
  Params p;
};

// The linked build's card edges (mapped host memory, device pointers).
struct Link {
  const int32_t* in_pkts;    // (m_blocks, 2T) from the card to the left,
  const int32_t* in_flags;   // (m_blocks); both null on the first card
  int32_t* out_pkts;         // (m_blocks, 2T) to the card to the right,
  int32_t* out_flags;        // (m_blocks); both null on the last card
  int col_base;              // global column of this card's column 0
  int shard_base;            // global shard index of this card's block 0
};

// Dynamic shared memory: the incoming packet (2T ints), then, unless
// kGlobal, H and E (W * kThreads ints each) and a (W * kThreads bytes).
template <bool kGlobal, class Reader, bool kLinked = false>
__device__ __forceinline__ void score_body(const Score& k,
                                           const Link* lk = nullptr) {
  extern __shared__ int32_t s_dyn[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const Params p = k.p;
  const int pair = blockIdx.x / k.D;
  const int d = blockIdx.x - pair * k.D;
  const size_t shard = (size_t)pair * k.D + d;  // (pair, d) in the packets
  const int t = threadIdx.x;
  const int T = k.T;
  const int n_real = k.lens[2 * pair], m_real = k.lens[2 * pair + 1];
  // the columns and rows this launch runs: the pair's real extent (K1) or
  // every padded one (the ring)
  const int n_run = k.full ? k.n_pad : n_real;
  const int rows = k.full ? k.m_stride : m_real;
  const int col0 = d * k.C;                 // the launch's column 0
  const int Cd = min(k.C, n_run - col0);    // this shard's columns
  // the global index of the shard's column 0, and whether the shard is
  // the pair's first (whose left edge is the DP's boundary)
  const int gcol0 = kLinked ? lk->col_base + col0 : col0;
  const bool first = kLinked ? d == 0 && lk->in_flags == nullptr : d == 0;
  int32_t* out = k.out + 2 * shard;
  if (Cd <= 0) {  // wholly past the pair's columns: nobody waits on it
    if (t == 0) {
      out[0] = kNeg;
      out[1] = kNeg;
    }
    return;
  }
  const int W = strip_width(Cd);
  const int Wp = strip_width(k.C);          // the allocation's strip
  const int j0 = t * W;
  const int jend = min(j0 + W, Cd);         // jend <= j0: no columns
  const int t_last = (Cd - 1) / W;          // owns the shard's last column
  // packets for a right neighbour that runs, or for the ring's caller
  const bool send = k.comm != nullptr && (k.full || col0 + Cd < n_run);
  const int oe = p.o + p.e;
  int32_t* s_pkt = s_dyn;
  int32_t* H = kGlobal ? k.scratch + shard * 2 * Wp * kThreads
                       : s_dyn + 2 * T;
  int32_t* E = H + (size_t)W * kThreads;
  uint8_t* s_a = reinterpret_cast<uint8_t*>(s_dyn + 2 * T + 2 * Wp * kThreads);
  const Reader a(k, pair, col0);
  const uint8_t* b = k.b + (size_t)pair * k.m_stride;
  const size_t slab = (size_t)k.m_blocks * 2 * T;
  // used only where send (mine) or d > 0 (the left shard's)
  int32_t* my_comm = k.comm + shard * slab;
  const int32_t* left_comm = k.comm + (shard - 1) * slab;
  int32_t* my_flags = k.flags + shard * k.m_blocks;
  const int32_t* left_flags = k.flags + (shard - 1) * k.m_blocks;
  const unsigned long long wait_ns =
      tsta::wait_limit_ns(kLinked ? lk->shard_base + d : d, T, W);
  // the linked build's last block also feeds the card to its right
  const bool link_out = kLinked && d == k.D - 1 && lk->out_flags != nullptr;

  // row -1: H(-1,j) = o + (j+1)e, E(-1,j) = NEG
  for (int j = j0; j < jend; ++j) {
    const int q = (j - j0) * kThreads + t;
    H[q] = p.o + (gcol0 + j + 1) * p.e;
    E[q] = kNeg;
    if (!kGlobal) a.stage_col(s_a, q, j);
  }
  if (!kGlobal) a.stage_all(s_a, Cd, W);
  s_edge[1][t] = p.o + (gcol0 + jend) * p.e;  // H(-1, jend - 1)
  int edge = p.o + (gcol0 + Cd) * p.e;         // H(i-1, last column)
  int best = kNeg, corner = kNeg;
  __syncthreads();

  const int mb = (rows + T - 1) / T;
  for (int rb = 0; rb < mb; ++rb) {
    if (d > 0) {
      if (t == 0) tsta::wait_flag(left_flags + rb, wait_ns);
      __syncthreads();
      for (int q = t; q < 2 * T; q += kThreads)
        s_pkt[q] = __ldcg(left_comm + (size_t)rb * 2 * T + q);
      __syncthreads();
    } else if constexpr (kLinked) {
      if (!first) {
        if (t == 0) tsta::wait_flag_system(lk->in_flags + rb, wait_ns);
        __syncthreads();
        for (int q = t; q < 2 * T; q += kThreads)
          s_pkt[q] = __ldcv(lk->in_pkts + (size_t)rb * 2 * T + q);
        __syncthreads();
      }
    }
    int32_t* pkt_out = my_comm + (size_t)rb * 2 * T;
    const int nr = min(T, rows - rb * T);
    for (int r = 0; r < nr; ++r) {
      const int i = rb * T + r;
      const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
      const int seed = first ? p.o + (i + 1) * p.e + p.e : s_pkt[T + r];
      const int fill = first ? bound_prev : s_pkt[r];
      const bool last_row = i == m_real - 1;
      const int bi = b[i];
      const int hd0 = t == 0 ? fill : s_edge[(i + 1) & 1][t - 1];

      // pass 1: strip max of C(k) - k*e
      int agg = kNeg;
      int hd = hd0;
      for (int j = j0; j < jend; ++j) {
        const int q = (j - j0) * kThreads + t;
        const int hp = H[q];
        const int ev = __viaddmax_s32(E[q], p.e, hp + oe);
        const int aj = kGlobal ? a.at(j) : s_a[q];
        const int diag = hd + (aj == bi ? p.m : p.x);
        agg = __viaddmax_s32(max(diag, ev), -(gcol0 + j) * p.e, agg);
        hd = hp;
      }
      int run = tsta::block_excl_max<kThreads>(agg, seed, s_warp);

      // pass 2: F, H, E
      hd = hd0;
      int hl = 0;          // H(i, j-1)
      int rbest = kNeg;    // the row's best in this strip
      for (int j = j0; j < jend; ++j) {
        const int q = (j - j0) * kThreads + t;
        const int gje = (gcol0 + j) * p.e;
        const int hp = H[q];
        const int ev = __viaddmax_s32(E[q], p.e, hp + oe);
        const int aj = kGlobal ? a.at(j) : s_a[q];
        const int diag = hd + (aj == bi ? p.m : p.x);
        const int h = __vimax3_s32(diag, ev, p.o + gje + run);
        run = __viaddmax_s32(max(diag, ev), -gje, run);
        H[q] = h;
        E[q] = ev;
        rbest = max(rbest, h);
        if (last_row && gcol0 + j == n_real - 1) corner = h;
        hd = hp;
        hl = h;
      }
      if (i < m_real) best = max(best, rbest);
      s_edge[i & 1][t] = hl;  // H(i, jend - 1)
      if (t == t_last && send) {
        pkt_out[r] = edge;      // H(i-1, last column)
        pkt_out[T + r] = run;   // inclusive F prefix of row i
        if constexpr (kLinked) {
          if (link_out) {
            int32_t* l = lk->out_pkts + (size_t)rb * 2 * T;
            l[r] = edge;
            l[T + r] = run;
          }
        }
        edge = hl;
      }
      __syncthreads();
    }
    if (t == t_last && send) tsta::publish(my_flags + rb);
    if constexpr (kLinked) {
      if (t == t_last && link_out) tsta::publish_system(lk->out_flags + rb);
    }
  }

  best = tsta::block_max<kThreads>(best, s_warp);
  corner = tsta::block_max<kThreads>(corner, s_warp);
  if (t == 0) {
    out[0] = best;
    out[1] = corner;
  }
}

// Dynamic shared memory of a block of C columns and T-row packets, and
// whether its frontier goes to the global scratch.
size_t smem_bytes(int C, int T, bool* global) {
  const size_t pkt = 2 * sizeof(int32_t) * (size_t)T;
  const size_t frontier =
      (2 * sizeof(int32_t) + 1) * (size_t)strip_width(C) * kThreads;
  *global = pkt + frontier > kSmemMax;
  return *global ? pkt : pkt + frontier;
}

// Columns per thread when each of P pairs of n_pad columns takes
// max(1, per_sm * sms / P) blocks.
int plan_width(int P, int n_pad, int sms, int per_sm) {
  const int blocks = per_sm * sms / P > 1 ? per_sm * sms / P : 1;
  const long long span = (long long)blocks * kThreads;
  const int per_thread = (int)((n_pad + span - 1) / span);
  return per_thread > kMinW ? per_thread : kMinW;
}

void plan(int P, int n_pad, int sms, int* D, int* C, int* W, int* T) {
  const int w1 = plan_width(P, n_pad, sms, 1);
  const int w0 = w1 >= kSplitW && w1 <= kSplitMaxW
                     ? plan_width(P, n_pad, sms, 2) : w1;
  *C = w0 * kThreads < n_pad ? w0 * kThreads : n_pad;
  *D = (n_pad + *C - 1) / *C;
  *W = strip_width(*C);
  *T = kT;
}

// The most shards of C columns and T-row packets the current card holds
// resident at once of a body whose builds are `shared` and `global`; a
// negative value is minus a CUDA error.
template <typename Kernel>
int max_blocks(Kernel shared, Kernel global_, int C, int T) {
  bool global;
  const size_t smem = smem_bytes(C, T, &global);
  return global ? tsta::coresident_limit(global_, kThreads, smem)
                : tsta::coresident_limit(shared, kThreads, smem);
}

// One launch of the sharded body `fn` over P pairs of D shards, one block
// of kThreads threads and `smem` bytes of dynamic shared memory a shard,
// with the kernel argument `k`: an ordinary launch of P blocks at D = 1
// (any P), one cooperative launch of P * D blocks at D >= 2, refused with
// cudaErrorCooperativeLaunchTooLarge without launching when those blocks,
// which wait on each other, cannot be resident together: the one place
// that decides it, for K1, the ring, the striped DP and the difference
// method (psa_dp_diff.cu).  Returns cudaGetLastError() after the launch.
template <class Args>
int launch_shards(const void* fn, size_t smem, int P, int D, const Args& k,
                  void* stream) {
  if (D >= 2) {
    const int limit = tsta::coresident_limit(fn, kThreads, smem);
    if (limit < 0) return -limit;
    if ((long long)P * D > limit)
      return (int)cudaErrorCooperativeLaunchTooLarge;
  } else {
    cudaError_t rc = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  void* args[] = {(void*)&k};
  cudaError_t rc =
      D >= 2 ? cudaLaunchCooperativeKernel(fn, dim3(P * D), dim3(kThreads),
                                           args, smem, (cudaStream_t)stream)
             : cudaLaunchKernel(fn, dim3(P), dim3(kThreads), args, smem,
                                (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// One launch of a body whose builds are `shared` and `global` (the
// arguments of tsta_psa_dp, psa_dp.cu), through launch_shards.
template <typename Kernel>
int launch(Kernel shared, Kernel global_, const void* a, const void* b,
           const void* lens, int P, int n_pad, int m_stride, int M, int X,
           int E, int O, int full, int D, int C, int T, void* comm,
           void* flags, void* out, void* scratch, void* stream) {
  if (P < 1 || D < 1 || C < 1 || T < 1 || m_stride < 1 ||
      (long long)(D - 1) * C >= n_pad || n_pad > (long long)D * C ||
      (D >= 2 && (comm == nullptr || flags == nullptr)))
    return (int)cudaErrorInvalidValue;
  bool global;
  const size_t smem = smem_bytes(C, T, &global);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const Score k{static_cast<const uint8_t*>(a),
                static_cast<const uint8_t*>(b),
                static_cast<const int32_t*>(lens),
                static_cast<int32_t*>(out),
                static_cast<int32_t*>(comm),
                static_cast<int32_t*>(flags),
                static_cast<int32_t*>(scratch),
                n_pad, m_stride, C, D, T, (m_stride + T - 1) / T, full,
                Params{M, X, E, O}};
  return launch_shards(global ? (const void*)global_ : (const void*)shared,
                       smem, P, D, k, stream);
}

}  // namespace
