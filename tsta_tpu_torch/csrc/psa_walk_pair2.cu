// Traceback walk over the DP kernel's code plane, one thread walking two
// pairs from two staged window rings.
//
// Replaces the TPU kernel tsta_tpu/ops/traceback.py:
// _walk_kernel_packed_pair2 (Q2-12, launched through
// _decode_moves_banded_packed with pair2=True when P is even): program q
// walks pairs 2q and 2q+1 in one loop, both pairs' decode chains in one
// basic block, so the in-order scalar core fills one chain's load-use
// stalls with the other's; each pair keeps its own SMEM window.  Its
// function is K3's (psa_walk.cu): the same moves, words and counts per
// pair.
//
// Per pair the walk and its output are K3's: start at (m-1, n-1), step
// until i < 0 and j < 0 with psa_walk_step.cuh's rules in the core, left
// then up outside it; 16 moves of 2 bits per int32 word, LSB first; the
// tail word after the loop, the remaining words zeroed, the count.
//
// Design.  Block q (grid P/2, the TPU's grid) walks pairs 2q and 2q+1.
// Thread 0, the walker, holds both walks' state in registers; warps 1..,
// the loaders, stage each pair's windows of the plane in shared memory
// with cp.async, as K3's ring does for one pair (psa_walk_stage.cuh): per
// pair two windows of (2S + 1) x (2S + 16) bytes anchored and clipped by
// walk_window, phase k of a pair reading the window anchored where its
// phase k - 1 began, at most S steps in the matrix.  pair_stage makes
// walk_stage's copies without a division a copy: the loaders stage two
// windows a phase, and the walker takes a third of K3's time a step.  The
// pairs share the phase counter: one __syncthreads ends a phase of both,
// and the anchors and done flags are double-buffered by the phase's
// parity, one set per pair (walk_ring's protocol).
// traceback.walk_pair2_staged_plain emulates the walker on the CPU read
// by read, the loaders' windows and the guards included.
//
// In a phase that both pairs begin inside the matrix, each step of the
// walker's loop first issues both pairs' three ld.shared reads, then
// applies the step rules to each, with no branch: two independent
// dependent-load chains in one loop body.  The step is short (PairRules):
// the back code as c / 9 by a multiply-high, the forced move as a select,
// the continuation of a gap run as bit ``move`` of two mask lookups, the
// cell's offset step as a byte of a packed table, the move shifted into
// its word from the top.  The steps both walks are sure to
// take inside the matrix (the least of their i and j, down to a multiple
// of 16) run unmasked, 16 steps of each a body, which completes one word
// of each, stored after it; i and j are read back off the cell's offset
// after them.  The rest of the phase runs masked, i and j kept: a pair
// that leaves the matrix becomes a no-op until the phase ends (its reads
// issued and discarded), then runs its left/up tail.  The j > 0 and i > 0
// tests of the step rules are left out: a gap run forced at the matrix's
// edge leaves the matrix, where no forced move is read.  Once a pair is
// done its partner walks alone on the same step (chains_phase of one
// walk).  Every read whose value a move depends on is in the pair's
// window.  A read whose value is discarded (past the matrix's edge, or a
// masked one at a walk's exit cell) lies in the window or, for the code
// above an exit cell at column -1, one byte before it; each pair's
// windows follow a guard of W + 16 bytes of its own, so no read leaves
// the pair's part of shared memory.
//
// What bounds it on the H100: its instructions.  One thread issues about
// one instruction every 2.5 cycles (the walk probes, Q2-17), and a second
// chain in the thread did not lower that; so the step is cut to ~20
// instructions, K3's is 66 (the library's SASS, walk_probes.
// walk_sass_steps).  The grid is half K3's: half as many SMs at P <= 2 x
// SMs.
//
// Shared memory: 2 x (W + 16 + 2 (2S + 1) W) bytes, W = 2S + 16 (74,624
// at S = 64, 20,992 at S = 32).

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_stage.cuh"

namespace {

// steps of each walk a loop body: where every walk is sure to stay inside
// the matrix (one word of moves each, stored once a body), and where a
// step is masked (S is a multiple of 8)
constexpr int kFastUnroll = 16, kMaskedUnroll = 4;

// Move t into the packed words: a word is stored when its 16th move lands.
struct PackedMoves {
  int32_t* words;
  uint32_t acc;
  __device__ __forceinline__ void put(int t, int move) {
    acc |= (uint32_t)move << (2 * (t & 15));
    if ((t & 15) == 15) {
      words[t >> 4] = (int32_t)acc;
      acc = 0;
    }
  }
};

using Walker = tsta::RingWalker<PackedMoves>;

// The longest phase: a cell offset's step (W + 1 = 2S + 17) is a byte of
// PairRules::delta.
constexpr int kPair2MaxS = 112;

// One pair's part of shared memory: its guard, then its two windows.
__host__ __device__ inline int pair2_guard(int S) { return 2 * S + 32; }
__host__ __device__ inline int pair2_region(int S) {
  return pair2_guard(S) + 2 * (2 * S + 1) * (2 * S + 16);   // walk_ring_bytes
}

__device__ __forceinline__ bool in_core(const Walker& w) {
  return (w.i | w.j) >= 0;
}

// The step rules of walk_step_masks as a two-pair step reads them: bit 0
// of (f0 >> c | f2 >> l) continues a left gap run, bit 2 of (e0 >> c |
// e2 >> u) an up one, so bit ``move`` of their union says whether the
// next move is forced to be this one; byte ``move`` of ``delta`` is the
// cell offset's step (left 1, diagonal W + 1, up W).
struct PairRules {
  uint32_t f0, f2, e0, e2, delta;
};

__device__ __forceinline__ PairRules pair_rules(const tsta::StepMasks& m,
                                                int W) {
  return {m.f0, m.f2, m.e0 << 2, m.e2 << 2,
          1u | (uint32_t)(W + 1) << 8 | (uint32_t)W << 16};
}

// One walk inside a two-pair phase.  Its moves enter ``acc`` from the
// top, two bits a move (after move t, move t - q at bits 30 - 2q), so
// the word of moves 16w .. 16w + 15 is acc itself after move 16w + 15,
// LSB first.  The masked loop stores the current word at every step; the
// unmasked one once a body of 16 steps (chains_phase).  The next move is
// ``prev`` when ``forced``.  i and j are kept only in the masked loop.
struct Chain {
  uint32_t off, acc;   // the shared address of its cell; its current word
  int t, prev, i, j;
  bool forced;
  int32_t* words;
};

// One step of ``ch`` at the cell whose codes are c, l and u: RingWalker::
// phase's step, without its i > 0 and j > 0 tests (a gap run forced at
// the matrix's edge leaves it, where no forced move is read; the code
// read past the edge is discarded).  kMasked: applied only while the walk
// is inside the matrix.
template <bool kMasked>
__device__ __forceinline__ void chain_step(Chain& ch, uint32_t c, uint32_t l,
                                           uint32_t u, const PairRules& r) {
  const int back = __umulhi(c, 0x1C71C71Du);   // c / 9 for c < 27
  const int move = ch.forced ? ch.prev : back;
  const uint32_t go = ((__funnelshift_r(r.f0, 0u, c) |
                        __funnelshift_r(r.f2, 0u, l)) & 1u) |
                      ((__funnelshift_r(r.e0, 0u, c) |
                        __funnelshift_r(r.e2, 0u, u)) & 4u);
  const bool forced = (go >> move) & 1u;
  uint32_t delta;   // byte ``move`` of r.delta (selector nibbles 4: zero)
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(delta) : "r"(r.delta), "r"(0u),
      "r"(0x4440u | move));
  const uint32_t acc = __funnelshift_r(ch.acc, (uint32_t)move, 2);
  if (kMasked) {
    const bool act = (ch.i | ch.j) >= 0;
    ch.acc = act ? acc : ch.acc;
    ch.words[ch.t >> 4] = (int32_t)ch.acc;
    ch.off = act ? ch.off - delta : ch.off;
    ch.i -= act && move != 0;
    ch.j -= act && move != 2;
    ch.prev = act ? move : ch.prev;
    ch.forced = act ? forced : ch.forced;
    ch.t += act;
  } else {
    ch.acc = acc;
    ch.off -= delta;
    ch.prev = move;
    ch.forced = forced;
    ++ch.t;
  }
}

// The N walks' three codes, all read first, then a step of each.  W is a
// constant where chains_phase is built for the plan's S.
template <int N, bool kMasked>
__device__ __forceinline__ void chains_step(Chain (&ch)[N], int W,
                                            const PairRules& r) {
  uint32_t c[N], l[N], u[N];
#pragma unroll
  for (int x = 0; x < N; ++x) {
    c[x] = tsta::lds_u8(ch[x].off);
    l[x] = tsta::lds_u8(ch[x].off - 1);
    u[x] = tsta::lds_u8(ch[x].off - W);
  }
#pragma unroll
  for (int x = 0; x < N; ++x) chain_step<kMasked>(ch[x], c[x], l[x], u[x], r);
}

// Outside the matrix: left, then up, to the walk's end (RingWalker::phase's
// tail).
__device__ __forceinline__ void run_tail(Walker& w) {
  do {
    const int move = w.j >= 0 ? 0 : 2;
    w.out.put(w.t++, move);
    w.i -= move != 0;
    w.j -= move != 2;
  } while (w.more());
  w.forced = 0;
}

// A phase that N walks (both pairs, or the one left) begin inside the
// matrix: at most S steps of each, walk x from its window at shared
// address win[x] (slot 0 row ra[x], column 0 c0[x]); then the tail of a
// walk that left the matrix.  The steps every walk takes inside the
// matrix for sure (the least of their i and j, down to a multiple of 16)
// run unmasked, 16 of each a body: a body completes one word of each
// walk, at the step k whose move is 16w + 15, and that word is moves k +
// 1 .. k + 16 of the 32 the body and the one before it made, stored after
// the body.  The rest of the phase runs masked.  kW: W built in (the
// plan's S), or 0 to take ``W``.
template <int N, int kW>
__device__ __forceinline__ void chains_phase(Walker* const (&w)[N],
                                             const uint32_t (&win)[N],
                                             const int (&ra)[N],
                                             const int (&c0)[N], int W, int S,
                                             const PairRules& r) {
  if (kW) W = kW;
  Chain ch[N];
  int fast = S;
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int n = w[x]->t & 15;
    ch[x].off = win[x] + (w[x]->i - ra[x]) * W + (w[x]->j - c0[x]);
    ch[x].acc = n ? w[x]->out.acc << (32 - 2 * n) : 0u;
    ch[x].t = w[x]->t;
    ch[x].forced = w[x]->forced > 0;
    ch[x].prev = w[x]->forced - 1;
    ch[x].words = w[x]->out.words;
    fast = min(fast, min(w[x]->i, w[x]->j));
  }
  fast -= fast % kFastUnroll;
  if (fast > 0) {
    int32_t* out[N];   // the word each body completes
    uint32_t shift[N];
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int k = (15 - ch[x].t) & 15;
      out[x] = ch[x].words + ((ch[x].t + k) >> 4);
      shift[x] = 2 * (k + 1);
    }
    for (int s = 0; s < fast; s += kFastUnroll) {
      uint32_t before[N];
#pragma unroll
      for (int x = 0; x < N; ++x) before[x] = ch[x].acc;
#pragma unroll
      for (int v = 0; v < kFastUnroll; ++v) chains_step<N, false>(ch, W, r);
#pragma unroll
      for (int x = 0; x < N; ++x)
        *out[x]++ = (int32_t)__funnelshift_rc(before[x], ch[x].acc, shift[x]);
    }
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {   // still inside the matrix and the window
    const int rel = static_cast<int>(ch[x].off - win[x]);
    ch[x].i = ra[x] + rel / W;
    ch[x].j = c0[x] + rel % W;
  }
  for (int s = fast; s < S; s += kMaskedUnroll) {
#pragma unroll
    for (int v = 0; v < kMaskedUnroll; ++v) chains_step<N, true>(ch, W, r);
    bool any = false;
#pragma unroll
    for (int x = 0; x < N; ++x) any |= (ch[x].i | ch[x].j) >= 0;
    if (!any) break;
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int n = ch[x].t & 15;
    w[x]->i = ch[x].i;
    w[x]->j = ch[x].j;
    w[x]->t = ch[x].t;
    w[x]->forced = ch[x].forced ? ch[x].prev + 1 : 0;
    w[x]->out.acc = n ? ch[x].acc >> (32 - 2 * n) : 0u;
    if (!in_core(*w[x]) && w[x]->more()) run_tail(*w[x]);
  }
}

// chains_phase with W built in for the plan's two phase lengths.
template <int N>
__device__ __forceinline__ void run_phase(Walker* const (&w)[N],
                                          const uint32_t (&win)[N],
                                          const int (&ra)[N],
                                          const int (&c0)[N], int W, int S,
                                          const PairRules& r) {
  if (S == 64)
    chains_phase<N, 2 * 64 + 16>(w, win, ra, c0, W, S, r);
  else if (S == 32)
    chains_phase<N, 2 * 32 + 16>(w, win, ra, c0, W, S, r);
  else
    chains_phase<N, 0>(w, win, ra, c0, W, S, r);
}

// Loader ``lt`` of ``nl``: start its share of the window anchored at (i0,
// j0) of a pair's whole plane into the buffer at shared address ``sbuf``:
// walk_stage's copies, each thread's chunks stepped through without a
// division a copy.
__device__ __forceinline__ void pair_stage(uint32_t sbuf,
                                           const uint8_t* __restrict__ plane,
                                           int m_pad, int n_pad, int S,
                                           int i0, int j0, int lt, int nl) {
  const tsta::WalkWindow w = tsta::walk_window(i0, j0, S, 0, m_pad, n_pad);
  if (w.r1 <= w.r0) return;
  const int W = 2 * S + 16, nq = (w.c1 - w.c0) >> 4;
  const int dr = nl / nq, dq = nl % nq;
  int r = w.r0 + lt / nq, q = lt % nq;
  const uint8_t* src = plane + (size_t)r * n_pad + w.c0;
  uint32_t dst = sbuf + (r - (i0 - 2 * S)) * W;
  while (r < w.r1) {
    tsta::cp_async16(dst + (q << 4), src + (q << 4));
    r += dr;
    src += (size_t)dr * n_pad;
    dst += dr * W;
    q += dq;
    if (q >= nq) {
      q -= nq;
      ++r;
      src += n_pad;
      dst += W;
    }
  }
}

__global__ void __launch_bounds__(tsta::kWalkMaxThreads)
    psa_walk_pair2_kernel(const uint8_t* __restrict__ plane_all,
                          const int32_t* __restrict__ nm, int P, int m_pad,
                          int n_pad, int32_t* __restrict__ words_all,
                          int n_words, int32_t* __restrict__ counts, int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int anchor[2][2][2];   // [pair][parity]: (i, j)
  __shared__ int done[2][2];        // [pair][parity]
  __shared__ int t_end[2];
  const int q = blockIdx.x;
  if (2 * q + 1 >= P) return;
  const int W = 2 * S + 16, win = (2 * S + 1) * W;
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int lt = static_cast<int>(threadIdx.x) - 32;
  const int nl = static_cast<int>(blockDim.x) - 32;
  const uint8_t* plane[2];
  int32_t* words[2];
  uint32_t region[2];   // pair x's window b at region[x] + b * win
  Walker w[2];
  int ai[2], aj[2];     // the anchors of the walker's current windows
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int pair = 2 * q + x;
    plane[x] = plane_all + (size_t)pair * m_pad * n_pad;
    words[x] = words_all + (size_t)pair * n_words;
    region[x] = sbase + x * pair2_region(S) + pair2_guard(S);
    w[x].i = ai[x] = nm[2 * pair + 1] - 1;
    w[x].j = aj[x] = nm[2 * pair] - 1;
    w[x].t = w[x].forced = w[x].base = 0;
    w[x].out.words = words[x];
    w[x].out.acc = 0;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      anchor[x][0][0] = ai[x];
      anchor[x][0][1] = aj[x];
      done[x][0] = done[x][1] = 0;
    }
  }
  const PairRules rules = pair_rules(tsta::walk_step_masks(), W);
  if (lt >= 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
      pair_stage(region[x], plane[x], m_pad, n_pad, S, ai[x], aj[x], lt, nl);
    tsta::cp_async_wait_all();
  }
  __syncthreads();
  for (int k = 0;; ++k) {
    const int cur = k & 1, nxt = (k + 1) & 1;
    if (lt >= 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
        pair_stage(region[x] + nxt * win, plane[x], m_pad, n_pad, S,
                   anchor[x][cur][0], anchor[x][cur][1], lt, nl);
      tsta::cp_async_wait_all();
    } else if (threadIdx.x == 0) {
      const int pi[2] = {w[0].i, w[1].i}, pj[2] = {w[0].j, w[1].j};
      uint32_t at[2];
      int ra[2], c0[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        at[x] = region[x] + cur * win;
        ra[x] = ai[x] - 2 * S;
        c0[x] = tsta::walk_window_c0(aj[x], S);
      }
      if (in_core(w[0]) && in_core(w[1])) {
        Walker* const both[2] = {&w[0], &w[1]};
        run_phase<2>(both, at, ra, c0, W, S, rules);
      } else {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (in_core(w[x])) {
            Walker* const one[1] = {&w[x]};
            const uint32_t at1[1] = {at[x]};
            const int ra1[1] = {ra[x]}, c01[1] = {c0[x]};
            run_phase<1>(one, at1, ra1, c01, W, S, rules);
          } else if (w[x].more()) {
            run_tail(w[x]);   // a walk that begins outside the matrix
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        anchor[x][nxt][0] = w[x].i;
        anchor[x][nxt][1] = w[x].j;
        done[x][cur] = !w[x].more();
        ai[x] = pi[x];   // the next window is anchored where this phase began
        aj[x] = pj[x];
      }
    }
    __syncthreads();
    if (done[0][cur] && done[1][cur]) break;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      words[x][w[x].t >> 4] = (int32_t)w[x].out.acc;
      counts[2 * q + x] = w[x].t;
      t_end[x] = w[x].t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < 2; ++x)
    for (int k = (t_end[x] >> 4) + 1 + threadIdx.x; k < n_words;
         k += blockDim.x)
      words[x][k] = 0;
}

}  // namespace

// Bytes of dynamic shared memory the two-pair walk takes at phase length
// S: each pair's guard and two windows.
extern "C" int tsta_psa_walk_pair2_bytes(int S) { return 2 * pair2_region(S); }

// plane: (P, m_pad, n_pad) uint8 codes, P even and >= 2, n_pad a multiple
// of 16; nm: (P, 2) int32 real (n, m); words: (P, n_words) int32; counts:
// (P,) int32; S: steps a phase, a multiple of 8 up to kPair2MaxS whose
// four windows fit a block; threads: a block's, a multiple of 32 in [64,
// 256].  The plan is K3's (tsta_psa_walk_layout): the sweep of S in {32,
// 64} and 128, 192 or 256 threads on an H100 (tools/psa_walk_ab.py
// --sweep) found its rule the fastest here too, on the 32 x 10 kbp plane
// and on a traced batch of 4,096 short pairs.  Returns the CUDA error of
// the checks, the shared-memory attribute or the launch
// (cudaGetLastError()).
extern "C" int tsta_psa_walk_pair2(const void* plane, const void* nm, int P,
                                   int m_pad, int n_pad, void* words,
                                   int n_words, void* counts, int S,
                                   int threads, void* stream) {
  if (P < 2 || P % 2 != 0 || S > kPair2MaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = tsta::walk_ring_prepare(psa_walk_pair2_kernel, S, threads, n_pad,
                                   plane, nullptr);
  if (rc) return rc;
  const int bytes = tsta_psa_walk_pair2_bytes(S);
  if (bytes > 48 * 1024) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        psa_walk_pair2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes));
    if (rc) return rc;
  }
  psa_walk_pair2_kernel<<<P / 2, threads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), static_cast<const int32_t*>(nm), P,
      m_pad, n_pad, static_cast<int32_t*>(words), n_words,
      static_cast<int32_t*>(counts), S);
  return static_cast<int>(cudaGetLastError());
}
