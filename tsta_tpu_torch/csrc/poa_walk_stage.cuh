// The window ring of the POA traceback walks (poa_walk.cu, Q2-5;
// poa_walk_bounded.cu, Q2-6's walk): the part of the 16-bit word plane
// and of the pred table a walk is about to enter, staged in shared memory
// while the walk runs.
//
// A POA walk is one serial chain of moves.  A move reads the word of the
// cell (row, j), then, for a diagonal (state H) or a gap in the graph
// (state E), the pred its field names, preds[row, idx], which picks the
// next row: two dependent loads.  Read from device memory, the word of a
// round's plane (GBs) misses L2 after each diagonal, ~255 ns a move.
// Here one thread (the walker, thread 0) reads both from shared memory,
// and warps 1.. (the loaders) copy the plane and the preds into it ahead
// of the walk with cp.async, 16 bytes a thread.
//
// A move lowers j by at most one and moves the row to a pred, at most
// maxdist rows up (prepare's largest pred distance).  The walk runs in
// phases of at most S moves.  While phase k walks window k (anchored where
// phase k - 1 began; phases 0 and 1's at the entry), the loaders fill
// window k + 1, anchored at (r0, j0) where phase k began, into the other
// buffer; one __syncthreads ends the phase.  The window anchored at (r0,
// j0) is R rows, [r0 - R + 1, r0] (slot 0 = row r0 - R + 1), by 2S + 8
// columns from c0 = j0 - 2S aligned down to 8 words (16 bytes), clipped to
// the plane (msa_poa.poa_walk_window in Python), with the preds of those
// rows.  The 2S moves after an anchor stay in it when R >= 2S * maxdist;
// the plan (_kernels.poa_walk_plan) takes less where maxdist is large,
// since most moves go up one or two rows.  A move outside the current
// window reads its word and pred from device memory (__ldg) and counts a
// miss, so the result never depends on R (R = 0: every move misses); a
// long jump misses for the rest of its phase and the next, whose window is
// still anchored before the jump.  The CPU tests replay this schedule
// (msa_poa.poa_walk_staged_plain) and assert that every read the walker
// takes from a window was staged there.
//
// Each block keeps its own phases, and every thread reaches every
// barrier: the walker publishes the next anchor and a done flag before the
// barrier, each in one of two slots by the phase's parity (as
// psa_walk_stage.cuh's ring).
//
// The move is the chain, so it is kept short (on an H100: ~200 ns
// a move with the pred a second dependent load and the window test a
// branch before the loads, ~85 ns as it is): the word (ld.shared.u16) and
// all the preds of its row (one ld.shared.v4 for max_in <= 4, two for 8)
// are loaded together, at a row and column clamped into the buffer, before
// the test that the move is in the window; the pred the word names is a
// select, the state rules of msa_native's walk are selects with no branch
// (an H cell whose word names a gap switches to E or F and takes that move
// on the same word, since the next step would read the same cell), and the
// align store is off the chain.  Wider pred tables (max_in 16-64) load the
// pred once the word is in.
//
// Shared memory: two buffers of R (at least one) x (2S + 8) words and R *
// max_in + 8 preds (180 KB at the plan's S = 64, R = 320, max_in 4).  The
// copies are 16 bytes, so the plane's width must be a multiple of 8 words,
// the pred table a multiple of 4 ints and both 16-byte aligned:
// poa_walk_prepare refuses anything else.  The block is 64 to 256 threads:
// the walker's warp and one to seven loader warps.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_stage.cuh"   // cp_async16, cp_async_wait_all

namespace tsta {

constexpr int kPoaWalkMinThreads = 64, kPoaWalkMaxThreads = 256;

// Bytes of the word rows of a window buffer: R rows of 2S + 8 words, at
// least one (the walker's clamped loads stay inside it at R = 0).
inline __host__ __device__ int poa_walk_word_bytes(int S, int R) {
  return (R > 1 ? R : 1) * (2 * S + 8) * 2;
}

// Bytes of one window buffer: the word rows, then the preds of those
// rows, rounded out to whole 16-byte copies.
inline __host__ __device__ int poa_walk_buf_bytes(int S, int R, int max_in) {
  return poa_walk_word_bytes(S, R) + (R * max_in + 8) * 4;
}

struct PoaWindow {
  int lo, hi, c0, c1;   // plane rows [lo, hi), columns [c0, c1)
};

__device__ __forceinline__ int poa_window_c0(int j0, int S) {
  return max(j0 - 2 * S, 0) & ~7;
}

// msa_poa.poa_walk_window: the window anchored at (r0, j0), clipped to
// the plane's rows [0, rows) and columns [0, cols); empty outside it.
__device__ __forceinline__ PoaWindow poa_walk_window(int r0, int j0, int S,
                                                     int R, int rows,
                                                     int cols) {
  PoaWindow w;
  w.c0 = poa_window_c0(j0, S);
  w.c1 = min(w.c0 + 2 * S + 8, cols);
  const bool in = r0 >= 0 && r0 < rows && j0 >= 0 && j0 < cols;
  w.hi = in ? r0 + 1 : 0;
  w.lo = in ? max(r0 - R + 1, 0) : 0;
  return w;
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The preds of one row, V of them (1, 2, 4 or 8), loaded together from
// shared memory: 4, 8 or 16-byte aligned in the window (rows of V ints
// from a 16-byte aligned base).
template <int V>
struct PredRow {
  int v[V];
  __device__ __forceinline__ void load(uint32_t addr) {
    if constexpr (V == 1) {
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v[0]) : "r"(addr));
    } else if constexpr (V == 2) {
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                   : "=r"(v[0]), "=r"(v[1])
                   : "r"(addr));
    } else {
#pragma unroll
      for (int q = 0; q < V; q += 4)
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[q]), "=r"(v[q + 1]), "=r"(v[q + 2]),
                       "=r"(v[q + 3])
                     : "r"(addr + 4 * q));
    }
  }
  // v[idx] by selects on idx's low bits, no indexed (local) access
  __device__ __forceinline__ int pick(uint32_t idx) const {
    int a[V];
#pragma unroll
    for (int q = 0; q < V; ++q) a[q] = v[q];
#pragma unroll
    for (int half = V / 2, bit = 1; half >= 1; half /= 2, bit *= 2) {
#pragma unroll
      for (int q = 0; q < half; ++q)
        a[q] = (idx & bit) ? a[2 * q + 1] : a[2 * q];
    }
    return a[0];
  }
};

// The first pred of the window's buffer: row rb = r0 - R + 1's first,
// rounded down to a 16-byte copy (rb may be negative).
__device__ __forceinline__ int poa_pred_base(int r0, int R, int max_in) {
  return ((r0 - R + 1) * max_in) & ~3;
}

// Loader ``lt`` of ``nl``: start its share of the window anchored at
// (r0, j0) into the buffer at shared address ``sbuf``.
__device__ __forceinline__ void poa_walk_stage(
    uint32_t sbuf, const uint16_t* __restrict__ words,
    const int32_t* __restrict__ preds, int rows, int cols, int max_in,
    int S, int R, int r0, int j0, int lt, int nl) {
  const PoaWindow w = poa_walk_window(r0, j0, S, R, rows, cols);
  if (w.hi <= w.lo) return;
  const int Wc = 2 * S + 8, rb = r0 - R + 1;
  const int nq = (w.c1 - w.c0) >> 3, nr = w.hi - w.lo;
  for (int k = lt; k < nr * nq; k += nl) {
    const int r = w.lo + k / nq, q = (k % nq) << 3;
    cp_async16(sbuf + ((r - rb) * Wc + q) * 2,
               words + (size_t)r * cols + w.c0 + q);
  }
  const uint32_t pbuf = sbuf + poa_walk_word_bytes(S, R);
  const int fb = poa_pred_base(r0, R, max_in);
  const int f1 = min((w.hi * max_in + 3) & ~3, rows * max_in);
  for (int f = ((w.lo * max_in) & ~3) + 4 * lt; f < f1; f += 4 * nl)
    cp_async16(pbuf + (f - fb) * 4, preds + f);
}

// A move outside the window: its word and, for a diagonal or an E move,
// the pred it names, from device memory through the read-only path (the
// plane and the preds were written by earlier launches; neighbouring rows'
// preds share a line, so a run of misses mostly finds its pred in L1),
// packed (pred << 32 | word).
__device__ __forceinline__ uint64_t poa_walk_miss(
    const uint16_t* __restrict__ words, const int32_t* __restrict__ preds,
    int row, int j, int cols, int max_in, int state) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned short*>(words) +
                           (size_t)row * cols + j);
  const uint32_t st = state == 0 ? (w >> 2) & 3u : (uint32_t)state;
  const int f = row * max_in + (int)((w >> (st == 0 ? 4 : 10)) & 63u);
  const int p = st < 2 ? __ldg(preds + f) : 0;
  return (uint64_t)(uint32_t)p << 32 | w;
}

// The walk's state, in the plane's own coordinates (row - base, j -
// col0), and its step loop, for one thread.  Exits when the walk leaves
// the plane: row < 0 (the virtual row) or j < 0 end a single call's walk;
// a cell's bounds end a bounded walk (poa_walk_bounded.cu's loop
// condition).  align[j + col0] gets row + base for a diagonal, -1 for a
// gap in the graph's row (F).  V: the preds a row has (max_in) when it is
// at most 8, all loaded with the word, so the pred the word names is a
// select and not a second dependent load; 0 for wider tables, whose pred
// is loaded once the word is in.
template <int V>
struct PoaWalker {
  int row, j, state;
  int steps, pred_moves, misses;
  int base, col0, rows, cols, max_in;
  const uint16_t* __restrict__ words;
  const int32_t* __restrict__ preds;
  int32_t* __restrict__ align;

  __device__ __forceinline__ bool inside() const {
    return (unsigned)row < (unsigned)rows && (unsigned)j < (unsigned)cols;
  }

  // One move from word ``w`` of (row, j); ``rh`` and ``re`` are the
  // rows (the plane's) of the preds its diagonal and E fields name.
  __device__ __forceinline__ void move(uint32_t w, int rh, int re,
                                       int32_t* __restrict__ al) {
    // x >> 2 is the move type: H takes its word's (0 diagonal, 1 E, 2 or 3
    // F), E and F keep theirs
    const uint32_t x = (w & (state == 0 ? 12u : 0u)) | (uint32_t)state << 2;
    const bool diag = x == 0, emove = x == 4;
    pred_moves += diag | emove;
    if (!emove) al[j] = diag ? row + base : -1;
    state = diag ? 0 : (emove ? (int)((w >> 1) & 1u) : (int)((w & 1u) << 1));
    row = diag ? rh : (emove ? re : row);
    j -= !emove;
    ++steps;
  }

  // At most S moves from the window at shared address ``win`` anchored at
  // (r0, j0); true when the walk has left the plane.  Each move loads its
  // word and its row's preds from the window first, at a row and column
  // clamped into the buffer (so any position gives an address inside it),
  // then tests whether (row, j) is in the window (clipped to the plane, so
  // inside it too); a move outside it either leaves the plane or reads
  // device memory instead (a miss).  The loads so never wait on the
  // test.
  __device__ __forceinline__ bool phase(uint32_t win, int r0, int j0,
                                        int S, int R) {
    const int Wc = 2 * S + 8, rb = r0 - R + 1, c0 = poa_window_c0(j0, S);
    const int rlo = max(rb, 0);
    const unsigned nr = R > 0 && r0 >= 0 && r0 < rows && j0 >= 0 && j0 < cols
                            ? (unsigned)(r0 + 1 - rlo) : 0u;
    const unsigned nc = (unsigned)(min(c0 + Wc, cols) - c0);
    const unsigned rlim = (unsigned)max(R - 1, 0), clim = (unsigned)(Wc - 1);
    // row slot rc's preds at pbase + 4 * max_in * rc (the buffer's preds
    // start at row rb's first, rounded down to a 16-byte copy)
    const uint32_t pbase = win + poa_walk_word_bytes(S, R) +
        4u * (uint32_t)(rb * max_in - poa_pred_base(r0, R, max_in));
    const int off = 1 + base;   // a pred's buffer row id -> the plane's row
    int32_t* const al = align + col0;
#pragma unroll 2
    for (int s = 0; s < S; ++s) {
      const unsigned rc = min((unsigned)(row - rb), rlim);
      const unsigned jc = min((unsigned)(j - c0), clim);
      uint32_t w = lds_u16(win + rc * (2u * Wc) + 2u * jc);
      int rh = 0, re = 0;
      if constexpr (V > 0) {
        PredRow<V> pr;
        pr.load(pbase + 4u * V * rc);
#pragma unroll
        for (int q = 0; q < V; ++q) pr.v[q] -= off;
        rh = pr.pick((w >> 4) & 63u);
        re = pr.pick((w >> 10) & 63u);
      }
      if (__builtin_expect(
              !((unsigned)(row - rlo) < nr && (unsigned)(j - c0) < nc), 0)) {
        if (!inside()) return true;
        const uint64_t wp =
            poa_walk_miss(words, preds, row, j, cols, max_in, state);
        w = (uint32_t)wp;
        rh = re = (int)(wp >> 32) - off;
        ++misses;
      } else if constexpr (V == 0) {
        const uint32_t st = state == 0 ? (w >> 2) & 3u : (uint32_t)state;
        const uint32_t idx = (w >> (st == 0 ? 4 : 10)) & (max_in - 1);
        PredRow<1> pr = {{0}};
        if (st < 2) pr.load(pbase + 4u * (rc * max_in + idx));
        rh = re = pr.v[0] - off;
      }
      move(w, rh, re, al);
    }
    return !inside();
  }
};

// Run ``wk`` (meaningful in thread 0; every thread of the block calls
// this, each with the entry position) on the window ring.  ``smem``:
// 2 * poa_walk_buf_bytes(S, R, max_in) bytes of dynamic shared memory,
// 16-byte aligned.  counts[0..3] = (moves, pred moves, misses, phases).
//
// Phase k ends at barrier k.  The walker publishes the next anchor and
// the done flag in slot (k + 1) & 1 and k & 1 before it, and every thread
// reads them after it: double-buffered, because the walker may reach
// phase k + 1's writes while a slower thread still reads phase k's.
template <int V>
__device__ __forceinline__ void poa_walk_ring(PoaWalker<V>& wk, int S, int R,
                                              uint8_t* smem,
                                              int32_t* __restrict__ counts) {
  __shared__ int anchor[2][2];
  __shared__ int done[2];
  const int buf = poa_walk_buf_bytes(S, R, wk.max_in);
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int lt = static_cast<int>(threadIdx.x) - 32;
  const int nl = static_cast<int>(blockDim.x) - 32;
  int ai = wk.row, aj = wk.j;   // the anchor of the walker's window
  if (threadIdx.x == 0) {
    anchor[0][0] = ai;
    anchor[0][1] = aj;
    done[0] = done[1] = 0;
  }
  if (lt >= 0) {
    poa_walk_stage(sbase, wk.words, wk.preds, wk.rows, wk.cols, wk.max_in,
                   S, R, ai, aj, lt, nl);
    cp_async_wait_all();
  }
  __syncthreads();
  int k = 0;
  for (;; ++k) {
    if (lt >= 0) {
      poa_walk_stage(sbase + ((k + 1) & 1) * buf, wk.words, wk.preds,
                     wk.rows, wk.cols, wk.max_in, S, R, anchor[k & 1][0],
                     anchor[k & 1][1], lt, nl);
      cp_async_wait_all();
    } else if (threadIdx.x == 0) {
      const int pi = wk.row, pj = wk.j;   // where this phase begins
      const bool fin = wk.phase(sbase + (k & 1) * buf, ai, aj, S, R);
      anchor[(k + 1) & 1][0] = wk.row;
      anchor[(k + 1) & 1][1] = wk.j;
      if (fin) done[k & 1] = 1;
      ai = pi;   // the next window is anchored where this phase began
      aj = pj;
    }
    __syncthreads();
    if (done[k & 1]) break;
  }
  if (threadIdx.x == 0) {
    counts[0] = wk.steps;
    counts[1] = wk.pred_moves;
    counts[2] = wk.misses;
    counts[3] = k + 1;
  }
}

// Check a walk launch and set the dynamic shared memory its kernel may
// take: S a multiple of 8, R >= 0, ``threads`` a multiple of 32 in
// [kPoaWalkMinThreads, kPoaWalkMaxThreads], the plane's width a multiple
// of 8 words, the pred table's size a multiple of 4 ints and both 16-byte
// aligned (the copies' unit).  Returns a CUDA error code (0 on success).
template <class Kernel>
inline int poa_walk_prepare(Kernel kernel, int S, int R, int threads,
                            int rows, int cols, int max_in,
                            const void* words, const void* preds) {
  if (S < 8 || S % 8 || R < 0 || threads % 32 ||
      threads < kPoaWalkMinThreads || threads > kPoaWalkMaxThreads ||
      cols % 8 || (rows * max_in) % 4 ||
      reinterpret_cast<uintptr_t>(words) % 16 ||
      reinterpret_cast<uintptr_t>(preds) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 2 * poa_walk_buf_bytes(S, R, max_in);
  if (bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  return 0;
}

}  // namespace tsta
