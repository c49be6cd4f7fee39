// The window ring of the PSA traceback walks (psa_walk.cu, K3 and Q2-16;
// psa_walk_bounded.cu, Q2-8): the part of the code plane a walk is about
// to enter, staged in shared memory while the walk runs.
//
// A walk is one serial chain: each step's reads (the cell's code, the f
// code of the cell to its left, the e code of the cell above) depend on the
// step before.  Read from device memory, a diagonal step's `up` read
// misses L2 (the plane is GBs), so a step costs a DRAM round trip.  Here
// one thread (the walker, thread 0) reads its codes from shared memory,
// and warps 1.. (the loaders) copy the plane into it ahead of the walk
// with cp.async, 16 bytes a thread.
//
// Each step lowers i, j or both by one, so the 2S steps after an anchor
// (i0, j0) read only rows [i0 - 2S, i0] and columns [j0 - 2S, j0]: the
// window anchored there is those 2S + 1 rows (slot 0 = row i0 - 2S) by
// 2S + 16 columns from c0 = j0 - 2S aligned down to 16, clipped to the
// plane (traceback.walk_window in Python; the CPU tests replay this
// schedule with traceback.walk_staged_plain and assert that no read falls
// outside).  The walk runs in phases of at most S steps in the matrix.
// While phase k walks window k (anchored where phase k - 1 began; phase 0
// in window 0, anchored at the entry), the loaders fill window k + 1,
// anchored where phase k began, into the other buffer; one __syncthreads
// ends the phase.  Each block keeps its own phases (no grid-wide sync),
// and every thread reaches every barrier: the walker publishes its
// position for the loaders and a done flag before the barrier, each in one
// of two slots by the phase's parity, so no thread still reading phase k's
// slot meets phase k + 1's write.  Outside the matrix a walk
// reads nothing, so it runs to its end in the phase where it leaves.  In a
// row-chunk (base > 0) the slot of row base - 1 is staged from prev_row,
// the previous chunk's last row; no row outside the chunk is read from the
// chunk's plane.
//
// The step itself is kept short, since it is the chain: the walker reads
// its three codes with ld.shared at a running 32-bit offset and applies
// psa_walk_step's rules through bit masks read off psa_walk_step itself
// (walk_step_masks), with no branch.  As compiled, psa_walk_step's
// divisions by 9 and 3 and its branches made a step ~12 dependent
// instructions, and a generic pointer re-derived the shared window's
// address every step.  (Loaders that decode each staged cell into one byte
// for the walker made them the bottleneck: the decode grows with the
// window's area, the walk with its side.)
//
// Shared memory: two windows of (2S + 1) x (2S + 16) bytes, dynamic (~37
// KB at S = 64, ~140 KB at S = 128, above 48 KB after
// cudaFuncSetAttribute).  The copies are 16 bytes, so the plane's rows (and
// prev_row) must be 16-byte aligned: n_pad a multiple of 16, as every
// route's is (a multiple of 128); walk_ring_prepare refuses anything else.
//
// The block is 64 to 256 threads (a launch parameter): the walker's warp
// and one to seven loader warps (psa_walk.cu's plan; the bounded walk
// takes 256).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_step.cuh"

namespace tsta {

// threads a block: warp 0 the walker, warps 1.. the loaders
constexpr int kWalkMinThreads = 64, kWalkMaxThreads = 256;

// Bytes of dynamic shared memory for phase length S: the two windows.
inline int walk_ring_bytes(int S) { return 2 * (2 * S + 1) * (2 * S + 16); }

struct WalkWindow {
  int r0, r1, c0, c1;   // plane rows [r0, r1), columns [c0, c1)
};

__device__ __forceinline__ int walk_window_c0(int j0, int S) {
  return max(j0 - 2 * S, 0) & ~15;
}

// traceback.walk_window: the window anchored at (i0, j0), clipped to rows
// [row_lo, row_lo + rows) and columns [0, n_pad); empty outside the matrix.
__device__ __forceinline__ WalkWindow walk_window(int i0, int j0, int S,
                                                  int row_lo, int rows,
                                                  int n_pad) {
  WalkWindow w;
  w.r0 = max(i0 - 2 * S, row_lo);
  w.r1 = j0 >= 0 ? max(w.r0, min(i0 + 1, row_lo + rows)) : w.r0;
  w.c0 = walk_window_c0(j0, S);
  w.c1 = min(w.c0 + 2 * S + 16, n_pad);
  return w;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loader ``lt`` of ``nl``: start its share of the window anchored at (i0,
// j0) into the buffer at shared address ``sbuf``.  ``plane`` holds rows
// [row_lo, row_lo + rows); at row_lo > 0 ``prev_row`` holds row row_lo - 1.
__device__ __forceinline__ void walk_stage(uint32_t sbuf,
                                           const uint8_t* __restrict__ plane,
                                           const uint8_t* __restrict__ prev_row,
                                           int row_lo, int rows, int n_pad,
                                           int S, int i0, int j0, int lt,
                                           int nl) {
  const WalkWindow w = walk_window(i0, j0, S, row_lo, rows, n_pad);
  if (w.r1 <= w.r0) return;
  const int W = 2 * S + 16, ra = i0 - 2 * S;
  // the slot of row row_lo - 1: the previous chunk's last row
  const int first = row_lo > 0 && w.r0 == row_lo && ra <= row_lo - 1
                        ? row_lo - 1 : w.r0;
  const int nr = w.r1 - first, nq = (w.c1 - w.c0) >> 4;
  for (int k = lt; k < nr * nq; k += nl) {
    const int r = first + k / nq, q = (k % nq) << 4;
    const uint8_t* src =
        r < row_lo ? prev_row + w.c0 + q
                   : plane + (size_t)(r - row_lo) * n_pad + w.c0 + q;
    cp_async16(sbuf + (r - ra) * W + q, src);
  }
}

// The step rules as bit masks over the 27 cell codes, read off
// psa_walk_step itself: the back code's two bits (the move when nothing is
// forced); f0 / e0, the cell's own f / e code continues a left / up gap run
// (extend); f2 / e2, the entered cell's f / e code does (an open with a
// tie).  A left move forces the next move left when j > 0 and (f0 of the
// cell or f2 of the cell to its left), an up move likewise with e codes:
// psa_walk_step's two conditions.
struct StepMasks {
  uint32_t b0, b1, f0, f2, e0, e2;
};

__device__ __forceinline__ StepMasks walk_step_masks() {
  StepMasks m = {0, 0, 0, 0, 0, 0};
  for (int c = 0; c < 27; ++c) {
    int nx;
    const uint32_t back = psa_walk_step(c, 0, 0, 1, 1, 0, nx);
    m.b0 |= (back & 1u) << c;
    m.b1 |= (back >> 1) << c;
    psa_walk_step(c, 0, 0, 1, 1, 1, nx);   // forced left, left f code 0
    m.f0 |= (uint32_t)(nx == 1) << c;
    psa_walk_step(3, c, 0, 1, 1, 1, nx);   // code 3: f code 1, an open
    m.f2 |= (uint32_t)(nx == 1) << c;
    psa_walk_step(c, 0, 0, 1, 1, 3, nx);   // forced up, up e code 0
    m.e0 |= (uint32_t)(nx == 3) << c;
    psa_walk_step(1, 0, c, 1, 1, 3, nx);   // code 1: e code 1, an open
    m.e2 |= (uint32_t)(nx == 3) << c;
  }
  return m;
}

// Bit ``c`` of ``m``; 0 for any c >= 32 (a code past 26 is never a cell a
// walk decodes: the real matrix holds the DP's codes).
__device__ __forceinline__ uint32_t mask_bit(uint32_t m, uint32_t c) {
  return __funnelshift_rc(m, 0u, c) & 1u;
}

// The walk's state and its step loop, for one thread.  ``Out::put(t,
// move)`` records move t.  Exits when the walk is done, or, in a chunk at
// base > 0, when it leaves the chunk (i < base): psa_walk_bounded.cu's
// loop condition, which at base 0 is K3's (i < 0 and j < 0).
template <class Out>
struct RingWalker {
  int i, j, t, forced, base;
  Out out;

  __device__ __forceinline__ bool more() const {
    return (i >= 0 || j >= 0) && (i >= base || (base == 0 && j >= 0));
  }

  // At most S steps in the matrix from the window at shared address
  // ``win`` whose slot 0 is row ``ra`` and whose column 0 is ``c0``; true
  // when the walk is over.  A step reads its three codes together; the
  // move and the next forced move follow psa_walk_step through ``m``,
  // without branches, and the cell's offset moves with the walk.
  __device__ __forceinline__ bool phase(uint32_t win, int ra, int c0, int W,
                                        int S, const StepMasks& m) {
    uint32_t off = win + (i - ra) * W + (j - c0);
    for (int s = 0; s < S; ++s) {
      if (i < base || j < 0) {   // left the chunk, or outside the matrix
        if (!more()) return true;
        do {   // outside the matrix: left, then up
          const int move = j >= 0 ? 0 : 2;
          out.put(t++, move);
          i -= move != 0;
          j -= move != 2;
        } while (more());
        forced = 0;
        return true;
      }
      const uint32_t c = lds_u8(off), l = lds_u8(off - 1),
                     u = lds_u8(off - W);
      const int back = mask_bit(m.b0, c) | mask_bit(m.b1, c) << 1;
      const int move = forced > 0 ? forced - 1 : back;
      const int go_left = j > 0 && (mask_bit(m.f0, c) | mask_bit(m.f2, l));
      const int go_up = i > 0 && (mask_bit(m.e0, c) | mask_bit(m.e2, u));
      out.put(t++, move);
      forced = move == 0 ? go_left : (move == 2 ? 3 * go_up : 0);
      i -= move != 0;
      j -= move != 2;
      off -= (move != 0 ? W : 0) + (move != 2);
    }
    return !more();
  }
};

// Run ``wk`` (meaningful in thread 0; every thread of the block calls
// this) over ``plane`` on the window ring.  ``smem``: walk_ring_bytes(S)
// bytes of dynamic shared memory, 16-byte aligned; S a multiple of 8.
//
// Phase k ends at barrier k.  The walker publishes the next anchor and
// the done flag in slot (k + 1) & 1 and k & 1 before it, and every thread
// reads them after it: double-buffered, because the walker may reach
// phase k + 1's writes while a slower thread still reads phase k's.
template <class Walker>
__device__ void walk_ring(Walker& wk, const uint8_t* __restrict__ plane,
                          const uint8_t* __restrict__ prev_row, int row_lo,
                          int rows, int n_pad, int S, uint8_t* smem) {
  __shared__ int anchor[2][2];
  __shared__ int done[2];
  const int W = 2 * S + 16, win = (2 * S + 1) * W;   // window b at b * win
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int lt = static_cast<int>(threadIdx.x) - 32;
  const int nl = static_cast<int>(blockDim.x) - 32;
  int ai = wk.i, aj = wk.j;   // the anchor of the walker's current window
  if (threadIdx.x == 0) {
    anchor[0][0] = ai;
    anchor[0][1] = aj;
    done[0] = done[1] = 0;
  }
  const StepMasks masks = walk_step_masks();
  if (lt >= 0) {
    walk_stage(sbase, plane, prev_row, row_lo, rows, n_pad, S, ai, aj, lt,
               nl);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int k = 0;; ++k) {
    if (lt >= 0) {
      walk_stage(sbase + ((k + 1) & 1) * win, plane, prev_row, row_lo, rows,
                 n_pad, S, anchor[k & 1][0], anchor[k & 1][1], lt, nl);
      cp_async_wait_all();
    } else if (threadIdx.x == 0) {
      const int pi = wk.i, pj = wk.j;   // where this phase begins
      const bool fin = wk.phase(sbase + (k & 1) * win, ai - 2 * S,
                                walk_window_c0(aj, S), W, S, masks);
      anchor[(k + 1) & 1][0] = wk.i;
      anchor[(k + 1) & 1][1] = wk.j;
      if (fin) done[k & 1] = 1;
      ai = pi;   // the next window is anchored where this phase began
      aj = pj;
    }
    __syncthreads();
    if (done[k & 1]) break;
  }
}

// Check a walk launch and set the dynamic shared memory its kernel may
// take for phase length S: S a multiple of 8, ``threads`` a multiple of 32
// in [kWalkMinThreads, kWalkMaxThreads], n_pad a multiple of 16 and the
// planes 16-byte aligned (the copies' unit).  Returns a CUDA error code (0
// on success).
template <class Kernel>
inline int walk_ring_prepare(Kernel kernel, int S, int threads, int n_pad,
                             const void* plane, const void* prev_row) {
  if (S < 8 || S % 8 || threads % 32 || threads < kWalkMinThreads ||
      threads > kWalkMaxThreads || n_pad % 16 ||
      reinterpret_cast<uintptr_t>(plane) % 16 ||
      reinterpret_cast<uintptr_t>(prev_row) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = walk_ring_bytes(S);
  if (bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  return 0;
}

}  // namespace tsta
