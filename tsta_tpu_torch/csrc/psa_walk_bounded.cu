// PSA traceback walk inside one row-chunk of a single pair's code plane,
// one thread.
//
// Replaces the TPU kernel tsta_tpu/ops/traceback.py:_walk_kernel_bounded
// (Q2-8, launched through _bounded_banded_ops, :958).  The chunked traced
// path (ops/psa_chunked.py) keeps one chunk's plane at a time: rows
// [base, base + rows) of the pair, rematerialised by psa_dp_traced.cu at
// one pair.  This kernel walks from (i, j, forced) with the step rules of
// psa_walk_step.cuh until the walk leaves the chunk (i < base), or, in the
// chunk at base 0, until it is done (i < 0 and j < 0).  The e code of the
// cell above the chunk's first row comes from ``prev_row``, the codes of
// row base - 1 (the previous chunk's last row).  Outside the matrix the
// walk goes left while j >= 0, then up.  Step t writes its move (1 diag,
// 0 left, 2 up) to moves[t] of the pair's (m + n) int8 buffer; the exit
// state (i, j, t, forced) goes to out[0..3], which the host reads to pick
// the next chunk.
//
// The TPU walk stages a band of the plane in SMEM by DMA and logs its
// moves in a CAP-bounded SMEM buffer that the host loop scatters and
// re-enters; here the thread reads the plane through L1/L2 and writes
// each move to device memory, so there is no band, no log and no early
// exit.
//
// What bounds it on the H100: one dependent load per step (the three
// codes of a step are read together), mostly an L2 hit (a diagonal step
// moves to the row above, which the previous step's up read touched),
// times the steps in the chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_step.cuh"

namespace {

__global__ void psa_walk_bounded_kernel(const uint8_t* __restrict__ plane,
                                        const uint8_t* __restrict__ prev_row,
                                        int n_pad, int base, int i, int j,
                                        int t, int forced,
                                        int8_t* __restrict__ moves,
                                        int32_t* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  while ((i >= 0 || j >= 0) && (i >= base || (base == 0 && j >= 0))) {
    int move, next = 0;
    if (i >= 0 && j >= 0) {
      const uint8_t* cell = plane + (size_t)(i - base) * n_pad + j;
      const int left = j > 0 ? cell[-1] : 0;
      const int up = i > base ? cell[-n_pad] : (i > 0 ? prev_row[j] : 0);
      move = tsta::psa_walk_step(cell[0], left, up, i, j, forced, next);
    } else {
      move = j >= 0 ? 0 : 2;
    }
    moves[t++] = static_cast<int8_t>(move);
    i -= move != 0;
    j -= move != 2;
    forced = next;
  }
  out[0] = i;
  out[1] = j;
  out[2] = t;
  out[3] = forced;
}

}  // namespace

// plane: (rows, n_pad) uint8 codes of the pair's rows [base, base + rows);
// prev_row: (n_pad,) uint8 codes of row base - 1 (zeros at base 0); the
// walk enters at (i, j) with t moves already made and ``forced`` carried;
// moves: the pair's int8 move buffer; out: (4,) int32 exit (i, j, t,
// forced).  Returns cudaGetLastError() after the launch.
extern "C" int tsta_psa_walk_bounded(const void* plane, const void* prev_row,
                                     int n_pad, int base, int i, int j,
                                     int t, int forced, void* moves,
                                     void* out, void* stream) {
  psa_walk_bounded_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane),
      static_cast<const uint8_t*>(prev_row), n_pad, base, i, j, t, forced,
      static_cast<int8_t*>(moves), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
