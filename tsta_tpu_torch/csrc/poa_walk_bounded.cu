// POA traceback walk inside one cell of a chunked round, one thread.
//
// Replaces the TPU kernel
// tsta_tpu/ops/msa_pallas.py:_poa_walk_bounded_kernel (launched through
// _walk_bounded_banded_ops, :892).  The chunked round's backward keeps one
// (chunk, column window) cell of the word plane at a time: rows [base,
// base + nc) and columns [col0, col0 + cw), rematerialised by poa_dp.cu.
// This kernel runs the 3-state walk of poa_walk.cu from (row, j, state)
// until the walk leaves the cell (row < base, row >= base + nc, j < col0
// or j >= col0 + cw; the TPU cond at :816-820), or ends (row < 0, j < 0,
// both outside any cell).  Each consumed column j gets align[j] = row for
// a diagonal step, -1 for a gap, in the round's (n,) align tensor; the
// state the walk left in goes to out[0..2] = (row, j, state), which the
// host reads to choose the next cell.
//
// The TPU version logs consumed columns into a CAP-bounded SMEM buffer
// and scatters them afterwards, since an n-wide SMEM row does not fit;
// here the thread writes align[j] in device memory directly, so there is
// no log and no early exit.
//
// What bounds it on the H100: one dependent load per step, mostly an L2
// or device-memory miss (a diagonal step moves to another row of the
// cell, cw*2 bytes away), times the steps in the cell.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void poa_walk_bounded_kernel(const uint16_t* __restrict__ words,
                                        const int32_t* __restrict__ preds,
                                        int nc, int cw, int max_in, int row,
                                        int j, int state, int base, int col0,
                                        int32_t* __restrict__ align,
                                        int32_t* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  while (row >= base && row < base + nc && j >= col0 && j < col0 + cw) {
    const int rl = row - base;
    const int w = words[(size_t)rl * cw + (j - col0)];
    if (state == 0) {  // H
      const int htype = (w >> 2) & 3;
      if (htype == 0) {
        align[j] = row;
        row = preds[(size_t)rl * max_in + ((w >> 4) & 63)] - 1;
        --j;
      } else {
        state = htype;
      }
    } else if (state == 1) {  // E
      row = preds[(size_t)rl * max_in + ((w >> 10) & 63)] - 1;
      state = (w >> 1) & 1;
    } else {  // F
      align[j] = -1;
      --j;
      state = (w & 1) ? 2 : 0;
    }
  }
  out[0] = row;
  out[1] = j;
  out[2] = state;
}

}  // namespace

// words: (nc, cw) uint16, the cell's plane; preds: (nc, max_in) int32
// buffer row ids of the cell's rows; align: (n,) int32 of the round,
// updated at the consumed columns; out: (3,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int tsta_poa_walk_bounded(const void* words, const void* preds,
                                     int nc, int cw, int max_in, int row,
                                     int j, int state, int base, int col0,
                                     void* align, void* out, void* stream) {
  poa_walk_bounded_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), static_cast<const int32_t*>(preds),
      nc, cw, max_in, row, j, state, base, col0,
      static_cast<int32_t*>(align), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
