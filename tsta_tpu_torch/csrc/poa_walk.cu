// POA traceback walk over the round DP's 16-bit word plane, one thread.
//
// Replaces the TPU kernel tsta_tpu/ops/msa_pallas.py:_poa_walk_kernel
// (launched through _walk_banded); the 3-state machine of
// msa_pallas.py:_walk (:593-624).  Starting at (best_row, n_real-1) in
// state H, each step reads the word of cell (row, j):
//   H: h_type 0 (diagonal) writes align[j] = row, moves to the pred
//      preds[row, h_pred] - 1 and to column j-1; h_type 1 or 2 switches to
//      state E or F in place;
//   E: moves to the pred preds[row, e_pred] - 1, stays in E iff e_ext;
//   F: writes align[j] = -1, moves to column j-1, stays in F iff f_ext;
// until row < 0 (buffer row id 0 is the virtual row, so -1 ends the walk)
// or j < 0.  Columns the walk never consumes keep the caller's -1.
//
// The TPU walk stages bands of the plane in SMEM because its scalar core
// pays ~1 us per HBM gather.  Here the thread reads the plane and the pred
// table through L1/L2, so there is no band and no shape gate.
//
// What bounds it on the H100: one dependent load per step, mostly an L2 or
// device-memory miss (a diagonal step moves to another row of the plane,
// n*2 bytes away), times ~n_real steps.  Later work: prefetch the rows the
// walk is about to enter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void poa_walk_kernel(const uint16_t* __restrict__ words,
                                const int32_t* __restrict__ preds,
                                const int32_t* __restrict__ best, int n,
                                int n_real, int max_in,
                                int32_t* __restrict__ align) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int row = best[0];
  int j = n_real - 1;
  int state = 0;  // 0 H, 1 E, 2 F
  while (j >= 0 && row >= 0) {
    const int w = words[(size_t)row * n + j];
    if (state == 0) {
      const int htype = (w >> 2) & 3;
      if (htype == 0) {
        align[j] = row;
        row = preds[(size_t)row * max_in + ((w >> 4) & 63)] - 1;
        --j;
      } else {
        state = htype;
      }
    } else if (state == 1) {
      row = preds[(size_t)row * max_in + ((w >> 10) & 63)] - 1;
      state = (w >> 1) & 1;
    } else {
      align[j] = -1;
      --j;
      state = (w & 1) ? 2 : 0;
    }
  }
}

}  // namespace

// words: (N, n) uint16; preds: (N, max_in) int32 buffer row ids; best:
// (1,) int32 start row; align: (n,) int32, filled with -1 by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int tsta_poa_walk(const void* words, const void* preds,
                             const void* best, int n, int n_real, int max_in,
                             void* align, void* stream) {
  poa_walk_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), static_cast<const int32_t*>(preds),
      static_cast<const int32_t*>(best), n, n_real, max_in,
      static_cast<int32_t*>(align));
  return static_cast<int>(cudaGetLastError());
}
