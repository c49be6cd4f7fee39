// PSA traceback walk inside one row-chunk of a single pair's code plane,
// one block.
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
// re-enters.  Here the block stages windows of the chunk in shared memory
// ahead of the walk (psa_walk_stage.cuh's ring; prev_row's slot for the
// row above the chunk), and the walker writes each move to device memory,
// off the chain, so there is no log and no early exit.
//
// What bounds it on the H100: the chain, one dependent step after another.
// Read from device memory, a diagonal step's `up` read missed L2 on a
// chunk of 13.1 GB (65,536 x 200,064), ~0.40 us a step; from the staged
// window a step is one shared-memory load (~30 cycles) and a few integer
// operations.

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_stage.cuh"

namespace {

struct ByteMoves {
  int8_t* moves;
  __device__ __forceinline__ void put(int t, int move) {
    moves[t] = static_cast<int8_t>(move);
  }
};

__global__ void __launch_bounds__(tsta::kWalkMaxThreads)
    psa_walk_bounded_kernel(const uint8_t* __restrict__ plane,
                            const uint8_t* __restrict__ prev_row, int rows,
                            int n_pad, int base, int i, int j, int t,
                            int forced, int8_t* __restrict__ moves,
                            int32_t* __restrict__ out, int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  tsta::RingWalker<ByteMoves> wk;
  wk.i = i;
  wk.j = j;
  wk.t = t;
  wk.forced = forced;
  wk.base = base;
  wk.out.moves = moves;
  tsta::walk_ring(wk, plane, prev_row, base, rows, n_pad, S, smem);
  if (threadIdx.x == 0) {
    out[0] = wk.i;
    out[1] = wk.j;
    out[2] = wk.t;
    out[3] = wk.forced;
  }
}

}  // namespace

// plane: (rows, n_pad) uint8 codes of the pair's rows [base, base + rows);
// n_pad a multiple of 16 and both 16-byte aligned; prev_row: (n_pad,)
// uint8 codes of row base - 1 (zeros at base 0); the
// walk enters at (i, j) with t moves already made and ``forced`` carried;
// moves: the pair's int8 move buffer; out: (4,) int32 exit (i, j, t,
// forced); S: steps a phase, a multiple of 8.  Returns the CUDA error of
// the checks, the shared-memory attribute or the launch
// (cudaGetLastError()).
extern "C" int tsta_psa_walk_bounded(const void* plane, const void* prev_row,
                                     int rows, int n_pad, int base, int i,
                                     int j, int t, int forced, void* moves,
                                     void* out, int S, void* stream) {
  const int rc = tsta::walk_ring_prepare(psa_walk_bounded_kernel, S,
                                         tsta::kWalkMaxThreads, n_pad, plane,
                                         prev_row);
  if (rc) return rc;
  psa_walk_bounded_kernel<<<1, tsta::kWalkMaxThreads,
                            tsta::walk_ring_bytes(S),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane),
      static_cast<const uint8_t*>(prev_row), rows, n_pad, base, i, j, t,
      forced, static_cast<int8_t*>(moves), static_cast<int32_t*>(out), S);
  return static_cast<int>(cudaGetLastError());
}
