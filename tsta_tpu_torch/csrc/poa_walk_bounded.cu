// POA traceback walk inside one cell of a chunked round, one block.
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
// here the walker writes align[j] in device memory directly, off the
// chain, so there is no log and no early exit.  The block stages windows
// of the cell and the preds of their rows on poa_walk_stage.cuh's ring,
// clipped to the cell.
//
// What bounds it on the H100: the chain, two dependent loads a move (the
// word, then the pred it names), from shared memory while the walk stays
// in its windows; a move outside them reads device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_walk_stage.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(tsta::kPoaWalkMaxThreads)
    poa_walk_bounded_kernel(const uint16_t* __restrict__ words,
                            const int32_t* __restrict__ preds, int nc,
                            int cw, int max_in, int row, int j, int state,
                            int base, int col0, int32_t* __restrict__ align,
                            int32_t* __restrict__ out,
                            int32_t* __restrict__ counts, int S, int R) {
  extern __shared__ __align__(16) uint8_t smem[];
  tsta::PoaWalker<V> wk;
  wk.row = row - base;
  wk.j = j - col0;
  wk.state = state;
  wk.steps = wk.pred_moves = wk.misses = 0;
  wk.base = base;
  wk.col0 = col0;
  wk.rows = nc;
  wk.cols = cw;
  wk.max_in = max_in;
  wk.words = words;
  wk.preds = preds;
  wk.align = align;
  tsta::poa_walk_ring(wk, S, R, smem, counts);
  if (threadIdx.x == 0) {
    out[0] = wk.row + base;
    out[1] = wk.j + col0;
    out[2] = wk.state;
  }
}

template <int V>
int launch(const void* words, const void* preds, int nc, int cw, int max_in,
           int row, int j, int state, int base, int col0, void* align,
           void* out, void* counts, int S, int R, int threads,
           cudaStream_t stream) {
  const int rc = tsta::poa_walk_prepare(poa_walk_bounded_kernel<V>, S, R,
                                        threads, nc, cw, max_in, words,
                                        preds);
  if (rc) return rc;
  poa_walk_bounded_kernel<V><<<1, threads,
                               2 * tsta::poa_walk_buf_bytes(S, R, max_in),
                               stream>>>(
      static_cast<const uint16_t*>(words), static_cast<const int32_t*>(preds),
      nc, cw, max_in, row, j, state, base, col0, static_cast<int32_t*>(align),
      static_cast<int32_t*>(out), static_cast<int32_t*>(counts), S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: (nc, cw) uint16, the cell's plane, cw a multiple of 8; preds:
// (nc, max_in) int32 buffer row ids of the cell's rows, nc * max_in a
// multiple of 4, both 16-byte aligned; align: (n,) int32 of the round,
// updated at the consumed columns; out: (3,) int32; counts: (4,) int32
// (moves, pred moves, misses, phases); S, R, ``threads`` and the builds
// per max_in as tsta_poa_walk's.  Returns the CUDA error of the checks,
// the shared-memory attribute or the launch (cudaGetLastError()).
extern "C" int tsta_poa_walk_bounded(const void* words, const void* preds,
                                     int nc, int cw, int max_in, int row,
                                     int j, int state, int base, int col0,
                                     void* align, void* out, void* counts,
                                     int S, int R, int threads,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (max_in) {
    case 1: return launch<1>(words, preds, nc, cw, max_in, row, j, state,
                             base, col0, align, out, counts, S, R, threads,
                             st);
    case 2: return launch<2>(words, preds, nc, cw, max_in, row, j, state,
                             base, col0, align, out, counts, S, R, threads,
                             st);
    case 4: return launch<4>(words, preds, nc, cw, max_in, row, j, state,
                             base, col0, align, out, counts, S, R, threads,
                             st);
    case 8: return launch<8>(words, preds, nc, cw, max_in, row, j, state,
                             base, col0, align, out, counts, S, R, threads,
                             st);
    default: return launch<0>(words, preds, nc, cw, max_in, row, j, state,
                              base, col0, align, out, counts, S, R, threads,
                              st);
  }
}
