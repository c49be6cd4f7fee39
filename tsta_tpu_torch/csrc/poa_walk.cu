// POA traceback walk over the round DP's 16-bit word plane, one block;
// the wide form (in-degree past 64) over its 32-bit plane.
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
// The TPU walk keeps a band of ~48 rows x 1,024 columns of the plane in
// VMEM with the pred table whole in SMEM, refetching the band when a step
// lands outside it.  Here the block stages windows of the plane and the
// preds of their rows in shared memory ahead of the walk
// (poa_walk_stage.cuh's ring: thread 0 walks, the other warps copy), and
// a move outside the window reads device memory and counts a miss.
//
// What bounds it on the H100: the chain, two dependent loads a move (the
// word, then the pred it names).  From device memory the word missed L2
// after each diagonal (the 50 kbp round's plane is 5.1 GB), ~255 ns a
// move; from the staged window both are shared-memory loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_walk_stage.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(tsta::kPoaWalkMaxThreads)
    poa_walk_kernel(const tsta::PoaWord<V>* __restrict__ words,
                    const int32_t* __restrict__ preds,
                    const int32_t* __restrict__ best, int N, int n,
                    int n_real, int max_in, int32_t* __restrict__ align,
                    int32_t* __restrict__ counts, int S, int R) {
  extern __shared__ __align__(16) uint8_t smem[];
  tsta::PoaWalker<V> wk;
  wk.row = best[0];
  wk.j = n_real - 1;
  wk.state = wk.steps = wk.pred_moves = wk.misses = 0;
  wk.base = wk.col0 = 0;
  wk.rows = N;
  wk.cols = n;
  wk.max_in = max_in;
  wk.words = words;
  wk.preds = preds;
  wk.align = align;
  tsta::poa_walk_ring(wk, S, R, smem, counts);
}

template <int V>
int launch(const void* words, const void* preds, const void* best, int N,
           int n, int n_real, int max_in, void* align, void* counts, int S,
           int R, int threads, cudaStream_t stream) {
  const int rc = tsta::poa_walk_prepare(poa_walk_kernel<V>, S, R, threads,
                                        N, n, max_in, words, preds, V < 0);
  if (rc) return rc;
  poa_walk_kernel<V><<<1, threads,
                       2 * tsta::poa_walk_buf_bytes_of<V>(S, R, max_in),
                       stream>>>(
      static_cast<const tsta::PoaWord<V>*>(words),
      static_cast<const int32_t*>(preds),
      static_cast<const int32_t*>(best), N, n, n_real, max_in,
      static_cast<int32_t*>(align), static_cast<int32_t*>(counts), S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: (N, n) uint16 (max_in <= 64) or uint32 (the wide form, max_in
// 128 to 8,192), n a multiple of 8; preds: (N, max_in) int32
// buffer row ids, N * max_in a multiple of 4, both 16-byte aligned; best:
// (1,) int32 start row; align: (n,) int32, filled with -1 by the caller;
// counts: (4,) int32 (moves, pred moves, misses, phases); S moves a
// phase (a multiple of 8), R rows a window, ``threads`` a block (a
// multiple of 32 in [64, 256]).  A build per max_in up to 8 (its preds
// loaded with the word), one for wider tables, one for the wide form.
// Returns the CUDA error of
// the checks, the shared-memory attribute or the launch
// (cudaGetLastError()).
extern "C" int tsta_poa_walk(const void* words, const void* preds,
                             const void* best, int N, int n, int n_real,
                             int max_in, void* align, void* counts, int S,
                             int R, int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_in > 64)
    return launch<tsta::kPoaWide>(words, preds, best, N, n, n_real, max_in,
                                  align, counts, S, R, threads, st);
  switch (max_in) {
    case 1: return launch<1>(words, preds, best, N, n, n_real, max_in, align,
                             counts, S, R, threads, st);
    case 2: return launch<2>(words, preds, best, N, n, n_real, max_in, align,
                             counts, S, R, threads, st);
    case 4: return launch<4>(words, preds, best, N, n, n_real, max_in, align,
                             counts, S, R, threads, st);
    case 8: return launch<8>(words, preds, best, N, n, n_real, max_in, align,
                             counts, S, R, threads, st);
    default: return launch<0>(words, preds, best, N, n, n_real, max_in,
                              align, counts, S, R, threads, st);
  }
}
