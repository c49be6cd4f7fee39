// Traceback walk over the DP kernel's code plane, one thread per pair.
//
// Replaces the TPU kernel tsta_tpu/ops/traceback.py:_walk_kernel_packed_db
// (and its single-buffer form _walk_kernel_packed), launched through
// _decode_moves_banded_packed, and at P = 1 the round-1 single-pair walk
// tsta_tpu/ops/traceback.py:_walk_kernel (Q2-16, through
// _decode_moves_banded) with its XLA fall-back _decode_moves, which walk
// the same codes from the same corner.  The TPU walks stage bands of the
// plane in SMEM (with double-buffered DMA) because a scalar core cannot
// afford an HBM gather per step; here each step reads the plane from
// global memory through L1/L2, so there is no band, no alignment gate and
// one walk serves every shape.
//
// Per pair: start at (m-1, n-1) and step until i < 0 and j < 0.  Moves:
// 1 diag, 0 left, 2 up.  In the core the step rules are
// psa_walk_step.cuh's (traceback.py _decode_step); outside the core: left
// while j >= 0, then up.  Moves are packed 16 per int32 word,
// 2 bits each, LSB first; the tail word is written after the loop and the
// remaining words are zeroed.
//
// What bounds it on the H100: one dependent global read per step (the
// three codes of a step are loaded together), i.e. L2 latency times
// m+n steps per pair; pairs run in parallel, one per block.  Later work:
// stage the band the walk is about to enter in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_step.cuh"

namespace {

__global__ void psa_walk_kernel(const uint8_t* __restrict__ plane_all,
                                const int32_t* __restrict__ nm, int P,
                                int m_pad, int n_pad,
                                int32_t* __restrict__ words_all, int n_words,
                                int32_t* __restrict__ counts) {
  const int pair = blockIdx.x;
  if (pair >= P || threadIdx.x != 0) return;
  const uint8_t* plane = plane_all + (size_t)pair * m_pad * n_pad;
  int32_t* words = words_all + (size_t)pair * n_words;
  int i = nm[2 * pair + 1] - 1;
  int j = nm[2 * pair] - 1;
  int t = 0, forced = 0;
  uint32_t acc = 0;
  while (i >= 0 || j >= 0) {
    int move, next = 0;
    if (i >= 0 && j >= 0) {
      const uint8_t* cell = plane + (size_t)i * n_pad + j;
      const int left = j > 0 ? cell[-1] : 0;
      const int up = i > 0 ? cell[-n_pad] : 0;
      move = tsta::psa_walk_step(cell[0], left, up, i, j, forced, next);
    } else {
      move = j >= 0 ? 0 : 2;
    }
    acc |= (uint32_t)move << (2 * (t & 15));
    if ((t & 15) == 15) {
      words[t >> 4] = (int32_t)acc;
      acc = 0;
    }
    ++t;
    i -= move != 0;
    j -= move != 2;
    forced = next;
  }
  words[t >> 4] = (int32_t)acc;
  for (int w = (t >> 4) + 1; w < n_words; ++w) words[w] = 0;
  counts[pair] = t;
}

}  // namespace

// plane: (P, m_pad, n_pad) uint8 codes; nm: (P, 2) int32 real (n, m);
// words: (P, n_words) int32; counts: (P,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int tsta_psa_walk(const void* plane, const void* nm, int P,
                             int m_pad, int n_pad, void* words, int n_words,
                             void* counts, void* stream) {
  psa_walk_kernel<<<P, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), static_cast<const int32_t*>(nm),
      P, m_pad, n_pad, static_cast<int32_t*>(words), n_words,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
