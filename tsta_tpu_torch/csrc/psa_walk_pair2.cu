// Traceback walk over the DP kernel's code plane, one thread walking two
// pairs.
//
// Replaces the TPU kernel tsta_tpu/ops/traceback.py:
// _walk_kernel_packed_pair2 (Q2-12, launched through
// _decode_moves_banded_packed with pair2=True when P is even): program q
// walks pairs 2q and 2q+1 in one loop, both pairs' decode chains in one
// basic block, so the in-order scalar core fills one chain's load-use
// stalls with the other's.  Its function is K3's (psa_walk.cu): the same
// moves, words and counts per pair.  The TPU kernel stages each pair's band
// of the plane in its own SMEM window; here, as in K3, a step reads the
// plane from global memory through L1/L2, so there is no band.
//
// Per pair the walk and its output are K3's: start at (m-1, n-1), step
// until i < 0 and j < 0 with psa_walk_step.cuh's rules in the core, left
// then up outside it; 16 moves of 2 bits per int32 word, LSB first; the
// tail word after the loop, the remaining words zeroed, the count.
//
// Design.  Thread q (one per block, grid P/2, the TPU's grid) holds both
// pairs' state in registers.  Each iteration first issues the three plane
// reads of both pairs (the cell, its left and its upper neighbour; indices
// clamped into the plane, so the reads need no branch), then steps each
// pair that is still walking: two independent dependent-load chains in one
// loop body, each one's global read in flight while the other's waits.  A
// finished pair's step is a masked no-op while its partner drains.
//
// What bounds it on the H100: the latency of one dependent global read per
// step (L2, ~0.15 us) times the longer walk of the two, m+n steps at most;
// with two chains per thread a step of each pair costs about one latency,
// against K3's one pair per latency, on half as many SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_step.cuh"

namespace {

struct Walk {
  int i, j, t, forced;
  uint32_t acc;
};

__global__ void psa_walk_pair2_kernel(const uint8_t* __restrict__ plane_all,
                                      const int32_t* __restrict__ nm, int P,
                                      int m_pad, int n_pad,
                                      int32_t* __restrict__ words_all,
                                      int n_words,
                                      int32_t* __restrict__ counts) {
  const int q = blockIdx.x;
  if (2 * q + 1 >= P || threadIdx.x != 0) return;
  const uint8_t* plane[2];
  int32_t* words[2];
  Walk w[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int pair = 2 * q + x;
    plane[x] = plane_all + (size_t)pair * m_pad * n_pad;
    words[x] = words_all + (size_t)pair * n_words;
    w[x] = Walk{nm[2 * pair + 1] - 1, nm[2 * pair] - 1, 0, 0, 0u};
  }
  while (w[0].i >= 0 || w[0].j >= 0 || w[1].i >= 0 || w[1].j >= 0) {
    int code[2], left[2], up[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {  // both pairs' reads before either's use
      const int i = max(w[x].i, 0), j = max(w[x].j, 0);
      const uint8_t* cell = plane[x] + (size_t)i * n_pad + j;
      code[x] = cell[0];
      left[x] = cell[j > 0 ? -1 : 0];
      up[x] = cell[i > 0 ? -n_pad : 0];
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      Walk& s = w[x];
      if (s.i < 0 && s.j < 0) continue;  // drained: a masked no-op
      int move, next = 0;
      if (s.i >= 0 && s.j >= 0) {
        move = tsta::psa_walk_step(code[x], left[x], up[x], s.i, s.j,
                                   s.forced, next);
      } else {
        move = s.j >= 0 ? 0 : 2;
      }
      s.acc |= (uint32_t)move << (2 * (s.t & 15));
      if ((s.t & 15) == 15) {
        words[x][s.t >> 4] = (int32_t)s.acc;
        s.acc = 0;
      }
      ++s.t;
      s.i -= move != 0;
      s.j -= move != 2;
      s.forced = next;
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    words[x][w[x].t >> 4] = (int32_t)w[x].acc;
    for (int k = (w[x].t >> 4) + 1; k < n_words; ++k) words[x][k] = 0;
    counts[2 * q + x] = w[x].t;
  }
}

}  // namespace

// plane: (P, m_pad, n_pad) uint8 codes, P even; nm: (P, 2) int32 real
// (n, m); words: (P, n_words) int32; counts: (P,) int32.  Returns
// cudaErrorInvalidValue without launching for an odd P, else
// cudaGetLastError() after the launch.
extern "C" int tsta_psa_walk_pair2(const void* plane, const void* nm, int P,
                                   int m_pad, int n_pad, void* words,
                                   int n_words, void* counts, void* stream) {
  if (P < 2 || P % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  psa_walk_pair2_kernel<<<P / 2, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), static_cast<const int32_t*>(nm), P,
      m_pad, n_pad, static_cast<int32_t*>(words), n_words,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
