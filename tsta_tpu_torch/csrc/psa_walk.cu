// Traceback walk over the DP kernel's code plane, one block per pair.
//
// Replaces the TPU kernel tsta_tpu/ops/traceback.py:_walk_kernel_packed_db
// (and its single-buffer form _walk_kernel_packed), launched through
// _decode_moves_banded_packed, and at P = 1 the round-1 single-pair walk
// tsta_tpu/ops/traceback.py:_walk_kernel (Q2-16, through
// _decode_moves_banded) with its XLA fall-back _decode_moves, which walk
// the same codes from the same corner.  The TPU walks stage bands of the
// plane in SMEM with double-buffered DMA, because a scalar core cannot
// afford an HBM gather per step; here the block stages windows of the
// plane in shared memory ahead of the walk (psa_walk_stage.cuh's ring),
// which any plane fits, so there is no band, no alignment gate and one
// walk serves every shape.
//
// Per pair: start at (m-1, n-1) and step until i < 0 and j < 0.  Moves:
// 1 diag, 0 left, 2 up.  In the core the step rules are
// psa_walk_step.cuh's (traceback.py _decode_step); outside the core: left
// while j >= 0, then up.  Moves are packed 16 per int32 word,
// 2 bits each, LSB first; the tail word is written after the loop and the
// block zeroes the remaining words.
//
// What bounds it on the H100: the chain, one dependent step after another
// (a step's three codes are read together).  Read from device memory, a
// diagonal step's `up` read missed L2 on a plane of GBs, ~0.4 us a step;
// from the staged window a step is one shared-memory load (~30 cycles)
// and a few integer operations.  Pairs run in parallel, one per block,
// each with its own phases.  A launch of more pairs than SMs takes a
// smaller S (tsta_psa_walk_layout): more blocks resident an SM and fewer
// bytes staged a step ((2S + 1) x (2S + 16) bytes every S steps).

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_walk_stage.cuh"

namespace {

// Move t into the packed words: a word is stored when its 16th move lands.
struct PackedMoves {
  int32_t* words;
  uint32_t acc;
  __device__ __forceinline__ void put(int t, int move) {
    acc |= (uint32_t)move << (2 * (t & 15));
    if ((t & 15) == 15) {
      words[t >> 4] = (int32_t)acc;
      acc = 0;
    }
  }
};

__global__ void __launch_bounds__(tsta::kWalkMaxThreads)
    psa_walk_kernel(const uint8_t* __restrict__ plane_all,
                    const int32_t* __restrict__ nm, int P, int m_pad,
                    int n_pad, int32_t* __restrict__ words_all, int n_words,
                    int32_t* __restrict__ counts, int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int t_end;
  const int pair = blockIdx.x;
  if (pair >= P) return;
  const uint8_t* plane = plane_all + (size_t)pair * m_pad * n_pad;
  int32_t* words = words_all + (size_t)pair * n_words;
  tsta::RingWalker<PackedMoves> wk;
  wk.i = nm[2 * pair + 1] - 1;
  wk.j = nm[2 * pair] - 1;
  wk.t = wk.forced = wk.base = 0;
  wk.out.words = words;
  wk.out.acc = 0;
  tsta::walk_ring(wk, plane, nullptr, 0, m_pad, n_pad, S, smem);
  if (threadIdx.x == 0) {
    words[wk.t >> 4] = (int32_t)wk.out.acc;
    counts[pair] = wk.t;
    t_end = wk.t;
  }
  __syncthreads();
  for (int w = (t_end >> 4) + 1 + threadIdx.x; w < n_words; w += blockDim.x)
    words[w] = 0;
}

}  // namespace

// K3's plan for P pairs on ``sms`` SMs: 128 threads a block (the walker's
// warp and three loader warps), S = 64 while each SM walks at most one
// pair, else S = 32, whose windows are a quarter the bytes.  From the
// sweep of S in {16, 32, 64} and 64, 128 or 256 threads on an H100
// (tools/psa_walk_ab.py --sweep): 128 threads 1-3% faster than 256 at one
// block an SM; on a traced batch of 4,096 short pairs (groups of 226 to
// 1,037 pairs) S = 32 the fastest, S = 16 the slowest.
extern "C" void tsta_psa_walk_layout(int P, int sms, int* S, int* threads) {
  *S = P <= sms ? 64 : 32;
  *threads = 128;
}

// plane: (P, m_pad, n_pad) uint8 codes, n_pad a multiple of 16; nm: (P, 2)
// int32 real (n, m); words: (P, n_words) int32; counts: (P,) int32; S:
// steps a phase, a multiple of 8; threads: a block's, a multiple of 32 in
// [64, 256].  Returns the CUDA error of the checks, the shared-memory
// attribute or the launch (cudaGetLastError()).
extern "C" int tsta_psa_walk(const void* plane, const void* nm, int P,
                             int m_pad, int n_pad, void* words, int n_words,
                             void* counts, int S, int threads, void* stream) {
  const int rc = tsta::walk_ring_prepare(psa_walk_kernel, S, threads, n_pad,
                                         plane, nullptr);
  if (rc) return rc;
  psa_walk_kernel<<<P, threads, tsta::walk_ring_bytes(S),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), static_cast<const int32_t*>(nm),
      P, m_pad, n_pad, static_cast<int32_t*>(words), n_words,
      static_cast<int32_t*>(counts), S);
  return static_cast<int>(cudaGetLastError());
}
