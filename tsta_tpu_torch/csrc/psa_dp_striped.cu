// Exact int32 Gotoh DP, score-only, over the striped column layout: P pairs,
// each pair's columns cut into D shards of co-resident 256-thread blocks.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_diff.py:_striped_kernel (Q2-11,
// launched through _psa_diff_call with layout="striped").  Its function is
// K1's (psa_dp.cu score-only): per pair the matrix-max score and the corner
// H(m-1, n-1), int32.
//
// Layout.  A pair's n_pad = Sp * 128 columns arrive as one (Sp, 128) tile,
// column j at [j % Sp][j / Sp] (ops/psa_diff.py pack_pairs_striped, JAX's
// striped a32): lane l of the tile holds the stripe of columns
// [l*Sp, (l+1)*Sp) down its Sp rows.  The TPU chose it so that F's prefix
// scans sublanes, which are cheap there, and crosses lanes only on (P, 128)
// tiles.  Here the schedule is K1's: the body, plan, packets and launch are
// psa_dp_score.cuh's (each pair over its real extent, plan
// psa_diff.score_plan at n_pad = Sp * 128), and only the Reader differs.
// The kernel reads the tile itself:
// * the shared-memory frontier: at row -1 the block's warps read the
//   stripes that hold its shard's columns, lanes l0 .. l1 of the tile, in
//   the tile's own order (at tile row u the bytes u*128 + l0 .. u*128 + l1
//   to consecutive threads) and scatter each byte into the slab slot of
//   its column, as K1 stages its bytes in order;
// * the global frontier (strips past shared memory): column g of the pair
//   read through the index map, tile[(g % Sp) * 128 + g / Sp].
// A shard's columns need not be whole stripes: a stripe cut by a shard's
// edge is read by both shards, each keeping its own columns, so at most
// two stripes' bytes a shard are read twice, once a launch.  C is not
// aligned to Sp for that: the plan stays K1's, whose W and blocks an SM
// come from PERF.md's sweep, and the staging is off the row loop.
//
// What bounds it on the H100: K1's function, about 12 integer operations
// per cell, so 128 x 10,240 x 10,240 cells bound it at ~9.6 ms; the row's
// fixed cost (three barriers, a block scan, a share of a packet) sets the
// pace at narrow strips, as in K1 (psa_dp.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_dp_score.cuh"

namespace {

constexpr int kLanes = 128;  // the striped tile's lanes

// A pair's columns as its (Sp, 128) striped tile, Sp = n_pad / 128.
struct Striped {
  const uint8_t* tile;
  int sp, col0;
  __device__ Striped(const Score& k, int pair, int col0_)
      : tile(k.a + (size_t)pair * k.n_pad), sp(k.n_pad / kLanes),
        col0(col0_) {}
  __device__ void stage_col(uint8_t*, int, int) const {}
  // the shard's columns [col0, col0 + Cd): the stripes l0 .. l0 + nl - 1
  // that hold them, read row by row of the tile, each byte to the slot of
  // its shard column j, (j % W) * 256 + j / W
  __device__ void stage_all(uint8_t* s_a, int Cd, int W) const {
    const int l0 = col0 / sp;
    const int nl = (col0 + Cd - 1) / sp - l0 + 1;
    for (int idx = threadIdx.x; idx < sp * nl; idx += kThreads) {
      const int u = idx / nl;
      const int l = l0 + idx - u * nl;
      const int j = l * sp + u - col0;
      if (j >= 0 && j < Cd)
        s_a[(j % W) * kThreads + j / W] = tile[u * kLanes + l];
    }
  }
  __device__ int at(int j) const {
    const int g = col0 + j;
    const int l = g / sp;
    return __ldg(tile + (g - l * sp) * kLanes + l);
  }
};

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
psa_dp_striped_kernel(const Score k) {
  score_body<kGlobal, Striped>(k);
}

}  // namespace

// The most shards of C columns and T-row packets the current card holds
// resident at once; a negative value is minus a CUDA error.
extern "C" int tsta_psa_dp_striped_max_blocks(int C, int T) {
  return max_blocks(psa_dp_striped_kernel<false>,
                    psa_dp_striped_kernel<true>, C, T);
}

// a_tile: (P, sp, 128) uint8, column j of a pair at [j % sp][j / sp]; b:
// (P, m_stride) uint8; lens: (P, 2) int32 real (n, m), n <= sp * 128 and m
// <= m_stride; D shards of C columns ((D-1)*C < sp * 128 <= D*C), T rows
// per packet; comm: (P, D, ceil(m_stride / T), 2T) int32 and flags: (P, D,
// ceil(m_stride / T)) int32, zero, both null at D = 1; out: (P, D, 2)
// int32, each shard's best and corner; scratch: (P, D,
// tsta_psa_dp_scratch_words(C, T)) int32 or null (psa_dp.cu's: the one
// body's).  D = 1 is an ordinary launch of P blocks; D >= 2 a cooperative
// launch of P * D.
// Returns cudaGetLastError() after the launch, or
// cudaErrorCooperativeLaunchTooLarge without launching when P * D >= 2
// blocks cannot be resident together.
extern "C" int tsta_psa_dp_striped(const void* a_tile, const void* b,
                                   const void* lens, int P, int sp,
                                   int m_stride, int M, int X, int E, int O,
                                   int D, int C, int T, void* comm,
                                   void* flags, void* out, void* scratch,
                                   void* stream) {
  if (sp < 1) return (int)cudaErrorInvalidValue;
  return launch(psa_dp_striped_kernel<false>, psa_dp_striped_kernel<true>,
                a_tile, b, lens, P, sp * kLanes, m_stride, M, X, E, O, 0, D,
                C, T, comm, flags, out, scratch, stream);
}
