// Score-only Gotoh DP for batches of short pairs, one warp per pair.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_pallas.py:_packed_kernel (Q2-15,
// launched through _psa_pallas_packed), which packs P pairs of at most
// PACK_RMAX = 16 column segments (n <= 2,048) along the sublanes of one
// (P*Rp, 128) tile so that short pairs still fill the vector unit.  K1
// (psa_dp.cu) gives each pair a block of 256 threads: at n <= 2,048 a
// thread's strip is 4-8 columns wide and the row's three block barriers
// cost more than its cells.  Here a block holds kWarps pairs, one warp
// each, and the row loop has no __syncthreads:
//
// * lane l owns the strip of W columns from l*W, W = ceil(n_real / 32)
//   rounded up to 4 (at most 64 at n <= 2,048);
// * the row's F prefix max (dp_common.cuh's closed form) is a 5-step
//   __shfl_up_sync scan of the strip maxima, seeded with H(i,-1) + e;
// * the diagonal term at a strip's first column, H(i-1, l*W-1), comes from
//   lane l-1 by a shuffle (lanes past the pair's width own no columns and
//   are never a left neighbour of one that does);
// * the warp's H/E frontier lives in shared memory, interleaved (column
//   l*W+k at k*32+l) so that a warp's accesses fall in 32 banks:
//   2 x 32 x W int32 per warp, 16 KB at W = 64.
//
// Recurrence, boundary terms and the NEG guard are psa_dp.cu's.  Each pair
// runs over its real extent (lens), so pairs of mixed lengths share a
// launch without padding and the result holds for any parameters.  It
// returns the max of H over the pair's cells and H(m_real-1, n_real-1);
// the TPU kernel's max also covers padded cells, which never exceed it
// while every move into padding lowers the score (X < 0, E < 0, O <= 0).
//
// What bounds it on the H100: per cell about 24 integer operations over
// two passes and six shared-memory accesses, in a chain per lane of
// 2*W dependent steps per row; with 64 KB of shared memory per block at
// W = 64, three blocks (12 warps) share an SM.  Later work: frontier in
// registers for fixed W, DPX max-plus instructions (__viaddmax_s32).

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // pairs per block

__host__ __device__ inline int short_strip(int n) {
  int w = (n + kLanes - 1) / kLanes;
  return (w + 3) & ~3;
}

__global__ void __launch_bounds__(kWarps * kLanes)
psa_dp_short_kernel(const uint8_t* __restrict__ a_all,
                    const uint8_t* __restrict__ b_all,
                    const int32_t* __restrict__ lens, int B, int n_stride,
                    int m_stride, int pm, int px, int pe, int po,
                    int32_t* __restrict__ score,
                    int32_t* __restrict__ corner, int w_max) {
  extern __shared__ int32_t s_front[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= B) return;  // the whole warp: shuffles stay within a warp

  const int n_real = lens[2 * pair];
  const int m_real = lens[2 * pair + 1];
  const int W = short_strip(n_real);
  const int j0 = lane * W;
  const int jend = min(j0 + W, n_real);  // jend <= j0: no columns
  const uint8_t* a = a_all + (size_t)pair * n_stride;
  const uint8_t* b = b_all + (size_t)pair * m_stride;
  int32_t* H = s_front + (size_t)warp * 2 * w_max * kLanes;
  int32_t* E = H + (size_t)w_max * kLanes;
  const int oe = po + pe;

  for (int j = j0; j < jend; ++j) {  // row -1
    const int k = (j - j0) * kLanes + lane;
    H[k] = po + (j + 1) * pe;
    E[k] = kNeg;
  }
  int hlast = po + (j0 + W) * pe;  // H(i-1, j0 + W - 1), here i = 0
  int best = kNeg;

  for (int i = 0; i < m_real; ++i) {
    const int bound_cur = po + (i + 1) * pe;  // H(i, -1)
    const int bi = b[i];
    int hd0 = __shfl_up_sync(kFull, hlast, 1);
    if (lane == 0) hd0 = i == 0 ? 0 : po + i * pe;  // H(i-1, -1)

    // pass 1: strip max of C(k) - k*e
    int agg = kNeg;
    int hd = hd0;
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kLanes + lane;
      const int hp = H[k];
      const int ev = max(E[k] + pe, hp + oe);
      const int diag = hd + (__ldg(a + j) == bi ? pm : px);
      agg = max(agg, max(diag, ev) - j * pe);
      hd = hp;
    }
    // warp-wide exclusive prefix max of the strip maxima
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int u = __shfl_up_sync(kFull, agg, d);
      if (lane >= d) agg = max(agg, u);
    }
    int excl = __shfl_up_sync(kFull, agg, 1);
    int run = max(bound_cur + pe, lane == 0 ? kNeg : excl);

    // pass 2: F, H, E
    hd = hd0;
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kLanes + lane;
      const int hp = H[k];
      const int ev = max(E[k] + pe, hp + oe);
      const int diag = hd + (__ldg(a + j) == bi ? pm : px);
      const int c = max(diag, ev);
      const int h = max(c, po + j * pe + run);
      run = max(run, c - j * pe);
      H[k] = h;
      E[k] = ev;
      best = max(best, h);
      if (i == m_real - 1 && j == n_real - 1) corner[pair] = h;
      hd = hp;
      hlast = h;
    }
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) best = max(best, __shfl_xor_sync(kFull, best, d));
  if (lane == 0) score[pair] = best;
}

}  // namespace

// Dynamic shared memory of a launch at n_stride columns.
extern "C" int tsta_psa_dp_short_smem_bytes(int n_stride) {
  return kWarps * 2 * short_strip(n_stride) * kLanes * (int)sizeof(int32_t);
}

// a: (B, n_stride) uint8, b: (B, m_stride) uint8, lens: (B, 2) int32 real
// (n, m), n <= n_stride; score, corner: (B,) int32.  Returns the CUDA
// error of raising the kernel's shared-memory limit, or cudaGetLastError()
// after the launch.
extern "C" int tsta_psa_dp_short(const void* a, const void* b,
                                 const void* lens, int B, int n_stride,
                                 int m_stride, int M, int X, int E, int O,
                                 void* score, void* corner, void* stream) {
  const int smem = tsta_psa_dp_short_smem_bytes(n_stride);
  cudaError_t err = cudaFuncSetAttribute(
      psa_dp_short_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  psa_dp_short_kernel<<<(B + kWarps - 1) / kWarps, kWarps * kLanes, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int32_t*>(lens), B, n_stride, m_stride, M, X, E, O,
      static_cast<int32_t*>(score), static_cast<int32_t*>(corner),
      short_strip(n_stride));
  return static_cast<int>(cudaGetLastError());
}
