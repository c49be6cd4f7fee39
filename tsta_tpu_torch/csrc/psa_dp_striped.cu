// Exact int32 Gotoh DP, score-only, over the striped column layout: one
// thread block of 128 threads per pair.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_diff.py:_striped_kernel (Q2-11,
// launched through _psa_diff_call with layout="striped").  Its function is
// K1's (psa_dp.cu score-only): per pair the matrix-max score and the corner
// H(m-1, n-1), int32.  The recurrence, boundary terms and closed-form F are
// K1's (see psa_dp.cu's header).
//
// Layout.  A pair's n_pad = Sp * 128 columns arrive as one (Sp, 128) tile,
// column j at [j % Sp][j / Sp] (ops/psa_diff.py pack_pairs_striped, JAX's
// striped a32): lane l of the tile holds the stripe of columns
// [l*Sp, (l+1)*Sp) down its Sp rows.  The TPU chose it so that F's prefix
// scans sublanes, which are cheap there, and crosses lanes only on (P, 128)
// tiles.  Here thread l is lane l and owns that stripe, so the tile is K1's
// strip-per-thread split with the strips' bytes interleaved: at stripe row
// u the warp reads a_tile[u*128 + l], 32 consecutive bytes, where K1's
// threads read 40 or more bytes apart.  The H/E frontier (global scratch,
// 2 * Sp * 128 int32 per pair) is in the same u*128 + l order, coalesced
// as in K1.
//
// Per row i, each thread over its stripe's real columns (j < n, rows < m:
// each pair over its real extent):
//   pass 1  the stripe's max of y = C(j) - j*e (the TPU kernel's stripe
//           total, max(q, y) at u = Sp - 1);
//   scan    the exclusive prefix max of the stripe totals across the 128
//           lanes, seeded with H(i,-1) + e (dp_common.cuh block_excl_max:
//           warp shuffles, then the 4 warp totals through shared memory):
//           the TPU kernel's cross-lane prefix on the compressed tile;
//   pass 2  the stripe again, carrying the running max down it (the
//           within-stripe prefix), and writes H and E.
// The diagonal term at a stripe's first column, H(i-1, l*Sp - 1), is lane
// l-1's last H of the row before, through a double-buffered shared edge
// array (the TPU's boundary_rows lane roll).
//
// What bounds it on the H100: as K1, about 12 integer operations per cell
// and six 4-byte frontier accesses through L1/L2, three barriers per row,
// one block per pair; with 128 threads (the TPU's lanes) against K1's 256
// each thread walks twice K1's columns per row and an SM holds half the
// warps, so the row loop's latency is hidden less.  Later work: frontier
// in shared memory, several pairs per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kLanes = 128;  // one thread per lane of the striped tile

struct Params {
  int m, x, e, o;
};

__global__ void __launch_bounds__(kLanes)
psa_dp_striped_kernel(const uint8_t* __restrict__ a_all,
                      const uint8_t* __restrict__ b_all,
                      const int32_t* __restrict__ lens, int sp, int m_stride,
                      Params p, int32_t* __restrict__ score,
                      int32_t* __restrict__ corner,
                      int32_t* __restrict__ scratch) {
  constexpr int kWarps = kLanes / 32;
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kLanes];

  const int pair = blockIdx.x;
  const int l = threadIdx.x;
  const int n_real = lens[2 * pair];
  const int m_real = lens[2 * pair + 1];
  const int j0 = l * sp;
  const int nu = max(0, min(sp, n_real - j0));  // this stripe's real columns
  const size_t tile = (size_t)sp * kLanes;
  const uint8_t* a = a_all + (size_t)pair * tile + l;  // column j0+u at a[u*128]
  const uint8_t* b = b_all + (size_t)pair * m_stride;
  int32_t* H = scratch + (size_t)pair * 2 * tile + l;
  int32_t* E = H + tile;
  const int oe = p.o + p.e;

  for (int u = 0; u < nu; ++u) {  // row -1
    H[u * kLanes] = p.o + (j0 + u + 1) * p.e;
    E[u * kLanes] = kNeg;
  }
  s_edge[1][l] = p.o + (j0 + sp) * p.e;  // H(-1, j0 + Sp - 1)
  __syncthreads();

  int best = kNeg;
  for (int i = 0; i < m_real; ++i) {
    const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
    const int bound_cur = p.o + (i + 1) * p.e;          // H(i, -1)
    const int bi = b[i];
    const int hd0 = l == 0 ? bound_prev : s_edge[(i + 1) & 1][l - 1];

    // pass 1: the stripe's max of C(j) - j*e
    int agg = kNeg;
    int hd = hd0;
    for (int u = 0; u < nu; ++u) {
      const int hp = H[u * kLanes];
      const int ev = max(E[u * kLanes] + p.e, hp + oe);
      const int diag = hd + (__ldg(a + u * kLanes) == bi ? p.m : p.x);
      agg = max(agg, max(diag, ev) - (j0 + u) * p.e);
      hd = hp;
    }
    int run = tsta::block_excl_max<kLanes>(agg, bound_cur + p.e, s_warp);

    // pass 2: F, H, E down the stripe
    hd = hd0;
    int hl = 0;  // H(i, j0 + nu - 1)
    for (int u = 0; u < nu; ++u) {
      const int j = j0 + u;
      const int hp = H[u * kLanes];
      const int ev = max(E[u * kLanes] + p.e, hp + oe);
      const int diag = hd + (__ldg(a + u * kLanes) == bi ? p.m : p.x);
      const int c = max(diag, ev);
      const int h = max(c, p.o + j * p.e + run);
      run = max(run, c - j * p.e);
      H[u * kLanes] = h;
      E[u * kLanes] = ev;
      best = max(best, h);
      if (i == m_real - 1 && j == n_real - 1) corner[pair] = h;
      hd = hp;
      hl = h;
    }
    s_edge[i & 1][l] = hl;
    __syncthreads();
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) best = max(best, __shfl_xor_sync(kFull, best, d));
  if ((l & 31) == 0) s_warp[l >> 5] = best;
  __syncthreads();
  if (l == 0) {
    int r = kNeg;
    for (int w = 0; w < kWarps; ++w) r = max(r, s_warp[w]);
    score[pair] = r;
  }
}

}  // namespace

// a_tile: (B, sp, 128) uint8, column j of a pair at [j % sp][j / sp]; b:
// (B, m_stride) uint8; lens: (B, 2) int32 real (n, m), n <= sp * 128 and
// m <= m_stride; score, corner: (B,) int32; scratch: (B, 2 * sp * 128)
// int32.  Returns cudaGetLastError() after the launch.
extern "C" int tsta_psa_dp_striped(const void* a_tile, const void* b,
                                   const void* lens, int B, int sp,
                                   int m_stride, int M, int X, int E, int O,
                                   void* score, void* corner, void* scratch,
                                   void* stream) {
  const Params p{M, X, E, O};
  psa_dp_striped_kernel<<<B, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a_tile), static_cast<const uint8_t*>(b),
      static_cast<const int32_t*>(lens), sp, m_stride, p,
      static_cast<int32_t*>(score), static_cast<int32_t*>(corner),
      static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
