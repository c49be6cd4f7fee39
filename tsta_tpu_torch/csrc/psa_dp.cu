// Exact int32 Gotoh global-alignment DP, score-only, one thread block per
// pair.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_diff.py:_abs_kernel in its
// score-only use (K1, launched through _psa_diff_call), and the round-1
// kernels tsta_tpu/ops/psa_pallas.py:_kernel score-only (Q2-13's
// score-only half) and :_batch_kernel (Q2-14).  The TPU kernel packs P
// pairs along the sublanes of (P*Rp, 128) tiles; here each pair is one
// block and the batch is the grid, so 128 pairs fill 128 of the 132 SMs.
// The traced DP (K2, Q2-13 traced) and one long pair's row-chunk (Q2-7)
// are psa_dp_traced.cu's, each pair's columns over co-resident blocks.
//
// Recurrence (rows i over b, columns j over a):
//   E(i,j) = max(E(i-1,j) + e, H(i-1,j) + o + e)
//   C(j)   = max(H(i-1,j-1) + sub(a_j, b_i), E(i,j))
//   F(i,j) = o + j*e + max(H(i,-1) + e, max_{0<=k<j} (C(k) - k*e))
//   H(i,j) = max(C(j), F(i,j))
// with H(-1,j) = o + (j+1)e, H(i,-1) = o + (i+1)e, H(-1,-1) = 0 and
// E(-1,j) = NEG (-2^28, not INT_MIN: gap terms are added to it).
//
// Block layout: thread t owns the strip of W consecutive columns starting
// at t*W (W a multiple of 4).  Per row:
//   pass 1  each thread scans its strip for max(C(k) - k*e);
//   scan    block-wide exclusive prefix max of those strip maxima, seeded
//           with H(i,-1) + e (dp_common.cuh: warp shuffles, then one
//           warp over the warp totals in shared memory);
//   pass 2  each thread walks its strip again, carrying the running max,
//           and writes H and E.
// The H/E frontier lives in global scratch in an interleaved layout
// (column t*W+k at k*256+t) so that a warp's accesses are coalesced;
// it is per pair and has no length cap.  The diagonal term at a strip's
// first column, H(i-1, t*W-1), comes from the neighbour thread through a
// double-buffered shared edge array.  Each pair runs over its real extent.
//
// What bounds it on the H100: per cell about 12 integer operations and
// six 4-byte frontier accesses that hit L1/L2, plus three barriers per row
// and one resident block per pair, so a single pair uses one SM and the
// row barriers serialise it.  Later work: anti-diagonal wavefronts,
// DPX max-plus instructions (__viaddmax_s32), shared-memory frontiers.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int strip_width(int n) {
  int w = (n + kThreads - 1) / kThreads;
  return (w + 3) & ~3;
}

struct Params {
  int m, x, e, o;
};

__global__ void __launch_bounds__(kThreads)
psa_dp_kernel(const uint8_t* __restrict__ a_all,
              const uint8_t* __restrict__ b_all,
              const int32_t* __restrict__ lens, int n_stride, int m_stride,
              Params p, int32_t* __restrict__ score,
              int32_t* __restrict__ corner, int32_t* __restrict__ scratch,
              int scratch_stride) {
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const int pair = blockIdx.x;
  const int t = threadIdx.x;
  const int n_real = lens[2 * pair];
  const int m_real = lens[2 * pair + 1];
  const int W = strip_width(n_real);
  const int j0 = t * W;
  const int jend = min(j0 + W, n_real);  // jend <= j0: no columns
  const uint8_t* a = a_all + (size_t)pair * n_stride;
  const uint8_t* b = b_all + (size_t)pair * m_stride;
  int32_t* H = scratch + (size_t)pair * scratch_stride;
  int32_t* E = H + (size_t)W * kThreads;
  const int oe = p.o + p.e;

  // row -1
  for (int j = j0; j < jend; ++j) {
    const int k = (j - j0) * kThreads + t;
    H[k] = p.o + (j + 1) * p.e;
    E[k] = kNeg;
  }
  s_edge[1][t] = p.o + (j0 + W) * p.e;  // H(-1, j0 + W - 1)
  __syncthreads();

  int best = kNeg;
  for (int i = 0; i < m_real; ++i) {
    const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
    const int bound_cur = p.o + (i + 1) * p.e;          // H(i, -1)
    const int bi = b[i];
    const int hd0 = t == 0 ? bound_prev : s_edge[(i + 1) & 1][t - 1];

    // pass 1: strip max of C(k) - k*e
    int agg = kNeg;
    int hd = hd0;
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kThreads + t;
      const int hp = H[k];
      const int ev = max(E[k] + p.e, hp + oe);
      const int diag = hd + (__ldg(a + j) == bi ? p.m : p.x);
      agg = max(agg, max(diag, ev) - j * p.e);
      hd = hp;
    }
    int run = tsta::block_excl_max<kThreads>(agg, bound_cur + p.e, s_warp);

    // pass 2: F, H, E
    hd = hd0;
    int hl = 0;  // H(i, j-1)
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kThreads + t;
      const int hp = H[k];
      const int ev = max(E[k] + p.e, hp + oe);
      const int diag = hd + (__ldg(a + j) == bi ? p.m : p.x);
      const int c = max(diag, ev);
      const int f = p.o + j * p.e + run;
      const int h = max(c, f);
      run = max(run, c - j * p.e);
      H[k] = h;
      E[k] = ev;
      best = max(best, h);
      if (i == m_real - 1 && j == n_real - 1) corner[pair] = h;
      hd = hp;
      hl = h;
    }
    s_edge[i & 1][t] = hl;  // H(i, jend - 1)
    __syncthreads();
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) best = max(best, __shfl_xor_sync(kFull, best, d));
  if ((t & 31) == 0) s_warp[t >> 5] = best;
  __syncthreads();
  if (t == 0) {
    int r = kNeg;
    for (int w = 0; w < kWarps; ++w) r = max(r, s_warp[w]);
    score[pair] = r;
  }
}

}  // namespace

extern "C" int tsta_psa_dp_scratch_words(int n_stride) {
  return 2 * strip_width(n_stride) * kThreads;
}

// a: (B, n_stride) uint8, b: (B, m_stride) uint8, lens: (B, 2) int32 real
// (n, m); score, corner: (B,) int32; scratch: (B, scratch_stride) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int tsta_psa_dp(const void* a, const void* b, const void* lens,
                           int B, int n_stride, int m_stride, int M, int X,
                           int E, int O, void* score, void* corner,
                           void* scratch, int scratch_stride, void* stream) {
  const Params p{M, X, E, O};
  psa_dp_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int32_t*>(lens), n_stride, m_stride, p,
      static_cast<int32_t*>(score), static_cast<int32_t*>(corner),
      static_cast<int32_t*>(scratch), scratch_stride);
  return static_cast<int>(cudaGetLastError());
}
