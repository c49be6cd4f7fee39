// Score-only Gotoh DP for batches of short pairs: a lane wavefront, one
// warp a pair.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_pallas.py:_packed_kernel (Q2-15,
// launched through _psa_pallas_packed), which packs P pairs of at most
// PACK_RMAX = 16 column segments (n <= 2,048) along the sublanes of one
// (P*Rp, 128) tile so that short pairs still fill the vector unit.  On the
// H100 a short pair is one warp's work:
//
// * the pair's columns are cut into tiles of 32*W; in a tile lane l owns
//   the strip of W columns from l*W and, at step s, computes row s - l of
//   it, so a tile of m rows takes m + 31 steps (m + L - 1 where only L
//   lanes own columns);
// * the strip's H and E live in registers and F runs left to right
//   through it in one pass: no prefix scan, no second pass, no frontier in
//   shared memory (each value of a cell is computed once; C, which needs
//   the H above-left, is taken right to left over the H above it, then F
//   and H left to right, so no register is copied).  Lane l - 1 hands over its last column's H and the F
//   entering lane l's strip with two __shfl_up_sync a step; the diagonal
//   H(r-1, l*W-1) is the H received the step before;
// * a tile's last lane writes the row's (H, F) at the tile's edge to the
//   warp's boundary buffer (2 int32 a row, L2-resident device memory),
//   which the next tile's lane 0 reads a step ahead of use;
// * W is a template parameter, one build each; short_width() picks the W
//   of a pair (the least modelled cost: steps x (cells + a step's fixed
//   cost)), so few lanes idle and the 31-step fill and drain stay small
//   against m;
// * the warps are persistent, kPerSm blocks of four an SM, and take pairs
//   from an atomic counter in the order `order` gives (the wrapper's
//   argsort of n*m, longest first), and write each pair's score and corner
//   at its input index.
//
// Values are stored shifted by the row: H~ = H - r*e, E~ = E - r*e,
// F~ = F - r*e - (o+e), which turns every step of the recurrence into one
// DPX max-plus instruction a cell:
//   E~(r, j)   = max(E~(r-1, j), H~(r-1, j) + o)
//   C~         = max(H~(r-1, j-1) + s - e, E~(r, j))
//   H~(r, j)   = max(C~, F~(r, j) + o + e)
//   F~(r, j+1) = max(F~(r, j) + e, C~)
// with s = M or X, and the left boundary H~(r, -1) = F~(r, 0) = o + e.
// Columns past n_real (in the last tile's last strip) match no byte, and
// at row 0 their diagonal term, the top edge left of them, is kNeg (row
// 0's E is set before the first step, so that edge serves nothing else):
// every path into them then loses score against a real cell for any
// parameters of the round-1 domain, so the max over a strip is the max
// over its real cells (without the kNeg a pair whose M < X - |E| could
// score higher in padding, through the top edge).  kNeg only ever takes
// one small term.  Rows past m_real are never computed.  Each pair
// returns the max of H over its real cells and H(m_real-1, n_real-1).
//
// What bounds it on the H100: the INT32 pipe, about 6.5 instructions a
// cell (a compare and a select for the substitution, four VIADDMNMX, half
// a VIMNMX3 for the row max) and ~20 a step; the fill and drain of each
// tile, and the columns a pair's last strip rounds up to.  No per-column
// term beyond the byte and the frontier is kept: at 32 columns a strip
// ptxas recomputed one a cell each step rather than hold it.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // warps a block
// the plan's cost model per lane (x2): a cell, and a step's fixed cost
constexpr long long kCellCost = 13, kStepCost = 40;
// the plan's blocks an SM (a sweep on the H100: fewer warps an SM ran the
// smoke's batch faster than the 3 blocks registers allow)
constexpr int kPerSm = 2;

// the strip widths, one build each (ops/psa_pallas.py SHORT_WIDTHS)
#define TSTA_SHORT_WIDTHS(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(10) X(12) X(14) X(16) X(20) X(24) \
  X(28) X(32)

struct Params {
  int mp, xp;  // M - e, X - e
  int e, o, oe;
};

__host__ __device__ inline long long short_cost(int n, int m, int w) {
  const int tile = kLanes * w;
  const int tiles = (n + tile - 1) / tile;
  const int last = (n - (tiles - 1) * tile + w - 1) / w;  // lanes of it
  return ((long long)(tiles - 1) * (m + kLanes - 1) + (m + last - 1)) *
         (kCellCost * w + kStepCost);
}

// The strip width of an n x m pair: the least modelled cost among the
// built widths, the narrowest on a tie.
__host__ __device__ inline int short_width(int n, int m) {
  int best_w = 0;
  long long best = 0;
  if (n < 1 || m < 1) return 2;
#define TSTA_TRY(w)                                      \
  {                                                      \
    const long long c = short_cost(n, m, w);             \
    if (best_w == 0 || c < best) best = c, best_w = w;   \
  }
  TSTA_SHORT_WIDTHS(TSTA_TRY)
#undef TSTA_TRY
  return best_w;
}

__host__ __device__ inline bool short_width_built(int w) {
#define TSTA_IS(x) if (w == x) return true;
  TSTA_SHORT_WIDTHS(TSTA_IS)
#undef TSTA_IS
  return false;
}

// One pair of n x m (n, m >= 1) at strips of W columns.  bnd: the warp's
// boundary buffer, m (H~, F~) rows.  Returns the lane's best and corner
// (kNeg on the lanes that hold neither).
template <int W>
__device__ __forceinline__ void short_pair(const uint8_t* __restrict__ a,
                                           const uint8_t* __restrict__ b,
                                           int n, int m, const Params p,
                                           int2* __restrict__ bnd, int lane,
                                           int& best_out, int& corner_out) {
  constexpr int kTile = kLanes * W;
  const int tiles = (n + kTile - 1) / kTile;
  const int edge = p.o + p.e;  // H~(r, -1) = F~(r, 0) for every r >= 0
  int best = kNeg, corner = kNeg;
  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kTile;
    const int lanes_t = min(kLanes, (n - c0 + W - 1) / W);
    const int j0 = c0 + lane * W;
    const int m_lane = lane < lanes_t ? m : 0;
    const bool load_bnd = lane == 0 && t > 0;
    const bool store_bnd = lane == kLanes - 1 && t + 1 < tiles;
    int ak[W], h[W], e[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = j0 + k;
      const int top = p.o + (j + 2) * p.e;  // H~(-1, j) = H(-1, j) + e
      ak[k] = j < n ? __ldg(a + j) : -1;    // -1 matches no byte
      // row 0's E~ is taken here, so the top edge serves only as the
      // next column's diagonal, which into padding is NEG
      h[k] = j < n - 1 ? top : kNeg;
      e[k] = top + p.o;
    }
    // lane 0's diagonal at row 0: H~(-1, c0 - 1), H(-1, -1) = 0
    int hd = t == 0 ? p.e : p.o + (c0 + 1) * p.e;
    int fout = 0;
    int2 bcur = make_int2(edge, edge);
    if (load_bnd) bcur = __ldcg(bnd);
    int r = -lane;
    int re = r * p.e;
    int bch = lane == 0 ? __ldg(b) : 0;
    const int steps = m + lanes_t - 1;
    for (int s = 0; s < steps; ++s) {
      // the next step's row byte and lane 0's boundary row, a step ahead
      const int rn = r + 1;
      int bnext = 0;
      if ((unsigned)rn < (unsigned)m_lane) bnext = __ldg(b + rn);
      int2 bnxt = make_int2(edge, edge);
      if (load_bnd && rn < m) bnxt = __ldcg(bnd + rn);
      // H~(r, j0 - 1) and F~(r, j0) from the left
      int hl = __shfl_up_sync(kFull, h[W - 1], 1);
      int fin = __shfl_up_sync(kFull, fout, 1);
      if (lane == 0) hl = bcur.x, fin = bcur.y;
      if ((unsigned)r < (unsigned)m_lane) {
        // right to left, C~ in place of the H~ above it, which the column
        // to its right has taken as its diagonal already; then F~ left to
        // right, H~ in place of C~
#pragma unroll
        for (int k = W - 1; k >= 0; --k) {
          e[k] = __viaddmax_s32(h[k], p.o, e[k]);
          h[k] = __viaddmax_s32(k ? h[k - 1] : hd,
                                ak[k] == bch ? p.mp : p.xp, e[k]);
        }
        int f = fin;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int c = h[k];
          h[k] = __viaddmax_s32(f, p.oe, c);
          f = __viaddmax_s32(f, p.e, c);
        }
        fout = f;
        int rm = h[0];
#pragma unroll
        for (int k = 1; k < W; k += 2)
          rm = __vimax3_s32(rm, h[k], h[k + 1 < W ? k + 1 : k]);
        best = __viaddmax_s32(rm, re, best);
        if (store_bnd) __stcg(bnd + r, make_int2(h[W - 1], f));
      }
      hd = hl;
      bch = bnext;
      bcur = bnxt;
      ++r;
      re += p.e;
    }
    if (t + 1 == tiles) {
      const int kc = n - 1 - j0;  // the corner's column in this strip
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k == kc) corner = h[k] + (m - 1) * p.e;
    }
    __syncwarp();  // the boundary rows, written, before the next tile reads
  }
  best_out = best;
  corner_out = corner;
}

__global__ void __launch_bounds__(kWarps * kLanes)
psa_dp_short_kernel(const uint8_t* __restrict__ a_all,
                    const uint8_t* __restrict__ b_all,
                    const int32_t* __restrict__ lens,
                    const int64_t* __restrict__ order, int B, int n_stride,
                    int m_stride, const Params p, int force_w,
                    int32_t* __restrict__ score, int32_t* __restrict__ corner,
                    int* __restrict__ next, int2* __restrict__ bnd_all) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int gw = blockIdx.x * kWarps + threadIdx.x / kLanes;
  int2* bnd = bnd_all + (size_t)gw * m_stride;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(next, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= B) break;
    const int pair = (int)order[k];
    const int n = lens[2 * pair], m = lens[2 * pair + 1];
    int best = kNeg, cor = kNeg;
    if (n >= 1 && m >= 1) {
      const uint8_t* a = a_all + (size_t)pair * n_stride;
      const uint8_t* b = b_all + (size_t)pair * m_stride;
      switch (force_w ? force_w : short_width(n, m)) {
#define TSTA_CASE(x)                                      \
  case x:                                                 \
    short_pair<x>(a, b, n, m, p, bnd, lane, best, cor);   \
    break;
        TSTA_SHORT_WIDTHS(TSTA_CASE)
#undef TSTA_CASE
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      best = max(best, __shfl_xor_sync(kFull, best, d));
      cor = max(cor, __shfl_xor_sync(kFull, cor, d));
    }
    if (lane == 0) score[pair] = best, corner[pair] = cor;
  }
}

}  // namespace

// The plan's strip width for an n x m pair.
extern "C" int tsta_psa_dp_short_width(int n, int m) {
  return short_width(n, m);
}

// Whether a strip width has a build.
extern "C" int tsta_psa_dp_short_width_built(int w) {
  return short_width_built(w) ? 1 : 0;
}

// The persistent blocks (kWarps warps each) a launch over B pairs takes on
// the current card at per_sm blocks an SM (<= 0: the plan's, kPerSm), at
// most as many as an SM holds, which *resident receives; -cudaError on
// failure.
extern "C" int tsta_psa_dp_short_layout(int B, int per_sm, int* resident) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, psa_dp_short_kernel, kWarps * kLanes, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *resident = occ;
  per_sm = std::max(1, std::min(per_sm > 0 ? per_sm : kPerSm, occ));
  return std::min((B + kWarps - 1) / kWarps, per_sm * sms);
}

// a: (B, n_stride) uint8, b: (B, m_stride) uint8, lens: (B, 2) int32 real
// (n, m), n <= n_stride, m <= m_stride; order: (B,) int64, the pairs in
// the order the warps take them; score, corner: (B,) int32, by input
// index.  scratch: 2 + 2 * blocks * kWarps * m_stride int32 (the counter,
// then each warp's boundary rows).  force_w: 0 for the plan, else a built
// width for every pair.  Returns cudaGetLastError() after the launch, or
// the error of the counter's reset; cudaErrorInvalidValue, without
// launching, for a force_w that has no build.
extern "C" int tsta_psa_dp_short(const void* a, const void* b,
                                 const void* lens, const void* order, int B,
                                 int n_stride, int m_stride, int M, int X,
                                 int E, int O, int force_w, int blocks,
                                 void* score, void* corner, void* scratch,
                                 void* stream) {
  if (force_w && !short_width_built(force_w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* next = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{M - E, X - E, E, O, O + E};
  int2* bnd = reinterpret_cast<int2*>(next + 2);
  psa_dp_short_kernel<<<blocks, kWarps * kLanes, 0, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int32_t*>(lens), static_cast<const int64_t*>(order),
      B, n_stride, m_stride, p, force_w, static_cast<int32_t*>(score),
      static_cast<int32_t*>(corner), next, bnd);
  return static_cast<int>(cudaGetLastError());
}
