// Exact int32 Gotoh global-alignment DP, one thread block per pair.
//
// Replaces the TPU kernels tsta_tpu/ops/psa_diff.py:_abs_kernel in both of
// its uses, score-only (K1, launched through _psa_diff_call) and
// traced=True (K2, through _psa_diff_traced_call), the round-1 kernels
// tsta_tpu/ops/psa_pallas.py:_kernel (Q2-13: K1 score-only, K2 at P = 1
// traced) and :_batch_kernel (Q2-14: K1), and
// tsta_tpu/ops/psa_pallas.py:_kernel_chunk (Q2-7, through _psa_chunk_call),
// one row-chunk of a single pair's traced DP whose whole code plane the
// card cannot hold.  The TPU kernel packs P pairs along the sublanes of
// (P*Rp, 128) tiles; here each pair is one block and the batch is the
// grid, so 128 pairs fill 128 of the 132 SMs.
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
//           and writes H, E (and in traced mode the cell codes).
// The H/E frontier lives in global scratch in an interleaved layout
// (column t*W+k at k*kThreads+t) so that a warp's accesses are coalesced;
// it is per pair and has no length cap.  The diagonal term at a strip's
// first column, H(i-1, t*W-1), and the left term of its f code,
// H(i, t*W-1), come from the neighbour thread through a double-buffered
// shared edge array; the first code word of a strip is written after the
// row's final barrier, once the neighbour's H(i, t*W-1) is known.
//
// Score-only launches run each pair over its real extent; traced launches
// run every padded cell of the group (A_PAD/B_PAD bytes) so the code plane
// matches the JAX kernel's cell for cell.  Padding is exact whenever every
// move into it lowers the score, X < 0, E < 0 and O <= 0, whatever M: the
// round-1 kernels' domain (psa_pallas.py) as well as the packed ones'.
// Cell code = back*9 + f*3 + e: back 1 diag > 0 left (F) > 2 up (E); f/e
// 0 extend, 1 open, 2 open with an open/extend tie.  One byte per cell,
// row-major per pair: plane[pair][i][j].
//
// Chunk mode (kChunk, one pair, 1,024 threads): the block runs the rows
// [row_base, row_base + rows) from the frontier of row row_base - 1, given
// and returned in natural column order ((n,) int32 H and E; the kernel
// maps it into and out of its interleaved scratch, 1.6 MB at 200 kbp), and
// writes the chunk's (rows, n) code plane.  The boundary terms take the
// global row; a strip's first diagonal term at the chunk's first row is
// the entry frontier's H(row_base - 1, t*W - 1).  best is the chunk's max;
// corner is H(m_real-1, n_real-1) when the chunk holds that row, else NEG.
// The TPU kernel carries best and last as per-column (R, 128) state and
// writes 4 rows per int32 word; the caller here takes the max and the
// corner from the chunk that holds it.
//
// What bounds it on the H100: per cell about 20 integer operations and
// six 4-byte frontier accesses that hit L1/L2, plus three barriers per row
// and one resident block per pair, so a single pair uses one SM and the
// row barriers serialise it.  The chunk mode's wider block (1,024 threads,
// ~196 columns each at 200 kbp, against K1's 256 and ~782) keeps more
// frontier loads in flight per row.  Later work: anti-diagonal
// wavefronts, DPX max-plus instructions (__viaddmax_s32), shared-memory
// frontiers.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kPairThreads = 256;    // K1, K2: one block per pair of a batch
constexpr int kChunkThreads = 1024;  // Q2-7: one long pair

template <int kThreads>
__host__ __device__ inline int strip_width(int n) {
  int w = (n + kThreads - 1) / kThreads;
  return (w + 3) & ~3;
}

struct Params {
  int m, x, e, o;
};

// The chunk mode's frontier: (n,) int32 H and E of the row before the
// chunk (in) and of its last row (out), in natural column order.
struct Frontier {
  const int32_t* h_in;
  const int32_t* e_in;
  int32_t* h_out;
  int32_t* e_out;
};

template <int kThreads, bool kTraced, bool kChunk>
__global__ void __launch_bounds__(kThreads)
psa_dp_kernel(const uint8_t* __restrict__ a_all,
              const uint8_t* __restrict__ b_all,
              const int32_t* __restrict__ lens, int n_stride, int m_stride,
              Params p, int32_t* __restrict__ score,
              int32_t* __restrict__ corner, uint8_t* __restrict__ plane_all,
              int32_t* __restrict__ scratch, int scratch_stride,
              // the chunk mode's; last, so K1's and K2's parameters keep
              // the offsets they had before it and their code its schedule
              int row_base, Frontier fr) {
  static_assert(kTraced || !kChunk, "a chunk writes its code plane");
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const int pair = blockIdx.x;
  const int t = threadIdx.x;
  const int n_real = lens[2 * pair];
  const int m_real = lens[2 * pair + 1];
  const int n_ext = kTraced ? n_stride : n_real;
  const int m_ext = kTraced ? m_stride : m_real;
  const int W = strip_width<kThreads>(n_ext);
  const int j0 = t * W;
  const int jend = min(j0 + W, n_ext);  // jend <= j0: no columns
  const uint8_t* a = a_all + (size_t)pair * n_stride;
  const uint8_t* b = b_all + (size_t)pair * m_stride;
  int32_t* H = scratch + (size_t)pair * scratch_stride;
  int32_t* E = H + (size_t)W * kThreads;
  uint8_t* plane =
      kTraced ? plane_all + (size_t)pair * m_stride * n_stride : nullptr;
  const int oe = p.o + p.e;

  // the row before the first: row -1, or the chunk's entry frontier
  for (int j = j0; j < jend; ++j) {
    const int k = (j - j0) * kThreads + t;
    H[k] = kChunk ? fr.h_in[j] : p.o + (j + 1) * p.e;
    E[k] = kChunk ? fr.e_in[j] : kNeg;
  }
  if (kChunk) {
    s_edge[1][t] = jend > j0 ? fr.h_in[jend - 1] : 0;
    if (t == 0) corner[pair] = kNeg;  // set below only by the chunk of m-1
  } else {
    s_edge[1][t] = p.o + (j0 + W) * p.e;  // H(-1, j0 + W - 1)
  }
  __syncthreads();

  int best = kNeg;
  for (int r = 0; r < m_ext; ++r) {
    const int i = kChunk ? row_base + r : r;  // the global row
    const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
    const int bound_cur = p.o + (i + 1) * p.e;          // H(i, -1)
    const int bi = b[r];
    const int hd0 = t == 0 ? bound_prev : s_edge[(r + 1) & 1][t - 1];

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

    // pass 2: F, H, codes
    hd = hd0;
    int hl = 0;  // H(i, j-1)
    uint32_t word = 0, first_word = 0;
    int f0 = 0, rest0 = 0;
    bool tie0 = false;
    uint8_t* prow = kTraced ? plane + (size_t)r * n_stride : nullptr;
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
      if (kTraced) {
        const int back = h == diag ? 1 : (h == f ? 0 : 2);
        const bool f_tie = f + p.e == h + oe;
        const int ecode = ev == hp + oe ? (ev + p.e == h + oe ? 2 : 1) : 0;
        const int rest = back * 9 + ecode;
        int code = 0;
        if (j == j0) {  // f code needs the neighbour's H(i, j0-1)
          f0 = f;
          tie0 = f_tie;
          rest0 = rest;
        } else {
          code = rest + 3 * (f == hl + oe ? (f_tie ? 2 : 1) : 0);
        }
        const int q = (j - j0) & 3;
        word |= (uint32_t)code << (8 * q);
        if (q == 3) {
          if (j - j0 == 3) {
            first_word = word;
          } else {
            *reinterpret_cast<uint32_t*>(prow + j - 3) = word;
          }
          word = 0;
        }
      }
      hd = hp;
      hl = h;
    }
    s_edge[r & 1][t] = hl;  // H(i, jend - 1)
    __syncthreads();
    if (kTraced && jend > j0) {
      const int hleft = t == 0 ? bound_cur : s_edge[r & 1][t - 1];
      const int fcode = f0 == hleft + oe ? (tie0 ? 2 : 1) : 0;
      first_word |= (uint32_t)(rest0 + 3 * fcode);
      *reinterpret_cast<uint32_t*>(prow + j0) = first_word;
    }
  }

  if (kChunk) {  // each thread hands back its own strip
    for (int j = j0; j < jend; ++j) {
      const int k = (j - j0) * kThreads + t;
      fr.h_out[j] = H[k];
      fr.e_out[j] = E[k];
    }
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
  return 2 * strip_width<kPairThreads>(n_stride) * kPairThreads;
}

extern "C" int tsta_psa_dp_chunk_scratch_words(int n_stride) {
  return 2 * strip_width<kChunkThreads>(n_stride) * kChunkThreads;
}

// a: (B, n_stride) uint8, b: (B, m_stride) uint8, lens: (B, 2) int32 real
// (n, m); score, corner: (B,) int32; plane: (B, m_stride, n_stride) uint8
// or null for score-only; scratch: (B, scratch_stride) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int tsta_psa_dp(const void* a, const void* b, const void* lens,
                           int B, int n_stride, int m_stride, int M, int X,
                           int E, int O, void* score, void* corner,
                           void* plane, void* scratch, int scratch_stride,
                           void* stream) {
  const Params p{M, X, E, O};
  const Frontier none{nullptr, nullptr, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plane != nullptr) {
    psa_dp_kernel<kPairThreads, true, false><<<B, kPairThreads, 0, s>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<const int32_t*>(lens), n_stride, m_stride, p,
        static_cast<int32_t*>(score), static_cast<int32_t*>(corner),
        static_cast<uint8_t*>(plane), static_cast<int32_t*>(scratch),
        scratch_stride, 0, none);
  } else {
    psa_dp_kernel<kPairThreads, false, false><<<B, kPairThreads, 0, s>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<const int32_t*>(lens), n_stride, m_stride, p,
        static_cast<int32_t*>(score), static_cast<int32_t*>(corner),
        nullptr, static_cast<int32_t*>(scratch), scratch_stride, 0, none);
  }
  return static_cast<int>(cudaGetLastError());
}

// One row-chunk of one pair (chunk mode).  a: (n_stride,) uint8; b:
// (rows,) uint8, the chunk's rows [row_base, row_base + rows); lens: (2,)
// int32 real (n, m); h_in, e_in: (n_stride,) int32 frontier of row
// row_base - 1; h_out, e_out: (n_stride,) int32 frontier of the chunk's
// last row; best, corner: (1,) int32; plane: (rows, n_stride) uint8;
// scratch: tsta_psa_dp_chunk_scratch_words(n_stride) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int tsta_psa_dp_chunk(const void* a, const void* b,
                                 const void* lens, int n_stride, int rows,
                                 int row_base, int M, int X, int E, int O,
                                 const void* h_in, const void* e_in,
                                 void* h_out, void* e_out, void* best,
                                 void* corner, void* plane, void* scratch,
                                 void* stream) {
  const Params p{M, X, E, O};
  const Frontier fr{static_cast<const int32_t*>(h_in),
                    static_cast<const int32_t*>(e_in),
                    static_cast<int32_t*>(h_out),
                    static_cast<int32_t*>(e_out)};
  psa_dp_kernel<kChunkThreads, true, true>
      <<<1, kChunkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
          static_cast<const int32_t*>(lens), n_stride, rows, p,
          static_cast<int32_t*>(best), static_cast<int32_t*>(corner),
          static_cast<uint8_t*>(plane), static_cast<int32_t*>(scratch),
          tsta_psa_dp_chunk_scratch_words(n_stride), row_base, fr);
  return static_cast<int>(cudaGetLastError());
}
