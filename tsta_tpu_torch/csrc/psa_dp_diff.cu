// Score-only Gotoh DP by the difference method: the H/E frontier held as
// int16 offsets from per-segment int32 anchors, two columns to a 32-bit
// word, every cell updated with Hopper's s16x2 DPX max-plus instructions.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_diff.py:_diff_kernel (Q2-9,
// launched through _psa_diff_call with use_int16=True).  Its results are
// K1's (psa_dp.cu score-only): the matrix-max score and the corner
// H(m-1, n-1), int32 per pair, for every parameter set the caller's gate
// admits (ops/psa_diff.py supports_params_int16: M > 0 > X, E < 0, O <= 0
// and D = max(M, -X, -(O+E), -E) <= 57, the JAX package's gate).
//
// Design.  K1's shape: one block of 256 threads per pair, thread t owning
// a strip of W consecutive columns, each pair over its real extent (rows
// < m, columns < n rounded up to 4; the up to 3 columns past n hold A_PAD
// bytes, never match and so never raise the max).  Per row, pass 1 takes
// each segment's max of y = C(k) - k*e, a block-wide exclusive prefix max
// (dp_common.cuh) gives the F carry into each strip, and pass 2 walks the
// strip again and writes H and E.  The strip is cut into segments of G <=
// 128 columns, each with its own int32 anchor; W and G are set by layout()
// so that every segment of a strip has the same width and the segments
// form one grid of width G from column 0 (the plain version,
// ops/psa_diff.py scan_rows_int16, takes G as its parameter).  Two pairs
// per word (inter-pair SIMD) would avoid the F dependency inside a word
// but change the grid and the host packing and pair pairs of unequal
// length; two columns of one pair per word keep K1's grid and inputs.
//
// Per word (columns j, j+1 of one segment, l = j - segment start):
//   ev  = max(E + e, H(i-1) + o + e)               __viaddmax_s16x2
//   C   = max(H(i-1, j-1..j) + sub, ev)            __byte_perm, __viaddmax_s16x2
//   y   = C - (l*e, (l+1)*e)                       __vsub2
//   pre = (R, max(R, y.lo))                        __byte_perm, __vmaxs2
//   H   = max(C, (o + l*e, o + (l+1)*e) + pre)     __vadd2, __vmaxs2
//   R   = max(R, y.lo, y.hi) in both halves        __byte_perm, __vimax3_s16x2
// where R is the running max of y from the segment's carry on: the F
// dependency inside a word is one byte permutation and a max, in int16.
// The carry enters a segment as clip(run - beta, guard, 32767), beta =
// anchor - start*e, run the int32 prefix max; it leaves as R + beta.
//
// Ranges (D as above, G <= 128 columns, re-based every kReanchor = 16
// rows: the anchor moves to the segment's first H of the row, and every
// offset of the segment moves with it).  Adjacent-column H differences lie
// in [-D, 2D], and so does each column's change from a row to the next,
// so between re-bases every H offset lies in [-143D, 286D], E and C in
// [-144D, 286D], y in [-144D, 413D] (-l*e adds up to 127D), the carry
// below 288D and F in [-287D, 413D]: all within int16 for D <= 72, and
// the guard -160D (E of row -1, the carry's floor) sits below every y, so
// R + beta is max(run, the segment's max y) whether or not the clip took
// the carry up to the guard.  The widest intermediate is y at 413D =
// 23,541 for D = 57.  The best H is folded into int32 at the end of each
// segment of each row, before its anchor can move; the corner is read
// from the frontier and its anchor after the last row.
//
// What bounds it on the H100: about 30 integer instructions and six 4-byte
// frontier accesses through L1/L2 per word of two cells over the two
// passes (per cell 15 and 3, against K1's ~20 and 6), three barriers per
// row, one SM per pair.
//
// Scratch per pair: the H and E words, (Wmax / 2) * 256 each, interleaved
// as in K1 (word k of thread t at k * 256 + t), then the anchors, (Wmax /
// Gmax) * 256 int32 (segment s of thread t at s * 256 + t), with Wmax, Gmax
// the layout of n_stride.

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kThreads = 256;
constexpr int kSegMax = 128;    // widest segment one anchor carries
constexpr int kReanchor = 16;   // rows between re-bases (the JAX kernel's)
constexpr int kMaxDelta = 57;   // the callers' gate on D

// Strip width W (a multiple of 4, W * 256 >= n) and segment width G (a
// multiple of 4, at most kSegMax, dividing W) for n columns.
struct Layout {
  int W, G;
};

__host__ __device__ inline Layout layout(int n) {
  int w = (n + kThreads - 1) / kThreads;
  w = (w + 3) & ~3;
  const int nseg = (w + kSegMax - 1) / kSegMax;
  const int g = ((w + nseg - 1) / nseg + 3) & ~3;
  return {nseg * g, g};
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

__device__ __forceinline__ int lo16(uint32_t w) {
  return static_cast<int16_t>(w & 0xffffu);
}

__device__ __forceinline__ int hi16(uint32_t w) {
  return static_cast<int16_t>(w >> 16);
}

struct Params {
  int m, x, e, o, guard;  // guard = -160 * D, the int16 "minus infinity"
};

__global__ void __launch_bounds__(kThreads)
psa_dp_diff_kernel(const uint8_t* __restrict__ a_all,
                   const uint8_t* __restrict__ b_all,
                   const int32_t* __restrict__ lens, int n_stride,
                   int m_stride, Params p, int32_t* __restrict__ score,
                   int32_t* __restrict__ corner,
                   uint32_t* __restrict__ scratch, int scratch_stride) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const int pair = blockIdx.x;
  const int t = threadIdx.x;
  const int n_real = lens[2 * pair];
  const int m_real = lens[2 * pair + 1];
  const int n_ext = (n_real + 3) & ~3;
  const Layout L = layout(n_ext);
  const Layout Lmax = layout(n_stride);
  const int W = L.W, G = L.G;
  const int j0 = t * W;
  const int jend = min(j0 + W, n_ext);  // jend <= j0: no columns
  const uint8_t* a = a_all + (size_t)pair * n_stride;
  const uint8_t* b = b_all + (size_t)pair * m_stride;
  uint32_t* Hw = scratch + (size_t)pair * scratch_stride;
  uint32_t* Ew = Hw + (size_t)(Lmax.W / 2) * kThreads;
  int32_t* A = reinterpret_cast<int32_t*>(Ew + (size_t)(Lmax.W / 2) * kThreads);

  const uint32_t e2 = pack2(p.e, p.e);
  const uint32_t oe2 = pack2(p.o + p.e, p.o + p.e);
  const uint32_t x2 = pack2(p.x, p.x);
  const uint32_t mx2 = pack2(p.m, p.m) ^ x2;
  const uint32_t step2 = pack2(2 * p.e, 2 * p.e);
  const uint32_t guard2 = pack2(p.guard, p.guard);

  // row -1: anchor H(-1, start) = o + (start + 1)e, offsets l*e, E = guard
  for (int sj = j0, s = 0; sj < jend; sj += G, ++s) {
    A[s * kThreads + t] = p.o + (sj + 1) * p.e;
    for (int j = sj; j < min(sj + G, jend); j += 2) {
      const int k = (j - j0) >> 1;
      Hw[k * kThreads + t] = pack2((j - sj) * p.e, (j + 1 - sj) * p.e);
      Ew[k * kThreads + t] = guard2;
    }
  }
  s_edge[1][t] = p.o + (j0 + W) * p.e;  // H(-1, j0 + W - 1)
  __syncthreads();

  int best = kNeg;
  for (int i = 0; i < m_real; ++i) {
    const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
    const int bound_cur = p.o + (i + 1) * p.e;          // H(i, -1)
    const uint32_t b4 = 0x01010101u * b[i];
    const int hd0 = t == 0 ? bound_prev : s_edge[(i + 1) & 1][t - 1];

    // pass 1: each segment's max of y, absolute, maxed over the strip
    int agg = kNeg;
    int hd = hd0;  // H(i-1, start - 1), absolute
    for (int sj = j0, s = 0; sj < jend; sj += G, ++s) {
      const int alpha = A[s * kThreads + t];
      const int send = min(sj + G, jend);
      uint32_t prev = static_cast<uint32_t>(hd - alpha) << 16;
      uint32_t le = pack2(0, p.e);
      uint32_t ymax = guard2;
      for (int j = sj; j < send; j += 4) {
        const uint32_t eq =
            __vcmpeq4(__ldg(reinterpret_cast<const uint32_t*>(a + j)), b4);
        const int k = (j - j0) >> 1;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t sub = x2 ^ (__byte_perm(eq, 0, q ? 0x3322 : 0x1100) & mx2);
          const uint32_t hp = Hw[(k + q) * kThreads + t];
          const uint32_t ev =
              __viaddmax_s16x2(Ew[(k + q) * kThreads + t], e2, __vadd2(hp, oe2));
          const uint32_t c =
              __viaddmax_s16x2(__byte_perm(prev, hp, 0x5432), sub, ev);
          ymax = __vmaxs2(ymax, __vsub2(c, le));
          le = __vadd2(le, step2);
          prev = hp;
        }
      }
      agg = max(agg, max(lo16(ymax), hi16(ymax)) + alpha - sj * p.e);
      hd = hi16(prev) + alpha;
    }
    int run = tsta::block_excl_max<kThreads>(agg, bound_cur + p.e, s_warp);

    // pass 2: F, H, E; the best H folded per segment; re-base on every
    // kReanchor-th row
    const bool rebase = i % kReanchor == kReanchor - 1;
    hd = hd0;
    int hl = 0;  // H(i, jend - 1), absolute
    for (int sj = j0, s = 0; sj < jend; sj += G, ++s) {
      const int alpha = A[s * kThreads + t];
      const int beta = alpha - sj * p.e;
      const int send = min(sj + G, jend);
      const int carry = min(max(run - beta, p.guard), 32767);
      uint32_t R = pack2(carry, carry);
      uint32_t prev = static_cast<uint32_t>(hd - alpha) << 16;
      uint32_t le = pack2(0, p.e);
      uint32_t ole = pack2(p.o, p.o + p.e);
      uint32_t sbest = guard2;
      uint32_t delta = 0;  // (d, d): the re-base's shift, 0 on other rows
      uint32_t h = 0;
      for (int j = sj; j < send; j += 4) {
        const uint32_t eq =
            __vcmpeq4(__ldg(reinterpret_cast<const uint32_t*>(a + j)), b4);
        const int k = (j - j0) >> 1;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t sub = x2 ^ (__byte_perm(eq, 0, q ? 0x3322 : 0x1100) & mx2);
          const uint32_t hp = Hw[(k + q) * kThreads + t];
          const uint32_t ev =
              __viaddmax_s16x2(Ew[(k + q) * kThreads + t], e2, __vadd2(hp, oe2));
          const uint32_t c =
              __viaddmax_s16x2(__byte_perm(prev, hp, 0x5432), sub, ev);
          const uint32_t y = __vsub2(c, le);
          const uint32_t pre = __vmaxs2(R, __byte_perm(R, y, 0x5410));
          h = __vmaxs2(c, __vadd2(ole, pre));
          R = __vimax3_s16x2(R, y, __byte_perm(y, 0, 0x1032));
          sbest = __vmaxs2(sbest, h);
          if (q == 0 && rebase && j == sj) delta = __byte_perm(h, 0, 0x1010);
          Hw[(k + q) * kThreads + t] = __vsub2(h, delta);
          Ew[(k + q) * kThreads + t] = __vsub2(ev, delta);
          le = __vadd2(le, step2);
          ole = __vadd2(ole, step2);
          prev = hp;
        }
      }
      hd = hi16(prev) + alpha;
      hl = hi16(h) + alpha;
      run = lo16(R) + beta;  // max(run, the segment's max y): see Ranges
      best = max(best, max(lo16(sbest), hi16(sbest)) + alpha);
      if (rebase) A[s * kThreads + t] = alpha + lo16(delta);
    }
    s_edge[i & 1][t] = hl;
    __syncthreads();
  }

  // the corner: the last row's frontier word and its segment's anchor
  const int cn = n_real - 1;
  if (t == cn / W) {
    const int k = cn - j0;
    const uint32_t w = Hw[(k >> 1) * kThreads + t];
    corner[pair] = ((k & 1) ? hi16(w) : lo16(w)) + A[(k / G) * kThreads + t];
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

// The strip and segment widths the kernel takes for n columns, so that the
// plain version's (ops/psa_diff.py diff_layout) can be held to them.
extern "C" void tsta_psa_dp_diff_layout(int n, int* w, int* g) {
  const Layout L = layout(n);
  *w = L.W;
  *g = L.G;
}

extern "C" int tsta_psa_dp_diff_scratch_words(int n_stride) {
  const Layout L = layout(n_stride);
  return (L.W + L.W / L.G) * kThreads;
}

// a: (B, n_stride) uint8, n_stride a multiple of 4; b: (B, m_stride)
// uint8; lens: (B, 2) int32 real (n, m); score, corner: (B,) int32;
// scratch: (B, scratch_stride) 32-bit words, scratch_stride >=
// tsta_psa_dp_diff_scratch_words(n_stride).  Returns cudaErrorInvalidValue
// without launching for parameters outside the gate, else
// cudaGetLastError() after the launch.
extern "C" int tsta_psa_dp_diff(const void* a, const void* b, const void* lens,
                                int B, int n_stride, int m_stride, int M, int X,
                                int E, int O, void* score, void* corner,
                                void* scratch, int scratch_stride,
                                void* stream) {
  int D = 1;
  for (const int v : {M, -X, -(O + E), -E}) D = v > D ? v : D;
  if (!(M > 0 && X < 0 && E < 0 && O <= 0) || D > kMaxDelta ||
      n_stride % 4 != 0 ||
      scratch_stride < tsta_psa_dp_diff_scratch_words(n_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{M, X, E, O, -160 * D};
  psa_dp_diff_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int32_t*>(lens), n_stride, m_stride, p,
      static_cast<int32_t*>(score), static_cast<int32_t*>(corner),
      static_cast<uint32_t*>(scratch), scratch_stride);
  return static_cast<int>(cudaGetLastError());
}
