// Score-only Gotoh DP by the difference method: P pairs, each pair's
// columns cut into D shards of co-resident 256-thread blocks, the H/E
// frontier of a shard held as int16 offsets from per-segment int32
// anchors, two columns to a 32-bit word, every cell updated with Hopper's
// s16x2 DPX max-plus instructions.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_diff.py:_diff_kernel (Q2-9,
// launched through _psa_diff_call with use_int16=True).  Its results are
// K1's (psa_dp.cu score-only): the matrix-max score and the corner
// H(m-1, n-1), int32 per pair, for every parameter set the caller's gate
// admits (ops/psa_diff.py supports_params_int16: M > 0 > X, E < 0, O <= 0
// and D = max(M, -X, -(O+E), -E) <= 57, the JAX package's gate).
//
// Schedule: K1's (psa_dp_score.cuh, whose launch_shards() launches it).  A
// one-dimensional grid of P * D blocks, block pair * D + d on the global
// columns [d*C, d*C + Cd), an ordinary launch at D = 1 and one cooperative
// launch at D >= 2, refused without launching past the co-resident limit
// (ring_common.cuh); each pair over its real extent, rows < m and columns < n
// rounded up to 4 (the up to 3 columns past n hold A_PAD bytes, never match
// and so never raise the max); per row two strip passes around a block-wide
// exclusive prefix max (dp_common.cuh); a two-lane int32 packet a row to the
// right neighbour behind release flags, slots never reused; per-shard (best,
// corner), NEG where the corner is not in the shard, reduced by a max after
// the launch.
//
// Plan (diff_plan(), the wrapper's twin psa_diff.diff_plan): K1's shards
// (psa_dp_score.cuh's plan() for the same pairs and card, so the two cannot
// drift), cut(): the strip w = ceil(ceil(n_pad / D) / 256) columns a thread,
// at least kWordMinW, rounded up to 4 and cut into nseg = ceil(w / 128)
// segments of G = ceil(w / nseg) rounded up to 4, W = nseg * G; C =
// ceil(n_pad / D) rounded up to whole segments (n_pad when that is less), D =
// ceil(n_pad / C), T = kT.  A shard of Cd columns runs strips of Wd = G *
// ceil(Cd / (256 * G)) <= W columns, so a narrow shard leaves threads idle
// rather than take fewer blocks than K1 (PERF.md: at 32 x 10,240 eight shards
// of 1,280 columns beat five of 2,048).  C and every strip start are multiples
// of G, the segments form one grid of width G from column 0 that never
// straddles a strip or a shard, and ops/psa_diff.py scan_rows_int16 at G is
// the plain version of every plan.
//
// Inside a shard.  Thread t owns the strip [t*Wd, t*Wd + Wd) of the
// shard's columns, cut into segments of G columns, each with its own int32
// anchor.  The H words, the E + e words and the row's C words (int16
// offsets, column pairs) and the shard's slab of a (4-byte words of 4
// columns) live in shared memory, interleaved (word k of thread t at k *
// 256 + t), when they fit beside the packet (6 bytes a column for H, E and
// C against K1's 8 for H and E: W <= 124, so a strip is one segment and
// its anchor a register); else the frontier and the anchors go to a
// global scratch and a is read from device memory.
//
// Per word (columns j, j+1 of one segment, l = j - segment start), pass 1:
//   ev  = max(H(i-1) + o + e, E(i-1) + e)          __viaddmax_s16x2
//   C   = max(H(i-1, j-1..j) + sub, ev)            __byte_perm, __viaddmax_s16x2
//   E + e for the next row                         __viaddmax_s16x2 (with guard)
//   ymax = max(ymax, C - (l*e, (l+1)*e))           __viaddmax_s16x2
// and pass 2, from the stored C:
//   pre = (R, max(R, y.lo))                        __byte_perm, __vmaxs2
//   H   = max(C, (o + l*e, o + (l+1)*e) + pre)     __viaddmax_s16x2
//   R   = max(R, y.lo, y.hi) in both halves        __byte_perm, __vimax3_s16x2
// where R is the running max of y from the segment's carry on: the F
// dependency inside a word is one byte permutation and a max, in int16.
// The carry enters a segment as clip(run - beta, guard, 32767), beta =
// anchor - start*e, run the int32 prefix max; it leaves as R + beta.  No
// packed add is the emulated __vadd2 or __vsub2: each is the add of a DPX
// max-plus whose max is the guard (below every value in the ranges
// below, so the max never bites and the add is exact) or, for -l*e, a
// 32-bit add of halves that cannot carry.
//
// The shard's edge.  No int16 value crosses a block: the packet is K1's
// two int32 lanes, H(i-1, the shard's last column) and the inclusive F
// prefix of row i there, both absolute.  Shard d takes the first as the
// diagonal term of its first column, converted into its first segment's
// offsets as a strip's left neighbour's H is (H(i-1, start-1) - anchor),
// and the second as the seed of the row's block scan, so the carry into its
// first segment is clipped into offsets exactly as every segment's carry
// is.  The shard's first column is a segment's first column, so a shard's
// edge is a segment's edge and the ranges below hold unchanged.
//
// Ranges (D as above, G <= 128 columns, re-based every kReanchor = 16
// rows of the global row index: the anchor moves to the segment's first H
// of the row, and every offset of the segment moves with it).
// Adjacent-column H differences lie in [-D, 2D], and so does each column's
// change from a row to the next, so between re-bases every H offset lies
// in [-143D, 286D], E and C in [-144D, 286D], y in [-144D, 413D] (-l*e
// adds up to 127D), the carry below 288D and F in [-287D, 413D]: all
// within int16 for D <= 72, and the guard -160D (E of row -1, the carry's
// floor) sits below every y, so R + beta is max(run, the segment's max y)
// whether or not the clip took the carry up to the guard; that sum, at the
// shard's last column, is the packet's F prefix.  The widest intermediate
// is y at 413D = 23,541 for D = 57.  The best H is folded into int32 at the
// end of each segment of each row, before its anchor can move; the corner
// is read from the frontier and its anchor after the last row.
//
// What bounds it on the H100: K1's function at two cells per s16x2
// instruction.  By its SASS a word of two cells is ~17 instructions in
// pass 1 and ~10 in pass 2, 6 of them DPX (which issue at half the rate
// of a plain int32 max on this card: PERF.md, the dtype-max probe), so a
// cell costs ~2/3 of K1's; the row's fixed cost (three barriers, a block
// scan, a share of a packet), ~0.7 us in both, stays.  The emulated
// __vadd2 and __vsub2 (several instructions each) and the interleaved
// index (an IMAD a word) had made the first build's cell as dear as K1's.

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

// K1's scaffold: kThreads, kWarps, kT, kSmemMax, its plan() and
// launch_shards()
#include "psa_dp_score.cuh"

namespace {

constexpr int kWordMinW = 4;    // columns a thread, at least: a word of a
constexpr int kSegMax = 128;    // widest segment one anchor carries
constexpr int kReanchor = 16;   // rows between re-bases (the JAX kernel's)
constexpr int kMaxDelta = 57;   // the callers' gate on D
constexpr uint32_t kSign2 = 0x80008000u;  // each half's sign bit

struct DiffParams {
  int m, x, e, o, guard;  // guard = -160 * D, the int16 "minus infinity"
};

struct Diff {
  const uint8_t* a;      // (P, n_pad), n_pad a multiple of 4
  const uint8_t* b;      // (P, m_stride)
  const int32_t* lens;   // (P, 2): real n, m
  int32_t* out;          // (P, D, 2): each shard's best and corner
  int32_t* comm;         // (P, D, m_blocks, 2T), or null at D = 1
  int32_t* flags;        // (P, D, m_blocks), zero; null with comm
  uint32_t* scratch;     // (P, D, frontier_words(W, G)) or null
  int n_pad, m_stride, C, D, W, G, T, m_blocks;
  DiffParams p;
};

// Ints of a shard's frontier: H, E + e and the row's C words, (W / 2) *
// 256 each, then (in the global scratch) the anchors, (W / G) * 256.
__host__ __device__ inline int frontier_words(int W, int G) {
  return (3 * W / 2 + W / G) * kThreads;
}

// Dynamic shared memory of a block of W columns a thread, segments of G
// and T-row packets, and whether its frontier goes to the global scratch:
// the packet (2T ints), then, unless global, the H, E + e and C words and
// a ((W / 4) * 256 words); the anchor of a strip of one segment is a
// register.
size_t diff_smem_bytes(int W, int G, int T, bool* global) {
  const size_t pkt = 2 * sizeof(int32_t) * (size_t)T;
  const size_t shard = sizeof(int32_t) * (size_t)(3 * W / 2 + W / 4) *
                       kThreads;
  *global = W != G || pkt + shard > kSmemMax;
  return *global ? pkt : pkt + shard;
}

// The cut of n_pad columns into D shards: a strip of at least
// ceil(n_pad / D) / 256 columns (kWordMinW at least) rounded up to 4 and cut
// into nseg = ceil(w / kSegMax) segments of G columns, G rounded up to 4,
// W = nseg * G; C = ceil(n_pad / D) rounded up to whole segments (n_pad
// when that is less), so ceil(n_pad / C) <= D shards.
void cut(int n_pad, int D, int* C, int* W, int* G) {
  const int span = (n_pad + D - 1) / D;
  int w = (span + kThreads - 1) / kThreads;
  w = ((w > kWordMinW ? w : kWordMinW) + 3) & ~3;
  const int nseg = (w + kSegMax - 1) / kSegMax;
  *G = ((w + nseg - 1) / nseg + 3) & ~3;
  *W = nseg * *G;
  const int c = (span + *G - 1) / *G * *G;
  *C = c < n_pad ? c : n_pad;
}

// K1's shard count (psa_dp_score.cuh's plan()) cut by cut(); K1's T.
void diff_plan(int P, int n_pad, int sms, int* D, int* C, int* W, int* G,
               int* T) {
  int d1, c1, w1;
  plan(P, n_pad, sms, &d1, &c1, &w1, T);
  cut(n_pad, d1, C, W, G);
  *D = (n_pad + *C - 1) / *C;
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

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
psa_dp_diff_kernel(const Diff k) {
  extern __shared__ int32_t s_dyn[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const DiffParams p = k.p;
  const int pair = blockIdx.x / k.D;
  const int d = blockIdx.x - pair * k.D;
  const size_t shard = (size_t)pair * k.D + d;  // (pair, d) in the packets
  const int t = threadIdx.x;
  const int T = k.T, G = k.G;
  const int n_ext = (k.lens[2 * pair] + 3) & ~3;
  const int n_real = k.lens[2 * pair], m_real = k.lens[2 * pair + 1];
  const int col0 = d * k.C;                 // global index of column 0
  const int Cd = min(k.C, n_ext - col0);    // this shard's columns
  int32_t* out = k.out + 2 * shard;
  if (Cd <= 0) {  // wholly past the pair's columns: nobody waits on it
    if (t == 0) {
      out[0] = kNeg;
      out[1] = kNeg;
    }
    return;
  }
  // the strip: whole segments, as few as cover Cd
  const int W = G * ((Cd + kThreads * G - 1) / (kThreads * G));
  const int Wp = k.W;                       // the allocation's strip
  const int j0 = t * W;
  const int jend = min(j0 + W, Cd);         // jend <= j0: no columns
  const int t_last = (Cd - 1) / W;          // owns the shard's last column
  const bool send = k.comm != nullptr && col0 + Cd < n_ext;
  int32_t* s_pkt = s_dyn;
  uint32_t* Hw = kGlobal ? k.scratch + shard * frontier_words(Wp, G)
                         : reinterpret_cast<uint32_t*>(s_dyn + 2 * T);
  uint32_t* Ew = Hw + (size_t)(Wp / 2) * kThreads;
  uint32_t* Cw = Ew + (size_t)(Wp / 2) * kThreads;
  // the anchors: (Wp / G) * 256 after the frontier in the global scratch;
  // with the shared-memory frontier a strip is one segment (W <= 124 < 128
  // there), so its one anchor lives in a register
  int32_t* A = reinterpret_cast<int32_t*>(Cw + (size_t)(Wp / 2) * kThreads);
  uint32_t* s_a = reinterpret_cast<uint32_t*>(A);
  const int Gs = kGlobal ? G : W;           // a segment of this strip
  int anchor = 0;
  auto get_anchor = [&](int s) {
    return kGlobal ? A[s * kThreads + t] : anchor;
  };
  auto set_anchor = [&](int s, int v) {
    if (kGlobal) A[s * kThreads + t] = v; else anchor = v;
  };
  const uint8_t* a = k.a + (size_t)pair * k.n_pad + col0;
  const uint8_t* b = k.b + (size_t)pair * k.m_stride;
  const size_t slab = (size_t)k.m_blocks * 2 * T;
  // used only where send (mine) or d > 0 (the left shard's)
  int32_t* my_comm = k.comm + shard * slab;
  const int32_t* left_comm = k.comm + (shard - 1) * slab;
  int32_t* my_flags = k.flags + shard * k.m_blocks;
  const int32_t* left_flags = k.flags + (shard - 1) * k.m_blocks;
  const unsigned long long wait_ns = tsta::wait_limit_ns(d, T, W);

  const uint32_t e2 = pack2(p.e, p.e);
  const uint32_t oe2 = pack2(p.o + p.e, p.o + p.e);
  const uint32_t x2 = pack2(p.x, p.x);
  const uint32_t mx2 = pack2(p.m, p.m) ^ x2;
  const uint32_t guard2 = pack2(p.guard, p.guard);
  // -l*e for the word's two columns, (0, -e) at a segment's first word,
  // both halves non-negative and below 2^15 (l < 128, -e <= 57), so a
  // 32-bit add of (-2e, -2e) steps it a word with no carry between the
  // halves; o + l*e is (obias - nle) ^ kSign2, obias the halves o + 2^15
  const uint32_t nle0 = pack2(0, -p.e);
  const uint32_t step2 = pack2(-2 * p.e, -2 * p.e);
  const uint32_t obias = pack2(p.o + 32768, p.o + 32768);

  // row -1: anchor H(-1, start) = o + (start + 1)e, offsets l*e, E + e =
  // guard (below every H + o + e, so the first row takes H + o + e)
  for (int sj = j0, s = 0; sj < jend; sj += Gs, ++s) {
    set_anchor(s, p.o + (col0 + sj + 1) * p.e);
    for (int j = sj; j < min(sj + Gs, jend); j += 2) {
      const int q = (j - j0) >> 1;
      Hw[q * kThreads + t] = pack2((j - sj) * p.e, (j + 1 - sj) * p.e);
      Ew[q * kThreads + t] = guard2;
    }
  }
  if (!kGlobal)
    for (int j = j0; j < jend; j += 4)
      s_a[((j - j0) >> 2) * kThreads + t] =
          *reinterpret_cast<const uint32_t*>(a + j);
  s_edge[1][t] = p.o + (col0 + jend) * p.e;  // H(-1, jend - 1)
  int edge = p.o + (col0 + Cd) * p.e;         // H(i-1, last column)
  int best = kNeg;
  __syncthreads();

  const int mb = (m_real + T - 1) / T;
  for (int rb = 0; rb < mb; ++rb) {
    if (d > 0) {
      if (t == 0) tsta::wait_flag(left_flags + rb, wait_ns);
      __syncthreads();
      for (int q = t; q < 2 * T; q += kThreads)
        s_pkt[q] = __ldcg(left_comm + (size_t)rb * 2 * T + q);
      __syncthreads();
    }
    int32_t* pkt_out = my_comm + (size_t)rb * 2 * T;
    const int nr = min(T, m_real - rb * T);
    for (int r = 0; r < nr; ++r) {
      const int i = rb * T + r;
      const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
      const int seed = d == 0 ? p.o + (i + 1) * p.e + p.e : s_pkt[T + r];
      const int fill = d == 0 ? bound_prev : s_pkt[r];
      const uint32_t b4 = 0x01010101u * b[i];
      const int hd0 = t == 0 ? fill : s_edge[(i + 1) & 1][t - 1];

      // pass 1: C and E of each word, kept for pass 2 and the next row;
      // each segment's max of y, absolute, maxed over the strip
      int agg = kNeg;
      int hd = hd0;  // H(i-1, start - 1), absolute
      for (int sj = j0, s = 0; sj < jend; sj += Gs, ++s) {
        const int alpha = get_anchor(s);
        const int nw = (min(sj + Gs, jend) - sj) >> 1;  // words, even
        const size_t w0 = (size_t)((sj - j0) >> 1) * kThreads + t;
        uint32_t* hw = Hw + w0;
        uint32_t* ew = Ew + w0;
        uint32_t* cw = Cw + w0;
        const uint32_t* aw = kGlobal
            ? reinterpret_cast<const uint32_t*>(a + sj)
            : s_a + (size_t)((sj - j0) >> 2) * kThreads + t;
        uint32_t prev = static_cast<uint32_t>(hd - alpha) << 16;
        uint32_t nle = nle0;
        uint32_t ymax = guard2;
        for (int k = 0; k < nw; k += 2) {
          const uint32_t eq = __vcmpeq4(kGlobal ? __ldg(aw) : *aw, b4);
          aw += kGlobal ? 1 : kThreads;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const uint32_t sub =
                x2 ^ (__byte_perm(eq, 0, h2 ? 0x3322 : 0x1100) & mx2);
            const uint32_t hp = hw[h2 * kThreads];
            const uint32_t ev = __viaddmax_s16x2(hp, oe2, ew[h2 * kThreads]);
            const uint32_t c =
                __viaddmax_s16x2(__byte_perm(prev, hp, 0x5432), sub, ev);
            cw[h2 * kThreads] = c;
            // E + e, the next row's
            ew[h2 * kThreads] = __viaddmax_s16x2(ev, e2, guard2);
            ymax = __viaddmax_s16x2(c, nle, ymax);  // y = C - l*e
            nle += step2;
            prev = hp;
          }
          hw += 2 * kThreads;
          ew += 2 * kThreads;
          cw += 2 * kThreads;
        }
        agg = max(agg, max(lo16(ymax), hi16(ymax)) + alpha - (col0 + sj) * p.e);
        hd = hi16(prev) + alpha;
        if (!kGlobal) break;
      }
      int run = tsta::block_excl_max<kThreads>(agg, seed, s_warp);

      // pass 2: F and H; the best H folded per segment; re-base on every
      // kReanchor-th row
      int hl = 0;  // H(i, jend - 1), absolute
      for (int sj = j0, s = 0; sj < jend; sj += Gs, ++s) {
        const int alpha = get_anchor(s);
        const int beta = alpha - (col0 + sj) * p.e;
        const int nw = (min(sj + Gs, jend) - sj) >> 1;
        const size_t w0 = (size_t)((sj - j0) >> 1) * kThreads + t;
        uint32_t* hw = Hw + w0;
        const uint32_t* cw = Cw + w0;
        const int carry = min(max(run - beta, p.guard), 32767);
        uint32_t R = pack2(carry, carry);
        uint32_t nle = nle0;
        uint32_t sbest = guard2;
        uint32_t h = 0;
        if (i % kReanchor != kReanchor - 1) {
#pragma unroll 2
          for (int k = 0; k < nw; ++k) {
            const uint32_t c = *cw;
            const uint32_t y = __viaddmax_s16x2(c, nle, guard2);
            const uint32_t pre = __vmaxs2(R, __byte_perm(R, y, 0x5410));
            h = __viaddmax_s16x2((obias - nle) ^ kSign2, pre, c);
            R = __vimax3_s16x2(R, y, __byte_perm(y, 0, 0x1032));
            sbest = __vmaxs2(sbest, h);
            *hw = h;
            nle += step2;
            cw += kThreads;
            hw += kThreads;
          }
        } else {  // re-base: every offset of the segment less its first H
          uint32_t* ew = Ew + w0;
          uint32_t nd2 = 0;  // (-d, -d)
          for (int k = 0; k < nw; ++k) {
            const uint32_t c = *cw;
            const uint32_t y = __viaddmax_s16x2(c, nle, guard2);
            const uint32_t pre = __vmaxs2(R, __byte_perm(R, y, 0x5410));
            h = __viaddmax_s16x2((obias - nle) ^ kSign2, pre, c);
            R = __vimax3_s16x2(R, y, __byte_perm(y, 0, 0x1032));
            sbest = __vmaxs2(sbest, h);
            if (k == 0) nd2 = pack2(-lo16(h), -lo16(h));
            *hw = __viaddmax_s16x2(h, nd2, guard2);
            *ew = __viaddmax_s16x2(*ew, nd2, guard2);
            nle += step2;
            cw += kThreads;
            hw += kThreads;
            ew += kThreads;
          }
          set_anchor(s, alpha - lo16(nd2));
        }
        hl = hi16(h) + alpha;
        run = lo16(R) + beta;  // max(run, the segment's max y): see Ranges
        best = max(best, max(lo16(sbest), hi16(sbest)) + alpha);
        if (!kGlobal) break;
      }
      s_edge[i & 1][t] = hl;  // H(i, jend - 1)
      if (t == t_last && send) {
        pkt_out[r] = edge;      // H(i-1, last column)
        pkt_out[T + r] = run;   // inclusive F prefix of row i
        edge = hl;
      }
      __syncthreads();
    }
    if (t == t_last && send) tsta::publish(my_flags + rb);
  }

  // the corner: the last row's frontier word and its segment's anchor
  const int cn = n_real - 1 - col0;
  int corner = kNeg;
  if (cn >= 0 && cn < Cd && t == cn / W) {
    const int c = cn - j0;
    const uint32_t w = Hw[(c >> 1) * kThreads + t];
    corner = ((c & 1) ? hi16(w) : lo16(w)) + get_anchor(c / Gs);
  }
  best = tsta::block_max<kThreads>(best, s_warp);
  corner = tsta::block_max<kThreads>(corner, s_warp);
  if (t == 0) {
    out[0] = best;
    out[1] = corner;
  }
}

int diff_max_blocks(int W, int G, int T) {
  bool global;
  const size_t smem = diff_smem_bytes(W, G, T, &global);
  return global
             ? tsta::coresident_limit(psa_dp_diff_kernel<true>, kThreads, smem)
             : tsta::coresident_limit(psa_dp_diff_kernel<false>, kThreads,
                                      smem);
}

}  // namespace

// The plan for P pairs of n_pad columns on a card of sms SMs: D shards of
// C columns (the last one n_pad - (D-1)*C), W columns a thread in segments
// of G, T rows a packet.  The wrapper's twin is psa_diff.diff_plan.
extern "C" void tsta_psa_dp_diff_plan(int P, int n_pad, int sms, int* D,
                                      int* C, int* W, int* G, int* T) {
  diff_plan(P, n_pad, sms, D, C, W, G, T);
}

// Words of global frontier scratch a shard of W columns a thread in
// segments of G, with T-row packets (0 when it fits in shared memory).
extern "C" int tsta_psa_dp_diff_scratch_words(int W, int G, int T) {
  bool global;
  diff_smem_bytes(W, G, T, &global);
  return global ? frontier_words(W, G) : 0;
}

// The most shards of W columns a thread in segments of G with T-row
// packets the current card holds resident at once; a negative value is
// minus a CUDA error.
extern "C" int tsta_psa_dp_diff_max_blocks(int W, int G, int T) {
  return diff_max_blocks(W, G, T);
}

// a: (P, n_pad) uint8, n_pad a multiple of 4; b: (P, m_stride) uint8; lens:
// (P, 2) int32 real (n, m); D shards of C columns ((D-1)*C < n_pad <= D*C),
// W columns a thread in segments of G (G a multiple of 4, at most 128,
// dividing W and, at D >= 2, C; W at least a shard's strip, G * ceil(C /
// (256 * G))), T rows a packet; comm: (P, D,
// ceil(m_stride / T), 2T) int32 and flags: (P, D, ceil(m_stride / T))
// int32, zero, both null at D = 1; out: (P, D, 2) int32; scratch: (P, D,
// tsta_psa_dp_diff_scratch_words(W, G, T)) 32-bit words or null.  Returns
// cudaErrorInvalidValue without launching for parameters outside the gate
// or a plan the body cannot run, cudaErrorCooperativeLaunchTooLarge
// without launching when P * D >= 2 blocks cannot be resident together,
// else cudaGetLastError() after the launch.
extern "C" int tsta_psa_dp_diff(const void* a, const void* b, const void* lens,
                                int P, int n_pad, int m_stride, int M, int X,
                                int E, int O, int D, int C, int W, int G,
                                int T, void* comm, void* flags, void* out,
                                void* scratch, void* stream) {
  int delta = 1;
  for (const int v : {M, -X, -(O + E), -E}) delta = v > delta ? v : delta;
  if (!(M > 0 && X < 0 && E < 0 && O <= 0) || delta > kMaxDelta)
    return (int)cudaErrorInvalidValue;
  if (P < 1 || D < 1 || C < 1 || T < 1 || m_stride < 1 || n_pad % 4 != 0 ||
      G < 4 || G > kSegMax || G % 4 != 0 || W % G != 0 ||
      (long long)G * ((C + kThreads * G - 1) / (kThreads * G)) > W ||
      (D >= 2 && C % G != 0) ||
      (long long)(D - 1) * C >= n_pad || n_pad > (long long)D * C ||
      (D >= 2 && (comm == nullptr || flags == nullptr)))
    return (int)cudaErrorInvalidValue;
  bool global;
  const size_t smem = diff_smem_bytes(W, G, T, &global);
  if (smem > kSmemMax || (global && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Diff k{static_cast<const uint8_t*>(a),
               static_cast<const uint8_t*>(b),
               static_cast<const int32_t*>(lens),
               static_cast<int32_t*>(out),
               static_cast<int32_t*>(comm),
               static_cast<int32_t*>(flags),
               static_cast<uint32_t*>(scratch),
               n_pad, m_stride, C, D, W, G, T, (m_stride + T - 1) / T,
               DiffParams{M, X, E, O, -160 * delta}};
  return launch_shards(global ? (const void*)psa_dp_diff_kernel<true>
                              : (const void*)psa_dp_diff_kernel<false>,
                       smem, P, D, k, stream);
}
