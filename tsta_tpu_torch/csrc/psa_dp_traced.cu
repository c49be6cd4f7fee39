// The traced Gotoh DP of P pairs, each pair's columns cut into D shards of
// co-resident 256-thread blocks: one body for a traced batch and for one
// long pair's row-chunk.
//
// Replaces the TPU kernels tsta_tpu/ops/psa_diff.py:_abs_kernel traced=True
// (K2, through _psa_diff_traced_call), the round-1 tsta_tpu/ops/
// psa_pallas.py:_kernel traced (Q2-13, one pair) and :_kernel_chunk (Q2-7,
// through _psa_chunk_call and psa_align_traced_chunked).  Each launch runs
// the rows [row_base, row_base + rows) of every pair from the H/E frontier
// of row row_base - 1 (row -1's boundary when h_in is null, row_base 0: a
// traced batch, K2 and Q2-13) and writes each pair's (rows, n_pad) code
// plane, best (the max over the launch's cells, padded ones included) and
// corner (H(m_real-1, n_real-1) when the launch holds that row, else NEG),
// and, when h_out is not null, the frontier of its last row (a chunk,
// Q2-7, P = 1).  A traced batch runs every padded cell of the group
// (A_PAD/B_PAD bytes), so its plane matches the JAX kernel's cell for
// cell; padding is exact whenever every move into it lowers the score, X <
// 0, E < 0 and O <= 0, whatever M.  The TPU kernels pack pairs along the
// sublanes of one core; here each pair's columns are spread over SMs.
//
// Recurrence (i the GLOBAL row over b, j the GLOBAL column over a):
//   E(i,j) = max(E(i-1,j) + e, H(i-1,j) + o + e)
//   C(j)   = max(H(i-1,j-1) + sub(a_j, b_i), E(i,j))
//   F(i,j) = o + j*e + max(H(i,-1) + e, max_{0<=k<j} (C(k) - k*e))
//   H(i,j) = max(C(j), F(i,j))
// with H(-1,j) = o + (j+1)e, H(i,-1) = o + (i+1)e, H(-1,-1) = 0 and
// E(-1,j) = NEG (-2^28, not INT_MIN: gap terms are added to it).  The
// closed-form F composes across shards: shard d's seed is shard d-1's
// inclusive prefix (psa_dp.cu does the same for the score-only DP).
// Cell code = back*9 + f*3 + e: back 1 diag > 0 left (F) > 2 up (E); f/e
// 0 extend, 1 open, 2 open with an open/extend tie.  One byte per cell,
// row-major per pair: plane[pair][r][j].
//
// Plan (tsta_psa_dp_traced_layout, from P, n_pad and the SM count alone):
// max(1, SMs / P) blocks a pair; W = ceil(n_pad / (256 * blocks)) columns
// per thread, at least kMinW, a multiple of 4; C = 256 * W columns per
// shard (n_pad when that is less); D = ceil(n_pad / C) shards, the last one
// possibly narrower; T = kT rows per packet.  So P * D <= SMs whenever D
// >= 2.  At P = 1 it is the chunk's plan: at
// 65,536 x 200,064 on an H100, W = 8, C = 2,048, D = 98, T = 32 (the
// fastest of 16 to 256 there: a taller packet adds (D - 1) more rows of
// fill per row of T, a shorter one more waits); at 1 x 10,240, W = 4, C =
// 1,024, D = 10 (a narrower strip makes a cheaper row); at 32 x 10,240,
// W = 12, C = 3,072, D = 4.
//
// Grid.  One dimension, block pair * D + d (a group of more than 65,535
// pairs, the y limit, launches at once).  D = 1: an ordinary launch, as no
// block waits on another, so any P runs.  D >= 2: one cooperative launch of
// P * D blocks, refused without launching past the card's co-resident
// limit (ring_common.cuh).
//
// Block d of a pair owns the global columns [d*C, d*C + C_d); thread t the
// strip [t*W, t*W + W) of them.  Per row: pass 1 takes each strip's max of
// C(k) - k*e, block_excl_max (dp_common.cuh) seeds the exclusive prefix
// with the incoming F prefix (H(i,-1) + e on shard 0), pass 2 writes H, E
// and the codes, each thread its strip as whole 4-byte words.  The H/E
// frontier and the shard's slab of a live in shared memory, interleaved
// (column t*W+k at k*256+t, so a warp's accesses are consecutive), when
// the strip fits (W <= kSmemW), else the frontier in a global scratch and
// a read through L1.  The diagonal term of a strip's first column and the
// left term of its f code come from the neighbour thread through a
// double-buffered shared edge array; a strip's first code word is written
// after the row's last barrier, once the neighbour's H(i, t*W-1) is known.
//
// Packets.  comm is (P, D, m_blocks, 3T) int32, one slot per row block of T
// rows; slot rb of shard d holds, for row r of the block (i = row_base +
// rb*T + r), H(i-1, its last column) in lane r (the entry frontier's at
// the launch's first row), the inclusive F prefix of row i at its last
// column in lane T + r, and H(i, its last column) in lane 2T + r: shard
// d+1's first column needs the first two for its H and the third for its
// f code.  The thread that owns the last column writes them as it goes,
// then, after the block's last row, publishes flags[pair][d][rb]
// (ring_common.cuh); thread 0 of block d+1 waits on it at the start of
// row block rb, the block meets at a barrier and reads the slot past L1
// (__ldcg) into shared memory.  Slots are never reused.  A wait past the
// watchdog's limit traps.  The last shard writes no packets; at D = 1
// comm and flags are null.
//
// best and corner: each block's max over its cells, then atomicMax into
// the pair's outputs, which its block 0 sets to NEG first; every other
// block of the pair reaches its atomics only after an acquire chain from
// block 0's first packet.
//
// DPX (sm_90): E = max(E + e, H + o + e) is __viaddmax_s32, the running
// max of C(k) - k*e one more, and H = max(diag, E, F) __vimax3_s32; the
// same int32 values as the plain max.
//
// What bounds it on the H100: per cell about 18 int32 operations (K1's 12
// and the code's 6), so 65,536 x 200,064 cells bound it at ~14 ms, and the
// plane's 13.1 GB at 3.9 ms.  A row costs three barriers and a block scan
// whatever W is, so at W = 8 the barriers set the pace, and the pipeline's
// fill adds (D - 1) * T rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"
#include "ring_common.cuh"

namespace {

using tsta::kNeg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;       // rows per packet: PERF.md's T sweep
constexpr int kTMax = 256;   // the largest T the shared memory plan admits
constexpr int kMinW = 4;     // columns per thread of a shard, at least
                             // (one code word: PERF.md's W sweep)
constexpr int kSmemW = 96;   // widest strip whose frontier and a fit in
                             // shared memory (9 bytes a column, 3 kTMax
                             // ints of packet: under 227 KB)

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int strip_width(int C) {
  return round4((C + kThreads - 1) / kThreads);
}

struct Params {
  int m, x, e, o;
};

struct Traced {
  const uint8_t* a;      // (P, n_pad)
  const uint8_t* b;      // (P, rows): each pair's rows [row_base, +rows)
  const int32_t* lens;   // (P, 2): real n, m
  const int32_t* h_in;   // (P, n_pad): the frontier of row row_base - 1,
  const int32_t* e_in;   // or null: row -1's boundary (row_base 0)
  int32_t* h_out;        // (P, n_pad): the frontier of the last row, or
  int32_t* e_out;        // null
  int32_t* best;         // (P,)
  int32_t* corner;       // (P,)
  uint8_t* plane;        // (P, rows, n_pad)
  int32_t* comm;         // (P, D, m_blocks, 3T), null at D = 1
  int32_t* flags;        // (P, D, m_blocks), zero; null at D = 1
  int32_t* scratch;      // (P, D, 2 * W * kThreads) or null
  int n_pad, rows, row_base, C, D, T, m_blocks;
  Params p;
};

// Dynamic shared memory: the incoming packet (3T ints), then, with
// kSmem, H and E (W * kThreads ints each) and a (W * kThreads bytes).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
psa_dp_traced_kernel(const Traced k) {
  extern __shared__ int32_t s_dyn[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const Params p = k.p;
  const int pair = blockIdx.x / k.D;
  const int d = blockIdx.x - pair * k.D;
  const size_t shard = (size_t)pair * k.D + d;  // (pair, d) in the packets
  const int t = threadIdx.x;
  const int T = k.T;
  const int col0 = d * k.C;                // global index of column 0
  const int Cd = min(k.C, k.n_pad - col0);  // this shard's columns
  const int W = strip_width(k.C);
  const int j0 = t * W;
  const int jend = min(j0 + W, Cd);        // jend <= j0: no columns
  const int t_last = (Cd - 1) / W;         // owns the shard's last column
  const bool has_right = d + 1 < k.D;      // a shard to hand packets to
  const int n_real = k.lens[2 * pair], m_real = k.lens[2 * pair + 1];
  const int oe = p.o + p.e;
  int32_t* s_pkt = s_dyn;
  int32_t* H = kSmem ? s_dyn + 3 * T : k.scratch + shard * 2 * W * kThreads;
  int32_t* E = H + (size_t)W * kThreads;
  uint8_t* s_a = reinterpret_cast<uint8_t*>(s_dyn + 3 * T + 2 * W * kThreads);
  const size_t row0 = (size_t)pair * k.n_pad + col0;  // the pair's column 0
  const uint8_t* a = k.a + row0;
  const uint8_t* b = k.b + (size_t)pair * k.rows;
  uint8_t* plane = k.plane + (size_t)pair * k.rows * k.n_pad + col0;
  const size_t slab = (size_t)k.m_blocks * 3 * T;
  // used only where has_right (mine) or d > 0 (the left shard's)
  int32_t* my_comm = k.comm + shard * slab;
  const int32_t* left_comm = k.comm + (shard - 1) * slab;
  int32_t* my_flags = k.flags + shard * k.m_blocks;
  const int32_t* left_flags = k.flags + (shard - 1) * k.m_blocks;
  const unsigned long long wait_ns = tsta::wait_limit_ns(d, T, W);

  if (d == 0 && t == 0) {
    k.best[pair] = kNeg;
    k.corner[pair] = kNeg;
    __threadfence();
  }
  // the entry frontier, row row_base - 1: h_in's, or H(-1,j) = o + (j+1)e
  // and E(-1,j) = NEG
  const int32_t* h_in = k.h_in ? k.h_in + row0 : nullptr;
  const int32_t* e_in = k.e_in ? k.e_in + row0 : nullptr;
  for (int j = j0; j < jend; ++j) {
    const int q = (j - j0) * kThreads + t;
    H[q] = h_in ? h_in[j] : p.o + (col0 + j + 1) * p.e;
    E[q] = e_in ? e_in[j] : kNeg;
    if (kSmem) s_a[q] = a[j];
  }
  if (jend > j0)
    s_edge[1][t] = h_in ? h_in[jend - 1] : p.o + (col0 + jend) * p.e;
  // H(i-1, the shard's last column)
  int edge = h_in ? h_in[Cd - 1] : p.o + (col0 + Cd) * p.e;
  int best = kNeg, corner = kNeg;
  __syncthreads();

  for (int rb = 0; rb < k.m_blocks; ++rb) {
    if (d > 0) {
      if (t == 0) tsta::wait_flag(left_flags + rb, wait_ns);
      __syncthreads();
      for (int q = t; q < 3 * T; q += kThreads)
        s_pkt[q] = __ldcg(left_comm + (size_t)rb * 3 * T + q);
      __syncthreads();
    }
    int32_t* pkt_out = my_comm + (size_t)rb * 3 * T;
    const int nr = min(T, k.rows - rb * T);
    for (int rr = 0; rr < nr; ++rr) {
      const int r = rb * T + rr;          // the launch's row
      const int i = k.row_base + r;       // the global row
      const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
      const int bound_cur = p.o + (i + 1) * p.e;          // H(i, -1)
      const int seed = d == 0 ? bound_cur + p.e : s_pkt[T + rr];
      const int fill = d == 0 ? bound_prev : s_pkt[rr];
      const bool last_row = i == m_real - 1;
      const int bi = b[r];
      const int hd0 = t == 0 ? fill : s_edge[(r + 1) & 1][t - 1];

      // pass 1: strip max of C(k) - k*e
      int agg = kNeg;
      int hd = hd0;
      for (int j = j0; j < jend; ++j) {
        const int q = (j - j0) * kThreads + t;
        const int hp = H[q];
        const int ev = __viaddmax_s32(E[q], p.e, hp + oe);
        const int aj = kSmem ? s_a[q] : __ldg(a + j);
        const int diag = hd + (aj == bi ? p.m : p.x);
        agg = __viaddmax_s32(max(diag, ev), -(col0 + j) * p.e, agg);
        hd = hp;
      }
      int run = tsta::block_excl_max<kThreads>(agg, seed, s_warp);

      // pass 2: F, H, E, codes
      hd = hd0;
      int hl = 0;  // H(i, j-1)
      uint32_t word = 0, first_word = 0;
      int f0 = 0, rest0 = 0;
      bool tie0 = false;
      uint8_t* prow = plane + (size_t)r * k.n_pad;
      for (int j = j0; j < jend; ++j) {
        const int q = (j - j0) * kThreads + t;
        const int gje = (col0 + j) * p.e;
        const int hp = H[q];
        const int ev = __viaddmax_s32(E[q], p.e, hp + oe);
        const int aj = kSmem ? s_a[q] : __ldg(a + j);
        const int diag = hd + (aj == bi ? p.m : p.x);
        const int f = p.o + gje + run;
        const int h = __vimax3_s32(diag, ev, f);
        run = __viaddmax_s32(max(diag, ev), -gje, run);
        H[q] = h;
        E[q] = ev;
        best = max(best, h);
        if (last_row && col0 + j == n_real - 1) corner = h;
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
        const int sh = (j - j0) & 3;
        word |= (uint32_t)code << (8 * sh);
        if (sh == 3) {
          if (j - j0 == 3) {
            first_word = word;
          } else {
            *reinterpret_cast<uint32_t*>(prow + j - 3) = word;
          }
          word = 0;
        }
        hd = hp;
        hl = h;
      }
      s_edge[r & 1][t] = hl;  // H(i, jend - 1)
      if (t == t_last && has_right) {
        pkt_out[rr] = edge;         // H(i-1, last column)
        pkt_out[T + rr] = run;      // inclusive F prefix of row i
        pkt_out[2 * T + rr] = hl;   // H(i, last column)
        edge = hl;
      }
      __syncthreads();
      if (jend > j0) {
        const int hleft = t > 0 ? s_edge[r & 1][t - 1]
                                : (d == 0 ? bound_cur : s_pkt[2 * T + rr]);
        const int fcode = f0 == hleft + oe ? (tie0 ? 2 : 1) : 0;
        first_word |= (uint32_t)(rest0 + 3 * fcode);
        *reinterpret_cast<uint32_t*>(prow + j0) = first_word;
      }
    }
    if (t == t_last && has_right) tsta::publish(my_flags + rb);
  }

  if (k.h_out != nullptr) {
    for (int j = j0; j < jend; ++j) {  // each thread hands back its strip
      const int q = (j - j0) * kThreads + t;
      k.h_out[row0 + j] = H[q];
      k.e_out[row0 + j] = E[q];
    }
  }
  best = tsta::block_max<kThreads>(best, s_warp);
  corner = tsta::block_max<kThreads>(corner, s_warp);
  if (t == 0) {
    atomicMax(k.best + pair, best);
    atomicMax(k.corner + pair, corner);
  }
}

size_t smem_bytes(int C, int T, bool* in_smem) {
  const int W = strip_width(C);
  *in_smem = W <= kSmemW;
  return sizeof(int32_t) * 3 * (size_t)T +
         (*in_smem ? (2 * sizeof(int32_t) + 1) * (size_t)W * kThreads : 0);
}

void plan(int P, int n_pad, int sms, int* D, int* C, int* W, int* T) {
  const int blocks = sms / P > 1 ? sms / P : 1;
  const int per_thread =
      (int)(((long long)n_pad + (long long)blocks * kThreads - 1) /
            ((long long)blocks * kThreads));
  const int w0 = round4(per_thread > kMinW ? per_thread : kMinW);
  *C = w0 * kThreads < n_pad ? w0 * kThreads : n_pad;
  *D = (n_pad + *C - 1) / *C;
  *W = strip_width(*C);
  *T = kT;
}

}  // namespace

// The plan for P pairs of n_pad columns on a card of sms SMs: D shards of
// C columns (the last one n_pad - (D-1)*C), W columns per thread, T rows
// per packet.  The wrapper's twin is psa_diff.traced_plan; at P = 1 it is
// one pair's row-chunk's, psa_chunked.chunk_plan.
extern "C" void tsta_psa_dp_traced_layout(int P, int n_pad, int sms, int* D,
                                          int* C, int* W, int* T) {
  plan(P, n_pad, sms, D, C, W, T);
}

// Ints of global frontier scratch per shard (0 when it is in shared memory).
extern "C" int tsta_psa_dp_traced_scratch_words(int C) {
  const int W = strip_width(C);
  return W <= kSmemW ? 0 : 2 * W * kThreads;
}

// The most shards of C columns and T-row packets the current card holds
// resident at once; a negative value is minus a CUDA error.
extern "C" int tsta_psa_dp_traced_max_blocks(int C, int T) {
  bool in_smem;
  const size_t smem = smem_bytes(C, T, &in_smem);
  return in_smem
             ? tsta::coresident_limit(psa_dp_traced_kernel<true>, kThreads,
                                      smem)
             : tsta::coresident_limit(psa_dp_traced_kernel<false>, kThreads,
                                      smem);
}

// a: (P, n_pad) uint8; b: (P, rows) uint8, each pair's rows [row_base,
// row_base + rows); lens: (P, 2) int32 real (n, m); h_in, e_in: (P, n_pad)
// int32 frontier of row row_base - 1, or both null for row -1's boundary
// (row_base 0); h_out, e_out: (P, n_pad) int32 frontier of the last row, or
// both null; best, corner: (P,) int32; plane: (P, rows, n_pad) uint8; D
// shards of C columns (n_pad and C multiples of 4, D = ceil(n_pad / C)), T
// rows per packet (1..256); comm: (P, D, ceil(rows / T), 3T) int32 and
// flags: (P, D, ceil(rows / T)) int32, zero, both null at D = 1; scratch:
// (P, D, tsta_psa_dp_traced_scratch_words(C)) int32 or null.  D = 1 is an
// ordinary launch of P blocks; D >= 2 a cooperative launch of P * D.
// Returns cudaGetLastError() after the launch, or
// cudaErrorCooperativeLaunchTooLarge without launching when P * D >= 2
// blocks that wait on each other cannot be resident together: the one
// place that decides it.
extern "C" int tsta_psa_dp_traced(const void* a, const void* b,
                                  const void* lens, int P, int n_pad,
                                  int rows, int row_base, int M, int X,
                                  int E, int O, const void* h_in,
                                  const void* e_in, void* h_out, void* e_out,
                                  void* best, void* corner, void* plane,
                                  int D, int C, int T, void* comm,
                                  void* flags, void* scratch, void* stream) {
  if (T < 1 || T > kTMax || P < 1 || D < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  bool in_smem;
  const size_t smem = smem_bytes(C, T, &in_smem);
  const void* fn = in_smem ? (const void*)psa_dp_traced_kernel<true>
                           : (const void*)psa_dp_traced_kernel<false>;
  if (D >= 2) {
    const int limit = tsta_psa_dp_traced_max_blocks(C, T);
    if (limit < 0) return -limit;
    if ((long long)P * D > limit)
      return (int)cudaErrorCooperativeLaunchTooLarge;
  } else {
    cudaError_t rc = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const Traced k{static_cast<const uint8_t*>(a),
                 static_cast<const uint8_t*>(b),
                 static_cast<const int32_t*>(lens),
                 static_cast<const int32_t*>(h_in),
                 static_cast<const int32_t*>(e_in),
                 static_cast<int32_t*>(h_out),
                 static_cast<int32_t*>(e_out),
                 static_cast<int32_t*>(best),
                 static_cast<int32_t*>(corner),
                 static_cast<uint8_t*>(plane),
                 static_cast<int32_t*>(comm),
                 static_cast<int32_t*>(flags),
                 static_cast<int32_t*>(scratch),
                 n_pad, rows, row_base, C, D, T, (rows + T - 1) / T,
                 Params{M, X, E, O}};
  void* args[] = {(void*)&k};
  cudaError_t rc =
      D >= 2 ? cudaLaunchCooperativeKernel(fn, dim3(P * D), dim3(kThreads),
                                           args, smem, (cudaStream_t)stream)
             : cudaLaunchKernel(fn, dim3(P), dim3(kThreads), args, smem,
                                (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
