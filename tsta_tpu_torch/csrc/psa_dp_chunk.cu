// One row-chunk of one long pair's traced Gotoh DP, its columns cut into D
// shards, one co-resident 256-thread block each (a cooperative launch).
//
// Replaces the TPU kernel tsta_tpu/ops/psa_pallas.py:_kernel_chunk (Q2-7,
// through _psa_chunk_call and psa_align_traced_chunked): the rows
// [row_base, row_base + rows) of a pair whose whole code plane the card
// cannot hold, from the H/E frontier of row row_base - 1.  It writes the
// chunk's (rows, n_pad) code plane, the frontier of its last row, best
// (the max over the chunk's cells, padded ones included) and corner
// (H(m_real-1, n_real-1) when the chunk holds that row, else NEG).  The
// TPU kernel runs the chunk on one core and writes 4 rows per int32 word;
// here the chunk's columns are spread over the card's SMs.
//
// Recurrence, boundaries, padding and codes are psa_dp.cu's, with i the
// GLOBAL row and j the GLOBAL column, so that the closed-form F
//   F(i,j) = o + j*e + max(H(i,-1) + e, max_{0<=k<j} (C(k) - k*e))
// composes across shards: shard d's seed is shard d-1's inclusive prefix
// (psa_ring.cu does the same for the score-only DP).  Cell code =
// back*9 + f*3 + e: back 1 diag > 0 left (F) > 2 up (E); f/e 0 extend,
// 1 open, 2 open with an open/extend tie.
//
// Plan (tsta_psa_dp_chunk_layout, from n_pad and the SM count alone):
// W = ceil(n_pad / (256 * SMs)) columns per thread, at least kMinW, a
// multiple of 4; C = 256 * W columns per shard (n_pad when that is less);
// D = ceil(n_pad / C) <= SMs shards, the last one possibly narrower; T =
// kT rows per packet.  At 65,536 x 200,064 on an H100: W = 8, C = 2,048,
// D = 98; T = 32 (the fastest of 32 to 256 there: a taller packet adds
// (D - 1) more rows of fill per row of T, a shorter one more waits).
//
// Block d owns the global columns [d*C, d*C + C_d); thread t the strip
// [t*W, t*W + W) of them.  Per row: pass 1 takes each strip's max of
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
// Packets.  comm is (D, m_blocks, 3T) int32, one slot per row block of T
// rows; slot rb of shard d holds, for row r of the block (i = row_base +
// rb*T + r), H(i-1, its last column) in lane r (the entry frontier's at
// the chunk's first row), the inclusive F prefix of row i at its last
// column in lane T + r, and H(i, its last column) in lane 2T + r: shard
// d+1's first column needs the first two for its H and the third for its
// f code.  The thread that owns the last column writes them as it goes,
// then, after the block's last row, publishes flags[d][rb]
// (ring_common.cuh); thread 0 of block d+1 waits on it at the start of
// row block rb, the block meets at a barrier and reads the slot past L1
// (__ldcg) into shared memory.  Slots are never reused.  A wait past the
// watchdog's limit traps; D past the card's co-resident limit is refused
// before launching (ring_common.cuh).
//
// best and corner: each block's max over its cells, then atomicMax into
// the outputs, which block 0 sets to NEG first; every other block reaches
// its atomics only after an acquire chain from block 0's first packet.
//
// DPX (sm_90): E = max(E + e, H + o + e) is __viaddmax_s32, the running
// max of C(k) - k*e one more, and H = max(diag, E, F) __vimax3_s32; the
// same int32 values as the plain max.
//
// What bounds it on the H100: per cell about 18 int32 operations (K2's
// row: K1's 12 and the code's 6), so 65,536 x 200,064 cells bound it at
// ~14 ms, and the plane's 13.1 GB at 3.9 ms.  A row costs three barriers
// and a block scan whatever W is, so at W = 8 the barriers set the pace,
// and the pipeline's fill adds (D - 1) * T rows.

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
constexpr int kMinW = 8;     // columns per thread of a shard, at least
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

struct Chunk {
  const uint8_t* a;      // (n_pad,)
  const uint8_t* b;      // (rows,): the chunk's rows of the padded b
  const int32_t* lens;   // (2,): real n, m
  const int32_t* h_in;   // (n_pad,): the frontier of row row_base - 1
  const int32_t* e_in;
  int32_t* h_out;        // (n_pad,): the frontier of the chunk's last row
  int32_t* e_out;
  int32_t* best;         // (1,)
  int32_t* corner;       // (1,)
  uint8_t* plane;        // (rows, n_pad)
  int32_t* comm;         // (D, m_blocks, 3T)
  int32_t* flags;        // (D, m_blocks), zero
  int32_t* scratch;      // (D, 2 * W * kThreads) or null
  int n_pad, rows, row_base, C, T, m_blocks;
  Params p;
};

// Dynamic shared memory: the incoming packet (3T ints), then, with
// kSmem, H and E (W * kThreads ints each) and a (W * kThreads bytes).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
psa_dp_chunk_kernel(const Chunk k) {
  extern __shared__ int32_t s_dyn[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const Params p = k.p;
  const int d = blockIdx.x;
  const int t = threadIdx.x;
  const int T = k.T;
  const int col0 = d * k.C;                // global index of column 0
  const int Cd = min(k.C, k.n_pad - col0);  // this shard's columns
  const int W = strip_width(k.C);
  const int j0 = t * W;
  const int jend = min(j0 + W, Cd);        // jend <= j0: no columns
  const int t_last = (Cd - 1) / W;         // owns the shard's last column
  const int n_real = k.lens[0], m_real = k.lens[1];
  const int oe = p.o + p.e;
  int32_t* s_pkt = s_dyn;
  int32_t* H = kSmem ? s_dyn + 3 * T
                     : k.scratch + (size_t)d * 2 * W * kThreads;
  int32_t* E = H + (size_t)W * kThreads;
  uint8_t* s_a = reinterpret_cast<uint8_t*>(s_dyn + 3 * T + 2 * W * kThreads);
  const uint8_t* a = k.a + col0;
  int32_t* my_comm = k.comm + (size_t)d * k.m_blocks * 3 * T;
  const int32_t* left_comm = k.comm + (size_t)(d - 1) * k.m_blocks * 3 * T;
  const unsigned long long wait_ns = tsta::wait_limit_ns(d, T, W);

  if (d == 0 && t == 0) {
    *k.best = kNeg;
    *k.corner = kNeg;
    __threadfence();
  }
  for (int j = j0; j < jend; ++j) {
    const int q = (j - j0) * kThreads + t;
    H[q] = k.h_in[col0 + j];
    E[q] = k.e_in[col0 + j];
    if (kSmem) s_a[q] = a[j];
  }
  s_edge[1][t] = jend > j0 ? k.h_in[col0 + jend - 1] : 0;
  int edge = k.h_in[col0 + Cd - 1];  // H(i-1, the shard's last column)
  int best = kNeg, corner = kNeg;
  __syncthreads();

  for (int rb = 0; rb < k.m_blocks; ++rb) {
    if (d > 0) {
      if (t == 0)
        tsta::wait_flag(k.flags + (size_t)(d - 1) * k.m_blocks + rb, wait_ns);
      __syncthreads();
      for (int q = t; q < 3 * T; q += kThreads)
        s_pkt[q] = __ldcg(left_comm + (size_t)rb * 3 * T + q);
      __syncthreads();
    }
    int32_t* pkt_out = my_comm + (size_t)rb * 3 * T;
    const int nr = min(T, k.rows - rb * T);
    for (int rr = 0; rr < nr; ++rr) {
      const int r = rb * T + rr;          // the chunk's row
      const int i = k.row_base + r;       // the global row
      const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
      const int bound_cur = p.o + (i + 1) * p.e;          // H(i, -1)
      const int seed = d == 0 ? bound_cur + p.e : s_pkt[T + rr];
      const int fill = d == 0 ? bound_prev : s_pkt[rr];
      const bool last_row = i == m_real - 1;
      const int bi = k.b[r];
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
      uint8_t* prow = k.plane + (size_t)r * k.n_pad + col0;
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
      if (t == t_last) {
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
    if (t == t_last) tsta::publish(k.flags + (size_t)d * k.m_blocks + rb);
  }

  for (int j = j0; j < jend; ++j) {  // each thread hands back its strip
    const int q = (j - j0) * kThreads + t;
    k.h_out[col0 + j] = H[q];
    k.e_out[col0 + j] = E[q];
  }
  best = tsta::block_max<kThreads>(best, s_warp);
  corner = tsta::block_max<kThreads>(corner, s_warp);
  if (t == 0) {
    atomicMax(k.best, best);
    atomicMax(k.corner, corner);
  }
}

size_t smem_bytes(int C, int T, bool* in_smem) {
  const int W = strip_width(C);
  *in_smem = W <= kSmemW;
  return sizeof(int32_t) * 3 * (size_t)T +
         (*in_smem ? (2 * sizeof(int32_t) + 1) * (size_t)W * kThreads : 0);
}

}  // namespace

// The plan for a chunk of n_pad columns on a card of sms SMs: D shards of
// C columns (the last one n_pad - (D-1)*C), W columns per thread, T rows
// per packet.  The wrapper's twin is psa_chunked.chunk_plan.
extern "C" void tsta_psa_dp_chunk_layout(int n_pad, int sms, int* D, int* C,
                                         int* W, int* T) {
  const int per_thread = (n_pad + sms * kThreads - 1) / (sms * kThreads);
  const int w0 = round4(per_thread > kMinW ? per_thread : kMinW);
  *C = w0 * kThreads < n_pad ? w0 * kThreads : n_pad;
  *D = (n_pad + *C - 1) / *C;
  *W = strip_width(*C);
  *T = kT;
}

// Ints of global frontier scratch per shard (0 when it is in shared memory).
extern "C" int tsta_psa_dp_chunk_scratch_words(int C) {
  const int W = strip_width(C);
  return W <= kSmemW ? 0 : 2 * W * kThreads;
}

// The most shards of C columns and T-row packets the current card holds
// resident at once; a negative value is minus a CUDA error.
extern "C" int tsta_psa_dp_chunk_max_blocks(int C, int T) {
  bool in_smem;
  const size_t smem = smem_bytes(C, T, &in_smem);
  return in_smem
             ? tsta::coresident_limit(psa_dp_chunk_kernel<true>, kThreads, smem)
             : tsta::coresident_limit(psa_dp_chunk_kernel<false>, kThreads,
                                      smem);
}

// a: (n_pad,) uint8; b: (rows,) uint8, the chunk's rows [row_base,
// row_base + rows); lens: (2,) int32 real (n, m); h_in, e_in: (n_pad,)
// int32 frontier of row row_base - 1; h_out, e_out: (n_pad,) int32
// frontier of the chunk's last row; best, corner: (1,) int32; plane:
// (rows, n_pad) uint8; D shards of C columns (n_pad and C multiples of 4,
// D = ceil(n_pad / C)), T rows per packet (1..256); comm: (D, ceil(rows /
// T), 3T) int32; flags: (D, ceil(rows / T)) int32, zero; scratch: (D,
// tsta_psa_dp_chunk_scratch_words(C)) int32 or null.  Returns
// cudaGetLastError() after the cooperative launch, or
// cudaErrorCooperativeLaunchTooLarge without launching when D blocks
// cannot be resident together: the one place that decides it.
extern "C" int tsta_psa_dp_chunk(const void* a, const void* b,
                                 const void* lens, int n_pad, int rows,
                                 int row_base, int M, int X, int E, int O,
                                 const void* h_in, const void* e_in,
                                 void* h_out, void* e_out, void* best,
                                 void* corner, void* plane, int D, int C,
                                 int T, void* comm, void* flags,
                                 void* scratch, void* stream) {
  if (T < 1 || T > kTMax) return (int)cudaErrorInvalidValue;
  bool in_smem;
  const size_t smem = smem_bytes(C, T, &in_smem);
  const int limit = tsta_psa_dp_chunk_max_blocks(C, T);
  if (limit < 0) return -limit;
  if (D < 1 || D > limit) return (int)cudaErrorCooperativeLaunchTooLarge;
  const Chunk k{static_cast<const uint8_t*>(a),
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
                n_pad, rows, row_base, C, T, (rows + T - 1) / T,
                Params{M, X, E, O}};
  void* args[] = {(void*)&k};
  const void* fn = in_smem ? (const void*)psa_dp_chunk_kernel<true>
                           : (const void*)psa_dp_chunk_kernel<false>;
  cudaError_t rc = cudaLaunchCooperativeKernel(
      fn, dim3(D), dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
