// The ring wavefront: one pair's score-only Gotoh DP with its columns cut
// into D shards, one thread block per shard, all co-resident on one card.
//
// Replaces the TPU kernel tsta_tpu/ops/psa_ring.py:_ring_kernel (through
// _ring_call and align_long_ring), and runs the XLA pipeline
// tsta_tpu/parallel/longseq.py:align_long with T = its block.  On the TPU
// each shard is a chip of the mesh's seq axis and the per-row-block edge
// packet travels right by remote DMA; here each shard is a block of one
// launch and the packet is a store to global memory behind a flag.
//
// Recurrence and boundaries as psa_dp.cu's (H(-1,j) = o + (j+1)e,
// H(i,-1) = o + (i+1)e, H(-1,-1) = 0, E(-1,j) = NEG), with j the GLOBAL
// column, so that the closed-form F
//   F(i,j) = o + j*e + max(H(i,-1) + e, max_{0<=k<j} (C(k) - k*e))
// composes across shards: shard d's seed is shard d-1's inclusive prefix.
//
// Block d owns the global columns [d*C, (d+1)*C); thread t the strip of W
// = ceil(C / 256) columns from t*W, as K1 (psa_dp.cu).  Per row: pass 1
// takes each strip's max of C(k) - k*e, block_excl_max (dp_common.cuh)
// seeds the exclusive prefix with the incoming F prefix (H(i,-1) + e on
// shard 0), pass 2 writes H and E.  The diagonal term of the shard's first
// column is the left shard's edge H (the global boundary on shard 0).  The
// H/E frontier lives in shared memory, interleaved (column t*W+k at
// k*256+t), when it fits (W <= kSmemW), else in a global scratch.
//
// Packets.  comm is (D, m_blocks, 2T) int32, one row per row block as
// JAX's comm_ref; row rb of shard d holds, for r < T, H(rb*T + r - 1, its
// last column) in lane r and the inclusive F prefix of row rb*T + r at its
// last column in lane T + r.  The thread that owns the last column writes
// both as it goes, then, after row rb*T + T - 1, __threadfence() and a
// release store of flags[d][rb] = 1.  At the start of row block rb, thread
// 0 of block d+1 spins on an acquire load of that flag (__nanosleep
// back-off), the block meets at a barrier and reads the packet past L1
// (__ldcg) into shared memory.  Slots are never reused, so no ack: JAX
// needs one only because it reuses one send buffer.  Every block publishes
// every row block, padded rows included.
//
// Watchdog (ring_common.cuh): a wait on the left neighbour past 20 s plus
// the fill traps rather than hangs (an H100 takes ~0.63 us + 0.086 us per
// column of a strip a row here with the frontier in shared memory; K1
// pays 0.37 us per column through L2).
//
// Co-residency: all D blocks must be resident at once.  tsta_psa_ring
// checks D against tsta_psa_ring_max_blocks and returns
// cudaErrorCooperativeLaunchTooLarge without launching (the wrapper
// raises); the cooperative launch refuses such a grid too.
//
// Result: out (D, 2) int32, each block's best over its rows i < m_real
// (every padded column included, as JAX's) and its corner H(m_real-1,
// n_real-1), NEG where that column is not in its shard.  The max over D
// is JAX's pmax, outside its kernel too.
//
// What bounds it on the H100: per cell about 12 int32 operations (K1's
// row), so the 200 kbp pair's 3.9e10 cells bound it at ~28 ms; a row
// costs three barriers and a block scan whatever W is, so at W = 6
// (D = 132) the barriers, not the cells, set the pace, and the pipeline's
// fill and drain add (D - 1) * T rows.  Later work: several blocks per
// shard, DPX max-plus (__viaddmax_s32), a in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"
#include "ring_common.cuh"

namespace {

using tsta::kFull;
using tsta::kNeg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemW = 100;  // widest strip whose frontier is in shared memory

struct Params {
  int m, x, e, o;
};

__host__ __device__ inline int strip_width(int C) {
  return (C + kThreads - 1) / kThreads;
}

// Dynamic shared memory: the incoming packet (2T ints), then, with
// kSmemFrontier, H and E (W * kThreads ints each).
template <bool kSmemFrontier>
__global__ void __launch_bounds__(kThreads)
psa_ring_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int C, int m_blocks, int T, int n_real, int m_real, Params p,
                int32_t* __restrict__ comm, int32_t* __restrict__ flags,
                int32_t* __restrict__ out, int32_t* __restrict__ scratch) {
  extern __shared__ int32_t s_dyn[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_edge[2][kThreads];

  const int d = blockIdx.x;
  const int t = threadIdx.x;
  const int W = strip_width(C);
  const int j0 = t * W;
  const int jend = min(j0 + W, C);      // jend <= j0: no columns
  const int t_last = (C - 1) / W;       // owns the shard's last column
  const int col0 = d * C;               // global index of column 0
  const uint8_t* ad = a + col0;
  int32_t* s_pkt = s_dyn;
  int32_t* H = kSmemFrontier ? s_dyn + 2 * T
                             : scratch + (size_t)d * 2 * W * kThreads;
  int32_t* E = H + (size_t)W * kThreads;
  int32_t* my_comm = comm + (size_t)d * m_blocks * 2 * T;
  const int32_t* left_comm = comm + (size_t)(d - 1) * m_blocks * 2 * T;
  const int oe = p.o + p.e;
  const unsigned long long wait_ns = tsta::wait_limit_ns(d, T, W);

  for (int j = j0; j < jend; ++j) {
    const int k = (j - j0) * kThreads + t;
    H[k] = p.o + (col0 + j + 1) * p.e;  // H(-1, j)
    E[k] = kNeg;
  }
  s_edge[1][t] = p.o + (col0 + jend) * p.e;  // H(-1, jend - 1)
  int edge = p.o + (col0 + C) * p.e;          // H(i-1, last column)
  int best = kNeg, corner = kNeg;
  __syncthreads();

  for (int rb = 0; rb < m_blocks; ++rb) {
    if (d > 0) {
      if (t == 0) tsta::wait_flag(flags + (size_t)(d - 1) * m_blocks + rb,
                                  wait_ns);
      __syncthreads();
      for (int k = t; k < 2 * T; k += kThreads)
        s_pkt[k] = __ldcg(left_comm + (size_t)rb * 2 * T + k);
      __syncthreads();
    }
    int32_t* pkt_out = my_comm + (size_t)rb * 2 * T;
    for (int r = 0; r < T; ++r) {
      const int i = rb * T + r;
      const int bound_prev = i == 0 ? 0 : p.o + i * p.e;  // H(i-1, -1)
      const int seed = d == 0 ? p.o + (i + 1) * p.e + p.e : s_pkt[T + r];
      const int fill = d == 0 ? bound_prev : s_pkt[r];
      const int bi = b[i];
      const int hd0 = t == 0 ? fill : s_edge[(i + 1) & 1][t - 1];

      // pass 1: strip max of C(k) - k*e
      int agg = kNeg;
      int hd = hd0;
      for (int j = j0; j < jend; ++j) {
        const int k = (j - j0) * kThreads + t;
        const int hp = H[k];
        const int ev = max(E[k] + p.e, hp + oe);
        const int diag = hd + (__ldg(ad + j) == bi ? p.m : p.x);
        agg = max(agg, max(diag, ev) - (col0 + j) * p.e);
        hd = hp;
      }
      int run = tsta::block_excl_max<kThreads>(agg, seed, s_warp);

      // pass 2: F, H, E
      hd = hd0;
      int hl = 0;  // H(i, j-1)
      for (int j = j0; j < jend; ++j) {
        const int k = (j - j0) * kThreads + t;
        const int gj = col0 + j;
        const int hp = H[k];
        const int ev = max(E[k] + p.e, hp + oe);
        const int diag = hd + (__ldg(ad + j) == bi ? p.m : p.x);
        const int c = max(diag, ev);
        const int h = max(c, p.o + gj * p.e + run);
        run = max(run, c - gj * p.e);
        H[k] = h;
        E[k] = ev;
        if (i < m_real) {
          best = max(best, h);
          if (i == m_real - 1 && gj == n_real - 1) corner = h;
        }
        hd = hp;
        hl = h;
      }
      s_edge[i & 1][t] = hl;  // H(i, jend - 1)
      if (t == t_last) {
        pkt_out[r] = edge;      // H(i-1, last column)
        pkt_out[T + r] = run;   // inclusive F prefix of row i
        edge = hl;
      }
      __syncthreads();
    }
    if (t == t_last) tsta::publish(flags + (size_t)d * m_blocks + rb);
  }

  best = tsta::block_max<kThreads>(best, s_warp);
  corner = tsta::block_max<kThreads>(corner, s_warp);
  if (t == 0) {
    out[2 * d] = best;
    out[2 * d + 1] = corner;
  }
}

size_t smem_bytes(int C, int T, bool* in_smem) {
  const int W = strip_width(C);
  *in_smem = W <= kSmemW;
  return sizeof(int32_t) * (2 * (size_t)T +
                            (*in_smem ? 2 * (size_t)W * kThreads : 0));
}

}  // namespace

// Ints of global frontier scratch per shard (0 when it is in shared memory).
extern "C" int tsta_psa_ring_scratch_words(int C) {
  const int W = strip_width(C);
  return W <= kSmemW ? 0 : 2 * W * kThreads;
}

// The most shards (blocks) of C columns and T-row packets the current card
// holds resident at once; a negative value is minus a CUDA error.
extern "C" int tsta_psa_ring_max_blocks(int C, int T) {
  bool in_smem;
  const size_t smem = smem_bytes(C, T, &in_smem);
  return in_smem ? tsta::coresident_limit(psa_ring_kernel<true>, kThreads, smem)
                 : tsta::coresident_limit(psa_ring_kernel<false>, kThreads,
                                          smem);
}

// a: (D*C,) uint8, b: (m_blocks*T,) uint8, both padded; comm: (D,
// m_blocks, 2T) int32 out; flags: (D, m_blocks) int32, zero; out: (D, 2)
// int32; scratch: (D, tsta_psa_ring_scratch_words(C)) int32 or null.
// Returns cudaGetLastError() after the cooperative launch, or
// cudaErrorCooperativeLaunchTooLarge without launching when D blocks
// cannot be resident together: the one place that decides it.
extern "C" int tsta_psa_ring(const void* a, const void* b, int D, int C,
                             int m_blocks, int T, int n_real, int m_real,
                             int M, int X, int E, int O, void* comm,
                             void* flags, void* out, void* scratch,
                             void* stream) {
  bool in_smem;
  size_t smem = smem_bytes(C, T, &in_smem);
  const int limit = tsta_psa_ring_max_blocks(C, T);
  if (limit < 0) return -limit;
  if (D < 1 || D > limit) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p{M, X, E, O};
  void* args[] = {(void*)&a, (void*)&b, (void*)&C, (void*)&m_blocks,
                  (void*)&T, (void*)&n_real, (void*)&m_real, (void*)&p,
                  (void*)&comm, (void*)&flags, (void*)&out, (void*)&scratch};
  const void* fn = in_smem ? (const void*)psa_ring_kernel<true>
                           : (const void*)psa_ring_kernel<false>;
  cudaError_t rc = cudaLaunchCooperativeKernel(
      fn, dim3(D), dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
