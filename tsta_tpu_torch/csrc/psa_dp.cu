// The score-only Gotoh DP of P pairs, each pair's columns cut into D shards
// of co-resident 256-thread blocks: one body for K1 (any P) and the ring
// (one pair over the mesh's D shards).
//
// Replaces the TPU kernels tsta_tpu/ops/psa_diff.py:_abs_kernel in its
// score-only use (K1, through _psa_diff_call), the round-1 tsta_tpu/ops/
// psa_pallas.py:_kernel score-only (Q2-13's score-only half) and
// :_batch_kernel (Q2-14), and tsta_tpu/ops/psa_ring.py:_ring_kernel (Q2-10,
// through _ring_call and align_long_ring; also the XLA pipeline
// tsta_tpu/parallel/longseq.py:align_long with T = its block).  The TPU
// kernels pack pairs along the sublanes of one core, and the ring puts
// each shard on a chip of the mesh's seq axis; here each pair's columns are
// spread over SMs, a shard a block, and the ring's packet is a store to
// global memory behind a flag.
//
// Two launch shapes of the one body:
// * K1 (full = 0): each pair over its real extent, rows < m_real and
//   columns < n_real, so mixing lengths costs no padding; a shard wholly
//   past n_real writes NEG and returns at once (nobody to its right waits
//   on it).  Its scores equal the JAX kernels' (which include padded
//   cells) whenever every move into padding lowers the score.
// * The ring (full = 1, P = 1): every padded column and row, the best over
//   rows < m_real and every padded column, as JAX's (psa_ring.py:216-224,
//   247-250, 303-304); every shard writes its packets, the last one too,
//   since the caller reads them all.
//
// The body, plan, packets and launch are psa_dp_score.cuh's, shared with
// psa_dp_striped.cu; this file's Reader takes a pair's columns as one row
// of (P, n_pad) bytes.
//
// The ring across cards and processes (tsta_psa_dp_linked): one launch of
// the body's linked build a card, over that card's columns of the pair
// (JAX's chip shard, C_card = n / K), its blocks the card's plan; the
// card edges are links in mapped host memory (psa_dp_score.cuh), which
// tsta_host_register and tsta_host_device_ptr set up.
//
// What bounds it on the H100: per cell about 12 int32 operations, so 128 x
// 10,240 x 10,240 cells bound it at ~9.6 ms and the 200 kbp pair at ~28
// ms.  A row costs three barriers, a block scan and, at D >= 2, a share of
// a packet, whatever W is, so at narrow strips that fixed cost, not the
// cells, sets the pace, and the pipeline's fill adds (D - 1) * T rows.
// The row's closing barrier stays: a variant without it (each thread
// adding its right neighbour's first diagonal term to the scan, so no
// edge crosses threads before it) ran 5-14% slower (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "psa_dp_score.cuh"

namespace {

// A pair's columns as bytes in order: column j of the shard at a[j].
struct Linear {
  const uint8_t* a;
  __device__ Linear(const Score& k, int pair, int col0)
      : a(k.a + (size_t)pair * k.n_pad + col0) {}
  __device__ void stage_col(uint8_t* s_a, int q, int j) const { s_a[q] = a[j]; }
  __device__ void stage_all(uint8_t*, int, int) const {}
  __device__ int at(int j) const { return __ldg(a + j); }
};

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
psa_dp_kernel(const Score k) {
  score_body<kGlobal, Linear>(k);
}

struct Linked {
  Score s;
  Link l;
};

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
psa_dp_linked_kernel(const __grid_constant__ Linked k) {
  score_body<kGlobal, Linear, true>(k.s, &k.l);
}

}  // namespace

// The plan for P pairs of n_pad columns on a card of sms SMs: D shards of
// C columns (the last one n_pad - (D-1)*C), W columns per thread, T rows
// per packet.  The wrapper's twin is psa_diff.score_plan.
extern "C" void tsta_psa_dp_layout(int P, int n_pad, int sms, int* D, int* C,
                                   int* W, int* T) {
  plan(P, n_pad, sms, D, C, W, T);
}

// Ints of global frontier scratch per shard of C columns with T-row packets
// (0 when the frontier is in shared memory), of psa_dp_striped.cu's too.
extern "C" int tsta_psa_dp_scratch_words(int C, int T) {
  bool global;
  smem_bytes(C, T, &global);
  return global ? 2 * strip_width(C) * kThreads : 0;
}

// The most shards of C columns and T-row packets the current card holds
// resident at once; a negative value is minus a CUDA error.
extern "C" int tsta_psa_dp_max_blocks(int C, int T) {
  return max_blocks(psa_dp_kernel<false>, psa_dp_kernel<true>, C, T);
}

// a: (P, n_pad) uint8; b: (P, m_stride) uint8; lens: (P, 2) int32 real
// (n, m); full: 0 for each pair's real extent (K1), 1 for every padded
// cell with the best over rows < m (the ring); D shards of C columns
// ((D-1)*C < n_pad <= D*C), T rows per packet; comm: (P, D, ceil(m_stride
// / T), 2T) int32 and flags: (P, D, ceil(m_stride / T)) int32, zero, both
// null for a K1 launch at D = 1; out: (P, D, 2) int32; scratch: (P, D,
// tsta_psa_dp_scratch_words(C, T)) int32 or null.  D = 1 is an ordinary
// launch of P blocks; D >= 2 a cooperative launch of P * D.  Returns
// cudaGetLastError() after the launch, or cudaErrorCooperativeLaunchTooLarge
// without launching when P * D >= 2 blocks that wait on each other cannot
// be resident together.
extern "C" int tsta_psa_dp(const void* a, const void* b, const void* lens,
                           int P, int n_pad, int m_stride, int M, int X,
                           int E, int O, int full, int D, int C, int T,
                           void* comm, void* flags, void* out, void* scratch,
                           void* stream) {
  return launch(psa_dp_kernel<false>, psa_dp_kernel<true>, a, b, lens, P,
                n_pad, m_stride, M, X, E, O, full, D, C, T, comm, flags, out,
                scratch, stream);
}

// The most linked-build shards of C columns and T-row packets the current
// card holds resident at once; a negative value is minus a CUDA error.
extern "C" int tsta_psa_dp_linked_max_blocks(int C, int T) {
  return max_blocks(psa_dp_linked_kernel<false>, psa_dp_linked_kernel<true>,
                    C, T);
}

// One card of the ring across cards: tsta_psa_dp's arguments at P = 1,
// full = 1 (a: the card's (n_pad) columns; lens: the pair's real (n, m),
// global), plus the card's edges: col_base, the global column of its
// column 0; shard_base, the global shard index of its block 0 (the
// watchdog's); in_pkts and in_flags, device pointers of the link from the
// card to the left ((m_blocks, 2T) and (m_blocks) int32, mapped host
// memory), both null on the first card; out_pkts and out_flags, the link
// to the card to the right, both null on the last card, their flags zero.
// Returns as tsta_psa_dp does, cudaErrorCooperativeLaunchTooLarge without
// launching.
extern "C" int tsta_psa_dp_linked(const void* a, const void* b,
                                  const void* lens, int n_pad, int m_stride,
                                  int M, int X, int E, int O, int D, int C,
                                  int T, void* comm, void* flags, void* out,
                                  void* scratch, int col_base, int shard_base,
                                  const void* in_pkts, const void* in_flags,
                                  void* out_pkts, void* out_flags,
                                  void* stream) {
  if (D < 1 || C < 1 || T < 1 || m_stride < 1 || comm == nullptr ||
      flags == nullptr || (long long)(D - 1) * C >= n_pad ||
      n_pad > (long long)D * C || col_base < 0 || shard_base < 0 ||
      (in_pkts == nullptr) != (in_flags == nullptr) ||
      (out_pkts == nullptr) != (out_flags == nullptr))
    return (int)cudaErrorInvalidValue;
  bool global;
  const size_t smem = smem_bytes(C, T, &global);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const Linked k{
      Score{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
            static_cast<const int32_t*>(lens), static_cast<int32_t*>(out),
            static_cast<int32_t*>(comm), static_cast<int32_t*>(flags),
            static_cast<int32_t*>(scratch), n_pad, m_stride, C, D, T,
            (m_stride + T - 1) / T, 1, Params{M, X, E, O}},
      Link{static_cast<const int32_t*>(in_pkts),
           static_cast<const int32_t*>(in_flags),
           static_cast<int32_t*>(out_pkts), static_cast<int32_t*>(out_flags),
           col_base, shard_base}};
  return launch_shards(global ? (const void*)psa_dp_linked_kernel<true>
                              : (const void*)psa_dp_linked_kernel<false>,
                       smem, 1, D, k, stream);
}

// The links' host memory: register bytes at p (page-aligned: a memfd
// mapping) as mapped and portable pinned memory; undo it;
// and the device pointer of host address p in the current card's context.
// Each returns a CUDA error code.
extern "C" int tsta_host_register(void* p, size_t bytes) {
  return (int)cudaHostRegister(
      p, bytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
}

extern "C" int tsta_host_unregister(void* p) {
  return (int)cudaHostUnregister(p);
}

extern "C" int tsta_host_device_ptr(void* p, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, p, 0);
}
