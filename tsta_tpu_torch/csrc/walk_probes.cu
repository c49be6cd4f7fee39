// The walk probes: what one step of a serial walk costs on an H100 SM,
// piece by piece.  On no path of the system: tools/walk_probes.py launches
// them, holds each output to its plain version and times each mode.
//
// Replaces the four TPU probes under scripts/ (Q2-17a, b, c, e):
//   walk_probe_a  scripts/walk_ablate.py:36 kernel (pallas_call :91): a
//                 while loop of N steps, one piece of the banded walk's
//                 body added a mode: empty, wr (a store of the step's
//                 value), rd (a band read and a byte decode), rd3 (three
//                 reads and a decode-like move), cond (a rarely taken
//                 branch), cond_dma (that branch with a copy inside);
//   walk_probe_b  scripts/walk_ablate2.py:32 kernel (:101): the loop's
//                 structure: while and counted loops, 4 or 8 stores a
//                 body, the refetch branch, 8 three-read steps a body;
//   walk_probe_c  scripts/walk_ablate3.py:33 kernel (:123): a walk over a
//                 (128, 256) window of a traced plane of real size: the
//                 real decode rules and carry, a six-value carry with a
//                 miss test, a window refetched every 119 or 18 steps;
//   walk_probe_e  scripts/db_probe.py:14 kern (:31): a double-buffered
//                 band, each buffer filled by its own copy behind its own
//                 barrier, then 64 scalar reads summed.
//
// One block a program, the scripts' grid of P programs side by side, one
// an SM (on the TPU they ran one after another on one core).  The block's
// threads fill the band, the TPU's SMEM scratch, here dynamic shared
// memory (96, 96, 128 and 64 KB, above the 48 KB default after
// cudaFuncSetAttribute), with INT32_MIN: the value the JAX kernel reads
// from scratch nothing wrote in interpret mode, undefined on a TPU.  After
// one barrier thread 0 alone walks, as the walker of psa_walk_stage.cuh,
// computing exactly what the TPU program computes and storing its results
// to `out` in device memory as it goes (the TPU kernel wrote an SMEM out
// block back after the program).  The wrapper fills `out` with INT32_MIN,
// so the words no mode writes equal interpret mode's.
//
// A copy, the TPU's make_async_copy(...).start(); .wait() inside one
// thread's data-dependent branch, is Hopper's bulk async copy
// (cp.async.bulk ... mbarrier::complete_tx::bytes) completing on an
// mbarrier in shared memory, which the walker waits on by its phase
// parity: no __syncthreads can sit in that branch.  (a), (b): the band is
// 24 whole rows of the plane, one contiguous 98,304-byte copy, compiled in
// and never taken (bi0 starts at -2^30 and i >= 0, as in the scripts).
// (c): 128 row copies of 1,024 bytes on one barrier and one expect_tx of
// 131,072 bytes.  (e): two barriers picked at run time by the buffer
// index, each waited on its own parity.
//
// The loops must survive the compiler: N and the initial bi0 are kernel
// arguments, the loops are not unrolled (the TPU's while and fori loops
// were not), and keep() passes each loop-carried value through an empty
// asm statement once a step, which emits no instruction but hides the
// value from the optimiser, so the empty modes' loops are not folded
// into their results.  (a)'s empty loop computes nothing the output
// reads; its last store reads the loop's t (below).  tools/walk_probes.py
// reads each mode's loop and its instructions a step from the library's
// SASS.  The band's shape, the modulo constants and (c)'s refetch period
// are compile-time constants, as in the TPU kernels.
//
// What bounds it: one thread's serial chain.  A step issues at most one
// instruction a clock, and in (c) each step's band reads depend on the
// step before (one dependent shared-memory load a step); a copy that
// fires adds its bytes.  Nothing here is made fast: a probe measures.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // the band's fill; thread 0 then walks
constexpr int kEmpty = INT_MIN;  // interpret mode's unwritten word
// (a), (b): the band, 24 whole rows of the (256, 1,024) plane
constexpr int kAbRows = 24, kAbCols = 1024;
// (b): out's ring of columns, and its row width
constexpr int kOutRing = 10240, kOutColsB = 10248;
// (c): the band, a (128, 256) window of the plane
constexpr int kCRows = 128, kCCols = 256;
// (e): a buffer of the band, (R, WS, L), two of them
constexpr int kER = 8, kEWs = 8, kEL = 128;
constexpr int kEBuf = kER * kEWs * kEL;

enum ModeA { kAEmpty, kAWr, kARd, kARd3, kACond, kACondDma, kModesA };
enum ModeB {
  kBWhileEmpty, kBForiEmpty, kBUnroll4, kBUnroll8, kBCondDma, kBFullUnroll8,
  kModesB
};
enum ModeC { kCNodma, kCDecode, kCSix, kCDma119, kCDma18, kModesC };

__device__ __forceinline__ void keep1(int& v) { asm volatile("" : "+r"(v)); }

// Hide each loop-carried value from the optimiser; no instruction.
template <typename... T>
__device__ __forceinline__ void keep(T&... v) {
  (keep1(v), ...);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// jnp's //: rounds toward -infinity (C's / toward zero); b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar))
               : "memory");
}

// Arrive on `bar` and expect `bytes` of copies to complete its phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed; a copy
// that never lands traps (a launch error) after 2^24 polls, not a hang.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == 1u << 24) __trap();
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// The block fills the band with kEmpty and thread 0 initialises `bars`
// barriers after it; returns true on thread 0, the walker, alone.
__device__ __forceinline__ bool setup(int* band, int words, uint64_t* bar,
                                      int bars) {
  for (int k = threadIdx.x; k < words; k += blockDim.x) band[k] = kEmpty;
  // the fill (generic proxy) before any bulk copy (async proxy) writes it
  fence_async();
  if (threadIdx.x == 0) {
    for (int k = 0; k < bars; ++k) bar_init(bar + k);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return threadIdx.x == 0;
}

// (a) and (b)'s refetch: 24 whole rows from row bi, read where
// dynamic_slice reads them (clamped into the plane, as in interpret mode;
// the scripts' copy never fires).
__device__ __forceinline__ void fetch_rows(int* band, uint64_t* bar,
                                           uint32_t& phase, const int* plane,
                                           int plane_rows, int bi) {
  constexpr uint32_t kBytes = kAbRows * kAbCols * 4;
  const int r = clampi(bi, 0, plane_rows - kAbRows);
  fence_async();   // the walker's band reads before the copy rewrites it
  bar_expect(bar, kBytes);
  bulk_copy(band, plane + (size_t)r * kAbCols, kBytes, bar);
  bar_wait(bar, phase);
  phase ^= 1;
}

__device__ __forceinline__ int byte_at(int w, int sh) {
  return (w >> sh) & 0xFF;
}

// Q2-17a: scripts/walk_ablate.py's kernel body, mode by mode.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    walk_probe_a(const int* __restrict__ plane, int* __restrict__ out, int n,
                 int plane_rows, int bi0_init) {
  extern __shared__ __align__(16) int band[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(band + kAbRows * kAbCols);
  if (!setup(band, kAbRows * kAbCols, bar, 1)) return;
  constexpr bool kCond = kMode == kACond || kMode == kACondDma;
  int* row = out + (size_t)blockIdx.x * (n + 1);
  int i = n - 1, t = 0, acc = 0, bi0 = kCond ? bi0_init : 0;
  uint32_t phase = 0;
#pragma unroll 1
  while (i >= 0) {
    if constexpr (kCond) {
      if (i < bi0) {   // the refetch
        if constexpr (kMode == kACondDma) {
          const int bi = max(floor_div(i - 15, 8) * 8, 0);
          fetch_rows(band, bar, phase, plane, plane_rows, bi);
          bi0 = bi;
        } else {
          bi0 = max(i - 23, 0);
        }
      }
    }
    int acc2 = acc;
    if constexpr (kMode >= kARd) {
      const int li = clampi(kCond ? i - bi0 : i % kAbRows, 0, kAbRows - 1);
      const int sh = (i & 3) * 8;
      const int code = byte_at(band[li * kAbCols + (i >> 2) % kAbCols], sh);
      acc2 = acc + code;
      if constexpr (kMode >= kARd3) {
        const int w2 = band[li * kAbCols + (max(i - 1, 0) >> 2) % kAbCols];
        const int w3 = band[max(li - 1, 0) * kAbCols + (i >> 2) % kAbCols];
        const int f = byte_at(w2, sh) / 3 % 3;
        const int e = byte_at(w3, sh) % 3;
        acc2 += acc2 % 9 == 1 ? 1 : (f > e ? 0 : 2);
      }
    }
    if constexpr (kMode != kAEmpty) row[t] = acc2;
    i -= 1;
    t += 1;
    acc = acc2;
    keep(i, t, acc, bi0);
  }
  // empty: nothing reads the loop's values, and the assembler deletes
  // such a loop (keep() stops the compiler, not ptxas); acc + (t - N),
  // which is acc after N steps, reads its t: one add after the loop, none
  // in it
  row[0] = kMode == kAEmpty ? acc + (t - n) : acc;
}

// Q2-17b's read_step: three band reads, the move, its store.
__device__ __forceinline__ int read_step_b(const int* band, int* row, int i,
                                           int t, int acc, int bi0) {
  const int li = clampi(i - bi0, 0, kAbRows - 1);
  const int sh = (i & 3) * 8;
  const int code = byte_at(band[li * kAbCols + (i >> 2) % kAbCols], sh);
  const int w2 = band[li * kAbCols + (max(i - 1, 0) >> 2) % kAbCols];
  const int w3 = band[max(li - 1, 0) * kAbCols + (i >> 2) % kAbCols];
  const int f = byte_at(w2, sh) / 3 % 3;
  const int e = byte_at(w3, sh) % 3;
  const int move = code % 9 == 1 ? 1 : (f > e ? 0 : 2);
  row[t % kOutRing] = acc + move;
  return acc + move;
}

// Q2-17b: scripts/walk_ablate2.py's kernel body, mode by mode.  N is a
// multiple of 8 (the wrapper's check), so i - k >= 0 in every step.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    walk_probe_b(const int* __restrict__ plane, int* __restrict__ out, int n,
                 int plane_rows, int bi0_init) {
  extern __shared__ __align__(16) int band[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(band + kAbRows * kAbCols);
  if (!setup(band, kAbRows * kAbCols, bar, 1)) return;
  int* row = out + (size_t)blockIdx.x * kOutColsB;
  if constexpr (kMode == kBForiEmpty) {
    int i = n - 1, t = 0, acc = 0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      i -= 1;
      t += 1;
      acc += 1;
      keep(i, t, acc);
    }
    row[0] = acc;
  } else {
    constexpr int U = kMode == kBUnroll4 ? 4
                      : (kMode == kBUnroll8 || kMode == kBFullUnroll8) ? 8
                                                                        : 1;
    constexpr bool kDma = kMode == kBCondDma || kMode == kBFullUnroll8;
    int i = n - 1, t = 0, acc = 0, bi0 = kDma ? bi0_init : 0;
    uint32_t phase = 0;
#pragma unroll 1
    while (i >= 0) {
      if constexpr (kDma) {
        if (i < bi0) {   // the refetch
          const int bi = clampi(floor_div(i % 224 - 15, 8) * 8, 0,
                                plane_rows - kAbRows);
          fetch_rows(band, bar, phase, plane, plane_rows, bi);
          bi0 = bi;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if constexpr (kMode == kBUnroll4 || kMode == kBUnroll8) {
          row[(t + k) % kOutRing] = acc;
          acc += 1;
        } else if constexpr (kMode == kBFullUnroll8) {
          acc = read_step_b(band, row, i - k, t + k, acc, bi0);
        } else {
          acc += 1;
        }
      }
      i -= U;
      t += U;
      keep(i, t, acc, bi0);
    }
    row[0] = acc;
  }
}

// Q2-17c: scripts/walk_ablate3.py's kernel body, mode by mode, on an
// (m_rows, n_w) plane.  j >= i >= 0 in every step (i drops by one a step,
// j by at most one).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    walk_probe_c(const int* __restrict__ plane, int* __restrict__ out, int n,
                 int m_rows, int n_w) {
  extern __shared__ __align__(16) int band[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(band + kCRows * kCCols);
  if (!setup(band, kCRows * kCCols, bar, 1)) return;
  constexpr bool kDma = kMode == kCDma119 || kMode == kCDma18;
  constexpr int kPeriod = kMode == kCDma119 ? 119 : 18;
  int* row = out + (size_t)blockIdx.x * (n + 8);
  int i = n - 1, t = 0, j = n - 1, forced = 0, bi0 = 0, wj0 = 0;
  uint32_t phase = 0;
#pragma unroll 1
  while (i >= 0) {
    if constexpr (kDma) {
      if (t % kPeriod == 0) {   // the refetch: 128 rows of 256 words
        const int bi = clampi(floor_div(i - (kCRows - 9), 8) * 8, 0,
                              m_rows - kCRows);
        const int wj = clampi(floor_div((j >> 2) + 128, 128) * 128 - kCCols,
                              0, n_w - kCCols);
        fence_async();
        bar_expect(bar, kCRows * kCCols * 4);
        const int* src = plane + (size_t)bi * n_w + wj;
        for (int r = 0; r < kCRows; ++r)
          bulk_copy(band + r * kCCols, src + (size_t)r * n_w, kCCols * 4,
                    bar);
        bar_wait(bar, phase);
        phase ^= 1;
        bi0 = bi;
        wj0 = wj;
      }
    } else if constexpr (kMode == kCSix) {
      const bool in_core0 = (i >= 0) & (j >= 0);
      const bool miss =
          in_core0 & (((i > 0) & (i - 1 < bi0 - 2 * m_rows)) |
                      (i < bi0 - 2 * m_rows) | (i >= bi0 + kCRows) |
                      ((max(j - 1, 0) >> 2) < wj0 - 2 * n_w) |
                      ((j >> 2) >= wj0 + kCCols));
      bi0 = miss ? bi0 + 1 : bi0;
    }
    const int li = kDma ? clampi(i - bi0, 0, kCRows - 1) : i % kCRows;
    const int ww = clampi(
        kDma ? (max(j, 0) >> 2) - wj0 : (j >> 2) % kCCols, 0, kCCols - 1);
    const int sh = (j & 3) * 8;
    const int code = byte_at(band[li * kCCols + ww], sh);
    const int w2 = band[li * kCCols + clampi(ww - 1, 0, kCCols - 1)];
    const int w3 = band[clampi(li - 1, 0, kCRows - 1) * kCCols + ww];
    const int fprev = byte_at(w2, sh) / 3 % 3;
    const int eprev = byte_at(w3, sh) % 3;
    int move;
    if constexpr (kMode == kCNodma) {
      move = code % 3;
    } else {   // the real _decode_step rules, with the forced-move carry
      const bool in_core = (i >= 0) & (j >= 0);
      const int back = code / 9, f = code / 3 % 3, e = code % 3;
      move = in_core ? (forced > 0 ? forced - 1 : back) : (j >= 0 ? 0 : 2);
      const bool force_left = (move == 0) & (j - 1 >= 0) &
                              ((f == 0) | ((f >= 1) & (fprev == 2)));
      const bool force_up = (move == 2) & (i - 1 >= 0) &
                            ((e == 0) | ((e >= 1) & (eprev == 2)));
      forced = in_core ? (force_left ? 1 : (force_up ? 3 : 0)) : 0;
    }
    row[t] = move;
    i -= max(move == 0 ? 0 : 1, 1);
    t += 1;
    j -= move == 2 ? 0 : 1;
    keep(i, t, j, forced, bi0, wj0);
  }
  row[0] = t + bi0;
}

// Q2-17e: scripts/db_probe.py's kern: buffer b of the band from rows
// [b R, b R + R) of x behind barrier b, both picked at run time, then
// `steps` reads band[t & 1, t % R, 7t % WS, 13t % L] summed.
__global__ void __launch_bounds__(kThreads)
    walk_probe_e(const int* __restrict__ x, int* __restrict__ out,
                 int steps) {
  extern __shared__ __align__(16) int band[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(band + 2 * kEBuf);
  if (!setup(band, 2 * kEBuf, bars, 2)) return;
  uint32_t phases = 0;   // bit b: the parity barrier b waits on next
#pragma unroll 1
  for (int buf = 0; buf < 2; ++buf) {
    uint64_t* bar = bars + buf;
    fence_async();
    bar_expect(bar, kEBuf * 4);
    bulk_copy(band + buf * kEBuf, x + (size_t)buf * kEBuf, kEBuf * 4, bar);
    bar_wait(bar, (phases >> buf) & 1);
    phases ^= 1u << buf;
  }
  int acc = 0;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    acc += band[((buf * kER + t % kER) * kEWs + t * 7 % kEWs) * kEL +
                t * 13 % kEL];
    keep(t, acc);
  }
  out[0] = acc;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int band_words, int bars,
           cudaStream_t stream, Args... args) {
  const int bytes = band_words * 4 + bars * 8;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<blocks, kThreads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_ab(bool b, const int* plane, int* out, int n, int p,
              int plane_rows, int bi0, cudaStream_t s) {
  return b ? launch(walk_probe_b<kMode>, p, kAbRows * kAbCols, 1, s, plane,
                    out, n, plane_rows, bi0)
           : launch(walk_probe_a<kMode>, p, kAbRows * kAbCols, 1, s, plane,
                    out, n, plane_rows, bi0);
}

int probe_ab(bool b, const void* plane, void* out, int mode, int n, int p,
             int plane_rows, int bi0, void* stream) {
  if (n < 1 || p < 1 || plane_rows < kAbRows || (b && n % 8) ||
      mode < 0 || mode >= (b ? (int)kModesB : (int)kModesA))
    return (int)cudaErrorInvalidValue;
  const int* pl = static_cast<const int*>(plane);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_ab<0>(b, pl, o, n, p, plane_rows, bi0, s);
    case 1: return launch_ab<1>(b, pl, o, n, p, plane_rows, bi0, s);
    case 2: return launch_ab<2>(b, pl, o, n, p, plane_rows, bi0, s);
    case 3: return launch_ab<3>(b, pl, o, n, p, plane_rows, bi0, s);
    case 4: return launch_ab<4>(b, pl, o, n, p, plane_rows, bi0, s);
    default: return launch_ab<5>(b, pl, o, n, p, plane_rows, bi0, s);
  }
}

}  // namespace

// Q2-17a: plane (plane_rows, 1,024) int32, out (p, n + 1) int32 filled
// with INT32_MIN; mode 0 empty, 1 wr, 2 rd, 3 rd3, 4 cond, 5 cond_dma; bi0
// the refetch state's start (the script's -2^30).  Returns
// cudaErrorInvalidValue without launching for a bad mode or size, else the
// launch's error (a refused shared-memory size included).
extern "C" int tsta_walk_probe_a(const void* plane, void* out, int mode,
                                 int n, int p, int plane_rows, int bi0,
                                 void* stream) {
  return probe_ab(false, plane, out, mode, n, p, plane_rows, bi0, stream);
}

// Q2-17b: as Q2-17a, out (p, 10,248), n a multiple of 8; mode 0
// while_empty, 1 fori_empty, 2 unroll4, 3 unroll8, 4 cond_dma, 5
// full_unroll8.
extern "C" int tsta_walk_probe_b(const void* plane, void* out, int mode,
                                 int n, int p, int plane_rows, int bi0,
                                 void* stream) {
  return probe_ab(true, plane, out, mode, n, p, plane_rows, bi0, stream);
}

// Q2-17c: plane (m_rows, n_w) int32, n_w a multiple of 4 and the plane
// 16-byte aligned, out (p, n + 8) filled with INT32_MIN; mode 0 nodma, 1
// decode, 2 six, 3 dma119, 4 dma18.
extern "C" int tsta_walk_probe_c(const void* plane, void* out, int mode,
                                 int n, int p, int m_rows, int n_w,
                                 void* stream) {
  if (n < 1 || p < 1 || m_rows < kCRows || n_w < kCCols || n_w % 4 ||
      mode < 0 || mode >= kModesC)
    return (int)cudaErrorInvalidValue;
  const int* pl = static_cast<const int*>(plane);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kW = kCRows * kCCols;
  switch (mode) {
    case kCNodma:
      return launch(walk_probe_c<kCNodma>, p, kW, 1, s, pl, o, n, m_rows, n_w);
    case kCDecode:
      return launch(walk_probe_c<kCDecode>, p, kW, 1, s, pl, o, n, m_rows,
                    n_w);
    case kCSix:
      return launch(walk_probe_c<kCSix>, p, kW, 1, s, pl, o, n, m_rows, n_w);
    case kCDma119:
      return launch(walk_probe_c<kCDma119>, p, kW, 1, s, pl, o, n, m_rows,
                    n_w);
    default:
      return launch(walk_probe_c<kCDma18>, p, kW, 1, s, pl, o, n, m_rows,
                    n_w);
  }
}

// Q2-17e: x (16, 8, 128) int32, out (1, 1); `steps` reads (the script's
// 64).
extern "C" int tsta_walk_probe_e(const void* x, void* out, int steps,
                                 void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  return launch(walk_probe_e, 1, 2 * kEBuf, 2,
                static_cast<cudaStream_t>(stream),
                static_cast<const int*>(x), static_cast<int*>(out), steps);
}
