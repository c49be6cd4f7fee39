// The narrow-dtype max probe: how much an elementwise max costs in a
// narrow integer type against int32, and how the s16x2 DPX forms that the
// difference method's cell uses (psa_dp_diff.cu) compare with their int32
// forms.
//
// Replaces the TPU probe scripts/dtype_max_probe.py:19 kern (its
// pallas_call at :34, Q2-17d): a (256, 128) tile of one dtype, c = x, then
// ITERS rounds of c = max(max(max(max(c, y), x), y), x).  Here a 32-bit
// word holds one int32 lane, two 16-bit lanes or four 8-bit lanes, and each
// form is the card's own instruction for its lanes:
//   int32   max.s32                 (IMNMX)
//   int16   __vmaxs2, uint16 __vmaxu2
//   int8    __vmaxs4, uint8  __vmaxu4
// and the DPX forms, on int32 lanes and on s16x2 words:
//   viaddmax  c = max(c + y, x), four times a round
//             (__viaddmax_s32, __viaddmax_s16x2)
//   vimax3    c = max(c, y, x), four times a round
//             (__vimax3_s32, __vimax3_s16x2)
// Every step's result passes through an empty asm statement, so the
// compiler can neither fold a round's repeated maxes nor hoist a step out
// of the loop: each step is one dependent instruction of the chain, as in
// the TPU probe.
//
// Launch: `copies` copies of the tile, out (copies, words), each word an
// independent chain, a grid of 8 blocks of 256 threads an SM striding over
// them, so the card runs enough warps to be bound by its issue rate, not by
// one chain's latency.  What bounds it: the INT32 pipe, 64 lanes a clock an
// SM, one instruction a step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Form : int {
  kInt32 = 0, kInt16, kUint16, kInt8, kUint8,
  kViaddmaxS32, kViaddmaxS16x2, kVimax3S32, kVimax3S16x2, kForms
};

__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <int kForm>
__device__ __forceinline__ uint32_t step(uint32_t c, uint32_t v, uint32_t x) {
  if constexpr (kForm == kInt32) {
    uint32_t r;
    asm("max.s32 %0, %1, %2;" : "=r"(r) : "r"(c), "r"(v));
    return r;
  } else if constexpr (kForm == kInt16) {
    return __vmaxs2(c, v);
  } else if constexpr (kForm == kUint16) {
    return __vmaxu2(c, v);
  } else if constexpr (kForm == kInt8) {
    return __vmaxs4(c, v);
  } else if constexpr (kForm == kUint8) {
    return __vmaxu4(c, v);
  } else if constexpr (kForm == kViaddmaxS32) {
    return (uint32_t)__viaddmax_s32((int)c, (int)v, (int)x);
  } else if constexpr (kForm == kViaddmaxS16x2) {
    return __viaddmax_s16x2(c, v, x);
  } else if constexpr (kForm == kVimax3S32) {
    return (uint32_t)__vimax3_s32((int)c, (int)v, (int)x);
  } else {
    return __vimax3_s16x2(c, v, x);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
dtype_max_probe_kernel(const uint32_t* __restrict__ xs,
                       const uint32_t* __restrict__ ys,
                       uint32_t* __restrict__ out, int words, int iters,
                       long long items) {
  constexpr bool kDpx = kForm >= kViaddmaxS32;
  for (long long k = blockIdx.x * (long long)kThreads + threadIdx.x;
       k < items; k += (long long)gridDim.x * kThreads) {
    const int w = (int)(k % words);
    const uint32_t x = opaque(xs[w]), y = opaque(ys[w]);
    uint32_t c = x;
    for (int r = 0; r < iters; ++r) {
      // max forms: max(c, y), then x, y, x; DPX forms: op(c, y, x) four
      // times
      c = opaque(step<kForm>(c, y, x));
      c = opaque(step<kForm>(c, kDpx ? y : x, x));
      c = opaque(step<kForm>(c, y, x));
      c = opaque(step<kForm>(c, kDpx ? y : x, x));
    }
    out[k] = c;
  }
}

template <int kForm>
int launch(const void* x, const void* y, void* out, int words, int iters,
           int copies, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)words * copies;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  dtype_max_probe_kernel<kForm><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out), words, iters, items);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (words,) 32-bit words of the tile in the form's lanes; out:
// (copies, words); form: 0 int32, 1 int16, 2 uint16, 3 int8, 4 uint8, 5
// viaddmax s32, 6 viaddmax s16x2, 7 vimax3 s32, 8 vimax3 s16x2.  Returns
// cudaErrorInvalidValue without launching for another form or a
// non-positive count, else cudaGetLastError() after the launch.
extern "C" int tsta_dtype_max_probe(const void* x, const void* y, void* out,
                                    int form, int words, int iters,
                                    int copies, void* stream) {
  if (words < 1 || iters < 0 || copies < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kInt32: return launch<kInt32>(x, y, out, words, iters, copies, s);
    case kInt16: return launch<kInt16>(x, y, out, words, iters, copies, s);
    case kUint16: return launch<kUint16>(x, y, out, words, iters, copies, s);
    case kInt8: return launch<kInt8>(x, y, out, words, iters, copies, s);
    case kUint8: return launch<kUint8>(x, y, out, words, iters, copies, s);
    case kViaddmaxS32:
      return launch<kViaddmaxS32>(x, y, out, words, iters, copies, s);
    case kViaddmaxS16x2:
      return launch<kViaddmaxS16x2>(x, y, out, words, iters, copies, s);
    case kVimax3S32:
      return launch<kVimax3S32>(x, y, out, words, iters, copies, s);
    case kVimax3S16x2:
      return launch<kVimax3S16x2>(x, y, out, words, iters, copies, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
