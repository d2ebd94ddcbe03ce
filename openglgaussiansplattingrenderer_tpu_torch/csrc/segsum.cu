// Per-splat segment sum of record cotangents: the transpose of expand.cu,
// for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/records.py
//           _segsum_kernel (512 splats a grid step; their records streamed
//           in 128-aligned chunks and reduced onto the splat axis by a
//           transposed one-hot matrix-unit product).
// Bound on the card: bytes. 36 bytes read a record below total, 36 bytes
//           written and 4 read a splat; one add a value.
// Design:   records are splat-major, so splat s owns the contiguous span
//           [cum_incl[s-1], min(cum_incl[s], total)), total =
//           min(cum_incl[n-1], capacity): records at or past total were
//           zeroed by the expansion and carry no gradient. kGroup = 8
//           lanes share a splat (the mean span of a frame is a few
//           records, a large splat's a few hundred): each lane strides
//           over the span adding nine rows, a shuffle tree over the group
//           sums them, the group's first lane writes nine floats. Adjacent
//           groups read adjacent records, so loads coalesce across splats.
//           No atomics, one fixed summation order: the result is the same
//           from run to run. A splat with no records gets zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr int kFields = 9;

__global__ void __launch_bounds__(kThreads)
segsum(const float* __restrict__ g, int capacity,      // (9, capacity)
       const int32_t* __restrict__ cum_incl, int n,    // (n,)
       float* __restrict__ out) {                      // (9, n)
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s = tid / kGroup;
  const int lane = threadIdx.x % kGroup;
  int lo = 0, hi = 0;  // an empty span for the groups past n: every lane
                       // of the warp still takes part in the shuffles
  if (s < n) {
    const int total = min(cum_incl[n - 1], capacity);
    lo = s > 0 ? cum_incl[s - 1] : 0;
    hi = min(cum_incl[s], total);
  }
  float acc[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
  for (int r = lo + lane; r < hi; r += kGroup) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) acc[f] += g[(size_t)f * capacity + r];
  }
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      acc[f] += __shfl_down_sync(0xffffffffu, acc[f], off, kGroup);
  }
  if (lane == 0 && s < n) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) out[(size_t)f * n + s] = acc[f];
  }
}

}  // namespace

// g: (9, capacity) f32 record cotangents; cum_incl (n,) int32 inclusive
// prefix sum of the per-splat record counts; out (9, n) f32.
extern "C" int gs_segsum(const float* g, int capacity, const int32_t* cum_incl, int n,
                         float* out, void* stream) {
  if (n <= 0) return 0;
  const long long threads = (long long)n * kGroup;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segsum<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, capacity, cum_incl, n, out);
  return static_cast<int>(cudaGetLastError());
}
