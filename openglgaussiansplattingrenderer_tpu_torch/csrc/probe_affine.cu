// x * 2 + 1 over a float array: the small kernel the build-cache probe
// rebuilds, for Hopper (sm_90a).
//
// Replaces: scripts/cache_key_probe.py kernel (one (8, 128) f32 block, the
//           smallest program that carries source locations into the TPU
//           compile-cache key).
// Bound on the card: bytes, 4 B read and 4 B written a value; at the
//           probe's 1,024 values the launch is all there is to time.
// Design:   one thread a value. The library is built without multiply-add
//           contraction, so the result equals x * 2 + 1 in PyTorch bit for
//           bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void probe_affine(const float* __restrict__ x, float* __restrict__ out,
                             long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f + 1.0f;
}

}  // namespace

// x, out: n f32 on the device.
extern "C" int gs_probe_affine(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  probe_affine<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
