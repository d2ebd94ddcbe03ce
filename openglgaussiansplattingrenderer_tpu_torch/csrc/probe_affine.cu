// x * 2 + 1 over a float array: the small kernel the build-cache probe
// rebuilds, for Hopper (sm_90a).
//
// Replaces: scripts/cache_key_probe.py kernel (one (8, 128) f32 block, the
//           smallest program that carries source locations into the TPU
//           compile-cache key).
// Bound on the card: bytes, 4 B read and 4 B written a value; at the
//           probe's 1,024 values the launch is all there is to time.
// Design:   a thread takes four values with one 16-byte load and one
//           16-byte store where both arrays start on a 16-byte boundary,
//           and the last n % 4 values (or all of them, off that boundary)
//           go one a thread. The library is built without multiply-add
//           contraction, so the result equals x * 2 + 1 in PyTorch bit for
//           bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Threads [0, n4) take four values each, threads [n4, n4 + n - 4 * n4) one.
__global__ void probe_affine(const float* __restrict__ x, float* __restrict__ out,
                             long long n, long long n4) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(out)[i] = make_float4(
        v.x * 2.0f + 1.0f, v.y * 2.0f + 1.0f, v.z * 2.0f + 1.0f, v.w * 2.0f + 1.0f);
  } else {
    const long long j = 4 * n4 + (i - n4);
    if (j < n) out[j] = x[j] * 2.0f + 1.0f;
  }
}

}  // namespace

// x, out: n f32 on the device.
extern "C" int gs_probe_affine(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long threads = n4 + (n - 4 * n4);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  probe_affine<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, n4);
  return static_cast<int>(cudaGetLastError());
}
