// The loads-first form of the Adam kernel, not taken, kept for
// scripts/torch_adam_probe.py: built appended to csrc/adam.cu (it uses its
// AdamArgs, Key, key_at, key_of, adam_one and adam_four), entry point
// gs_adam_step_loads_first, the same arguments planned with chunks of
// kThreads * 4 * kLoadGroups elements.
//
// The earlier kernel's blocks with what was thought to hold them back
// removed: the key's pointers are __restrict__, every one of a thread's
// 4 kLoadGroups 16-byte loads is issued before any arithmetic, and loads and
// stores carry streaming cache hints (__ldcs, __stcs: each byte is touched
// once). At 8 groups it needs 160 registers: one block an SM, whose loads,
// arithmetic and stores no other block overlaps.

namespace {

constexpr int kLoadGroups = 8;                                // float4s of each array a thread
constexpr int kLoadChunk = kThreads * 4 * kLoadGroups;

__global__ void __launch_bounds__(kThreads) adam_loads_first(const AdamArgs a) {
  const long long chunks = a.first_chunk[kAdamMaxKeys];
  const int t = threadIdx.x;
  if (blockIdx.x < chunks) {
    const Key s = key_at(a, key_of(a.first_chunk, blockIdx.x));
    const long long start = (blockIdx.x - s.first_chunk) * kLoadChunk;
    const long long end = min(start + kLoadChunk, s.n & ~3LL);
    const float4* __restrict__ p = reinterpret_cast<const float4*>(s.in[0]);
    const float4* __restrict__ g = reinterpret_cast<const float4*>(s.in[1]);
    const float4* __restrict__ m = reinterpret_cast<const float4*>(s.in[2]);
    const float4* __restrict__ v = reinterpret_cast<const float4*>(s.in[3]);
    float4* __restrict__ po = reinterpret_cast<float4*>(s.out[0]);
    float4* __restrict__ mo = reinterpret_cast<float4*>(s.out[1]);
    float4* __restrict__ vo = reinterpret_cast<float4*>(s.out[2]);
    float4 P[kLoadGroups], G[kLoadGroups], M[kLoadGroups], V[kLoadGroups];
#pragma unroll
    for (int j = 0; j < kLoadGroups; ++j) {
      const long long e = start + 4 * (j * kThreads + t);
      if (e < end) {
        P[j] = __ldcs(p + e / 4);
        G[j] = __ldcs(g + e / 4);
        M[j] = __ldcs(m + e / 4);
        V[j] = __ldcs(v + e / 4);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadGroups; ++j) {
      const long long e = start + 4 * (j * kThreads + t);
      if (e < end) {
        float4 x, y, z;
        adam_four(a, s.neg_lr, P[j], G[j], M[j], V[j], x, y, z);
        __stcs(po + e / 4, x);
        __stcs(mo + e / 4, y);
        __stcs(vo + e / 4, z);
      }
    }
  } else {
    const long long x = (blockIdx.x - chunks) * kThreads + t;
    if (x >= a.first_elem[kAdamMaxKeys]) return;
    const Key s = key_at(a, key_of(a.first_elem, x));
    const long long i = s.elem_lo + (x - s.first_elem);
    adam_one(a, s.neg_lr, s.in[0][i], s.in[1][i], s.in[2][i], s.in[3][i], s.out[0][i],
             s.out[1][i], s.out[2][i]);
  }
}

}  // namespace

extern "C" int gs_adam_step_loads_first(const void* args, void* stream) {
  const AdamArgs& a = *static_cast<const AdamArgs*>(args);
  if (a.keys < 1 || a.keys > kAdamMaxKeys || a.blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.blocks == 0) return 0;
  adam_loads_first<<<a.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
