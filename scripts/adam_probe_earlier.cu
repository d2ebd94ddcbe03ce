// One Adam step over every raw tensor of a train step, in one launch
// (multi-tensor apply), for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package's optimizer is optax's adam
//           (openglgaussiansplattingrenderer_tpu/train/trainer.py
//           make_optimizer), which XLA fuses; the port wrote it out as some
//           13 elementwise torch calls a tensor and the addition to the raw
//           tensor (ops/kernels/adam.py adam_update_plain).
// Bound on the card: bytes. An element reads p, g, m and v and writes p',
//           m' and v': 28 B, and a handful of float operations.
// Design:   the keys' pointers, lengths, learning rates and the step's
//           scalars travel in one AdamArgs struct, passed by value. A block
//           takes 4,096 elements of one key (blocks are numbered key after
//           key: first_block), a thread four groups of four, each group one
//           16-byte load of p, g, m, v and one 16-byte store of p', m', v'
//           where all seven of the key's arrays start on a 16-byte boundary
//           (vec); the last n % 4 elements, and a key off that boundary, go
//           one element at a time. Outputs are new arrays: the step is
//           functional. Every float expression rounds as the plain version's
//           torch calls do on the card (the library is built without
//           multiply-add contraction; sqrt and division are IEEE): a torch
//           tensor divided by a Python float is multiplied by the reciprocal
//           taken in double and rounded to float (inv_c1, inv_c2), each
//           Python scalar is rounded to float, and the update -lr * step is
//           rounded before it is added to p.

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int kAdamMaxKeys = 8;

// ops/kernels/adam.py AdamArgs mirrors the layout; gs_adam_args_size lets
// it check.
struct AdamArgs {
  const float* p[kAdamMaxKeys];
  const float* g[kAdamMaxKeys];
  const float* m[kAdamMaxKeys];
  const float* v[kAdamMaxKeys];
  float* p_out[kAdamMaxKeys];
  float* m_out[kAdamMaxKeys];
  float* v_out[kAdamMaxKeys];
  long long n[kAdamMaxKeys];
  long long first_block[kAdamMaxKeys + 1];
  float neg_lr[kAdamMaxKeys];
  int vec[kAdamMaxKeys];
  float b1, one_minus_b1, b2, one_minus_b2, inv_c1, inv_c2, eps;
  int keys;
};

}  // namespace gs

namespace {

using gs::AdamArgs;
using gs::kAdamMaxKeys;

constexpr int kThreads = 256;
constexpr int kGroups = 4;                                  // float4s a thread
constexpr long long kBlockElems = (long long)kThreads * 4 * kGroups;

struct Key {
  const float *p, *g, *m, *v;
  float *po, *mo, *vo;
  long long n;
  float neg_lr;
  int vec;
  long long first;
};

// The block's key, its arrays read with constant indices (a dynamic index
// into the parameter struct would copy it to local memory).
__device__ __forceinline__ Key key_of(const AdamArgs& a, long long block) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < kAdamMaxKeys; ++i)
    if (i < a.keys && block >= a.first_block[i]) k = i;
  Key s{};
#pragma unroll
  for (int i = 0; i < kAdamMaxKeys; ++i) {
    if (i == k) {
      s = Key{a.p[i], a.g[i], a.m[i], a.v[i], a.p_out[i], a.m_out[i], a.v_out[i],
              a.n[i], a.neg_lr[i], a.vec[i], a.first_block[i]};
    }
  }
  return s;
}

// One element: adam_update_plain's expressions in its order.
__device__ __forceinline__ void adam_one(const AdamArgs& a, float neg_lr, float p, float g,
                                         float m, float v, float& po, float& mo, float& vo) {
  mo = a.b1 * m + a.one_minus_b1 * g;
  vo = a.b2 * v + a.one_minus_b2 * (g * g);
  const float step = (mo * a.inv_c1) / (sqrtf(vo * a.inv_c2) + a.eps);
  const float u = neg_lr * step;
  po = p + u;
}

__global__ void __launch_bounds__(kThreads) adam_step(const AdamArgs a) {
  const Key s = key_of(a, blockIdx.x);
  const long long start = (blockIdx.x - s.first) * kBlockElems;
  if (s.vec) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const long long e = start + 4 * ((long long)j * kThreads + threadIdx.x);
      if (e + 4 <= s.n) {
        const long long q = e / 4;
        const float4 g = reinterpret_cast<const float4*>(s.g)[q];
        const float4 m = reinterpret_cast<const float4*>(s.m)[q];
        const float4 v = reinterpret_cast<const float4*>(s.v)[q];
        const float4 p = reinterpret_cast<const float4*>(s.p)[q];
        float4 po, mo, vo;
        adam_one(a, s.neg_lr, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
        adam_one(a, s.neg_lr, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
        adam_one(a, s.neg_lr, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
        adam_one(a, s.neg_lr, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
        reinterpret_cast<float4*>(s.po)[q] = po;
        reinterpret_cast<float4*>(s.mo)[q] = mo;
        reinterpret_cast<float4*>(s.vo)[q] = vo;
      } else {
        for (long long i = e; i < s.n && i < e + 4; ++i) {
          adam_one(a, s.neg_lr, s.p[i], s.g[i], s.m[i], s.v[i], s.po[i], s.mo[i], s.vo[i]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * kGroups; ++j) {
      const long long i = start + (long long)j * kThreads + threadIdx.x;
      if (i < s.n) {
        adam_one(a, s.neg_lr, s.p[i], s.g[i], s.m[i], s.v[i], s.po[i], s.mo[i], s.vo[i]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int gs_adam_args_size() { return static_cast<int>(sizeof(gs::AdamArgs)); }

extern "C" int gs_adam_block_elems() { return static_cast<int>(kBlockElems); }

// args: the host's AdamArgs with every key's pointers, n, neg_lr and the
// step's scalars set; first_block and vec are filled here. Arrays of one key
// are n f32 on the device; keys of n == 0 take no block.
extern "C" int gs_adam_step(const void* args, void* stream) {
  AdamArgs a = *static_cast<const AdamArgs*>(args);
  if (a.keys < 1 || a.keys > kAdamMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0;
  for (int k = 0; k < kAdamMaxKeys; ++k) {
    a.first_block[k] = blocks;
    if (k >= a.keys) continue;
    a.vec[k] = aligned16(a.p[k]) && aligned16(a.g[k]) &&
               aligned16(a.m[k]) && aligned16(a.v[k]) && aligned16(a.p_out[k]) &&
               aligned16(a.m_out[k]) && aligned16(a.v_out[k]);
    blocks += (a.n[k] + kBlockElems - 1) / kBlockElems;
  }
  a.first_block[kAdamMaxKeys] = blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  adam_step<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
