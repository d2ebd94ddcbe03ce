// One Adam step over every raw tensor of a train step, in one launch
// (multi-tensor apply), for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package's optimizer is optax's adam
//           (openglgaussiansplattingrenderer_tpu/train/trainer.py
//           make_optimizer), which XLA fuses; the port wrote it out as some
//           13 elementwise torch calls a tensor and the addition to the raw
//           tensor (ops/kernels/adam.py adam_update_plain).
// Bound on the card: bytes. An element reads p, g, m and v and writes p',
//           m' and v': 28 B, and a handful of float operations: 0.4231 ms
//           at the flagship's SH 0 keys (50,625,442 floats), 1.7832 ms at
//           SH 3, at 3.35 TB/s.
// Design:   the host plans each key into chunks of kChunk elements that
//           never straddle a key: a key whose four inputs start on the
//           16-byte grid gives its first n - n % 4 elements in chunks (its
//           last chunk short), and its last n % 4 elements, or all n of a
//           key off the grid, go to an element index space after the
//           chunks. A block takes one chunk, a thread kGroups float4s of
//           each array, one group after another: 16-byte loads of p, g, m,
//           v, the arithmetic, 16-byte stores of p', m', v'. The blocks past
//           the chunks take the element index space, a thread an element.
//           Each block asks for shared memory it does not use, so that an
//           SM holds kBlocksPerSm blocks (24 warps) rather than 8. The
//           outputs are one allocation the wrapper makes (every key's p',
//           then m', then v', each key's part 16-byte aligned): the step is
//           functional, the inputs are not written. The host passes
//           everything in one AdamArgs struct, by value: the plan (lengths,
//           the two layouts, paths, output offsets, blocks), which
//           ops/kernels/adam.py caches on the inputs' shapes, alignment and
//           device, and the step's pointers and scalars, which it writes
//           into the cached struct each step.
// Why this form (PERF.md, Adam's redesign; scripts/torch_adam_probe.py
//           keeps the others as variants): launched alone, every form moves
//           2.9-3.0 TB/s, what the card's memory gives four reads and three
//           writes: the same loads and stores without the arithmetic take as
//           long (473.9 against 473.7 us at SH 0), and torch's add, two reads
//           and a write, moves 3.09 TB/s. What differs is how many warps
//           stream at once. At SH 0, alone / inside the train step (the
//           probe's --in-step, one harness for all): this form, 3 blocks an
//           SM, 473.7 / 484.3 us; 2 blocks 472.7 / 535.6; 4 blocks 477.7 /
//           488.5; 8 blocks (no shared memory reserved) 490.0 / 506.2; the
//           earlier kernel (scripts/adam_probe_earlier.cu: blocks of 4,096
//           elements, 6 an SM) 484.7 / 499.6; a persistent grid streaming
//           chunks through a shared-memory ring by TMA bulk copies
//           (scripts/adam_probe_stream.cu) 491.3 / 499.8-511.1; restrict
//           pointers with every load of a thread first and streaming hints
//           (scripts/adam_probe_loads_first.cu) 485.3 / 591.8-595.4, at 160
//           registers one block an SM, whose loads, arithmetic and stores
//           nothing else on the SM overlaps.
// Rounding: every float expression rounds as adam_update_plain's torch calls
//           do on the card (the library is built without multiply-add
//           contraction; sqrt and division are IEEE): a torch tensor divided
//           by a Python float is multiplied by the reciprocal taken in
//           double and rounded to float (inv_c1, inv_c2), each Python scalar
//           is rounded to float, and the update -lr * step is rounded before
//           it is added to p. The step is bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int kAdamMaxKeys = 8;

// ops/kernels/adam.py AdamArgs mirrors the layout; gs_adam_args_size lets
// it check.
struct AdamArgs {
  // the step's: key k's p, g, m, v at inputs[4k .. 4k + 3]; the outputs'
  // one allocation; -lr of each key; the bias corrections' reciprocals
  const float* inputs[4 * kAdamMaxKeys];
  float* out;
  float neg_lr[kAdamMaxKeys];
  float inv_c1, inv_c2;
  // the plan's: key k's elements; its p' at out + out_at[k], m' and v'
  // role_stride and 2 role_stride further; its chunks [first_chunk[k],
  // first_chunk[k + 1]) and its element-path elements [first_elem[k],
  // first_elem[k + 1]) (entries past the last key hold the totals);
  // whether its inputs are on the 16-byte grid; the grid
  long long n[kAdamMaxKeys];
  long long out_at[kAdamMaxKeys];
  long long role_stride;
  long long first_chunk[kAdamMaxKeys + 1];
  long long first_elem[kAdamMaxKeys + 1];
  int vec[kAdamMaxKeys];
  float b1, one_minus_b1, b2, one_minus_b2, eps;
  int keys;
  int blocks;
};

}  // namespace gs

namespace {

using gs::AdamArgs;
using gs::kAdamMaxKeys;

constexpr int kThreads = 256;
constexpr int kGroups = 4;                              // float4s of each array a thread
constexpr int kChunk = kThreads * 4 * kGroups;          // 4,096 elements
// blocks an SM: each block asks for shared memory it does not use, so that
// kBlocksPerSm fit in an SM's 228 KB and one more does not (each block also
// takes 1 KB of its own)
constexpr int kBlocksPerSm = 3;
constexpr int kReserveBytes = 228 / (kBlocksPerSm + 1) * 1024;

// One element: adam_update_plain's expressions in its order.
__device__ __forceinline__ void adam_one(const AdamArgs& a, float neg_lr, float p, float g,
                                         float m, float v, float& po, float& mo, float& vo) {
  mo = a.b1 * m + a.one_minus_b1 * g;
  vo = a.b2 * v + a.one_minus_b2 * (g * g);
  const float step = (mo * a.inv_c1) / (sqrtf(vo * a.inv_c2) + a.eps);
  const float u = neg_lr * step;
  po = p + u;
}

__device__ __forceinline__ void adam_four(const AdamArgs& a, float neg_lr, const float4& p,
                                          const float4& g, const float4& m, const float4& v,
                                          float4& po, float4& mo, float4& vo) {
  adam_one(a, neg_lr, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
  adam_one(a, neg_lr, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
  adam_one(a, neg_lr, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
  adam_one(a, neg_lr, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
}

// A key's arrays and scalars, read out of the parameter struct with
// constant indices (a dynamic index would copy the struct to local memory).
struct Key {
  const float* in[4];
  float* out[3];
  long long n, first_chunk, first_elem, elem_lo;
  float neg_lr;
};

__device__ __forceinline__ Key key_at(const AdamArgs& a, int k) {
  Key s{};
#pragma unroll
  for (int i = 0; i < kAdamMaxKeys; ++i) {
    if (i == k) {
      float* o = a.out + a.out_at[i];
      s = Key{{a.inputs[4 * i], a.inputs[4 * i + 1], a.inputs[4 * i + 2], a.inputs[4 * i + 3]},
              {o, o + a.role_stride, o + 2 * a.role_stride},
              a.n[i], a.first_chunk[i], a.first_elem[i], a.vec[i] ? (a.n[i] & ~3LL) : 0,
              a.neg_lr[i]};
    }
  }
  return s;
}

// The key whose range of `first` holds x (x below the total): the last
// whose first entry is at or before x.
__device__ __forceinline__ int key_of(const long long (&first)[kAdamMaxKeys + 1], long long x) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < kAdamMaxKeys; ++i)
    if (x >= first[i]) k = i;
  return k;
}

__global__ void __launch_bounds__(kThreads) adam_step(const AdamArgs a) {
  const long long chunks = a.first_chunk[kAdamMaxKeys];
  const int t = threadIdx.x;
  if (blockIdx.x < chunks) {
    const Key s = key_at(a, key_of(a.first_chunk, blockIdx.x));
    const long long start = (blockIdx.x - s.first_chunk) * kChunk;
    const long long end = min(start + kChunk, s.n & ~3LL);
    // one group of four elements of each array after another (the arrays
    // may alias as far as the compiler knows)
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const long long e = start + 4 * (j * kThreads + t);
      if (e < end) {
        const long long q = e / 4;
        const float4 p = reinterpret_cast<const float4*>(s.in[0])[q];
        const float4 g = reinterpret_cast<const float4*>(s.in[1])[q];
        const float4 m = reinterpret_cast<const float4*>(s.in[2])[q];
        const float4 v = reinterpret_cast<const float4*>(s.in[3])[q];
        float4 x, y, z;
        adam_four(a, s.neg_lr, p, g, m, v, x, y, z);
        reinterpret_cast<float4*>(s.out[0])[q] = x;
        reinterpret_cast<float4*>(s.out[1])[q] = y;
        reinterpret_cast<float4*>(s.out[2])[q] = z;
      }
    }
  } else {
    // the element path: keys off the 16-byte grid whole, and the last
    // n % 4 elements of the others, a thread an element
    const long long x = (blockIdx.x - chunks) * kThreads + t;
    if (x >= a.first_elem[kAdamMaxKeys]) return;
    const Key s = key_at(a, key_of(a.first_elem, x));
    const long long i = s.elem_lo + (x - s.first_elem);
    adam_one(a, s.neg_lr, s.in[0][i], s.in[1][i], s.in[2][i], s.in[3][i], s.out[0][i],
             s.out[1][i], s.out[2][i]);
  }
}

}  // namespace

extern "C" int gs_adam_args_size() { return static_cast<int>(sizeof(gs::AdamArgs)); }

extern "C" int gs_adam_chunk_elems() { return kChunk; }

extern "C" int gs_adam_threads() { return kThreads; }

// args: the host's AdamArgs, plan and step filled (ops/kernels/adam.py),
// a.blocks = the chunks and the element path's blocks. A step of no
// element launches nothing.
extern "C" int gs_adam_step(const void* args, void* stream) {
  const AdamArgs& a = *static_cast<const AdamArgs*>(args);
  if (a.keys < 1 || a.keys > kAdamMaxKeys || a.blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.blocks == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool sized[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev]) {  // the reserve may pass the 48 KB a block gets unasked
    e = cudaFuncSetAttribute(adam_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kReserveBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  adam_step<<<a.blocks, kThreads, kReserveBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
