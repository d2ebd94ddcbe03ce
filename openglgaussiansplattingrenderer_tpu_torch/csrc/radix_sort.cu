// One pass of a stable least-significant-digit radix sort of u32 keys with
// 32-bit payload rows: per-chunk digit histogram and stable scatter, for
// Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/radix_sort.py
//           _hist_kernel (digit counts of eight 512-key sub-chunks as one
//           one-hot matrix-unit product, keys held as two f32 halves) and
//           _scatter_kernel (per digit, a lane prefix sum and a one-hot
//           matrix-unit placement into a 128-aligned read-modify-write
//           window of the output, correct only on a sequential grid).
// Bound on the card: bytes. The histogram reads 4 B a key; the scatter
//           reads and writes 4 B a key and 4 B a key for each payload row.
//           The arithmetic is a shift, a mask and a warp vote a key.
// Design:   blocks run in any order, so all order comes from the offsets
//           table (phase 2, outside these kernels) and from a rank computed
//           inside the block; nothing is accumulated in global memory, so
//           the result is the same from run to run. A block owns a chunk
//           of kChunk = 4096 consecutive keys: at the frame's 6.3M records
//           that is 1,536 blocks (a dozen an SM) and a 393,216-entry offset
//           table at 8 bits, where the TPU's 512-key chunk would make it
//           3.1M entries and the prefix sum as long as the keys. Each of
//           the block's 8 warps owns 512 consecutive keys of the chunk and
//           walks them 32 at a time, so input order is (warp, round, lane).
//           Histogram: lanes with equal digits find each other with
//           __match_any_sync; the first of them adds the group's size to
//           the block's shared counts (integer adds in shared memory: any
//           order gives the same sum). Scatter: (A) each warp counts its
//           own 512 keys into its own row of shared memory, (B) one thread
//           a digit turns the rows into running bases, in warp order,
//           starting from the chunk's global offset of that digit, (C) each
//           warp walks its keys again: a key's slot is its warp's base for
//           the digit plus the number of lower lanes with the same digit,
//           and the group's first lane then moves the base on. Keys and
//           payload rows are stored at that slot as raw 32-bit words. The
//           ragged last chunk is masked in the kernel; nothing is padded.
//           The digit width is a template parameter: 4 bits is the TPU
//           package's plan, 8 bits halves the passes and is what the port
//           runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // keys a lane
constexpr int kWarpSpan = 32 * kItems;      // consecutive keys a warp owns
constexpr int kChunk = kWarps * kWarpSpan;  // keys a block owns
constexpr unsigned kFull = 0xffffffffu;

template <int BITS>
__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift) {
  return (key >> shift) & ((1u << BITS) - 1u);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
radix_hist(const uint32_t* __restrict__ keys, int n, int shift,
           int32_t* __restrict__ counts) {  // (n_chunks, 2^BITS)
  constexpr int K = 1 << BITS;
  __shared__ int hist[K];
  for (int d = threadIdx.x; d < K; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + (long long)i * kThreads;  // coalesced
    const bool live = idx < n;
    // K is no digit: the lanes past n group among themselves and add nothing
    const unsigned d = live ? digit_of<BITS>(keys[idx], shift) : (unsigned)K;
    const unsigned peers = __match_any_sync(kFull, d);
    if (live && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < K; d += kThreads)
    counts[(long long)blockIdx.x * K + d] = hist[d];
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ vals,
              int nv, int n, int shift,
              const int32_t* __restrict__ offs,  // (n_chunks + 1, 2^BITS)
              uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_vals) {
  constexpr int K = 1 << BITS;
  __shared__ int base[kWarps][K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * K; j += kThreads) (&base[0][0])[j] = 0;
  __syncthreads();

  const long long first = (long long)blockIdx.x * kChunk + warp * kWarpSpan + lane;
  uint32_t key[kItems];
  // (A) this warp's digit counts
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = first + i * 32;
    const bool live = idx < n;
    key[i] = live ? keys[idx] : 0u;
    const unsigned d = live ? digit_of<BITS>(key[i], shift) : (unsigned)K;
    const unsigned peers = __match_any_sync(kFull, d);
    // one lane a digit writes, and no other warp touches this row
    if (live && lane == __ffs(peers) - 1) base[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // (B) counts -> where each warp's first key of each digit goes
  for (int d = threadIdx.x; d < K; d += kThreads) {
    int run = offs[(long long)blockIdx.x * K + d];
    for (int w = 0; w < kWarps; ++w) {
      const int c = base[w][d];
      base[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  // (C) place
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = first + i * 32;
    const bool live = idx < n;
    const unsigned d = live ? digit_of<BITS>(key[i], shift) : (unsigned)K;
    const unsigned peers = __match_any_sync(kFull, d);
    int pos = 0;
    if (live) pos = base[warp][d] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();  // every lane has read its base before it moves
    if (live && lane == __ffs(peers) - 1) base[warp][d] += __popc(peers);
    __syncwarp();
    if (live) {
      out_keys[pos] = key[i];
      for (int r = 0; r < nv; ++r)
        out_vals[(size_t)r * n + pos] = vals[(size_t)r * n + idx];
    }
  }
}

int chunks_of(int n) { return (n + kChunk - 1) / kChunk; }

}  // namespace

extern "C" int gs_radix_chunk() { return kChunk; }

// keys: n u32 on the device; counts: (ceil(n / gs_radix_chunk()), 2^bits)
// int32, bits 4 or 8. Returns cudaGetLastError() after the launch.
extern "C" int gs_radix_hist(const void* keys, int n, int shift, int bits, void* counts,
                             void* stream) {
  if (n <= 0) return 0;
  if (shift < 0 || shift + bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  int32_t* c = static_cast<int32_t*>(counts);
  if (bits == 8) {
    radix_hist<8><<<chunks_of(n), kThreads, 0, s>>>(k, n, shift, c);
  } else if (bits == 4) {
    radix_hist<4><<<chunks_of(n), kThreads, 0, s>>>(k, n, shift, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, out_keys: n u32; vals, out_vals: (nv, n) 32-bit words, nv >= 0;
// offs: (ceil(n / gs_radix_chunk()) + 1, 2^bits) int32, row c column d the
// slot of chunk c's first key with digit d. Inputs and outputs must not
// overlap.
extern "C" int gs_radix_scatter(const void* keys, const void* vals, int nv, int n,
                                int shift, int bits, const void* offs, void* out_keys,
                                void* out_vals, void* stream) {
  if (n <= 0) return 0;
  if (shift < 0 || shift + bits > 32 || nv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  const int32_t* o = static_cast<const int32_t*>(offs);
  uint32_t* ok = static_cast<uint32_t*>(out_keys);
  uint32_t* ov = static_cast<uint32_t*>(out_vals);
  if (bits == 8) {
    radix_scatter<8><<<chunks_of(n), kThreads, 0, s>>>(k, v, nv, n, shift, o, ok, ov);
  } else if (bits == 4) {
    radix_scatter<4><<<chunks_of(n), kThreads, 0, s>>>(k, v, nv, n, shift, o, ok, ov);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
