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
//           The arithmetic is a shift, a mask and a warp vote a key. What
//           the scatter pays beyond its bytes is sectors: a 4-byte store to
//           a slot of its own costs a whole 32-byte sector, and with low,
//           well-mixed digits a warp's 32 keys in input order fall into up
//           to 32 different digit ranges.
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
//           order gives the same sum). Scatter: the chunk is sorted by
//           digit inside the block first and stored afterwards. (A) a warp
//           loads its 512 keys (16 bytes a lane, put into (round, lane)
//           order through shared memory, where the pointer allows) and
//           walks them once in input order: lanes with equal digits find
//           each other by one vote a digit bit, a key's rank among the
//           warp's keys of its digit is the warp's count of that digit so
//           far plus the lower lanes of its group, and the group's first
//           lane then moves the count on; (B) one thread a digit adds
//           the eight warps' counts, a block scan over the digits gives
//           each digit's first position in the sorted chunk, and the counts
//           become each warp's first position for the digit; the chunk's
//           global offset of the digit less that first position is kept a
//           digit; (C) every key is written to a shared-memory buffer at
//           its position in the sorted chunk. Then thread t takes entries
//           t, t + 256, ... of the buffer, recomputes the digit, and
//           stores to position + (offset - first position): neighbouring
//           threads hold neighbouring keys of one digit and store to
//           neighbouring addresses, so a run of equal digits goes out as
//           whole sectors (16 keys a digit on average at 8 bits, 256 at 4).
//           Payload rows follow through the same positions, one row at a
//           time, alternating between two buffers so that a row costs one
//           block barrier; both kinds of position stay in registers. The
//           chunk stays at 4,096 keys (two 16 KB buffers, 8 KB of counts: 42
//           KB of static shared memory): on an H100 a variant that stored
//           the sorted chunk to consecutive addresses, the best any chunk
//           length could do for the stores, measured hardly faster, so the
//           longer runs of a longer chunk have little left to give. The
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

// The live lanes of the warp whose digit equals this lane's: a vote a bit,
// a fixed BITS votes a key. (__match_any_sync gives the same mask, but its
// time grows with the distinct values in the warp: on mixed 8-bit digits,
// where nearly every lane holds another value, the votes measured faster.)
// A lane that is not live gets a mask it must not use.
template <int BITS>
__device__ __forceinline__ unsigned same_digit(unsigned d, bool live) {
  unsigned peers = __ballot_sync(kFull, live);
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned has = __ballot_sync(kFull, bit);
    peers &= bit ? has : ~has;
  }
  return peers;
}

// Exclusive scan of one value a thread over the block. warp_sums is kWarps
// ints of shared memory.
__device__ int block_excl_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) before += warp_sums[w];
  return before + incl - v;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ vals,
              int nv, int n, int shift,
              const int32_t* __restrict__ offs,  // (n_chunks + 1, 2^BITS)
              uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_vals,
              int wide) {
  constexpr int K = 1 << BITS;
  static_assert(K <= kThreads, "phase B gives a digit to a thread");
  __shared__ __align__(16) uint32_t stage[2][kChunk];
  __shared__ int base[kWarps][K];
  __shared__ int to_global[K];
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * K; j += kThreads) (&base[0][0])[j] = 0;

  const long long chunk0 = (long long)blockIdx.x * kChunk;
  const int live_n = (int)min((long long)kChunk, n - chunk0);  // keys of this chunk
  const int mine = warp * kWarpSpan + lane;  // my round-0 key, inside the chunk
  uint32_t key[kItems];
  if (wide && live_n == kChunk) {
    // 16 bytes a lane, then through the warp's own stretch of the buffer into
    // (round, lane) order
    const int4* src = reinterpret_cast<const int4*>(keys + chunk0 + warp * kWarpSpan);
    int4* mid = reinterpret_cast<int4*>(&stage[0][warp * kWarpSpan]);
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) mid[j * 32 + lane] = src[j * 32 + lane];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kItems; ++i) key[i] = stage[0][mine + i * 32];
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      key[i] = mine + i * 32 < live_n ? keys[chunk0 + mine + i * 32] : 0u;
  }
  __syncthreads();

  // (A) rank among this warp's keys of the same digit, in input order
  int pos[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool live = mine + i * 32 < live_n;
    const unsigned d = digit_of<BITS>(key[i], shift);
    const unsigned peers = same_digit<BITS>(d, live);
    const int lower = __popc(peers & ((1u << lane) - 1u));
    const int seen = live ? base[warp][d] : 0;  // the warp's count so far
    __syncwarp();  // every lane has read the count before it moves
    // one lane a digit writes, and no other warp touches this row
    if (live && lower == 0) base[warp][d] = seen + __popc(peers);
    __syncwarp();
    pos[i] = seen + lower;
  }
  __syncthreads();

  // (B) counts -> each warp's first position of each digit in the sorted
  // chunk, and what takes a position of digit d to its global slot
  {
    const int d = threadIdx.x;
    int total = 0;
    if (d < K)
      for (int w = 0; w < kWarps; ++w) total += base[w][d];
    int run = block_excl_scan(total, warp_sums);
    if (d < K) {
      to_global[d] = offs[(long long)blockIdx.x * K + d] - run;
      for (int w = 0; w < kWarps; ++w) {
        const int c = base[w][d];
        base[w][d] = run;
        run += c;
      }
    }
  }
  __syncthreads();

  // (C) sort the chunk by digit in shared memory, then store it in that order
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (mine + i * 32 < live_n) {
      pos[i] += base[warp][digit_of<BITS>(key[i], shift)];
      stage[0][pos[i]] = key[i];
    }
  }
  __syncthreads();
  int dst[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < live_n) {
      const uint32_t k = stage[0][p];
      dst[i] = p + to_global[digit_of<BITS>(k, shift)];
      out_keys[dst[i]] = k;
    }
  }
  // a row is written to the buffer the row before it is not being read from
  for (int r = 0; r < nv; ++r) {
    uint32_t* buf = stage[(r + 1) & 1];
    const uint32_t* src = vals + (size_t)r * n + chunk0 + mine;
    uint32_t* out = out_vals + (size_t)r * n;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (mine + i * 32 < live_n) buf[pos[i]] = src[i * 32];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < live_n) out[dst[i]] = buf[p];
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
  const int wide = (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;  // 16-byte loads
  if (bits == 8) {
    radix_scatter<8><<<chunks_of(n), kThreads, 0, s>>>(k, v, nv, n, shift, o, ok, ov, wide);
  } else if (bits == 4) {
    radix_scatter<4><<<chunks_of(n), kThreads, 0, s>>>(k, v, nv, n, shift, o, ok, ov, wide);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
