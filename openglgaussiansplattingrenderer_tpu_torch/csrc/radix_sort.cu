// A stable least-significant-digit radix sort of u32 keys with 32-bit
// payload rows in the onesweep shape (Adinets and Merrill, "Onesweep: A
// Faster Least Significant Digit Radix Sort for GPUs", 2022), for Hopper
// (sm_90a): one launch counts the digits of every pass over the whole
// array, then one launch a pass scatters, each chunk finding its base per
// digit by decoupled look-back over the chunks before it.
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/radix_sort.py
//           _hist_kernel (digit counts of eight 512-key sub-chunks as one
//           one-hot matrix-unit product, keys held as two f32 halves) and
//           _scatter_kernel (per digit, a lane prefix sum and a one-hot
//           matrix-unit placement into a 128-aligned read-modify-write
//           window of the output, correct only on a sequential grid).
// Bound on the card: bytes. The counts read 4 B a key once for all passes;
//           a scatter reads and writes 4 B a key and 4 B a key for each
//           payload row. The arithmetic is a shift, a mask and a warp vote
//           a key. What the scatter pays beyond its bytes is sectors: a
//           4-byte store to a slot of its own costs a whole 32-byte sector,
//           and with low, well-mixed digits a warp's 32 keys in input order
//           fall into up to 32 different digit ranges.
// Design:   radix_counts: about two blocks an SM stride over the keys, 16
//           bytes a load where the pointer allows (the scalars before the
//           first 16-byte boundary and after the last whole vector go to
//           block 0). Each warp adds every pass's digit of its keys to
//           counts of its own in shared memory (integer shared atomics:
//           8 warps x 4 passes x 256 digits, 32 KB at 8 bits), and the block
//           adds the sums of its warps into the (passes, 2^BITS) table with
//           integer atomics: the same sum in any order, so the counts repeat
//           bit for bit. The table must be zero before the launch. On an
//           H100 the shared atomics, not the bytes, set the time (four adds
//           a key at 8 bits): the variants of scripts/torch_sort_walk.py
//           --variants (a warp-wide test for lanes of one digit, four blocks
//           an SM, more loads in flight) and their times are in PERF.md.
//           radix_scatter: a block owns a chunk of kChunk = 4096 consecutive
//           keys (1,536 chunks at the frame's 6.3M records) and takes its
//           chunk number from a ticket counter, not from blockIdx, so every
//           chunk it waits for has already started and the chain cannot
//           deadlock, whatever order the hardware schedules blocks in. Each of
//           its 8 warps owns 512 consecutive keys of the chunk and walks them
//           32 at a time, so input order is (warp, round, lane). (A) a warp
//           loads its 512 keys (16 bytes a lane, put into (round, lane) order
//           through shared memory, where the pointer allows) and walks them
//           once in input order: lanes with equal digits find each other by
//           one vote a digit bit, a key's rank among the warp's keys of its
//           digit is the warp's count of that digit so far plus the lower
//           lanes of its group, and the group's first lane then moves the
//           count on; (B) thread d adds the eight warps' counts of digit d
//           and publishes them at once as the chunk's descriptor of d (the
//           first chunk publishes them as its prefix), then looks back over
//           the earlier chunks' descriptors of d, four at a time, adding
//           counts until it meets a chunk that knows its prefix, and
//           publishes its own. A descriptor is one 64-bit word, status in
//           the high half and the count in the low half, written and read
//           with single volatile 64-bit accesses, as in scan.cu: status and
//           count cannot be seen torn and no fence is needed. The digit's
//           global base is the exclusive scan over digits of the pass's row
//           of the counts table; base + the chunk's prefix of d less d's
//           first position in the sorted chunk takes a position of digit d
//           to its global slot. (C) every key is written to a shared-memory
//           buffer at its position in the sorted chunk. Then thread t takes
//           entries t, t + 256, ... of the buffer, recomputes the digit, and
//           stores to its global slot: neighbouring threads hold
//           neighbouring keys of one digit and store to neighbouring
//           addresses, so a run of equal digits goes out as whole sectors
//           (16 keys a digit on average at 8 bits, 256 at 4). Payload rows
//           follow through the same positions, one row at a time,
//           alternating between two buffers so that a row costs one block
//           barrier; both kinds of position stay in registers. The chunk
//           stays at 4,096 keys (two 16 KB buffers, 8 KB of counts: 42 KB of
//           static shared memory): on an H100 a variant that stored the
//           sorted chunk to consecutive addresses, the best any chunk length
//           could do for the stores, measured hardly faster. The ragged last
//           chunk is masked in the kernel; nothing is padded. The scatter is
//           held to 80 registers so that three blocks share an SM: the
//           look-back keeps a block waiting, and a third block works
//           meanwhile.
//           A pass's scratch is a ticket word and one descriptor a (chunk,
//           digit). The wrapper keeps one scratch area a stream, holding the
//           counts table and every pass's scratch of a sort, and the counts
//           entry point clears it with one cudaMemsetAsync on the launch's
//           own stream before it counts: one clear a sort. Launches on one
//           stream run in turn, so a clear in stream order can never be seen
//           stale, two streams never share scratch, and a launch replayed
//           from a CUDA graph clears again.
//           The digit width is a template parameter: 4 bits is the TPU
//           package's plan, 8 bits halves the passes and is what the port
//           runs.
//           The record sort stage (ops/kernels/record_sort.py) runs on these
//           kernels: record_counts, one launch, counts every pass's digits
//           of the key's one or two words and the records of each tile, and
//           its last block (a ticket taken after a fence) scans the tile
//           counts into the stage's bounds, so no searchsorted runs; then
//           radix_scatter a pass, where the first pass makes the source
//           index as a payload row of its own (iota: a key's input
//           position), and the last stores no key and writes the inverse of
//           the index it places (inv[source] = slot). A gather of the nine
//           field rows inside the last pass measured ~3x slower on an H100
//           than a separate row gather (record_gather.cu): its reads span
//           the whole (9, C) array where the row gather's span one row,
//           which stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // keys a lane
constexpr int kWarpSpan = 32 * kItems;      // consecutive keys a warp owns
constexpr int kChunk = kWarps * kWarpSpan;  // keys a block owns
constexpr int kCountLoads = 4;              // 16-byte loads in flight a thread
constexpr int kLook = 4;                    // descriptors read back at a time
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;
// a descriptor's status; cleared scratch reads as kEmpty
constexpr uint32_t kEmpty = 0, kSum = 1, kPrefix = 2;

__device__ __forceinline__ u64 descriptor(uint32_t status, uint32_t value) {
  return ((u64)status << 32) | value;
}

template <int BITS>
__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift) {
  return (key >> shift) & ((1u << BITS) - 1u);
}

// keys[0, head) are the scalars before the first 16-byte boundary; then
// `vectors` whole 16-byte groups; then the scalars up to n.
template <int BITS>
__global__ void __launch_bounds__(kThreads)
radix_counts(const uint32_t* __restrict__ keys, int n, int head, int vectors,
             int passes, int32_t* __restrict__ counts) {  // (passes, 2^BITS), zero
  constexpr int K = 1 << BITS;
  constexpr int kMaxPasses = 32 / BITS;
  __shared__ int hist[kWarps][kMaxPasses * K];
  for (int j = threadIdx.x; j < kWarps * kMaxPasses * K; j += kThreads)
    (&hist[0][0])[j] = 0;
  __syncthreads();
  int* mine = hist[threadIdx.x >> 5];
  auto count = [&](uint32_t key) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < passes) atomicAdd(&mine[p * K + digit_of<BITS>(key, p * BITS)], 1);
  };
  const uint4* vec = reinterpret_cast<const uint4*>(keys + head);
  const int stride = gridDim.x * kThreads;
  int v = blockIdx.x * kThreads + threadIdx.x;
  for (; v + (kCountLoads - 1) * stride < vectors; v += kCountLoads * stride) {
    uint4 q[kCountLoads];
#pragma unroll
    for (int j = 0; j < kCountLoads; ++j) q[j] = __ldg(vec + v + j * stride);
#pragma unroll
    for (int j = 0; j < kCountLoads; ++j) {
      count(q[j].x); count(q[j].y); count(q[j].z); count(q[j].w);
    }
  }
  for (; v < vectors; v += stride) {
    const uint4 q = __ldg(vec + v);
    count(q.x); count(q.y); count(q.z); count(q.w);
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) count(keys[threadIdx.x]);
    const int tail = head + 4 * vectors + threadIdx.x;
    if (threadIdx.x < 4 && tail < n) count(keys[tail]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < passes * K; j += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist[w][j];
    if (s) atomicAdd(&counts[j], s);
  }
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
// ints of shared memory that no other scan is reading.
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

// The count of digit d in every chunk before `chunk`, by one thread: kLook
// descriptors read at once, nearest first; a chunk that has published
// nothing yet is read again, and the nearest chunk that knows its prefix
// ends the walk, since the farther ones are inside that prefix.
template <int K>
__device__ uint32_t look_back(const volatile u64* desc, int chunk, int d) {
  uint32_t excl = 0;
  int c = chunk - 1;  // the nearest chunk not summed yet
  for (;;) {
    u64 w[kLook];
#pragma unroll
    for (int j = 0; j < kLook; ++j)  // before the first chunk everything is a known 0
      w[j] = c - j >= 0 ? desc[(long long)(c - j) * K + d] : descriptor(kPrefix, 0u);
#pragma unroll
    for (int j = 0; j < kLook; ++j) {
      const uint32_t status = (uint32_t)(w[j] >> 32);
      if (status == kEmpty) break;
      excl += (uint32_t)w[j];
      if (status == kPrefix) return excl;
      --c;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, 3)
radix_scatter(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ vals,
              int nv, int iota, int n, int shift,
              const int32_t* __restrict__ counts,  // (2^BITS,) this pass's digits
              u64* state,  // ticket word, then (n_chunks, 2^BITS) descriptors; zero
              uint32_t* __restrict__ out_keys,  // null: the keys are not stored
              uint32_t* __restrict__ out_vals, int wide,
              int32_t* __restrict__ inv_out) {  // (n,) or null
  constexpr int K = 1 << BITS;
  static_assert(K <= kThreads, "phase B gives a digit to a thread");
  __shared__ __align__(16) uint32_t stage[2][kChunk];
  __shared__ int base[kWarps][K];
  __shared__ int to_global[K];
  __shared__ int warp_sums[2][kWarps];
  __shared__ int s_chunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_chunk = (int)atomicAdd((unsigned int*)state, 1u);
  for (int j = threadIdx.x; j < kWarps * K; j += kThreads) (&base[0][0])[j] = 0;
  __syncthreads();
  const int chunk = s_chunk;
  // the pass's count of digit threadIdx.x, read now to be at hand in phase B
  const int count_d = threadIdx.x < K ? counts[threadIdx.x] : 0;

  const long long chunk0 = (long long)chunk * kChunk;
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

  // (B) publish the chunk's counts, scan them and the pass's, look back for
  // the chunk's prefix: each warp's first position of each digit in the
  // sorted chunk, and what takes a position of digit d to its global slot
  {
    const int d = threadIdx.x;
    volatile u64* desc = state + 1;
    int total = 0;
    if (d < K) {
      for (int w = 0; w < kWarps; ++w) total += base[w][d];
      desc[(long long)chunk * K + d] = descriptor(chunk == 0 ? kPrefix : kSum, total);
    }
    const int global_base = block_excl_scan(count_d, warp_sums[0]);
    int run = block_excl_scan(total, warp_sums[1]);
    if (d < K) {
      uint32_t before = 0;  // digit-d keys in the chunks before this one
      if (chunk > 0) {
        before = look_back<K>(desc, chunk, d);
        desc[(long long)chunk * K + d] = descriptor(kPrefix, before + total);
      }
      to_global[d] = global_base + (int)before - run;
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
      if (out_keys) out_keys[dst[i]] = k;
    }
  }
  // a row is written to the buffer the row before it is not being read from;
  // the iota row is each key's input position
  const int rows = nv + iota;
  for (int r = 0; r < rows; ++r) {
    uint32_t* buf = stage[(r + 1) & 1];
    uint32_t* out = out_vals + (size_t)r * n;
    if (r < nv) {
      const uint32_t* src = vals + (size_t)r * n + chunk0 + mine;
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (mine + i * 32 < live_n) buf[pos[i]] = src[i * 32];
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (mine + i * 32 < live_n) buf[pos[i]] = (uint32_t)(chunk0 + mine + i * 32);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < live_n) out[dst[i]] = buf[p];
    }
  }
  // the last row is the source index: inv_out[source] = slot
  if (inv_out != nullptr) {
    const uint32_t* src_of = stage[rows & 1];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < live_n) inv_out[src_of[p]] = dst[i];
    }
  }
}

// The record sort's count, 8-bit digits: lo_passes digit passes of the
// words lo and hi_passes of the words hi (null where hi_passes is 0), and
// the records of each tile, tile = hi, or lo >> tile_shift where hi is null,
// into `bins` counts (a tile at or past bins is counted in none). Each warp
// counts digits in shared memory of its own and the block counts tiles in
// one shared table, as radix_counts does; the block then adds its sums into
// the tables in device memory. The last block to finish (a ticket taken
// after a fence) turns the tile counts into bounds[k] = the records whose
// tile is below k, k < bins: a block-wide exclusive scan, each thread a
// run of consecutive bins.
__global__ void __launch_bounds__(kThreads)
record_counts(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi, int n,
              int wide, int lo_passes, int hi_passes, int tile_shift, int bins,
              int32_t* counts,        // (lo_passes + hi_passes, 256), zero
              int32_t* hist,          // (bins,), zero
              unsigned int* done,     // zero
              int32_t* __restrict__ bounds) {  // (bins,)
  constexpr int K = 256;
  constexpr int kMaxPasses = 4;  // of a 32-bit word
  extern __shared__ int smem[];  // kWarps x span digit counts, then bins tile counts
  const int span = (lo_passes + hi_passes) * K;
  for (int j = threadIdx.x; j < kWarps * span + bins; j += kThreads) smem[j] = 0;
  __syncthreads();
  int* mine = smem + (threadIdx.x >> 5) * span;
  int* tiles = smem + kWarps * span;
  auto count = [&](uint32_t l, uint32_t h) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < lo_passes) atomicAdd(&mine[p * K + digit_of<8>(l, p * 8)], 1);
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < hi_passes) atomicAdd(&mine[(lo_passes + p) * K + digit_of<8>(h, p * 8)], 1);
    const uint32_t t = hi != nullptr ? h : l >> tile_shift;
    if (t < (uint32_t)bins) atomicAdd(&tiles[t], 1);
  };
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  if (wide) {  // 16 bytes a load of each word (n % 4 == 0, both aligned)
    const uint4* lo4 = reinterpret_cast<const uint4*>(lo);
    const uint4* hi4 = reinterpret_cast<const uint4*>(hi);
    for (int v = first; v < n / 4; v += stride) {
      const uint4 a = __ldg(lo4 + v);
      const uint4 b = hi != nullptr ? __ldg(hi4 + v) : make_uint4(0u, 0u, 0u, 0u);
      count(a.x, b.x); count(a.y, b.y); count(a.z, b.z); count(a.w, b.w);
    }
  } else {
    for (int i = first; i < n; i += stride)
      count(__ldg(lo + i), hi != nullptr ? __ldg(hi + i) : 0u);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[w * span + j];
    if (s) atomicAdd(&counts[j], s);
  }
  for (int j = threadIdx.x; j < bins; j += kThreads)
    if (tiles[j]) atomicAdd(&hist[j], tiles[j]);
  // every block's sums are in device memory before its ticket
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  __shared__ int warp_sums[kWarps];
  const int per = (bins + kThreads - 1) / kThreads;
  const int b0 = min(bins, (int)threadIdx.x * per), b1 = min(bins, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += __ldcg(hist + b);  // L2: other blocks' adds
  int run = block_excl_scan(sum, warp_sums);
  for (int b = b0; b < b1; ++b) {
    bounds[b] = run;
    run += __ldcg(hist + b);
  }
}

int chunks_of(int n) { return (n + kChunk - 1) / kChunk; }

bool digit_ok(int shift, int bits) {
  return (bits == 4 || bits == 8) && shift >= 0 && shift + bits <= 32;
}

}  // namespace

extern "C" int gs_radix_chunk() { return kChunk; }

// keys: n u32 on the device, 4-byte aligned; counts: (passes, 2^bits) int32,
// bits 4 or 8, 1 <= passes <= 32 / bits: row p the counts of digit
// (key >> p * bits) & (2^bits - 1). The kernel adds into counts, so `clear`
// (clear_bytes of zeros, set on the stream before the launch) must cover
// it. One clear, one launch. Returns the first CUDA error.
extern "C" int gs_radix_counts(const void* keys, int n, int passes, int bits,
                               void* counts, void* clear, long long clear_bytes,
                               void* stream) {
  if (!digit_ok(0, bits) || passes < 1 || passes * bits > 32 || n < 0 || clear_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear_bytes > 0) {
    const cudaError_t e = cudaMemsetAsync(clear, 0, (size_t)clear_bytes, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0) return 0;
  const int off = (int)(reinterpret_cast<uintptr_t>(keys) & 15u);
  const int head = off ? std::min(n, (16 - off) / 4) : 0;
  const int vectors = (n - head) / 4;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = std::max(1, std::min(2 * sms, (vectors + kThreads - 1) / kThreads));
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  int32_t* c = static_cast<int32_t*>(counts);
  if (bits == 8) {
    radix_counts<8><<<grid, kThreads, 0, s>>>(k, n, head, vectors, passes, c);
  } else {
    radix_counts<4><<<grid, kThreads, 0, s>>>(k, n, head, vectors, passes, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, out_keys: n u32; vals, out_vals: (nv, n) 32-bit words, nv >= 0;
// counts: (2^bits,) int32, the counts of digit (key >> shift) & (2^bits - 1)
// over all n keys (gs_radix_counts' row of the pass); state: 1 +
// ceil(n / gs_radix_chunk()) * 2^bits 64-bit words that no other stream
// uses, zero at the launch: clear_bytes > 0 clears that many on the stream
// first. Inputs and outputs must not overlap. Returns the first CUDA error.
extern "C" int gs_radix_scatter(const void* keys, const void* vals, int nv, int n,
                                int shift, int bits, const void* counts, void* state,
                                long long clear_bytes, void* out_keys, void* out_vals,
                                void* stream) {
  if (!digit_ok(shift, bits) || nv < 0 || n < 0 || clear_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear_bytes > 0) {
    const cudaError_t e = cudaMemsetAsync(state, 0, (size_t)clear_bytes, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0) return 0;
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  const int32_t* c = static_cast<const int32_t*>(counts);
  u64* st = static_cast<u64*>(state);
  uint32_t* ok = static_cast<uint32_t*>(out_keys);
  uint32_t* ov = static_cast<uint32_t*>(out_vals);
  const int wide = (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;  // 16-byte loads
  if (bits == 8) {
    radix_scatter<8><<<chunks_of(n), kThreads, 0, s>>>(k, v, nv, 0, n, shift, c, st, ok, ov,
                                                       wide, nullptr);
  } else {
    radix_scatter<4><<<chunks_of(n), kThreads, 0, s>>>(k, v, nv, 0, n, shift, c, st, ok, ov,
                                                       wide, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// The record sort's passes (8-bit digits): gs_radix_scatter's pass, and
// besides: iota = 1 appends a payload row that is each key's input
// position (out_vals then has nv + 1 rows); out_keys may be null (the last
// pass stores no keys); inv_out, when not null, gets inv_out[source] =
// slot, the last payload row read as the source index. state must be
// cleared before the launch (gs_record_counts clears every pass's state).
// Returns the first CUDA error.
extern "C" int gs_record_scatter(const void* keys, const void* vals, int nv, int iota, int n,
                                 int shift, const void* counts, void* state, void* out_keys,
                                 void* out_vals, void* inv_out, void* stream) {
  if (!digit_ok(shift, 8) || nv < 0 || (iota != 0 && iota != 1) || n < 0 ||
      (inv_out != nullptr && nv + iota < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int wide = (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;
  radix_scatter<8><<<chunks_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(vals), nv, iota, n,
      shift, static_cast<const int32_t*>(counts), static_cast<u64*>(state),
      static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_vals), wide,
      static_cast<int32_t*>(inv_out));
  return static_cast<int>(cudaGetLastError());
}

// The record sort's count (see record_counts): lo, hi: n u32 words (hi
// null where hi_passes is 0), 1 <= lo_passes <= 4, 0 <= hi_passes <= 4;
// counts: (lo_passes + hi_passes, 256) int32, row p the counts of the
// digit p of lo, then those of hi; hist: `bins` int32; done: one u32; all
// three must be zero at the launch: `clear` (clear_bytes of zeros, set on
// the stream first) must cover them. bounds: `bins` int32, written.
// n >= 1. One clear, one launch. Returns the first CUDA error.
extern "C" int gs_record_counts(const void* lo, const void* hi, int n, int lo_passes,
                                int hi_passes, int tile_shift, int bins, void* counts,
                                void* hist, void* done, void* bounds, void* clear,
                                long long clear_bytes, void* stream) {
  if (n < 1 || lo_passes < 1 || lo_passes > 4 || hi_passes < 0 || hi_passes > 4 ||
      (hi == nullptr) != (hi_passes == 0) || tile_shift < 0 || tile_shift > 31 ||
      bins < 1 || clear_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * ((size_t)kWarps * (lo_passes + hi_passes) * 256 + bins);
  int device = 0, sms = 0, most = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > (size_t)most) return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_set[64] = {};  // the largest size allowed so far, a device
  if (smem > 48 * 1024 && (device >= 64 || smem > smem_set[device])) {
    e = cudaFuncSetAttribute(record_counts, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) smem_set[device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear_bytes > 0) {
    e = cudaMemsetAsync(clear, 0, (size_t)clear_bytes, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(lo) & 15u) == 0 &&
                       (reinterpret_cast<uintptr_t>(hi) & 15u) == 0;
  const int wide = aligned && n % 4 == 0;
  const int groups = wide ? n / 4 : n;
  const int grid = std::max(1, std::min(2 * sms, (groups + kThreads - 1) / kThreads));
  record_counts<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), n, wide, lo_passes,
      hi_passes, tile_shift, bins, static_cast<int32_t*>(counts), static_cast<int32_t*>(hist),
      static_cast<unsigned int*>(done), static_cast<int32_t*>(bounds));
  return static_cast<int>(cudaGetLastError());
}
