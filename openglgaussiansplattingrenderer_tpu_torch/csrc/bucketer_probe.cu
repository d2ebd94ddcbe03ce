// One level of a K-bucket distribution of 16-row records: bucket, stable
// in-bucket rank, compaction, flush -- the probe of what a bucketing sort
// level costs at least, for Hopper (sm_90a).
//
// Replaces: scripts/bucketer_probe.py kernel (per 512-record chunk and per
//           bucket: a lane prefix sum for the rank, a one-hot matrix-unit
//           product for the compaction, and a copy of the bucket's first
//           128 staged records to one fixed region of the output, which
//           every chunk overwrites: on a sequential grid the last chunk
//           wins).
// Bound on the card: bytes. 64 B a record read, and 16 x 128 x 4 B a
//           bucket a chunk written whatever the bucket holds.
// Design:   blocks run in any order, so each chunk flushes to a slab of
//           its own, (n_chunks, 16, K * 128): the bytes written are those
//           of the TPU kernel and the result can be checked; the TPU
//           kernel's output is the last chunk's slab. One thread a record.
//           The bucket is floor(tile * K / 512), tile being row 9. Lanes
//           with the same bucket find each other with __match_any_sync:
//           the rank inside the warp is the number of lower such lanes,
//           the group's first lane writes the group's size to the warp's
//           row in shared memory, one thread a bucket turns the rows into
//           exclusive bases in warp order, and rank = base + rank inside
//           the warp is the record's input-order rank in its bucket.
//           Records ranked below 128 are stored, all 16 rows, as raw bits;
//           the block then zeroes every slot at or past its bucket's
//           count. No atomics: the result is the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 512;        // records a chunk, one thread each
constexpr int kWarps = kR / 32;
constexpr int kRows = 16;      // field rows a record
constexpr int kTileRow = 9;    // the row that holds the tile id
constexpr int kCarry = 128;    // slots flushed a bucket
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kR)
bucketer_level(const float* __restrict__ rec, long long c,  // (16, c)
               int k, float scale,
               float* __restrict__ out) {  // (n_chunks, 16, k * 128)
  __shared__ int cnt[kWarps][kMaxK];
  __shared__ int total[kMaxK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * kMaxK; j += kR) (&cnt[0][0])[j] = 0;
  __syncthreads();

  const long long col = (long long)blockIdx.x * kR + threadIdx.x;
  const float b_f = floorf(rec[(size_t)kTileRow * c + col] * scale);
  // a tile outside [0, 512) has no bucket and is dropped
  const bool live = b_f >= 0.0f && b_f < (float)k;
  const int b = live ? (int)b_f : k;
  const unsigned peers = __match_any_sync(kFull, b);
  const int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (live && lane == __ffs(peers) - 1) cnt[warp][b] = __popc(peers);
  __syncthreads();
  if (threadIdx.x < k) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = cnt[w][threadIdx.x];
      cnt[w][threadIdx.x] = run;
      run += n;
    }
    total[threadIdx.x] = run;
  }
  __syncthreads();

  const size_t width = (size_t)k * kCarry;
  float* slab = out + (size_t)blockIdx.x * kRows * width;
  if (live) {
    const int rank = cnt[warp][b] + in_warp;
    if (rank < kCarry) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        slab[r * width + (size_t)b * kCarry + rank] = rec[(size_t)r * c + col];
    }
  }
  for (size_t j = threadIdx.x; j < kRows * width; j += kR) {
    const int slot = (int)(j % kCarry);
    const int bucket = (int)((j % width) / kCarry);
    if (slot >= total[bucket]) slab[j] = 0.0f;
  }
}

}  // namespace

extern "C" int gs_bucketer_chunk() { return kR; }

// rec: (16, c) f32, row 9 the tile id in [0, 512); out: (c / 512, 16,
// k * 128) f32, 1 <= k <= 64; scale = k / 512 as a float. Columns past the
// last whole chunk are not read.
extern "C" int gs_bucketer_level(const void* rec, long long c, int k, float scale,
                                 void* out, void* stream) {
  const long long n_chunks = c / kR;
  if (n_chunks <= 0) return 0;
  if (k < 1 || k > kMaxK || n_chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bucketer_level<<<(unsigned)n_chunks, kR, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), c, k, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
