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
//           bucket a chunk written whatever the bucket holds: 3.2 GB at the
//           probe's 6.3M records and K = 32, 89% of it zeros.
// Design:   blocks run in any order, so each chunk flushes to a slab of
//           its own, (n_chunks, 16, K * 128): the bytes written are those
//           of the TPU kernel and the result can be checked; the TPU
//           kernel's output is the last chunk's slab. A block owns a chunk,
//           one thread a record. (1) The chunk's 16 rows arrive in shared
//           memory by cp.async, 16 bytes a copy where the row's address
//           allows and 4 otherwise, all in flight before the first wait.
//           (2) The bucket is floor(tile * K / 512), tile being row 9. Lanes
//           with the same bucket find each other by one vote a bucket bit
//           (at most 6): the rank inside the warp is the number of lower
//           such lanes, the group's first lane writes the group's size to
//           the warp's row in shared memory, one thread a bucket turns the
//           rows into exclusive bases in warp order, and rank = base + rank
//           inside the warp is the record's input-order rank in its bucket.
//           No atomics: the result is the same from run to run. (3) The
//           chunk's slab is contiguous, 16 * K (row, bucket) pairs of 128
//           slots, and is built in shared memory a piece of 32 pairs (16
//           KB) at a time: the block zeroes the piece with 16-byte stores,
//           each record ranked below 128 places its rows that fall in the
//           piece (raw bits), and one thread writes the piece out whole with
//           one bulk copy (cp.async.bulk, shared to global). Two pieces
//           alternate, so a piece is built while the one before it is being
//           stored; a piece is rebuilt only after the bulk copy of two
//           pieces back has read it. Every slot of the output is written
//           once, by a bulk copy, and nothing is divided at run time but by
//           constants.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 512;        // records a chunk, one thread each
constexpr int kWarps = kR / 32;
constexpr int kRows = 16;      // field rows a record
constexpr int kTileRow = 9;    // the row that holds the tile id
constexpr int kCarry = 128;    // slots flushed a bucket
constexpr int kMaxK = 64;
constexpr int kPiecePairs = 32;                    // (row, bucket) pairs a piece
constexpr int kPieceWords = kPiecePairs * kCarry;  // 16 KB
constexpr int kSmemBytes = 4 * (kRows * kR + 2 * kPieceWords);  // rows + two pieces
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// generic-proxy writes to shared memory, seen by the bulk copy's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* global, const void* shared, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(global), "r"(smem_addr(shared)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk copies but the newest N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_read_done() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_all_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kR)
bucketer_level(const float* __restrict__ rec, long long c,  // (16, c)
               int k, int bucket_bits, float scale,
               float* __restrict__ out) {  // (n_chunks, 16, k * 128)
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rows = smem;                  // [kRows][kR]: the chunk's records
  uint32_t* pieces = smem + kRows * kR;   // [2][kPieceWords]
  __shared__ int cnt[kWarps][kMaxK];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // (1) the chunk's rows, all copies in flight before the first wait
  const long long col0 = (long long)blockIdx.x * kR;
  for (int j = t; j < kRows * (kR / 4); j += kR) {
    const int r = j / (kR / 4), q = j % (kR / 4);
    const float* src = rec + (long long)r * c + col0 + 4 * q;
    uint32_t* dst = rows + r * kR + 4 * q;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
      __pipeline_memcpy_async(dst, src, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) __pipeline_memcpy_async(dst + e, src + e, 4);
    }
  }
  for (int j = t; j < kWarps * kMaxK; j += kR) (&cnt[0][0])[j] = 0;
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // (2) bucket and stable rank in the bucket
  const float b_f = floorf(__uint_as_float(rows[kTileRow * kR + t]) * scale);
  // a tile outside [0, 512) has no bucket and is dropped
  const bool live = b_f >= 0.0f && b_f < (float)k;
  const int b = live ? (int)b_f : 0;
  unsigned peers = __ballot_sync(kFull, live);
  for (int i = 0; i < bucket_bits; ++i) {
    const bool bit = (b >> i) & 1;
    const unsigned has = __ballot_sync(kFull, bit);
    peers &= bit ? has : ~has;
  }
  const int lower = __popc(peers & ((1u << lane) - 1u));
  if (live && lower == 0) cnt[warp][b] = __popc(peers);
  __syncthreads();
  if (t < k) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = cnt[w][t];
      cnt[w][t] = run;
      run += n;
    }
  }
  __syncthreads();
  const int rank = live ? cnt[warp][b] + lower : kCarry;

  // (3) the slab a piece at a time: zero, place, store whole
  const int pairs = kRows * k;
  const int n_pieces = (pairs + kPiecePairs - 1) / kPiecePairs;
  float* slab = out + (long long)blockIdx.x * pairs * kCarry;
  int row = 0, pair = b;  // this record's next row, and its (row, bucket) pair
  for (int i = 0; i < n_pieces; ++i) {
    uint32_t* piece = pieces + (i & 1) * kPieceWords;
    if (i >= 2) {  // the copy of piece i - 2, out of this buffer, has read it
      if (t == 0) bulk_read_done<1>();
      __syncthreads();
    }
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int j = t; j < kPieceWords / 4; j += kR) reinterpret_cast<uint4*>(piece)[j] = zero;
    __syncthreads();
    const int first = i * kPiecePairs;
    if (rank < kCarry) {
      for (; row < kRows && pair < first + kPiecePairs; ++row, pair += k)
        piece[(pair - first) * kCarry + rank] = rows[row * kR + t];
    }
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      const int words = min(kPiecePairs, pairs - first) * kCarry;
      bulk_store(slab + (long long)first * kCarry, piece, 4 * words);
    }
  }
  if (t == 0) bulk_all_done();
}

}  // namespace

extern "C" int gs_bucketer_chunk() { return kR; }

// rec: (16, c) f32, 4-byte aligned, row 9 the tile id in [0, 512); out:
// (c / 512, 16, k * 128) f32, 16-byte aligned, 1 <= k <= 64; scale = k / 512
// as a float. Columns past the last whole chunk are not read.
extern "C" int gs_bucketer_level(const void* rec, long long c, int k, float scale,
                                 void* out, void* stream) {
  const long long n_chunks = c / kR;
  if (n_chunks <= 0) return 0;
  if (k < 1 || k > kMaxK || n_chunks > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int bucket_bits = 0;
  while ((1 << bucket_bits) < k) ++bucket_bits;
  cudaError_t e = cudaFuncSetAttribute(bucketer_level,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  bucketer_level<<<(unsigned)n_chunks, kR, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), c, k, bucket_bits, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
