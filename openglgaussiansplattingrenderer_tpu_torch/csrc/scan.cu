// Inclusive int32 prefix sum in one pass (chained scan with decoupled
// look-back), and the radix sort's offset table on the same core, for
// Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/scan.py
//           _cumsum_kernel (a sequential TPU grid carrying one scalar
//           between 2048-element blocks).
// Bound on the card: device memory, 8 bytes a value (read once, written
//           once), and at the frame's 3.6M counts the fixed cost of getting
//           a kernel onto the card: there is no arithmetic to speak of.
// Design:   GPU blocks run in no order, so the TPU's carried scalar becomes
//           a chain of per-tile descriptors in global memory. One launch:
//           (1) a block takes its tile number from a global counter, not
//           from blockIdx, so every tile it will wait for has already
//           started and the chain cannot deadlock, whatever order the
//           hardware schedules blocks in; (2) it loads its 4,096 values, 16
//           bytes a thread where both pointers allow (4-byte accesses
//           otherwise, and in the ragged last tile), and scans them in
//           registers and warp shuffles; (3) it publishes its tile's sum,
//           then its first warp looks back over the earlier tiles'
//           descriptors, 32 at a time, adding sums until it meets a tile
//           that already knows its prefix, and publishes its own prefix;
//           (4) the block adds the prefix and stores. A descriptor is one
//           64-bit word, status in the high half and the int32 value in the
//           low half, written and read with single volatile 64-bit
//           accesses: status and value cannot be seen torn, the compiler
//           cannot hoist the read out of the spin loop, and because a
//           reader takes nothing but the word itself no fence is needed
//           between a tile's output stores and its descriptor. The scratch
//           (ticket counter + descriptors) is the wrapper's, one allocation
//           a stream that lives from call to call, and the entry point
//           clears it with cudaMemsetAsync on the launch's own stream before
//           every launch. Launches on one stream run one after the other,
//           so a clear in stream order can never be seen stale, two streams
//           never share scratch, and a launch that is replayed from a CUDA
//           graph clears again. The two other ways were tried on the card:
//           an epoch tag in the status needs host state that a replay would
//           repeat, and a kernel that leaves its scratch zeroed (each block
//           fences and counts itself done, the last clears) spares the clear
//           but the fence and the counter cost 17% at 67M values and nothing
//           is gained at the frame's 3.6M, where a launch is one wave of
//           blocks and the time is latency.
//           Sums are taken in uint32, so they wrap exactly as
//           torch.cumsum(dtype=int32) does, bit for bit.
//           The table entry point walks the radix sort's (n_chunks, K)
//           count table in digit-major order through its strides and writes
//           the (n_chunks + 1, K) exclusive offsets, closing row included:
//           phase 2 of a sort pass in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                    // 16-byte groups a thread
constexpr int kWarpSpan = 32 * 4 * kVecs;   // consecutive values a warp owns
constexpr int kTile = kWarps * kWarpSpan;   // values a block owns
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;
constexpr int kScratchHead = 1;  // words before the descriptors: the ticket counter
// a descriptor's status; cleared scratch reads as kEmpty
constexpr uint32_t kEmpty = 0, kSum = 1, kPrefix = 2;

__device__ __forceinline__ u64 descriptor(uint32_t status, uint32_t value) {
  return ((u64)status << 32) | value;
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// One warp: the sum of every tile before `tile`, in every lane. Lane l reads
// the descriptor of the l-th tile back; the nearest tile that knows its
// prefix ends the walk, since the farther ones are inside that prefix.
__device__ uint32_t look_back(const volatile u64* desc, int tile, int lane) {
  uint32_t excl = 0;
  for (int nearest = tile - 1;; nearest -= 32) {
    const int t = nearest - lane;
    u64 w;
    do {  // before the first tile everything sums to a known 0
      w = t >= 0 ? desc[t] : descriptor(kPrefix, 0u);
    } while (__any_sync(kFull, (uint32_t)(w >> 32) == kEmpty));
    const unsigned known = __ballot_sync(kFull, (uint32_t)(w >> 32) == kPrefix);
    const unsigned take = known ? (2u << (__ffs(known) - 1)) - 1u : kFull;
    excl += __reduce_add_sync(kFull, (take >> lane) & 1u ? (uint32_t)w : 0u);
    if (known) return excl;
  }
}

// TABLE = false: out[i] = x[0] + ... + x[i], i < n.
// TABLE = true:  x is a (rows, cols) table read through its strides in
//   column-major order, i = col * rows + row; out is (rows + 1, cols)
//   contiguous, out[row, col] the sum before i and out[rows, col] the sum
//   through the column's last row.
template <bool TABLE>
__global__ void __launch_bounds__(kThreads)
scan_lookback(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              u64* scratch, int n, int rows, int cols, long long stride_r,
              long long stride_c, int vec_in, int vec_out) {
  __shared__ int s_tile;
  __shared__ uint32_t s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd((unsigned int*)scratch, 1u);
  __syncthreads();
  const int tile = s_tile;
  // the thread's group j holds values first + 128 j .. first + 128 j + 3
  const long long first = (long long)tile * kTile + warp * kWarpSpan + lane * 4;
  const bool full = (long long)(tile + 1) * kTile <= n;

  uint32_t v[kVecs][4], x0[kVecs][4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long at = first + j * 128;
    if (!TABLE && full && vec_in) {
      const int4 q = *reinterpret_cast<const int4*>(x + at);
      v[j][0] = q.x; v[j][1] = q.y; v[j][2] = q.z; v[j][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = at + k;
        uint32_t val = 0u;
        if (i < n) {
          if (TABLE) {
            const int col = (int)(i / rows);
            const int row = (int)(i - (long long)col * rows);
            val = (uint32_t)x[row * stride_r + col * stride_c];
          } else {
            val = (uint32_t)x[i];
          }
        }
        v[j][k] = val;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) x0[j][k] = v[j][k];
  }

  // running sums inside each group, a warp scan of the groups' sums, and the
  // warp's earlier groups carried along
  uint32_t carry = 0u;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    v[j][1] += v[j][0];
    v[j][2] += v[j][1];
    v[j][3] += v[j][2];
    const uint32_t incl = warp_incl_scan(v[j][3], lane);
    const uint32_t before = carry + incl - v[j][3];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[j][k] += before;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) s_warp[warp] = carry;  // the warp's sum
  __syncthreads();

  if (warp == 0) {
    const uint32_t w = lane < kWarps ? s_warp[lane] : 0u;
    const uint32_t incl = warp_incl_scan(w, lane);
    const uint32_t total = __shfl_sync(kFull, incl, 31);
    volatile u64* desc = scratch + kScratchHead;
    uint32_t excl = 0u;
    if (tile == 0) {
      if (lane == 0) desc[0] = descriptor(kPrefix, total);
    } else {
      if (lane == 0) desc[tile] = descriptor(kSum, total);
      excl = look_back(desc, tile, lane);
      if (lane == 0) desc[tile] = descriptor(kPrefix, excl + total);
    }
    if (lane < kWarps) s_warp[lane] = excl + incl - w;  // what precedes the warp
  }
  __syncthreads();
  const uint32_t before = s_warp[warp];

#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long at = first + j * 128;
    if (!TABLE && full && vec_out) {
      int4 q;
      q.x = v[j][0] + before; q.y = v[j][1] + before;
      q.z = v[j][2] + before; q.w = v[j][3] + before;
      *reinterpret_cast<int4*>(out + at) = q;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = at + k;
        if (i >= n) continue;
        const uint32_t incl = v[j][k] + before;
        if (TABLE) {
          const int col = (int)(i / rows);
          const int row = (int)(i - (long long)col * rows);
          out[(long long)row * cols + col] = (int32_t)(incl - x0[j][k]);
          if (row == rows - 1) out[(long long)rows * cols + col] = (int32_t)incl;
        } else {
          out[i] = (int32_t)incl;
        }
      }
    }
  }
}

int tiles_of(long long n) { return (int)((n + kTile - 1) / kTile); }

cudaError_t clear_scratch(void* scratch, int tiles, cudaStream_t s) {
  return cudaMemsetAsync(scratch, 0, sizeof(u64) * (size_t)(kScratchHead + tiles), s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int gs_cumsum_tile() { return kTile; }

// x, out: n int32 on the device, 4-byte aligned (16-byte alignment of either
// turns on its wide accesses); scratch: at least 1 + ceil(n / gs_cumsum_tile())
// 64-bit words that no other stream uses, cleared here on the stream. One
// kernel launch. Returns the first CUDA error.
extern "C" int gs_cumsum_i32(const int32_t* x, int32_t* out, void* scratch, int n,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = tiles_of(n);
  const cudaError_t e = clear_scratch(scratch, nt, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_lookback<false><<<nt, kThreads, 0, s>>>(
      x, out, static_cast<u64*>(scratch), n, 0, 0, 0, 0, aligned16(x), aligned16(out));
  return static_cast<int>(cudaGetLastError());
}

// counts: (rows, cols) int32 with element strides (stride_r, stride_c);
// offs: (rows + 1, cols) int32, contiguous: offs[r, c] = the sum of every
// count in a column before c plus column c's counts in rows before r; row
// `rows` closes each column's range. rows * cols < 2^31. scratch: as for
// gs_cumsum_i32 with n = rows * cols. One launch.
extern "C" int gs_prefix_offsets_i32(const int32_t* counts, int32_t* offs,
                                     void* scratch, int rows, int cols,
                                     long long stride_r, long long stride_c,
                                     void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n = (long long)rows * cols;
  if (n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = tiles_of(n);
  const cudaError_t e = clear_scratch(scratch, nt, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_lookback<true><<<nt, kThreads, 0, s>>>(
      counts, offs, static_cast<u64*>(scratch), (int)n, rows, cols, stride_r,
      stride_c, 0, 0);
  return static_cast<int>(cudaGetLastError());
}
