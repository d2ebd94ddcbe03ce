// Per-splat segment sum of record cotangents: the transpose of expand.cu,
// for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/records.py
//           _segsum_kernel (512 splats a grid step; their records streamed
//           in 128-aligned chunks and reduced onto the splat axis by a
//           transposed one-hot matrix-unit product).
// Bound on the card: bytes. 36 bytes read a record below total, 36 bytes
//           written and 4 read a splat; one add a value.
// Design:   record-major, on the expansion's partition (records_common.cuh):
//           a piece is K = 1,024 items of the merged sequence of the
//           records below total = min(cum_incl[n-1], capacity) and the n
//           splat ends. Records at or past total were zeroed by the
//           expansion and carry no gradient. A block takes two pieces one
//           after another: it (1) finds where they start by three merge-path
//           searches at once, a warp each; then for each piece (2) loads its
//           records' nine rows into
//           shared memory, 16 bytes a copy where the rows are 16-byte
//           aligned, and the prefix sums of its ends, all copies in flight
//           at once (cp.async); (3) gives each of its 256 threads 4
//           consecutive items, found by a merge-path search in shared
//           memory: the thread walks them, summing the records of a
//           splat and, at each end, storing the splat's sum -- all of it if
//           the splat began in the thread's items, else keeping it as the
//           head of its first end; (4) a segmented scan of the threads' open
//           sums (warp shuffles, then across the warps), keyed by whether a
//           thread met an end, gives each thread the sum of the records
//           before it that belong to its first end's splat, and the block's
//           open sum at its end; (5) every end in the piece, an empty splat
//           too (zeros), is stored by the block, the open sum goes to a
//           carry slot. A splat cut by piece boundaries is finished by a
//           second launch: a thread for each piece that holds an end adds
//           the carries of the pieces before it, nearest first,
//           back to the one where the splat's records begin. No atomics,
//           one fixed summation order: the result is the same from run to
//           run. Two launches a call.

#include "records_common.cuh"

namespace {

using records::kFull;
using records::kItems;

constexpr int kThreads = 256;
constexpr int kPer = kItems / kThreads;  // items a thread walks
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 9;
static_assert(kThreads / 32 > records::kPieces, "block_splits takes a warp a split");
constexpr int kRow = kItems + 8;         // a shared row: the piece's records,
                                         // widened to whole 16-byte groups

struct Open {  // a segmented-scan element: a sum, and whether an end closed it
  float v[kFields];
  bool closed;
};

// a then b: b's sum alone if an end closed b, else a's sum and b's
__device__ __forceinline__ void combine(const Open& a, Open& b) {
  if (!b.closed) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) b.v[f] = a.v[f] + b.v[f];
  }
  b.closed = a.closed || b.closed;
}

__device__ __forceinline__ Open shfl_up(const Open& x, int o) {
  Open y;
#pragma unroll
  for (int f = 0; f < kFields; ++f) y.v[f] = __shfl_up_sync(kFull, x.v[f], o);
  y.closed = __shfl_up_sync(kFull, (int)x.closed, o) != 0;
  return y;
}

// One piece of the partition, by the whole block.
__device__ __forceinline__ void piece(const float* __restrict__ g, int capacity,
                                      const int32_t* __restrict__ cum_incl, int n,
                                      float* __restrict__ out, float* __restrict__ carry,
                                      int32_t* __restrict__ first, bool vec, long long total,
                                      const records::Piece p, long long q,
                                      float (*s_g)[kRow], int32_t* s_end,
                                      float (*s_warp)[kFields + 1]) {
  const int nends = p.s1 - p.s0, nrec = p.r1 - p.r0;
  const int base = p.r0 & ~3;  // s_g column 0 is record `base`

  // every copy in flight at once; an end's prefix sum is clamped to total
  // where it is read
  for (int i = threadIdx.x; i < nends; i += kThreads)
    records::copy_async(&s_end[i], cum_incl + p.s0 + i, 4);
  if (nrec > 0) {
    const int groups = ((p.r1 + 3) >> 2) - (base >> 2);
    for (int gq = threadIdx.x; gq < groups; gq += kThreads) {
      const int r = base + 4 * gq;
      if (vec) {  // capacity % 4 == 0: the whole group lies inside the row
#pragma unroll
        for (int f = 0; f < kFields; ++f)
          records::copy_async(&s_g[f][4 * gq], g + (size_t)f * capacity + r, 16);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (r + k < p.r0 || r + k >= p.r1) continue;
#pragma unroll
          for (int f = 0; f < kFields; ++f)
            records::copy_async(&s_g[f][4 * gq + k], g + (size_t)f * capacity + r + k, 4);
        }
      }
    }
  }
  records::copies_arrived();
  __syncthreads();
  const int32_t tot = (int32_t)total;

  // the thread's items [dt, dt + kPer) of the piece: i ends before them
  const int len = nends + nrec;
  const int dt = threadIdx.x * kPer;
  int i = 0;
  if (dt < len) {
    int lo = max(0, dt - nrec), hi = min(dt, nends);
    while (lo < hi) {  // the smallest i whose end lies at or past dt
      const int mid = (lo + hi) >> 1;
      if (mid + (min(s_end[mid], tot) - p.r0) >= dt) hi = mid; else lo = mid + 1;
    }
    i = lo;
  }
  int r = p.r0 + dt - i;
  Open mine;
#pragma unroll
  for (int f = 0; f < kFields; ++f) mine.v[f] = 0.0f;
  mine.closed = false;
  float head[kFields];
  int head_end = -1;
  for (int k = 0; k < kPer && dt + k < len; ++k) {
    if (i < nends && min(s_end[i], tot) <= r) {  // splat s0 + i ends here
      if (head_end < 0) {
        head_end = i;
#pragma unroll
        for (int f = 0; f < kFields; ++f) head[f] = mine.v[f];
      } else {
#pragma unroll
        for (int f = 0; f < kFields; ++f) out[(size_t)f * n + p.s0 + i] = mine.v[f];
      }
#pragma unroll
      for (int f = 0; f < kFields; ++f) mine.v[f] = 0.0f;
      ++i;
    } else {
#pragma unroll
      for (int f = 0; f < kFields; ++f) mine.v[f] += s_g[f][r - base];
      ++r;
    }
  }
  mine.closed = head_end >= 0;

  // segmented scan over the block's threads, in thread order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Open incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Open up = shfl_up(incl, o);
    if (lane >= o) combine(up, incl);
  }
  if (lane == 31) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) s_warp[warp][f] = incl.v[f];
    s_warp[warp][kFields] = incl.closed ? 1.0f : 0.0f;
  }
  Open excl = shfl_up(incl, 1);  // the threads before, in this warp
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) excl.v[f] = 0.0f;
    excl.closed = false;
  }
  __syncthreads();
  Open before;  // the warps before
#pragma unroll
  for (int f = 0; f < kFields; ++f) before.v[f] = 0.0f;
  before.closed = false;
  for (int wp = 0; wp < warp; ++wp) {
    Open x;
#pragma unroll
    for (int f = 0; f < kFields; ++f) x.v[f] = s_warp[wp][f];
    x.closed = s_warp[wp][kFields] != 0.0f;
    combine(before, x);
    before = x;
  }
  combine(before, excl);  // now the open sum of every thread before this one

  if (head_end >= 0) {
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      out[(size_t)f * n + p.s0 + head_end] = excl.v[f] + head[f];
  }
  if (threadIdx.x == kThreads - 1) {  // the piece's open sum: splat s1's records
    combine(excl, mine);
#pragma unroll
    for (int f = 0; f < kFields; ++f) carry[q * kFields + f] = mine.v[f];
    first[q] = nends > 0 ? p.s0 : -1;
  }
}

// carries: (pieces, 9) float, then (pieces,) int32 first-end splat (-1: none)
__global__ void __launch_bounds__(kThreads)
segsum(const float* __restrict__ g, int capacity,    // (9, capacity)
       const int32_t* __restrict__ cum_incl, int n,  // (n,)
       float* __restrict__ out,                      // (9, n)
       float* __restrict__ carry, int32_t* __restrict__ first, bool vec) {
  __shared__ __align__(16) float s_g[kFields][kRow];
  __shared__ int32_t s_end[kItems];        // cum_incl[s0 + i] of the piece's ends
  __shared__ float s_warp[kWarps][kFields + 1];
  __shared__ long long s_split[records::kPieces + 1];
  const long long total = records::clamp_total(cum_incl, n, capacity);
  const long long merged = n + total;
  const long long first_item = (long long)blockIdx.x * records::kPieces * kItems;
  if (first_item >= merged) return;
  records::block_splits(cum_incl, n, total, first_item, merged, s_split);
  for (int j = 0; j < records::kPieces; ++j) {
    if (first_item + (long long)j * kItems >= merged) break;
    const long long q = (long long)blockIdx.x * records::kPieces + j;  // the piece
    piece(g, capacity, cum_incl, n, out, carry, first, vec, total,
          records::piece_of(s_split, j, first_item, merged), q, s_g, s_end, s_warp);
    __syncthreads();  // the shared rows are refilled for the next piece
  }
}

// One thread a piece: the piece's first end gets the carries of the pieces
// before it that hold records of its splat, nearest first.
__global__ void segsum_carries(const int32_t* __restrict__ cum_incl, int n, int capacity,
                               float* __restrict__ out, const float* __restrict__ carry,
                               const int32_t* __restrict__ first) {
  const long long total = records::clamp_total(cum_incl, n, capacity);
  const long long pieces = (n + total + kItems - 1) / kItems;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0 || b >= pieces) return;
  const int s = first[b];
  if (s < 0) return;
  float acc[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
  for (long long k = b - 1;; --k) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) acc[f] += carry[k * kFields + f];
    if (k == 0 || first[k] >= 0) break;  // splat s's records begin in piece k
  }
#pragma unroll
  for (int f = 0; f < kFields; ++f) out[(size_t)f * n + s] += acc[f];
}

}  // namespace

// g: (9, capacity) f32 record cotangents; cum_incl (n,) int32 inclusive
// prefix sum of the per-splat record counts; out (9, n) f32; scratch: at
// least 10 * ceil((n + capacity) / gs_records_items()) words. Two launches.
extern "C" int gs_segsum(const float* g, int capacity, const int32_t* cum_incl, int n,
                         float* out, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = (long long)n + capacity;
  const long long pieces = (items + kItems - 1) / kItems;
  const long long span = (long long)records::kPieces * kItems;
  float* carry = static_cast<float*>(scratch);
  int32_t* first = reinterpret_cast<int32_t*>(carry + pieces * kFields);
  const bool vec = capacity % 4 == 0 && records::aligned16(g);
  segsum<<<(unsigned)((items + span - 1) / span), kThreads, 0, s>>>(
      g, capacity, cum_incl, n, out, carry, first, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  segsum_carries<<<(unsigned)((pieces + 255) / 256), 256, 0, s>>>(cum_incl, n, capacity, out,
                                                                  carry, first);
  return static_cast<int>(cudaGetLastError());
}
