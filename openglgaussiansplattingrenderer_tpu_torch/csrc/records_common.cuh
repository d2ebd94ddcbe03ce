// The load-balanced partition of records and splats that the expansion
// (expand.cu) and its transpose, the segment sum (segsum.cu), share.
//
// Records are splat-major: splat s owns the records [cum_incl[s-1],
// E[s]), E[s] = min(cum_incl[s], total), total = min(cum_incl[n-1],
// capacity). Merge the `total` records with the n splat ends, an end
// coming after every record of its splat: end s sits at position s + E[s]
// of the merged sequence, record r before end s iff r < E[s]. Piece q is
// the items [q K, (q+1) K) of the M = n + total items, so no piece holds
// more than K items of either kind: a run of a million empty splats is
// ends only and a splat of 2,040 records is spread over pieces. Where a
// piece starts, (s, r) with s + r = d = q K, is one merge-path search of
// cum_incl (the smallest s with s + E[s] >= d); a warp does it 32 probes
// at a time, five dependent loads at 3.6M splats where a binary search
// takes 22. Block b takes the pieces b P .. b P + P - 1 (P = kPieces) one
// after another and searches their P + 1 bounds at once, one warp each.
// Diagonals are 64-bit: n + capacity may pass 2^31. Records at or past
// total are the items [M, n + capacity), record r = item - n: the
// expansion fills them in the grid's last part.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace records {

constexpr int kItems = 1024;  // merged items a piece holds (K)
constexpr int kPieces = 2;    // consecutive pieces a block takes, one after another
constexpr unsigned kFull = 0xffffffffu;

static __device__ __forceinline__ long long clamp_total(const int32_t* cum_incl, int n,
                                                 int capacity) {
  return n > 0 ? min((long long)cum_incl[n - 1], (long long)capacity) : 0ll;
}

// position of splat s's end in the merged sequence
static __device__ __forceinline__ long long end_position(const int32_t* cum_incl, int s,
                                                  long long total) {
  return (long long)s + min((long long)cum_incl[s], total);
}

// One warp, all lanes: the number of splat ends among the first d items,
// the smallest s in [max(0, d - total), min(d, n)) whose end lies at or past
// d, else min(d, n). Each round probes 32 evenly spaced splats and keeps the
// span between the last probe before the answer and the first at or past
// it; the last round probes up to 32 splats one by one.
static __device__ long long warp_merge_search(const int32_t* __restrict__ cum_incl, int n,
                                       long long total, long long d, int lane) {
  long long lo = d - total > 0 ? d - total : 0;
  long long hi = d < n ? d : (long long)n;  // the answer is in [lo, hi]
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool at_or_past = p >= hi || end_position(cum_incl, (int)p, total) >= d;
    const unsigned m = __ballot_sync(kFull, at_or_past);
    if (m == 0u) {
      lo = lo + 31 * step + 1;
    } else {
      const int j = __ffs(m) - 1;
      if (j == 0) return lo;
      const long long nlo = lo + (j - 1) * step + 1;
      hi = min(hi, lo + j * step);
      lo = nlo;
    }
  }
  const long long p = lo + lane;
  const bool at_or_past = p < hi && end_position(cum_incl, (int)p, total) >= d;
  const unsigned m = __ballot_sync(kFull, at_or_past);
  return m ? lo + __ffs(m) - 1 : hi;
}

// A piece: the ends of splats [s0, s1) and the records [r0, r1).
struct Piece {
  int s0, s1, r0, r1;
};

// Warps 0 .. kPieces search the kPieces + 1 diagonals that bound a block's
// pieces, first + j K clamped to merged, all at once, so that the search's
// latency is paid once for kPieces pieces; s_split[j] gets the ends before
// diagonal j. Every thread of the block returns after a barrier.
static __device__ void block_splits(const int32_t* __restrict__ cum_incl, int n,
                                    long long total, long long first, long long merged,
                                    long long* s_split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp <= kPieces) {
    const long long d = min(first + (long long)warp * kItems, merged);
    const long long s = warp_merge_search(cum_incl, n, total, d, lane);
    if (lane == 0) s_split[warp] = s;
  }
  __syncthreads();
}

// piece j of a block whose pieces start at item `first`
static __device__ __forceinline__ Piece piece_of(const long long* s_split, int j,
                                                 long long first, long long merged) {
  const long long d0 = min(first + (long long)j * kItems, merged);
  const long long d1 = min(d0 + kItems, merged);
  Piece p;
  p.s0 = (int)s_split[j];
  p.s1 = (int)s_split[j + 1];
  p.r0 = (int)(d0 - s_split[j]);
  p.r1 = (int)(d1 - s_split[j + 1]);
  return p;
}

// An asynchronous copy of `bytes` (4 or 16, both addresses aligned to it)
// from device memory to shared memory: a block issues all of its loads
// before it waits for any (copies_arrived), where a loop of plain loads
// through registers would wait once an iteration.
static __device__ __forceinline__ void copy_async(void* shared, const void* global,
                                                  int bytes) {
  __pipeline_memcpy_async(shared, global, bytes);
}

// every copy_async of this thread has landed; the caller syncs the block
static __device__ __forceinline__ void copies_arrived() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

static __host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace records
