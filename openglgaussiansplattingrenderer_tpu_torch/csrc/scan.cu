// Inclusive int32 prefix sum (reduce-then-scan), for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/scan.py
//           _cumsum_kernel (a sequential TPU grid carrying one scalar
//           between 2048-element blocks).
// Bound on the card: device memory. The frame's scan reads the per-splat
//           duplicate counts twice and writes the offsets once, 12 bytes a
//           splat; there is no arithmetic to speak of.
// Design:   GPU blocks run in no order, so the carry becomes three passes:
//           (1) each block sums its 4096-element tile, (2) one block scans
//           the tile sums to exclusive tile offsets, (3) each block scans
//           its tile again (warp shuffles, then a scan of the 32 warp sums)
//           and adds its offset. Integer sums are exact, so the result
//           equals torch.cumsum bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Inclusive scan of one value per thread over the whole block; *total gets
// the block's sum. warp_sums is 32 ints of shared memory.
__device__ int block_incl_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
    w = warp_incl_scan(w);
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int res = incl + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return res;
}

__global__ void tile_sums(const int32_t* __restrict__ x, int32_t* __restrict__ sums, int n) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * kTile;
  int s = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = base + threadIdx.x + i * kThreads;  // coalesced
    if (idx < n) s += x[idx];
  }
  int total;
  block_incl_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: sums[0..nb) -> exclusive prefix, in place.
__global__ void scan_tile_sums(int32_t* __restrict__ sums, int nb) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < nb; base += kThreads) {
    const int idx = base + threadIdx.x;
    const int v = idx < nb ? sums[idx] : 0;
    int total;
    const int incl = block_incl_scan(v, warp_sums, &total);
    if (idx < nb) sums[idx] = carry + incl - v;
    carry += total;
  }
}

__global__ void scan_tiles(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                           const int32_t* __restrict__ offsets, int n) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int v[kItems];
  int run = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = base + i < n ? x[base + i] : 0;
    run += v[i];
    v[i] = run;
  }
  int total;
  const int thread_incl = block_incl_scan(run, warp_sums, &total);
  const int off = offsets[blockIdx.x] + thread_incl - run;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (base + i < n) out[base + i] = v[i] + off;
}

}  // namespace

extern "C" int gs_cumsum_tile() { return kTile; }

// x, out: n int32 on the device; tile_scratch: ceil(n / gs_cumsum_tile())
// int32. Returns cudaGetLastError() after the three launches.
extern "C" int gs_cumsum_i32(const int32_t* x, int32_t* out, int32_t* tile_scratch,
                             int n, void* stream) {
  if (n <= 0) return 0;
  const int nb = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_sums<<<nb, kThreads, 0, s>>>(x, tile_scratch, n);
  scan_tile_sums<<<1, kThreads, 0, s>>>(tile_scratch, nb);
  scan_tiles<<<nb, kThreads, 0, s>>>(x, out, tile_scratch, n);
  return static_cast<int>(cudaGetLastError());
}
