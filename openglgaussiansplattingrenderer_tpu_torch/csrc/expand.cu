// Duplicate expansion: per-splat table -> splat-major records, with the
// exact reachability cull, for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/records.py
//           _expand_kernel (a one-hot bf16 MXU matmul gather over
//           128-floored DMA windows of a 16-row f32 table).
// Bound on the card: device memory. Each record writes 11 words (9 fields,
//           tile, depth) and reads one splat's 13 words, which neighbouring
//           records share through L1/L2; the binary search touches
//           log2(N) = 22 words at the flagship size, mostly cached.
// Design:   one thread per record r. Its splat is s = upper_bound(cum_incl,
//           r) by binary search, the GPU form of the one-hot gather; the
//           tile follows from j = r - cum_excl[s] in integer arithmetic, so
//           none of the TPU layout rules (f32 index math, 128-floored
//           window starts, 16-row padding) carries over. Records past
//           total = min(cum_incl[n-1], capacity) are zero with tile =
//           num_tiles. The cull repeats the TPU kernel's two-KKT-candidate
//           minimum of the conic quadratic over the tile's pixel rect in
//           the same operation order; the library is built with
//           --fmad=false so no multiply-add is contracted and the plain
//           PyTorch version agrees bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void expand_records(const float* __restrict__ fields,     // (9, n)
                               const int32_t* __restrict__ tile_min,  // (n, 2)
                               const int32_t* __restrict__ tile_ext,  // (n, 2)
                               const float* __restrict__ depth,       // (n,)
                               const int32_t* __restrict__ cum_incl,  // (n,)
                               int n, float* __restrict__ out_fields,  // (9, cap)
                               int32_t* __restrict__ out_tile,         // (cap,)
                               float* __restrict__ out_depth,          // (cap,)
                               int capacity, int gx, int num_tiles, int pw, int ph,
                               float ln_alpha_min) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= capacity) return;
  const int total = min(n > 0 ? cum_incl[n - 1] : 0, capacity);

  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = 0.0f;
  int tile = num_tiles;
  float d = 0.0f;

  if (r < total) {
    int lo = 0, hi = n;  // first s with cum_incl[s] > r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum_incl[mid] > r) hi = mid; else lo = mid + 1;
    }
    const int s = lo;
    const int j = r - (s > 0 ? cum_incl[s - 1] : 0);
    const int ext = max(tile_ext[2 * s], 1);
    const int q = j / ext;
    const int ty = tile_min[2 * s + 1] + q;
    const int tx = tile_min[2 * s] + (j - q * ext);
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = fields[(size_t)k * n + s];
    d = depth[s];

    // exact minimum of the conic quadratic over the tile's pixel rect:
    // the two KKT edge candidates (records.py _expand_kernel, same order)
    const float mx = f[0], my = f[1], aa = f[2], bb = f[3], cc = f[4];
    const float x0 = (float)tx * (float)pw;
    const float y0 = (float)ty * (float)ph;
    const float dx0 = clipf(mx, x0, x0 + (float)(pw - 1)) - mx;
    const float dy0 = clipf(my, y0, y0 + (float)(ph - 1)) - my;
    const float ylo = y0 - my;
    const float xlo = x0 - mx;
    const float dys = clipf(-bb * dx0 / fmaxf(cc, 1e-12f), ylo, ylo + (float)(ph - 1));
    const float q1 = (aa * dx0 * dx0 + cc * dys * dys) + 2.0f * (bb * dx0 * dys);
    const float dxs = clipf(-bb * dy0 / fmaxf(aa, 1e-12f), xlo, xlo + (float)(pw - 1));
    const float q2 = (aa * dxs * dxs + cc * dy0 * dy0) + 2.0f * (bb * dxs * dy0);
    const float qmin = fminf(q1, q2);
    const float ln_ratio = logf(fmaxf(f[5], 1e-30f)) - ln_alpha_min;
    if (qmin * 0.49999f <= ln_ratio + 1e-4f) tile = ty * gx + tx;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) out_fields[(size_t)k * capacity + r] = f[k];
  out_tile[r] = tile;
  out_depth[r] = d;
}

}  // namespace

extern "C" int gs_expand(const float* fields, const int32_t* tile_min, const int32_t* tile_ext,
                         const float* depth, const int32_t* cum_incl, int n,
                         float* out_fields, int32_t* out_tile, float* out_depth,
                         int capacity, int gx, int num_tiles, int pw, int ph,
                         float ln_alpha_min, void* stream) {
  if (capacity <= 0) return 0;
  const int blocks = (capacity + kThreads - 1) / kThreads;
  expand_records<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fields, tile_min, tile_ext, depth, cum_incl, n, out_fields, out_tile, out_depth,
      capacity, gx, num_tiles, pw, ph, ln_alpha_min);
  return static_cast<int>(cudaGetLastError());
}
