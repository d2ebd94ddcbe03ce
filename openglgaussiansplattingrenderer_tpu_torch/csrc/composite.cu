// Tile compositor forward: front-to-back blending of (tile, depth)-sorted
// records, for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/composite.py
//           _fwd_kernel (one sequential grid step per tile; (pixels, chunk)
//           vector blocks with a Hillis-Steele cumprod of 1 - alpha).
// Bound on the card: by bytes on the uniform flagship frame (36 B a binned
//           record read, 16 B a pixel written: most pixels saturate after
//           a few hundred records), by operations on the gate scene and
//           wherever tiles do not saturate; chip_smoke.py computes both
//           for the records it is given and prints the larger.
// Design:   the unit of work is a group of eight pixel patches of a tile
//           (16x16 pixels of a 32x32 tile), one block of eight warps; a
//           tile is as many blocks as it has groups, so a heavy tile runs
//           on several SMs and each block writes its own pixels. A warp
//           owns one patch, one pixel a lane. Records stream through
//           shared memory in batches of up to `chunk`, staged once a block
//           with the TPU kernel's scaled Cholesky ("sos") factors and with
//           what the skip test needs (composite_common.cuh), and only
//           those records are staged that the test lets reach the box
//           around the block's live pixels: one test a record decides for
//           eight warps, and a batch fills up with records that matter. Per
//           round of 32 staged records, lane l tests record l against the
//           warp's patch rect (narrowed, batch by batch, to the box around
//           the pixels still alive) and a ballot names the survivors; a
//           warp tests its whole batch ahead and then blends the survivors
//           alone, in record order, so a pixel sees the records that can
//           reach alpha_min in its patch, in the same order and with the
//           same arithmetic as if it had seen them all. Each pixel stops
//           at the first record whose preceding transmittance is <= 1 -
//           saturation (draw.glsl's break); a warp with no live pixel
//           stops testing, and a block whose live box is empty leaves
//           (the warps merge their boxes after each batch). Built with
//           --fmad=false: the power is rounded as in the plain version.

#include "composite_common.cuh"

namespace {

constexpr int kWarps = 8;            // patches a block owns
constexpr int kThreads = 32 * kWarps;

// The patches of a group: gax x gay of them, gax * gay = kWarps.
struct Groups {
  int gax, gay, across, count;
};

Groups patch_groups(const gs::PatchGrid& g) {
  Groups q;
  q.gax = g.pax < 2 ? 1 : 2;
  q.gay = kWarps / q.gax;
  q.across = (g.pax + q.gax - 1) / q.gax;
  q.count = q.across * ((g.pay + q.gay - 1) / q.gay);
  return q;
}

__global__ void __launch_bounds__(kThreads, 5)
composite_fwd(const float* __restrict__ rec, int rec_stride,   // (9, rec_stride)
              const int32_t* __restrict__ bounds,              // (T + 1,)
              const int32_t* __restrict__ ox, const int32_t* __restrict__ oy,
              float4* __restrict__ out,                        // (T, p)
              gs::PatchGrid grid, Groups groups, int pw, int ph, int chunk,
              float alpha_min, float alpha_max, float thresh, float ln_alpha_min) {
  extern __shared__ float4 sm4[];  // kStagedFloats floats a record of the batch
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ int s_box[2][4];
  __shared__ int s_counts[2 * 32];

  const int t = blockIdx.x / groups.count;
  const int group = blockIdx.x - t * groups.count;
  const int b0 = bounds[t];
  const int b1 = bounds[t + 1];
  const float oxf = (float)ox[t];
  const float oyf = (float)oy[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int pxi = (group % groups.across) * groups.gax + warp % groups.gax;
  const int pyi = (group / groups.across) * groups.gay + warp / groups.gax;
  const int x = pxi * grid.px + (lane & (grid.px - 1));
  const int y = pyi * grid.py + (lane >> grid.px_log2);
  const bool in_tile = x < pw && y < ph;
  const float fx = (float)x, fy = (float)y;

  float T = in_tile ? 1.0f : 0.0f;  // a lane outside the tile is never alive
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;

  // the box around the warp's live pixels, and around the block's: that of
  // the batch being staged in s_box[gen], the next one's gathering in the other
  gs::Box mine_box = gs::live_box(T > thresh, x, y);
  if (threadIdx.x < 2) gs::box_clear(s_box[threadIdx.x]);
  __syncthreads();
  if (lane == 0) gs::box_merge(s_box[0], mine_box);
  __syncthreads();

  int gen = 0;
  for (int base = b0; base < b1; gen ^= 1) {
    const gs::Box box = gs::box_read(s_box[gen]);
    if (box.x1 < 0) break;  // no pixel of the block is alive
    if (threadIdx.x == 0) gs::box_clear(s_box[gen ^ 1]);
    const int m = gs::stage_reaching(sm, chunk, rec, rec_stride, base, b1, oxf, oyf,
                                     ln_alpha_min, gs::rect_of(box), s_counts, nullptr);
    __syncthreads();
    if (mine_box.x1 >= 0) {
      // lane r: the survivors of round r against what is left of the patch
      const unsigned mine = gs::batch_survivors(sm, chunk, m, gs::rect_of(mine_box), lane);
      bool warp_alive = true;
      for (unsigned todo = __ballot_sync(gs::kFull, mine != 0u); todo && warp_alive;
           todo &= todo - 1) {
        const int r = __ffs(todo) - 1;
        const int k0 = r * gs::kRound;
        unsigned live = __shfl_sync(gs::kFull, mine, r);
        while (live) {
          const int k = k0 + __ffs(live) - 1;
          live &= live - 1;
          const float4* words = gs::blend_words(sm, k);
          const float4 c0 = words[0], c1 = words[1];  // s11 s12 s22 u0 | v0 op r g
          const float blue = reinterpret_cast<const float*>(words + 2)[0];
          if (T > thresh) {
            const float alpha = fminf(
                alpha_max, gs::alpha_unclamped(c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, fx, fy));
            if (alpha >= alpha_min) {
              const float w = alpha * T;
              cr += w * c1.z;
              cg += w * c1.w;
              cb += w * blue;
              T = T * (1.0f - alpha);
            }
          }
        }
        warp_alive = __any_sync(gs::kFull, T > thresh);
      }
      mine_box = gs::live_box(T > thresh, x, y);
      if (lane == 0) gs::box_merge(s_box[gen ^ 1], mine_box);
    }
    __syncthreads();  // the batch has been consumed, the next box is complete
  }

  if (in_tile)
    out[(size_t)t * (pw * ph) + y * pw + x] = make_float4(cr, cg, cb, T);
}

}  // namespace

extern "C" int gs_composite_max_pixels() { return gs::kMaxPixels; }

// rec: (9, rec_stride) f32 sorted record fields; bounds (T+1,) int32;
// ox, oy (T,) int32 tile pixel origins; out (T, pw * ph, 4) f32;
// ln_alpha_min = ln(alpha_min) as the expansion's cull rounds it.
extern "C" int gs_composite_fwd(const float* rec, int rec_stride, const int32_t* bounds,
                                const int32_t* ox, const int32_t* oy, float* out,
                                int num_tiles, int pw, int ph, int chunk, float alpha_min,
                                float alpha_max, float thresh, float ln_alpha_min,
                                void* stream) {
  if (num_tiles <= 0) return 0;
  if (pw <= 0 || ph <= 0 || pw * ph > gs::kMaxPixels || chunk <= 0 || chunk > gs::kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const gs::PatchGrid grid = gs::patch_grid(pw, ph);
  const Groups groups = patch_groups(grid);
  const size_t smem = sizeof(float) * gs::kStagedFloats * chunk;
  if (smem > 48 * 1024) {  // above the default limit only on request
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_fwd<<<num_tiles * groups.count, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      rec, rec_stride, bounds, ox, oy, reinterpret_cast<float4*>(out), grid, groups, pw, ph,
      chunk, alpha_min, alpha_max, thresh, ln_alpha_min);
  return static_cast<int>(cudaGetLastError());
}
