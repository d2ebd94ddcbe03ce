// Tile compositor backward: the analytic gradient of composite.cu's blend
// with respect to the nine fields of every record, for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/composite.py
//           _bwd_kernel (one sequential grid step per tile; (pixels, chunk)
//           vector blocks, Hillis-Steele scans of the transmittance and of
//           the weighted colour, two matrix-unit moment products, and a
//           read-modify-write of the 128-aligned chunk a tile shares with
//           its predecessor -- none of which the card needs: a tile's
//           records [b0, b1) are its own block's and are written once).
// Bound on the card: by bytes on the uniform flagship frame (36 B read and
//           36 B written a binned record, 32 B read a pixel), by operations
//           on the gate scene and wherever tiles do not saturate;
//           chip_smoke.py computes both and prints the larger.
// Design:   one block per tile, at most 16 warps; a warp owns PPT pixel
//           patches stacked downwards (PPT = 2 at 32x32 pixels, so two
//           blocks fit an SM), one pixel of each a lane, with the forward's
//           map from lanes to pixels and its skip test, patch by patch
//           (composite_common.cuh), so that each pixel sees the records the
//           forward showed it. The only residual is the forward's output:
//           each lane walks its pixels front to back again, carrying the
//           transmittance T and D, the cotangent-weighted colour still to
//           come (g_rgb . R_total less the weighted colours so far), and
//           repeats the forward's keep and include decisions exactly
//           (--fmad=false). Records are staged in batches of up to
//           `chunk` (at least one record a thread), and only those that the
//           skip test lets reach the box around the tile's live pixels:
//           the others get their zeros as they pass, so where a heavy
//           tile's records crowd on pixels that have long saturated, a
//           few pixels still alive elsewhere cost one test a record. The
//           batch is taken in rounds of 32. A live warp first tests it
//           (lane l tests record l of each round against the box around
//           the patch's live pixels), so the block knows the rounds in
//           which no live warp has a survivor: their gradients are zeros
//           and they cost no barrier. In the other rounds a warp walks its
//           survivors, and where a lane blended one, the nine partial sums
//           (dpower and its first and second moments in tile-local dx, dy;
//           the blend weight times g_rgb) are reduced over the warp by
//           shuffles (eight of them in one butterfly, warp_sums) and
//           stored with the warp's bit in the record's mask. After the
//           round's barrier one warp, the next one each round, adds the
//           partials of the warps named in each mask in warp order, turns
//           the moments into the field gradients with the staged conic and
//           writes them, while the others go on (partials and masks are
//           double-buffered: one barrier a round). No float atomics: the
//           result is the same from run to run. A warp with no live pixel
//           stops; when none is left the block writes zeros for the rest
//           of its tile's records, the first block also for the columns
//           before bounds[0], and every block for its share of those past
//           bounds[T] (a million at the flagship: one block alone took
//           longer over them than the whole walk), so the caller's drec
//           needs no clearing.

#include "composite_common.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kSums = 9;

// The sums of a[0..8] over the warp's lanes, stored at dst[j * kRound]. The
// first eight are summed together: at each of three steps a lane hands one
// half of what it holds to the lane 16, 8, 4 away and adds the partner's
// other half to its own, so after 4 + 2 + 1 shuffles lane l holds value
// (l >> 2) & 7 summed over eight lanes, and two more sum the four lanes
// that hold the same value: 9 shuffles where eight separate trees take 40.
// The order of the additions is fixed.
__device__ __forceinline__ void warp_sums(const float (&a)[kSums], int lane, float* dst) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float b[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (h16 ? a[i + 4] : a[i]) +
           __shfl_xor_sync(gs::kFull, h16 ? a[i] : a[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h8 ? b[i + 2] : b[i]) + __shfl_xor_sync(gs::kFull, h8 ? b[i] : b[i + 2], 8);
  float d = (h4 ? c[1] : c[0]) + __shfl_xor_sync(gs::kFull, h4 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(gs::kFull, d, 2);
  d += __shfl_xor_sync(gs::kFull, d, 1);
  float e = a[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(gs::kFull, e, off);
  if ((lane & 3) == 0) dst[(lane >> 2) * gs::kRound] = d;
  if (lane == 0) dst[8 * gs::kRound] = e;
}

template <int PPT>
__global__ void __launch_bounds__(32 * kMaxWarps, PPT <= 2 ? 2 : 1)  // two blocks an SM
composite_bwd(const float* __restrict__ rec, int rec_stride,   // (9, rec_stride)
              const int32_t* __restrict__ bounds,              // (T + 1,)
              const int32_t* __restrict__ ox, const int32_t* __restrict__ oy,
              const float4* __restrict__ out,                  // (T, p) forward output
              const float4* __restrict__ gout,                 // (T, p) its cotangent
              float* __restrict__ drec,                        // (9, rec_stride)
              gs::PatchGrid grid, int num_tiles, int pw, int ph, int chunk,
              float alpha_min, float alpha_max, float thresh, float ln_alpha_min) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int nwarps = blockDim.x >> 5;
  float* s_part = sm + gs::kStagedFloats * chunk;         // [2][nwarps][kSums][kRound]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_part + 2 * nwarps * kSums * gs::kRound);
  unsigned* s_any = s_mask + 2 * gs::kRound;  // the batch's rounds with a survivor
  __shared__ int s_box[2][4];
  __shared__ int s_counts[2 * 32];

  const int t = blockIdx.x;
  const int b0 = bounds[t];
  const int b1 = bounds[t + 1];
  const float oxf = (float)ox[t];
  const float oyf = (float)oy[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = pw * ph;

  // the warp's PPT patches: column pxi, rows pyi0 .. pyi0 + PPT - 1
  const int pxi = warp % grid.pax;
  const int pyi0 = (warp / grid.pax) * PPT;
  const int x = pxi * grid.px + (lane & (grid.px - 1));
  const float fx = (float)x;
  int y[PPT];
  float T[PPT], D[PPT], gr[PPT], gg[PPT], gb[PPT], gtt[PPT], fy[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    y[i] = (pyi0 + i) * grid.py + (lane >> grid.px_log2);
    fy[i] = (float)y[i];
    if (x < pw && y[i] < ph) {
      const float4 gv = gout[(size_t)t * p + y[i] * pw + x];
      const float4 ov = out[(size_t)t * p + y[i] * pw + x];
      T[i] = 1.0f;
      gr[i] = gv.x;
      gg[i] = gv.y;
      gb[i] = gv.z;
      D[i] = gv.x * ov.x + gv.y * ov.y + gv.z * ov.z;
      gtt[i] = gv.w * ov.w;  // g_T * T_fin
    } else {
      T[i] = 0.0f;  // a lane outside the tile is never alive
      gr[i] = gg[i] = gb[i] = D[i] = gtt[i] = 0.0f;
    }
  }
  if (threadIdx.x < 2 * gs::kRound) s_mask[threadIdx.x] = 0u;

  // the boxes around the live pixels of the warp's patches, and around the
  // block's: that of the batch being staged in s_box[gen], the next one's
  // gathering in the other
  gs::Box mine_box[PPT];
  bool warp_alive = false;
  if (threadIdx.x < 2) gs::box_clear(s_box[threadIdx.x]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    mine_box[i] = gs::live_box(T[i] > thresh, x, y[i]);
    warp_alive |= mine_box[i].x1 >= 0;
    if (lane == 0) gs::box_merge(s_box[0], mine_box[i]);
  }

  int round = 0;      // rounds with a barrier so far: picks the buffer
  int finaliser = 0;  // the warp that finalises the next of them
  int reached = b0;   // records below this index have had their gradient written
  bool block_alive = true;
  int gen = 0;
  for (int base = b0; base < b1 && block_alive; gen ^= 1) {
    __syncthreads();  // the previous batch has been consumed and finalised
    const gs::Box box = gs::box_read(s_box[gen]);
    if (box.x1 < 0) break;  // no pixel of the tile is alive
    if (threadIdx.x == 0) {
      gs::box_clear(s_box[gen ^ 1]);
      *s_any = 0u;
    }
    // the records that cannot reach the box get their zeros as they pass
    const int m = gs::stage_reaching(sm, chunk, rec, rec_stride, base, b1, oxf, oyf,
                                     ln_alpha_min, gs::rect_of(box), s_counts, drec);
    reached = base;
    __syncthreads();
    // A live warp tests the whole batch first; lane r keeps the ballot of
    // round r. The block then knows the rounds in which no warp has a
    // survivor: their gradients are zeros and they need no barrier.
    unsigned mine[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) mine[i] = 0u;
    if (warp_alive) {
      unsigned any_mine = 0u;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        // against what is left of the patch: the box around its live pixels
        if (mine_box[i].x1 >= 0)
          mine[i] = gs::batch_survivors(sm, chunk, m, gs::rect_of(mine_box[i]), lane);
        any_mine |= mine[i];
      }
      const unsigned nonempty = __ballot_sync(gs::kFull, any_mine != 0u);
      if (lane == 0 && nonempty) atomicOr(s_any, nonempty);
    }
    __syncthreads();
    const unsigned batch_any = *s_any;
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      if (!((batch_any >> (k / gs::kRound)) & 1u)) {
        const int idx = gs::staged_index(sm, chunk, k);
#pragma unroll
        for (int j = 0; j < kSums; ++j) drec[(size_t)j * rec_stride + idx] = 0.0f;
      }
    }
    for (unsigned todo = batch_any; todo; todo &= todo - 1) {
      const int r = __ffs(todo) - 1;
      const int k0 = r * gs::kRound;
      const int buf = round & 1;
      float* part = s_part + (buf * nwarps + warp) * (kSums * gs::kRound);
      unsigned* mask = s_mask + buf * gs::kRound;
      const bool walked = block_alive;  // else: zeros, and no buffer is touched
      if (walked && warp_alive) {
        unsigned live[PPT], any_live = 0u;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          live[i] = __shfl_sync(gs::kFull, mine[i], r);
          any_live |= live[i];
        }
        while (any_live) {
          const int kk = __ffs(any_live) - 1;
          const int k = k0 + kk;
          any_live &= any_live - 1;
          const float4* words = gs::blend_words(sm, k);
          const float4 c0 = words[0], c1 = words[1], c2 = words[2];
          const float s11 = c0.x, s12 = c0.y, s22 = c0.z, u0 = c0.w;
          const float v0 = c1.x, op = c1.y, cr = c1.z, cg = c1.w;
          const float cb = c2.x, mxl = c2.y, myl = c2.z;
          float acc[kSums];
#pragma unroll
          for (int j = 0; j < kSums; ++j) acc[j] = 0.0f;
          bool touched = false;
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            if (((live[i] >> kk) & 1u) && T[i] > thresh) {
              const float alpha_pre =
                  gs::alpha_unclamped(s11, s12, s22, u0, v0, op, fx, fy[i]);
              const float alpha = fminf(alpha_max, alpha_pre);
              if (alpha >= alpha_min) {
                const float S = T[i];
                const float w = alpha * S;
                const float e = gr[i] * cr + gg[i] * cg + gb[i] * cb;
                D[i] = D[i] - w * e;
                acc[6] += w * gr[i];
                acc[7] += w * gg[i];
                acc[8] += w * gb[i];
                if (alpha_pre < alpha_max) {  // no gradient through the clamp
                  const float dabar = e * S - (D[i] + gtt[i]) / (1.0f - alpha);
                  const float dpower = dabar * alpha;
                  const float dx = fx - mxl;
                  const float dy = fy[i] - myl;
                  const float px = dpower * dx;
                  const float py = dpower * dy;
                  acc[0] += dpower;
                  acc[1] += px;
                  acc[2] += py;
                  acc[3] += px * dx;
                  acc[4] += px * dy;
                  acc[5] += py * dy;
                }
                T[i] = T[i] * (1.0f - alpha);
                touched = true;
              }
            }
          }
          if (__any_sync(gs::kFull, touched)) {
            warp_sums(acc, lane, part + kk);
            if (lane == 0) atomicOr(&mask[kk], 1u << warp);
          }
        }
        bool alive = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) alive |= T[i] > thresh;
        warp_alive = __any_sync(gs::kFull, alive);
      }
      // this round's partials and masks are complete; once no warp is alive
      // the batch's other rounds are only finalised, to zeros
      if (walked) block_alive = __syncthreads_or(warp_alive);
      if (warp == finaliser && k0 + lane < m) {
        const int k = k0 + lane;
        const float* all = s_part + buf * nwarps * (kSums * gs::kRound) + lane;
        unsigned from = 0u;
        if (walked) {
          from = mask[lane];
          mask[lane] = 0u;
        }
        float s[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) s[j] = 0.0f;
        while (from) {  // in warp order, whatever order the warps arrived in
          const float* one = all + (__ffs(from) - 1) * (kSums * gs::kRound);
          from &= from - 1;
#pragma unroll
          for (int j = 0; j < kSums; ++j) s[j] += one[j * gs::kRound];
        }
        const float* rows = gs::staged_rows(sm, chunk);
        const float ca = rows[gs::kA * chunk + k], cbn = rows[gs::kBq * chunk + k];
        const float cc = rows[gs::kC * chunk + k], op = rows[gs::kOp * chunk + k];
        const int idx = gs::staged_index(sm, chunk, k);
        drec[idx] = ca * s[1] + cbn * s[2];                       // d mx
        drec[rec_stride + idx] = cc * s[2] + cbn * s[1];          // d my
        drec[2 * rec_stride + idx] = -0.5f * s[3];                // d A
        drec[3 * rec_stride + idx] = -s[4];                       // d B
        drec[4 * rec_stride + idx] = -0.5f * s[5];                // d C
        drec[5 * rec_stride + idx] = s[0] / fmaxf(op, 1e-12f);    // d opacity
        drec[6 * rec_stride + idx] = s[6];                        // d colour
        drec[7 * rec_stride + idx] = s[7];
        drec[8 * rec_stride + idx] = s[8];
      }
      round += walked;
      finaliser = finaliser + 1 == nwarps ? 0 : finaliser + 1;
    }
    // what is left of the warp's patches, for the next batch
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      mine_box[i] = gs::live_box(T[i] > thresh, x, y[i]);
      if (lane == 0) gs::box_merge(s_box[gen ^ 1], mine_box[i]);
    }
  }

  // zeros where no gradient was written: behind saturation, before
  // bounds[0], and this block's share of the columns past bounds[T] (there
  // may be a million of them: every block takes an equal share)
  const int tail0 = bounds[num_tiles];
  const int share = (rec_stride - tail0 + num_tiles - 1) / num_tiles;
  const int from[3] = {reached, t == 0 ? 0 : b0, min(tail0 + t * share, rec_stride)};
  const int to[3] = {b1, b0, min(tail0 + (t + 1) * share, rec_stride)};
#pragma unroll
  for (int span = 0; span < 3; ++span) {
    for (int idx = from[span] + (int)threadIdx.x; idx < to[span]; idx += blockDim.x) {
#pragma unroll
      for (int j = 0; j < kSums; ++j) drec[(size_t)j * rec_stride + idx] = 0.0f;
    }
  }
}

template <int PPT>
cudaError_t launch(const float* rec, int rec_stride, const int32_t* bounds, const int32_t* ox,
                   const int32_t* oy, const float* out, const float* gout, float* drec,
                   const gs::PatchGrid& grid, int nwarps, int num_tiles, int pw, int ph,
                   int chunk, float alpha_min, float alpha_max, float thresh,
                   float ln_alpha_min, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)gs::kStagedFloats * chunk + 2 * nwarps * kSums * gs::kRound +
                       2 * gs::kRound + 1);  // the batch, the partials, the masks, s_any
  if (smem > 48 * 1024) {  // above the default limit only on request
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  composite_bwd<PPT><<<num_tiles, 32 * nwarps, smem, s>>>(
      rec, rec_stride, bounds, ox, oy, reinterpret_cast<const float4*>(out),
      reinterpret_cast<const float4*>(gout), drec, grid, num_tiles, pw, ph, chunk, alpha_min,
      alpha_max, thresh, ln_alpha_min);
  return cudaGetLastError();
}

}  // namespace

// rec: (9, rec_stride) f32 sorted record fields; bounds (T+1,) int32;
// ox, oy (T,) int32 tile pixel origins; out, gout (T, pw * ph, 4) f32: the
// forward's output and its cotangent; drec (9, rec_stride) f32: the record
// cotangents, every column written; ln_alpha_min as for the forward.
extern "C" int gs_composite_bwd(const float* rec, int rec_stride, const int32_t* bounds,
                                const int32_t* ox, const int32_t* oy, const float* out,
                                const float* gout, float* drec, int num_tiles, int pw, int ph,
                                int chunk, float alpha_min, float alpha_max, float thresh,
                                float ln_alpha_min, void* stream) {
  if (num_tiles <= 0) return 0;
  if (pw <= 0 || ph <= 0 || pw * ph > gs::kMaxPixels || chunk <= 0 || chunk > gs::kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const gs::PatchGrid grid = gs::patch_grid(pw, ph);
  int ppt = 1;
  while (ppt < 4 && grid.pax * ((grid.pay + ppt - 1) / ppt) > kMaxWarps) ppt *= 2;
  const int nwarps = grid.pax * ((grid.pay + ppt - 1) / ppt);
  if (nwarps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  // a batch holds at least one record a thread: a staging pass examines one
  // record a thread, as far as the batch has free slots
  chunk = chunk > 32 * nwarps ? chunk : 32 * nwarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ppt == 1)
    err = launch<1>(rec, rec_stride, bounds, ox, oy, out, gout, drec, grid, nwarps, num_tiles, pw, ph, chunk, alpha_min, alpha_max, thresh, ln_alpha_min, s);
  else if (ppt == 2)
    err = launch<2>(rec, rec_stride, bounds, ox, oy, out, gout, drec, grid, nwarps, num_tiles, pw, ph, chunk, alpha_min, alpha_max, thresh, ln_alpha_min, s);
  else
    err = launch<4>(rec, rec_stride, bounds, ox, oy, out, gout, drec, grid, nwarps, num_tiles, pw, ph, chunk, alpha_min, alpha_max, thresh, ln_alpha_min, s);
  return static_cast<int>(err);
}
