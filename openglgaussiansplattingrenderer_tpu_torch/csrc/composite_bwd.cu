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
// Bound on the card: arithmetic. Every (pixel, record) pair until the
//           pixel saturates costs the forward's expf and blend again plus
//           the gradient terms (about 45 float operations where the record
//           contributes), and every record a reduction of nine sums over
//           the tile's pixels; memory is 36 bytes read and 36 written a
//           record, and 32 bytes a pixel.
// Design:   one block per tile with the forward's thread-to-pixel mapping,
//           records staged through shared memory in batches of `chunk`
//           with the forward's per-record factors. The only residual is
//           the forward's output: each thread walks its pixels front to
//           back again, carrying the transmittance T and D, the cotangent-
//           weighted colour still to come (g_rgb . R_total less the
//           weighted colours so far), and repeats the forward's keep and
//           include decisions exactly (composite_common.cuh, --fmad=false).
//           Per record the nine partial sums (dpower and its first and
//           second moments in tile-local dx, dy; the blend weight times
//           g_rgb) are reduced over each warp by shuffles, skipped where
//           no lane of the warp touched the record, and stored per warp;
//           after every kSub records warp 0 adds the per-warp partials in
//           a fixed order, turns the moments into the field gradients and
//           writes them, while the other warps go on (the partials are
//           double-buffered). No atomics: the result is the same from run
//           to run. Batches behind a saturated tile are left untouched, so
//           the caller hands in a zeroed drec.

#include "composite_common.cuh"

namespace {

using gs::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kStaged = 11;  // rows of `chunk` floats staged per batch
constexpr int kSums = 9;
constexpr int kSub = 32;     // records between two finalisations (one a lane)
constexpr unsigned kFull = 0xffffffffu;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_bwd(const float* __restrict__ rec, int rec_stride,   // (9, rec_stride)
              const int32_t* __restrict__ bounds,              // (T + 1,)
              const int32_t* __restrict__ ox, const int32_t* __restrict__ oy,
              const float4* __restrict__ out,                  // (T, p) forward output
              const float4* __restrict__ gout,                 // (T, p) its cotangent
              float* __restrict__ drec,                        // (9, rec_stride), zeroed
              int pw, int p, int chunk, float alpha_min, float alpha_max,
              float thresh) {
  extern __shared__ float sm[];
  float* s_s11 = sm;
  float* s_s12 = sm + chunk;
  float* s_s22 = sm + 2 * chunk;
  float* s_u0 = sm + 3 * chunk;
  float* s_v0 = sm + 4 * chunk;
  float* s_op = sm + 5 * chunk;
  float* s_r = sm + 6 * chunk;
  float* s_g = sm + 7 * chunk;
  float* s_b = sm + 8 * chunk;
  float* s_mxl = sm + 9 * chunk;
  float* s_myl = sm + 10 * chunk;
  float* s_part = sm + kStaged * chunk;  // [2][kWarps][kSums][kSub]

  const int t = blockIdx.x;
  const int b0 = bounds[t];
  const int b1 = bounds[t + 1];
  const float oxf = (float)ox[t];
  const float oyf = (float)oy[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float T[PPT], D[PPT], gr[PPT], gg[PPT], gb[PPT], gtt[PPT], fx[PPT], fy[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    fx[i] = (float)(pix % pw);
    fy[i] = (float)(pix / pw);
    if (pix < p) {
      const float4 gv = gout[(size_t)t * p + pix];
      const float4 ov = out[(size_t)t * p + pix];
      T[i] = 1.0f;
      gr[i] = gv.x;
      gg[i] = gv.y;
      gb[i] = gv.z;
      D[i] = gv.x * ov.x + gv.y * ov.y + gv.z * ov.z;
      gtt[i] = gv.w * ov.w;  // g_T * T_fin
    } else {
      T[i] = 0.0f;  // pixels past p are never alive
      gr[i] = gg[i] = gb[i] = D[i] = gtt[i] = 0.0f;
    }
  }

  int sub = 0;  // finalisations so far: picks the partials buffer
  for (int base = b0; base < b1; base += chunk) {
    const int m = min(chunk, b1 - base);
    __syncthreads();  // the previous batch has been consumed
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const int idx = base + k;
      const gs::RecordFactors f = gs::record_factors(
          rec[idx], rec[rec_stride + idx], rec[2 * rec_stride + idx],
          rec[3 * rec_stride + idx], rec[4 * rec_stride + idx], oxf, oyf);
      s_s11[k] = f.s11;
      s_s12[k] = f.s12;
      s_s22[k] = f.s22;
      s_u0[k] = f.u0;
      s_v0[k] = f.v0;
      s_mxl[k] = f.mxl;
      s_myl[k] = f.myl;
      s_op[k] = rec[5 * rec_stride + idx];
      s_r[k] = rec[6 * rec_stride + idx];
      s_g[k] = rec[7 * rec_stride + idx];
      s_b[k] = rec[8 * rec_stride + idx];
    }
    __syncthreads();
    for (int k0 = 0; k0 < m; k0 += kSub, ++sub) {
      const int ms = min(kSub, m - k0);
      float* part = s_part + (sub & 1) * (kWarps * kSums * kSub);
      for (int kk = 0; kk < ms; ++kk) {
        const int k = k0 + kk;
        const float s11 = s_s11[k], s12 = s_s12[k], s22 = s_s22[k];
        const float u0 = s_u0[k], v0 = s_v0[k], op = s_op[k];
        const float cr = s_r[k], cg = s_g[k], cb = s_b[k];
        const float mxl = s_mxl[k], myl = s_myl[k];
        float acc[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) acc[j] = 0.0f;
        bool touched = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          if (T[i] > thresh) {
            const float alpha_pre =
                gs::alpha_unclamped(s11, s12, s22, u0, v0, op, fx[i], fy[i]);
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
                const float dx = fx[i] - mxl;
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
        float* dst = part + (warp * kSums) * kSub + kk;
        if (__any_sync(kFull, touched)) {
#pragma unroll
          for (int j = 0; j < kSums; ++j) {
            float v = acc[j];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
            if (lane == 0) dst[j * kSub] = v;
          }
        } else if (lane < kSums) {
          dst[lane * kSub] = 0.0f;
        }
      }
      __syncthreads();  // this sub-batch's partials are complete
      if (warp == 0 && lane < ms) {
        float s[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) {
          float v = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v += part[(w * kSums + j) * kSub + lane];
          s[j] = v;
        }
        const int idx = base + k0 + lane;
        const float ca = rec[2 * rec_stride + idx];
        const float cbn = rec[3 * rec_stride + idx];
        const float cc = rec[4 * rec_stride + idx];
        const float op = rec[5 * rec_stride + idx];
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
    }
    int alive = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) alive |= T[i] > thresh;
    if (!__syncthreads_or(alive)) break;
  }
}

size_t shared_bytes(int chunk) {
  return sizeof(float) * ((size_t)kStaged * chunk + 2 * kWarps * kSums * kSub);
}

template <int PPT>
cudaError_t launch(const float* rec, int rec_stride, const int32_t* bounds, const int32_t* ox,
                   const int32_t* oy, const float* out, const float* gout, float* drec,
                   int num_tiles, int pw, int p, int chunk, float alpha_min, float alpha_max,
                   float thresh, cudaStream_t s) {
  const size_t smem = shared_bytes(chunk);
  if (smem > 48 * 1024) {  // above the default limit only on request
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  composite_bwd<PPT><<<num_tiles, kThreads, smem, s>>>(
      rec, rec_stride, bounds, ox, oy, reinterpret_cast<const float4*>(out),
      reinterpret_cast<const float4*>(gout), drec, pw, p, chunk, alpha_min, alpha_max,
      thresh);
  return cudaGetLastError();
}

}  // namespace

// rec: (9, rec_stride) f32 sorted record fields; bounds (T+1,) int32;
// ox, oy (T,) int32 tile pixel origins; out, gout (T, p, 4) f32: the
// forward's output and its cotangent; drec (9, rec_stride) f32, zeroed by
// the caller: the record cotangents.
extern "C" int gs_composite_bwd(const float* rec, int rec_stride, const int32_t* bounds,
                                const int32_t* ox, const int32_t* oy, const float* out,
                                const float* gout, float* drec, int num_tiles, int pw, int p,
                                int chunk, float alpha_min, float alpha_max, float thresh,
                                void* stream) {
  if (num_tiles <= 0) return 0;
  if (p <= 0 || p > gs::kMaxPixels || chunk <= 0 || chunk > gs::kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (p + kThreads - 1) / kThreads;
  cudaError_t err;
  if (ppt <= 1)
    err = launch<1>(rec, rec_stride, bounds, ox, oy, out, gout, drec, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  else if (ppt <= 2)
    err = launch<2>(rec, rec_stride, bounds, ox, oy, out, gout, drec, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  else if (ppt <= 4)
    err = launch<4>(rec, rec_stride, bounds, ox, oy, out, gout, drec, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  else
    err = launch<8>(rec, rec_stride, bounds, ox, oy, out, gout, drec, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  return static_cast<int>(err);
}
