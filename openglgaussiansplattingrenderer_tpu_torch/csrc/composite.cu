// Tile compositor forward: front-to-back blending of (tile, depth)-sorted
// records, for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/composite.py
//           _fwd_kernel (one sequential grid step per tile; (pixels, chunk)
//           vector blocks with a Hillis-Steele cumprod of 1 - alpha).
// Bound on the card: arithmetic. Every (pixel, record) pair until the
//           pixel saturates costs an expf and ~12 other float operations,
//           while a record costs 36 bytes of memory read once per tile.
// Design:   one block per tile, 256 threads, each thread owning PPT pixels
//           of the tile (P = 1024 at 32x32 px tiles -> 4 pixels a thread).
//           Records stream through shared memory in batches of `chunk`,
//           as in the reference's draw.glsl; the loading thread turns each
//           record into the TPU kernel's scaled Cholesky ("sos") factors
//           once, so a pair costs u, v, -(u^2 + v^2), expf and the blend.
//           Each pixel blends sequentially and stops at the first record
//           whose preceding transmittance is <= 1 - saturation (draw.glsl's
//           break). The block leaves its record loop once no pixel of the
//           tile is alive (__syncthreads_or after each batch). Built with
//           --fmad=false: the power is rounded as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 9;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_fwd(const float* __restrict__ rec, int rec_stride,   // (9, rec_stride)
              const int32_t* __restrict__ bounds,              // (T + 1,)
              const int32_t* __restrict__ ox, const int32_t* __restrict__ oy,
              float* __restrict__ out,                         // (T, p, 4)
              int pw, int p, int chunk, float alpha_min, float alpha_max,
              float thresh) {
  extern __shared__ float sm[];  // kFields rows of `chunk` floats
  float* s_s11 = sm;
  float* s_s12 = sm + chunk;
  float* s_s22 = sm + 2 * chunk;
  float* s_u0 = sm + 3 * chunk;
  float* s_v0 = sm + 4 * chunk;
  float* s_op = sm + 5 * chunk;
  float* s_r = sm + 6 * chunk;
  float* s_g = sm + 7 * chunk;
  float* s_b = sm + 8 * chunk;

  const int t = blockIdx.x;
  const int b0 = bounds[t];
  const int b1 = bounds[t + 1];
  const float oxf = (float)ox[t];
  const float oyf = (float)oy[t];

  float T[PPT], cr[PPT], cg[PPT], cb[PPT], fx[PPT], fy[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    T[i] = pix < p ? 1.0f : 0.0f;  // pixels past p are never alive
    cr[i] = cg[i] = cb[i] = 0.0f;
    fx[i] = (float)(pix % pw);
    fy[i] = (float)(pix / pw);
  }

  for (int base = b0; base < b1; base += chunk) {
    const int m = min(chunk, b1 - base);
    __syncthreads();  // the previous batch has been consumed
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const int idx = base + k;
      const float mxl = rec[idx] - oxf;
      const float myl = rec[rec_stride + idx] - oyf;
      const float ca = rec[2 * rec_stride + idx];
      const float cbn = rec[3 * rec_stride + idx];
      const float cc = rec[4 * rec_stride + idx];
      const float s11 = sqrtf(fmaxf(ca * 0.5f, 0.0f));
      const float s12 = (cbn * 0.5f) / fmaxf(s11, 1e-20f);
      const float s22 = sqrtf(fmaxf(cc * 0.5f - s12 * s12, 0.0f));
      s_s11[k] = s11;
      s_s12[k] = s12;
      s_s22[k] = s22;
      s_u0[k] = -(s11 * mxl + s12 * myl);
      s_v0[k] = -(s22 * myl);
      s_op[k] = rec[5 * rec_stride + idx];
      s_r[k] = rec[6 * rec_stride + idx];
      s_g[k] = rec[7 * rec_stride + idx];
      s_b[k] = rec[8 * rec_stride + idx];
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float s11 = s_s11[k], s12 = s_s12[k], s22 = s_s22[k];
      const float u0 = s_u0[k], v0 = s_v0[k], op = s_op[k];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (T[i] > thresh) {
          const float u = s11 * fx[i] + (s12 * fy[i] + u0);
          const float v = s22 * fy[i] + v0;
          const float power = -(u * u + v * v);
          const float alpha = fminf(alpha_max, expf(power) * op);
          if (alpha >= alpha_min) {
            const float w = alpha * T[i];
            cr[i] += w * s_r[k];
            cg[i] += w * s_g[k];
            cb[i] += w * s_b[k];
            T[i] = T[i] * (1.0f - alpha);
          }
        }
      }
    }
    int alive = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) alive |= T[i] > thresh;
    if (!__syncthreads_or(alive)) break;
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    if (pix < p) {
      float4 o = make_float4(cr[i], cg[i], cb[i], T[i]);
      reinterpret_cast<float4*>(out)[(size_t)t * p + pix] = o;
    }
  }
}

template <int PPT>
void launch(const float* rec, int rec_stride, const int32_t* bounds, const int32_t* ox,
            const int32_t* oy, float* out, int num_tiles, int pw, int p, int chunk,
            float alpha_min, float alpha_max, float thresh, cudaStream_t s) {
  const size_t smem = sizeof(float) * kFields * chunk;
  composite_fwd<PPT><<<num_tiles, kThreads, smem, s>>>(
      rec, rec_stride, bounds, ox, oy, out, pw, p, chunk, alpha_min, alpha_max, thresh);
}

}  // namespace

extern "C" int gs_composite_max_pixels() { return 8 * kThreads; }

// rec: (9, rec_stride) f32 sorted record fields; bounds (T+1,) int32;
// ox, oy (T,) int32 tile pixel origins; out (T, p, 4) f32. chunk <= 1024
// keeps the batch within the default 48 KB of shared memory.
extern "C" int gs_composite_fwd(const float* rec, int rec_stride, const int32_t* bounds,
                                const int32_t* ox, const int32_t* oy, float* out,
                                int num_tiles, int pw, int p, int chunk, float alpha_min,
                                float alpha_max, float thresh, void* stream) {
  if (num_tiles <= 0) return 0;
  if (p <= 0 || p > 8 * kThreads || chunk <= 0 || chunk > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (p + kThreads - 1) / kThreads;
  if (ppt <= 1)
    launch<1>(rec, rec_stride, bounds, ox, oy, out, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  else if (ppt <= 2)
    launch<2>(rec, rec_stride, bounds, ox, oy, out, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  else if (ppt <= 4)
    launch<4>(rec, rec_stride, bounds, ox, oy, out, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  else
    launch<8>(rec, rec_stride, bounds, ox, oy, out, num_tiles, pw, p, chunk, alpha_min, alpha_max, thresh, s);
  return static_cast<int>(cudaGetLastError());
}
