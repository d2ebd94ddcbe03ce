// What the compositor's forward (composite.cu) and backward
// (composite_bwd.cu) share. The backward keeps no per-record state from the
// forward: it recomputes each pixel's alpha and transmittance, and must
// take the forward's keep and include decisions to the last ulp, because a
// flipped borderline record shifts the transmittance of every later record
// of the tile. So the arithmetic of one (pixel, record) step lives here
// once, and both kernels build with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int kThreads = 256;       // threads a block; one block per tile
constexpr int kMaxPixels = 8 * kThreads;
constexpr int kMaxChunk = 1024;

// A record as the pixel loop needs it: the scaled Cholesky ("sos") factors
// of the conic, with power(px, py) = -(u^2 + v^2),
//   u = s11 * px + (s12 * py + u0),  v = s22 * py + v0,
// px, py tile-local. mxl, myl are the tile-local centre.
struct RecordFactors {
  float s11, s12, s22, u0, v0, mxl, myl;
};

__device__ __forceinline__ RecordFactors record_factors(float mx, float my, float ca,
                                                        float cb, float cc, float oxf,
                                                        float oyf) {
  RecordFactors f;
  f.mxl = mx - oxf;
  f.myl = my - oyf;
  f.s11 = sqrtf(fmaxf(ca * 0.5f, 0.0f));
  f.s12 = (cb * 0.5f) / fmaxf(f.s11, 1e-20f);
  f.s22 = sqrtf(fmaxf(cc * 0.5f - f.s12 * f.s12, 0.0f));
  f.u0 = -(f.s11 * f.mxl + f.s12 * f.myl);
  f.v0 = -(f.s22 * f.myl);
  return f;
}

// exp(power) * op at tile-local pixel (fx, fy), before the alpha_max clamp.
__device__ __forceinline__ float alpha_unclamped(float s11, float s12, float s22, float u0,
                                                 float v0, float op, float fx, float fy) {
  const float u = s11 * fx + (s12 * fy + u0);
  const float v = s22 * fy + v0;
  const float power = -(u * u + v * v);
  return expf(power) * op;
}

}  // namespace gs
