// The splat table: preprocess, 3-D covariance, SH colour and tile rect of
// every splat in one pass (gs_splat_table), and its analytic backward
// (gs_splat_table_bwd), for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package computes this stage inside
//           jax.jit (render.py _render_jit, train/trainer.py's step), where
//           XLA fuses openglgaussiansplattingrenderer_tpu/ops/projection.py
//           preprocess (42-201), ops/transforms.py build_covariance (67-90)
//           and eval_sh (135-170), render.py effective_colors (39) and the
//           table rows of ops/fastpath.py (116-191) into a few kernels,
//           forward and backward. Its plain version is
//           ops/kernels/table.py splat_table_plain (projection.preprocess
//           and the field stack in torch, ~170 small kernels) and
//           splat_table_bwd_plain (the same analytic backward in torch).
// Bound on the card: bytes. Forward, a splat: means 12 B, cov6 24 (or
//           scales 12 + quats 16), opacity 4, colours 12 in (+ shift2d 8,
//           + sh_rest 180 at SH-3); fields 36, tile_min 8, tile_ext 8,
//           counts 4, depth 4, raw depth 4, radius 4, valid and culled 2
//           out (+ the unshifted mean2d 8 with shift2d): 122-126 B, ~0.44
//           GB at 3,616,103 splats, 0.13 ms at 3.35 TB/s (SH-3 ~1.09 GB,
//           0.33 ms). Backward: the inputs again but the colours, the 9
//           cotangents, the gradients (means 12, cov6 24 or scales +
//           quats 28, opacity 4, colours 12, + sh_rest 180): ~136-148 B
//           (~500 B at SH-3). A few hundred float operations a splat
//           (SH-3: ~400 more) stay far under the byte time at 67 TFLOP/s.
//           chip_smoke.py computes both bounds from the call's arguments.
// Design:   one thread a splat, 128 a block; the frame's two matrices
//           (and the camera centre) go through shared memory once a block.
//           Every float expression is written in the plain version's
//           operation order and the library builds with --fmad=false, so
//           the fields round as torch's one-operation-a-kernel code does on
//           the card; where torch divides a CUDA tensor by a Python scalar
//           it multiplies by the scalar's reciprocal, taken in double and
//           rounded to float, and so does this kernel. The integer
//           outputs copy XLA's saturating f32 -> i32 conversion
//           (projection._to_i32). sh_rest rows (3 K floats a splat,
//           channel-major) are 180 B at SH-3, so a thread-per-splat read
//           would touch 32 lines a warp load: each warp stages its 32 rows
//           through shared memory with coalesced loads, and the backward
//           stores its sh_rest gradients the same way. No atomics: a
//           thread owns its splat's rows. The backward keeps no state from
//           the forward: it recomputes the projection from the saved
//           inputs, as composite_bwd.cu recomputes transmittance.
//           Derivatives follow torch autograd's conventions, which the
//           plain version meets: maximum/minimum split a tie's gradient in
//           halves, clamp_min passes it where x >= the bound, torch.where
//           gives the branch taken, ceil (radius), the detached tight-rect
//           half-extents, counts and depth give none, and a row whose nine
//           cotangents (and mean2d cotangents) are all zero gets zero
//           gradients, even where autograd's 0 * inf would give NaN.
//           Where `pairs` is given (the default frame's record sort stage)
//           the forward also stores the nine fields in the stage's pair
//           layout (record_gather.cu): fields 0-7 as four (n + 1, 2) arrays
//           of 8-byte pairs, field 8 as an (n + 1,) array, row n zero (by
//           thread 0), 36 B a splat more: the stage reads a sorted record's
//           fields as five sectors from arrays of 29 MB at the flagship,
//           which L2 holds, where field rows cost nine.

#include <cuda_runtime.h>
#include <stdint.h>

// The frame's scalars. ops/kernels/table.py TableArgs mirrors the layout;
// gs_table_args_size lets it check.
namespace gs {

struct TableArgs {
  float width, height;               // float(width), float(height)
  float focal_x, focal_y;
  float tan_fovx, tan_fovy;
  float neg_fov_margin;              // float(-cfg.fov_margin)
  float w_eps, dilation, eig_floor, radius_sigma, alpha_min;
  // torch divides a CUDA tensor by a Python scalar as a product with the
  // scalar's reciprocal, taken in double and rounded to float: these are
  // 1 / tile_w, 1 / tile_h (the rect's divisors), 1 / alpha_min and
  // 1 / color_scale so taken
  float inv_tile_w, inv_tile_h, inv_alpha_min, inv_color_scale;
  float color_scale;
  int gx, gy;
  int antialiased, tight_rect;
  int sh_degree;                     // 0: the colours as given
  int sh_row;                        // floats of sh_rest a splat, 3 K
};

}  // namespace gs

namespace {

using gs::TableArgs;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kShRowMax = 45;        // sh_rest floats a splat, at most (SH-3)
constexpr int kCam = 35;             // view (16), vp (16), camera centre (3)

// transforms.py's SH constants, rounded as torch rounds a Python float
__device__ __constant__ float kC0 = (float)0.28209479177387814;
__device__ __constant__ float kInvC0 = (float)(1.0 / 0.28209479177387814);
__device__ __constant__ float kC1 = (float)0.4886025119029199;
__device__ __constant__ float kC2[5] = {
    (float)1.0925484305920792, (float)-1.0925484305920792, (float)0.31539156525252005,
    (float)-1.0925484305920792, (float)0.5462742152960396};
__device__ __constant__ float kC3[7] = {
    (float)-0.5900435899266435, (float)2.890611442640554, (float)-0.4570457994644658,
    (float)0.3731763325901154, (float)-0.4570457994644658, (float)1.445305721320277,
    (float)-0.5900435899266435};

// torch's elementwise semantics on the card: maximum and minimum return a
// NaN operand, clamp_min keeps a NaN x.
__device__ __forceinline__ float t_maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// projection._to_i32: NaN -> 0, clamp to +-(2^31 - 128), truncate
__device__ __forceinline__ int to_i32(float x) {
  const float lim = 2147483520.0f;
  x = x != x ? 0.0f : fminf(fmaxf(x, -lim), lim);
  return static_cast<int>(x);
}

__device__ __forceinline__ int clamp_tile(int v, int hi) { return min(max(v, 0), hi); }

// transforms.quat_to_rotmat's rows, the factors build_covariance scales
__device__ __forceinline__ void rotation(const float q[4], float R[3][3]) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  R[0][1] = 2.0f * (x * y - r * z);
  R[0][2] = 2.0f * (x * z + r * y);
  R[1][0] = 2.0f * (x * y + r * z);
  R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  R[1][2] = 2.0f * (y * z - r * x);
  R[2][0] = 2.0f * (x * z - r * y);
  R[2][1] = 2.0f * (y * z + r * x);
  R[2][2] = 1.0f - 2.0f * (x * x + y * y);
}

// build_covariance: M = R diag(s), Sigma = M M^T packed (xx, xy, xz, yy, yz, zz)
__device__ __forceinline__ void covariance(const float R[3][3], const float s[3],
                                           float M[3][3], float cov[6]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) M[i][k] = R[i][k] * s[k];
  const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int p = 0; p < 6; ++p)
    cov[p] = M[pi[p]][0] * M[pj[p]][0] + M[pi[p]][1] * M[pj[p]][1] +
             M[pi[p]][2] * M[pj[p]][2];
}

// transforms.covariance_quadratic_form, u^T Sigma v
__device__ __forceinline__ float quad(const float c[6], const float u[3], const float v[3]) {
  return c[0] * u[0] * v[0] + c[3] * u[1] * v[1] + c[5] * u[2] * v[2] +
         c[1] * (u[0] * v[1] + u[1] * v[0]) + c[2] * (u[0] * v[2] + u[2] * v[0]) +
         c[4] * (u[1] * v[2] + u[2] * v[1]);
}

// What projection.preprocess computes of a splat before its opacity, and
// what the backward needs of it.
struct Proj {
  float p[4];        // vp @ mean
  float w;           // clamp_min(p3, w_eps)
  float ndc[3];
  float t[3];        // view @ mean
  float txtz, tytz;  // t0 / tz, t1 / tz
  float mx, my;      // maximum(-lim, t / tz), the fov clamp's inner step
  float cx, cy;      // the fov clamp: tx = cx * tz
  float inv_tz;
  float u0[3], u1[3];
  float a2d, b2d, c2d, det, inv_det;
  float sx, sy;
  bool culled, valid;
};

__device__ __forceinline__ void project(const TableArgs& a, const float* cam,
                                        const float m[3], const float cov[6], Proj& o) {
  const float* V = cam;
  const float* VP = cam + 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o.p[j] = m[0] * VP[4 * j] + m[1] * VP[4 * j + 1] + m[2] * VP[4 * j + 2] + VP[4 * j + 3];
  o.w = t_clamp_min(o.p[3], a.w_eps);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.ndc[k] = o.p[k] / o.w;
  o.culled = fabsf(o.ndc[0]) > 1.0f || fabsf(o.ndc[1]) > 1.0f;
  o.sx = (o.ndc[0] + 1.0f) * 0.5f * a.width;
  o.sy = (o.ndc[1] + 1.0f) * 0.5f * a.height;

#pragma unroll
  for (int j = 0; j < 3; ++j)
    o.t[j] = m[0] * V[4 * j] + m[1] * V[4 * j + 1] + m[2] * V[4 * j + 2] + V[4 * j + 3];
  const float tz = o.t[2];
  // the reference's quirk, verbatim: lim = -margin * tanFov and the clamp
  // min(lim, max(-lim, x))
  const float limx = a.neg_fov_margin * a.tan_fovx;
  const float limy = a.neg_fov_margin * a.tan_fovy;
  o.txtz = o.t[0] / tz;
  o.tytz = o.t[1] / tz;
  o.mx = t_maximum(-limx, o.txtz);
  o.my = t_maximum(-limy, o.tytz);
  o.cx = t_minimum(limx, o.mx);
  o.cy = t_minimum(limy, o.my);
  const float tx = o.cx * tz;
  const float ty = o.cy * tz;

  o.inv_tz = 1.0f / tz;
  const float al0 = a.focal_x * o.inv_tz;
  const float be0 = a.focal_x * tx * o.inv_tz * o.inv_tz;
  const float al1 = a.focal_y * o.inv_tz;
  const float be1 = a.focal_y * ty * o.inv_tz * o.inv_tz;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.u0[k] = al0 * V[k] - be0 * V[8 + k];
    o.u1[k] = al1 * V[4 + k] - be1 * V[8 + k];
  }
  o.a2d = quad(cov, o.u0, o.u0) + a.dilation;
  o.b2d = quad(cov, o.u0, o.u1);
  o.c2d = quad(cov, o.u1, o.u1) + a.dilation;
  o.det = o.a2d * o.c2d - o.b2d * o.b2d;
  const bool degenerate =
      o.det == 0.0f || !isfinite(o.det) || !isfinite(o.sx) || !isfinite(o.sy);
  o.valid = !o.culled && !degenerate;
  o.inv_det = 1.0f / (o.det == 0.0f ? 1.0f : o.det);
}

// The splat's covariance from cov6 or from scales and quats; M and R are
// filled on the second route only.
__device__ __forceinline__ void load_covariance(const float* __restrict__ cov6,
                                                const float* __restrict__ scales,
                                                const float* __restrict__ quats, long long i,
                                                float cov[6], float s[3], float q[4],
                                                float R[3][3], float M[3][3]) {
  if (cov6 != nullptr) {
#pragma unroll
    for (int p = 0; p < 6; ++p) cov[p] = cov6[6 * i + p];
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = scales[3 * i + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = quats[4 * i + k];
  rotation(q, R);
  covariance(R, s, M, cov);
}

// render.effective_colors' unit direction from the camera centre; torch's
// vector_norm over three values sums (x^2 + z^2) + y^2 on the card
__device__ __forceinline__ void view_dir(const float* cam, const float m[3], float dv[3],
                                         float& n, float& nc, float dir[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) dv[k] = m[k] - cam[32 + k];
  n = sqrtf((dv[0] * dv[0] + dv[2] * dv[2]) + dv[1] * dv[1]);
  nc = t_clamp_min(n, (float)1e-12);
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = dv[k] / nc;
}

// transforms.eval_sh of one channel: the SH sum c (before (0.5 + c) *
// scale) from the DC term and the channel's K coefficients sh[0..K)
__device__ __forceinline__ float sh_sum(int degree, float c, const float* sh,
                                        const float d[3]) {
  const float x = d[0], y = d[1], z = d[2];
  if (degree >= 1) c = c - kC1 * y * sh[0] + kC1 * z * sh[1] - kC1 * x * sh[2];
  if (degree >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    c = c + kC2[0] * xy * sh[3] + kC2[1] * yz * sh[4] +
        kC2[2] * (2.0f * zz - xx - yy) * sh[5] + kC2[3] * xz * sh[6] +
        kC2[4] * (xx - yy) * sh[7];
    if (degree >= 3)
      c = c + kC3[0] * y * (3.0f * xx - yy) * sh[8] + kC3[1] * xy * z * sh[9] +
          kC3[2] * y * (4.0f * zz - xx - yy) * sh[10] +
          kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy) * sh[11] +
          kC3[4] * x * (4.0f * zz - xx - yy) * sh[12] + kC3[5] * z * (xx - yy) * sh[13] +
          kC3[6] * x * (xx - 3.0f * yy) * sh[14];
  }
  return c;
}

// Coefficient k's factor in eval_sh at d, and its gradient; zero past the
// degree. Called with k known at compile time, so the switch folds.
__device__ __forceinline__ void sh_basis(int k, int degree, const float d[3], float& b,
                                         float g[3]) {
  const float x = d[0], y = d[1], z = d[2];
  const float xx = x * x, yy = y * y, zz = z * z;
  b = 0.0f;
  g[0] = g[1] = g[2] = 0.0f;
  if (k >= (degree >= 3 ? 15 : (degree == 2 ? 8 : (degree == 1 ? 3 : 0)))) return;
  switch (k) {
    case 0: b = -kC1 * y; g[1] = -kC1; break;
    case 1: b = kC1 * z; g[2] = kC1; break;
    case 2: b = -kC1 * x; g[0] = -kC1; break;
    case 3: b = kC2[0] * x * y; g[0] = kC2[0] * y; g[1] = kC2[0] * x; break;
    case 4: b = kC2[1] * y * z; g[1] = kC2[1] * z; g[2] = kC2[1] * y; break;
    case 5:
      b = kC2[2] * (2.0f * zz - xx - yy);
      g[0] = -2.0f * kC2[2] * x; g[1] = -2.0f * kC2[2] * y; g[2] = 4.0f * kC2[2] * z;
      break;
    case 6: b = kC2[3] * x * z; g[0] = kC2[3] * z; g[2] = kC2[3] * x; break;
    case 7: b = kC2[4] * (xx - yy); g[0] = 2.0f * kC2[4] * x; g[1] = -2.0f * kC2[4] * y; break;
    case 8:
      b = kC3[0] * y * (3.0f * xx - yy);
      g[0] = kC3[0] * 6.0f * x * y; g[1] = kC3[0] * (3.0f * xx - 3.0f * yy);
      break;
    case 9:
      b = kC3[1] * x * y * z;
      g[0] = kC3[1] * y * z; g[1] = kC3[1] * x * z; g[2] = kC3[1] * x * y;
      break;
    case 10:
      b = kC3[2] * y * (4.0f * zz - xx - yy);
      g[0] = kC3[2] * -2.0f * x * y; g[1] = kC3[2] * (4.0f * zz - xx - 3.0f * yy);
      g[2] = kC3[2] * 8.0f * y * z;
      break;
    case 11:
      b = kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      g[0] = kC3[3] * -6.0f * x * z; g[1] = kC3[3] * -6.0f * y * z;
      g[2] = kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      break;
    case 12:
      b = kC3[4] * x * (4.0f * zz - xx - yy);
      g[0] = kC3[4] * (4.0f * zz - 3.0f * xx - yy); g[1] = kC3[4] * -2.0f * x * y;
      g[2] = kC3[4] * 8.0f * x * z;
      break;
    case 13:
      b = kC3[5] * z * (xx - yy);
      g[0] = kC3[5] * 2.0f * x * z; g[1] = kC3[5] * -2.0f * y * z; g[2] = kC3[5] * (xx - yy);
      break;
    default:
      b = kC3[6] * x * (xx - 3.0f * yy);
      g[0] = kC3[6] * (3.0f * xx - 3.0f * yy); g[1] = kC3[6] * -6.0f * x * y;
      break;
  }
}

// Copies the block's view, vp and camera centre into shared memory.
__device__ __forceinline__ void load_camera(float* s_cam, const float* view,
                                            const float* vp, const float* centre) {
  const int t = threadIdx.x;
  if (t < 16) s_cam[t] = view[t];
  else if (t < 32) s_cam[t] = vp[t - 16];
  else if (t < kCam) s_cam[t] = centre != nullptr ? centre[t - 32] : 0.0f;
  __syncthreads();
}

// The warp's rows [i0, i0 + 32) of a (n, row) array, staged in shared
// memory with coalesced loads; rows past n are not read.
__device__ __forceinline__ void stage_rows(float* slab, const float* __restrict__ src,
                                           long long i0, long long n, int row, int lane) {
  const long long rows = n - i0 < 32 ? n - i0 : 32;
  const int count = rows > 0 ? static_cast<int>(rows) * row : 0;
  const float* base = src + i0 * row;
  for (int k = lane; k < count; k += 32) slab[k] = base[k];
  __syncwarp();
}

__device__ __forceinline__ void flush_rows(const float* slab, float* __restrict__ dst,
                                           long long i0, long long n, int row, int lane) {
  __syncwarp();
  const long long rows = n - i0 < 32 ? n - i0 : 32;
  const int count = rows > 0 ? static_cast<int>(rows) * row : 0;
  float* base = dst + i0 * row;
  for (int k = lane; k < count; k += 32) base[k] = slab[k];
}

__global__ void __launch_bounds__(kThreads)
splat_table_fwd(const float* __restrict__ means, const float* __restrict__ cov6,
                const float* __restrict__ scales, const float* __restrict__ quats,
                const float* __restrict__ opacities, const float* __restrict__ colors,
                const float* __restrict__ sh_rest, const float* __restrict__ shift2d,
                const float* __restrict__ view, const float* __restrict__ vp,
                const float* __restrict__ centre, TableArgs a,
                float* __restrict__ fields, int2* __restrict__ tile_min,
                int2* __restrict__ tile_ext, int32_t* __restrict__ counts,
                float* __restrict__ depth, float* __restrict__ raw_depth,
                float2* __restrict__ mean2d, float* __restrict__ radius_out,
                bool* __restrict__ valid_out, bool* __restrict__ culled_out,
                float* __restrict__ pairs, long long n) {
  __shared__ float s_cam[kCam];
  extern __shared__ float s_sh[];    // kWarps slabs of 32 sh_rest rows, SH only
  load_camera(s_cam, view, vp, centre);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const long long i = i0 + lane;
  float* slab = s_sh + warp * 32 * a.sh_row;
  if (a.sh_degree > 0) stage_rows(slab, sh_rest, i0, n, a.sh_row, lane);
  if (i >= n) return;

  const float m[3] = {means[3 * i], means[3 * i + 1], means[3 * i + 2]};
  float cov[6], s[3], q[4], R[3][3], M[3][3];
  load_covariance(cov6, scales, quats, i, cov, s, q, R, M);
  Proj pr;
  project(a, s_cam, m, cov, pr);

  float op = opacities[i];
  if (a.antialiased) {
    // opacity compensation: sqrt(det before dilation / det after)
    const float det_nodil = (pr.a2d - a.dilation) * (pr.c2d - a.dilation) - pr.b2d * pr.b2d;
    const float comp = sqrtf(t_clamp_min(det_nodil, (float)1e-30) /
                             t_clamp_min(pr.det, (float)1e-30));
    op = op * (pr.valid ? comp : 1.0f);
  }

  // bounding radius via eigenvalues
  const float mid = 0.5f * (pr.a2d + pr.c2d);
  const float lam_max = mid + sqrtf(t_clamp_min(mid * mid - pr.det, a.eig_floor));
  const float radius = ceilf(a.radius_sigma * sqrtf(t_clamp_min(lam_max, 0.0f)));

  // tile rect (the divisions by Python scalars are products with their
  // reciprocals, as torch takes them)
  float rx = radius, ry = radius;
  bool reach = pr.valid;
  if (a.tight_rect) {
    const float lam = logf(t_clamp_min(op, (float)1e-30) * a.inv_alpha_min);
    const float two_l = 2.0f * t_clamp_min(lam, 0.0f);
    rx = t_minimum(radius, sqrtf(two_l * t_clamp_min(pr.a2d, 0.0f)) + (float)1e-3);
    ry = t_minimum(radius, sqrtf(two_l * t_clamp_min(pr.c2d, 0.0f)) + (float)1e-3);
    reach = pr.valid && op >= a.alpha_min;
  }
  const int tmin_x = clamp_tile(to_i32((pr.sx - rx) * a.inv_tile_w), a.gx - 1);
  const int tmax_x = clamp_tile(to_i32((pr.sx + rx) * a.inv_tile_w), a.gx - 1);
  const int tmin_y = clamp_tile(to_i32((pr.sy - ry) * a.inv_tile_h), a.gy - 1);
  const int tmax_y = clamp_tile(to_i32((pr.sy + ry) * a.inv_tile_h), a.gy - 1);
  const int ext_x = tmax_x - tmin_x + 1;
  const int ext_y = tmax_y - tmin_y + 1;

  // colour: the DC colours, or eval_sh along the view direction
  float col[3] = {colors[3 * i], colors[3 * i + 1], colors[3 * i + 2]};
  if (a.sh_degree > 0) {
    float dv[3], nrm, nc, dir[3];
    view_dir(s_cam, m, dv, nrm, nc, dir);
    const int K = a.sh_row / 3;
    const float* row = slab + lane * a.sh_row;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float dc = (col[ch] * a.inv_color_scale - 0.5f) * kInvC0;
      col[ch] = (0.5f + sh_sum(a.sh_degree, kC0 * dc, row + ch * K, dir)) * a.color_scale;
    }
  }

  const float z01 = (pr.ndc[2] + 1.0f) * 0.5f;
  float dz = pr.valid ? z01 : 0.0f;
  dz = isfinite(dz) ? dz : 0.0f;

  float fx = pr.sx, fy = pr.sy;
  if (shift2d != nullptr) {
    mean2d[i] = make_float2(pr.sx, pr.sy);
    fx = fx + shift2d[2 * i];
    fy = fy + shift2d[2 * i + 1];
  }
  const float f[9] = {fx, fy, pr.c2d * pr.inv_det, -pr.b2d * pr.inv_det,
                      pr.a2d * pr.inv_det, op, col[0], col[1], col[2]};
#pragma unroll
  for (int r = 0; r < 9; ++r) fields[r * n + i] = f[r];
  if (pairs != nullptr) {
    const size_t m = (size_t)n + 1;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float2* p = reinterpret_cast<float2*>(pairs + g * m * 2);
      p[i] = make_float2(f[2 * g], f[2 * g + 1]);
      if (i == 0) p[n] = make_float2(0.0f, 0.0f);
    }
    pairs[8 * m + i] = f[8];
    if (i == 0) pairs[8 * m + n] = 0.0f;
  }
  tile_min[i] = make_int2(tmin_x, tmin_y);
  tile_ext[i] = make_int2(ext_x, ext_y);
  counts[i] = reach ? ext_x * ext_y : 0;
  depth[i] = dz;
  raw_depth[i] = z01;
  radius_out[i] = radius;
  valid_out[i] = pr.valid;
  culled_out[i] = pr.culled;
}

__global__ void __launch_bounds__(kThreads)
splat_table_bwd(const float* __restrict__ means, const float* __restrict__ cov6,
                const float* __restrict__ scales, const float* __restrict__ quats,
                const float* __restrict__ opacities, const float* __restrict__ sh_rest,
                const float* __restrict__ view, const float* __restrict__ vp,
                const float* __restrict__ centre, TableArgs a,
                const float* __restrict__ g_fields, const float2* __restrict__ g_mean2d,
                float* __restrict__ g_means, float* __restrict__ g_cov6,
                float* __restrict__ g_scales, float4* __restrict__ g_quats,
                float* __restrict__ g_opacities, float* __restrict__ g_colors,
                float* __restrict__ g_sh, long long n) {
  __shared__ float s_cam[kCam];
  extern __shared__ float s_sh[];
  load_camera(s_cam, view, vp, centre);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const long long i = i0 + lane;
  const bool sh = a.sh_degree > 0;
  float* slab = s_sh + warp * 32 * a.sh_row;
  if (sh) stage_rows(slab, sh_rest, i0, n, a.sh_row, lane);
  if (i0 >= n) return;               // the whole warp is past n
  const bool live = i < n;

  float g[9], gm0 = 0.0f, gm1 = 0.0f;
  bool any = false;
  if (live) {
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      g[r] = g_fields[r * n + i];
      any = any || g[r] != 0.0f;
    }
    if (g_mean2d != nullptr) {
      const float2 gm = g_mean2d[i];
      gm0 = gm.x;
      gm1 = gm.y;
      any = any || gm0 != 0.0f || gm1 != 0.0f;
    }
  }
  float* srow = slab + lane * a.sh_row;

  if (live && !any) {
#pragma unroll
    for (int k = 0; k < 3; ++k) g_means[3 * i + k] = 0.0f;
    if (g_cov6 != nullptr)
#pragma unroll
      for (int p = 0; p < 6; ++p) g_cov6[6 * i + p] = 0.0f;
    if (g_scales != nullptr)
#pragma unroll
      for (int k = 0; k < 3; ++k) g_scales[3 * i + k] = 0.0f;
    if (g_quats != nullptr) g_quats[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    g_opacities[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) g_colors[3 * i + k] = 0.0f;
    if (sh)
      for (int k = 0; k < a.sh_row; ++k) srow[k] = 0.0f;
  } else if (live) {
    const float m[3] = {means[3 * i], means[3 * i + 1], means[3 * i + 2]};
    float cov[6], s[3], q[4], R[3][3], M[3][3];
    load_covariance(cov6, scales, quats, i, cov, s, q, R, M);
    Proj pr;
    project(a, s_cam, m, cov, pr);
    const float op0 = opacities[i];
    const float a2d = pr.a2d, b2d = pr.b2d, c2d = pr.c2d, det = pr.det;

    // cotangents of a2d, b2d, c2d and det
    float gA = 0.0f, gB = 0.0f, gC = 0.0f, gD = 0.0f;
    float g_op0 = g[5];
    if (a.antialiased && pr.valid) {
      const float am = a2d - a.dilation, cm = c2d - a.dilation;
      const float dn = am * cm - b2d * b2d;
      const float num = t_clamp_min(dn, (float)1e-30);
      const float den = t_clamp_min(det, (float)1e-30);
      const float comp = sqrtf(num / den);
      g_op0 = g[5] * comp;
      const float g_ratio = g[5] * op0 / (2.0f * comp);
      const float g_num = g_ratio / den;
      const float g_den = -g_ratio * num / (den * den);
      if (dn >= (float)1e-30) {
        gA += g_num * cm;
        gC += g_num * am;
        gB -= 2.0f * b2d * g_num;
      }
      if (det >= (float)1e-30) gD += g_den;
    }
    // conic = (c2d, -b2d, a2d) * inv_det, inv_det = 1 / where(det == 0, 1, det)
    const float inv = pr.inv_det;
    gC += g[2] * inv;
    gB -= g[3] * inv;
    gA += g[4] * inv;
    const float g_inv = g[2] * c2d - g[3] * b2d + g[4] * a2d;
    if (!(det == 0.0f)) gD -= g_inv * inv * inv;
    // det = a2d c2d - b2d^2
    gA += gD * c2d;
    gC += gD * a2d;
    gB -= 2.0f * gD * b2d;

    // the quadratic forms a2d = u0' S u0, b2d = u0' S u1, c2d = u1' S u1
    float su0[3], su1[3], gu0[3], gu1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int r0 = k == 0 ? 0 : (k == 1 ? 1 : 2);
      const int r1 = k == 0 ? 1 : (k == 1 ? 3 : 4);
      const int r2 = k == 0 ? 2 : (k == 1 ? 4 : 5);
      su0[k] = cov[r0] * pr.u0[0] + cov[r1] * pr.u0[1] + cov[r2] * pr.u0[2];
      su1[k] = cov[r0] * pr.u1[0] + cov[r1] * pr.u1[1] + cov[r2] * pr.u1[2];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gu0[k] = 2.0f * gA * su0[k] + gB * su1[k];
      gu1[k] = 2.0f * gC * su1[k] + gB * su0[k];
    }
    float gcov[6];
    {
      const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        const int u = pi[p], v = pj[p];
        if (u == v)
          gcov[p] = gA * pr.u0[u] * pr.u0[u] + gB * pr.u0[u] * pr.u1[u] +
                    gC * pr.u1[u] * pr.u1[u];
        else
          gcov[p] = 2.0f * gA * pr.u0[u] * pr.u0[v] +
                    gB * (pr.u0[u] * pr.u1[v] + pr.u1[u] * pr.u0[v]) +
                    2.0f * gC * pr.u1[u] * pr.u1[v];
      }
    }

    // u0 = al0 V0 - be0 V2, u1 = al1 V1 - be1 V2
    const float* V = s_cam;
    const float* VP = s_cam + 16;
    float g_al0 = 0.0f, g_be0 = 0.0f, g_al1 = 0.0f, g_be1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_al0 += gu0[k] * V[k];
      g_be0 -= gu0[k] * V[8 + k];
      g_al1 += gu1[k] * V[4 + k];
      g_be1 -= gu1[k] * V[8 + k];
    }
    const float tz = pr.t[2], it = pr.inv_tz;
    const float tx = pr.cx * tz, ty = pr.cy * tz;
    // al = f * it, be = f * t * it * it
    float g_it = g_al0 * a.focal_x + g_al1 * a.focal_y +
                 2.0f * g_be0 * a.focal_x * tx * it + 2.0f * g_be1 * a.focal_y * ty * it;
    const float g_tx = g_be0 * a.focal_x * it * it;
    const float g_ty = g_be1 * a.focal_y * it * it;
    // tx = cx * tz, cx = minimum(lim, maximum(-lim, t0 / tz)); torch splits
    // a tie's gradient in halves
    const float limx = a.neg_fov_margin * a.tan_fovx;
    const float limy = a.neg_fov_margin * a.tan_fovy;
    float g_tz = g_tx * pr.cx + g_ty * pr.cy;
    const float g_mx = limx < pr.mx ? 0.0f : (limx == pr.mx ? 0.5f : 1.0f);
    const float g_my = limy < pr.my ? 0.0f : (limy == pr.my ? 0.5f : 1.0f);
    const float h_x = -limx > pr.txtz ? 0.0f : (-limx == pr.txtz ? 0.5f : 1.0f);
    const float h_y = -limy > pr.tytz ? 0.0f : (-limy == pr.tytz ? 0.5f : 1.0f);
    const float g_txtz = g_tx * tz * g_mx * h_x;
    const float g_tytz = g_ty * tz * g_my * h_y;
    const float g_t0 = g_txtz / tz;
    const float g_t1 = g_tytz / tz;
    g_tz -= g_txtz * pr.t[0] / (tz * tz) + g_tytz * pr.t[1] / (tz * tz);
    g_tz -= g_it * it * it;

    // the screen position: s = ((p / w) + 1) * 0.5 * size, w = clamp_min(p3, w_eps)
    const float g_sx = g[0] + gm0, g_sy = g[1] + gm1;
    const float g_n0 = g_sx * a.width * 0.5f;
    const float g_n1 = g_sy * a.height * 0.5f;
    const float g_p0 = g_n0 / pr.w;
    const float g_p1 = g_n1 / pr.w;
    const float g_w = -(g_n0 * pr.p[0] + g_n1 * pr.p[1]) / (pr.w * pr.w);
    const float g_p3 = pr.p[3] >= a.w_eps ? g_w : 0.0f;

    float gmv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gmv[k] = g_t0 * V[k] + g_t1 * V[4 + k] + g_tz * V[8 + k] + g_p0 * VP[k] +
               g_p1 * VP[4 + k] + g_p3 * VP[12 + k];

    // colours
    float gcol[3] = {g[6], g[7], g[8]};
    if (sh) {
      float dv[3], nrm, nc, dir[3], gc[3];
      view_dir(s_cam, m, dv, nrm, nc, dir);
      const int K = a.sh_row / 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        gc[ch] = g[6 + ch] * a.color_scale;
        gcol[ch] = gc[ch] * kC0 * kInvC0 * a.inv_color_scale;
      }
      // coefficient k of channel ch gets gc[ch] * b_k; the direction gets
      // sum_k (sum_ch gc[ch] coef[ch][k]) grad b_k. k is static, so the
      // basis stays in registers; each slot is read before its gradient
      // takes its place.
      float gd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kShRowMax / 3; ++k) {
        if (k < K) {
          float bk, gk[3], sk = 0.0f;
          sh_basis(k, a.sh_degree, dir, bk, gk);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float* slot = srow + ch * K + k;
            sk += gc[ch] * *slot;
            *slot = gc[ch] * bk;
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) gd[j] += sk * gk[j];
        }
      }
      // dir = dv / clamp_min(|dv|, 1e-12)
      const float gdd = gd[0] * dv[0] + gd[1] * dv[1] + gd[2] * dv[2];
      const float g_nc = -gdd / (nc * nc);
      const float g_n = nrm >= (float)1e-12 ? g_nc : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gmv[k] += gd[k] / nc + (nrm == 0.0f ? 0.0f : g_n * dv[k] / nrm);
    }

#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_means[3 * i + k] = gmv[k];
      g_colors[3 * i + k] = gcol[k];
    }
    g_opacities[i] = g_op0;
    if (g_cov6 != nullptr) {
#pragma unroll
      for (int p = 0; p < 6; ++p) g_cov6[6 * i + p] = gcov[p];
    } else {
      // Sigma = M M^T, M = R diag(s)
      float gM[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gM[0][k] = 2.0f * gcov[0] * M[0][k] + gcov[1] * M[1][k] + gcov[2] * M[2][k];
        gM[1][k] = gcov[1] * M[0][k] + 2.0f * gcov[3] * M[1][k] + gcov[4] * M[2][k];
        gM[2][k] = gcov[2] * M[0][k] + gcov[4] * M[1][k] + 2.0f * gcov[5] * M[2][k];
      }
      float gR[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_scales[3 * i + k] = gM[0][k] * R[0][k] + gM[1][k] * R[1][k] + gM[2][k] * R[2][k];
#pragma unroll
        for (int r = 0; r < 3; ++r) gR[r][k] = gM[r][k] * s[k];
      }
      const float r = q[0], x = q[1], y = q[2], z = q[3];
      const float gr = 2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2] -
                               y * gR[2][0] + x * gR[2][1]);
      const float gx = 2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                               2.0f * x * gR[1][1] - r * gR[1][2] + z * gR[2][0] +
                               r * gR[2][1] - 2.0f * x * gR[2][2]);
      const float gy = 2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + r * gR[0][2] +
                               x * gR[1][0] + z * gR[1][2] - r * gR[2][0] + z * gR[2][1] -
                               2.0f * y * gR[2][2]);
      const float gz = 2.0f * (-2.0f * z * gR[0][0] - r * gR[0][1] + x * gR[0][2] +
                               r * gR[1][0] - 2.0f * z * gR[1][1] + y * gR[1][2] +
                               x * gR[2][0] + y * gR[2][1]);
      g_quats[i] = make_float4(gr, gx, gy, gz);
    }
  }
  if (sh) flush_rows(slab, g_sh, i0, n, a.sh_row, lane);
}

size_t sh_bytes(const TableArgs& a) {
  return a.sh_degree > 0 ? sizeof(float) * kWarps * 32 * a.sh_row : 0;
}

}  // namespace

extern "C" int gs_table_args_size() { return static_cast<int>(sizeof(gs::TableArgs)); }

extern "C" int gs_table_sh_row_max() { return kShRowMax; }

extern "C" int gs_splat_table(const float* means, const float* cov6, const float* scales,
                              const float* quats, const float* opacities,
                              const float* colors, const float* sh_rest,
                              const float* shift2d, const float* view, const float* vp,
                              const float* centre, const gs::TableArgs* args, float* fields,
                              int32_t* tile_min, int32_t* tile_ext, int32_t* counts,
                              float* depth, float* raw_depth, float* mean2d, float* radius,
                              bool* valid, bool* culled, float* pairs, long long n,
                              cudaStream_t stream) {
  const gs::TableArgs a = *args;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  splat_table_fwd<<<blocks, kThreads, sh_bytes(a), stream>>>(
      means, cov6, scales, quats, opacities, colors, sh_rest, shift2d, view, vp, centre, a,
      fields, reinterpret_cast<int2*>(tile_min), reinterpret_cast<int2*>(tile_ext), counts,
      depth, raw_depth, reinterpret_cast<float2*>(mean2d), radius, valid, culled, pairs, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gs_splat_table_bwd(const float* means, const float* cov6, const float* scales,
                                  const float* quats, const float* opacities,
                                  const float* sh_rest, const float* view, const float* vp,
                                  const float* centre, const gs::TableArgs* args,
                                  const float* g_fields, const float* g_mean2d,
                                  float* g_means, float* g_cov6, float* g_scales,
                                  float* g_quats, float* g_opacities, float* g_colors,
                                  float* g_sh, long long n, cudaStream_t stream) {
  const gs::TableArgs a = *args;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  splat_table_bwd<<<blocks, kThreads, sh_bytes(a), stream>>>(
      means, cov6, scales, quats, opacities, sh_rest, view, vp, centre, a, g_fields,
      reinterpret_cast<const float2*>(g_mean2d), g_means, g_cov6, g_scales,
      reinterpret_cast<float4*>(g_quats), g_opacities, g_colors, g_sh, n);
  return static_cast<int>(cudaGetLastError());
}
