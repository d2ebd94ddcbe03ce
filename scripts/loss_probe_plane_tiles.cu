// The training loss kernels' earlier design, kept whole for
// scripts/torch_loss_probe.py to time beside csrc/ssim_loss.cu in one run
// (the port builds and runs only csrc/). It reads the head of the same
// LossArgs (the fields up to ts).
//
// The training loss (1 - lambda) L1 + lambda D-SSIM and its backward, for
// Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package computes the loss with XLA's
//           conv_general_dilated, five depthwise 11x11 Gaussian windows
//           (openglgaussiansplattingrenderer_tpu/train/losses.py ssim_map,
//           gs_loss), and its gradient by autodiff; the port's plain form is
//           the same five depthwise conv2d calls (train/losses.py
//           gs_loss_plain). ops/kernels/ssim_loss.py gs_loss_separable_plain
//           and gs_loss_separable_bwd_plain restate these kernels' arithmetic
//           in torch.
// Bound on the card: bytes. The forward reads pred and target once and
//           writes three partials a map value (12 B in float32, which is
//           what chip_smoke.py's bound counts; these kernels store them in
//           float64, 24 B); the backward reads them, pred and target, and
//           writes the gradient. The image is a few MB: a launch's fixed
//           costs and the 11-tap windows (some 250 operations a map value
//           forward, 140 a pixel backward) matter as much.
//           scripts/torch_loss_probe.py splits the forward block's life
//           into phases.
// Design:   images are (B, H, W, C) with any element strides (pred is the
//           rendered (H, W, 4) image's first three channels, read in place).
//           A block takes a 32 x 16 tile of one (batch, channel) plane and
//           stages it with its 10-pixel halo in shared memory, then takes the
//           windowed sums separably with the normalised 1-D Gaussian: along
//           each staged row (26 rows x 32 columns), then down the columns.
//           Everything past the float32 inputs runs in double, the stored
//           partials too: E[p^2] - mu^2 cancels in flat regions, and the
//           backward's three window sums cancel against each other there, so
//           float32 sums leave the gradient some 1e-5 of its largest from its
//           float64 value on a rendered frame, as the float32 conv form is.
//           The outputs (the loss, the gradient) are rounded to float once.
//   forward (gs_loss_fwd): the five sums E[p], E[t], E[p^2], E[t^2], E[pt]
//           over the VALID windows, the SSIM map value S and its partials
//           dS/dE[p], dS/dE[p^2], dS/dE[pt] (stored for the backward: three
//           (B * C, H - 10, W - 10) double planes), |p - t| over the tile's own
//           pixels. A block writes its sums of S and |p - t| (in double) to
//           its slot; a second launch of one block (gs_loss_sum) adds the
//           slots in index order and writes the loss. No atomics: the loss
//           repeats bit for bit.
//   backward (gs_loss_bwd): the transpose of the VALID window sum is the
//           "full" one with the same (symmetric) Gaussian. A block stages the
//           three partial planes over its tile and the 10 rows and columns
//           before it (zero outside the map), sums them separably as above
//           and writes, per pixel,
//             dL/dp = s_ssim (G*dS/dE[p] + 2p G*dS/dE[p^2] + t G*dS/dE[pt])
//                     + s_l1 sign(p - t),
//           s_ssim = -lambda / (2 M) dL, s_l1 = (1 - lambda) / (B H W C) dL,
//           dL read from the device.
//   Every expression is the plain restatement's, in its order and type; the
//   library is built without multiply-add contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int kSsimTaps = 11;

// ops/kernels/ssim_loss.py LossArgs mirrors the layout; gs_loss_args_size
// lets it check. Strides are in elements.
struct LossArgs {
  double g[kSsimTaps];        // the float32 Gaussian's values
  double c1, c2;
  double coef_ssim;           // -lambda / (2 M)
  double coef_l1;             // (1 - lambda) / (B H W C)
  double lam;
  int b, h, w, c;
  long long ps[4];            // pred's strides: batch, row, column, channel
  long long ts[4];            // target's
};

}  // namespace gs

namespace {

using gs::LossArgs;
using gs::kSsimTaps;

constexpr int kTW = 32, kTH = 16, kHalo = kSsimTaps - 1;
constexpr int kSW = kTW + kHalo, kSH = kTH + kHalo;         // staged tile 42 x 26
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// An element's offset; s is pred's or target's strides (a.ps, a.ts).
#define AT(s, b, y, x, c) \
  ((long long)(b) * (s)[0] + (long long)(y) * (s)[1] + (long long)(x) * (s)[2] + \
   (long long)(c) * (s)[3])

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, in a fixed order, on thread 0 (and returned there).
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < 32) {
    s = threadIdx.x < kWarps ? red[threadIdx.x] : 0.0;
    s = warp_sum(s);
  }
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads) gs_loss_fwd(
    const float* __restrict__ pred, const float* __restrict__ target, const LossArgs a,
    double* __restrict__ parts, double2* __restrict__ slots) {
  __shared__ float sp[kSH][kSW], st[kSH][kSW];
  __shared__ double hs[5][kSH][kTW];
  __shared__ double red[kWarps];
  const int hm = a.h - kHalo, wm = a.w - kHalo;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int bc = blockIdx.z, b = bc / a.c, ch = bc % a.c;

  for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, col = i % kSW, y = y0 + r, x = x0 + col;
    const bool in = y < a.h && x < a.w;
    sp[r][col] = in ? pred[AT(a.ps, b, y, x, ch)] : 0.0f;
    st[r][col] = in ? target[AT(a.ts, b, y, x, ch)] : 0.0f;
  }
  __syncthreads();

  // |p - t| over the tile's own pixels
  double l1 = 0.0;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int r = i / kTW, col = i % kTW;
    if (y0 + r < a.h && x0 + col < a.w) l1 += (double)fabsf(sp[r][col] - st[r][col]);
  }

  // along the rows
  for (int i = threadIdx.x; i < kSH * kTW; i += kThreads) {
    const int r = i / kTW, x = i % kTW;
    double mp = 0.0, mt = 0.0, mpp = 0.0, mtt = 0.0, mpt = 0.0;
#pragma unroll
    for (int k = 0; k < kSsimTaps; ++k) {
      const double p = sp[r][x + k], t = st[r][x + k], g = a.g[k];
      if (k == 0) {
        mp = g * p; mt = g * t; mpp = g * (p * p); mtt = g * (t * t); mpt = g * (p * t);
      } else {
        mp = mp + g * p; mt = mt + g * t; mpp = mpp + g * (p * p);
        mtt = mtt + g * (t * t); mpt = mpt + g * (p * t);
      }
    }
    hs[0][r][x] = mp; hs[1][r][x] = mt; hs[2][r][x] = mpp; hs[3][r][x] = mtt;
    hs[4][r][x] = mpt;
  }
  __syncthreads();

  // down the columns, the map value and its partials
  double ssum = 0.0;
  const long long plane = (long long)hm * wm, planes = (long long)a.b * a.c * plane;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int yy = i / kTW, x = i % kTW, y = y0 + yy, xm = x0 + x;
    if (y >= hm || xm >= wm) continue;
    double q[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      double s = a.g[0] * hs[j][yy][x];
#pragma unroll
      for (int k = 1; k < kSsimTaps; ++k) s = s + a.g[k] * hs[j][yy + k][x];
      q[j] = s;
    }
    const double mu_p = q[0], mu_t = q[1];
    const double mu_pp = mu_p * mu_p, mu_tt = mu_t * mu_t, mu_pt = mu_p * mu_t;
    const double sig_p = q[2] - mu_pp, sig_t = q[3] - mu_tt, sig_pt = q[4] - mu_pt;
    const double a1 = 2.0 * mu_pt + a.c1, a2 = 2.0 * sig_pt + a.c2;
    const double b1 = (mu_pp + mu_tt) + a.c1, b2 = (sig_p + sig_t) + a.c2;
    const double d = b1 * b2;
    const double s = (a1 * a2) / d;
    const long long o = bc * plane + (long long)y * wm + xm;
    parts[o] = 2.0 * (mu_t * (a2 - a1) - (s * mu_p) * (b2 - b1)) / d;
    parts[planes + o] = -s / b2;
    parts[2 * planes + o] = (2.0 * a1) / d;
    ssum += s;
  }

  ssum = block_sum(ssum, red);
  l1 = block_sum(l1, red);
  if (threadIdx.x == 0) {
    const unsigned id = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    slots[id] = make_double2(ssum, l1);
  }
}

// One block: the slots of gs_loss_fwd's blocks, added in index order.
__global__ void __launch_bounds__(kThreads) gs_loss_sum(
    const double2* __restrict__ slots, unsigned nblocks, const LossArgs a,
    float* __restrict__ loss) {
  __shared__ double red[kWarps];
  double s_all = 0.0, l_all = 0.0;
  for (unsigned i = threadIdx.x; i < nblocks; i += kThreads) {
    s_all += slots[i].x;
    l_all += slots[i].y;
  }
  s_all = block_sum(s_all, red);
  l_all = block_sum(l_all, red);
  if (threadIdx.x == 0) {
    const double m = (double)a.b * a.c * (a.h - kHalo) * (a.w - kHalo);
    const double n = (double)a.b * a.h * a.w * a.c;
    const double lam = a.lam;
    *loss = (float)((1.0 - lam) * (l_all / n) + lam * ((1.0 - s_all / m) / 2.0));
  }
}

__global__ void __launch_bounds__(kThreads) gs_loss_bwd(
    const float* __restrict__ pred, const float* __restrict__ target, const LossArgs a,
    const double* __restrict__ parts, const float* __restrict__ dloss,
    float* __restrict__ out) {
  __shared__ double sd[3][kSH][kSW];
  __shared__ double hs[3][kSH][kTW];
  const int hm = a.h - kHalo, wm = a.w - kHalo;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int bc = blockIdx.z, b = bc / a.c, ch = bc % a.c;
  const long long plane = (long long)hm * wm, planes = (long long)a.b * a.c * plane;

  // the partials of the windows that reach the tile: map rows y0 - 10 ..
  for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, col = i % kSW, y = y0 - kHalo + r, x = x0 - kHalo + col;
    const bool in = y >= 0 && y < hm && x >= 0 && x < wm;
    const long long o = bc * plane + (long long)y * wm + x;
#pragma unroll
    for (int j = 0; j < 3; ++j) sd[j][r][col] = in ? parts[j * planes + o] : 0.0;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kSH * kTW; i += kThreads) {
    const int r = i / kTW, x = i % kTW;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double s = a.g[0] * sd[j][r][x];
#pragma unroll
      for (int k = 1; k < kSsimTaps; ++k) s = s + a.g[k] * sd[j][r][x + k];
      hs[j][r][x] = s;
    }
  }
  __syncthreads();

  const double s_ssim = a.coef_ssim * (double)dloss[0], s_l1 = a.coef_l1 * (double)dloss[0];
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int yy = i / kTW, x = i % kTW, y = y0 + yy, xi = x0 + x;
    if (y >= a.h || xi >= a.w) continue;
    double q[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double s = a.g[0] * hs[j][yy][x];
#pragma unroll
      for (int k = 1; k < kSsimTaps; ++k) s = s + a.g[k] * hs[j][yy + k][x];
      q[j] = s;
    }
    const float p = pred[AT(a.ps, b, y, xi, ch)], t = target[AT(a.ts, b, y, xi, ch)];
    const float d = p - t;
    const double sgn = d > 0.0f ? 1.0 : (d < 0.0f ? -1.0 : 0.0);
    const double br = (q[0] + (2.0 * (double)p) * q[1]) + (double)t * q[2];
    out[(((long long)b * a.h + y) * a.w + xi) * a.c + ch] = (float)(s_ssim * br + s_l1 * sgn);
  }
}

}  // namespace

extern "C" int gs_loss_args_size() { return static_cast<int>(sizeof(gs::LossArgs)); }

// A block's tile: ceil(w / tile_w) ceil(h / tile_h) b c blocks, one slot
// each.
extern "C" int gs_loss_tile_w() { return kTW; }
extern "C" int gs_loss_tile_h() { return kTH; }

static bool grid_of(const LossArgs& a, dim3* grid) {
  if (a.h <= kHalo || a.w <= kHalo || a.b < 1 || a.c < 1) return false;
  const long long z = (long long)a.b * a.c;
  if (z > 65535) return false;
  *grid = dim3((a.w + kTW - 1) / kTW, (a.h + kTH - 1) / kTH, (unsigned)z);
  return grid->y <= 65535;
}

// Two launches: gs_loss_fwd, then gs_loss_sum. pred, target: (b, h, w, c)
// f32 at the strides of args; parts: 3 (b c, h - 10, w - 10) f64 planes;
// slots: one double2 a block; loss: one f32.
extern "C" int gs_loss_forward(const void* pred, const void* target, const void* args,
                               void* parts, void* slots, void* loss, void* stream) {
  const LossArgs a = *static_cast<const LossArgs*>(args);
  dim3 grid;
  if (!grid_of(a, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  gs_loss_fwd<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(pred), static_cast<const float*>(target), a,
      static_cast<double*>(parts), static_cast<double2*>(slots));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gs_loss_sum<<<1, kThreads, 0, s>>>(static_cast<const double2*>(slots),
                                     grid.x * grid.y * grid.z, a, static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

// dloss: the loss's cotangent, one f32 on the device; out: (b, h, w, c) f32
// contiguous.
extern "C" int gs_loss_backward(const void* pred, const void* target, const void* args,
                                const void* parts, const void* dloss, void* out,
                                void* stream) {
  const LossArgs a = *static_cast<const LossArgs*>(args);
  dim3 grid;
  if (!grid_of(a, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  gs_loss_bwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(target), a,
      static_cast<const double*>(parts), static_cast<const float*>(dloss),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
