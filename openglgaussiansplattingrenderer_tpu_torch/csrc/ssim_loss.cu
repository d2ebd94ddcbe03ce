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
// Bound on the card: the float64 issue rate, then bytes. The forward reads
//           pred and target once and writes three partials a map value; the
//           backward reads them, pred and target, and writes the gradient
//           (some 33 and 39 MB at 512 x 1024 x 3). Each map value takes
//           four 11-tap window sums along the rows and four down the
//           columns, each tap one float64 fma, about 140 float64
//           instructions with S and its partials: chip_smoke.py reports that
//           own bound beside rows 15, 16's bound (float32 rate, 12 B of
//           partials). scripts/torch_loss_probe.py splits a block's life into
//           phases and times the earlier design and variants beside these.
// Design:   images are (B, H, W, C) with any element strides (pred is the
//           rendered (H, W, 4) image's first three channels, read in place).
//           A block owns a strip 32 columns wide of one image, every channel
//           of it (up to 4; more go in groups of 4 by blockIdx.z), over a
//           segment of rows, and walks down it a band of 8 rows at a time,
//           two barriers a band:
//   staging: the next band's rows with their 10 halo columns land in one of
//           two shared buffers by cp.async while the block sums this band
//           (zeros outside the image). A warp copies a row, 16 bytes a copy
//           where the wrapper finds the strides allow it (pvec, tvec): pred
//           a pixel at a time (channels 1 float apart, pixels 4: the
//           rendered frame), target its row's contiguous floats (a
//           contiguous image whose rows end on 16 bytes), the partials a
//           pixel's group of channels; other strides 4 bytes an element.
//           A staged row of pred or of the partials keeps a pixel in 16
//           bytes with 16 bytes of padding every 4 pixels (the row pass's
//           threads read 4 pixels apart: other banks); target's row keeps
//           its channels dense.
//   row sums: a thread takes 4 neighbouring outputs of one (row, channel)
//           from 14 staged inputs, each to double once, and writes the window
//           sums into a ring of the last 18 rows' sums: each row is summed
//           once for the whole strip (the halo rows twice only at a
//           segment's top). The forward needs E[p^2] and E[t^2] only as
//           their sum (sigma_p + sigma_t), so it takes four sums, not five.
//   column sums: a thread takes 4 rows of one (column, channel) from the
//           ring and finishes them: the forward's S, its three partials and
//           the backward's gradient, stored by neighbouring threads to
//           neighbouring addresses.
//   The host picks the segment height so that the grid fills the card's
//   resident blocks once (gs_loss_plan: 2 blocks an SM, 256 blocks at
//   512 x 1024).
//   Every sum past the float32 inputs is a double: E[p^2] - mu^2 cancels in
//   flat regions, and the backward's three window sums cancel against each
//   other there, so float32 sums leave the gradient some 1e-5 of its largest
//   from its float64 value on a rendered frame, as the float32 conv form is.
//   A tap of a window sum is one fused multiply-add, fma(g, x, s) (the
//   plain restatement rounds the product and the sum apart: the one place
//   the two round differently). The partials between the kernels are
//   stored as float (GS_LOSS_PART_T), a pixel's group of channels in 16
//   bytes (the lanes past C zero), so that the backward stages a pixel in
//   one copy; they are summed in double. The outputs (the loss, the
//   gradient) are rounded to float once.
//   forward (gs_loss_fwd): the sums E[p], E[t], E[p^2 + t^2], E[pt] over
//           the VALID windows, S and its partials dS/dE[p], dS/dE[p^2],
//           dS/dE[pt] (three (B, H - 10, W - 10, 4 groups) planes), |p - t|
//           over the pixels the block owns. A block writes its sums of S and
//           |p - t| (in double) to its slot; a second launch of one block
//           (gs_loss_sum) adds the slots in index order and writes the loss.
//           No atomics: the loss repeats bit for bit.
//   backward (gs_loss_bwd): the transpose of the VALID window sum is the
//           "full" one with the same (symmetric) Gaussian: the partials'
//           rows 10 above the strip's and columns 10 left of it, zero
//           outside the map, summed as above; per pixel
//             dL/dp = s_ssim (G*dS/dE[p] + 2p G*dS/dE[p^2] + t G*dS/dE[pt])
//                     + s_l1 sign(p - t),
//           s_ssim = -lambda / (2 M) dL, s_l1 = (1 - lambda) / (B H W C) dL,
//           dL read from the device.
//   Apart from the taps, every expression is the plain restatement's, in its
//   order and type; the library is built without multiply-add contraction.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The partials' type between the kernels (float, or double).
#ifndef GS_LOSS_PART_T
#define GS_LOSS_PART_T float
#endif
// A tap of a window sum: s + g x.
#ifndef GS_LOSS_TAP
#define GS_LOSS_TAP(g, x, s) fma((g), (x), (s))
#endif
// Marks between a block's phases; scripts/torch_loss_probe.py defines them
// in its copy to time the phases.
#ifndef GS_LOSS_MARK
#define GS_LOSS_MARK(k)
#endif

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
  int pvec, tvec;             // staging modes: pred 0 or kPixels, target 0 or kRows
  // filled by gs_loss_plan
  int cg, groups;             // channels a block, channel groups
  int fseg, fsegs;            // forward: map rows a block, segments
  int bseg, bsegs;            // backward: image rows a block, segments
};

}  // namespace gs

namespace {

using gs::LossArgs;
using gs::kSsimTaps;
using PartT = GS_LOSS_PART_T;

constexpr int kHalo = kSsimTaps - 1;
constexpr int kTW = 32;                          // a strip's columns
constexpr int kBH = 8;                           // a band's rows
constexpr int kRing = kBH + kHalo;               // rows of sums held
constexpr int kR = 4;                            // row-pass outputs a thread
constexpr int kRV = 4;                           // column-pass outputs a thread
constexpr int kCols = kTW + kHalo;               // staged columns
constexpr int kRowSlots = kCols + (kCols - 1) / 4;   // a pixel's 16 B, and 16 B every 4
constexpr int kRowF = kRowSlots * 4;             // a staged row, in floats
constexpr int kMinSeg = 16;
constexpr int kSumThreads = 256;
static_assert(kTW % kR == 0 && kBH == 2 * kRV, "the thread maps below");

// A staged pixel's slot in its row: one 16-byte slot of padding after every
// 4 pixels, so that the row pass's threads (4 pixels apart) hit other banks.
__device__ __forceinline__ int slot_of(int j) { return j + (j >> 2); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of N bytes, zero-filled where !in (src is then not read)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(N), "r"(in ? N : 0) : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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
    s = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.0;
    s = warp_sum(s);
  }
  __syncthreads();
  return s;
}

// Staging modes (LossArgs pvec, tvec): 0 an element's 4 (or 8) bytes a
// copy, any strides; kPixels a pixel's 4 lanes in 16-byte copies (channels
// 1 apart, pixels 4, 16-byte aligned: the rendered frame); kRows a row
// segment's contiguous floats 16 bytes a copy (channels 1 apart, pixels C,
// 16-byte aligned rows that end on 16 bytes).
constexpr int kPixels = 1, kRows = 2;

// One row's copy, a warp's: pixels x0 .. x0 + ncols - 1 of row (its first
// element; null outside the image, where the row is zero-filled), channels
// c0 .. c0 + CG - 1 (zeros past c), zeros outside [xlo, xhi). Into
// dst[slot_of(j)][4 lanes] (pred, the partials) or, DENSE, dst[j][CG]
// (target).
template <int CG, bool DENSE, typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* row, const T* any, long long sx,
                                         long long sc, int mode, int x0, int ncols, int xlo,
                                         int xhi, int c0, int c) {
  const int lane = threadIdx.x & 31;
  if (!DENSE && mode == kPixels) {
    for (int j = lane; j < ncols; j += 32) {
      const int x = x0 + j;
      const bool in = row != nullptr && x >= xlo && x < xhi;
#pragma unroll
      for (int h = 0; h < (int)sizeof(T) / 4; ++h)         // 16 bytes at a time
        cp_async<16>(dst + 4 * slot_of(j) + h * 16 / (int)sizeof(T),
                     in ? row + x * sx + h * 16 / (int)sizeof(T) : any, in);
    }
  } else if (DENSE && mode == kRows) {   // c0 == 0, sx == CG, xlo == 0: floats of x0 CG ..
    const int first = x0 * CG, end = xhi * CG;
    for (int i = lane; 4 * i < ncols * CG; i += 32) {
      const bool in = row != nullptr && first + 4 * i + 4 <= end;
      cp_async<16>(dst + 4 * i, in ? row + first + 4 * i : any, in);
    }
  } else {
    for (int e = lane; e < ncols * CG; e += 32) {
      const int j = e / CG, ch = e - j * CG, x = x0 + j;
      const bool in = row != nullptr && x >= xlo && x < xhi && c0 + ch < c;
      cp_async<sizeof(T)>(dst + (DENSE ? e : 4 * slot_of(j) + ch),
                          in ? row + x * sx + (c0 + ch) * sc : any, in);
    }
  }
}

// The rows y0 .. y0 + kBH - 1 of an image (rows outside [ylo, h) zero) into
// dst[row][kRowF], the warps taking a row each in turn from warp0.
template <int CG, int NCOLS, bool DENSE>
__device__ __forceinline__ void stage_image(float* dst, const float* src, const long long* s,
                                            int mode, const LossArgs& a, int b, int y0, int ylo,
                                            int x0, int c0, int warp0) {
  const int warps = blockDim.x >> 5;
  for (int r = (threadIdx.x >> 5) - warp0; r < kBH; r += warps) {
    if (r < 0) continue;
    const int y = y0 + r;
    const float* row = y >= ylo && y < a.h ? src + b * s[0] + y * s[1] : nullptr;
    copy_row<CG, DENSE>(dst + r * kRowF, row, src, s[2], s[3], mode, x0, NCOLS, 0, a.w, c0,
                        a.c);
  }
}

// The partial planes are (B, H - 10, W - 10, 4 groups): a pixel's group of
// up to 4 channels in 16 bytes (of float), the lanes past C zero.
__device__ __forceinline__ long long part_plane(const LossArgs& a) {
  return (long long)a.b * (a.h - kHalo) * (a.w - kHalo) * 4 * a.groups;
}

// A partial into its lane; where PAIR, lane 2's store carries lane 3's zero.
template <bool PAIR>
__device__ __forceinline__ void store_part(PartT* p, int lane, PartT v) {
  using Pair = typename std::conditional<sizeof(PartT) == 4, float2, double2>::type;
  if (PAIR && lane == 2) {
    Pair two;
    two.x = v;
    two.y = 0;
    *reinterpret_cast<Pair*>(p) = two;
  } else {
    *p = v;
  }
}

// The rows of the partial planes the backward's band reads: map rows
// y0 .. y0 + kBH - 1, columns x0 - kHalo .. x0 + kTW - 1 (zeros outside the
// map) of each plane into dst[plane][row][kRowF], a pixel's group at once.
template <int CG>
__device__ __forceinline__ void stage_parts(PartT* dst, const PartT* parts, const LossArgs& a,
                                            int b, int y0, int x0, int c0) {
  const int hm = a.h - kHalo, wm = a.w - kHalo, warps = blockDim.x >> 5, cp = 4 * a.groups;
  const long long plane = part_plane(a);
  for (int t = threadIdx.x >> 5; t < 3 * kBH; t += warps) {
    const int q = t / kBH, y = y0 + t % kBH;
    const PartT* row =
        y >= 0 && y < hm ? parts + q * plane + ((long long)b * hm + y) * wm * cp + c0 : nullptr;
    copy_row<CG, false>(dst + t * kRowF, row, parts, cp, 1, kPixels, x0 - kHalo, kCols, 0, wm,
                        0, a.c);
  }
}

// The row pass's unit: kR neighbouring outputs of one (row, channel).
struct RowUnit {
  int c, xg, r;
  template <int CG>
  __device__ static RowUnit of(int u) {
    return {u % CG, (u / CG) % (kTW / kR), u / (CG * (kTW / kR))};
  }
};

// The ring slot of the first of the kRV + kHalo rows a column-pass thread
// reads in band k (rows k kBH - kHalo + kRV rg from the segment's first).
__device__ __forceinline__ int ring_base(int k, int rg) {
  return (k * kBH - kHalo + kRV * rg + kRing) % kRing;
}

// The window sums of NQ quantities along a staged row: kR outputs from the
// kR + kHalo inputs load(kk, x) gives (x[q], double), into acc[q][i].
template <int NQ, typename Load>
__device__ __forceinline__ void row_sums(const double* g, Load load, double (&acc)[NQ][kR]) {
#pragma unroll
  for (int kk = 0; kk < kR + kHalo; ++kk) {
    double x[NQ];
    load(kk, x);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int tap = kk - i;
      if (tap < 0 || tap > kHalo) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        acc[q][i] = tap == 0 ? g[0] * x[q] : GS_LOSS_TAP(g[tap], x[q], acc[q][i]);
    }
  }
}

// The window sums of NQ quantities down the ring's columns: kRV outputs of
// ring column f from the kRV + kHalo rows from slot s0, into m[q][i].
template <int NQ>
__device__ __forceinline__ void column_sums(const double* g, const double* ring, int kf, int f,
                                            int s0, double (&m)[NQ][kRV]) {
#pragma unroll
  for (int j = 0; j < kRV + kHalo; ++j) {
    const int s = s0 + j < kRing ? s0 + j : s0 + j - kRing;
    const double* h = ring + s * NQ * kf + f;
    double v[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = h[q * kf];
#pragma unroll
    for (int i = 0; i < kRV; ++i) {
      const int tap = j - i;
      if (tap < 0 || tap > kHalo) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        m[q][i] = tap == 0 ? g[0] * v[q] : GS_LOSS_TAP(g[tap], v[q], m[q][i]);
    }
  }
}

// Shared memory of the forward: the ring of row sums [kRing][4][kTW CG]
// and two staging buffers [pred, target][kBH][kRowF], the block sum's
// scratch.
template <int CG>
struct FwdSmem {
  static constexpr size_t ring = sizeof(double) * kRing * 4 * kTW * CG;
  static constexpr size_t stage = sizeof(float) * 2 * kBH * kRowF;
  static constexpr size_t bytes = ring + 2 * stage + sizeof(double) * 8;
};

template <int CG>
__global__ void __launch_bounds__(64 * CG) gs_loss_fwd(
    const float* __restrict__ pred, const float* __restrict__ target,
    const __grid_constant__ LossArgs a, PartT* __restrict__ parts, double2* __restrict__ slots) {
  constexpr int kF = kTW * CG;
  using S = FwdSmem<CG>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);                   // [kRing][4][kF]
  float* stage = reinterpret_cast<float*>(smem + S::ring);          // [2][pred, target][kBH][kRowF]
  double* red = reinterpret_cast<double*>(smem + S::ring + 2 * S::stage);
  GS_LOSS_MARK(0);
  const int hm = a.h - kHalo, wm = a.w - kHalo;
  const int x0 = blockIdx.x * kTW, ys = blockIdx.y * a.fseg;
  const int b = blockIdx.z / a.groups, c0 = (blockIdx.z % a.groups) * CG;
  const int yend = min(ys + a.fseg, hm);
  const int nb = (yend - ys + kHalo + kBH - 1) / kBH;
  // the pixels whose |p - t| this block adds: its strip's columns (the last
  // strip's up to w) of its segment's rows (the last segment's up to h)
  const bool last_strip = x0 + kTW >= wm;
  const int own_end = ys + a.fseg >= hm ? a.h : ys + a.fseg;
  const long long plane = part_plane(a);
  const int cp = 4 * a.groups;
  const RowUnit ru = RowUnit::of<CG>(threadIdx.x);
  const int f = threadIdx.x % kF, rg = threadIdx.x / kF, cx = f / CG, cc = f % CG;
  const double* g = a.g;
  double ssum = 0.0, l1 = 0.0;

  auto copy = [&](int k) {      // band k's rows into its staging buffer
    const int y0 = ys + k * kBH;
    float* st = stage + (k & 1) * 2 * kBH * kRowF;
    stage_image<CG, kCols, false>(st, pred, a.ps, a.pvec, a, b, y0, 0, x0, c0, 0);
    stage_image<CG, kCols, true>(st + kBH * kRowF, target, a.ts, a.tvec, a, b, y0, 0, x0, c0, 2);
    cp_commit();
  };
  copy(0);
  for (int k = 0; k < nb; ++k) {
    GS_LOSS_MARK(3);
    cp_wait_all();
    __syncthreads();            // band k staged; the ring and band k - 1's buffer are free
    GS_LOSS_MARK(1);
    if (k + 1 < nb) copy(k + 1);

    {  // along the rows: E[p], E[t], E[p^2 + t^2], E[pt] of row ys + k kBH + ru.r,
       // each staged float to double once a thread, and the L1 terms owned
      const float* sp = stage + (k & 1) * 2 * kBH * kRowF + ru.r * kRowF + ru.c;
      const float* st = sp + kBH * kRowF + kR * ru.xg * CG;    // target's channels dense
      const bool own_row = ys + k * kBH + ru.r < own_end;
      const bool own_tail = last_strip && ru.xg == kTW / kR - 1;
      double acc[4][kR];
      row_sums<4>(g, [&](int kk, double (&x)[4]) {
        const float pf = sp[4 * (5 * ru.xg + kk + (kk >> 2))];   // slot_of(kR xg + kk)
        const float tf = st[kk * CG];
        if (own_row && (kk < kR || own_tail)) l1 += (double)fabsf(pf - tf);
        const double p = pf, t = tf;
        x[0] = p;
        x[1] = t;
        x[2] = fma(t, t, p * p);     // exact products: p * p + t * t rounded once
        x[3] = p * t;
      }, acc);
      double* h = ring + ((k * kBH + ru.r) % kRing) * 4 * kF + kR * ru.xg * CG + ru.c;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < kR; ++i) h[q * kF + i * CG] = acc[q][i];
    }
    __syncthreads();            // the band's sums are in the ring
    GS_LOSS_MARK(2);
    if (k == 0) continue;       // its windows start above the segment

    // down the columns: map rows yb .. yb + kRV - 1, the map value and its
    // partials
    const int yb = ys + k * kBH - kHalo + kRV * rg;
    double m[4][kRV];
    column_sums<4>(g, ring, kF, f, ring_base(k, rg), m);
#pragma unroll
    for (int i = 0; i < kRV; ++i) {
      const int y = yb + i;
      if (y < ys || y >= yend || x0 + cx >= wm) continue;
      const long long o = (((long long)b * hm + y) * wm + x0 + cx) * cp + c0 + cc;
      if (CG != 3 && cc == CG - 1) {   // the group's lanes past CG: whole 16-byte pixels
#pragma unroll
        for (int z = CG; z < 4; ++z)
          parts[o - cc + z] = parts[plane + o - cc + z] = parts[2 * plane + o - cc + z] = 0;
      }
      if (c0 + cc >= a.c) {     // a channel past C in the last group
        parts[o] = parts[plane + o] = parts[2 * plane + o] = 0;
        continue;
      }
      const double mu_p = m[0][i], mu_t = m[1][i];
      const double mu_pp = mu_p * mu_p, mu_tt = mu_t * mu_t, mu_pt = mu_p * mu_t;
      const double mu_sq = mu_pp + mu_tt;
      const double a1 = 2.0 * mu_pt + a.c1, a2 = 2.0 * (m[3][i] - mu_pt) + a.c2;
      const double b1 = mu_sq + a.c1, b2 = (m[2][i] - mu_sq) + a.c2;
      const double r = 1.0 / (b1 * b2);
      const double s = (a1 * a2) * r;
      const double d_mu = (2.0 * (mu_t * (a2 - a1) - (s * mu_p) * (b2 - b1))) * r;
      // three channels: the third lane's store carries the zero of the fourth
      store_part<CG == 3>(parts + o, cc, (PartT)d_mu);
      store_part<CG == 3>(parts + plane + o, cc, (PartT)(-(s * (b1 * r))));
      store_part<CG == 3>(parts + 2 * plane + o, cc, (PartT)((2.0 * a1) * r));
      ssum += s;
    }
  }
  GS_LOSS_MARK(3);

  ssum = block_sum(ssum, red);
  l1 = block_sum(l1, red);
  if (threadIdx.x == 0) {
    const unsigned id = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    slots[id] = make_double2(ssum, l1);
  }
  GS_LOSS_MARK(4);
}

// One block: the slots of gs_loss_fwd's blocks, added in index order.
__global__ void __launch_bounds__(kSumThreads) gs_loss_sum(
    const double2* __restrict__ slots, unsigned nblocks, const __grid_constant__ LossArgs a,
    float* __restrict__ loss) {
  __shared__ double red[kSumThreads / 32];
  double s_all = 0.0, l_all = 0.0;
  for (unsigned i = threadIdx.x; i < nblocks; i += kSumThreads) {
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

// Shared memory of the backward: the ring [kRing][3][kTW CG] and two
// staging buffers, each a band's partials [3][kBH][kRowF] and pixels
// [pred, target][kBH][kRowF].
template <int CG>
struct BwdSmem {
  static constexpr size_t ring = sizeof(double) * kRing * 3 * kTW * CG;
  static constexpr size_t parts = sizeof(PartT) * 3 * kBH * kRowF;
  static constexpr size_t pixels = sizeof(float) * 2 * kBH * kRowF;
  static constexpr size_t bytes = ring + 2 * (parts + pixels);
};

template <int CG>
__global__ void __launch_bounds__(64 * CG) gs_loss_bwd(
    const float* __restrict__ pred, const float* __restrict__ target,
    const __grid_constant__ LossArgs a, const PartT* __restrict__ parts,
    const float* __restrict__ dloss, float* __restrict__ out) {
  constexpr int kF = kTW * CG;
  using S = BwdSmem<CG>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);                  // [kRing][3][kF]
  PartT* sd = reinterpret_cast<PartT*>(smem + S::ring);            // [2][3][kBH][kRowF]
  float* spx = reinterpret_cast<float*>(smem + S::ring + 2 * S::parts);   // [2][2][kBH][kRowF]
  GS_LOSS_MARK(0);
  const int x0 = blockIdx.x * kTW, ys = blockIdx.y * a.bseg;
  const int b = blockIdx.z / a.groups, c0 = (blockIdx.z % a.groups) * CG;
  const int yend = min(ys + a.bseg, a.h);
  const int nb = (yend - ys + kHalo + kBH - 1) / kBH;
  const RowUnit ru = RowUnit::of<CG>(threadIdx.x);
  const int f = threadIdx.x % kF, rg = threadIdx.x / kF, cx = f / CG, cc = f % CG;
  const double* g = a.g;
  const double dl = (double)dloss[0];
  const double s_ssim = a.coef_ssim * dl, s_l1 = a.coef_l1 * dl;

  // band k: the partials' rows ys - kHalo + k kBH .. (for the row pass) and
  // the pixels of the rows the band finishes, ys - kHalo + k kBH ..
  auto copy = [&](int k) {
    const int y0 = ys - kHalo + k * kBH;
    float* px = spx + (k & 1) * 2 * kBH * kRowF;
    stage_parts<CG>(sd + (k & 1) * 3 * kBH * kRowF, parts, a, b, y0, x0, c0);
    stage_image<CG, kTW, false>(px, pred, a.ps, a.pvec, a, b, y0, ys, x0, c0, 3);
    stage_image<CG, kTW, true>(px + kBH * kRowF, target, a.ts, a.tvec, a, b, y0, ys, x0, c0, 5);
    cp_commit();
  };
  copy(0);
  for (int k = 0; k < nb; ++k) {
    GS_LOSS_MARK(3);
    cp_wait_all();
    __syncthreads();            // band k staged; the ring and band k - 1's buffer are free
    GS_LOSS_MARK(1);
    if (k + 1 < nb) copy(k + 1);

    {  // along the rows of the partials (the full window: columns x - 10 .. x)
      const PartT* d = sd + (k & 1) * 3 * kBH * kRowF + ru.r * kRowF + ru.c;
      double acc[3][kR];
      row_sums<3>(g, [&](int kk, double (&v)[3]) {
        const int o = 4 * (5 * ru.xg + kk + (kk >> 2));     // slot_of(kR xg + kk)
#pragma unroll
        for (int q = 0; q < 3; ++q) v[q] = (double)d[q * kBH * kRowF + o];
      }, acc);
      double* h = ring + ((k * kBH + ru.r) % kRing) * 3 * kF + kR * ru.xg * CG + ru.c;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < kR; ++i) h[q * kF + i * CG] = acc[q][i];
    }
    __syncthreads();            // the band's sums are in the ring
    GS_LOSS_MARK(2);
    if (k == 0) continue;

    // down the columns: image rows yb .. yb + kRV - 1, the gradient
    const int yb = ys + k * kBH - kHalo + kRV * rg;
    double m[3][kRV];
    column_sums<3>(g, ring, kF, f, ring_base(k, rg), m);
    const float* px = spx + (k & 1) * 2 * kBH * kRowF;
#pragma unroll
    for (int i = 0; i < kRV; ++i) {
      const int y = yb + i;
      if (y < ys || y >= yend || x0 + cx >= a.w || c0 + cc >= a.c) continue;
      const int o = (kRV * rg + i) * kRowF;
      const float p = px[o + 4 * slot_of(cx) + cc], t = px[kBH * kRowF + o + f];
      const float d = p - t;
      const double sgn = d > 0.0f ? 1.0 : (d < 0.0f ? -1.0 : 0.0);
      const double br = (m[0][i] + (2.0 * (double)p) * m[1][i]) + (double)t * m[2][i];
      out[(((long long)b * a.h + y) * a.w + x0 + cx) * a.c + c0 + cc] =
          (float)(s_ssim * br + s_l1 * sgn);
    }
  }
  GS_LOSS_MARK(3);
  GS_LOSS_MARK(4);
}

template <int CG>
constexpr size_t fwd_smem() {
  return FwdSmem<CG>::bytes;
}
template <int CG>
constexpr size_t bwd_smem() {
  return BwdSmem<CG>::bytes;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// A segment's rows: enough segments that strips x segments fill the
// card's resident blocks once, none shorter than kMinSeg rows.
int seg_rows(int rows, long long strips, long long resident) {
  const long long segs = resident / strips > 1 ? resident / strips : 1;
  const long long seg = cdiv(rows, segs);
  return static_cast<int>(seg > kMinSeg ? seg : kMinSeg);
}

template <int CG>
cudaError_t plan_cg(LossArgs& a, int sms) {
  cudaError_t e = cudaFuncSetAttribute(gs_loss_fwd<CG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(fwd_smem<CG>()));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gs_loss_bwd<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bwd_smem<CG>()));
  int fper = 0, bper = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fper, gs_loss_fwd<CG>, 64 * CG,
                                                      fwd_smem<CG>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bper, gs_loss_bwd<CG>, 64 * CG,
                                                      bwd_smem<CG>());
  if (e != cudaSuccess) return e;
  if (fper < 1 || bper < 1) return cudaErrorInvalidConfiguration;
  const long long z = (long long)a.b * a.groups;
  a.fseg = seg_rows(a.h - kHalo, cdiv(a.w - kHalo, kTW) * z, (long long)fper * sms);
  a.fsegs = static_cast<int>(cdiv(a.h - kHalo, a.fseg));
  a.bseg = seg_rows(a.h, cdiv(a.w, kTW) * z, (long long)bper * sms);
  a.bsegs = static_cast<int>(cdiv(a.h, a.bseg));
  return cudaSuccess;
}

dim3 fwd_grid(const LossArgs& a) {
  return dim3(static_cast<unsigned>(cdiv(a.w - kHalo, kTW)), a.fsegs, a.b * a.groups);
}
dim3 bwd_grid(const LossArgs& a) {
  return dim3(static_cast<unsigned>(cdiv(a.w, kTW)), a.bsegs, a.b * a.groups);
}

bool planned(const LossArgs& a) {
  return a.cg >= 1 && a.cg <= 4 && a.fseg > 0 && a.bseg > 0 && a.h > kHalo && a.w > kHalo;
}

}  // namespace

extern "C" int gs_loss_args_size() { return static_cast<int>(sizeof(gs::LossArgs)); }

// Bytes of a stored partial (4: float, 8: double).
extern "C" int gs_loss_partial_bytes() { return static_cast<int>(sizeof(PartT)); }

// Fills args' cg, groups and segments for the current device (its SMs and
// the kernels' resident blocks) and returns the forward's blocks: one slot
// each. A negative value is a CUDA error's code.
extern "C" int gs_loss_plan(void* args) {
  LossArgs& a = *static_cast<LossArgs*>(args);
  if (a.h <= kHalo || a.w <= kHalo || a.b < 1 || a.c < 1) return -cudaErrorInvalidValue;
  a.cg = a.c < 4 ? a.c : 4;
  a.groups = static_cast<int>(cdiv(a.c, a.cg));
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    switch (a.cg) {
      case 1: e = plan_cg<1>(a, sms); break;
      case 2: e = plan_cg<2>(a, sms); break;
      case 3: e = plan_cg<3>(a, sms); break;
      default: e = plan_cg<4>(a, sms); break;
    }
  }
  if (e != cudaSuccess) return -static_cast<int>(e);
  const dim3 gf = fwd_grid(a), gb = bwd_grid(a);
  if ((long long)a.b * a.groups > 65535 || gf.y > 65535 || gb.y > 65535)
    return -cudaErrorInvalidValue;
  return static_cast<int>(gf.x * gf.y * gf.z);
}

// Two launches: gs_loss_fwd, then gs_loss_sum. pred, target: (b, h, w, c)
// f32 at the strides of args (planned by gs_loss_plan); parts: 3 (b, h - 10,
// w - 10, 4 groups) planes of GS_LOSS_PART_T, 16-byte aligned; slots: one
// double2 a forward block, 16-byte aligned; loss: one f32.
extern "C" int gs_loss_forward(const void* pred, const void* target, const void* args,
                               void* parts, void* slots, void* loss, void* stream) {
  const LossArgs a = *static_cast<const LossArgs*>(args);
  if (!planned(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = fwd_grid(a);
  const float* p = static_cast<const float*>(pred);
  const float* t = static_cast<const float*>(target);
  PartT* d = static_cast<PartT*>(parts);
  double2* sl = static_cast<double2*>(slots);
  switch (a.cg) {
    case 1: gs_loss_fwd<1><<<grid, 64, fwd_smem<1>(), s>>>(p, t, a, d, sl); break;
    case 2: gs_loss_fwd<2><<<grid, 128, fwd_smem<2>(), s>>>(p, t, a, d, sl); break;
    case 3: gs_loss_fwd<3><<<grid, 192, fwd_smem<3>(), s>>>(p, t, a, d, sl); break;
    default: gs_loss_fwd<4><<<grid, 256, fwd_smem<4>(), s>>>(p, t, a, d, sl); break;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gs_loss_sum<<<1, kSumThreads, 0, s>>>(sl, grid.x * grid.y * grid.z, a,
                                        static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

// dloss: the loss's cotangent, one f32 on the device; out: (b, h, w, c) f32
// contiguous.
extern "C" int gs_loss_backward(const void* pred, const void* target, const void* args,
                                const void* parts, const void* dloss, void* out,
                                void* stream) {
  const LossArgs a = *static_cast<const LossArgs*>(args);
  if (!planned(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = bwd_grid(a);
  const float* p = static_cast<const float*>(pred);
  const float* t = static_cast<const float*>(target);
  const PartT* d = static_cast<const PartT*>(parts);
  const float* dl = static_cast<const float*>(dloss);
  float* o = static_cast<float*>(out);
  switch (a.cg) {
    case 1: gs_loss_bwd<1><<<grid, 64, bwd_smem<1>(), s>>>(p, t, a, d, dl, o); break;
    case 2: gs_loss_bwd<2><<<grid, 128, bwd_smem<2>(), s>>>(p, t, a, d, dl, o); break;
    case 3: gs_loss_bwd<3><<<grid, 192, bwd_smem<3>(), s>>>(p, t, a, d, dl, o); break;
    default: gs_loss_bwd<4><<<grid, 256, bwd_smem<4>(), s>>>(p, t, a, d, dl, o); break;
  }
  return static_cast<int>(cudaGetLastError());
}
