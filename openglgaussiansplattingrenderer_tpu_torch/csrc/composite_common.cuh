// What the compositor's forward (composite.cu) and backward
// (composite_bwd.cu) share. The backward keeps no per-record state from the
// forward: it recomputes each pixel's alpha and transmittance, and must
// take the forward's keep and include decisions to the last ulp, because a
// flipped borderline record shifts the transmittance of every later record
// of the tile. So the arithmetic of one (pixel, record) step, the map from
// lanes to pixels and the test by which a warp skips a record live here
// once, and both kernels build with --fmad=false.
//
// A warp owns a compact patch of 32 pixels (8x4 where the tile is at least
// 8 wide), one pixel a lane. A record is staged in shared memory once a
// block (16-byte aligned) with what the blend needs (the scaled Cholesky factors) and what
// the skip test needs (the conic, the tile-local centre and
// ln(op / alpha_min)); lane l of a warp tests record l of a round of 32
// against the box around the patch's live pixels, a ballot gives the
// round's survivors, and only those are blended, in record order. A record
// is staged at all only if the same test lets it reach the box around the
// live pixels of the whole block (stage_reaching): where a heavy tile's
// records crowd on pixels that have long saturated, the few pixels still
// alive elsewhere cost one test a record and not one a warp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gs {

constexpr int kMaxPixels = 2048;    // pixels a tile may have
constexpr int kMaxChunk = 1024;     // records a staged batch may have
constexpr int kRound = 32;          // records a warp tests at once: one a lane
constexpr unsigned kFull = 0xffffffffu;

// ---- the map from warps and lanes to pixels --------------------------------

// A patch is px x py pixels, px * py = 32, px the smallest power of two that
// covers the tile's width, at most 8. The tile is pax x pay patches; those
// on its right and bottom edge may hang over it, and a lane whose pixel
// lies outside the tile is never alive.
struct PatchGrid {
  int px_log2, px, py, pax, pay;
};

inline PatchGrid patch_grid(int pw, int ph) {
  PatchGrid g;
  g.px = 8;
  while (g.px > 1 && g.px / 2 >= pw) g.px /= 2;
  g.px_log2 = 0;
  while ((1 << g.px_log2) < g.px) ++g.px_log2;
  g.py = 32 / g.px;
  g.pax = (pw + g.px - 1) / g.px;
  g.pay = (ph + g.py - 1) / g.py;
  return g;
}

// A tile-local pixel rect, inclusive: x0 <= x <= x1, y0 <= y <= y1.
struct Rect {
  float x0, y0, x1, y1;
};

// The bounding box of a set of live pixels, inclusive; x1 < 0 where none is
// alive. Pixels only ever die, so a box taken at the start of a batch holds
// for the batch.
struct Box {
  int x0, y0, x1, y1;
};

__device__ __forceinline__ Rect rect_of(const Box& b) {
  return Rect{(float)b.x0, (float)b.y0, (float)b.x1, (float)b.y1};
}

// The box around a warp's live pixels, lane's pixel (x, y): what is left of
// its patch once pixels have saturated.
__device__ __forceinline__ Box live_box(bool live, int x, int y) {
  Box b;
  b.x0 = __reduce_min_sync(kFull, live ? x : INT32_MAX);
  b.y0 = __reduce_min_sync(kFull, live ? y : INT32_MAX);
  b.x1 = __reduce_max_sync(kFull, live ? x : -1);
  b.y1 = __reduce_max_sync(kFull, live ? y : -1);
  return b;
}

// A block's box in shared memory, four ints: cleared by one thread, then
// each warp's first lane merges its own box in (integer min and max: the
// result does not depend on the order), then read by all, with a barrier
// between the three.
__device__ __forceinline__ void box_clear(int* s) {
  s[0] = s[1] = INT32_MAX;
  s[2] = s[3] = -1;
}

__device__ __forceinline__ void box_merge(int* s, const Box& b) {
  if (b.x1 < 0) return;
  atomicMin(&s[0], b.x0);
  atomicMin(&s[1], b.y0);
  atomicMax(&s[2], b.x1);
  atomicMax(&s[3], b.y1);
}

__device__ __forceinline__ Box box_read(const int* s) { return Box{s[0], s[1], s[2], s[3]}; }

// ---- one record, staged -----------------------------------------------------

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

// What a block stages per batch of `chunk` records, 20 floats a record.
// First, three float4 a record, read by a whole warp at once (a broadcast)
// when it blends record k:
//   [s11 s12 s22 u0] [v0 op r g] [b mxl myl -]
// then eight rows of `chunk` floats, read one record a lane by the skip
// test and by the backward's finalising lanes; the last is the record's
// index in the sorted array, as bits.
constexpr int kBlendWords = 12;
enum StagedRow { kMxl, kMyl, kA, kBq, kC, kLnr, kOp, kIdx, kStagedRows };
constexpr int kStagedFloats = kBlendWords + kStagedRows;

__device__ __forceinline__ const float4* blend_words(const float* sm, int k) {
  return reinterpret_cast<const float4*>(sm) + 3 * k;
}

__device__ __forceinline__ const float* staged_rows(const float* sm, int chunk) {
  return sm + kBlendWords * chunk;
}

// ln(op / alpha_min) as the skip test wants it, or +inf, which no quadratic
// exceeds, for a record the test must let through: a non-finite field, or a
// conic whose Cholesky factors were clamped (the blend then does not
// evaluate the quadratic form the test bounds).
__device__ __forceinline__ float reach_log_ratio(const RecordFactors& f, float ca, float cb,
                                                 float cc, float op, float ln_alpha_min) {
  const bool finite = isfinite(f.mxl) && isfinite(f.myl) && isfinite(ca) && isfinite(cb) &&
                      isfinite(cc) && isfinite(op);
  const bool proper = f.s11 >= 1e-20f && cc * 0.5f - f.s12 * f.s12 >= 0.0f;
  return finite && proper ? logf(fmaxf(op, 1e-30f)) - ln_alpha_min : INFINITY;
}

// ---- the skip test ----------------------------------------------------------

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Can a record with tile-local centre (mxl, myl), conic (aa, bb, cc) and
// lnr = reach_log_ratio reach alpha_min anywhere in the rect? The exact
// minimum of the conic quadratic over the rect is the smaller of the two
// KKT edge candidates, as in expand.cu's cull of a record against its
// tile, with that cull's margins. The test is conservative: it may pass a
// record whose alpha then stays below alpha_min at every pixel, it never
// drops one that would have blended. Every comparison is false on NaN on
// the side that drops.
__device__ __forceinline__ bool reaches(float mxl, float myl, float aa, float bb, float cc,
                                        float lnr, const Rect& r) {
  const float limit = lnr + 1e-4f;
  const float dx0 = clipf(mxl, r.x0, r.x1) - mxl;
  const float dy0 = clipf(myl, r.y0, r.y1) - myl;
  const float dys = clipf(-bb * dx0 / fmaxf(cc, 1e-12f), r.y0 - myl, r.y1 - myl);
  const float q1 = (aa * dx0 * dx0 + cc * dys * dys) + 2.0f * (bb * dx0 * dys);
  const float dxs = clipf(-bb * dy0 / fmaxf(aa, 1e-12f), r.x0 - mxl, r.x1 - mxl);
  const float q2 = (aa * dxs * dxs + cc * dy0 * dy0) + 2.0f * (bb * dxs * dy0);
  const bool drop = q1 * 0.49999f > limit && q2 * 0.49999f > limit;
  return !drop;
}

// The same for staged record k.
__device__ __forceinline__ bool patch_reach(const float* sm, int chunk, int k, const Rect& r) {
  const float* rows = staged_rows(sm, chunk);
  return reaches(rows[kMxl * chunk + k], rows[kMyl * chunk + k], rows[kA * chunk + k],
                 rows[kBq * chunk + k], rows[kC * chunk + k], rows[kLnr * chunk + k], r);
}

// ---- staging ------------------------------------------------------------------

// Fill the staged batch with the next records of [base, b1) that can reach
// the box around the block's live pixels, in record order, until the batch
// is at least a quarter full or the records end; base moves past the records
// examined, and the count staged is returned. A pass examines one record a
// thread, as many as there are free slots: the thread loads it, takes its
// factors and tests it, a ballot and the warps' counts in shared memory
// (counts: 2 x 32 ints) give every survivor its slot. The loads of the next
// pass are started before this pass's record is tested, so that in a tile
// where little survives pass follows pass without waiting on memory (the
// last pass's are spent: they warm the cache for the next batch). The
// backward passes drec, and a record that is not staged gets its zero
// gradient here. Every thread of the block calls this, and a barrier must
// follow before the batch is read.
__device__ __forceinline__ int stage_reaching(float* sm, int chunk,
                                              const float* __restrict__ rec, int rec_stride,
                                              int& base, int b1, float oxf, float oyf,
                                              float ln_alpha_min, const Rect& box, int* counts,
                                              float* __restrict__ drec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int least = max(min((int)blockDim.x, chunk) * 3 / 4, 1);  // free slots worth a pass
  float4* words = reinterpret_cast<float4*>(sm);
  float* rows = sm + kBlendWords * chunk;
  int m = 0;
  float v[9], next[9];  // the thread's record of this pass and of the next
#pragma unroll
  for (int j = 0; j < 9; ++j)
    v[j] = base + (int)threadIdx.x < b1 ? rec[(size_t)j * rec_stride + base + threadIdx.x] : 0.0f;
  for (int pass = 0; base < b1 && chunk - m >= least; ++pass) {
    const int step = min((int)blockDim.x, chunk - m);
    const int idx = base + (int)threadIdx.x;
    const bool mine = (int)threadIdx.x < step && idx < b1;
#pragma unroll
    for (int j = 0; j < 9; ++j)
      next[j] = idx + step < b1 ? rec[(size_t)j * rec_stride + idx + step] : 0.0f;
    const RecordFactors f = record_factors(v[0], v[1], v[2], v[3], v[4], oxf, oyf);
    const float lnr = reach_log_ratio(f, v[2], v[3], v[4], v[5], ln_alpha_min);
    const bool staged = mine && reaches(f.mxl, f.myl, v[2], v[3], v[4], lnr, box);
    const unsigned votes = __ballot_sync(kFull, staged);
    int* count = counts + (pass & 1) * 32;
    if (lane == 0) count[warp] = __popc(votes);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = count[w];
      total += c;
      before += w < warp ? c : 0;
    }
    if (staged) {
      const int k = m + before + __popc(votes & ((1u << lane) - 1u));
      words[3 * k] = make_float4(f.s11, f.s12, f.s22, f.u0);
      words[3 * k + 1] = make_float4(f.v0, v[5], v[6], v[7]);
      words[3 * k + 2] = make_float4(v[8], f.mxl, f.myl, 0.0f);
      rows[kMxl * chunk + k] = f.mxl;
      rows[kMyl * chunk + k] = f.myl;
      rows[kA * chunk + k] = v[2];
      rows[kBq * chunk + k] = v[3];
      rows[kC * chunk + k] = v[4];
      rows[kLnr * chunk + k] = lnr;
      rows[kOp * chunk + k] = v[5];
      rows[kIdx * chunk + k] = __int_as_float(idx);
    } else if (mine && drec != nullptr) {
#pragma unroll
      for (int j = 0; j < 9; ++j) drec[(size_t)j * rec_stride + idx] = 0.0f;
    }
    m += total;
    base += step;
#pragma unroll
    for (int j = 0; j < 9; ++j) v[j] = next[j];
  }
  return m;
}

// The index in the sorted array of staged record k.
__device__ __forceinline__ int staged_index(const float* sm, int chunk, int k) {
  return __float_as_int(staged_rows(sm, chunk)[kIdx * chunk + k]);
}

// The survivors of a whole batch of m staged records against one rect, for
// a warp: lane r returns the ballot of round r (records 32 r .. 32 r + 31).
// kAhead rounds are tested before their ballots are taken, so that their
// divisions overlap.
constexpr int kAhead = 4;

__device__ __forceinline__ unsigned batch_survivors(const float* sm, int chunk, int m,
                                                    const Rect& rect, int lane) {
  unsigned mine = 0u;
  for (int r0 = 0; r0 * kRound < m; r0 += kAhead) {
    bool pass[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = (r0 + u) * kRound + lane;
      pass[u] = k < m && patch_reach(sm, chunk, k, rect);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const unsigned b = __ballot_sync(kFull, pass[u]);
      if (lane == r0 + u) mine = b;
    }
  }
  return mine;
}

}  // namespace gs
