// Duplicate expansion: per-splat table -> splat-major records, with the
// exact reachability cull, for Hopper (sm_90a).
//
// Replaces: openglgaussiansplattingrenderer_tpu/ops/pallas/records.py
//           _expand_kernel (a one-hot bf16 MXU matmul gather over
//           128-floored DMA windows of a 16-row f32 table).
// Bound on the card: device memory. Each record writes 11 words (9 fields,
//           tile, depth), 12 where it also writes the record sort's key
//           word; each splat's 14 words (9 fields, the tile rect, depth, the
//           prefix sum) are read once.
// Design:   the partition of records_common.cuh: a block owns K = 1,024
//           items of the merged sequence of records and splat ends, so a
//           run of empty splats or one large splat cannot load one block
//           more than another. A block takes two pieces one after
//           another; it (1) finds where they start by three merge-path
//           searches at once, a warp each; then for each piece (2) loads the
//           tables of the splats its
//           records can belong to, [s0, min(s1, n-1)], into shared memory
//           with coalesced row copies, all in flight at once (cp.async), and
//           evaluates each splat's
//           ln(op) - ln(alpha_min) there once (logf is deterministic, so the
//           value is the one a record would compute); (3) gives each thread
//           groups of four consecutive records, r = 4g .. 4g+3: the thread
//           finds the first record's splat by a binary search of the window's
//           prefix sums in shared memory and follows the next three by a
//           step (a search again only past an empty splat); the tile follows
//           from j = r - cum_excl[s] in integer arithmetic and the cull is
//           the TPU kernel's two-KKT-candidate minimum of the conic
//           quadratic over the tile's pixel rect in the same operation
//           order (the library is built with --fmad=false, so no
//           multiply-add is contracted and the plain PyTorch version agrees
//           bit for bit); (4) stores each row of a whole group with one
//           16-byte store where the rows are 16-byte aligned (capacity a
//           multiple of 4, as on the main path), else and at the piece's
//           ragged ends with 4-byte stores. A block whose piece holds ends
//           only does nothing past its search. The items [n + total, n +
//           capacity) are the records at or past total: zero with tile =
//           num_tiles, written by the grid's last blocks with the same
//           stores. With a record in registers, the record sort's key word
//           follows from its tile and depth (sort_word): the pair key's low
//           word (its high word is the tile) or the packed word, 4 B a
//           record more; the depth is still written (4 B a record) so that
//           every caller keeps its (fields, tile, depth).

#include "records_common.cuh"

namespace {

using records::kItems;

constexpr int kThreads = 256;
constexpr int kWin = kItems + 1;  // splats a piece's records can belong to
constexpr int kFields = 9;
static_assert(kThreads / 32 > records::kPieces, "block_splits takes a warp a split");

// the window in shared memory, a row a quantity; cum[i] = cum_excl of the
// window's i-th splat, cum[w] = cum_incl of its last
struct Window {
  float f[kFields][kWin];
  float depth[kWin];
  float ln_ratio[kWin];
  int32_t tx0[kWin], ty0[kWin], ext[kWin];
  int32_t cum[kWin + 1];
};
constexpr size_t kSmem = sizeof(Window);

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// the largest i in [lo, hi) with cum[i] <= r (cum[lo] <= r holds): the
// splat of record r
__device__ __forceinline__ int window_search(const int32_t* cum, int lo, int hi, int r) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= r) lo = mid; else hi = mid;
  }
  return lo;
}

struct Record {
  float f[kFields];
  int tile;
  float d;
  uint32_t key;
};

// The record sort's key word (records.sort_word): kKeyPair, the low word
// of the (tile, depth) pair key, the depth's bits with non-negative floats'
// sign bit set and negative floats' bits inverted, so that unsigned order is
// float order (-0.0 before +0.0); kKeyPacked, tile * 2^22 + the depth
// clamped to [0, 1] in 22 bits. kKeyNone writes no word.
constexpr int kKeyNone = 0, kKeyPair = 1, kKeyPacked = 2;

__device__ __forceinline__ uint32_t sort_word(int mode, int tile, float d) {
  if (mode == kKeyPair) {
    const uint32_t b = __float_as_uint(d);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  const uint32_t q = 1u << 22;
  const uint32_t qd = min((uint32_t)(fminf(fmaxf(d, 0.0f), 1.0f) * (float)q), q - 1u);
  return (uint32_t)tile * q + qd;
}

// record r of the window's splat i: its fields, tile and depth, the cull
// in the TPU kernel's operation order
__device__ __forceinline__ void make_record(const Window& w, int i, int r, int gx,
                                            int num_tiles, int pw, int ph, int key_mode,
                                            Record& o) {
  const int j = r - w.cum[i];
  const int ext = w.ext[i];
  const int q = j / ext;
  const int ty = w.ty0[i] + q;
  const int tx = w.tx0[i] + (j - q * ext);
#pragma unroll
  for (int k = 0; k < kFields; ++k) o.f[k] = w.f[k][i];
  o.d = w.depth[i];
  const float mx = o.f[0], my = o.f[1], aa = o.f[2], bb = o.f[3], cc = o.f[4];
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
  o.tile = qmin * 0.49999f <= w.ln_ratio[i] + 1e-4f ? ty * gx + tx : num_tiles;
  o.key = sort_word(key_mode, o.tile, o.d);
}

// the records [a, b) of four-record groups, `fill` giving each one
template <typename Fill>
__device__ __forceinline__ void store_groups(int a, int b, bool vec, float* out_f,
                                             int32_t* out_t, float* out_d, uint32_t* out_k,
                                             int capacity, Fill fill) {
  for (int g = (a >> 2) + (int)threadIdx.x; g <= ((b - 1) >> 2); g += kThreads) {
    Record rec[4];
    bool in[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * g + k;
      in[k] = r >= a && r < b;
      if (in[k]) fill(r, rec[k]);
    }
    const int r = 4 * g;
    if (vec && in[0] && in[3]) {
#pragma unroll
      for (int f = 0; f < kFields; ++f)
        *reinterpret_cast<float4*>(out_f + (size_t)f * capacity + r) =
            make_float4(rec[0].f[f], rec[1].f[f], rec[2].f[f], rec[3].f[f]);
      *reinterpret_cast<int4*>(out_t + r) =
          make_int4(rec[0].tile, rec[1].tile, rec[2].tile, rec[3].tile);
      *reinterpret_cast<float4*>(out_d + r) =
          make_float4(rec[0].d, rec[1].d, rec[2].d, rec[3].d);
      if (out_k)
        *reinterpret_cast<uint4*>(out_k + r) =
            make_uint4(rec[0].key, rec[1].key, rec[2].key, rec[3].key);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!in[k]) continue;
#pragma unroll
        for (int f = 0; f < kFields; ++f) out_f[(size_t)f * capacity + r + k] = rec[k].f[f];
        out_t[r + k] = rec[k].tile;
        out_d[r + k] = rec[k].d;
        if (out_k) out_k[r + k] = rec[k].key;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
expand_records(const float* __restrict__ fields,     // (9, n)
               const int32_t* __restrict__ tile_min,  // (n, 2)
               const int32_t* __restrict__ tile_ext,  // (n, 2)
               const float* __restrict__ depth,       // (n,)
               const int32_t* __restrict__ cum_incl,  // (n,)
               int n, float* __restrict__ out_fields,  // (9, cap)
               int32_t* __restrict__ out_tile,         // (cap,)
               float* __restrict__ out_depth,          // (cap,)
               uint32_t* __restrict__ out_key,         // (cap,) or null
               int capacity, int gx, int num_tiles, int pw, int ph,
               float ln_alpha_min, int key_mode, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_split[records::kPieces + 1];
  Window& w = *reinterpret_cast<Window*>(smem);
  const long long total = records::clamp_total(cum_incl, n, capacity);
  const long long merged = n + total;
  const long long first = (long long)blockIdx.x * records::kPieces * kItems;
  const long long last = min(first + records::kPieces * kItems, (long long)n + capacity);

  if (first < merged) {
    records::block_splits(cum_incl, n, total, first, merged, s_split);
    for (int j = 0; j < records::kPieces; ++j) {
      const records::Piece p = records::piece_of(s_split, j, first, merged);
      if (p.r1 <= p.r0) continue;  // ends only, or past merged
      const int s0 = p.s0;
      const int nw = min(p.s1, n - 1) - s0 + 1;
      for (int i = threadIdx.x; i < nw; i += kThreads) {
        const int s = s0 + i;
#pragma unroll
        for (int k = 0; k < kFields; ++k)
          records::copy_async(&w.f[k][i], fields + (size_t)k * n + s, 4);
        records::copy_async(&w.depth[i], depth + s, 4);
        records::copy_async(&w.tx0[i], tile_min + 2 * s, 4);
        records::copy_async(&w.ty0[i], tile_min + 2 * s + 1, 4);
        records::copy_async(&w.ext[i], tile_ext + 2 * s, 4);
        records::copy_async(&w.cum[i + 1], cum_incl + s, 4);
      }
      if (threadIdx.x == 0) w.cum[0] = s0 > 0 ? cum_incl[s0 - 1] : 0;
      records::copies_arrived();
      __syncthreads();
      for (int i = threadIdx.x; i < nw; i += kThreads) {  // each thread its own splats
        w.ln_ratio[i] = logf(fmaxf(w.f[5][i], 1e-30f)) - ln_alpha_min;
        w.ext[i] = max(w.ext[i], 1);
      }
      __syncthreads();
      // a thread's records only grow, so its splat only moves on: a search
      // of what is left once a record is past the splat
      int i = 0;
      store_groups(p.r0, p.r1, vec, out_fields, out_tile, out_depth, out_key, capacity,
                   [&](int r, Record& o) {
                     if (w.cum[i + 1] <= r) i = window_search(w.cum, i + 1, nw, r);
                     make_record(w, i, r, gx, num_tiles, pw, ph, key_mode, o);
                   });
      __syncthreads();  // the window is refilled for the next piece
    }
  }
  // the records at or past total
  const long long t0 = max(first, merged), t1 = last;
  if (t0 < t1) {
    store_groups((int)(t0 - n), (int)(t1 - n), vec, out_fields, out_tile, out_depth,
                 out_key, capacity, [&](int, Record& o) {
#pragma unroll
                   for (int k = 0; k < kFields; ++k) o.f[k] = 0.0f;
                   o.tile = num_tiles;
                   o.d = 0.0f;
                   o.key = sort_word(key_mode, num_tiles, 0.0f);
                 });
  }
}

}  // namespace

extern "C" int gs_records_items() { return kItems; }

// out_key: null with key_mode kKeyNone, else (capacity,) u32 sort words.
extern "C" int gs_expand(const float* fields, const int32_t* tile_min, const int32_t* tile_ext,
                         const float* depth, const int32_t* cum_incl, int n,
                         float* out_fields, int32_t* out_tile, float* out_depth,
                         uint32_t* out_key, int capacity, int gx, int num_tiles, int pw,
                         int ph, float ln_alpha_min, int key_mode, void* stream) {
  if (key_mode < kKeyNone || key_mode > kKeyPacked ||
      (key_mode == kKeyNone) != (out_key == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (capacity <= 0) return 0;
  static bool smem_set[64] = {};  // the attribute holds for a device's process
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !smem_set[dev]) {
    e = cudaFuncSetAttribute(expand_records, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) smem_set[dev] = true;
  }
  const long long items = (long long)n + capacity;
  const long long span = (long long)records::kPieces * kItems;
  const unsigned blocks = (unsigned)((items + span - 1) / span);
  const bool vec = capacity % 4 == 0 && records::aligned16(out_fields) &&
                   records::aligned16(out_tile) && records::aligned16(out_depth) &&
                   records::aligned16(out_key);
  expand_records<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      fields, tile_min, tile_ext, depth, cum_incl, n, out_fields, out_tile, out_depth,
      out_key, capacity, gx, num_tiles, pw, ph, ln_alpha_min, key_mode, vec);
  return static_cast<int>(cudaGetLastError());
}
