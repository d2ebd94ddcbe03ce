// The record sort stage's gathers, for Hopper (sm_90a).
//
// gs_record_gather: out[r, j] = in[r, idx[j]] over nine field rows. The
// un-sort runs it on the sorted records' cotangents by the inverse index.
//
// The stage's forward (record_sort.record_sort_splats) gathers the sorted
// records' fields by splat: a record's fields are its splat's.
// gs_id_gather writes the sorted records' splat ids (sid[si[j]]);
// gs_pair_gather reads each one's fields from the splat table in the pair
// layout: fields 0-7 as four (n + 1, 2) arrays of 8-byte pairs, field 8 as
// an (n + 1,) array, row n zero (the id of the records past the total),
// which the splat table kernel stores beside its fields (table.cu). The
// forms measured and not taken (the nine field rows gathered by the sorted
// source index, the record-major (n + 1, 12) rows) are variants of
// scripts/torch_record_sort_probe.py, with their times in PERF.md.
//
// Replaces: the payload of the JAX package's record sort
//           (openglgaussiansplattingrenderer_tpu/ops/pallas/records.py
//           sort_with_payload / sort_multi_with_payload: the nine field
//           rows ride a lax.sort as payload operands) and its backward
//           (_sort_cotangents: a lax.sort of the sorted source index with
//           the cotangent rows as payload; under BWD_COT_PACK="bf16" the
//           rows go in pairs packed into u32 words). XLA compiles both; no
//           Pallas kernel there. The port's plain versions are one
//           index_select and one index_copy_.
// Bound on the card: bytes. A record's nine values read (36 B) and
//           written (36 B), its index read (4 B): 76 B a record. No
//           arithmetic but the bf16 mode's rounding.
// Design:   the index is a permutation, so every output element is written
//           once: the result is the same from run to run. The writes go in
//           order, 16 bytes a store; the reads are scattered (sorted
//           neighbours come from different splats), so a 4-byte read costs
//           a 32-byte sector. A grid row takes one field row: blocks start
//           in order, so the row being read at a time (25 MB at the
//           flagship's 6.29M records) stays in the 50 MB L2 cache and a
//           sector is fetched from device memory about once; the index is
//           read once a row. The index and the output are streams, read and
//           written with the evict-first hint (__ldcs, __stcs) so that they
//           leave L2 to the row being gathered: 12% faster on an H100 than
//           plain accesses (PERF.md). Measured on an H100 (PERF.md), all nine rows
//           of a record at once, the last radix pass's own gather among
//           them, read ~3x slower: their working set is the whole (9, C)
//           array. A thread takes four consecutive columns. Under the
//           bf16 cotangent mode the first `paired` rows round to bfloat16
//           and back with the card's round-to-nearest-even conversion,
//           which is torch's on the card (records.round_cotangent_pairs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 9;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Row blockIdx.y, columns 4q .. 4q + 3; vec: the rows and the index are
// 16-byte aligned and n % 4 == 0.
__global__ void __launch_bounds__(kThreads)
record_gather(const float* __restrict__ in, const int32_t* __restrict__ idx, int n,
              int paired, int vec, float* __restrict__ out) {
  const int r = blockIdx.y;
  const bool round = r < paired;
  const float* row = in + (size_t)r * n;
  float* dst = out + (size_t)r * n;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  if (vec) {
    const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx) + q);
    float4 w = make_float4(row[ix.x], row[ix.y], row[ix.z], row[ix.w]);
    if (round)
      w = make_float4(bf16_round(w.x), bf16_round(w.y), bf16_round(w.z), bf16_round(w.w));
    __stcs(reinterpret_cast<float4*>(dst + 4 * q), w);
    return;
  }
  for (long long c = 4 * q; c < 4 * q + 4 && c < n; ++c) {
    const float x = row[idx[c]];
    dst[c] = round ? bf16_round(x) : x;
  }
}

}  // namespace

// in, out: (9, n) float32 on the device, not overlapping; idx: n int32 in
// [0, n); the first `paired` rows (0 <= paired <= 9) are rounded to
// bfloat16. One launch. Returns the first CUDA error.
extern "C" int gs_record_gather(const void* in, const void* idx, int n, int paired,
                                void* out, void* stream) {
  if (n < 0 || paired < 0 || paired > kFields) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const int vec = n % 4 == 0 && aligned(in) && aligned(idx) && aligned(out);
  const long long quads = ((long long)n + 3) / 4;
  const dim3 grid((unsigned)((quads + kThreads - 1) / kThreads), kFields);
  record_gather<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const int32_t*>(idx), n, paired, vec,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---- the stage by splat: the pair layout -----------------------------------
// Bound on the card: bytes. gs_id_gather reads a record's source index (4 B,
//           a stream) and its splat id (one sector of a 25 MB row, at
//           random) and writes 4 B; gs_pair_gather reads a record's splat
//           id five times (a grid row a group) and its fields as five
//           sectors, and writes 36 B.
// Design:   the row gather's, a grid row a group (a pair of fields or field
//           8): at the flagship's 3,616,103 splats a pair array is 29 MB,
//           which L2 holds while the grid row that reads it runs, so a
//           record costs five sectors of L2 traffic where the nine field
//           rows of the (9, C) form cost nine (measured on an H100:
//           PERF.md). Four records a thread: their ids in one 16-byte
//           evict-first load, four 8-byte (or 4-byte) loads in flight, two
//           (one) 16-byte evict-first stores.

namespace {

constexpr int kPairs = 4;  // pair arrays before field 8's array

// Grid row g < 4: fields 2g, 2g + 1; g == 4: field 8. vec: ids and out
// 16-byte aligned, n % 4 == 0.
__global__ void __launch_bounds__(kThreads)
pair_gather(const float* __restrict__ pairs, long long m, const int32_t* __restrict__ ids,
            int n, int vec, float* __restrict__ out) {
  const int g = blockIdx.y;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  const float2* two = reinterpret_cast<const float2*>(pairs + (size_t)g * m * 2);
  const float* one = pairs + (size_t)2 * kPairs * m;
  if (vec) {
    const int4 ix = __ldcs(reinterpret_cast<const int4*>(ids + 4 * q));
    if (g < kPairs) {
      const float2 a = two[ix.x], b = two[ix.y], c = two[ix.z], d = two[ix.w];
      __stcs(reinterpret_cast<float4*>(out + (size_t)(2 * g) * n + 4 * q),
             make_float4(a.x, b.x, c.x, d.x));
      __stcs(reinterpret_cast<float4*>(out + (size_t)(2 * g + 1) * n + 4 * q),
             make_float4(a.y, b.y, c.y, d.y));
    } else {
      __stcs(reinterpret_cast<float4*>(out + (size_t)2 * kPairs * n + 4 * q),
             make_float4(one[ix.x], one[ix.y], one[ix.z], one[ix.w]));
    }
    return;
  }
  for (long long c = 4 * q; c < 4 * q + 4 && c < n; ++c) {
    const int s = ids[c];
    if (g < kPairs) {
      const float2 v = two[s];
      out[(size_t)(2 * g) * n + c] = v.x;
      out[(size_t)(2 * g + 1) * n + c] = v.y;
    } else {
      out[(size_t)2 * kPairs * n + c] = one[s];
    }
  }
}

// out[j] = sid[si[j]], four a thread where vec.
__global__ void __launch_bounds__(kThreads)
id_gather(const int32_t* __restrict__ sid, const int32_t* __restrict__ si, int n, int vec,
          int32_t* __restrict__ out) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  if (vec) {
    const int4 ix = __ldcs(reinterpret_cast<const int4*>(si + 4 * q));
    reinterpret_cast<int4*>(out)[q] = make_int4(sid[ix.x], sid[ix.y], sid[ix.z], sid[ix.w]);
    return;
  }
  for (long long c = 4 * q; c < 4 * q + 4 && c < n; ++c) out[c] = sid[si[c]];
}

bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// pairs: the pair layout of m = n_splats + 1 rows, 8-byte aligned; ids: n
// int32 in [0, m); out: (9, n) f32. One launch.
extern "C" int gs_pair_gather(const void* pairs, long long m, const void* ids, int n,
                              void* out, void* stream) {
  if (n < 0 || m < 1 || !aligned_to(pairs, 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int vec = n % 4 == 0 && aligned_to(ids, 16) && aligned_to(out, 16);
  const long long quads = ((long long)n + 3) / 4;
  const dim3 grid((unsigned)((quads + kThreads - 1) / kThreads), kPairs + 1);
  pair_gather<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pairs), m, static_cast<const int32_t*>(ids), n, vec,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[j] = sid[si[j]], n int32 each, si in range of sid. One launch.
extern "C" int gs_id_gather(const void* sid, const void* si, int n, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int vec = n % 4 == 0 && aligned_to(si, 16) && aligned_to(out, 16);
  const long long quads = ((long long)n + 3) / 4;
  id_gather<<<(unsigned)((quads + kThreads - 1) / kThreads), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(sid),
                                                   static_cast<const int32_t*>(si), n, vec,
                                                   static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
