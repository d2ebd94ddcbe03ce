// The record sort stage's row gather, for Hopper (sm_90a): out[r, j] =
// in[r, idx[j]] over the nine field rows. The forward gathers the records'
// fields by the sorted source index; the backward, the un-sort, gathers
// the sorted records' cotangents by its inverse.
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
