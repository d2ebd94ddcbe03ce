#!/usr/bin/env python3
"""Where the record sort stage's time goes, and the forms it did not take.

    python3 scripts/torch_record_sort_probe.py            # on a card
    python3 scripts/torch_record_sort_probe.py --splats 1000000

Renders the uniform flagship scene's records (3,616,103 splats at 1024x512,
``chip_smoke.py``'s scene and capacity) and, for the pair and the packed
key, times on the device alone (torch.profiler, median of runs):

- each launch of the stage (``record_sort.record_sort_splats_fwd``: the
  counts, every radix pass, the sorted records' splat ids, their fields
  from the pair layout; ``splat_stage_us``) and of the form it replaced
  (``field_stage``: the same counts and passes, then the row gather of the
  records' own nine field rows by the sorted source index; ``stage_us``),
  and the un-sort (``unsort_us``);
- two variants of the (9, C) form built from copies of the sources with a
  text substitution (``build.build_library`` on a temporary directory):
  the last radix pass gathering the nine field rows itself
  (``fused_last_pass_stage_us``), and the row gather taking all nine rows
  of its four columns a thread (``nine_rows_stage_us``, against the
  production one row a grid row). Both variants' outputs are held bit for
  bit to the stage's;
- the row gather alone with and without cache hints (``gather_hints_us``:
  the production gather reads its index and writes its rows evict-first,
  ``__ldcs`` / ``__stcs``, so that they leave L2 to the row being
  gathered; the variants read and write them plainly, or keep the
  gathered reads out of L1 too, ``__ldcg``), each held bit for bit;
- the un-sort's other form (``unsort_scatter_us``, against ``unsort_us``):
  the sorted cotangents read in order and stored through the sorted source
  index, a grid row a field row, held bit for bit;
- the record-major form, kernels of the probe's own (``ROW_KERNELS``):
  (N + 1, 12) rows, a splat's nine fields and three zero pad words in 48 B
  (``splat_rows_us``), read whole by a gather of four records a thread:
  option 1 (``record_rows_option1_us``: a copy of ``radix_sort.cu`` whose
  last pass stores the sorted records' splat ids, sid[source], in place of
  the source index, where a pointer is set) and option 2
  (``record_rows_option2_us``: the gather reads the splat id through the
  index), each held bit for bit to the stage;
- the compositor backward (kernel 5) storing each record's cotangents as
  one 48-byte row (``composite_bwd_rows_us``, a copy of its sources whose
  stores go to the record rows where a pointer is set, against
  ``composite_bwd_us``; ``composite_bwd_variant_fields_us`` the copy with
  the pointer unset), and the un-sort of those record rows
  (``unsort_rows_us``), each held bit for bit (pair key);
- the expansion's two modes (``expand_us``: the nine field rows;
  ``expand_ids_us``: the splat id and the sort word in place of the fields);
- the copies: the splat table kernel with and without its pair-layout
  stores (``table_pairs_us``, ``table_us``), a copy of ``table.cu`` that
  stores each splat's 48-byte row where a pointer is set
  (``table_rows_us``), and the transposes of its (9, N) fields into the
  pair layout (``splat_pairs_us``) and into the record rows
  (``splat_rows_us``), each held bit for bit to its plain version;
- the layouts of what the gathers read at random (``layouts``: groups of
  1, 2 or 4 fields, and the mixed layout of four pairs and a single row,
  the pair layout's), as kernels of the probe's own (``LAYOUT_KERNELS``),
  for the forward gather by splat and for the un-sort.

Prints the card and its power limit, then one JSON object last. Needs a
card: without CUDA it exits with "no CUDA device".
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# the last pass's payload store, and option 1's: in the last pass (the one
# that stores no keys) the image of the source index under g_map where it
# is set
PAYLOAD_STORE = "      if (p < live_n) out[dst[i]] = buf[p];\n"
MAPPED_STORE = """      if (p < live_n)
        out[dst[i]] = (g_map != nullptr && out_keys == nullptr && r == rows - 1)
                          ? g_map[buf[p]] : buf[p];
"""
# the last pass's inverse store, and what the variant adds beside it
LAST_PASS_STORE = "      if (p < live_n) inv_out[src_of[p]] = dst[i];\n"
FUSED_STORE = """      if (p < live_n) {
        const size_t s = src_of[p];
        inv_out[s] = dst[i];
        if (g_gather_in != nullptr) {
          float v[9];
#pragma unroll
          for (int g = 0; g < 9; ++g) v[g] = g_gather_in[(size_t)g * n + s];
#pragma unroll
          for (int g = 0; g < 9; ++g) g_gather_out[(size_t)g * n + dst[i]] = v[g];
        }
      }
"""
FUSED_GLOBALS = """typedef unsigned long long u64;
__device__ const float* g_gather_in;
__device__ float* g_gather_out;
__device__ const uint32_t* g_map;
"""
FUSED_SETTER = """
extern "C" int gs_probe_set_gather(const void* in, void* out) {
  cudaError_t e = cudaMemcpyToSymbol(g_gather_in, &in, sizeof(in));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_gather_out, &out, sizeof(out));
  return static_cast<int>(e);
}

extern "C" int gs_probe_set_map(const void* map) {
  return static_cast<int>(cudaMemcpyToSymbol(g_map, &map, sizeof(map)));
}
"""
# the row gather taking all nine rows of its four columns a thread
NINE_ROWS_KERNEL = """__global__ void __launch_bounds__(kThreads)
record_gather(const float* __restrict__ in, const int32_t* __restrict__ idx, int n,
              int paired, int vec, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  const int4 ix = __ldg(reinterpret_cast<const int4*>(idx) + q);
  float4 w[kFields];
#pragma unroll
  for (int r = 0; r < kFields; ++r) {
    const float* row = in + (size_t)r * n;
    w[r] = make_float4(row[ix.x], row[ix.y], row[ix.z], row[ix.w]);
  }
#pragma unroll
  for (int r = 0; r < kFields; ++r)
    *reinterpret_cast<float4*>(out + (size_t)r * n + 4 * q) = w[r];
}
"""


def variant_library(tmp: Path):
    """The two variant sources built into one library: (ctypes library)."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    src = build.CSRC
    radix = (src / "radix_sort.cu").read_text()
    gather = (src / "record_gather.cu").read_text()
    for old in (LAST_PASS_STORE, PAYLOAD_STORE, "typedef unsigned long long u64;\n"):
        if radix.count(old) != 1:
            raise RuntimeError(f"radix_sort.cu changed: {old.strip()!r} not found once")
    radix = radix.replace(LAST_PASS_STORE, FUSED_STORE).replace(
        PAYLOAD_STORE, MAPPED_STORE).replace(
        "typedef unsigned long long u64;\n", FUSED_GLOBALS) + FUSED_SETTER
    grid = "const dim3 grid((unsigned)((quads + kThreads - 1) / kThreads), kFields);"
    if len(KERNEL_BODY.findall(gather)) != 1 or gather.count(grid) != 1:
        raise RuntimeError("record_gather.cu changed: its kernel or grid not found once")
    gather = KERNEL_BODY.sub(lambda _: NINE_ROWS_KERNEL, gather).replace(
        grid, "const dim3 grid((unsigned)((quads + kThreads - 1) / kThreads), 1);")
    (tmp / "radix_sort.cu").write_text(radix)
    (tmp / "record_gather.cu").write_text(gather)
    path, _, _ = build.build_library(tmp, tmp / "out")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.gs_probe_set_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gs_probe_set_map.argtypes = [ctypes.c_void_p]
    lib.gs_probe_set_gather.restype = lib.gs_probe_set_map.restype = ctypes.c_int
    return lib


# the un-sort as a scatter: out[r, idx[j]] = in[r, j], idx the sorted index
SCATTER_KERNEL = """__global__ void __launch_bounds__(kThreads)
record_gather(const float* __restrict__ in, const int32_t* __restrict__ idx, int n,
              int paired, int vec, float* __restrict__ out) {
  const int r = blockIdx.y;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx) + q);
  const float4 w = __ldcs(reinterpret_cast<const float4*>(in + (size_t)r * n) + q);
  float* row = out + (size_t)r * n;
  row[ix.x] = w.x;
  row[ix.y] = w.y;
  row[ix.z] = w.z;
  row[ix.w] = w.w;
}
"""
KERNEL_BODY = re.compile(
    r"__global__ void __launch_bounds__\(kThreads\)\nrecord_gather\(.*?\n}\n", re.S)


def gather_source() -> str:
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    return (build.CSRC / "record_gather.cu").read_text()


def build_gather(tmp: Path, text: str):
    """``text`` as record_gather.cu, built on its own in ``tmp``: (ctypes
    library)."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    tmp.mkdir()
    (tmp / "record_gather.cu").write_text(text)
    lib = ctypes.CDLL(str(build.build_library(tmp, tmp / "out")[0]))
    lib.gs_record_gather.argtypes = build.SIGNATURES["gs_record_gather"]
    lib.gs_record_gather.restype = ctypes.c_int
    return lib


def gather_library(tmp: Path, kernel: str):
    """The row gather with its kernel replaced by ``kernel``."""
    text = gather_source()
    if len(KERNEL_BODY.findall(text)) != 1:
        raise RuntimeError("record_gather.cu changed: its kernel not found once")
    return build_gather(tmp, KERNEL_BODY.sub(lambda _: kernel, text))


# the row gather's three memory accesses, and their hinted forms
GATHER_INDEX = "const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx) + q);"
GATHER_READ = "float4 w = make_float4(row[ix.x], row[ix.y], row[ix.z], row[ix.w]);"
GATHER_STORE = "__stcs(reinterpret_cast<float4*>(dst + 4 * q), w);"
GATHER_HINTS = {
    "no hints": {
        GATHER_INDEX: "const int4 ix = __ldg(reinterpret_cast<const int4*>(idx) + q);",
        GATHER_STORE: "*reinterpret_cast<float4*>(dst + 4 * q) = w;"},
    "evict first, reads past L1": {
        GATHER_READ: ("float4 w = make_float4(__ldcg(row + ix.x), __ldcg(row + ix.y), "
                      "__ldcg(row + ix.z), __ldcg(row + ix.w));")},
}


def hinted_gathers(tmp: Path):
    """{variant: ctypes library} of the row gather with GATHER_HINTS."""
    libs = {}
    for i, (name, subs) in enumerate(GATHER_HINTS.items()):
        src = gather_source()
        for old, new in subs.items():
            if src.count(old) != 1:
                raise RuntimeError(f"record_gather.cu changed: {old!r} not found once")
            src = src.replace(old, new)
        libs[name] = build_gather(tmp / f"hint{i}", src)
    return libs


# the splat table kernel's field stores, and the record-row stores a copy
# adds beside them where g_rows is set
TABLE_STORE = "  for (int r = 0; r < 9; ++r) fields[r * n + i] = f[r];\n"
TABLE_ROWS_STORE = TABLE_STORE + """  if (g_rows != nullptr) {
    float4* r4 = reinterpret_cast<float4*>(g_rows + (size_t)i * 12);
    r4[0] = make_float4(f[0], f[1], f[2], f[3]);
    r4[1] = make_float4(f[4], f[5], f[6], f[7]);
    r4[2] = make_float4(f[8], 0.0f, 0.0f, 0.0f);
  }
"""
TABLE_GLOBAL = "namespace gs {\n"
TABLE_SETTER = """
extern "C" int gs_probe_set_rows(void* rows) {
  return static_cast<int>(cudaMemcpyToSymbol(g_rows, &rows, sizeof(rows)));
}
"""


def table_rows_library(tmp: Path):
    """``table.cu`` storing record rows beside its fields, built on its own
    in ``tmp``: (ctypes library)."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    text = (build.CSRC / "table.cu").read_text()
    for old in (TABLE_STORE, TABLE_GLOBAL):
        if text.count(old) != 1:
            raise RuntimeError(f"table.cu changed: {old.strip()!r} not found once")
    text = text.replace(TABLE_STORE, TABLE_ROWS_STORE).replace(
        TABLE_GLOBAL, "__device__ float* g_rows;\n" + TABLE_GLOBAL) + TABLE_SETTER
    tmp.mkdir()
    (tmp / "table.cu").write_text(text)
    lib = ctypes.CDLL(str(build.build_library(tmp, tmp / "out")[0]))
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.gs_probe_set_rows.argtypes = [ctypes.c_void_p]
    lib.gs_probe_set_rows.restype = ctypes.c_int
    return lib


# Layouts of what the gathers read at random, as kernels of the probe's own:
# the nine values split into G = ceil(9 / W) groups of W (1, 2 or 4)
# consecutive floats, group g an (m, W) array; a grid row a group, as the
# row gather takes a grid row a field row (W = 1 from the splat table's own
# (9, N) rows needs no copy). groups_copy writes the groups of the (9, n)
# fields, row n zero; grouped_gather<W> writes out[W g + w, j] =
# group g's row s, s = idx[j] or map[idx[j]], four records a thread.
LAYOUT_KERNELS = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
template <int W> struct Vec;
template <> struct Vec<1> { typedef float T; };
template <> struct Vec<2> { typedef float2 T; };
template <> struct Vec<4> { typedef float4 T; };
__device__ __forceinline__ float at(float v, int) { return v; }
__device__ __forceinline__ float at(float2 v, int w) { return w ? v.y : v.x; }
__device__ __forceinline__ float at(float4 v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}
__device__ __forceinline__ void put(float& v, int, float x) { v = x; }
__device__ __forceinline__ void put(float2& v, int w, float x) { (w ? v.y : v.x) = x; }
__device__ __forceinline__ void put(float4& v, int w, float x) {
  (w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w) = x;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
groups_copy(const float* __restrict__ fields, int n, float* __restrict__ out) {
  typedef typename Vec<W>::T T;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i > n) return;
  for (int g = 0; g * W < 9; ++g) {
    T v;
#pragma unroll
    for (int w = 0; w < W; ++w)
      put(v, w, (i < n && g * W + w < 9) ? fields[(size_t)(g * W + w) * n + i] : 0.0f);
    reinterpret_cast<T*>(out + (size_t)g * (n + 1) * W)[i] = v;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
grouped_gather(const float* __restrict__ src, long long m, const int32_t* __restrict__ idx,
               const int32_t* __restrict__ map, int n, float* __restrict__ out) {
  typedef typename Vec<W>::T T;
  const int g = blockIdx.y;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx + 4 * q));
  int s[4] = {ix.x, ix.y, ix.z, ix.w};
  if (map) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = map[s[c]];
  }
  const T* base = reinterpret_cast<const T*>(src + (size_t)g * m * W);
  T v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = base[s[c]];
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (g * W + w < 9)
      __stcs(reinterpret_cast<float4*>(out + (size_t)(g * W + w) * n + 4 * q),
             make_float4(at(v[0], w), at(v[1], w), at(v[2], w), at(v[3], w)));
}
// the mixed layout: fields 0-7 as four (m, 2) groups, field 8 as an (m,)
// row after them; grid row g < 4 a pair, 4 the single row
__global__ void __launch_bounds__(kThreads)
mixed_copy(const float* __restrict__ fields, int n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i > n) return;
  const size_t m = (size_t)n + 1;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    reinterpret_cast<float2*>(out + g * m * 2)[i] =
        i < n ? make_float2(fields[(size_t)(2 * g) * n + i], fields[(size_t)(2 * g + 1) * n + i])
              : make_float2(0.0f, 0.0f);
  out[8 * m + i] = i < n ? fields[(size_t)8 * n + i] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
mixed_gather(const float* __restrict__ src, long long m, const int32_t* __restrict__ idx,
             int n, float* __restrict__ out) {
  const int g = blockIdx.y;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx + 4 * q));
  if (g < 4) {
    const float2* base = reinterpret_cast<const float2*>(src + (size_t)g * m * 2);
    const float2 a = base[ix.x], b = base[ix.y], c = base[ix.z], d = base[ix.w];
    __stcs(reinterpret_cast<float4*>(out + (size_t)(2 * g) * n + 4 * q),
           make_float4(a.x, b.x, c.x, d.x));
    __stcs(reinterpret_cast<float4*>(out + (size_t)(2 * g + 1) * n + 4 * q),
           make_float4(a.y, b.y, c.y, d.y));
  } else {
    const float* base = src + (size_t)8 * m;
    __stcs(reinterpret_cast<float4*>(out + (size_t)8 * n + 4 * q),
           make_float4(base[ix.x], base[ix.y], base[ix.z], base[ix.w]));
  }
}
}  // namespace

extern "C" int probe_mixed_copy(const void* fields, int n, void* out, void* stream) {
  const unsigned blocks = (unsigned)(((long long)n + 1 + kThreads - 1) / kThreads);
  mixed_copy<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_mixed_gather(const void* src, long long m, const void* idx, int n,
                                  void* out, void* stream) {
  const dim3 grid((unsigned)(((long long)n / 4 + kThreads - 1) / kThreads), 5);
  mixed_gather<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), m, static_cast<const int32_t*>(idx), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_groups_copy(const void* fields, int n, int w, void* out, void* stream) {
  const unsigned blocks = (unsigned)(((long long)n + 1 + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(fields);
  float* o = static_cast<float*>(out);
  if (w == 1) groups_copy<1><<<blocks, kThreads, 0, st>>>(f, n, o);
  else if (w == 2) groups_copy<2><<<blocks, kThreads, 0, st>>>(f, n, o);
  else groups_copy<4><<<blocks, kThreads, 0, st>>>(f, n, o);
  return static_cast<int>(cudaGetLastError());
}

// n % 4 == 0; groups: how many grid rows (groups) to gather
extern "C" int probe_grouped_gather(const void* src, long long m, int w, int groups,
                                    const void* idx, const void* map, int n, void* out,
                                    void* stream) {
  const dim3 grid((unsigned)(((long long)n / 4 + kThreads - 1) / kThreads), groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(src);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const int32_t* mp = static_cast<const int32_t*>(map);
  float* o = static_cast<float*>(out);
  if (w == 1) grouped_gather<1><<<grid, kThreads, 0, st>>>(a, m, ix, mp, n, o);
  else if (w == 2) grouped_gather<2><<<grid, kThreads, 0, st>>>(a, m, ix, mp, n, o);
  else grouped_gather<4><<<grid, kThreads, 0, st>>>(a, m, ix, mp, n, o);
  return static_cast<int>(cudaGetLastError());
}
"""


# The record-major form: rows of 12 floats, a splat's (or a record's) nine
# values and three zero pad words in 48 B, two sectors. splat_rows gives a
# thread a splat, stages the block's rows in shared memory and stores them
# as consecutive 16-byte words; row_gather gives a thread four records,
# out[f, j] = rows[s][f] with s = idx[j] or map[idx[j]]: the four ids in
# one evict-first load, the four rows (two 16-byte loads and one 4-byte
# load each) in flight at once, each output row one evict-first 16-byte
# store.
ROW_KERNELS = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kRow = 12;

__global__ void __launch_bounds__(kThreads)
splat_rows(const float* __restrict__ fields, int n, float4* __restrict__ out) {
  __shared__ float4 rows[kThreads * 3];
  const long long first = (long long)blockIdx.x * kThreads;
  const long long i = first + threadIdx.x;
  float v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = i < n ? fields[(size_t)k * n + i] : 0.0f;
  rows[3 * threadIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
  rows[3 * threadIdx.x + 1] = make_float4(v[4], v[5], v[6], v[7]);
  rows[3 * threadIdx.x + 2] = make_float4(v[8], 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int m = (int)min((long long)kThreads, (long long)n + 1 - first);
  for (int q = threadIdx.x; q < 3 * m; q += kThreads) out[3 * first + q] = rows[q];
}

__device__ __forceinline__ void load_row(const float* __restrict__ src, int s,
                                         float (&v)[9]) {
  const float4* r = reinterpret_cast<const float4*>(src + (size_t)s * kRow);
  const float4 a = r[0], b = r[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = src[(size_t)s * kRow + 8];
}

__global__ void __launch_bounds__(kThreads)
row_gather(const float* __restrict__ src, const int32_t* __restrict__ idx,
           const int32_t* __restrict__ map, int n, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * q >= n) return;
  if (n % 4 == 0) {
    const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx + 4 * q));
    int s[4] = {ix.x, ix.y, ix.z, ix.w};
    if (map) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = map[s[c]];
    }
    float v[4][9];
#pragma unroll
    for (int c = 0; c < 4; ++c) load_row(src, s[c], v[c]);
#pragma unroll
    for (int k = 0; k < 9; ++k)
      __stcs(reinterpret_cast<float4*>(out + (size_t)k * n + 4 * q),
             make_float4(v[0][k], v[1][k], v[2][k], v[3][k]));
    return;
  }
  for (long long c = 4 * q; c < 4 * q + 4 && c < n; ++c) {
    float v[9];
    load_row(src, map ? map[idx[c]] : idx[c], v);
#pragma unroll
    for (int k = 0; k < 9; ++k) out[(size_t)k * n + c] = v[k];
  }
}
}  // namespace

extern "C" int probe_splat_rows(const void* fields, int n, void* out, void* stream) {
  const unsigned blocks = (unsigned)(((long long)n + 1 + kThreads - 1) / kThreads);
  splat_rows<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), n, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// idx, out 16-byte aligned
extern "C" int probe_row_gather(const void* src, const void* idx, const void* map, int n,
                                void* out, void* stream) {
  if (n == 0) return 0;
  const long long quads = ((long long)n + 3) / 4;
  row_gather<<<(unsigned)((quads + kThreads - 1) / kThreads), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(map), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def splat_rows_plain(fields):
    """The record rows of (9, N) ``fields`` in plain torch: (N + 1, 12), row
    s splat s's fields and three zeros, row N zero."""
    out = fields.new_zeros((fields.shape[1] + 1, 12))
    out[:-1, :9] = fields.t()
    return out


def splat_rows(lib, fields, stream):
    """``probe_splat_rows``: the record rows of (9, N) ``fields``."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    out = torch.empty((fields.shape[1] + 1, 12), dtype=torch.float32, device=fields.device)
    build.check("splat rows", lib.probe_splat_rows(fields.data_ptr(), fields.shape[1],
                                                   out.data_ptr(), stream))
    return out


def row_gather(lib, rows, idx, map_, stream):
    """``probe_row_gather``: (9, C) out[f, j] = rows[s, f], s = idx[j] or
    map_[idx[j]]."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    c = idx.shape[0]
    out = torch.empty((9, c), dtype=torch.float32, device=idx.device)
    build.check("row gather", lib.probe_row_gather(
        rows.data_ptr(), idx.data_ptr(), None if map_ is None else map_.data_ptr(), c,
        out.data_ptr(), stream))
    return out


def field_stage(fields, words, num_tiles, key, inverse=True):
    """The (9, C) form of the stage, the one the stage by splat replaced:
    the counts and the passes (``record_sort._order``), then the row gather
    of the records' own nine field rows by the sorted source index
    (``gs_record_gather``). Returns (sorted fields, bounds, inverse or
    None)."""
    import types

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs

    si, bounds, inv = rs._order(words, num_tiles, key, inverse,
                                types.SimpleNamespace(launches=0))
    return rs._gather(fields, si, 0, "the (9, C) form"), bounds, inv


def layout_library(tmp: Path):
    """LAYOUT_KERNELS and ROW_KERNELS built on their own in ``tmp``: (ctypes
    library)."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    tmp.mkdir()
    (tmp / "layouts.cu").write_text(LAYOUT_KERNELS)
    (tmp / "rows.cu").write_text(ROW_KERNELS)
    lib = ctypes.CDLL(str(build.build_library(tmp, tmp / "out")[0]))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_groups_copy.argtypes = [P, I, I, P, P]
    lib.probe_grouped_gather.argtypes = [P, L, I, I, P, P, I, P, P]
    lib.probe_groups_copy.restype = lib.probe_grouped_gather.restype = ctypes.c_int
    lib.probe_mixed_copy.argtypes = [P, I, P, P]
    lib.probe_mixed_gather.argtypes = [P, L, P, I, P, P]
    lib.probe_mixed_copy.restype = lib.probe_mixed_gather.restype = ctypes.c_int
    lib.probe_splat_rows.argtypes = [P, I, P, P]
    lib.probe_row_gather.argtypes = [P, P, P, I, P, P]
    lib.probe_splat_rows.restype = lib.probe_row_gather.restype = ctypes.c_int
    return lib


# The compositor backward's (kernel 5's) cotangent stores, and a copy whose
# stores go to (C, 12) record rows where g_rows is set: a record's nine
# values and three zero pad words, three 16-byte stores, its zeros too.
BWD_STORES = """        const int idx = gs::staged_index(sm, chunk, k);
        drec[idx] = ca * s[1] + cbn * s[2];                       // d mx
        drec[rec_stride + idx] = cc * s[2] + cbn * s[1];          // d my
        drec[2 * rec_stride + idx] = -0.5f * s[3];                // d A
        drec[3 * rec_stride + idx] = -s[4];                       // d B
        drec[4 * rec_stride + idx] = -0.5f * s[5];                // d C
        drec[5 * rec_stride + idx] = s[0] / fmaxf(op, 1e-12f);    // d opacity
        drec[6 * rec_stride + idx] = s[6];                        // d colour
        drec[7 * rec_stride + idx] = s[7];
        drec[8 * rec_stride + idx] = s[8];
"""
BWD_ROW_STORES = """        const int idx = gs::staged_index(sm, chunk, k);
        const float d[9] = {ca * s[1] + cbn * s[2], cc * s[2] + cbn * s[1], -0.5f * s[3],
                            -s[4], -0.5f * s[5], s[0] / fmaxf(op, 1e-12f), s[6], s[7], s[8]};
        gs::store_rec(drec, rec_stride, idx, d);
"""
BWD_ZEROS = re.compile(r"#pragma unroll\n\s*for \(int j = 0; j < (kSums|9); \+\+j\) "
                       r"drec\[\(size_t\)j \* rec_stride \+ idx\] = 0\.0f;")
BWD_HELPERS = """namespace gs {

static __device__ float* g_rows;

__device__ __forceinline__ void store_rec(float* drec, int stride, int idx,
                                          const float (&v)[9]) {
  if (g_rows != nullptr) {
    float4* r = reinterpret_cast<float4*>(g_rows + (size_t)idx * 12);
    r[0] = make_float4(v[0], v[1], v[2], v[3]);
    r[1] = make_float4(v[4], v[5], v[6], v[7]);
    r[2] = make_float4(v[8], 0.0f, 0.0f, 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < 9; ++j) drec[(size_t)j * stride + idx] = v[j];
  }
}

__device__ __forceinline__ void zero_rec(float* drec, int stride, int idx) {
  const float z[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  store_rec(drec, stride, idx, z);
}
"""
BWD_SETTER = """
extern "C" int gs_probe_set_rows(void* rows) {
  return static_cast<int>(cudaMemcpyToSymbol(gs::g_rows, &rows, sizeof(rows)));
}
"""


def bwd_rows_library(tmp: Path):
    """The compositor's sources with kernel 5's record-row stores, built on
    their own in ``tmp``: (ctypes library)."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    common = (build.CSRC / "composite_common.cuh").read_text()
    bwd = (build.CSRC / "composite_bwd.cu").read_text()
    if (bwd.count(BWD_STORES) != 1 or len(BWD_ZEROS.findall(bwd)) != 2
            or len(BWD_ZEROS.findall(common)) != 1 or common.count("namespace gs {\n") != 1):
        raise RuntimeError("the compositor's sources changed: its stores not found")
    zero = "gs::zero_rec(drec, rec_stride, idx);"
    common = BWD_ZEROS.sub(zero.replace("gs::", ""), common).replace(
        "namespace gs {\n", BWD_HELPERS, 1)
    bwd = BWD_ZEROS.sub(zero, bwd.replace(BWD_STORES, BWD_ROW_STORES)) + BWD_SETTER
    tmp.mkdir()
    (tmp / "composite_common.cuh").write_text(common)
    (tmp / "composite_bwd.cu").write_text(bwd)
    (tmp / "composite.cu").write_text((build.CSRC / "composite.cu").read_text())
    lib = ctypes.CDLL(str(build.build_library(tmp, tmp / "out")[0]))
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.gs_probe_set_rows.argtypes = [ctypes.c_void_p]
    lib.gs_probe_set_rows.restype = ctypes.c_int
    return lib


def layout_rows(lib, fields, sid, si, sf, inv, g, stream) -> dict:
    """Device us of the forward's gather by splat from each layout (the
    copy, the sorted records' splat ids read through the index, the
    groups) and of the un-sort from each layout of the record cotangents,
    each held bit for bit to the production stage's outputs."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    n, c = fields.shape[1], si.shape[0]
    dev = fields.device
    row = {}
    ssid = torch.empty((1, c), dtype=torch.int32, device=dev)

    def sorted_ids():      # ssid = sid[si], the one-row gather
        build.check("ids", lib.probe_grouped_gather(sid.data_ptr(), c, 1, 1, si.data_ptr(),
                                                    None, c, ssid.data_ptr(), stream))

    sorted_ids()
    torch.cuda.synchronize()
    if not torch.equal(ssid[0], sid[si.to(torch.int64)]):
        raise AssertionError("the sorted splat ids differ")
    row["sorted_ids_us"] = launches_us(sorted_ids)
    for w in (1, 2, 4):
        groups = -(-9 // w)
        buf = fields if w == 1 else torch.empty(groups * (n + 1) * w, device=dev)
        m = n if w == 1 else n + 1
        out = torch.empty((9, c), device=dev)

        def copy(w=w, buf=buf):
            build.check("copy", lib.probe_groups_copy(fields.data_ptr(), n, w,
                                                      buf.data_ptr(), stream))

        def gather(w=w, buf=buf, m=m, out=out, groups=groups):
            build.check("gather", lib.probe_grouped_gather(
                buf.data_ptr(), m, w, groups, ssid.data_ptr(), None, c, out.data_ptr(),
                stream))

        if w > 1:
            copy()
            row[f"copy_w{w}_us"] = launches_us(copy)
        # records past the total read row n: the table's own rows (w = 1)
        # have none, so there the ids past the total are clamped
        if w == 1:
            safe = torch.clamp_max(ssid, n - 1)
            build.check("gather", lib.probe_grouped_gather(
                buf.data_ptr(), m, 1, groups, safe.data_ptr(), None, c, out.data_ptr(),
                stream))
            torch.cuda.synchronize()
            live = ssid[0] < n
            if not torch.equal(out[:, live], sf[:, live]):
                raise AssertionError("the gather from the table's rows differs")
            row["gather_w1_table_us"] = launches_us(
                lambda: lib.probe_grouped_gather(buf.data_ptr(), m, 1, groups,
                                                 safe.data_ptr(), None, c, out.data_ptr(),
                                                 stream))
            continue
        gather()
        torch.cuda.synchronize()
        if not torch.equal(out, sf):
            raise AssertionError(f"the gather from groups of {w} differs")
        row[f"gather_w{w}_us"] = launches_us(gather)
        del buf, out
    mixed = torch.empty(9 * (n + 1), device=dev)
    out = torch.empty((9, c), device=dev)

    def mixed_copy():
        build.check("copy", lib.probe_mixed_copy(fields.data_ptr(), n, mixed.data_ptr(),
                                                 stream))

    def mixed_gather():
        build.check("gather", lib.probe_mixed_gather(mixed.data_ptr(), n + 1,
                                                     ssid.data_ptr(), c, out.data_ptr(),
                                                     stream))

    mixed_copy()
    mixed_gather()
    torch.cuda.synchronize()
    if not torch.equal(out, sf):
        raise AssertionError("the gather from the mixed layout differs")
    row["copy_mixed_us"] = launches_us(mixed_copy)
    row["gather_mixed_us"] = launches_us(mixed_gather)
    del mixed, out
    # the un-sort from groups of the record cotangents (random values: the
    # layout, not the values, sets the time), against the (9, C) rows
    for w in (2, 4):
        groups = -(-9 // w)
        src = torch.zeros(groups * c * w, device=dev)
        view = src.view(groups, c, w)
        for f in range(9):
            view[f // w, :, f % w] = g[f]
        out = torch.empty((9, c), device=dev)

        def unsort(w=w, src=src, out=out, groups=groups):
            build.check("unsort", lib.probe_grouped_gather(
                src.data_ptr(), c, w, groups, inv.data_ptr(), None, c, out.data_ptr(),
                stream))

        unsort()
        torch.cuda.synchronize()
        want = g.index_select(1, inv.to(torch.int64))
        if not torch.equal(out, want):
            raise AssertionError(f"the un-sort from groups of {w} differs")
        row[f"unsort_w{w}_us"] = launches_us(unsort)
        del src, view, out
    return row


def launches_us(fn, runs: int = 7):
    """[(name, median us)] of each device launch of one call, in order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        got = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)
        seen.append([(e.name.split("(")[0][-40:] or e.name[:40], e.time_range.elapsed_us())
                     for e in got])
    seen = [r for r in seen if len(r) == len(seen[0])]
    return [(seen[0][j][0], statistics.median(r[j][1] for r in seen))
            for j in range(len(seen[0]))]


def _order_only(words, num_tiles, key):
    """The stage's counts and passes alone (``record_sort._order``):
    (sorted source index, bounds, inverse), int32."""
    import types

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs

    return rs._order(words, num_tiles, key, True, types.SimpleNamespace(launches=0))


def compositor_rows(lib, layouts, sf, bounds, inv, cfg, stream) -> dict:
    """Device us of kernel 5 storing (9, C) field rows (the production
    library's), of its copy storing (C, 12) record rows (``lib``, the
    pointer set) and of that copy with the pointer unset, and of the
    un-sort of the record rows (``row_gather`` by the inverse) against the
    production un-sort of the field rows; each held bit for bit."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs

    ckw = fastpath.composite_kwargs(1024, 512, cfg)
    tiles = torch.arange(cfg.num_tiles, dtype=torch.int32, device=sf.device)
    ox, oy = kc.tile_origins(tiles, ckw["pw"], ckw["ph"], cfg.grid_x)
    img = kc.composite(sf, bounds, ox, oy, **ckw)
    g = torch.randn(img.shape, device=sf.device,
                    generator=torch.Generator(device=sf.device).manual_seed(5))

    def bwd():
        return kc.composite_bwd(sf, bounds, ox, oy, img, g, **ckw)

    d = bwd()
    row = {"composite_bwd_us": launches_us(bwd)}
    rows = torch.empty((sf.shape[1], 12), device=sf.device)
    load = build.load_library
    build.load_library = lambda: lib
    try:
        variant_fields = bwd()
        row["composite_bwd_variant_fields_us"] = launches_us(bwd)
        build.check("set", lib.gs_probe_set_rows(rows.data_ptr()))
        bwd()
        torch.cuda.synchronize()
        row["composite_bwd_rows_us"] = launches_us(bwd)
        build.check("set", lib.gs_probe_set_rows(None))
    finally:
        build.load_library = load
    if not (torch.equal(variant_fields, d) and torch.equal(rows[:, :9].t(), d)
            and not rows[:, 9:].any()):
        raise AssertionError("kernel 5's record rows differ from its field rows")
    want = rs.record_unsort(d, inv)
    if not torch.equal(row_gather(layouts, rows, inv, None, stream), want):
        raise AssertionError("the un-sort of record rows differs")
    row["unsort_rows_us"] = launches_us(lambda: row_gather(layouts, rows, inv, None, stream))
    row["unsort_fields_us"] = launches_us(lambda: rs.record_unsort(d, inv))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splats", type=int, default=3_616_103)
    args = ap.parse_args(argv)
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import card_line, require_device

    dev = require_device("cuda")
    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
    from openglgaussiansplattingrenderer_tpu_torch.render import autotune_capacity, camera_args

    card = card_line(dev)
    print(card, flush=True)
    scene = ply_io.make_synthetic_scene(args.splats, seed=99, extent=3.0,
                                        log_scale_range=(-5.8, -3.6))
    params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"}, dev)
    cam = Camera(0.0, 0.0, -8.0, width=1024, height=512)
    a = camera_args(cam)
    cargs = (torch.as_tensor(a["view"], device=dev), torch.as_tensor(a["vp"], device=dev),
             a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])
    cfg0 = RenderConfig.for_resolution(1024, 512, tile_px=32, chunk=256)
    cfg = autotune_capacity(params, *cargs, 1024, 512, cfg0)
    t = cfg.num_tiles
    out = {"card": card, "splats": args.splats, "tiles": t}
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        load = build.load_library
        load()
        var = variant_library(Path(tmp))
        hints = hinted_gathers(Path(tmp))
        scatter = gather_library(Path(tmp) / "scatter", SCATTER_KERNEL)
        table_lib = table_rows_library(Path(tmp) / "table")
        layouts = layout_library(Path(tmp) / "layouts")
        bwd_lib = bwd_rows_library(Path(tmp) / "bwd")
        stream = build.stream_ptr()
        table, prep = fastpath.splat_table(params, *cargs, 1024, 512, cfg, pairs=True)
        kw = fastpath.expand_kwargs(args.splats, 1024, 512, cfg)
        cum = ks.cumsum(prep["counts"])
        fields, pairs = table[0], prep["pairs"]
        n = fields.shape[1]
        if not torch.equal(pairs, kt.splat_pairs_plain(fields)):
            raise AssertionError("the pair layout differs from its plain version")
        copy = splat_rows(layouts, fields, stream)
        mixed = torch.empty_like(pairs)

        def pairs_copy():
            build.check("copy", layouts.probe_mixed_copy(fields.data_ptr(), n,
                                                         mixed.data_ptr(), stream))

        pairs_copy()
        torch.cuda.synchronize()
        if not (torch.equal(copy, splat_rows_plain(fields)) and torch.equal(mixed, pairs)):
            raise AssertionError("a transpose differs from its plain version")
        out["splat_rows_us"] = launches_us(lambda: splat_rows(layouts, fields, stream))
        out["splat_pairs_us"] = launches_us(pairs_copy)
        del mixed

        def table_call(with_pairs=False):
            return kt.splat_table(params, *cargs, 1024, 512, cfg, pairs=with_pairs)

        out["table_us"] = launches_us(table_call)
        out["table_pairs_us"] = launches_us(lambda: table_call(True))
        kt._library.cache_clear()
        build.load_library = lambda: table_lib
        try:
            rows_buf = torch.zeros_like(copy)
            build.check("set", table_lib.gs_probe_set_rows(rows_buf.data_ptr()))
            table_call()
            torch.cuda.synchronize()
            if not torch.equal(rows_buf, copy):
                raise AssertionError("the splat table's record rows differ from splat_rows")
            out["table_rows_us"] = launches_us(table_call)
            build.check("set", table_lib.gs_probe_set_rows(None))
        finally:
            build.load_library = load
            kt._library.cache_clear()
        del rows_buf
        print("copy", json.dumps({k: out[k] for k in (
            "splat_rows_us", "splat_pairs_us", "table_us", "table_pairs_us",
            "table_rows_us")}), flush=True)
        for key in ("pair", "packed"):
            rec_f, rec_t, rec_d = kr.expand(*table, cum, **kw)
            sid, _, _, word = kr.expand_ids(*table, cum, **kw, key=key)
            words = rs.words_of(rec_t, rec_d, key, word)
            c = rec_f.shape[1]
            sf, bounds, inv = field_stage(rec_f, words, t, key)
            g = torch.randn((kr.NUM_FIELDS, c), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
            row = {"records": c,
                   "stage_us": launches_us(lambda: field_stage(rec_f, words, t, key)),
                   "unsort_us": launches_us(lambda: rs.record_unsort(g, inv)),
                   "gather_hints_us": {}}

            # the stage by splat on the pair layout; the record-major form's
            # two options
            def by_splat():
                return rs.record_sort_splats_fwd(fields, pairs, sid, words, t, key)

            def rows_option(map_in_last_pass):
                rows = splat_rows(layouts, fields, stream)
                si2, bounds2, inv2 = _order_only(words, t, key)
                return (row_gather(layouts, rows, si2, None if map_in_last_pass else sid,
                                   stream), bounds2, inv2)

            rx._library_chunk.cache_clear()
            build.load_library = lambda: var
            try:
                build.check("set", var.gs_probe_set_map(sid.data_ptr()))
                option1 = rows_option(True)
                row["record_rows_option1_us"] = launches_us(lambda: rows_option(True))
                build.check("set", var.gs_probe_set_map(None))
            finally:
                build.load_library = load
                rx._library_chunk.cache_clear()
            for what, got in (("by splat", by_splat()), ("record rows, option 1", option1),
                              ("record rows, option 2", rows_option(False))):
                if not (torch.equal(got[0], sf) and torch.equal(got[1], bounds)
                        and torch.equal(got[2], inv)):
                    raise AssertionError(f"{key}: the stage {what} differs")
            row["splat_stage_us"] = launches_us(by_splat)
            row["record_rows_option2_us"] = launches_us(lambda: rows_option(False))
            del option1
            row["expand_us"] = launches_us(lambda: kr.expand(*table, cum, **kw))
            row["expand_ids_us"] = launches_us(
                lambda: kr.expand_ids(*table, cum, **kw, key=key))
            if key == "pair":
                row.update(compositor_rows(bwd_lib, layouts, sf, bounds, inv, cfg, stream))
            si_ = torch.empty_like(inv)
            si_[inv.to(torch.int64)] = torch.arange(c, dtype=torch.int32, device=dev)
            row["layouts"] = layout_rows(layouts, fields, sid, si_, sf, inv, g, stream)
            del si_
            si = torch.empty_like(inv)
            si[inv.to(torch.int64)] = torch.arange(c, dtype=torch.int32, device=dev)
            for hname, lib in [("evict first", load())] + list(hints.items()):
                hout = torch.empty_like(rec_f)

                def gather(lib=lib, hout=hout):
                    build.check("gather", lib.gs_record_gather(
                        rec_f.data_ptr(), si.data_ptr(), c, 0, hout.data_ptr(), stream))

                gather()
                torch.cuda.synchronize()
                if not torch.equal(hout, sf):
                    raise AssertionError(f"{key}: the {hname} gather differs")
                row["gather_hints_us"][hname] = launches_us(gather)[0][1]
            unsorted = rs.record_unsort(g, inv)
            sout = torch.empty_like(g)

            def unsort_scatter():
                build.check("scatter", scatter.gs_record_gather(
                    g.data_ptr(), si.data_ptr(), c, 0, sout.data_ptr(), stream))

            unsort_scatter()
            torch.cuda.synchronize()
            if not torch.equal(sout, unsorted):
                raise AssertionError(f"{key}: the scatter un-sort differs")
            row["unsort_scatter_us"] = launches_us(unsort_scatter)
            # the variants: route the wrappers to the variant library
            fused = torch.empty_like(rec_f)
            rx._library_chunk.cache_clear()
            build.load_library = lambda: var
            try:
                build.check("set", var.gs_probe_set_gather(rec_f.data_ptr(), fused.data_ptr()))
                nine = field_stage(rec_f, words, t, key)[0]
                torch.cuda.synchronize()
                if not (torch.equal(fused, sf) and torch.equal(nine, sf)):
                    raise AssertionError(f"{key}: a variant's fields differ from the stage's")
                row["fused_last_pass_stage_us"] = launches_us(
                    lambda: field_stage(rec_f, words, t, key))
                build.check("set", var.gs_probe_set_gather(None, None))
                row["nine_rows_stage_us"] = launches_us(
                    lambda: field_stage(rec_f, words, t, key))
            finally:
                build.load_library = load
                rx._library_chunk.cache_clear()
            out[key] = row
            print(key, json.dumps(row), flush=True)
            del rec_f, rec_t, rec_d, word, words, sf, inv, g, fused, nine, si, sout, unsorted, sid
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
