#!/usr/bin/env python3
"""Where the record sort stage's time goes, and two gathers it did not take.

    python3 scripts/torch_record_sort_probe.py            # on a card
    python3 scripts/torch_record_sort_probe.py --splats 1000000

Renders the uniform flagship scene's records (3,616,103 splats at 1024x512,
``chip_smoke.py``'s scene and capacity) and, for the pair and the packed
key, times on the device alone (torch.profiler, median of runs):

- each launch of the stage's forward (``record_sort.record_sort_fwd``: the
  counts, every radix pass, the row gather) and its un-sort;
- two variants built from copies of the sources with a text substitution
  (``build.build_library`` on a temporary directory): the last radix pass
  gathering the nine field rows itself (``fused_last_pass_stage_us``, the
  stage's launches with it, against the production last pass plus its row
  gather in ``stage_us``), and the row gather taking all nine rows of its
  four columns a thread (``nine_rows_stage_us``, against the production
  one row a grid row). Both variants' outputs are held bit for bit to the
  production stage's;
- the row gather alone with and without cache hints (``gather_hints_us``:
  the production gather reads its index and writes its rows evict-first,
  ``__ldcs`` / ``__stcs``, so that they leave L2 to the row being
  gathered; the variants read and write them plainly, or keep the
  gathered reads out of L1 too, ``__ldcg``), each held bit for bit;
- the un-sort's other form (``unsort_scatter_us``, against ``unsort_us``):
  the sorted cotangents read in order and stored through the sorted source
  index, a grid row a field row, held bit for bit.

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
"""
FUSED_SETTER = """
extern "C" int gs_probe_set_gather(const void* in, void* out) {
  cudaError_t e = cudaMemcpyToSymbol(g_gather_in, &in, sizeof(in));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_gather_out, &out, sizeof(out));
  return static_cast<int>(e);
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
    for old in (LAST_PASS_STORE, "typedef unsigned long long u64;\n"):
        if radix.count(old) != 1:
            raise RuntimeError(f"radix_sort.cu changed: {old.strip()!r} not found once")
    radix = radix.replace(LAST_PASS_STORE, FUSED_STORE).replace(
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
    lib.gs_probe_set_gather.restype = ctypes.c_int
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
        table, prep = fastpath.splat_table(params, *cargs, 1024, 512, cfg)
        kw = fastpath.expand_kwargs(args.splats, 1024, 512, cfg)
        cum = ks.cumsum(prep["counts"])
        for key in ("pair", "packed"):
            rec_f, rec_t, rec_d, word = kr.expand(*table, cum, **kw, key=key)
            words = rs.words_of(rec_t, rec_d, key, word)
            c = rec_f.shape[1]
            sf, _, inv = rs.record_sort_fwd(rec_f, words, t, key)
            g = torch.randn((kr.NUM_FIELDS, c), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
            row = {"records": c,
                   "stage_us": launches_us(lambda: rs.record_sort_fwd(rec_f, words, t, key)),
                   "unsort_us": launches_us(lambda: rs.record_unsort(g, inv)),
                   "gather_hints_us": {}}
            si = torch.empty_like(inv)
            si[inv.to(torch.int64)] = torch.arange(c, dtype=torch.int32, device=dev)
            stream = build.stream_ptr()
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
                nine = rs.record_sort_fwd(rec_f, words, t, key)[0]
                torch.cuda.synchronize()
                if not (torch.equal(fused, sf) and torch.equal(nine, sf)):
                    raise AssertionError(f"{key}: a variant's fields differ from the stage's")
                row["fused_last_pass_stage_us"] = launches_us(
                    lambda: rs.record_sort_fwd(rec_f, words, t, key))
                build.check("set", var.gs_probe_set_gather(None, None))
                row["nine_rows_stage_us"] = launches_us(
                    lambda: rs.record_sort_fwd(rec_f, words, t, key))
            finally:
                build.load_library = load
                rx._library_chunk.cache_clear()
            out[key] = row
            print(key, json.dumps(row), flush=True)
            del rec_f, rec_t, rec_d, word, words, sf, inv, g, fused, nine, si, sout, unsorted
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
