#!/usr/bin/env python3
"""Where the port's expansion and segment-sum kernels (kernels 2 and 3,
``csrc/expand.cu`` and ``csrc/segsum.cu``) spend their time, on one NVIDIA
GPU.

    python3 scripts/torch_records_probe.py [--parent CHECKOUT]

On the uniform 3,616,103-splat flagship table (1024x512) and the
1,000,000-splat 1920x1080 scene of ``chip_smoke.py`` it prints JSON lines:

- ``kernels``: each kernel's time on the device alone (torch.profiler, by
  kernel name; the segment sum is two launches) and, with ``--parent``, the
  same for the kernels of another checkout of the port (its
  ``csrc/expand.cu`` and ``csrc/segsum.cu`` built alone, its outputs held
  equal or within 1e-5 of the row's scale);
- ``phases``: a block's life, cut by barriers into phases, from
  ``globaltimer`` sums that thread 0 of each block keeps in a copy of the
  sources (the barriers cost a little; the copy is timed once), and the
  blocks alive on average;
- ``variant``: the kernels rebuilt with one constant changed (pieces a
  block takes, items a piece holds, the segment sum's register cap), each
  checked against the plain versions and timed on the device alone.

Needs a card and nvcc; the copies are built under ``build/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMP_HEAD = r'''
static __device__ unsigned long long g_stamp[1 << 20];
static __shared__ unsigned long long g_last;
__device__ __forceinline__ unsigned long long now_() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
#define STAMP0 do { if (threadIdx.x == 0) { g_last = now_(); \
  g_stamp[(size_t)blockIdx.x * 8] = g_last; } } while (0)
#define ACC(k) do { __syncthreads(); if (threadIdx.x == 0) { unsigned long long t_ = now_(); \
  g_stamp[(size_t)blockIdx.x * 8 + (k)] += t_ - g_last; g_last = t_; } } while (0)
#define STAMP_END do { if (threadIdx.x == 0) g_stamp[(size_t)blockIdx.x * 8 + 6] = now_(); } while (0)
'''
STAMP_GETTER = r'''
extern "C" int stamps_NAME(void* dst, int count, int clear) {
  if (clear) { void* a; cudaGetSymbolAddress(&a, g_stamp);
    return (int)cudaMemset(a, 0, sizeof(unsigned long long) * count); }
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(unsigned long long) * count);
}
'''
# (text, text that replaces it) in each source: the stamps of each phase
STAMPS = {
    "expand.cu": [
        ("  Window& w = *reinterpret_cast<Window*>(smem);\n",
         "  Window& w = *reinterpret_cast<Window*>(smem);\n  STAMP0;\n"),
        ("    records::block_splits(cum_incl, n, total, first, merged, s_split);\n",
         "    records::block_splits(cum_incl, n, total, first, merged, s_split);\n    ACC(1);\n"),
        ("      records::copies_arrived();\n      __syncthreads();\n",
         "      records::copies_arrived();\n      __syncthreads();\n      ACC(2);\n"),
        ("      __syncthreads();\n      // a thread's records only grow",
         "      __syncthreads();\n      ACC(3);\n      // a thread's records only grow"),
        ("make_record(w, i, r, gx, num_tiles, pw, ph, o);\n                   });\n",
         "make_record(w, i, r, gx, num_tiles, pw, ph, o);\n                   });\n      ACC(4);\n"),
        ("  }\n}\n\n}  // namespace", "  }\n  ACC(5);\n  STAMP_END;\n}\n\n}  // namespace"),
    ],
    "segsum.cu": [
        ("  if (first_item >= merged) return;\n", "  if (first_item >= merged) return;\n  STAMP0;\n"),
        ("  records::block_splits(cum_incl, n, total, first_item, merged, s_split);\n",
         "  records::block_splits(cum_incl, n, total, first_item, merged, s_split);\n  ACC(1);\n"),
        ("  records::copies_arrived();\n  __syncthreads();\n",
         "  records::copies_arrived();\n  __syncthreads();\n  ACC(2);\n"),
        ("  mine.closed = head_end >= 0;\n", "  mine.closed = head_end >= 0;\n  ACC(3);\n"),
        ("    first[q] = nends > 0 ? p.s0 : -1;\n  }\n}\n",
         "    first[q] = nends > 0 ? p.s0 : -1;\n  }\n  ACC(4);\n}\n"),
        ("the shared rows are refilled for the next piece\n  }\n}\n",
         "the shared rows are refilled for the next piece\n  }\n  ACC(5);\n  STAMP_END;\n}\n"),
    ],
}
PHASES = {"expand": ["splits search", "window copies", "ln/ext pass", "records", "tail"],
          "segsum": ["splits search", "copies", "walk", "scan + stores", "rest"]}
# name -> (file, text, replacement): one constant changed
VARIANTS = {
    "pieces=1": ("records_common.cuh", "kPieces = 2;", "kPieces = 1;"),
    "pieces=4": ("records_common.cuh", "kPieces = 2;", "kPieces = 4;"),
    "pieces=7": ("records_common.cuh", "kPieces = 2;", "kPieces = 7;"),
    "items=512": ("records_common.cuh", "kItems = 1024;", "kItems = 512;"),
    "segsum min blocks=4": ("segsum.cu", "__launch_bounds__(kThreads)\nsegsum(",
                            "__launch_bounds__(kThreads, 4)\nsegsum("),
}


def library(csrc: Path, edit=None, stamps=False):
    """(ctypes library of csrc's expand.cu and segsum.cu, ptxas lines),
    built in a copy under build/ with the edits applied."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    d = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    for name in ("expand.cu", "segsum.cu", "records_common.cuh"):
        if (csrc / name).exists():
            shutil.copy(csrc / name, d)
    if edit:
        f, a, b = edit
        text = (d / f).read_text()
        assert text.count(a) == 1, edit
        (d / f).write_text(text.replace(a, b))
    if stamps:
        for name, subs in STAMPS.items():
            text = (d / name).read_text().replace(
                '#include "records_common.cuh"\n', '#include "records_common.cuh"\n' + STAMP_HEAD)
            for a, b in subs:
                assert text.count(a) == 1, (name, a)
                text = text.replace(a, b)
            (d / name).write_text(text + STAMP_GETTER.replace("NAME", name[:-3]))
    path, _, ptx = build.build_library(d, d / "out")
    lib = ctypes.CDLL(str(path))
    for name in ("gs_records_items", "gs_expand", "gs_segsum"):
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
    return lib, [ln.split(":")[-1].strip() for ln in ptx.splitlines() if "Used" in ln]


def device_by_kernel(fn, calls: int = 20) -> dict:
    """Mean device time of each kernel one call of fn launches, in us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out


class Case:
    """A scene's splat table, prefix sum and cotangent, with the plain
    versions' outputs, and calls of either kernel through a library."""

    def __init__(self, scene_kw, w, h, chunk):
        import torch

        import chip_smoke as cs
        from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
        from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
        from openglgaussiansplattingrenderer_tpu_torch.render import autotune_capacity

        dev = torch.device("cuda")
        cfg0 = RenderConfig.for_resolution(w, h, tile_px=32, chunk=chunk)
        frame = cs.Frame(ply_io.make_synthetic_scene(**scene_kw),
                         Camera(0.0, 0.0, -8.0, width=w, height=h), cfg0, dev)
        frame.cfg = autotune_capacity(frame.params, *frame.args[:6], w, h, cfg0)
        self.table, counts, self.kw = frame.table()
        self.cum = ks.cumsum(counts)
        self.n, self.cap = counts.numel(), self.kw["capacity"]
        self.ref = kr.expand_plain(*self.table, self.cum, **self.kw)
        gen = torch.Generator(device=dev).manual_seed(5)
        self.g = torch.randn((kr.NUM_FIELDS, self.cap), generator=gen, device=dev)
        self.sref = kr.segsum_plain(self.g, self.cum)
        self.outs = (torch.empty_like(self.ref[0]), torch.empty_like(self.ref[1]),
                     torch.empty_like(self.ref[2]), torch.empty_like(self.sref))
        # carry slots for pieces of 256 items or more: every variant's
        self.scratch = torch.empty(10 * -(-(self.n + self.cap) // 256), device=dev)

    def expand(self, lib):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr

        t, kw = self.table, self.kw
        of, ot, od, _ = self.outs
        build.check("expand", lib.gs_expand(*(ctypes.c_void_p(x.data_ptr()) for x in
                                              (*t, self.cum)), self.n,
                    *(ctypes.c_void_p(x.data_ptr()) for x in (of, ot, od)), self.cap,
                    kw["gx"], kw["num_tiles"], kw["pw"], kw["ph"],
                    ctypes.c_float(kr._ln_alpha_min(kw["alpha_min"])),
                    ctypes.c_void_p(build.stream_ptr())))

    def segsum(self, lib):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

        ptrs = [ctypes.c_void_p(self.g.data_ptr()), self.cap,
                ctypes.c_void_p(self.cum.data_ptr()), self.n,
                ctypes.c_void_p(self.outs[3].data_ptr())]
        if hasattr(lib, "gs_records_items"):        # the partitioned kernel's scratch
            ptrs.append(ctypes.c_void_p(self.scratch.data_ptr()))
        build.check("segsum", lib.gs_segsum(*ptrs, ctypes.c_void_p(build.stream_ptr())))

    def check(self, lib) -> float:
        """Run both; the expansion must be bit-equal; returns the segment
        sum's worst error of the row's scale."""
        import torch

        self.expand(lib)
        self.segsum(lib)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(self.outs[:3], self.ref))
        scale = self.sref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        rel = float(((self.outs[3] - self.sref).abs() / scale).max())
        assert rel <= 1e-5, rel
        return rel

    def times(self, lib) -> dict:
        return {"expand_us": device_by_kernel(lambda: self.expand(lib)),
                "segsum_us": device_by_kernel(lambda: self.segsum(lib))}

    def phases(self, lib) -> dict:
        import numpy as np
        import torch

        rows = {}
        for name, call in (("expand", self.expand), ("segsum", self.segsum)):
            count = 8 * (1 << 17)
            call(lib)
            getattr(lib, f"stamps_{name}")(None, count, 1)
            torch.cuda.synchronize()
            call(lib)
            torch.cuda.synchronize()
            buf = np.zeros(count, np.uint64)
            getattr(lib, f"stamps_{name}")(ctypes.c_void_p(buf.ctypes.data), count, 0)
            st = buf.reshape(-1, 8).astype(np.float64)
            st = st[st[:, 0] > 0]
            life = st[:, 6] - st[:, 0]
            span = st[:, 6].max() - st[:, 0].min()
            rows[name] = dict(blocks=len(st), span_us=span / 1e3,
                              block_life_us=float(life.mean()) / 1e3,
                              blocks_alive=float(life.sum() / span),
                              phase_us={PHASES[name][k - 1]: float(st[:, k].mean()) / 1e3
                                        for k in range(1, 6)})
        return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout of the port")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_records_probe: no CUDA device", file=sys.stderr)
        return 1
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    (ROOT / "build").mkdir(exist_ok=True)
    csrc = build.CSRC
    scenes = {
        "uniform flagship": (dict(num_splats=3_616_103, seed=99, extent=3.0,
                                  log_scale_range=(-5.8, -3.6)), 1024, 512, 256),
        "1080p": (dict(num_splats=1_000_000, seed=42, extent=3.0, log_scale_range=(-5.5, -3.2)),
                  1920, 1080, 128),
    }
    tree, ptx = library(csrc)
    stamped, _ = library(csrc, stamps=True)
    parent = None
    if args.parent:
        parent, _ = library(args.parent / "openglgaussiansplattingrenderer_tpu_torch" / "csrc")
    with torch.no_grad():
        for scene, spec in scenes.items():
            case = Case(*spec)
            row = dict(scene=scene, tree=case.times(tree), ptxas=ptx,
                       segsum_row_rel_err=case.check(tree))
            if parent is not None:
                case.check(parent)
                row["parent"] = case.times(parent)
            print(json.dumps({"kernels": row}), flush=True)
            case.check(stamped)
            print(json.dumps({"phases": dict(scene=scene, **case.phases(stamped))}), flush=True)
            for name, edit in VARIANTS.items():
                lib, vptx = library(csrc, edit)
                print(json.dumps({"variant": dict(
                    scene=scene, name=name, ptxas=vptx, segsum_row_rel_err=case.check(lib),
                    **case.times(lib))}), flush=True)
            print(json.dumps({"kernels again": dict(scene=scene, tree=case.times(tree))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
