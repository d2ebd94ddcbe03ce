#!/usr/bin/env python3
"""Where the port's training-loss kernels (``csrc/ssim_loss.cu``: the
forward ``gs_loss_fwd`` with its slot sum ``gs_loss_sum``, and the backward
``gs_loss_bwd``) spend their time, on one NVIDIA GPU.

    python3 scripts/torch_loss_probe.py [--height 512] [--width 1024]

On one (H, W, 3) image pair (seeded uniform values; pred is the first three
channels of an (H, W, 4) tensor, as the train step reads it; the kernels'
work does not depend on the values) it prints JSON lines:

- ``kernels``: each kernel's time on the device alone (torch.profiler, by
  kernel name), its registers and shared memory (ptxas), the blocks an SM
  holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
  the plan (``gs_loss_plan``: rows a block, segments, blocks);
- ``phases``: a block's life in each kernel cut by its barriers into
  phases, from ``globaltimer`` sums that thread 0 of each block keeps in a
  copy of the source built with ``GS_LOSS_MARK`` defined (each mark adds a
  barrier; the copy is timed once), and the blocks alive on average;
- ``variant``: the kernels rebuilt with one change, each held to the
  tree's loss (within 1e-7 relative) and gradient (1e-6 of its largest)
  and timed on the device alone: the earlier design
  (``scripts/loss_probe_plane_tiles.cu``: a block a 32 x 16 tile of one
  channel, float64 partials), the partials stored as float64, and the taps
  as a multiply and an add (no fma); and, for timing only (their outputs
  are not held), the kernels without their copies after the first band
  and the forward without its partials' stores. The earlier design and the
  tree are timed in turn: earlier, tree, tree, earlier.

Needs a card and nvcc; the copies are built under ``build/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = "ssim_loss.cu"
PLANE_TILES = ROOT / "scripts" / "loss_probe_plane_tiles.cu"
STAMP_HEAD = r'''
static __device__ unsigned long long g_stamp[1 << 17];
static __shared__ unsigned long long g_last;
__device__ __forceinline__ unsigned long long now_() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ size_t slot_() {
  return ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 8; }
#define GS_LOSS_MARK(k) do { if ((k) == 0) { if (threadIdx.x == 0) { g_last = now_(); \
  g_stamp[slot_()] = g_last; } } else { __syncthreads(); if (threadIdx.x == 0) { \
  unsigned long long t_ = now_(); g_stamp[slot_() + (k)] += t_ - g_last; g_last = t_; \
  if ((k) == 4) g_stamp[slot_() + 6] = t_; } } } while (0)
'''
STAMP_GETTER = r'''
extern "C" int loss_stamps(void* dst, int count, int clear) {
  if (clear) { void* a; cudaGetSymbolAddress(&a, g_stamp);
    return (int)cudaMemset(a, 0, sizeof(unsigned long long) * count); }
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(unsigned long long) * count);
}
'''
# blocks an SM holds (after gs_loss_plan set the shared memory the kernels
# ask for); the three-channel kernels
OCCUPANCY = r'''
extern "C" int loss_blocks_per_sm(int which) {
  int n = 0;
  if (which == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gs_loss_fwd<3>, 192,
                                                                fwd_smem<3>());
  else cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gs_loss_bwd<3>, 192, bwd_smem<3>());
  return n;
}
'''
OCCUPANCY_PLANE_TILES = r'''
extern "C" int loss_blocks_per_sm(int which) {
  int n = 0;
  if (which == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gs_loss_fwd, kThreads, 0);
  else cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gs_loss_bwd, kThreads, 0);
  return n;
}
'''
# the phases a kernel's marks close, in order
PHASES = ["wait for the band's copies", "row sums (the next band's copies issued)",
          "column sums and stores", "block sums + slot"]
# name -> (source, lines put before it, [(text, its replacement)], whether
# its outputs are held to the tree's; timing-only variants are not)
VARIANTS = {
    "plane tiles (the earlier kernels)": (PLANE_TILES, [], [], True),
    "float64 partials": (None, ["#define GS_LOSS_PART_T double"], [], True),
    "no fma (a multiply and an add a tap)": (
        None, ["#define GS_LOSS_TAP(g, x, s) ((s) + (g) * (x))"], [], True),
    "no copies after the first band (timing only)": (
        None, [], [("    if (k + 1 < nb) copy(k + 1);\n", "")], False),
    "no partials' stores (timing only)": (None, [], [
        ("      store_part<", "      if (s == 12345.0) store_part<")], False),
}
SIGS = {"gs_loss_args_size": [], "gs_loss_forward": [ctypes.c_void_p] * 7,
        "gs_loss_backward": [ctypes.c_void_p] * 7, "gs_loss_plan": [ctypes.c_void_p],
        "gs_loss_partial_bytes": [], "loss_blocks_per_sm": [ctypes.c_int],
        "loss_stamps": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]}


def library(source: Path, head=(), edits=(), stamps=False):
    """(ctypes library of ``source`` with ``head``'s lines before it and
    each (text, replacement) of ``edits`` made, ptxas lines), built alone in
    a copy under build/."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    d = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    body = source.read_text()
    for a, b in edits:
        assert a in body, a
        body = body.replace(a, b)
    text = "\n".join(list(head) + ([STAMP_HEAD] if stamps else []) + [body])
    text += OCCUPANCY_PLANE_TILES if source == PLANE_TILES else OCCUPANCY
    (d / SOURCE).write_text(text + (STAMP_GETTER if stamps else ""))
    path, _, ptx = build.build_library(d, d / "out")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGS.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.plane_tiles = source == PLANE_TILES
    return lib, [ln.split(":")[-1].strip() for ln in ptx.splitlines() if "Used" in ln]


def device_by_kernel(fn, calls: int = 20, tries: int = 3) -> dict:
    """Mean device time of each kernel one call of fn launches, in us (no
    user annotations); a profile that held no device record is taken
    again, up to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
        if out:
            break
    return out


class Case:
    """An image pair and calls of the loss kernels through a library: the
    tree's layout (planned args, partials of the library's type) or the
    earlier design's (float64 partials a plane a channel, a slot a tile)."""

    def __init__(self, h: int, w: int):
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl

        gen = torch.Generator(device="cuda").manual_seed(16)
        frame = torch.rand((h, w, 4), generator=gen, device="cuda")
        self.pred = frame[..., :3]
        self.target = (self.pred + 0.05 * torch.randn(
            (h, w, 3), generator=gen, device="cuda")).clamp(0, 1).contiguous()
        self.h, self.w = h, w
        self.parts = torch.empty(3 * 4 * (h - kl.HALO) * (w - kl.HALO), dtype=torch.float64,
                                 device="cuda")
        self.loss = torch.empty((), dtype=torch.float32, device="cuda")
        self.dloss = torch.ones((), dtype=torch.float32, device="cuda")
        self.grad = torch.empty((h, w, 3), dtype=torch.float32, device="cuda")
        self.plans = {}

    def plan(self, lib):
        """(args, blocks of the forward) for lib."""
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl

        if id(lib) not in self.plans:
            args = kl.loss_args(self.pred, self.target, 0.2)
            if lib.plane_tiles:      # its LossArgs is the head of this one
                blocks = -(-self.w // 32) * -(-self.h // 16) * 3
            else:
                assert lib.gs_loss_args_size() == ctypes.sizeof(args)
                blocks = lib.gs_loss_plan(ctypes.addressof(args))
                assert blocks > 0, blocks
            slots = torch.empty((blocks, 2), dtype=torch.float64, device="cuda")
            self.plans[id(lib)] = (args, blocks, slots)
        return self.plans[id(lib)]

    def forward(self, lib):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

        args, _, slots = self.plan(lib)
        build.check("gs_loss", lib.gs_loss_forward(
            self.pred.data_ptr(), self.target.data_ptr(), ctypes.addressof(args),
            self.parts.data_ptr(), slots.data_ptr(), self.loss.data_ptr(), build.stream_ptr()))

    def backward(self, lib):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

        args, _, _ = self.plan(lib)
        build.check("gs_loss_bwd", lib.gs_loss_backward(
            self.pred.data_ptr(), self.target.data_ptr(), ctypes.addressof(args),
            self.parts.data_ptr(), self.dloss.data_ptr(), self.grad.data_ptr(),
            build.stream_ptr()))

    def outputs(self, lib):
        import torch

        self.forward(lib)
        self.backward(lib)
        torch.cuda.synchronize()
        return float(self.loss), self.grad.clone()

    def times(self, lib) -> dict:
        out = device_by_kernel(lambda: self.forward(lib))
        out.update(device_by_kernel(lambda: self.backward(lib)))
        return out

    def phases(self, lib, backward: bool) -> dict:
        import numpy as np
        import torch

        count = 1 << 17
        run = self.backward if backward else self.forward
        self.forward(lib)
        torch.cuda.synchronize()
        lib.loss_stamps(None, count, 1)
        torch.cuda.synchronize()
        run(lib)
        torch.cuda.synchronize()
        buf = np.zeros(count, np.uint64)
        lib.loss_stamps(ctypes.c_void_p(buf.ctypes.data), count, 0)
        st = buf.reshape(-1, 8).astype(np.float64)
        st = st[st[:, 0] > 0]
        life = st[:, 6] - st[:, 0]
        span = st[:, 6].max() - st[:, 0].min()
        names = PHASES[:3] if backward else PHASES
        return dict(kernel="gs_loss_bwd" if backward else "gs_loss_fwd", blocks=len(st),
                    span_us=span / 1e3, block_life_us=float(life.mean()) / 1e3,
                    blocks_alive=float(life.sum() / span),
                    phase_us={n: float(st[:, k].mean()) / 1e3 for k, n in enumerate(names, 1)})


def describe(case, lib, ptx) -> dict:
    import torch

    args, blocks, _ = case.plan(lib)
    out = dict(ptxas=ptx, blocks_per_sm={"gs_loss_fwd": lib.loss_blocks_per_sm(0),
                                         "gs_loss_bwd": lib.loss_blocks_per_sm(1)},
               forward_blocks=blocks, sms=torch.cuda.get_device_properties(0).multi_processor_count)
    if not lib.plane_tiles:
        out["plan"] = {k: getattr(args, k) for k in ("cg", "groups", "fseg", "fsegs", "bseg",
                                                     "bsegs")}
        out["partial_bytes"] = lib.gs_loss_partial_bytes()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_loss_probe: no CUDA device", file=sys.stderr)
        return 1
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    case = Case(args.height, args.width)
    tree, ptx = library(build.CSRC / SOURCE)
    loss, grad = case.outputs(tree)
    gmax = float(grad.abs().max())
    libs = {}
    for name, (source, head, edits, _) in VARIANTS.items():
        libs[name] = library(source or build.CSRC / SOURCE, head, edits)
    earlier = libs["plane tiles (the earlier kernels)"][0]
    turns = []
    for which, lib in (("earlier", earlier), ("tree", tree), ("tree", tree),
                       ("earlier", earlier)):
        turns.append({which: case.times(lib)})
    print(json.dumps({"kernels": dict(shape=[args.height, args.width, 3], loss=loss,
                                      device_us_in_turn=turns, **describe(case, tree, ptx))}),
          flush=True)
    stamped, _ = library(build.CSRC / SOURCE, stamps=True)
    got, g = case.outputs(stamped)
    assert got == loss and torch.equal(g, grad), "the stamped copy changed the outputs"
    for backward in (False, True):
        print(json.dumps({"phases": case.phases(stamped, backward)}), flush=True)
    for name, (lib, vptx) in libs.items():
        got, g = case.outputs(lib)
        rel = abs(got - loss) / abs(loss)
        grad_err = float((g - grad).abs().max()) / gmax
        assert not VARIANTS[name][3] or (rel <= 1e-7 and grad_err <= 1e-6), (name, rel, grad_err)
        print(json.dumps({"variant": dict(
            name=name, loss_rel_err=rel, grad_rel_err=grad_err, device_us=case.times(lib),
            **describe(case, lib, vptx))}), flush=True)
    print(json.dumps({"kernels again": dict(device_us=case.times(tree))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
