#!/usr/bin/env python3
"""Where the port's training-loss kernels (``csrc/ssim_loss.cu``: the
forward ``gs_loss_fwd`` with its slot sum ``gs_loss_sum``, and the backward
``gs_loss_bwd``) spend their time, on one NVIDIA GPU.

    python3 scripts/torch_loss_probe.py [--height 512] [--width 1024]

On one (H, W, 3) image pair (seeded uniform values; pred is the first three
channels of an (H, W, 4) tensor, as the train step reads it; the kernels'
work does not depend on the values) it prints JSON lines:

- ``kernels``: each kernel's time on the device alone (torch.profiler, by
  kernel name), its registers and shared memory (ptxas) and the blocks an
  SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
- ``phases``: the forward block's life cut by barriers into phases, from
  ``globaltimer`` sums that thread 0 of each block keeps in a copy of the
  source (the barriers cost a little; the copy is timed once), and the
  blocks alive on average;
- ``variant``: the kernels rebuilt with one change, each held to the
  tree's loss (bit-equal where the change keeps every sum's order, else
  within 1e-7 relative) and gradient (1e-6 of its largest) and timed on
  the device alone: without the forward's stores of the partials (timing
  only: the backward is not run), a 32 x 8 tile, a register cap of five
  blocks an SM, and multiply-add contraction allowed (``--fmad=true``: a
  multiply and an add in one float64 instruction).

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
STAMP_HEAD = r'''
static __device__ unsigned long long g_stamp[1 << 17];
static __shared__ unsigned long long g_last;
__device__ __forceinline__ unsigned long long now_() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ size_t slot_() {
  return ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 8; }
#define STAMP0 do { if (threadIdx.x == 0) { g_last = now_(); g_stamp[slot_()] = g_last; } } \
  while (0)
#define ACC(k) do { __syncthreads(); if (threadIdx.x == 0) { unsigned long long t_ = now_(); \
  g_stamp[slot_() + (k)] += t_ - g_last; g_last = t_; } } while (0)
#define STAMP_END do { if (threadIdx.x == 0) g_stamp[slot_() + 6] = now_(); } while (0)
'''
STAMP_GETTER = r'''
extern "C" int loss_stamps(void* dst, int count, int clear) {
  if (clear) { void* a; cudaGetSymbolAddress(&a, g_stamp);
    return (int)cudaMemset(a, 0, sizeof(unsigned long long) * count); }
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(unsigned long long) * count);
}
'''
OCCUPANCY = r'''
extern "C" int loss_blocks_per_sm(int which) {
  int n = 0;
  if (which == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gs_loss_fwd, kThreads, 0);
  else cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gs_loss_bwd, kThreads, 0);
  return n;
}
'''
# (text, text that replaces it): the stamps of each phase of gs_loss_fwd
STAMPS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + STAMP_HEAD),
    ("  __shared__ double red[kWarps];\n  const int hm",
     "  __shared__ double red[kWarps];\n  STAMP0;\n  const int hm"),
    ("    st[r][col] = in ? target[AT(a.ts, b, y, x, ch)] : 0.0f;\n  }\n  __syncthreads();\n",
     "    st[r][col] = in ? target[AT(a.ts, b, y, x, ch)] : 0.0f;\n  }\n  __syncthreads();\n"
     "  ACC(1);\n"),
    ("  // along the rows\n", "  ACC(2);\n  // along the rows\n"),
    ("    hs[4][r][x] = mpt;\n  }\n  __syncthreads();\n",
     "    hs[4][r][x] = mpt;\n  }\n  __syncthreads();\n  ACC(3);\n"),
    ("    ssum += s;\n  }\n", "    ssum += s;\n  }\n  ACC(4);\n"),
    ("    slots[id] = make_double2(ssum, l1);\n  }\n}\n",
     "    slots[id] = make_double2(ssum, l1);\n  }\n  ACC(5);\n  STAMP_END;\n}\n"),
]
PHASES = ["stage tile + halo", "L1 terms", "sums along the rows",
          "sums down the columns, S, partials' stores", "block sums + slot"]
# name -> ([(text, replacement)], whether the loss keeps its bits, runs the
# backward, nvcc's flags in place of the library's)
VARIANTS = {
    "no partials' stores": ([
        ("    parts[o] = 2.0 * (mu_t * (a2 - a1) - (s * mu_p) * (b2 - b1)) / d;\n"
         "    parts[planes + o] = -s / b2;\n    parts[2 * planes + o] = (2.0 * a1) / d;\n",
         "")], True, False, None),
    "tile 32x8": ([("constexpr int kTW = 32, kTH = 16,", "constexpr int kTW = 32, kTH = 8,")],
                  False, True, None),
    "5 blocks an SM": ([
        ("__global__ void __launch_bounds__(kThreads) gs_loss_fwd(",
         "__global__ void __launch_bounds__(kThreads, 5) gs_loss_fwd(")], True, True, None),
    "--fmad=true": ([], False, True, ("--fmad=false", "--fmad=true")),
}


def library(csrc: Path, edits=(), stamps=False, flag=None):
    """(ctypes library of csrc's ssim_loss.cu with the edits applied, ptxas
    lines), built alone in a copy under build/; ``flag`` = (nvcc flag, its
    replacement) for this build."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

    d = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    text = (csrc / SOURCE).read_text()
    for a, b in list(edits) + (STAMPS if stamps else []):
        assert text.count(a) == 1, a
        text = text.replace(a, b)
    (d / SOURCE).write_text(text + OCCUPANCY + (STAMP_GETTER if stamps else ""))
    flags = list(build.NVCC_FLAGS)
    if flag:
        build.NVCC_FLAGS[build.NVCC_FLAGS.index(flag[0])] = flag[1]
    try:
        path, _, ptx = build.build_library(d, d / "out")
    finally:
        build.NVCC_FLAGS[:] = flags
    lib = ctypes.CDLL(str(path))
    for name, argtypes in build.SIGNATURES.items():
        if name.startswith("gs_loss"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib, [ln.split(":")[-1].strip() for ln in ptx.splitlines() if "Used" in ln]


def device_by_kernel(fn, calls: int = 20, tries: int = 3) -> dict:
    """Mean device time of each kernel one call of fn launches, in us; a
    profile that held no device record is taken again, up to ``tries``
    times."""
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
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
        if out:
            break
    return out


class Case:
    """An image pair and calls of the loss kernels through a library."""

    def __init__(self, h: int, w: int):
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl

        gen = torch.Generator(device="cuda").manual_seed(16)
        frame = torch.rand((h, w, 4), generator=gen, device="cuda")
        self.pred = frame[..., :3]
        self.target = (self.pred + 0.05 * torch.randn(
            (h, w, 3), generator=gen, device="cuda")).clamp(0, 1).contiguous()
        self.args = kl.loss_args(self.pred, self.target, 0.2)
        blocks = lambda tw, th: -(-w // tw) * -(-h // th) * 3      # noqa: E731
        self.slots = torch.empty((blocks(32, 8), 2), dtype=torch.float64, device="cuda")
        self.parts = torch.empty((3, 3, h - kl.HALO, w - kl.HALO), dtype=torch.float64,
                                 device="cuda")
        self.loss = torch.empty((), dtype=torch.float32, device="cuda")
        self.dloss = torch.ones((), dtype=torch.float32, device="cuda")
        self.grad = torch.empty((h, w, 3), dtype=torch.float32, device="cuda")

    def forward(self, lib):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

        build.check("gs_loss", lib.gs_loss_forward(
            self.pred.data_ptr(), self.target.data_ptr(), ctypes.addressof(self.args),
            self.parts.data_ptr(), self.slots.data_ptr(), self.loss.data_ptr(),
            build.stream_ptr()))

    def backward(self, lib):
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

        build.check("gs_loss_bwd", lib.gs_loss_backward(
            self.pred.data_ptr(), self.target.data_ptr(), ctypes.addressof(self.args),
            self.parts.data_ptr(), self.dloss.data_ptr(), self.grad.data_ptr(),
            build.stream_ptr()))

    def outputs(self, lib, backward=True):
        import torch

        self.forward(lib)
        if backward:
            self.backward(lib)
        torch.cuda.synchronize()
        return float(self.loss), (self.grad.clone() if backward else None)

    def times(self, lib, backward=True) -> dict:
        out = device_by_kernel(lambda: self.forward(lib))
        if backward:
            out.update(device_by_kernel(lambda: self.backward(lib)))
        return out

    def phases(self, lib) -> dict:
        import numpy as np
        import torch

        count = 1 << 17
        self.forward(lib)
        torch.cuda.synchronize()
        lib.loss_stamps(None, count, 1)
        torch.cuda.synchronize()
        self.forward(lib)
        torch.cuda.synchronize()
        buf = np.zeros(count, np.uint64)
        lib.loss_stamps(ctypes.c_void_p(buf.ctypes.data), count, 0)
        st = buf.reshape(-1, 8).astype(np.float64)
        st = st[st[:, 0] > 0]
        life = st[:, 6] - st[:, 0]
        span = st[:, 6].max() - st[:, 0].min()
        return dict(blocks=len(st), span_us=span / 1e3, block_life_us=float(life.mean()) / 1e3,
                    blocks_alive=float(life.sum() / span),
                    phase_us={PHASES[k - 1]: float(st[:, k].mean()) / 1e3 for k in range(1, 6)})


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
    tree, ptx = library(build.CSRC)
    loss, grad = case.outputs(tree)
    print(json.dumps({"kernels": dict(
        shape=[args.height, args.width, 3], loss=loss, device_us=case.times(tree), ptxas=ptx,
        blocks_per_sm={"gs_loss_fwd": tree.loss_blocks_per_sm(0),
                       "gs_loss_bwd": tree.loss_blocks_per_sm(1)},
        sms=torch.cuda.get_device_properties(0).multi_processor_count)}), flush=True)
    stamped, _ = library(build.CSRC, stamps=True)
    assert case.outputs(stamped, backward=False)[0] == loss
    print(json.dumps({"phases": case.phases(stamped)}), flush=True)
    for name, (edits, same_bits, backward, flag) in VARIANTS.items():
        lib, vptx = library(build.CSRC, edits, flag=flag)
        got, g = case.outputs(lib, backward)
        rel = abs(got - loss) / abs(loss)
        assert (rel == 0.0) if same_bits else (rel <= 1e-7), (name, got, loss)
        grad_err = None
        if backward:
            grad_err = float((g - grad).abs().max()) / float(grad.abs().max())
            assert (grad_err == 0.0) if same_bits else (grad_err <= 1e-6), (name, grad_err)
        print(json.dumps({"variant": dict(
            name=name, ptxas=vptx, loss_rel_err=rel, grad_rel_err=grad_err,
            device_us=case.times(lib, backward),
            blocks_per_sm={"gs_loss_fwd": lib.loss_blocks_per_sm(0),
                           "gs_loss_bwd": lib.loss_blocks_per_sm(1)})}), flush=True)
    print(json.dumps({"kernels again": dict(device_us=case.times(tree))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
