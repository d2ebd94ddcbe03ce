"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` (one compiler process per
source, all started together) and link into one shared library with a plain
C interface, loaded through ``ctypes`` (no PyTorch headers, so the build
takes seconds). The library lands in ``csrc/build/`` (git-ignored), named
by a hash of the sources, the shared headers (``*.cuh``) and the flags, and
is built at first use: the first CUDA launch of any wrapper builds it. A
missing ``nvcc`` or a failed build raises with the compiler's output;
nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# --fmad=false: no multiply-add contraction, so each kernel rounds its
# float expressions exactly as the plain PyTorch versions do.
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "--fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "gs_cumsum_tile": [],
    "gs_cumsum_i32": [_P, _P, _P, _I, _P],
    "gs_records_items": [],
    "gs_expand": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                  _P],
    "gs_composite_max_pixels": [],
    "gs_composite_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    "gs_composite_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                         _F, _F, _P],
    "gs_segsum": [_P, _I, _P, _I, _P, _P, _P],
    "gs_radix_chunk": [],
    "gs_radix_counts": [_P, _I, _I, _I, _P, _P, _L, _P],
    "gs_radix_scatter": [_P, _P, _I, _I, _I, _I, _P, _P, _L, _P, _P, _P],
    "gs_record_counts": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _P],
    "gs_record_scatter": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "gs_record_gather": [_P, _P, _I, _I, _P, _P],
    "gs_bucketer_chunk": [],
    "gs_bucketer_level": [_P, _L, _I, _F, _P, _P],
    "gs_probe_affine": [_P, _P, _L, _P],
    "gs_table_args_size": [],
    "gs_table_sh_row_max": [],
    "gs_splat_table": [_P] * 22 + [_L, _P],
    "gs_splat_table_bwd": [_P] * 19 + [_L, _P],
}

# filled by the build: seconds the nvcc run took (0.0 when the library was
# already built) and the compiler's -Xptxas -v report
build_info = {"seconds": None, "ptxas": "", "path": None}


class KernelBuildError(RuntimeError):
    """nvcc is missing or the CUDA sources did not compile."""


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under the CUDA toolkit PyTorch found."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    return None


def sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu"))


def headers(csrc: Path = CSRC):
    """Headers shared between sources; an edit to one rebuilds the library."""
    return sorted(csrc.glob("*.cuh"))


def digest(csrc: Path = CSRC) -> str:
    """The name of the library built from ``csrc``: a hash of the flags and
    of every source's and header's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc) + headers(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_together(cmds) -> str:
    """Start every command at once, wait for all, raise on the first that
    failed; returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(nvcc: str, lib_path: Path, csrc: Path) -> str:
    """One ``nvcc -c`` per source of ``csrc``, all running at once, then
    one link; returns the compilers' output."""
    stem = f"{lib_path.stem}.{os.getpid()}"
    srcs = sources(csrc)
    objs = [lib_path.parent / f"{stem}.{src.stem}.o" for src in srcs]
    tmp = lib_path.parent / f"{stem}.tmp"
    try:
        ptxas = _run_together(
            [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
             for src, obj in zip(srcs, objs)])
        _run_together([[nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return ptxas


def build_library(csrc: Path, build_dir: Path) -> Tuple[Path, float, str]:
    """Build the sources in ``csrc`` into ``build_dir`` unless the library
    of their digest is there already. Returns (library path, seconds the
    nvcc run took or 0.0, the compilers' output or "")."""
    lib_path = build_dir / f"gs_kernels_{digest(csrc)}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or the CUDA toolkit PyTorch reports): "
            "the CUDA kernels cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ptxas = _compile(nvcc, lib_path, csrc)
    seconds = time.perf_counter() - t0
    (build_dir / f"{lib_path.stem}.ptxas.txt").write_text(ptxas)
    return lib_path, seconds, ptxas


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib_path, build_info["seconds"], build_info["ptxas"] = build_library(
        CSRC, BUILD_DIR)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info["path"] = str(lib_path)
    return lib


def check(name: str, code: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")


def on_cuda(name: str, *tensors, has_backward: bool = False) -> bool:
    """Which implementation a wrapper runs: False (the plain PyTorch
    version) when every input lies on the CPU, True (the CUDA kernel) when
    every input lies on one CUDA device. Anything else raises. A wrapper
    whose kernel sits inside a ``torch.autograd.Function`` passes
    ``has_backward=True``; for the others (the integer prefix sum, and the
    backward kernels themselves, which have no second derivative) a CUDA
    call that autograd would need to differentiate raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: inputs must all lie on the CPU or all on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    import torch

    if (not has_backward and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise NotImplementedError(
            f"{name}: this CUDA kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad")
    return True


def expect(name: str, t, dtype, shape) -> None:
    """Check a kernel input's dtype, shape (None = any extent) and
    contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def stream_ptr() -> int:
    """The current device's current stream as an integer for ctypes. The raw
    accessor costs a fraction of a microsecond where building a
    ``torch.cuda.Stream`` object costs several, more than a small kernel's
    launch; the public call stands in where a PyTorch lacks it."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream
