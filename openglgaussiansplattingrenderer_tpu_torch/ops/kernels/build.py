"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` into one shared library with
a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library lands in ``csrc/build/`` (git-ignored),
named by a hash of the sources and flags, and is built at first use: the
first CUDA launch of any wrapper builds it. A missing ``nvcc`` or a failed
build raises with the compiler's output; nothing falls back.

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
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# --fmad=false: no multiply-add contraction, so each kernel rounds its
# float expressions exactly as the plain PyTorch versions do.
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "--fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "gs_cumsum_tile": [],
    "gs_cumsum_i32": [_P, _P, _P, _I, _P],
    "gs_expand": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "gs_composite_max_pixels": [],
    "gs_composite_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
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


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib_path = BUILD_DIR / f"gs_kernels_{_digest()}.so"
    if not lib_path.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (PATH or the CUDA toolkit PyTorch reports): "
                "the CUDA kernels cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["ptxas"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        (BUILD_DIR / f"{lib_path.stem}.ptxas.txt").write_text(build_info["ptxas"])
    else:
        build_info["seconds"] = 0.0
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


def on_cuda(name: str, *tensors) -> bool:
    """Which implementation a wrapper runs: False (the plain PyTorch
    version) when every input lies on the CPU, True (the CUDA kernel) when
    every input lies on one CUDA device. Anything else raises, and so does
    a CUDA call that autograd would need to differentiate: the kernels have
    no backward yet (ROADMAP.md, kernels to port: 3 and 5)."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: inputs must all lie on the CPU or all on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; call it under "
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
    import torch

    return torch.cuda.current_stream().cuda_stream
