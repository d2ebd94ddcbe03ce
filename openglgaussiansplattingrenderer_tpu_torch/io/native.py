"""ctypes binding to the native C++ PLY loader (``csrc/ply_loader.cpp``).

Counterpart of ``openglgaussiansplattingrenderer_tpu/io/native.py``. The
loader memory-maps the file and applies the load-time activations across
hardware threads (ref ``src/Splats.cpp:174-344``). Its source is the one at
the repository root (``csrc/ply_loader.cpp``); the port builds it with
``g++`` into its own git-ignored ``csrc/build/``, named by a hash of the
source and the flags, at first use; without ``-march=native`` (the root
``csrc/Makefile`` has it), so a copied checkout does not load a library
built for another host's instruction set. ``io/ply.load_splats`` falls back to
the numpy parser where the library cannot be built or the file layout is
not the standard one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ply_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def _build() -> Path:
    """Compile the loader unless the library of this source and these flags
    is built already; raises ``OSError`` or ``subprocess`` errors."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libgsply_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                            "-lpthread"], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=1)
def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.gs_open.restype = ctypes.c_long
    lib.gs_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
    lib.gs_read.restype = ctypes.c_int
    lib.gs_read.argtypes = [ctypes.c_long, ctypes.c_float] + [
        ctypes.POINTER(ctypes.c_float)] * 6
    lib.gs_close.restype = None
    lib.gs_close.argtypes = [ctypes.c_long]
    return lib


def available() -> bool:
    return _load_lib() is not None


def load_splats(path: str, color_scale: float = 255.0
                ) -> Optional[Dict[str, np.ndarray]]:
    """Load and activate through the native library. None: the caller
    falls back to the numpy parser (no library, or a non-standard
    layout). A missing file raises ``FileNotFoundError``."""
    lib = _load_lib()
    if lib is None:
        return None
    counts = (ctypes.c_long * 2)()
    handle = lib.gs_open(str(path).encode(), counts)
    if handle == 0:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None
    try:
        n, n_rest = int(counts[0]), int(counts[1])
        out = {
            "means": np.empty((n, 3), np.float32),
            "colors": np.empty((n, 3), np.float32),
            "opacities": np.empty((n,), np.float32),
            "scales": np.empty((n, 3), np.float32),
            "quats": np.empty((n, 4), np.float32),
            "sh_rest": np.empty((n, n_rest), np.float32),
        }

        def ptr(a):
            if a.size == 0:
                return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

        rc = lib.gs_read(handle, ctypes.c_float(color_scale),
                         *(ptr(out[k]) for k in ("means", "colors", "opacities",
                                                 "scales", "quats", "sh_rest")))
        return out if rc == 0 else None
    finally:
        lib.gs_close(handle)
