"""Does the kernel library's build digest survive an edit that changes no
kernel, and what does a rebuild cost?

Counterpart of ``scripts/cache_key_probe.py``, which asks the same of the
TPU compile cache: there, source locations reach the cache key, so an edit
that only shifts line numbers recompiles every kernel. The port's library
is named by ``build.digest``, a hash of the sources' bytes. This probe
copies ``csrc/`` to a temporary directory, prepends 7 blank lines to
``probe_affine.cu`` (the kernel of this probe, ``x * 2 + 1``), compares
the two digests and, on the card, times the rebuild of the shifted copy.

    python3 -m openglgaussiansplattingrenderer_tpu_torch.probes.cache_key_probe

prints ``{"digest_stable": ..., "rebuild_s": ...}``.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

PAD_LINES = 7


def probe_affine_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``probe_affine``."""
    return x * 2.0 + 1.0


def probe_affine(x: torch.Tensor) -> torch.Tensor:
    """``x * 2 + 1`` over a float32 tensor of any shape."""
    build.expect("probe_affine x", x, torch.float32, (None,) * x.dim())
    if not build.on_cuda("probe_affine", x):
        return probe_affine_plain(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load_library()
    build.check("probe_affine", lib.gs_probe_affine(
        x.data_ptr(), out.data_ptr(), x.numel(), build.stream_ptr()))
    probe_affine.launches += 1
    return out


probe_affine.launches = 0


def shifted_copy(dst: Path) -> Path:
    """Copy the CUDA sources and headers into ``dst`` with ``PAD_LINES``
    blank lines in front of ``probe_affine.cu``; returns ``dst``."""
    dst.mkdir(parents=True, exist_ok=True)
    for src in build.sources() + build.headers():
        shutil.copy(src, dst / src.name)
    target = dst / "probe_affine.cu"
    target.write_text("\n" * PAD_LINES + target.read_text())
    return dst


def digest_stable() -> bool:
    """Whether the library's digest is the same for the line-shifted copy."""
    with tempfile.TemporaryDirectory() as tmp:
        return build.digest(shifted_copy(Path(tmp) / "csrc")) == build.digest()


def run() -> dict:
    """The probe on the card: run the kernel once through the library as
    built from the sources, then build the line-shifted copy and time it."""
    if not torch.cuda.is_available():
        raise RuntimeError("cache_key_probe rebuilds and runs on an NVIDIA GPU; "
                           "none found")
    x = torch.ones((8, 128), device="cuda")
    if not torch.equal(probe_affine(x), probe_affine_plain(x)):
        raise RuntimeError("probe_affine differs from x * 2 + 1")
    with tempfile.TemporaryDirectory() as tmp:
        csrc = shifted_copy(Path(tmp) / "csrc")
        stable = build.digest(csrc) == build.digest()
        _, seconds, _ = build.build_library(csrc, Path(tmp) / "build")
    return {"digest_stable": stable, "rebuild_s": seconds}


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
