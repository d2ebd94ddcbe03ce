"""Differentiable 3D Gaussian Splatting renderer: the PyTorch/CUDA port.

The counterpart of ``openglgaussiansplattingrenderer_tpu`` (JAX/Pallas),
which stays the reference. Plain tensor code is PyTorch; the frame's
kernels (prefix sum, record expansion, tile compositor) are CUDA C++ for
Hopper in ``csrc/``, built with nvcc at first use. On CPU tensors every
kernel wrapper runs its plain PyTorch version instead. This package never
imports JAX.
"""

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.camera import Camera
from openglgaussiansplattingrenderer_tpu_torch.splats import SplatScene, Splats
from openglgaussiansplattingrenderer_tpu_torch.render import (
    camera_args,
    render,
    render_arrays,
    render_stats,
)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "SplatScene",
    "Splats",
    "camera_args",
    "render",
    "render_arrays",
    "render_stats",
    "__version__",
]
