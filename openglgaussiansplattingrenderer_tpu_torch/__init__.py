"""Differentiable 3D Gaussian Splatting renderer: the PyTorch/CUDA port.

The counterpart of ``openglgaussiansplattingrenderer_tpu`` (JAX/Pallas),
which stays the reference. Plain tensor code is PyTorch; the kernels of
the frame and of its gradient (prefix sum, record expansion and its
segment-sum transpose, tile compositor forward and backward), of the radix
record sort (digit histogram, stable scatter) and of the two probes in
``probes`` are CUDA C++ for Hopper in ``csrc/``, built with nvcc at first
use. On CPU tensors every
kernel wrapper runs its plain PyTorch version instead. ``train`` fits splat
parameters with Adam on those gradients. This package never imports JAX.
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
from openglgaussiansplattingrenderer_tpu_torch.train import (
    TrainConfig,
    TrainState,
    fit_scene,
    make_train_step,
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
    "TrainConfig",
    "TrainState",
    "fit_scene",
    "make_train_step",
    "__version__",
]
