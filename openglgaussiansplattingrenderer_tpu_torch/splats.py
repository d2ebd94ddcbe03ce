"""Scene container and the reference-shaped facade.

Counterpart of ``openglgaussiansplattingrenderer_tpu/splats.py``.
``SplatScene`` holds activated parameters as numpy arrays and hands them
out as tensors on a device; ``Splats`` mirrors the reference's ``Splats``
class (``include/Splats.h:29-124``): a PLY path and a resolution in,
rendered frames out.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.io import png as png_io
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance


@dataclasses.dataclass
class SplatScene:
    """Activated splat parameters (see ``io/ply.py`` for load activations)."""

    means: np.ndarray       # (N, 3)
    scales: np.ndarray      # (N, 3), post-exp
    quats: np.ndarray       # (N, 4) wxyz, normalised
    opacities: np.ndarray   # (N,), post-sigmoid
    colors: np.ndarray      # (N, 3), 0..color_scale
    sh_rest: Optional[np.ndarray] = None  # (N, 45)

    @classmethod
    def from_ply(cls, path: str, color_scale: float = 255.0) -> "SplatScene":
        return cls.from_dict(ply_io.load_splats(path, color_scale))

    @classmethod
    def from_dict(cls, d: Dict[str, np.ndarray]) -> "SplatScene":
        return cls(d["means"], d["scales"], d["quats"], d["opacities"],
                   d["colors"], d.get("sh_rest"))

    def __len__(self) -> int:
        return self.means.shape[0]

    def params(self, device: torch.device | str) -> Dict[str, torch.Tensor]:
        """Parameter dict of float32 tensors on ``device``."""
        d = {"means": self.means, "scales": self.scales, "quats": self.quats,
             "opacities": self.opacities, "colors": self.colors}
        if self.sh_rest is not None and self.sh_rest.shape[-1] > 0:
            d["sh_rest"] = self.sh_rest
        return params_from_numpy(d, device)

    def covariances(self, device: torch.device | str) -> torch.Tensor:
        """Packed (N, 6) 3D covariances (ref
        ``Splats::computeCovarianceMatrices``) on ``device``."""
        p = params_from_numpy({"scales": self.scales, "quats": self.quats},
                              device)
        return build_covariance(p["scales"], p["quats"])

    def save_ply(self, path: str, color_scale: float = 255.0) -> None:
        ply_io.save_ply(path, self.means, self.quats, self.scales,
                        self.opacities, self.colors, self.sh_rest,
                        color_scale=color_scale)


def inference_config(cfg: RenderConfig) -> RenderConfig:
    """``cfg`` in the q16 inference precision mode: ``sort_payload="q16"``
    on the packed depth key (see ``config.py``)."""
    return dataclasses.replace(cfg, sort_payload="q16", depth_key="packed")


class Splats:
    """Reference-API facade: path + resolution in, rendered frames out.
    Parameters and the covariance precompute live on ``device``."""

    def __init__(self, file_path: str, width: int, height: int,
                 cfg: Optional[RenderConfig] = None, *,
                 device: torch.device | str = "cuda", inference: bool = False):
        """``inference=True`` switches the render config to the q16
        inference precision mode (``inference_config``): image error well
        inside the reference's own 0.01 CPU-vs-GPU tolerance; rendering
        only -- gradients through such a frame raise. Composes with an
        explicit ``cfg``."""
        self.cfg = cfg or RenderConfig()
        if inference:
            self.cfg = inference_config(self.cfg)
        self.device = torch.device(device)
        self.scene = SplatScene.from_ply(file_path, self.cfg.color_scale)
        self.width = int(width)
        self.height = int(height)
        self.num_splats = len(self.scene)
        self.last_image: Optional[np.ndarray] = None
        self.last_stats: Optional[Dict[str, np.ndarray]] = None
        # load-time covariance precompute, as the reference does once at
        # construction (src/Splats.cpp:22, 414-438)
        self._params = self.scene.params(self.device)
        self._params["cov6"] = self.scene.covariances(self.device)

    def autotune_capacity(self, camera, margin: float = 1.2) -> None:
        """Pin the record capacity to the scene's measured record count
        from ``camera``'s viewpoint (``render.autotune_capacity``)."""
        from openglgaussiansplattingrenderer_tpu_torch.render import (
            autotune_capacity,
            camera_args,
        )

        a = camera_args(camera)
        self.cfg = autotune_capacity(
            self._params, a["view"], a["vp"], a["focal_x"], a["focal_y"],
            a["tan_fovx"], a["tan_fovy"], self.width, self.height, self.cfg,
            margin=margin)

    def _finish(self, image, stats) -> np.ndarray:
        self.last_image = image.detach().cpu().numpy()
        self.last_stats = {k: v.detach().cpu().numpy() for k, v in stats.items()}
        self._warn_on_overflow()
        return self.last_image

    def gpu_render(self, view_matrix, width, height, focal_x, focal_y,
                   tan_fov_x, tan_fov_y, vp_matrix) -> np.ndarray:
        """Render with the reference ``gpuRender`` signature
        (``src/Splats.cpp:587-597``)."""
        from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays

        with torch.no_grad():
            image, stats = render_arrays(
                self._params, view_matrix, vp_matrix, focal_x, focal_y,
                tan_fov_x, tan_fov_y, int(width), int(height), self.cfg)
        return self._finish(image, stats)

    def render_camera(self, camera) -> np.ndarray:
        from openglgaussiansplattingrenderer_tpu_torch.render import render_stats

        with torch.no_grad():
            image, stats = render_stats(self._params, camera, self.cfg)
        return self._finish(image, stats)

    def _warn_on_overflow(self) -> None:
        """Warn when the frame dropped records to fit the static capacity."""
        ov = int(self.last_stats.get("overflow", 0)) if self.last_stats else 0
        if ov > 0:
            warnings.warn(
                f"render overflowed record capacity by {ov} records "
                f"(dup_capacity_factor={self.cfg.dup_capacity_factor}); the "
                "image is missing duplicates -- raise dup_capacity_factor",
                RuntimeWarning, stacklevel=3)

    def display(self, path: str = "render.png") -> None:
        """Headless display: dump the last rendered frame to PNG."""
        if self.last_image is None:
            raise RuntimeError("nothing rendered yet")
        png_io.save_png(path, self.last_image)
