"""Scenes, cameras and training targets, made on the device from a seed.

A configuration's ``scene.generator`` names its scene generator. The
``clustered`` one is here, a torch copy of the port's clustered generator
(``io/ply.make_clustered_scene``: Zipf-sized Gaussian clusters of splats
with lognormal sizes tied to their cluster's spread, and a uniform dust
cloud), kept here so the yardstick does not move when the program does.
Any other is ``generators/<name>.py`` under the benchmark's directory,
found by name, whose ``raw_scene(cfg, device)`` makes the splats from
``structure_seed`` alone.
Two seeds drive every generator:

- the configuration's ``structure_seed`` fixes the scene every run shares,
  as a captured scene is fixed: cluster centres, spreads and populations,
  and every splat (position within its cluster, size, anisotropy,
  rotation, opacity, colour, SH coefficients);
- ``--seed`` draws the order of the rows (as a file holds them) and, in
  the traffic, the first pose or the order of the views: every seed gives
  other inputs and the same set of splats, so the same amount of work.

Splats come out in raw (pre-activation) form, as a trainer holds them:
log-scales, logit opacities, unnormalised quaternions; ``activated``
gives the render parameters. Cameras follow the reference's conventions
(``Camera.cpp``: OpenGL perspective, the tan-fov quirks) and orbit the
scene's centre at the configuration's distance.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _structure(sc: dict, n: int):
    """Cluster centres (K, 3), spreads (K,) and populations (K,) of the
    configuration's fixed layout (float64 on the host, a few numbers)."""
    rng = np.random.default_rng(int(sc["structure_seed"]))
    k = int(sc["num_clusters"])
    extent = float(sc["extent"])
    centres = rng.uniform(-extent, extent, size=(k, 3))
    lo, hi = sc["cluster_sigma_range"]
    csig = np.exp(rng.uniform(math.log(lo), math.log(hi), size=k))
    n_cl = n - int(n * float(sc["background_frac"]))
    w = 1.0 / np.arange(1, k + 1)
    pop = np.floor(w / w.sum() * n_cl).astype(np.int64)
    pop[0] += n_cl - int(pop.sum())
    return centres, csig, pop


def raw_scene(cfg: dict, seed: int, device, base: Optional[Path] = None
              ) -> Dict[str, torch.Tensor]:
    """The configuration's scene in raw form: ``means`` (N, 3),
    ``log_scales`` (N, 3), ``quats`` (N, 4), ``logit_opacities`` (N,),
    ``colors`` (N, 3) in 0..255, and ``sh_rest`` (N, 45) where the
    configuration's SH degree is above 0. float32 on ``device``. A
    generator file is looked for under ``base`` (the benchmark's directory
    by default)."""
    sc = cfg["scene"]
    if sc["generator"] != "clustered":
        from benchmark import manifest

        gen = manifest.generator(sc["generator"], base if base is not None else manifest.HERE)
        return _in_order(gen.raw_scene(cfg, device), seed, device)
    n = int(cfg["splats"])
    centres, csig, pop = _structure(sc, n)
    n_cl = int(pop.sum())
    n_bg = n - n_cl
    extent = float(sc["extent"])
    f32 = torch.float32
    g = generator(int(sc["structure_seed"]), device)
    assign = torch.repeat_interleave(torch.arange(len(pop), device=device),
                                     torch.as_tensor(pop, device=device))
    cen = torch.as_tensor(centres, dtype=f32, device=device)
    sig = torch.as_tensor(csig, dtype=f32, device=device)
    sig_bg = float(csig.mean())

    # one call for every normal and one for every uniform the rows need
    normals = torch.randn((n, 11), generator=g, device=device, dtype=f32)
    uniforms = torch.rand((n, 6), generator=g, device=device, dtype=f32)
    means = torch.empty((n, 3), dtype=f32, device=device)
    means[:n_cl] = cen[assign] + normals[:n_cl, 0:3] * sig[assign][:, None]
    means[n_cl:] = (uniforms[n_cl:, 0:3] * 2.0 - 1.0) * extent
    sig_of = torch.cat([sig[assign], torch.full((n_bg,), sig_bg, device=device)])
    log_s = (float(sc["log_scale_mu"]) + 0.5 * torch.log(sig_of / sig_bg)
             + float(sc["log_scale_sigma"]) * normals[:, 3])
    log_scales = log_s[:, None] + float(sc["anisotropy_sigma"]) * normals[:, 4:7]
    quats = normals[:, 7:11]
    quats = quats / torch.linalg.vector_norm(quats, dim=1, keepdim=True)
    logit = float(sc["opacity_logit_sigma"]) * torch.randn(
        (n,), generator=g, device=device, dtype=f32)
    f_dc = uniforms[:, 3:6] * 2.0 - 1.0
    raw = {"means": means, "log_scales": log_scales, "quats": quats,
           "logit_opacities": logit,
           "colors": (0.5 + SH_C0 * f_dc) * 255.0}
    if int(cfg["sh_degree"]) > 0:
        rest = 3 * ((int(cfg["sh_degree"]) + 1) ** 2 - 1)
        raw["sh_rest"] = float(sc["sh_rest_sigma"]) * torch.randn(
            (n, rest), generator=g, device=device, dtype=f32)
    return _in_order(raw, seed, device)


def _in_order(raw: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """The rows in the run's own order, drawn from ``seed``."""
    n = int(raw["means"].shape[0])
    perm = torch.randperm(n, generator=generator(seed, device), device=device)
    return {k: v[perm].contiguous() for k, v in raw.items()}


def activated(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Render parameters of a raw scene: scales = exp, opacities =
    sigmoid, quaternions as drawn (unit length)."""
    out = {"means": raw["means"], "scales": torch.exp(raw["log_scales"]),
           "quats": raw["quats"],
           "opacities": torch.sigmoid(raw["logit_opacities"]),
           "colors": raw["colors"]}
    if "sh_rest" in raw:
        out["sh_rest"] = raw["sh_rest"]
    return out


# ---- cameras -----------------------------------------------------------------

def _perspective(fovy_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    t = math.tan(fovy_rad / 2.0)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    return p


def _rot_x(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _rot_y(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def camera(cfg: dict, azimuth_deg: float, elevation_deg: float) -> dict:
    """The argument bundle of a camera on the orbit: ``view``, ``vp``
    (float32 4x4), ``focal_x``, ``focal_y``, ``tan_fovx``, ``tan_fovy``
    (float32), in the reference's conventions (tan-fovs in its swapped,
    degrees-as-radians form)."""
    cam = cfg["camera"]
    w, h = int(cfg["width"]), int(cfg["height"])
    fovy = float(cam["fovy_deg"])
    view = np.eye(4, dtype=np.float64)
    view[:3, :3] = _rot_x(elevation_deg) @ _rot_y(azimuth_deg)
    view[2, 3] = -float(cam["distance"])
    view = view.astype(np.float32)
    vp = (_perspective(math.radians(fovy), w / h, float(cam["near"]), float(cam["far"]))
          @ view).astype(np.float32)
    focal = lambda size: np.float32(size / (2.0 * math.tan(math.radians(fovy) / 2.0)))  # noqa: E731
    tan_y = math.tan(fovy / 2.0)
    return {"view": view, "vp": vp, "focal_x": focal(w), "focal_y": focal(h),
            "tan_fovx": np.float32(tan_y),
            "tan_fovy": np.float32(math.tan(math.atan(tan_y * w / h)))}


def orbit(cfg: dict, mix: dict, start: int) -> List[dict]:
    """The mix's ring of poses, one per ``degrees_per_frame`` of azimuth,
    starting at pose ``start``: every seed sees the same poses in another
    order."""
    count = int(mix["poses"])
    step = float(mix["degrees_per_frame"])
    el = float(mix["elevation_deg"])
    return [camera(cfg, ((start + i) % count) * step, el) for i in range(count)]


def training_views(cfg: dict) -> List[dict]:
    """The training cameras: ``views.count`` poses around the scene, every
    ``holdout_every``-th held out (3DGS's ``--eval`` split), elevation
    swinging between the two bounds twice around the ring."""
    v = cfg["views"]
    count, every = int(v["count"]), int(v["holdout_every"])
    lo, hi = v["elevation_deg"]
    out = []
    for i in range(count):
        if i % every == 0:
            continue
        az = 360.0 * i / count
        el = lo + (hi - lo) * 0.5 * (1.0 - math.cos(4.0 * math.pi * i / count))
        out.append(camera(cfg, az, el))
    return out


def targets(cfg: dict, views: int, seed: int, device) -> torch.Tensor:
    """(views, H, W, 3) float32 smooth target images in [0.05, 0.95]: each
    channel a sum of ``targets.waves`` seeded plane waves, squashed."""
    h, w = int(cfg["height"]), int(cfg["width"])
    k = int(cfg["targets"]["waves"])
    g = generator(seed + 1, device)
    f32 = torch.float32
    freq = torch.rand((views, 3, k, 2), generator=g, device=device, dtype=f32) * 12.0 - 6.0
    phase = torch.rand((views, 3, k), generator=g, device=device, dtype=f32) * (2 * math.pi)
    amp = torch.rand((views, 3, k), generator=g, device=device, dtype=f32) / k
    ys = torch.linspace(0.0, 1.0, h, device=device, dtype=f32)
    xs = torch.linspace(0.0, 1.0, w, device=device, dtype=f32)
    out = torch.empty((views, h, w, 3), dtype=f32, device=device)
    for v in range(views):
        acc = torch.zeros((3, h, w), dtype=f32, device=device)
        for j in range(k):
            fy = freq[v, :, j, 1, None, None] * ys[None, :, None]
            fx = freq[v, :, j, 0, None, None] * xs[None, None, :]
            acc += amp[v, :, j, None, None] * torch.sin(2 * math.pi * (fx + fy)
                                                        + phase[v, :, j, None, None])
        out[v] = (0.5 + 0.9 * 0.5 * torch.tanh(2.0 * acc)).permute(1, 2, 0)
    return out
