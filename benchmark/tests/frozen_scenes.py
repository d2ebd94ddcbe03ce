"""The clustered scene generator as it stood before generators were found
by name: a frozen copy of ``scenes._structure`` and ``scenes.raw_scene``,
which the tests hold the harness's clustered scenes to."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark import scenes


def parent_structure(sc: dict, n: int):
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


def parent_raw_scene(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's scene in raw form: ``means`` (N, 3),
    ``log_scales`` (N, 3), ``quats`` (N, 4), ``logit_opacities`` (N,),
    ``colors`` (N, 3) in 0..255, and ``sh_rest`` (N, 45) where the
    configuration's SH degree is above 0. float32 on ``device``."""
    sc = cfg["scene"]
    if sc["generator"] != "clustered":
        raise ValueError(f"unknown scene generator {sc['generator']!r}")
    n = int(cfg["splats"])
    centres, csig, pop = parent_structure(sc, n)
    n_cl = int(pop.sum())
    n_bg = n - n_cl
    extent = float(sc["extent"])
    f32 = torch.float32
    g = scenes.generator(int(sc["structure_seed"]), device)
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
           "colors": (0.5 + scenes.SH_C0 * f_dc) * 255.0}
    if int(cfg["sh_degree"]) > 0:
        rest = 3 * ((int(cfg["sh_degree"]) + 1) ** 2 - 1)
        raw["sh_rest"] = float(sc["sh_rest_sigma"]) * torch.randn(
            (n, rest), generator=g, device=device, dtype=f32)
    # the rows in the run's own order
    perm = torch.randperm(n, generator=scenes.generator(seed, device), device=device)
    return {k: v[perm].contiguous() for k, v in raw.items()}
