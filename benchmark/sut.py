"""The system under test: the PyTorch/CUDA port, as its users call it.

The only module of the benchmark that imports the program. A frame is
``render.render_arrays`` with the configuration's ``RenderConfig`` (the
fast path, ``use_pallas=True``), its capacity pinned by the port's own
``autotune_capacity``; a training step is the callable
``train.make_train_step`` returns, fed as ``fit_scene`` feeds it. The
benchmark hands the program only what it made itself: parameters,
targets and camera matrices.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import torch

import openglgaussiansplattingrenderer_tpu_torch as gs

# the package's ``render`` function shadows its module of that name
gs_render = importlib.import_module(gs.__name__ + ".render")
gs_trainer = importlib.import_module(gs.__name__ + ".train.trainer")

PROGRAM = gs.__name__


def render_config(cfg: dict, **over) -> gs.RenderConfig:
    """The configuration's RenderConfig, every other field at its
    default (which the reference renderer's constants mirror)."""
    r = cfg["render"]
    kw = dict(chunk=int(r["chunk"]), depth_key=r["depth_key"],
              sh_degree=int(cfg["sh_degree"]), use_pallas=True)
    kw.update(over)
    return gs.RenderConfig.for_resolution(int(cfg["width"]), int(cfg["height"]),
                                          tile_px=int(r["tile_px"]), **kw)


def autotune(params: Dict[str, torch.Tensor], cams: List[dict], rcfg, cfg: dict,
             margin: float):
    """``rcfg`` with the capacity the port's ``autotune_capacity`` picks
    for the most demanding of ``cams``."""
    w, h = int(cfg["width"]), int(cfg["height"])
    caps = [gs_render.autotune_capacity(params, c["view"], c["vp"], c["focal_x"], c["focal_y"],
                                        c["tan_fovx"], c["tan_fovy"], w, h, rcfg,
                                        margin=margin).capacity_records
            for c in cams]
    return dataclasses.replace(rcfg, capacity_records=max(caps))


def render(params: Dict[str, torch.Tensor], cam: dict, rcfg, cfg: dict):
    """One frame: ((H, W, 4) image, stats), as the viewer renders it."""
    return gs_render.render_arrays(params, cam["view"], cam["vp"], cam["focal_x"],
                                   cam["focal_y"], cam["tan_fovx"], cam["tan_fovy"],
                                   int(cfg["width"]), int(cfg["height"]), rcfg)


def make_step(cfg: dict, rcfg, keys):
    """The training step for raw tensors ``keys`` at the configuration's
    rates. Raises where the program would step a key at another rate
    than the configuration states."""
    tr = cfg["train"]
    lr = tr["lr"]
    tc = gs_trainer.TrainConfig(lr_means=lr["means"], lr_scales=lr["log_scales"],
                                lr_quats=lr["quats"], lr_opacities=lr["logit_opacities"],
                                lr_colors=lr["colors"], lambda_dssim=tr["lambda_dssim"])
    step = gs_trainer.make_train_step(rcfg, tc, int(cfg["width"]), int(cfg["height"]),
                                      param_keys=tuple(keys))
    for k in keys:
        got = step.optimizer.learning_rate(k, 0)
        if abs(got - float(lr[k])) > 1e-12 * abs(float(lr[k])):
            raise ValueError(f"the program steps {k} at {got}, the configuration states {lr[k]}")
    return step


def bundles(cams: List[dict], device) -> list:
    """Each camera's step arguments, matrices on the device, as
    ``fit_scene`` makes them."""
    return gs_trainer.camera_bundles(cams, device)


def moments(state) -> Dict[str, torch.Tensor]:
    """Adam's first moments by key, of a training state."""
    return state.opt_state["mu"]
