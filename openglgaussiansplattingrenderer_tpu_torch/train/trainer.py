"""Splat-fitting trainer: Adam steps on the gradients of ``render_arrays``.

Counterpart of ``openglgaussiansplattingrenderer_tpu/train/trainer.py``.
Parameters are optimised in *raw* (pre-activation) space like standard 3DGS
training: log-scales, logit-opacity, unnormalised quaternions, raw colours.
The optimizer is per-tensor Adam written out on tensors (the JAX package's
``optax.multi_transform`` of ``optax.adam``): b1 0.9, b2 0.999, eps 1e-8
added outside the square root, bias correction by the step count, no weight
decay. Checkpoints are plain npz files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import (
    inverse_sigmoid,
    sigmoid,
)
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import losses

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
DEFAULT_KEYS = ("means", "log_scales", "quats", "logit_opacities", "colors")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_colors: float = 2.5e-1      # colours live in 0..255 space
    lambda_dssim: float = 0.2
    steps: int = 200
    # Standard 3DGS position-LR schedule (Kerbl et al. train.py): exponential
    # log-interp decay from lr_means down to lr_means_final over
    # lr_means_decay_steps. lr_means_final=None keeps the constant LR.
    lr_means_final: Optional[float] = None
    lr_means_decay_steps: Optional[int] = None


def raw_from_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Activated parameters -> unconstrained optimisation space. ``sh_rest``
    (already linear) rides along when present so it trains too."""
    raw = {
        "means": params["means"],
        "log_scales": torch.log(torch.clamp_min(params["scales"], 1e-30)),
        "quats": params["quats"],
        "logit_opacities": inverse_sigmoid(
            torch.clamp(params["opacities"], 1e-6, 1.0 - 1e-6)),
        "colors": params["colors"],
    }
    if params.get("sh_rest") is not None:
        raw["sh_rest"] = params["sh_rest"]
    return raw


def params_from_raw(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Unconstrained space -> activated render parameters (differentiable)."""
    quats = raw["quats"]
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    params = {
        "means": raw["means"],
        "scales": torch.exp(raw["log_scales"]),
        "quats": quats,
        "opacities": sigmoid(raw["logit_opacities"]),
        "colors": raw["colors"],
    }
    if "sh_rest" in raw:
        params["sh_rest"] = raw["sh_rest"]
    return params


@dataclasses.dataclass
class TrainState:
    """``opt_state`` is ``{"count": int, "mu": {key: tensor}, "nu": {key:
    tensor}}``: Adam's step count and both moments per raw tensor."""
    raw: Dict[str, torch.Tensor]
    opt_state: dict
    step: int = 0


class Optimizer:
    """Per-tensor Adam. ``keys`` must match the raw dict (pass ``raw.keys()``
    when it carries ``sh_rest``). SH coefficients use lr_colors / 20, the
    standard 3DGS ratio for the rest bands."""

    def __init__(self, tc: TrainConfig, keys=DEFAULT_KEYS):
        self.tc = tc
        self.keys = tuple(keys)
        self.lrs = {
            "means": tc.lr_means,
            "log_scales": tc.lr_scales,
            "quats": tc.lr_quats,
            "logit_opacities": tc.lr_opacities,
            "colors": tc.lr_colors,
            "sh_rest": tc.lr_colors / 20.0,
        }

    def learning_rate(self, key: str, count: int) -> float:
        """The rate of the step taken at ``count`` (the count before the
        step's increment: step 0 uses lr_means). With ``lr_means_final``
        the position rate is exp(lerp(ln lr0, ln lr1, count / T)), 3DGS's
        get_expon_lr_func, evaluated in float32 as the JAX package does."""
        tc = self.tc
        if key != "means" or tc.lr_means_final is None:
            return self.lrs[key]
        f32 = np.float32
        steps = tc.lr_means_decay_steps or tc.steps
        t = np.clip(f32(count) / f32(steps), f32(0.0), f32(1.0))
        return float(np.exp((f32(1.0) - t) * np.log(f32(tc.lr_means))
                            + t * np.log(f32(tc.lr_means_final))))

    def init(self, raw: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(raw[k]) for k in self.keys},
                "nu": {k: torch.zeros_like(raw[k]) for k in self.keys}}

    def update(self, grads: Dict[str, torch.Tensor], opt_state: dict
               ) -> Tuple[Dict[str, torch.Tensor], dict]:
        """(updates to add to the raw tensors, new state)."""
        count = opt_state["count"]
        # bias corrections in float32, as the JAX package's optimizer takes
        # them: 1 - b2^t cancels, so its float32 rounding shows in the step
        f32 = np.float32
        c1 = float(f32(1.0) - f32(ADAM_B1) ** f32(count + 1))
        c2 = float(f32(1.0) - f32(ADAM_B2) ** f32(count + 1))
        mu, nu, updates = {}, {}, {}
        for k in self.keys:
            g = grads[k]
            mu[k] = ADAM_B1 * opt_state["mu"][k] + (1.0 - ADAM_B1) * g
            nu[k] = ADAM_B2 * opt_state["nu"][k] + (1.0 - ADAM_B2) * (g * g)
            step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
            updates[k] = -self.learning_rate(k, count) * step
        return updates, {"count": count + 1, "mu": mu, "nu": nu}


def make_optimizer(tc: TrainConfig, keys=DEFAULT_KEYS) -> Optimizer:
    return Optimizer(tc, keys)


def make_train_step(cfg: RenderConfig, tc: TrainConfig, width: int,
                    height: int,
                    loss_fn: Optional[Callable] = None,
                    with_grad_norms: bool = False,
                    grad_stat: str = "screen",
                    param_keys=None) -> Callable:
    """(state, target, camera args) -> (state, metrics) step. The step runs
    on the device the state's tensors lie on; ``target`` and the matrices
    must lie there too. Metrics are 0-d tensors (no host sync).

    ``with_grad_norms`` adds a per-splat ``densify_grad_norm`` (N,) tensor
    to the metrics, the selection statistic of adaptive density control.
    ``grad_stat`` picks it:

    - ``"screen"`` (default): the screen-space positional gradient, 3DGS's
      statistic: the gradient with respect to a zero per-splat shift added
      to the composited mean2d, scaled by (W/2, H/2) to NDC units.
    - ``"world"``: the norm of dL/d means.

    ``param_keys`` must name the raw dict's keys when they differ from the
    default five (e.g. ``sh_rest`` training).
    """
    if grad_stat not in ("screen", "world"):
        raise ValueError(f"unknown grad_stat {grad_stat!r}")
    optimizer = (make_optimizer(tc) if param_keys is None
                 else make_optimizer(tc, keys=param_keys))
    screen = with_grad_norms and grad_stat == "screen"

    def loss_of(raw, shift2d, target, view, vp, fx, fy, tfx, tfy):
        params = params_from_raw(raw)
        if shift2d is not None:
            params["shift2d"] = shift2d
        img, _ = render_arrays(params, view, vp, fx, fy, tfx, tfy,
                               width, height, cfg)
        pred = img[..., :3]
        if loss_fn is not None:
            return loss_fn(pred, target), pred
        return losses.gs_loss(pred, target, tc.lambda_dssim), pred

    def run(state: TrainState, target, view, vp, fx, fy, tfx, tfy
            ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        keys = optimizer.keys
        raw = {k: state.raw[k].detach().requires_grad_(True) for k in keys}
        shift = None
        if screen:
            shift = torch.zeros((raw["means"].shape[0], 2), dtype=torch.float32,
                                device=raw["means"].device, requires_grad=True)
        loss, pred = loss_of(raw, shift, target, view, vp, fx, fy, tfx, tfy)
        wrt = [raw[k] for k in keys] + ([shift] if screen else [])
        gs = torch.autograd.grad(loss, wrt)
        grads = dict(zip(keys, gs))
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "psnr": losses.psnr(pred.detach(), target)}
            if screen:
                # pixel gradients scaled to NDC units (x_ndc = 2 x_px / W)
                scale = gs[-1].new_tensor([width / 2.0, height / 2.0])
                metrics["densify_grad_norm"] = torch.linalg.vector_norm(
                    gs[-1] * scale, dim=-1)
            elif with_grad_norms:
                metrics["densify_grad_norm"] = torch.linalg.vector_norm(
                    grads["means"], dim=-1)
            updates, opt_state = optimizer.update(grads, state.opt_state)
            new_raw = {k: raw[k].detach() + updates[k] for k in keys}
        return TrainState(new_raw, opt_state, state.step + 1), metrics

    run.init = lambda raw: TrainState(dict(raw), optimizer.init(raw), 0)
    run.optimizer = optimizer
    return run


def camera_dims(cam) -> Tuple[int, int]:
    """(width, height) of a Camera or a camera bundle dict."""
    if isinstance(cam, dict):
        return int(cam["width"]), int(cam["height"])
    return cam.width, cam.height


def camera_bundles(cameras, device):
    """Per-camera step argument tuples (view, vp, focals, tanfovs) with the
    matrices on ``device``. Each entry is a ``Camera`` or a bundle dict with
    ``camera_args``'s keys."""
    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args

    bundles = []
    for cam in cameras:
        a = cam if isinstance(cam, dict) else camera_args(cam)
        mats = [torch.as_tensor(np.asarray(a[k]), dtype=torch.float32,
                                device=device) for k in ("view", "vp")]
        bundles.append((*mats, a["focal_x"], a["focal_y"], a["tan_fovx"],
                        a["tan_fovy"]))
    return bundles


def fit_scene(params: Dict[str, torch.Tensor], targets, cameras,
              cfg: RenderConfig, tc: Optional[TrainConfig] = None,
              width: Optional[int] = None, height: Optional[int] = None,
              log_every: int = 50, verbose: bool = True,
              save_every: int = 0, checkpoint_path: Optional[str] = None,
              resume: Optional[str] = None,
              device: torch.device | str = "cuda"):
    """Fit splat parameters to (target image, camera) pairs on ``device``.

    params: activated parameter dict (tensors or numpy arrays); targets:
    list of (H, W, 3) arrays; cameras: list of Camera. Returns (activated
    params, history).

    ``save_every``/``checkpoint_path`` write a full-state npz (raw params +
    optimizer moments + step) every N steps; ``resume`` restores one and
    continues from its step. The resumed run replays the exact step
    sequence: every reduction in the step has a fixed order (the backward
    kernels use no float atomics), so it matches an uninterrupted run bit
    for bit.
    """
    tc = tc or TrainConfig()
    device = torch.device(device)
    width = width or camera_dims(cameras[0])[0]
    height = height or camera_dims(cameras[0])[1]
    with torch.no_grad():
        raw = raw_from_params({
            k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in params.items() if v is not None})
    step = make_train_step(cfg, tc, width, height,
                           param_keys=tuple(sorted(raw.keys())))
    state = step.init(raw)
    start_step = 0
    if resume:
        r_raw, start_step, extras = load_checkpoint_full(resume)
        check_resume_shapes(raw, r_raw, resume)
        opt = (restore_opt_state(state.opt_state, extras["opt_state"])
               if "opt_state" in extras else state.opt_state)
        state = TrainState(
            {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in r_raw.items()}, opt, start_step)
        if verbose:
            print(f"resumed {resume} at step {start_step}")
    cam_bundles = camera_bundles(cameras, device)
    targets = [torch.as_tensor(t, dtype=torch.float32, device=device)
               for t in targets]

    history = []
    for i in range(start_step, tc.steps):
        j = i % len(targets)
        state, metrics = step(state, targets[j], *cam_bundles[j])
        if (i % log_every == 0 or i == tc.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f}")
        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            save_checkpoint(checkpoint_path, state.raw, step=i + 1,
                            opt_state=state.opt_state)
    with torch.no_grad():
        return params_from_raw(state.raw), history


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_checkpoint(path: str, raw: Dict[str, torch.Tensor], step: int = 0,
                    opt_state: Optional[dict] = None, **extras) -> None:
    """npz checkpoint: ``step``, the raw arrays under their own names, and
    ``extras`` (any additional arrays) under an ``x_`` prefix, as the JAX
    package writes them. The optimizer state is stored as ``o_count`` and,
    per raw tensor, ``o_mu_<key>`` and ``o_nu_<key>`` (the JAX package
    numbers optax's leaves instead; ``convert.train_state_from_checkpoint``
    reads that form).

    Written atomically (tmp file + rename) so a kill mid-save never leaves
    a truncated checkpoint behind.
    """
    opt = {}
    if opt_state is not None:
        opt["o_count"] = np.asarray(opt_state["count"])
        for m in ("mu", "nu"):
            opt.update({f"o_{m}_{k}": _to_numpy(v)
                        for k, v in opt_state[m].items()})
    tmp = path + ".tmp.npz"  # np.savez appends .npz to other suffixes anyway
    np.savez(tmp, step=step,
             **{k: _to_numpy(v) for k, v in raw.items()},
             **opt,
             **{f"x_{k}": _to_numpy(v) for k, v in extras.items()})
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def restore_opt_state(template: dict, saved: dict) -> dict:
    """Rebuild an optimizer state from checkpointed arrays: ``template`` is
    ``optimizer.init(raw)`` for the same parameter set, ``saved`` the
    ``opt_state`` entry of ``load_checkpoint_full``'s extras."""
    out = {"count": int(saved["count"]), "mu": {}, "nu": {}}
    for m in ("mu", "nu"):
        if set(saved[m]) != set(template[m]):
            raise ValueError(
                f"checkpointed optimizer state holds {sorted(saved[m])}, "
                f"this optimizer wants {sorted(template[m])} -- was it saved "
                "with a different parameter set?")
        for k, t in template[m].items():
            if np.shape(saved[m][k]) != tuple(t.shape):
                raise ValueError(
                    f"checkpointed optimizer moment {m}[{k!r}] has shape "
                    f"{np.shape(saved[m][k])}, this run wants "
                    f"{tuple(t.shape)} -- was the checkpoint saved at a "
                    "different capacity or parameter set?")
            out[m][k] = torch.as_tensor(saved[m][k], dtype=t.dtype, device=t.device)
    return out


def check_resume_shapes(current_raw, loaded_raw, resume: str) -> None:
    """Fail fast with a clear message when a resume checkpoint's parameter
    shapes don't match the run being resumed."""
    missing = set(current_raw) - set(loaded_raw)
    if missing:
        raise ValueError(
            f"resume checkpoint {resume!r} is missing parameters "
            f"{sorted(missing)} this run trains")
    extra = set(loaded_raw) - set(current_raw)
    if extra:
        raise ValueError(
            f"resume checkpoint {resume!r} carries parameters "
            f"{sorted(extra)} this run does not train -- resuming would "
            "silently drop them (was the checkpoint saved with sh_rest / "
            "a different parameter set?)")
    for k, v in current_raw.items():
        if np.shape(loaded_raw[k]) != tuple(v.shape):
            raise ValueError(
                f"resume checkpoint {resume!r}: parameter {k!r} has shape "
                f"{np.shape(loaded_raw[k])}, this run wants "
                f"{tuple(v.shape)} -- wrong capacity or scene?")


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """Returns (raw params, step); extras are ignored (see
    ``load_checkpoint_full``)."""
    raw, step, _ = load_checkpoint_full(path)
    return raw, step


def load_checkpoint_full(
    path: str,
) -> Tuple[Dict[str, np.ndarray], int, Dict[str, np.ndarray]]:
    """Returns (raw params, step, extras) of an npz checkpoint, as
    ``split_checkpoint`` splits its arrays."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as z:
        return split_checkpoint({k: z[k] for k in z.files})


def split_checkpoint(
    arrays: Dict[str, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], int, Dict[str, np.ndarray]]:
    """A checkpoint's arrays -> (raw params, step, extras), all numpy:
    extras as saved via ``save_checkpoint(..., name=array)``, prefix
    stripped. A checkpointed optimizer state lands in extras as
    ``opt_state`` (``{"count", "mu", "nu"}``) for ``restore_opt_state``; the
    numbered leaves ``o_<i>`` of a checkpoint written by the JAX package
    land there as ``opt_leaves`` (a list in saved order) for
    ``convert.train_state_from_checkpoint``."""
    raw = {k: v for k, v in arrays.items()
           if k != "step" and not k.startswith(("x_", "o_"))}
    extras = {k[2:]: v for k, v in arrays.items() if k.startswith("x_")}
    if "o_count" in arrays:
        extras["opt_state"] = {
            "count": int(arrays["o_count"]),
            "mu": {k[5:]: v for k, v in arrays.items() if k.startswith("o_mu_")},
            "nu": {k[5:]: v for k, v in arrays.items() if k.startswith("o_nu_")}}
    numbered = sorted((k for k in arrays if k.startswith("o_") and k[2:].isdigit()),
                      key=lambda k: int(k[2:]))
    if numbered:
        extras["opt_leaves"] = [arrays[k] for k in numbered]
    return raw, int(arrays["step"]), extras
