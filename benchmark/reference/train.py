"""The plain reference training step: 3DGS's loss, its gradient and Adam.

One step from raw parameters (log-scales, logit opacities, unnormalised
quaternions, colours in 0..255, SH coefficients) on one view: render
(``render.project`` / ``bin_and_sort`` / ``Compositor``), L1 + lambda
D-SSIM (Kerbl et al. 2023, section 5; 11 x 11 Gaussian window, sigma 1.5,
VALID) in float64 by autograd, the compositor's backward block by block,
autograd through the projection, then per-tensor Adam (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction by the step count)
at the configuration's rates.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import render as rr

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def params_from_raw(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    q = raw["quats"]
    out = {"means": raw["means"], "scales": torch.exp(raw["log_scales"]),
           "quats": q / torch.linalg.vector_norm(q, dim=-1, keepdim=True),
           "opacities": torch.sigmoid(raw["logit_opacities"]),
           "colors": raw["colors"]}
    if "sh_rest" in raw:
        out["sh_rest"] = raw["sh_rest"]
    return out


def _window(device) -> torch.Tensor:
    x = torch.arange(11, dtype=torch.float64, device=device) - 5.0
    g = torch.exp(-(x * x) / (2 * 1.5 ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def gs_loss(pred: torch.Tensor, target: torch.Tensor, lam: float) -> torch.Tensor:
    """(1 - lam) L1 + lam (1 - SSIM) / 2 of (H, W, 3) images, in float64."""
    p = pred.to(torch.float64).permute(2, 0, 1)[None]
    t = target.to(torch.float64).permute(2, 0, 1)[None]
    w = _window(pred.device)[None, None].expand(3, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, w, groups=3)

    mu_p, mu_t = filt(p), filt(t)
    sig_p = filt(p * p) - mu_p * mu_p
    sig_t = filt(t * t) - mu_t * mu_t
    sig_pt = filt(p * t) - mu_p * mu_t
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_p * mu_t + c1) * (2 * sig_pt + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (sig_p + sig_t + c2))
    return (1.0 - lam) * (p - t).abs().mean() + lam * (1.0 - ssim.mean()) / 2.0


def loss_and_gradients(raw: Dict[str, torch.Tensor], target: torch.Tensor, cam: dict,
                       fr: rr.Frame, lam: float, prec: rr.Precision = rr.FP32,
                       pair_budget: int = 1 << 25
                       ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss of one view and its gradient with respect to every raw
    tensor."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    proj = rr.project(params_from_raw(leaves), cam, fr, prec)
    sid, bounds, _ = rr.bin_and_sort(proj, fr)
    fields = proj["fields"]
    rec = fields.detach()[sid]
    comp = rr.Compositor(fr, prec, pair_budget)
    rgb, trans = comp.forward(rec, bounds, keep=True)
    img = rr.assemble(rgb, trans, fr).detach().requires_grad_(True)
    with torch.enable_grad():
        loss = gs_loss(img[..., :3], target, lam)
        (g_img,) = torch.autograd.grad(loss, img)
    g_rgb, g_trans = rr.untile(prec(g_img.to(torch.float32)), fr)
    g_rec = comp.backward(rec, bounds, g_rgb, g_trans)
    del rec
    g_fields = torch.zeros_like(fields).index_add_(0, sid, g_rec)
    del g_rec, sid
    grads = torch.autograd.grad(fields, list(leaves.values()), g_fields)
    return float(loss.detach()), {k: prec(g) for k, g in zip(leaves, grads)}


def adam(raw, mu, nu, count: int, grads, lrs: Dict[str, float]):
    """One Adam step of every key: (new raw, new mu, new nu)."""
    t = count + 1
    c1, c2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    out_raw, out_mu, out_nu = {}, {}, {}
    for k, g in grads.items():
        m = ADAM_B1 * mu[k] + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * nu[k] + (1.0 - ADAM_B2) * g * g
        out_raw[k] = raw[k] - lrs[k] * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
        out_mu[k], out_nu[k] = m, v
    return out_raw, out_mu, out_nu


def run_steps(raw0: Dict[str, torch.Tensor], views, cfg: dict, steps: int,
              prec: rr.Precision = rr.FP32, pair_budget: int = 1 << 25):
    """``steps`` steps from ``raw0`` over ``views`` (a list of (target,
    camera) pairs, one a step). Returns the losses, the first step's
    gradient by key and the change of every key after the last step."""
    tr = cfg["train"]
    lrs = {k: float(tr["lr"][k]) for k in raw0}
    lam = float(tr["lambda_dssim"])
    fr = rr.frame_of(cfg)
    raw = {k: v.clone() for k, v in raw0.items()}
    mu = {k: torch.zeros_like(v) for k, v in raw0.items()}
    nu = {k: torch.zeros_like(v) for k, v in raw0.items()}
    losses, first = [], None
    for i in range(steps):
        target, cam = views[i]
        loss, grads = loss_and_gradients(raw, target, cam, fr, lam, prec, pair_budget)
        if not math.isfinite(loss):
            raise FloatingPointError(f"reference step {i}: loss {loss}")
        losses.append(loss)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        raw, mu, nu = adam(raw, mu, nu, i, grads, lrs)
        del grads
    change = {k: raw[k] - raw0[k] for k in raw0}
    return losses, first, change
