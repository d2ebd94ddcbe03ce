"""The plain reference of 3DGS's adaptive density control at a fixed capacity.

Kerbl et al. 2023, section 5.2, as graphdeco-inria/gaussian-splatting
writes it (``scene/gaussian_model.py``: ``add_densification_stats``,
``densify_and_clone``, ``densify_and_split``, ``densify_and_prune``,
``reset_opacity``; ``train.py``; ``scene/dataset_readers.py``
``getNerfppNorm``), in plain torch and float32:

- ``screen_statistic``: the norm of the loss's gradient with respect to
  each splat's 2-D mean, in NDC units (the pixel gradient times W/2 and
  H/2: 3DGS's ``viewspace_point_tensor.grad[:, :2]``), from
  ``reference/train.py``'s loss and compositor (rows 0-1 of the projected
  fields are the 2-D mean);
- ``event``: prune splats whose opacity is under ``min_opacity`` or, past
  ``big_prune_after``, whose largest scale exceeds ``big_scale_frac`` x
  the scene's extent (``big_points_ws``); candidates are live splats seen
  at least once whose average statistic exceeds the threshold; a
  candidate whose largest scale exceeds ``percent_dense`` x extent is
  split, the others are cloned as they are; a split child is drawn from
  N(mean, R S^2 R^T) with its scales divided by ``split_factor``, and the
  split original is drawn again in place the same way; Adam's moments
  are zeroed on every changed row;
- ``reset_opacity``: every opacity clamped to the ceiling (0.01), the
  opacity moments zeroed;
- ``scene_extent``: 1.1 x the largest distance of a training camera's
  centre from their mean (``getNerfppNorm``).

Departures from 3DGS, each the program's as well:

- prune first, so the rows it frees take this event's new splats (3DGS
  clones and splits, then prunes);
- a fixed capacity: the rows past the live set are parked (opacity and
  scale logits of -20, identity rotation, zeros) and the new splats go
  into free rows, the strongest candidates first (by average statistic,
  ties to the lower row) into the lowest free rows; candidates left
  without a row stay as they are (3DGS grows the arrays). A parked row's
  moments are zeroed at every event;
- a split keeps its original in place, drawn again, and takes one free
  row for its second child (3DGS removes it and appends two);
- "seen" means a non-zero statistic, not ``radii > 0``; a candidate's
  statistic exceeds the threshold strictly (3DGS: ``>=``, apart only on
  a tie);
- no screen-size test: in the published code ``max_radii2D > 20`` reads
  ``max_radii2D`` after ``densification_postfix`` has reset it to zeros,
  so it never fires.

The split draws are one (2, capacity, 3) standard normal tensor from a
``torch.Generator`` whose state the caller passes in, drawn whether or
not a split happens: [0] for a child, [1] for its original, by the row
each lands in. With the same state on the same device the program draws
the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import render as rr
from benchmark.reference import train as rt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEAD_LOGIT = -20.0
DEAD_LOG_SCALE = -20.0


def scene_extent(views: List[dict]) -> float:
    """3DGS's ``cameras_extent`` of the training cameras (``view`` 4x4
    world-to-camera matrices): 1.1 x the largest distance of a camera
    centre from the centres' mean."""
    m = torch.stack([torch.as_tensor(v["view"], dtype=torch.float64) for v in views])
    c = -(m[:, :3, :3].transpose(1, 2) @ m[:, :3, 3:])[:, :, 0]
    return float(1.1 * torch.linalg.vector_norm(c - c.mean(dim=0), dim=1).max())


def pad(raw: Dict[str, torch.Tensor], capacity: int) -> Dict[str, torch.Tensor]:
    """Raw splats followed by parked rows up to ``capacity``."""
    n = raw["means"].shape[0]
    out = {}
    for k, v in raw.items():
        tail = torch.zeros((capacity - n,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=v.device)
        if k == "logit_opacities":
            tail.fill_(DEAD_LOGIT)
        elif k == "log_scales":
            tail.fill_(DEAD_LOG_SCALE)
        elif k == "quats":
            tail[:, 0] = 1.0
        out[k] = torch.cat([v, tail])
    return out


def screen_statistic(raw: Dict[str, torch.Tensor], target: torch.Tensor, cam: dict,
                     fr: rr.Frame, lam: float, prec: rr.Precision = rr.FP32,
                     pair_budget: int = 1 << 25) -> torch.Tensor:
    """(N,) the norm of dL / d(2-D mean) in NDC units of one view."""
    with torch.no_grad():
        proj = rr.project(rt.params_from_raw(raw), cam, fr, prec)
        sid, bounds, _ = rr.bin_and_sort(proj, fr)
        fields = proj["fields"]
        rec = fields[sid]
        comp = rr.Compositor(fr, prec, pair_budget)
        rgb, trans = comp.forward(rec, bounds, keep=True)
        img = rr.assemble(rgb, trans, fr)
    img.requires_grad_(True)
    with torch.enable_grad():
        loss = rt.gs_loss(img[..., :3], target, lam)
        (g_img,) = torch.autograd.grad(loss, img)
    g_rgb, g_trans = rr.untile(prec(g_img.to(torch.float32)), fr)
    g_rec = comp.backward(rec, bounds, g_rgb, g_trans)
    g_mean = torch.zeros_like(fields).index_add_(0, sid, g_rec)[:, :2]
    ndc = torch.tensor([fr.width / 2.0, fr.height / 2.0], device=g_mean.device)
    return prec(torch.linalg.vector_norm(prec(g_mean * ndc), dim=-1))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of (N, 4) wxyz quaternions, normalised first
    (3DGS's ``build_rotation``)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


@torch.no_grad()
def event(raw: Dict[str, torch.Tensor], alive: torch.Tensor, grad_accum: torch.Tensor,
          seen_count: torch.Tensor, mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
          generator: torch.Generator, d: dict, extent: float, iteration: int,
          prec: rr.Precision = rr.FP32) -> dict:
    """One densify event, ended at ``iteration``, of the settings ``d`` (a
    configuration's ``densify`` block). Returns ``raw``, ``alive``,
    ``changed``, ``mu``, ``nu`` after it and ``stats`` (pruned, cloned,
    split, alive) as ints."""
    q = prec
    cap = alive.shape[0]
    dev = alive.device
    draws = torch.randn((2, cap, 3), generator=generator, device=dev, dtype=torch.float32)
    opacity = q(torch.sigmoid(q(raw["logit_opacities"])))
    biggest = q(torch.exp(q(raw["log_scales"]))).amax(dim=1)

    dies = alive & (opacity < float(d["min_opacity"]))
    if float(d["big_scale_frac"]) > 0.0 and iteration > int(d["big_prune_after"]):
        dies |= alive & (biggest > float(d["big_scale_frac"]) * extent)
    live = alive & ~dies

    average = q(grad_accum / torch.clamp_min(seen_count, 1.0))
    cand = live & (seen_count > 0) & (average > float(d["grad_threshold"]))
    splits = biggest > float(d["percent_dense"]) * extent
    cand_rows = torch.nonzero(cand).flatten()
    ranked = cand_rows[torch.sort(-average[cand_rows], stable=True).indices]
    free_rows = torch.nonzero(~live).flatten()
    k = min(len(ranked), len(free_rows))
    src, dst = ranked[:k], free_rows[:k]

    out = {key: v.clone() for key, v in raw.items()}
    for key, v in raw.items():
        out[key][dst] = v[src]
    child = splits[src]
    parent = src[child]
    rot = rotation(q(raw["quats"][parent]))
    sigma = q(torch.exp(q(raw["log_scales"][parent])))
    shrunk = q(raw["log_scales"][parent] - math.log(float(d["split_factor"])))

    def drawn(z):
        return q(raw["means"][parent] + (rot @ (z * sigma)[:, :, None])[:, :, 0])

    out["means"][dst[child]] = drawn(draws[0][dst[child]])
    out["log_scales"][dst[child]] = shrunk
    out["means"][parent] = drawn(draws[1][parent])
    out["log_scales"][parent] = shrunk

    now = live.clone()
    now[dst] = True
    out["logit_opacities"][~now] = DEAD_LOGIT
    out["log_scales"][~now] = DEAD_LOG_SCALE
    changed = ~now
    changed[dst] = True
    changed[parent] = True
    moments = []
    for m in (mu, nu):
        z = {key: v.clone() for key, v in m.items()}
        for v in z.values():
            v[changed] = 0.0
        moments.append(z)
    stats = {"pruned": int(dies.sum()), "cloned": int((~child).sum()),
             "split": int(child.sum()), "alive": int(now.sum())}
    return {"raw": out, "alive": now, "changed": changed, "mu": moments[0],
            "nu": moments[1], "stats": stats}


@torch.no_grad()
def reset_opacity(raw: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
                  nu: Dict[str, torch.Tensor], ceiling: float = 0.01):
    """3DGS's ``reset_opacity``: opacities clamped to ``ceiling``, the
    opacity moments zeroed. Returns (raw, mu, nu)."""
    p = torch.sigmoid(raw["logit_opacities"])
    p = torch.minimum(p, torch.full_like(p, ceiling))
    out = dict(raw, logit_opacities=torch.log(p / (1.0 - p)))
    zero = {m: dict(x, logit_opacities=torch.zeros_like(x["logit_opacities"]))
            for m, x in (("mu", mu), ("nu", nu))}
    return out, zero["mu"], zero["nu"]
