"""The numbers that decide ``correct``, each held to its limit.

Frames (``orbit``): of frames the timed path rendered, drawn from the
seed, the reference renders the same poses of the same scene; compared
are the record count (exact), the largest and the mean absolute gap of
the RGBA image.

Steps (``train-steady``): the reference follows the program's first
three steps from the same raw parameters on the same views; compared are
each step's loss (relative gap, worst step), the norm of the first
gradient (the program's from Adam's first moment after one step) and the
norm of each tensor's change after three steps, both by the worst tensor:
the gap between the program's norm and the reference's over the larger of
the reference's norm of that tensor and of the median tensor. A tensor
whose reference gradient is under a thousandth of the median tensor's
moves by round-off alone and is left out of the change.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def frame_numbers(pairs) -> Dict[str, float]:
    """``pairs``: (program image, program num_records, reference image,
    reference record count) of each compared frame; no frame compared
    reads NaN, which no limit passes."""
    if not pairs:
        return dict.fromkeys(("records_gap", "img_max_gap", "img_mean_gap"), float("nan"))
    rec = mx = mean = 0.0
    for img, n, ref, ref_n in pairs:
        d = (img.float() - ref.float()).abs()
        rec = max(rec, abs(int(n) - int(ref_n)))
        mx = max(mx, float(d.max()))
        mean = max(mean, float(d.mean(dtype=torch.float64)))
    return {"records_gap": float(rec), "img_max_gap": mx, "img_mean_gap": mean}


def _worst(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref)


def step_numbers(prog_losses: List[float], prog_grad: Dict[str, float],
                 prog_change: Dict[str, float], ref_losses: List[float],
                 ref_grad: Dict[str, float], ref_change: Dict[str, float]) -> Dict[str, float]:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    med = statistics.median(ref_grad.values())
    moved = [k for k in ref_change if ref_grad[k] >= 1e-3 * med]
    return {"loss_gap": loss, "grad_gap": _worst(prog_grad, ref_grad),
            "change_gap": _worst({k: prog_change[k] for k in moved},
                                 {k: ref_change[k] for k in moved})}


def judge(numbers: Dict[str, float], limits: dict) -> tuple:
    """(correct, {name: [number, limit]}); a number without a limit
    fails."""
    lim = limits.get("limits", {})
    out, ok = {}, True
    for k, v in numbers.items():
        cap: Optional[float] = lim.get(k)
        out[k] = [v, cap]
        ok = ok and cap is not None and v == v and v <= cap
    return ok, out
