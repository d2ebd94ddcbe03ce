"""Peaks of the card, each stage's bytes and operations from its shapes,
and the attribution of the profiler's kernels to stages.

A stage's bound is the least time the card could take for it: the larger
of its operations over the float32 peak and its bytes over the memory
peak. Bytes count what the stage's inputs and outputs need, each read or
written once (what one implementation keeps between its own launches does
not count); records are the frame's own ``num_records`` (the binned
records for the compositor), never the capacity.

Peaks: NVIDIA H100 SXM5 80 GB (data sheet, dense, no sparsity), 67 TFLOP/s
float32 outside the tensor cores and 3.35 TB/s of HBM3, both at the full
700 W power limit; ``power_limit`` reads the card's own.
"""

from __future__ import annotations

import re
import subprocess
from typing import Dict, Iterable, List, Optional, Tuple

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float = 0.0, flops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def sh_rest_floats(sh_degree: int) -> int:
    return 3 * ((sh_degree + 1) ** 2 - 1)


# ---- stages (bytes, flops) ---------------------------------------------------

def table(splats: int, sh_degree: int, backward: bool = False) -> Tuple[float, float]:
    """The splat table (kernels 10, 11). Forward 126 B a splat (means,
    scales, quats, opacity, colour in; nine fields, rect, count, depth,
    radius out) plus the SH coefficients read; backward 136 B plus the SH
    coefficients read and their gradient written."""
    rest = 4 * sh_rest_floats(sh_degree)
    return (splats * (136 + 2 * rest) if backward else splats * (126 + rest)), 0.0


def prefix(splats: int) -> Tuple[float, float]:
    """Kernel 1: the counts read, the inclusive sums written."""
    return 8.0 * splats, 0.0


def expand(records: int, splats: int) -> Tuple[float, float]:
    """Kernel 2 in the record sort's mode: a splat's sum, rect and depth
    read (24 B); a record's splat id, tile, depth word written (16 B)."""
    return 16.0 * records + 24.0 * splats, 0.0


def sort(records: int, backward: bool = False) -> Tuple[float, float]:
    """Row 12, the record sort by splat: 84 B a record; row 13, the
    un-sort of the nine cotangent rows: 76 B a record."""
    return (76.0 if backward else 84.0) * records, 0.0


def segsum(records: int, splats: int) -> Tuple[float, float]:
    """Kernel 3, the expansion's transpose: 36 B a record, 40 B a splat."""
    return 36.0 * records + 40.0 * splats, 0.0


def composite(binned: int, pixels: int, backward: bool = False) -> Tuple[float, float]:
    """Kernels 4, 5: 36 B a binned record and 16 B a pixel forward; 72 B
    and 32 B backward."""
    if backward:
        return 72.0 * binned + 32.0 * pixels, 0.0
    return 36.0 * binned + 16.0 * pixels, 0.0


def image(pixels: int, image_pixels: int) -> Tuple[float, float]:
    """The tiled (T, P, 4) frame read and the (H, W, 4) image written."""
    return 16.0 * pixels + 16.0 * image_pixels, 0.0


def loss(image_pixels: int, backward: bool = False) -> Tuple[float, float]:
    """Rows 15, 16, L1 + D-SSIM of a 3-channel image: forward, prediction
    and target read once (24 B a pixel) and five maps filtered by the
    separable 11-tap window (220 operations a pixel and channel);
    backward, both read again and the gradient written (36 B) and three
    maps filtered (132 operations)."""
    if backward:
        return 36.0 * image_pixels, 132.0 * 3 * image_pixels
    return 24.0 * image_pixels, 220.0 * 3 * image_pixels


def activation(splats: int, backward: bool = False) -> Tuple[float, float]:
    """Raw to render parameters (exp of 3 log-scales, sigmoid, quaternion
    norm): 8 floats read and written; backward also reads the outputs'
    cotangents."""
    return (96.0 if backward else 64.0) * splats, 0.0


def adam(elements: int) -> Tuple[float, float]:
    """Row 14: parameter, gradient and both moments read, parameter and
    moments written: 28 B an element."""
    return 28.0 * elements, 0.0


def frame_stages(s: dict) -> Dict[str, Tuple[float, float]]:
    """Every stage of one frame, for shapes ``s`` of that frame."""
    return {"table": table(s["splats"], s["sh_degree"]),
            "prefix": prefix(s["splats"]),
            "expand": expand(s["records"], s["splats"]),
            "sort": sort(s["records"]),
            "composite": composite(s["binned"], s["pixels"]),
            "image": image(s["pixels"], s["image_pixels"])}


def step_stages(s: dict) -> Dict[str, Tuple[float, float]]:
    """Every stage of one training step: the frame, the loss, the
    frame's backward and Adam."""
    out = {"activation": activation(s["splats"]), **frame_stages(s)}
    out.update({"loss": loss(s["image_pixels"]),
                "loss_bwd": loss(s["image_pixels"], backward=True),
                "composite_bwd": composite(s["binned"], s["pixels"], backward=True),
                "unsort": sort(s["records"], backward=True),
                "segsum": segsum(s["records"], s["splats"]),
                "table_bwd": table(s["splats"], s["sh_degree"], backward=True),
                "activation_bwd": activation(s["splats"], backward=True),
                "adam": adam(s["adam_elements"])})
    return out


def bound_sum_s(stages: Dict[str, Tuple[float, float]]) -> float:
    return sum(bound_s(b, f) for b, f in stages.values())


# ---- attribution -------------------------------------------------------------

def _matcher(names: Iterable[str]):
    pats = [re.compile(r"(?<![A-Za-z0-9_])" + re.escape(n) + r"(?![A-Za-z0-9_])")
            for n in names]
    return lambda kernel: any(p.search(kernel) for p in pats)


def stage_time_s(kernels: Dict[str, float], names: Iterable[str]) -> float:
    """Device seconds of the kernels whose names carry one of ``names``
    as a whole word (a function name in the profiler's signature)."""
    hit = _matcher(names)
    return sum(t for k, t in kernels.items() if hit(k))


def unattributed(kernels: Dict[str, float], maps: Iterable[Iterable[str]]
                 ) -> List[Tuple[str, float]]:
    """Kernels no stage's map claims, longest first."""
    hits = [_matcher(m) for m in maps]
    rest = [(k, t) for k, t in kernels.items() if not any(h(k) for h in hits)]
    return sorted(rest, key=lambda kt: -kt[1])


def roofline_pct(rec, names: Iterable[str], work: Iterable[Tuple[float, float]]
                 ) -> Optional[float]:
    """100 x the bound of ``work`` ((bytes, operations) of the stage in
    each traced frame or step) over the device time of the stage's
    kernels in the traced window; None where no such kernel ran."""
    t = stage_time_s(rec.kernels, names)
    if t <= 0.0:
        return None
    return 100.0 * sum(bound_s(b, f) for b, f in work) / t


def mfu_pct(rec, stages_of) -> Optional[float]:
    """100 x the bound of every stage of every traced frame or step
    (``stages_of(shapes)``) over the traced window's length."""
    if not rec.units or rec.window_s <= 0.0:
        return None
    return 100.0 * sum(bound_sum_s(stages_of(u)) for u in rec.units) / rec.window_s


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
