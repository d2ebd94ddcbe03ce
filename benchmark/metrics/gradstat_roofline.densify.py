"""The selection statistic (its norm in the training step and
``train.densify.accumulate_grad_stats``, the ``gs.grad_stats`` spans):
25 B a capacity row (``densify_roofline.statistic``) times the
accumulations counted over the traced steps
(``accumulate_grad_stats.calls``), over the device time of what the
spans launched, %."""

from benchmark import densify_roofline as dr
from benchmark import roofline as rl

KERNELS = ()


def read(rec):
    span = rec.spans.get("stages", {}).get("gs.grad_stats")
    calls = rec.counters.get("train.densify.accumulate_grad_stats.calls")
    if not span or not calls or span["device_s"] <= 0.0 or not rec.units:
        return None
    work = dr.statistic(rec.units[0]["splats"])
    return 100.0 * calls * rl.bound_s(*work) / span["device_s"]
