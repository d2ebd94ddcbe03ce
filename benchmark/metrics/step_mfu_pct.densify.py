"""The whole adaptive step's share of the card's peak: the training step's
stages (``roofline.step_stages`` of each traced step), the statistic of
each call of ``accumulate_grad_stats`` and the densify event of each call
of ``densify_and_prune`` (``densify_roofline``; both counted by the port's
counters over the traced steps), each at the larger of operations over the
float32 peak and bytes over the memory peak, over the traced window's
time, %."""

from benchmark import densify_roofline as dr
from benchmark import roofline as rl

KERNELS = ()


def read(rec):
    stats = rec.counters.get("train.densify.accumulate_grad_stats.calls")
    if not stats or not rec.units or rec.window_s <= 0.0:
        return None
    u = rec.units[0]
    events = rec.counters.get("train.densify.densify_and_prune.calls", 0)
    total = sum(rl.bound_sum_s(rl.step_stages(s)) for s in rec.units)
    total += stats * rl.bound_s(*dr.statistic(u["splats"]))
    total += events * rl.bound_s(*dr.event(u["splats"], u["changed"],
                                           u["adam_elements"] // u["splats"]))
    return 100.0 * total / rec.window_s
