"""The densify event (``train.densify.densify_and_prune``, ``reset_rows``
and the accumulators' reset, the ``gs.densify`` span): what the rule
needs of each event (``densify_roofline.event``, the traced event's
changed rows) times the events counted over the traced steps
(``densify_and_prune.calls``), over the device time of what the span
launched, %."""

from benchmark import densify_roofline as dr
from benchmark import roofline as rl

KERNELS = ()


def read(rec):
    span = rec.spans.get("stages", {}).get("gs.densify")
    calls = rec.counters.get("train.densify.densify_and_prune.calls")
    if not span or not calls or span["device_s"] <= 0.0 or not rec.units:
        return None
    u = rec.units[0]
    work = dr.event(u["splats"], u["changed"], u["adam_elements"] // u["splats"])
    return 100.0 * calls * rl.bound_s(*work) / span["device_s"]
