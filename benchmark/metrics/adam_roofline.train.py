"""Adam over every raw tensor (row 14, ``ops.kernels.adam``): 28 B an
element, over its device time, %."""

from benchmark import roofline as rl

KERNELS = ("adam_step",)


def read(rec):
    return rl.roofline_pct(rec, KERNELS, [rl.adam(u["adam_elements"]) for u in rec.units])
