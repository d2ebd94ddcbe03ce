"""The tile compositor (kernel 4, ``ops.kernels.composite``): 36 B a
binned record and 16 B a pixel, over its device time, %."""

from benchmark import roofline as rl

KERNELS = ("composite_fwd",)


def read(rec):
    return rl.roofline_pct(rec, KERNELS, [rl.composite(u["binned"], u["pixels"])
                                          for u in rec.units])
