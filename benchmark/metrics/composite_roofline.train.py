"""The tile compositor and its backward (kernels 4, 5) in the training
step: 36 + 72 B a binned record and 16 + 32 B a pixel, over their device
time, %."""

from benchmark import roofline as rl

KERNELS = ("composite_fwd", "composite_bwd")


def read(rec):
    work = []
    for u in rec.units:
        work += [rl.composite(u["binned"], u["pixels"]),
                 rl.composite(u["binned"], u["pixels"], backward=True)]
    return rl.roofline_pct(rec, KERNELS, work)
