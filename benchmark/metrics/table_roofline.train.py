"""The splat table forward and backward (kernels 10, 11,
``ops.kernels.table``) in the training step: their bound over their
device time in the traced window, %."""

from benchmark import roofline as rl

KERNELS = ("splat_table_fwd", "splat_table_bwd")


def read(rec):
    work = []
    for u in rec.units:
        work += [rl.table(u["splats"], u["sh_degree"]),
                 rl.table(u["splats"], u["sh_degree"], backward=True)]
    return rl.roofline_pct(rec, KERNELS, work)
