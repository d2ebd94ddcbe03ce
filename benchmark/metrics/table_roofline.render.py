"""The splat table forward (kernel 10, ``ops.kernels.table``): its bound
over its device time in the traced window, %."""

from benchmark import roofline as rl

KERNELS = ("splat_table_fwd",)


def read(rec):
    return rl.roofline_pct(rec, KERNELS, [rl.table(u["splats"], u["sh_degree"])
                                          for u in rec.units])
