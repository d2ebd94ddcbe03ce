"""The record sort by splat (row 12, ``ops.kernels.record_sort``): the
counts, a scatter a radix pass, the id and pair gathers; 84 B a record of
the frame's own ``num_records``, over their device time, %."""

from benchmark import roofline as rl

KERNELS = ("record_counts", "radix_scatter", "id_gather", "pair_gather")


def read(rec):
    return rl.roofline_pct(rec, KERNELS, [rl.sort(u["records"]) for u in rec.units])
