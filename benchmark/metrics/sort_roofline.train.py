"""The record sort forward (row 12) and the un-sort of the cotangents
(row 13, ``record_gather``) in the training step: 84 + 76 B a record of
the step's own ``num_records``, over their device time, %."""

from benchmark import roofline as rl

KERNELS = ("record_counts", "radix_scatter", "id_gather", "pair_gather", "record_gather")


def read(rec):
    work = []
    for u in rec.units:
        work += [rl.sort(u["records"]), rl.sort(u["records"], backward=True)]
    return rl.roofline_pct(rec, KERNELS, work)
