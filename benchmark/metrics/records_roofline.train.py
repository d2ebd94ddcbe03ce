"""The prefix sum, the expansion and the segment sum (kernels 1-3,
``ops.kernels.scan`` and ``records``) in the training step: 8 B a splat,
16 B a record and 24 B a splat, 36 B a record and 40 B a splat of each
step's own records, over their device time, %."""

from benchmark import roofline as rl

KERNELS = ("scan_lookback", "expand_records", "segsum", "segsum_carries")


def read(rec):
    work = []
    for u in rec.units:
        work += [rl.prefix(u["splats"]), rl.expand(u["records"], u["splats"]),
                 rl.segsum(u["records"], u["splats"])]
    return rl.roofline_pct(rec, KERNELS, work)
