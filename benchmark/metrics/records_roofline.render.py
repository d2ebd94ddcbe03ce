"""The prefix sum and the expansion (kernels 1, 2, ``ops.kernels.scan``
and ``records``) in the frame: 8 B a splat, and 16 B a record of the
frame's own ``num_records`` and 24 B a splat, over their device time, %.
Read by the kernels' names: a replayed frame runs no stage's Python, so
it holds no ``gs.scan`` or ``gs.expand`` span to read them from."""

from benchmark import roofline as rl

KERNELS = ("scan_lookback", "expand_records")


def read(rec):
    work = []
    for u in rec.units:
        work += [rl.prefix(u["splats"]), rl.expand(u["records"], u["splats"])]
    return rl.roofline_pct(rec, KERNELS, work)
