"""The L1 + D-SSIM loss forward and backward (rows 15, 16,
``ops.kernels.ssim_loss``): what the loss needs (prediction and target
read, the gradient written, the window sums' operations), not the
kernels' own float32 partials, over their device time, %."""

from benchmark import roofline as rl

KERNELS = ("gs_loss_fwd", "gs_loss_sum", "gs_loss_bwd")


def read(rec):
    work = []
    for u in rec.units:
        work += [rl.loss(u["image_pixels"]), rl.loss(u["image_pixels"], backward=True)]
    return rl.roofline_pct(rec, KERNELS, work)
