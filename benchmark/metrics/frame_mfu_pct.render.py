"""The whole frame's share of the card's peak: the sum over every stage
of the frame (``roofline.frame_stages``) of the larger of operations over
the float32 peak and bytes over the memory peak, over the traced
window's time, %. It bounds what a fused or removed kernel can gain."""

from benchmark import roofline as rl

KERNELS = ()


def read(rec):
    return rl.mfu_pct(rec, rl.frame_stages)
