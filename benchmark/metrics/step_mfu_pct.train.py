"""The whole training step's share of the card's peak: the sum over
every stage of the step (``roofline.step_stages``: the frame, the loss,
the frame's backward, Adam) of the larger of operations over the float32
peak and bytes over the memory peak, over the traced window's time, %."""

from benchmark import roofline as rl

KERNELS = ()


def read(rec):
    return rl.mfu_pct(rec, rl.step_stages)
