"""The dgrad and wgrad kernels' share of their roofline in training
steps, as conv_fwd_roofline.train."""

from yardstick.readers import roofline, traced

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "higher"


def read(run):
    return roofline(run, "bwd") if traced(run, "train") else None
