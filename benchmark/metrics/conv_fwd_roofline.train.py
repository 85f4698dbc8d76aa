"""The forward hand-written kernels' share of their roofline in training
steps: the summed bound of their calls (flops.py, from the
configuration's shapes) over their summed device time."""

from yardstick.readers import roofline, traced

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "higher"


def read(run):
    return roofline(run, "fwd") if traced(run, "train") else None
