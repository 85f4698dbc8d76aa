"""The whole training step's share of the chip's bf16 peak: images x 3
x 2 x forward multiply-adds (from the configuration's layer shapes) over
the timed window, against 989 TFLOP/s."""

from yardstick.readers import mfu

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_img_per_s"
BETTER = "higher"


def read(run):
    return mfu(run) if run.get("kind") == "train" else None
