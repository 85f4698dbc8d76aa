"""Share of the traced training sub-window in which no operation ran on
the device."""

from yardstick.readers import idle_share, traced

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "lower"


def read(run):
    return idle_share(run) if traced(run, "train") else None
