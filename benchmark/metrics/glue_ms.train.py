"""Device milliseconds per training step outside the four hand-written
kernels (the graph executor's and fused ops' aten work, cuDNN, copies),
from the profiler's trace."""

from yardstick.readers import glue_ms, traced

LAYER = "graph executor and fused ops"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "lower"


def read(run):
    return glue_ms(run) if traced(run, "train") else None
