"""Mean wait of the training loop for its next staged batch: the input
pipeline's `wait_s` over its batches (TrainingMaster's harness,
`pipeline_stats()`), in the traced sub-window."""

from yardstick.readers import traced

LAYER = "input pipeline"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_img_per_s"
BETTER = "lower"


def read(run):
    t = traced(run, "train")
    pipe = t and t.get("pipeline")
    if not pipe or not pipe.get("batches"):
        return None
    return 1e3 * pipe["wait_s"] / pipe["batches"]
