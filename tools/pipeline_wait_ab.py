"""Per-batch waits of the input pipeline of one source tree, on one card.

    python tools/pipeline_wait_ab.py TREE

TREE is the root of a checkout (e.g. `git archive <commit> | tar -x -C
TREE`); its deeplearning4j_tpu_torch is imported. An IteratorPipeline
(depth 2, staging on CUDA) runs over a ListDataSetIterator of four
ResNet-50 batches of 128 (224x224x3 f32, 77 MB each) for three epochs in
the fit loops' pattern (reset, then iterate), with a 100 ms sleep
standing in for each train step and 50 ms for each epoch's scoring.
Prints one JSON line: the ms each epoch's `iter()` took (the device
stage fills its buffer there), the ms each `next()` waited, and their
mean. Compare two trees in one call, in turns: parent, change, change,
parent. Needs a CUDA card.
"""
import json
import sys
import time

sys.path.insert(0, sys.argv[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deeplearning4j_tpu_torch.datasets import (  # noqa: E402
    DataSet,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.engine import IteratorPipeline  # noqa: E402

BATCHES, BATCH, EPOCHS = 4, 128, 3
STEP_S, SCORE_S = 0.1, 0.05


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    rng = np.random.default_rng(45)
    n = BATCHES * BATCH
    x = rng.normal(size=(n, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]
    torch.zeros(1, device="cuda")
    pipe = IteratorPipeline(ListDataSetIterator(DataSet(x, y),
                                                batch_size=BATCH),
                            depth=2, device="cuda")
    waits, iters = [], []
    for _ in range(EPOCHS):
        pipe.reset()
        t0 = time.perf_counter()
        it = iter(pipe)
        iters.append(round((time.perf_counter() - t0) * 1e3, 3))
        while True:
            t0 = time.perf_counter()
            try:
                next(it)
            except StopIteration:
                break
            waits.append(round((time.perf_counter() - t0) * 1e3, 3))
            time.sleep(STEP_S)
            torch.cuda.synchronize()
        time.sleep(SCORE_S)
    pipe.close()
    print(json.dumps({"tree": sys.argv[1], "iter_ms": iters,
                      "waits_ms": waits,
                      "mean_wait_ms": sum(waits) / len(waits)}))


if __name__ == "__main__":
    main()
