"""On the card: the control (the float32 reference's arithmetic with
float8 operands, put in the program's place) fails at least one of the
cell's limits, at a size a test run holds (the cell's widths and image
size, fewer rows). The full-size readings come from control.py (README).

    python -m pytest benchmark/tests -m cuda
"""

import time

import pytest

import control
import run as bench
from reference import net as refnet
from yardstick import checks, manifest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resnet50-train-b128",
                                  "googlenet-train-b128"])
def test_control_fails_a_limit(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = manifest.workload(cell)
    cfg = manifest.config(wl["config"])
    wl = dict(wl, params=dict(wl["params"], batch=32))
    for seed in (101, 102, 103):
        ctx = bench.context(wl, cfg, seed, 0, 0, torch.device("cuda", 0),
                            time.perf_counter())
        numbers = control.control_training(ctx, quant=refnet.fp8)
        numbers.pop("notes")
        assert not checks.judge(numbers, wl["limits"]), numbers
