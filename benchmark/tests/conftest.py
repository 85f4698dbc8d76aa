"""Put the benchmark's folder and the checkout on sys.path, as run.py
does, and give tests a small CPU-sized copy of a cell."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small(cfg: dict, wl: dict, hw: int = 64, classes: int = 10,
          **params) -> tuple:
    """A cell's configuration and workload at a CPU test's size: the
    published widths at `hw` x `hw` images and `classes` classes, float32
    compute, and the workload's parameters overridden by `params`."""
    cfg = dict(cfg, input_shape=[hw, hw, 3], num_classes=classes)
    cfg["program"] = dict(cfg["program"], compute_dtype=None)
    wl = dict(wl, params=dict(wl["params"], **params))
    return cfg, wl


@pytest.fixture
def small_cell():
    return small
