"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of the cell (run.run_cell) on the CPU at a small size, with the
cell's own limits: a sound run comes out correct, and each fault a
training cell can have does not (a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest).
The cells have no exchange between chips and no produced answers.

A fault is planted underneath the public entry the window calls, in the
network's per-step function `_step`, which StepProgram runs for each
step of a group; the program has no public hook there (PERF.md, Open
questions)."""

import time

import pytest
import torch

import run as bench
from yardstick import manifest


def _half(t):
    if isinstance(t, torch.Tensor):
        return t[: t.shape[0] // 2]
    if isinstance(t, dict):
        return {k: _half(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_half(v) for v in t)
    return t


def _step_of(net):
    assert hasattr(net, "_step"), (
        "the network has no per-step function `_step` to plant a fault in")
    return net._step


def unchanged_state(net):
    step = _step_of(net)

    def frozen(carry, *a, **kw):
        _, loss, rnn = step(carry, *a, **kw)
        return carry, loss, rnn

    net._step = frozen


def half_batch(net):
    step = _step_of(net)

    def half(carry, inputs, labels, lmasks, scalars, fmasks=None,
             rnn_carries=None):
        return step(carry, _half(inputs), _half(labels), _half(lmasks),
                    scalars, _half(fmasks), rnn_carries)

    net._step = half


def _run(cell, small, fault=None, **params):
    cfg, wl = small(manifest.config(manifest.workload(cell)["config"]),
                    manifest.workload(cell), **params)
    # a smaller step keeps the small batches out of the chaotic regime,
    # so a sound run follows the reference within the cell's own limits
    cfg["program"] = dict(cfg["program"], learning_rate=1e-3)
    hooks = {"built": fault} if fault else {}
    return bench.run_cell(wl, cfg, 2 ** 31 + 17, 0.5, 0,
                          torch.device("cpu"), time.perf_counter(), hooks)


TRAIN = dict(batch=16, pool_batches=6, steps_per_call=4)


@pytest.mark.parametrize("cell", ["resnet50-train-b128",
                                  "googlenet-train-b128"])
@pytest.mark.parametrize("fault", [None, unchanged_state, half_batch],
                         ids=["sound", "unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(cell, fault, small_cell):
    res = _run(cell, small_cell, fault, **TRAIN)
    assert res["correct"] is (fault is None), res["numbers"]


def test_losses_the_program_does_not_give_are_named_missing():
    """Where the per-step losses of a group cannot be read, the group's
    last (the public `score()`) is compared and the others are named."""
    from types import SimpleNamespace

    from yardstick import checks

    train = manifest.traffic("train")
    net = SimpleNamespace(score=lambda: 2.0)
    got = train.group_losses(SimpleNamespace(), net, 4)
    assert got == [None, None, None, 2.0]
    leaves = {("a", "W"): 1.0, ("b", "W"): 2.0}
    ref = {"losses": [1.0, 1.0, 1.0, 1.0, 1.0], "grad": leaves,
           "change": leaves, "stats": leaves}
    prog = dict(ref, losses=[1.0] + got)
    numbers, notes = checks.training_numbers(prog, ref)
    assert numbers["loss_gap"] == 1.0 and notes["losses_missing"] == 3
    prog = dict(ref, losses=[1.0, None, float("nan"), None, 1.0])
    assert checks.training_numbers(prog, ref)[0]["loss_gap"] == float("inf")
