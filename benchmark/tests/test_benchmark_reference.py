"""The plain reference and the weight mapping, against the program on
the CPU: the same benchmark-made weights given to the program's zoo
network (float32, device "cpu", the kernels' plain versions) and to
reference/, which imports nothing of the program."""

import time

import pytest
import torch

import run as bench
from reference import net as refnet
from yardstick import manifest, program, weights

CELLS = {"resnet50": "resnet50-train-b128",
         "googlenet": "googlenet-train-b128"}


def _setup(name, small, hw=64, helpers="pallas"):
    cfg, wl = small(manifest.config(name), manifest.workload(CELLS[name]),
                    hw=hw, batch=8)
    cfg["program"] = dict(cfg["program"], helpers=helpers)
    ref = manifest.reference(cfg["reference"])
    nodes = ref.build(cfg)
    params, states = weights.make(nodes, 12345, torch.device("cpu"),
                                  ref.small_gamma)
    net = program.build(cfg, torch.device("cpu"))
    program.load(net, params, states)
    return cfg, wl, nodes, params, states, net


@pytest.mark.parametrize("name", ["resnet50", "googlenet"])
@pytest.mark.parametrize("helpers", ["pallas", "none"])
def test_forward_agrees(name, helpers, small_cell):
    cfg, _, nodes, params, states, net = _setup(name, small_cell,
                                                helpers=helpers)
    gen = torch.Generator().manual_seed(3)
    x = weights.images(gen, 4, cfg["input_shape"], torch.device("cpu"))
    got = net.output(x.numpy()).float()
    want = refnet.predict(nodes, params, states, x).exp()
    assert got.shape == want.shape == (4, cfg["num_classes"])
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["resnet50", "googlenet"])
def test_first_training_step_agrees(name, small_cell):
    """Loss and every leaf's gradient of one TrainingMaster step."""
    from deeplearning4j_tpu_torch.parallel.training_master import (
        TrainingMaster,
    )

    cfg, wl, nodes, params, states, net = _setup(name, small_cell)
    ctx = bench.context(wl, cfg, 12345, 0, 0, torch.device("cpu"),
                        time.perf_counter())
    train = manifest.traffic("train")
    pool = train.make_pool(ctx, 8, 2)
    tm = TrainingMaster(net, steps_per_dispatch=4)
    tm.fit(lambda s: pool[s], 1, start_step=0)
    lr = cfg["program"]["learning_rate"]
    grad = program.leaf_norms({k: v["v"] for k, v in
                               net.updater_states.items()
                               if isinstance(v, dict) and "v" in v},
                              scale=1.0 / lr)
    ref = train.reference_steps(ctx, pool[:1])
    assert net.score() == pytest.approx(ref["losses"][0], rel=1e-5)
    assert set(grad) == set(ref["grad"])
    # float32 gradients at this small size are ill-conditioned on a few
    # BatchNorm leaves: against a float64 reference, the program reads up
    # to 0.16% and this float32 reference up to 0.39% (GoogLeNet, 64x64,
    # 8 rows); a mapping fault reads of order 1
    big = max(ref["grad"].values())
    for key, g in ref["grad"].items():
        assert grad[key] == pytest.approx(g, rel=1e-2, abs=1e-4 * big), key


def test_same_program_leaves_as_reference():
    for name in CELLS:
        cfg = manifest.config(name)
        nodes = manifest.reference(cfg["reference"]).build(cfg)
        made = refnet.param_shapes(nodes)
        net = program.build(dict(cfg, input_shape=[32, 32, 3]),
                            torch.device("cpu"))
        trained = {k: {j: tuple(t.shape) for j, t in v.items()}
                   for k, v in net.params.items() if v}
        ref32 = refnet.param_shapes(manifest.reference(cfg["reference"])
                                    .build(dict(cfg, input_shape=[32, 32, 3])))
        assert trained == ref32
        assert set(made) == set(ref32)
