"""Train-mode dropout in the port (nn/layers/base.py, nn/base_network.py)
on the CPU.

torch cannot reproduce `jax.random.bernoulli`'s bits, so the masks are
pinned within the port: one generator seed gives one set of masks, the
layers draw in a fixed order, `StepProgram.run_group(k)` equals k `run`
calls bit for bit (the generator's state after included), and a guard's
skip rewinds the generator with the rest of the state. The apply step is
held against JAX's `jnp.where(mask, x / keep, 0)` on one shared mask,
exactly (one division and a select, the divisor rounded to the input's
dtype as JAX rounds it). The keep fraction is held to a binomial bound:
six standard deviations, sqrt(keep (1 - keep) / n)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer,
    DropoutLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import apply_dropout, dropout_mask
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import NonFiniteGuard
from deeplearning4j_tpu_torch.util.tree import leaves
from deeplearning4j_tpu_torch.zoo import SimpleCNN


def _mlp(seed=3, updater="adam", p=(0.5, 0.25, 0.2)):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(updater)
            .learning_rate(1e-2).activation("tanh").list()
            .layer(DenseLayer(n_out=16, dropout=p[0]))
            .layer(DropoutLayer(dropout=p[1]))
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=3, loss="mcxent", dropout=p[2]))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _batches(n, seed=0, rows=6):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 8)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _state(net):
    return (leaves(net.params) + leaves(net.updater_states)
            + leaves(net.states))


def _assert_bitwise(a, b):
    sa, sb = _state(a), _state(b)
    assert len(sa) == len(sb)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    assert a.iteration == b.iteration
    assert torch.equal(a._rng_state(), b._rng_state())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.5, 0.3])
def test_apply_step_equals_jax_on_one_mask(rng, dtype, p):
    x = rng.normal(size=(5, 7)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    mask = dropout_mask(tx, p, torch.Generator().manual_seed(1))
    assert mask.dtype == torch.bool and mask.shape == tx.shape
    keep = 1.0 - p
    ref = jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(x, dtype) / keep,
                    0.0)
    got = apply_dropout(tx, mask, p)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_same_seed_same_bits_and_another_seed_differs():
    data = _batches(3, seed=1)
    a, b, c = _mlp(), _mlp(), _mlp()
    c._drop_gen.manual_seed(99)
    for x, y in data:
        for net in (a, b, c):
            net.fit_batch((x, y))
    _assert_bitwise(a, b)
    assert not all(torch.equal(p, q) for p, q in zip(leaves(a.params),
                                                     leaves(c.params)))


def test_masks_are_drawn_once_per_layer_in_layer_order():
    """The train loss equals a hand-written forward whose masks come
    from a copy of the generator, drawn in layer order, the output
    layer's input last."""
    net = _mlp(updater="sgd")
    (x, y), = _batches(1, seed=2)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(net._rng_state())
    p = net.params

    def drop(h, rate):
        return apply_dropout(h, dropout_mask(h, rate, gen), rate)

    h = torch.tanh(drop(x, 0.5) @ p[0]["W"] + p[0]["b"])
    h = drop(h, 0.25)
    h = torch.tanh(h @ p[2]["W"] + p[2]["b"])
    per_ex = net.conf.layers[3].per_example_loss_from_input(
        p[3], drop(h, 0.2), y)
    loss, _ = net._loss_fn(p, net.states, x, y, train=True,
                           rng=net._train_rng())
    assert torch.equal(loss, per_ex.mean())
    assert torch.equal(net._rng_state(), gen.get_state())


def test_identity_at_inference_and_in_eval_score():
    net = _mlp()
    (x, y), = _batches(1, seed=3)
    before = net._rng_state()
    off = _mlp(p=(0.0, 0.0, 0.0))
    off.params = net.params
    assert torch.equal(net.output(x), off.output(x))
    assert net.score((x, y)) == off.score((x, y))
    assert torch.equal(net._rng_state(), before)   # nothing drawn


@pytest.mark.parametrize("p", [0.5, 0.1])
def test_keep_fraction_within_a_binomial_bound(p):
    n = 1 << 20
    mask = dropout_mask(torch.empty(n), p, torch.Generator().manual_seed(4))
    keep = 1.0 - p
    frac = mask.float().mean().item()
    assert abs(frac - keep) <= 6 * math.sqrt(keep * (1 - keep) / n)


def test_run_group_equals_k_runs_bitwise_with_dropout():
    data = _batches(4, seed=5)
    a, b = _mlp(), _mlp()
    pa, pb = StepProgram(a), StepProgram(b)
    losses = [pa.run(x, y) for x, y in data]
    pb.run_group(np.stack([d[0] for d in data]),
                 np.stack([d[1] for d in data]))
    _assert_bitwise(a, b)
    assert torch.equal(torch.stack(losses), pb.last_step_losses)


def test_consecutive_steps_draw_different_masks():
    net = _mlp()
    (x, _), = _batches(1, seed=6)
    tx = torch.from_numpy(x)
    gen = net._train_rng()
    m1 = dropout_mask(tx, 0.5, gen)
    m2 = dropout_mask(tx, 0.5, gen)
    assert not torch.equal(m1, m2)


def test_zoo_simplecnn_group_with_dropout_equals_runs():
    """The zoo's SimpleCNN keeps its dropout (convs 5-6 and the dense
    layer): run_group(3) against three run() calls, bit for bit."""
    mk = lambda: SimpleCNN(input_shape=(8, 8, 3), learning_rate=1e-3,
                           num_classes=4).init_model(device="cpu")
    a, b = mk(), mk()
    assert a._has_dropout()
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(3, 4, 8, 8, 3)).astype(np.float32)
    ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 4))]
    pa = StepProgram(a)
    for x, y in zip(xs, ys):
        pa.run(x, y)
    StepProgram(b).run_group(xs, ys)
    _assert_bitwise(a, b)


def test_graph_dropout_group_equals_runs():
    """The generator is the shared contract's: a ComputationGraph with
    dropout trains and groups the same way."""
    def graph():
        conf = (NeuralNetConfiguration.Builder().seed(8).updater("nesterovs")
                .learning_rate(1e-2).activation("relu").graph_builder()
                .add_inputs("x")
                .add_layer("d", DenseLayer(n_out=12, dropout=0.5), "x")
                .add_layer("out", OutputLayer(n_out=3, dropout=0.3), "d")
                .set_outputs("out")
                .set_input_types(x=InputType.feed_forward(8)).build())
        return ComputationGraph(conf, device="cpu").init()

    data = _batches(3, seed=9)
    a, b = graph(), graph()
    pa = StepProgram(a)
    for x, y in data:
        pa.run(x, y)
    StepProgram(b).run_group(np.stack([d[0] for d in data]),
                             np.stack([d[1] for d in data]))
    _assert_bitwise(a, b)


@pytest.mark.parametrize("pipeline", [True, False])
def test_guard_skip_rewinds_the_generator(pipeline):
    """skip_step over a NaN batch, dropout on: the run ends bit for bit
    where a run over the clean batches ends (the generator included), so
    the skipped step's draws leave no trace in later masks."""
    data = _batches(4, seed=10, rows=4)
    x = np.concatenate([d[0] for d in data])
    y = np.concatenate([d[1] for d in data])
    bad = x.copy()
    bad[8:12] = np.nan

    def fit(xx, yy, guard=None):
        net = _mlp(updater="nesterovs")
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
            model_saver=InMemoryModelSaver(),
            score_calculator=DataSetLossCalculator(_batches(1, seed=11)))
        res = EarlyStoppingTrainer(
            cfg, net, ListDataSetIterator(DataSet(xx, yy), batch_size=4),
            guard=guard, pipeline=pipeline).fit()
        return net, res

    guard = NonFiniteGuard("skip_step", check_every=1)
    net, res = fit(bad, y, guard)
    keep = np.r_[0:8, 12:16]
    ref, ref_res = fit(x[keep], y[keep])
    assert guard.counters["skipped_steps"] == 2
    assert res.score_vs_epoch == ref_res.score_vs_epoch
    _assert_bitwise(net, ref)
