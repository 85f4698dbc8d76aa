"""The public members the port gained to match the JAX package, held
against the JAX package on the CPU at small shapes:

  - ComputationGraph.evaluate / raw_score / get_layer / n_layers /
    summary on the same weights (tests/test_helpers.py's mini-ResNet);
  - YAML across the packages, both ways, for both configuration kinds;
  - GraphBuilder's camelCase names (addInputs, addLayer, addVertex,
    setOutputs) against the snake-case calls;
  - Layer.clone on every layer class against the JAX clone;
  - Plan.covers on ResNet-50's fusion plan;
  - StepHarness.flush, AsyncDataSetIterator.join, lint_program;
  - engine/sharding.py build_zero1_group at world 1 and over a 2-rank
    gloo gang (tests/fixtures/torch/scaleout_worker.py), against k calls
    of build_zero1_step, with the gang's per-step dp and tp 2 k=4 windows
    against k=1.

Tolerances: outputs and losses of the same weights within F32_TOL (rtol
1e-4, atol 1e-5, the repo's f32 cross-package bar); evaluation counts,
layer names, parameter counts, configurations and plans exactly; the
ZeRO-1 group and the gang's k=4 windows bit for bit with their k=1 runs
(the same math in the same order).
"""

import importlib
import inspect
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import (
    ComputationGraphConfiguration as JGraphConf,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLConf,
)
from deeplearning4j_tpu.nn.helpers import fused_graph as jfused_graph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.zoo.models import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.nn.conf import (
    InputType,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.helpers import fused_graph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from deeplearning4j_tpu_torch.util.tree import leaves
from deeplearning4j_tpu_torch.zoo.models import ResNet50
from test_helpers import _data, _mini_resnet

F32_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "fixtures", "torch",
                      "scaleout_worker.py")


# ----------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def graphs():
    """The JAX mini-ResNet ("fused") after one step, its port copy on the
    CPU (configuration through JSON, weights through the bridge), and
    three seeded batches."""
    rng = np.random.default_rng(4321)
    x, y = _data(rng)
    jnet = _mini_resnet("fused")
    jnet.fit_batch(([x], [y]))
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, device="cpu").init()
    p = jax.tree_util.tree_map(np.asarray, jnet.params)
    s = jax.tree_util.tree_map(np.asarray, jnet.states)
    net.params, net.states = params_from_jax(p, s, device="cpu")
    batches = [_data(rng) for _ in range(3)]
    return jnet, net, batches


def _mlp_confs(seed=7):
    jconf = (JNNC.Builder().seed(seed).updater("adam").learning_rate(1e-2)
             .activation("tanh").weight_init("xavier").list()
             .layer(JDense(n_out=12)).layer(JOut(n_out=4, loss="mcxent"))
             .set_input_type(JInputType.feed_forward(6)).build())
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


# ------------------------------------------------- ComputationGraph
def test_graph_evaluate_counts_match_jax(graphs):
    jnet, net, batches = graphs
    jev = jnet.evaluate([([x], [y]) for x, y in batches])
    ev = net.evaluate([([x], [y]) for x, y in batches])
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.accuracy() == jev.accuracy()


def test_graph_evaluate_takes_a_dataset_and_an_evaluation(graphs):
    """A DataSet-like batch (features/labels) and an Evaluation passed
    in accumulate into that Evaluation, as JAX's does."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.eval import Evaluation

    _, net, batches = graphs
    ev = Evaluation()
    out = net.evaluate([DataSet(*batches[0])], evaluation=ev)
    assert out is ev
    assert int(ev.confusion.matrix.sum()) == len(batches[0][0])


def test_graph_raw_score_is_the_device_loss_and_matches_jax(graphs):
    jnet, net, batches = graphs
    x, y = batches[1]
    jnet2 = _mini_resnet("fused")
    port = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet2.conf.to_json()), device="cpu").init()
    p = jax.tree_util.tree_map(np.asarray, jnet2.params)
    s = jax.tree_util.tree_map(np.asarray, jnet2.states)
    port.params, port.states = params_from_jax(p, s, device="cpu")
    assert port.raw_score() is None
    jnet2.fit_batch(([x], [y]))
    port.fit_batch(([x], [y]))
    raw = port.raw_score()
    assert isinstance(raw, torch.Tensor) and raw.ndim == 0
    np.testing.assert_allclose(float(raw), float(jnet2.raw_score()),
                               **F32_TOL)
    assert float(raw) == port.score()


def test_graph_get_layer_and_n_layers_match_jax(graphs):
    jnet, net, _ = graphs
    assert net.n_layers() == jnet.n_layers()
    names = [n.name for n in jnet.topo if n.kind == "layer"]
    assert len(names) == net.n_layers()
    for name in names:
        got, want = net.get_layer(name), jnet.get_layer(name)
        assert type(got).__name__ == type(want).__name__
        assert got.to_dict() == want.to_dict()


def _summary_rows(text):
    """(name, kind, type, params) of every node row of a summary."""
    lines = text.splitlines()
    rows = []
    for ln in lines[2:-1]:
        cols = ln.split()
        rows.append((cols[0], cols[1], cols[2], cols[-1]))
    return rows, lines[-1]


def test_graph_summary_names_and_param_counts_match_jax(graphs):
    jnet, net, _ = graphs
    got, got_total = _summary_rows(net.summary())
    want, want_total = _summary_rows(jnet.summary())
    assert got == want
    assert got_total == want_total
    n = sum(int(t.numel()) for t in leaves(net.params))
    assert got_total == f"Total parameters: {n:,}"


# ------------------------------------------------------------- YAML
def _graph_confs():
    jconf = _mini_resnet("none").conf
    return jconf, ComputationGraphConfiguration.from_json(jconf.to_json())


@pytest.mark.parametrize("kind", ["graph", "mln"])
def test_yaml_crosses_the_packages_both_ways(kind):
    """JAX to_yaml read by the port's from_yaml gives JAX's to_json, and
    the port's to_yaml read by JAX's from_yaml gives the port's."""
    jconf, pconf = _graph_confs() if kind == "graph" else _mlp_confs()
    jcls = JGraphConf if kind == "graph" else JMLConf
    pcls = (ComputationGraphConfiguration if kind == "graph"
            else MultiLayerConfiguration)
    got = pcls.from_yaml(jconf.to_yaml())
    assert json.loads(got.to_json()) == json.loads(jconf.to_json())
    back = jcls.from_yaml(pconf.to_yaml())
    assert json.loads(back.to_json()) == json.loads(pconf.to_json())


def test_yaml_round_trip_in_the_port():
    _, pconf = _graph_confs()
    again = ComputationGraphConfiguration.from_yaml(pconf.to_yaml())
    assert again.to_json() == pconf.to_json()


# ---------------------------------------------------- camelCase names
def test_camel_case_graph_builder_builds_the_snake_case_configuration():
    def build(camel):
        gb = (NeuralNetConfiguration.Builder().seed(3).graph_builder())
        inputs = gb.addInputs if camel else gb.add_inputs
        layer = gb.addLayer if camel else gb.add_layer
        vertex = gb.addVertex if camel else gb.add_vertex
        outputs = gb.setOutputs if camel else gb.set_outputs
        inputs("a", "b")
        layer("da", DenseLayer(n_out=8), "a")
        layer("db", DenseLayer(n_out=8), "b")
        vertex("sum", ElementWiseVertex(op="add"), "da", "db")
        layer("out", OutputLayer(n_out=3, loss="mcxent"), "sum")
        outputs("out")
        gb.set_input_types(a=InputType.feed_forward(5),
                           b=InputType.feed_forward(5))
        return gb.build()

    assert build(True).to_json() == build(False).to_json()


# ----------------------------------------------------- Layer.clone
def _layer_classes():
    out = []
    for mod in ("base", "conv", "core", "feedforward", "norm", "rbm",
                "recurrent", "variational"):
        jm = importlib.import_module(f"deeplearning4j_tpu.nn.layers.{mod}")
        for name, cls in vars(jm).items():
            if (inspect.isclass(cls) and cls.__module__ == jm.__name__
                    and hasattr(cls, "clone")):
                out.append((mod, name))
    return out


LAYER_CLASSES = _layer_classes()


def test_every_layer_class_is_listed():
    """The JAX layer classes with `clone`: Layer, BaseLayer and 23 more."""
    assert len(LAYER_CLASSES) == 25


@pytest.mark.parametrize("mod,name", LAYER_CLASSES,
                         ids=[n for _, n in LAYER_CLASSES])
def test_layer_clone_matches_jax(mod, name):
    jcls = getattr(importlib.import_module(
        f"deeplearning4j_tpu.nn.layers.{mod}"), name)
    pcls = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.nn.layers.{mod}"), name)
    layer = pcls()
    copy = layer.clone(name="copy", frozen=True)
    assert type(copy) is pcls and copy is not layer
    assert (copy.name, copy.frozen) == ("copy", True)
    assert (layer.name, layer.frozen) == (None, False)
    assert copy.to_dict() == jcls().clone(name="copy", frozen=True).to_dict()
    assert layer.clone() == layer
    with pytest.raises(TypeError):
        layer.clone(no_such_field=1)


# ------------------------------------------------------ Plan.covers
def test_plan_covers_resnet50_like_jax():
    conf = ResNet50(input_shape=(64, 64, 3), num_classes=10).conf()
    jconf = JResNet50(input_shape=(64, 64, 3), num_classes=10).conf()
    plan = fused_graph.build_plan(conf.topological_order(),
                                  conf.network_outputs, impl="pallas")
    jplan = jfused_graph.build_plan(jconf.topological_order(),
                                    jconf.network_outputs, impl="pallas")
    assert plan.covers() == jplan.covers() > 0
    assert plan.covers() == (len(plan.conv) + len(plan.bn)
                             + len(plan.vact) + len(plan.vadd))
    assert (set(plan.conv), set(plan.bn), set(plan.vact), set(plan.vadd)) \
        == (set(jplan.conv), set(jplan.bn), set(jplan.vact),
            set(jplan.vadd))


# ------------------------------------ StepHarness.flush, iterator join
def test_step_harness_flush_publishes_the_pending_counts():
    from deeplearning4j_tpu_torch.engine import StepHarness
    from deeplearning4j_tpu_torch.observability import metrics

    _, conf = _mlp_confs()
    net = MultiLayerNetwork(conf, device="cpu").init()
    acc = metrics.StepAccumulator(flush_every=1000)
    h = StepHarness(net, accumulator=acc)
    reg = metrics.get_registry()
    before = reg.counter_value("dl4j_train_steps_total") or 0.0
    acc.count_observe("dl4j_train_steps_total", "dl4j_train_step_seconds",
                      0.01, n=3)
    assert (reg.counter_value("dl4j_train_steps_total") or 0.0) == before
    h.flush()
    assert reg.counter_value("dl4j_train_steps_total") == before + 3
    h.flush()   # nothing pending: publishes nothing more
    assert reg.counter_value("dl4j_train_steps_total") == before + 3


def test_async_iterator_join_stops_the_producer_and_restarts():
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator,
    )

    items = list(range(20))
    it = AsyncDataSetIterator(items, queue_size=2)
    first = iter(it)
    assert [next(first) for _ in range(3)] == [0, 1, 2]
    it.join(timeout_s=5.0)
    assert it._thread is None
    assert list(it) == items      # a later pass starts a fresh producer
    it.join()


# ---------------------------------------------------- lint_program
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_lint_program_records_a_clean_step(kind, graphs):
    from deeplearning4j_tpu_torch.analysis import program_lint

    if kind == "mln":
        _, conf = _mlp_confs()
        net = MultiLayerNetwork(conf, device="cpu").init()
        rng = np.random.default_rng(2)
        x = rng.normal(size=(8, 6)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
        rec = net.lint_program(x, y)
    else:
        _, net, batches = graphs
        x, y = batches[0]
        rec = net.lint_program([x], [y])
    before = [t.clone() for t in leaves(net._params_view())]
    finds, (rep,) = program_lint.run_with_reports([rec])
    assert not finds, [f.render() for f in finds]
    assert rep["ops"] > 0
    for a, b in zip(before, leaves(net._params_view())):
        assert torch.equal(a, b)      # linting leaves the net as it was
    with pytest.raises(ValueError):
        net.lint_program(x, y, carries=[None])


# ------------------------------------------- build_zero1_group
def _zero1_net():
    _, conf = _mlp_confs()
    return MultiLayerNetwork(conf, device="cpu").init()


def test_build_zero1_group_at_world_one_equals_k_zero1_steps():
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.engine.mesh import MeshManager
    from deeplearning4j_tpu_torch.engine.sharding import (
        build_zero1_group,
        build_zero1_step,
    )

    rng = np.random.default_rng(8)
    xs = rng.normal(size=(8, 10, 6)).astype(np.float32)
    ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (8, 10))]
    runs = {}
    for how in ("step", "group"):
        net = _zero1_net()
        mgr = MeshManager()
        StepProgram(net).attach_mesh(mgr)
        x, y, _, _ = net._batch_tensors(xs, ys)
        carry = net._train_carry()
        scalars = net._step_scalars(0, 8)
        if how == "step":
            step, losses = build_zero1_step(net, mgr), []
            for i in range(8):
                carry, loss, _ = step(carry, x[i], y[i], None, scalars[i])
                losses.append(loss)
            losses = torch.stack(losses)
        else:
            group = build_zero1_group(net, mgr, 4, trace_key="zero1_k4")
            assert net._jit_cache.trace_counts() == {"zero1_k4": 1}
            parts = []
            for lo in (0, 4):
                carry, ls = group(carry, x[lo:lo + 4], y[lo:lo + 4], None,
                                  scalars[lo:lo + 4])
                assert ls.shape == (4,)
                parts.append(ls)
            losses = torch.cat(parts)
        runs[how] = (leaves(carry), losses)
    for a, b in zip(runs["group"][0], runs["step"][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs["group"][1], runs["step"][1])


def test_run_group_under_a_mesh_runs_build_zero1_group():
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.engine.mesh import MeshManager

    rng = np.random.default_rng(9)
    xs = rng.normal(size=(4, 10, 6)).astype(np.float32)
    ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 10))]
    a, b, c = _zero1_net(), _zero1_net(), _zero1_net()
    pa = StepProgram(a).attach_mesh(MeshManager())
    pb = StepProgram(b).attach_mesh(MeshManager())
    pa.run_group(xs, ys)
    for i in range(4):
        pb.run(xs[i], ys[i])
    # the mesh is the net's: a second program groups through ZeRO-1 too
    StepProgram(c).attach_mesh(MeshManager())
    other = StepProgram(c)
    assert other.mesh_manager is not None
    other.run_group(xs, ys)
    for net in (a, c):
        for x, y in zip(leaves(net.params) + leaves(net.updater_states),
                        leaves(b.params) + leaves(b.updater_states)):
            assert torch.equal(x, y)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """A 2-rank gloo gang on the CPU running the worker's zero1_group,
    dp_groups and tp_groups scenarios over port-initialized nets."""
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization,
        ConvolutionLayer,
        SubsamplingLayer,
    )

    io = str(tmp_path_factory.mktemp("zero1_group"))
    confs = {
        "conv": (NeuralNetConfiguration.Builder().seed(3).updater("sgd")
                 .learning_rate(0.05).weight_init("xavier").list()
                 .layer(ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                         activation="relu"))
                 .layer(BatchNormalization())
                 .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                 .layer(OutputLayer(n_out=3, loss="mcxent"))
                 .set_input_type(InputType.convolutional(8, 8, 1)).build()),
        "adam24": (NeuralNetConfiguration.Builder().seed(7).updater("adam")
                   .learning_rate(1e-2).activation("tanh")
                   .weight_init("xavier").list()
                   .layer(DenseLayer(n_out=24))
                   .layer(OutputLayer(n_out=24, loss="mcxent"))
                   .set_input_type(InputType.feed_forward(24)).build())}
    spec, arrays = {"nets": {}, "helpers": {}}, {}
    for name, conf in confs.items():
        net = MultiLayerNetwork(conf, device="cpu").init()
        spec["nets"][name] = ["mln", conf.to_json()]
        for prefix, tree in (("p", net.params), ("s", net.states)):
            for i, t in enumerate(leaves(tree)):
                arrays[f"{name}/{prefix}:{i}"] = t.numpy()
    rng = np.random.default_rng(23)
    x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    x[8:] = x[8:] * 3 + 1
    data = {"conv_x": x,
            "conv_y": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)],
            "z_x": rng.normal(size=(8, 16, 24)).astype(np.float32),
            "z_y": np.eye(24, dtype=np.float32)[
                rng.integers(0, 24, (8, 16))]}
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(io, "nets.npz"), **arrays)
    np.savez(os.path.join(io, "data.npz"), **data)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--rank", str(r), "--world", "2", "--port",
         str(port), "--io", io, "--only", "zero1_group,dp_groups,tp_groups"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = [dict(np.load(os.path.join(io, f"out-{r}.npz"))) for r in range(2)]
    facts = []
    for r in range(2):
        with open(os.path.join(io, f"out-{r}.json")) as f:
            facts.append(json.load(f))
    return out, facts


def _pair(arrays, a, b):
    keys = [k for k in arrays if k.startswith(a + "/")]
    assert keys, a
    for k in keys:
        np.testing.assert_array_equal(arrays[k], arrays[b + k[len(a):]])


@pytest.mark.parametrize("scen", ["zg_group", "zg_other"])
def test_build_zero1_group_over_two_gloo_ranks_equals_k_steps(gang, scen):
    """build_zero1_group by hand ("zg_group"), and run_group through a
    second StepProgram of a net meshed by another ("zg_other"), equal
    8 calls of build_zero1_step on both ranks."""
    out, facts = gang
    assert all(f["_failed"] == {} for f in facts)
    for r in range(2):
        _pair(out[r], scen, "zg_step")
    for k in out[0]:
        if k.startswith(("zg_group/params", "zg_group/upd")):
            np.testing.assert_array_equal(out[0][k], out[1][k])


@pytest.mark.parametrize("k4,k1", [("dp_k4", "dp_k1"), ("tp_k4", "tp_k1")])
def test_gang_k4_windows_equal_k1_on_the_cpu(gang, k4, k1):
    """The k=4 windows the NCCL drill captures on the card: on the CPU the
    group body runs directly, bit for bit the k=1 steps, and the eager
    collective after them sums the two ranks."""
    out, facts = gang
    _pair(out[0], k4, k1)
    assert facts[0][k4]["eager_after"] == 3.0
    assert facts[0][k4]["iteration"] == 8
