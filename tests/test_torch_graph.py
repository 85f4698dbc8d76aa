"""The port's ComputationGraph inference path against the JAX package:
the `_mini_resnet` graph of tests/test_helpers.py carried over through
`to_json()` and the weight bridge, in every helper mode, in f32 and under
the bf16 policy; the ResNet-50 configuration; the model-zip bridge."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.util.model_serializer import write_model
from deeplearning4j_tpu.zoo.models import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.helpers.fused_ops import kernel_route
from deeplearning4j_tpu_torch.util.model_serializer import (
    _flatten,
    params_from_jax,
    restore_computation_graph,
)
from deeplearning4j_tpu_torch.zoo.models import ResNet50
from test_helpers import _data, _mini_resnet

MODES = ("none", "fused", "pallas")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 policy: the packages round at different places inside each op
# (XLA may keep f32 intermediates inside a fusion, eager torch rounds
# every op to bf16) — the repo's bf16 tolerance note (rtol 2e-2) with an
# absolute floor for near-zero softmax probabilities
BF16_TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def trained_jax_nets():
    """One JAX mini-ResNet per helper mode, fitted one step so BN running
    statistics are not trivial (identical weights: same seed, same data)."""
    rng = np.random.default_rng(12345)
    x, y = _data(rng)
    nets = {}
    for m in MODES:
        net = _mini_resnet(m)
        net.fit_batch(([x], [y]))
        nets[m] = net
    return nets, x


def _port_of(jnet, compute_dtype=None):
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, compute_dtype=compute_dtype, device="cpu")
    p = jax.tree_util.tree_map(np.asarray, jnet.params)
    s = jax.tree_util.tree_map(np.asarray, jnet.states)
    net.params, net.states = params_from_jax(p, s, device="cpu")
    return net


@pytest.mark.parametrize("mode", MODES)
def test_mini_resnet_output_matches_jax_f32(trained_jax_nets, mode):
    nets, x = trained_jax_nets
    jnet = nets[mode]
    net = _port_of(jnet)
    assert net.conf.helper_mode == mode
    got = net.output(x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(x)),
                               **F32_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_mini_resnet_output_matches_jax_bf16_policy(trained_jax_nets, mode):
    nets, x = trained_jax_nets
    jnet = nets[mode]
    jb = JGraph(jnet.conf, compute_dtype=jnp.bfloat16)
    jb.params, jb.states = jnet.params, jnet.states
    net = _port_of(jnet, compute_dtype=torch.bfloat16)
    got = net.output(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.output(x)),
                               **BF16_TOL)


def test_fused_modes_match_port_default_executor(trained_jax_nets):
    """Within the port: the fused executor (torch convs and the kernels'
    plain versions) equals the per-layer executor."""
    nets, x = trained_jax_nets
    outs = {m: _port_of(nets["none"]) for m in MODES}
    for m, net in outs.items():
        net.conf.helper_mode = m
    ref = outs["none"].output(x)
    for m in ("fused", "pallas"):
        torch.testing.assert_close(outs[m].output(x), ref, **F32_TOL)


def test_feed_forward_materializes_all(trained_jax_nets):
    nets, x = trained_jax_nets
    fused = _port_of(nets["fused"]).feed_forward(x)
    plain = _port_of(nets["none"]).feed_forward(x)
    assert set(plain) <= set(fused)
    torch.testing.assert_close(fused["b1_out"], plain["b1_out"], **F32_TOL)


def test_plan_matches_jax_plan(trained_jax_nets):
    nets, _ = trained_jax_nets
    jplan = nets["pallas"]._helper_plan()
    plan = _port_of(nets["pallas"])._helper_plan()
    assert plan.impl == jplan.impl == "pallas"
    assert set(plan.conv) == set(jplan.conv)
    for name, spec in plan.conv.items():
        js = jplan.conv[name]
        assert (spec.stride, spec.padding, spec.bn_name) == \
            (tuple(js.stride), js.padding, js.bn_name)
    assert plan.bn == jplan.bn and plan.vact == jplan.vact
    assert plan.vadd == jplan.vadd


def test_config_json_round_trips_across_packages(trained_jax_nets):
    nets, _ = trained_jax_nets
    jconf = nets["fused"].conf
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    from deeplearning4j_tpu.nn.conf.graph_conf import (
        ComputationGraphConfiguration as JConf,
    )
    back = JConf.from_json(conf.to_json())
    assert back.helper_mode == "fused"
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())


def test_resnet50_conf_and_param_shapes_match_jax():
    kw = dict(compute_dtype="bfloat16", helpers="pallas")
    jconf = JResNet50(**kw).conf()
    conf = ResNet50(**kw).conf()
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    jtypes, jin = jconf.resolve_shapes(return_layer_inputs=True)
    _, tin = conf.resolve_shapes(return_layer_inputs=True)
    assert set(jin) == set(tin)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    jnodes = {n.name: n for n in jconf.nodes}
    n_params = 0
    for node in conf.nodes:
        if node.kind != "layer":
            continue
        js = jax.eval_shape(
            lambda k: jnodes[node.name].obj.init_params(k, jin[node.name]),
            key)
        ts = {k: tuple(v.shape) for k, v in
              node.obj.init_params(gen, tin[node.name]).items()}
        assert ts == {k: tuple(v.shape) for k, v in js.items()}, node.name
        n_params += sum(int(np.prod(s)) for s in ts.values())
    assert n_params == 25_583_592   # ResNet-50 with BN gamma/beta, 1000 cls


def test_resnet50_kernel_dispatch_counts():
    """helpers="pallas" routes 30 convs to the 1x1 kernel, 16 to the 3x3
    kernel and leaves 7 (stem, stride-2 a/sc) to torch convolution."""
    conf = ResNet50(helpers="pallas").conf()
    from deeplearning4j_tpu_torch.nn.helpers.fused_graph import build_plan

    plan = build_plan(conf.topological_order(), conf.network_outputs,
                      impl="pallas")
    types, lin = conf.resolve_shapes(return_layer_inputs=True)
    routes = {"conv1x1": [], "conv3x3": [], None: []}
    for name, spec in plan.conv.items():
        layer = conf.node(name).obj
        t = lin[name]
        w_shape = tuple(layer.kernel_size) + (t.channels, layer.n_out)
        routes[kernel_route(w_shape, spec.stride, spec.padding,
                            (t.height, t.width))].append(name)
    assert len(plan.conv) == 53
    assert len(routes["conv1x1"]) == 30
    assert len(routes["conv3x3"]) == 16
    assert sorted(routes[None]) == sorted(
        ["stem_conv"] + [f"s{s}b0_{p}_conv" for s in (3, 4, 5)
                         for p in ("a", "sc")])


def test_resnet50_small_forward_runs_on_cpu():
    net = ResNet50(num_classes=7, input_shape=(32, 32, 3),
                   compute_dtype="bfloat16", helpers="pallas"
                   ).init_model(device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3))
    out = net.output(x.astype(np.float32))
    assert out.shape == (2, 7) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.sum(-1), torch.ones(2), rtol=0,
                               atol=2e-2)


def test_entry_points_default_to_cuda():
    """Without a GPU and without device="cpu" every entry point raises;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    conf = ResNet50(input_shape=(32, 32, 3)).conf()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(input_shape=(32, 32, 3)).init_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"a": {"W": np.zeros(2)}})


def test_restore_jax_model_zip(tmp_path, trained_jax_nets):
    nets, x = trained_jax_nets
    jnet = nets["pallas"]
    path = os.path.join(tmp_path, "mini.zip")
    write_model(jnet, path)
    net = restore_computation_graph(path, device="cpu")
    assert net.conf.helper_mode == "pallas"
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), **F32_TOL)
    # leaf order is jax.tree_util's
    jl = jax.tree_util.tree_leaves(jnet.params)
    tl = _flatten(net.params)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with open(path, "r+b") as f:   # torn write -> sidecar mismatch
        f.seek(100)
        f.write(b"\x00\x01\x02")
    from deeplearning4j_tpu_torch.resilience.errors import (
        CheckpointIntegrityError,
    )
    with pytest.raises(CheckpointIntegrityError):
        restore_computation_graph(path, device="cpu")
