"""The port's transfer learning (nn/transferlearning.py) and frozen layers
in its train step, on the CPU: the JAX package's transfer tests
(tests/test_training_infra.py) mirrored on the port, fine-tuned fits
against the JAX package's on the same weights, and the frozen boundary
(no backward for a frozen conv, frozen params bit for bit through `run`
and `run_group`).

Tolerances: the layer-list fits at rtol 1e-5 on the loss and rtol 1e-5
/ atol 1e-6 on params (dense f32 products in another order); the graph
fits at tests/test_torch_train.py's LOSS_RTOL / PARAM_TOL (the JAX
package's own none-vs-fused training tolerances); features against the
full forward at the JAX test's rtol 1e-6; frozen params bit for bit."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.transferlearning import (
    FineTuneConfiguration as JFTC,
)
from deeplearning4j_tpu.nn.transferlearning import TransferLearning as JTL
from deeplearning4j_tpu.nn.transferlearning import (
    TransferLearningHelper as JHelper,
)
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.helpers import fused_ops
from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as pc
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration,
    TransferLearning,
    TransferLearningHelper,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from deeplearning4j_tpu_torch.util.tree import leaves
from test_helpers import _data as _mini_data
from test_helpers import _mini_resnet
from test_torch_train import LOSS_RTOL, PARAM_TOL, _assert_trees_close

MLN_LOSS_RTOL = 1e-5
MLN_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return t.detach().float().cpu().numpy()


def _tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conf(NNC, IT, Dense, Out, n_in=6, n_out=3, seed=11, lr=0.05):
    """tests/test_training_infra.py's _net configuration."""
    return (NNC.Builder()
            .seed(seed).updater("sgd").learning_rate(lr)
            .activation("tanh").weight_init("xavier").list()
            .layer(Dense(n_out=10))
            .layer(Dense(n_out=8))
            .layer(Out(n_out=n_out, loss="mcxent"))
            .set_input_type(IT.feed_forward(n_in))
            .build())


def _net(**kw):
    return MultiLayerNetwork(
        _conf(NeuralNetConfiguration, InputType, DenseLayer, OutputLayer,
              **kw), device="cpu").init()


def _data(rng, n=60, d=6, c=3):
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, c))
    y = np.eye(c, dtype=np.float32)[(x @ w).argmax(1)]
    return DataSet(x, y)


def _snapshot(tree):
    return [t.detach().clone() for t in leaves(tree)]


def _bits_equal(before, tree):
    return all(torch.equal(a, b) for a, b in zip(before, leaves(tree)))


# -------------------------------------- tests/test_training_infra.py


def test_transfer_learning_freeze_and_replace(rng):
    src = _net()
    ds = _data(rng)
    src.fit(ListDataSetIterator(ds, 20), epochs=2)
    p0 = src.params[0]["W"].clone()
    new = (TransferLearning.Builder(src)
           .fine_tune_configuration(
               FineTuneConfiguration.Builder().updater("sgd")
               .learning_rate(0.1).build())
           .set_feature_extractor(1)
           .n_out_replace(2, 5, weight_init="xavier")
           .build())
    assert torch.equal(new.params[0]["W"], p0)
    assert new.conf.layers[0].frozen and new.conf.layers[1].frozen
    assert not new.conf.layers[2].frozen
    assert new.conf.layers[2].n_out == 5
    assert new.conf.learning_rate == 0.1
    y5 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 60)]
    new.fit([(ds.features, y5)] * 4)
    assert torch.equal(new.params[0]["W"], p0)
    assert tuple(new.output(ds.features).shape) == (60, 5)


def test_transfer_learning_add_remove_layers(rng):
    src = _net()
    new = (TransferLearning.Builder(src)
           .remove_output_layer()
           .add_layer(DenseLayer(n_out=4, activation="relu"))
           .add_layer(OutputLayer(n_out=2, loss="mcxent"))
           .build())
    assert len(new.conf.layers) == 4
    assert new.conf.layers[2].weight_init == "xavier"
    x = rng.normal(size=(5, 6)).astype(np.float32)
    assert tuple(new.output(x).shape) == (5, 2)
    for i in (0, 1):     # retained layers keep their params
        assert torch.equal(new.params[i]["W"], src.params[i]["W"])
    with pytest.raises(TypeError, match="GraphBuilder"):
        TransferLearning.Builder(_mini_port("fused"))


def test_transfer_learning_helper_featurize(rng):
    src = _net()
    helper = TransferLearningHelper(src, frozen_up_to=1)
    x = rng.normal(size=(7, 6)).astype(np.float32)
    feats = helper.featurize(x)
    assert tuple(feats.shape) == (7, 8)
    acts = src.feed_forward(x)
    np.testing.assert_allclose(_np(feats), _np(acts[2]), rtol=1e-6)


def test_transfer_learning_helper_featurized_workflow(rng):
    x = rng.normal(size=(128, 8, 8, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum((1, 2, 3)) > 0).astype(int)]
    conf = (NeuralNetConfiguration.Builder().seed(1).updater("adam")
            .learning_rate(5e-3).activation("relu")
            .weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=2, loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    helper = TransferLearningHelper(net, frozen_up_to=0)
    feats = helper.featurize(x)
    assert tuple(feats.shape) == (128, 6, 6, 4)
    frozen_before = net.params[0]["W"].clone()
    head_before = net.params[2]["W"].clone()
    before = net.score((x, y))
    for _ in range(15):
        helper.fitFeaturized((feats, y))
    assert net.score((x, y)) < before
    assert torch.equal(net.params[0]["W"], frozen_before)
    assert float((net.params[2]["W"] - head_before).abs().max()) > 1e-5
    full = _np(net.output(x))
    tail = _np(helper.unfrozenMLN(feats).output(feats))
    np.testing.assert_allclose(full, tail, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ parity with JAX


def _port_mln(jnet):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    net.params, net.states = params_from_jax(
        _tonp(jnet.params), _tonp(jnet.states), device="cpu")
    return net


def test_fine_tuned_fit_matches_jax(rng):
    """The same source weights, the same Builder calls (freeze 0..1,
    replace the head's width, new updater and rate, add l2): the
    rebuilt configurations agree, and four fine-tuning steps (the
    re-initialized head carried over from the JAX net) give the same
    losses and params; the frozen layers keep the source's bits."""
    ds = _data(rng)
    jsrc = JMLN(_conf(JNNC, JInputType, JDense, JOut)).init()
    jsrc.fit([(ds.features, ds.labels)] * 3)
    src = _port_mln(jsrc)

    def build(TL, FTC, net):
        return (TL.Builder(net)
                .fine_tune_configuration(
                    FTC.Builder().updater("nesterovs").learning_rate(0.05)
                    .momentum(0.8).l2(1e-3).build())
                .set_feature_extractor(1)
                .n_out_replace(2, 5, weight_init="xavier")
                .build())

    jnew = build(JTL, JFTC, jsrc)
    new = build(TransferLearning, FineTuneConfiguration, src)
    assert new.conf.to_json() == jnew.conf.to_json()
    np.testing.assert_array_equal(_np(new.params[1]["W"]),
                                  np.asarray(jnew.params[1]["W"]))
    head, _ = params_from_jax([_tonp(jnew.params[2])], device="cpu")
    params = list(new.params)
    params[2] = head[0]
    new.params = params
    frozen = _snapshot(new.params[:2])
    y5 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 60)]
    for step in range(4):
        lj = float(jnew.fit_batch((ds.features, y5)))
        lt = float(new.fit_batch((ds.features, y5)))
        np.testing.assert_allclose(lt, lj, rtol=MLN_LOSS_RTOL,
                                   err_msg=f"step {step}")
    _assert_trees_close(jnew.params, new.params, **MLN_PARAM_TOL)
    _assert_trees_close(jnew.updater_states, new.updater_states,
                        **MLN_PARAM_TOL)
    assert _bits_equal(frozen, new.params[:2])


def test_helper_featurize_and_fit_featurized_match_jax(rng):
    ds = _data(rng, n=32)
    jsrc = JMLN(_conf(JNNC, JInputType, JDense, JOut)).init()
    src = _port_mln(jsrc)
    jh, th = JHelper(jsrc, frozen_up_to=0), TransferLearningHelper(src, 0)
    jf, tf = jh.featurize(ds.features), th.featurize(ds.features)
    np.testing.assert_allclose(_np(tf), jf, rtol=1e-6, atol=1e-7)
    for _ in range(3):
        jh.fit_featurized((jf, ds.labels))
        th.fit_featurized((tf, ds.labels))
    _assert_trees_close(jsrc.params, src.params, **MLN_PARAM_TOL)
    assert isinstance(th.unfrozen_mln(tf), MultiLayerNetwork)


def _mini_port(mode, jnet=None):
    jnet = jnet or _mini_resnet(mode)
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, device="cpu").init()
    net.params, net.states = params_from_jax(
        _tonp(jnet.params), _tonp(jnet.states), device="cpu")
    return net


@pytest.mark.parametrize("mode", ["none", "fused", "pallas"])
def test_graph_builder_fit_matches_jax(mode):
    """GraphBuilder on the mini ResNet of tests/test_helpers.py: freeze
    the conv block ("b0_out" and its ancestors), nesterovs at 1e-2; two
    steps against the JAX package's (its "fused" executor) — losses,
    params, updater state and the BatchNorm states (the frozen BNs'
    running statistics move in train mode, as JAX's do)."""
    jsrc = _mini_resnet("fused")
    src = _mini_port(mode, jsrc)

    def build(TL, FTC, net):
        return (TL.GraphBuilder(net)
                .fine_tune_configuration(FTC.Builder().updater("nesterovs")
                                         .learning_rate(1e-2).build())
                .set_feature_extractor("b0_out").build())

    jnew = build(JTL, JFTC, jsrc)
    new = build(TransferLearning, FineTuneConfiguration, src)
    new.conf.helper_mode = mode
    frozen = sorted(new._frozen())
    assert frozen == sorted(n.name for n in jnew.conf.nodes
                            if n.kind == "layer" and n.obj.frozen)
    assert {"stem_conv", "b0a_conv", "b0sc_bn", "b0c_bn"} <= set(frozen)
    assert "b1a_conv" not in frozen
    before = {k: _snapshot(new.params[k]) for k in frozen}
    bn_before = _snapshot(new.states["b0a_bn"])
    x, y = _mini_data(np.random.default_rng(4))
    for _ in range(2):
        np.testing.assert_allclose(float(new.fit_batch(([x], [y]))),
                                   float(jnew.fit_batch(([x], [y]))),
                                   rtol=LOSS_RTOL)
    _assert_trees_close(jnew.params, new.params, **PARAM_TOL)
    _assert_trees_close(jnew.updater_states, new.updater_states, **PARAM_TOL)
    _assert_trees_close(jnew.states, new.states, **PARAM_TOL)
    assert all(_bits_equal(before[k], new.params[k]) for k in frozen)
    assert not _bits_equal(bn_before, new.states["b0a_bn"])


# ------------------------------------------------- the frozen boundary


def _frozen_mini(mode="pallas"):
    src = _mini_port(mode)
    return (TransferLearning.GraphBuilder(src)
            .set_feature_extractor("b0_out").build())


def test_no_backward_runs_for_a_frozen_conv(monkeypatch):
    """Under "pallas", after freezing the conv block: FusedConv.backward
    runs for the three unfrozen convs only (b1a, b1b, b1c); of the
    routed 1x1 backwards, b1a (fed by the frozen block) launches no
    dgrad, only wgrad, and b1c both; nothing runs for b0a/b0c/b0sc."""
    net = _frozen_mini()
    calls, kernels = [], {"dgrad": [], "wgrad": []}
    orig_bwd = fused_ops.FusedConv.backward
    orig_d, orig_w = pc.dgrad_conv1x1, pc.wgrad_conv1x1

    def bwd(ctx, *grads):
        calls.append(tuple(ctx.saved_tensors[1].shape))
        return orig_bwd(ctx, *grads)

    def dgrad(dy, y, w, *a, **k):
        kernels["dgrad"].append(tuple(w.shape))
        return orig_d(dy, y, w, *a, **k)

    def wgrad(dy, y, x, *a, **k):
        kernels["wgrad"].append((x.shape[1], dy.shape[1]))
        return orig_w(dy, y, x, *a, **k)

    monkeypatch.setattr(fused_ops.FusedConv, "backward", staticmethod(bwd))
    monkeypatch.setattr(pc, "dgrad_conv1x1", dgrad)
    monkeypatch.setattr(pc, "wgrad_conv1x1", wgrad)
    x, y = _mini_data(np.random.default_rng(5))
    net.fit_batch(([x], [y]))
    # b1a 1x1 16->8, b1b 3x3 8->8, b1c 1x1 8->16
    assert sorted(calls) == sorted([(1, 1, 16, 8), (3, 3, 8, 8),
                                    (1, 1, 8, 16)])
    assert kernels["dgrad"] == [(8, 16)]               # b1c only
    assert sorted(kernels["wgrad"]) == [(8, 16), (16, 8)]


def test_fused_conv_backward_computes_only_what_is_asked(monkeypatch):
    """A 1x1 FusedConv whose input and affine need no gradient launches
    no dgrad (its bias gradient comes from torch) and gives dW and db
    equal to the full backward's."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4, 8, generator=g)
    s, t = torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g)
    w0, b0 = torch.randn(1, 1, 8, 16, generator=g), torch.randn(16,
                                                                generator=g)
    dy = torch.randn(2, 4, 4, 16, generator=g)
    n_dgrad = []
    orig = pc.dgrad_conv1x1
    monkeypatch.setattr(pc, "dgrad_conv1x1",
                        lambda *a, **k: n_dgrad.append(1) or orig(*a, **k))

    def grads(need_x):
        xi = x.clone().requires_grad_(need_x)
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        y, ssum, ssq, _ = fused_ops.fused_conv(
            xi, w, b, s, t, None, None, None, (1, 1), "SAME", True, 1,
            impl="pallas", emit_u=False)
        loss = (y * dy).sum() + ssum.sum() + 1e-2 * ssq.sum()
        return torch.autograd.grad(loss, [w, b])

    full = grads(True)
    assert len(n_dgrad) == 1
    part = grads(False)
    assert len(n_dgrad) == 1
    for a, b in zip(part, full):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["fused", "pallas"])
def test_frozen_params_stay_bitwise_through_run_and_run_group(mode):
    """StepProgram.run and run_group(2) on the frozen mini ResNet: frozen
    params bit for bit, the unfrozen ones moved, the flat chain off, and
    run_group equal to two run() calls bit for bit."""
    a, b = _frozen_mini(mode), _frozen_mini(mode)
    frozen = sorted(a._frozen())
    before = {k: _snapshot(a.params[k]) for k in frozen}
    data = [_mini_data(np.random.default_rng(s)) for s in (6, 7)]
    pa, pb = StepProgram(a), StepProgram(b)
    for x, y in data:
        pa.run(x, y)
    pb.run_group(np.stack([d[0] for d in data]),
                 np.stack([d[1] for d in data]))
    assert a._flat_train is None and b._flat_train is None
    for net in (a, b):
        assert all(_bits_equal(before[k], net.params[k]) for k in frozen)
        assert not _bits_equal(_snapshot(_frozen_mini(mode).params["out"]),
                               net.params["out"])
    for p, q in zip(leaves(a.params) + leaves(a.states),
                    leaves(b.params) + leaves(b.states)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("norm", ["renormalize_l2_per_layer",
                                  "clip_l2_per_layer"])
def test_per_layer_clip_with_frozen_and_parameterless_layers_matches_jax(
        rng, norm):
    """Per-layer gradient normalization over a layer list holding a
    parameterless layer (an ActivationLayer) and a frozen one: the port
    passes over layers without gradients, as the JAX package's norm over
    an empty tree does; three steps against JAX."""
    from deeplearning4j_tpu.nn.layers import ActivationLayer as JAct
    from deeplearning4j_tpu_torch.nn.layers import ActivationLayer

    def conf(NNC, IT, Dense, Act, Out):
        c = (NNC.Builder().seed(4).updater("sgd").learning_rate(0.1)
             .activation("tanh").weight_init("xavier").list()
             .layer(Dense(n_out=7))
             .layer(Act(activation="relu"))
             .layer(Dense(n_out=5))
             .layer(Out(n_out=3, loss="mcxent"))
             .set_input_type(IT.feed_forward(6)).build())
        c.gradient_normalization = norm
        c.gradient_normalization_threshold = 0.5
        c.layers[0].frozen = True
        return c

    jnet = JMLN(conf(JNNC, JInputType, JDense, JAct, JOut)).init()
    net = _port_mln(jnet)
    assert net.conf.to_json() == jnet.conf.to_json()
    ds = _data(rng, n=16)
    for step in range(3):
        np.testing.assert_allclose(
            float(net.fit_batch((ds.features, ds.labels))),
            float(jnet.fit_batch((ds.features, ds.labels))),
            rtol=MLN_LOSS_RTOL, err_msg=f"step {step}")
    _assert_trees_close(jnet.params, net.params, **MLN_PARAM_TOL)
