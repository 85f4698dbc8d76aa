"""The port's check_gradients (gradientcheck.py) on the JAX package's
gradient-check cases (tests/test_gradientcheck.py), on a graph with
L2NormalizeVertex, ScaleVertex and CenterLossOutputLayer, and on a
broken gradient it must catch. float64 on the CPU, at the JAX package's
bars: relative error 1e-5 unless the absolute error is under 1e-8."""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex,
    L2NormalizeVertex,
    MergeVertex,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    AutoEncoder,
    BatchNormalization,
    CenterLossOutputLayer,
    ConvolutionLayer,
    DenseLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _net(layers, input_type, **builder):
    b = NeuralNetConfiguration.Builder().seed(3).updater("sgd") \
        .learning_rate(0.1).activation(builder.get("activation", "tanh")) \
        .weight_init("xavier")
    for k in ("l1", "l2"):
        if k in builder:
            b = getattr(b, k)(builder[k])
    b = b.list()
    for l in layers:
        b = b.layer(l)
    conf = b.set_input_type(input_type).build()
    return MultiLayerNetwork(conf, dtype=torch.float64, device="cpu").init()


def _check(layers, input_type, x, y, fmask=None, lmask=None, builder=None,
           **kw):
    net = _net(layers, input_type, **(builder or {}))
    assert check_gradients(net, x, y, fmask=fmask, lmask=lmask, **kw)


def _cls(rng, n, c):
    return np.eye(c)[rng.integers(0, c, n)]


def _seq_cls(rng, b, t, c):
    return np.stack([_cls(rng, t, c) for _ in range(b)])


def _lstm_mask():
    m = np.ones((3, 6))
    m[0, 4:] = 0.0
    m[2, 2:] = 0.0
    return m


# (layers, input type, x, y, extra kwargs) of each JAX case, from a rng
CASES = {
    "dense_mlp": lambda r: (
        [DenseLayer(n_out=6), OutputLayer(n_out=3, loss="mcxent")],
        InputType.feed_forward(4), r.normal(size=(5, 4)), _cls(r, 5, 3), {}),
    "dense_l1_l2": lambda r: (
        [DenseLayer(n_out=5), OutputLayer(n_out=3, loss="mcxent")],
        InputType.feed_forward(4), r.normal(size=(4, 4)), _cls(r, 4, 3),
        {"builder": {"activation": "sigmoid", "l1": 0.01, "l2": 0.02}}),
    "cnn_pool_bn": lambda r: (
        [ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                          convolution_mode="same"),
         BatchNormalization(),
         SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
         OutputLayer(n_out=4, loss="mcxent")],
        InputType.convolutional(8, 8, 2), r.normal(size=(3, 8, 8, 2)),
        _cls(r, 3, 4), {"subset": 40}),
    "cnn_avg_pool": lambda r: (
        [ConvolutionLayer(n_out=2, kernel_size=(2, 2), stride=(2, 2)),
         SubsamplingLayer(pooling_type="avg", kernel_size=(3, 3),
                          stride=(1, 1)),
         OutputLayer(n_out=2, loss="mcxent")],
        InputType.convolutional(6, 6, 1), r.normal(size=(3, 6, 6, 1)),
        _cls(r, 3, 2), {"subset": 40}),
    "lstm_rnn_output": lambda r: (
        [GravesLSTM(n_out=5), RnnOutputLayer(n_out=3, loss="mcxent")],
        InputType.recurrent(4, 6), r.normal(size=(3, 6, 4)),
        _seq_cls(r, 3, 6, 3), {"subset": 40}),
    "bidirectional_lstm": lambda r: (
        [GravesBidirectionalLSTM(n_out=4),
         RnnOutputLayer(n_out=2, loss="mcxent")],
        InputType.recurrent(3, 5), r.normal(size=(2, 5, 3)),
        _seq_cls(r, 2, 5, 2), {"subset": 30}),
    "lstm_masking": lambda r: (
        [GravesLSTM(n_out=4), RnnOutputLayer(n_out=3, loss="mcxent")],
        InputType.recurrent(4, 6), r.normal(size=(3, 6, 4)),
        _seq_cls(r, 3, 6, 3), {"lmask": _lstm_mask(), "subset": 30}),
    "global_pooling_rnn": lambda r: (
        [GravesLSTM(n_out=4), GlobalPoolingLayer(pooling_type="max"),
         OutputLayer(n_out=3, loss="mcxent")],
        InputType.recurrent(4, 5), r.normal(size=(3, 5, 4)),
        _cls(r, 3, 3), {"subset": 30}),
    "embedding": lambda r: (
        [EmbeddingLayer(n_out=4), DenseLayer(n_out=5),
         OutputLayer(n_out=3, loss="mcxent")],
        InputType.feed_forward(7),
        r.integers(0, 7, size=(5, 1)).astype(np.float64), _cls(r, 5, 3),
        {}),
    "autoencoder_supervised": lambda r: (
        [AutoEncoder(n_out=4), OutputLayer(n_out=2, loss="mcxent")],
        InputType.feed_forward(6), r.normal(size=(4, 6)), _cls(r, 4, 2),
        {}),
    "vae_supervised": lambda r: (
        [VariationalAutoencoder(n_out=3, encoder_layer_sizes=(8,),
                                decoder_layer_sizes=(8,)),
         OutputLayer(n_out=2, loss="mcxent")],
        InputType.feed_forward(6), r.normal(size=(4, 6)), _cls(r, 4, 2),
        {"subset": 30}),
    "bptt_remat": lambda r: (
        [GravesLSTM(n_out=5, bptt_remat=True),
         RnnOutputLayer(n_out=3, loss="mcxent")],
        InputType.recurrent(4, 6), r.normal(size=(3, 6, 4)),
        _seq_cls(r, 3, 6, 3), {"subset": 40}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_jax_gradient_check_cases(case, rng):
    layers, it, x, y, kw = CASES[case](rng)
    _check(layers, it, x, y, **kw)


LOSS_CASES = {
    "mse": ("identity", lambda r: r.normal(size=(4, 2))),
    "l1": ("identity", lambda r: r.normal(size=(4, 2))),
    "l2": ("identity", lambda r: r.normal(size=(4, 2))),
    "mae": ("identity", lambda r: r.normal(size=(4, 2)) + 3.0),
    "mape": ("identity", lambda r: r.uniform(1.0, 2.0, (4, 2))),
    "msle": ("softplus", lambda r: r.uniform(0.5, 2.0, (4, 2))),
    "mcxent": ("softmax", lambda r: np.eye(2)[r.integers(0, 2, 4)]),
    "negativeloglikelihood": ("softmax",
                              lambda r: np.eye(2)[r.integers(0, 2, 4)]),
    "xent": ("sigmoid", lambda r: r.uniform(0.05, 0.95, (4, 2))),
    "hinge": ("identity", lambda r: r.choice([-1.0, 1.0], (4, 2))),
    "squared_hinge": ("identity", lambda r: r.choice([-1.0, 1.0], (4, 2))),
    "poisson": ("softplus", lambda r: r.integers(0, 5, (4, 2)).astype(float)),
    "kl_divergence": ("softmax", lambda r: (
        lambda p: p / p.sum(1, keepdims=True))(r.uniform(0.1, 1.0, (4, 2)))),
    "cosine_proximity": ("identity", lambda r: r.normal(size=(4, 2))),
}


@pytest.mark.parametrize("loss", list(LOSS_CASES))
def test_every_loss_function(loss, rng):
    act, make_y = LOSS_CASES[loss]
    x = rng.normal(size=(4, 3))
    _check([DenseLayer(n_out=5),
            OutputLayer(n_out=2, loss=loss, activation=act)],
           InputType.feed_forward(3), x, np.asarray(make_y(rng), np.float64))


def test_graph_with_embedding_vertices_and_center_loss(rng):
    """A graph holding the embedding nets' tail: a merge of two dense
    branches, a ScaleVertex into an add, L2-normalized embeddings and a
    CenterLossOutputLayer (whose centers are params)."""
    gb = (NeuralNetConfiguration.Builder().seed(5).updater("sgd")
          .learning_rate(0.1).activation("tanh").weight_init("xavier")
          .graph_builder().add_inputs("in")
          .add_layer("a", DenseLayer(n_out=4), "in")
          .add_layer("b", DenseLayer(n_out=4), "in")
          .add_vertex("cat", MergeVertex(), "a", "b")
          .add_layer("up", DenseLayer(n_out=5, activation="identity"), "cat")
          .add_vertex("scale", ScaleVertex(scale_factor=0.17), "up")
          .add_vertex("add", ElementWiseVertex(op="add"), "in", "scale")
          .add_layer("bottleneck", DenseLayer(n_out=3, activation="identity"),
                     "add")
          .add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
          .add_layer("out", CenterLossOutputLayer(n_out=3, loss="mcxent",
                                                  lambda_=0.5, alpha=0.3),
                     "embeddings")
          .set_outputs("out")
          .set_input_types(**{"in": InputType.feed_forward(5)}))
    net = ComputationGraph(gb.build(), dtype=torch.float64,
                           device="cpu").init()
    params = net.params
    params["out"]["centers"] = torch.from_numpy(rng.normal(size=(3, 3)))
    net.params = params
    x, y = rng.normal(size=(6, 5)), _cls(rng, 6, 3)
    assert check_gradients(net, [x], [y])


@dataclass(kw_only=True)
class _DetachedDense(DenseLayer):
    """A dense layer whose bias gradient is cut: a wrong gradient."""

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        y = x @ params["W"] + params["b"].detach() * 1.5 \
            - params["b"] * 0.5
        return torch.tanh(y), state


def test_a_wrong_gradient_fails_the_check(rng):
    net = _net([_DetachedDense(n_out=4), OutputLayer(n_out=2,
                                                     loss="mcxent")],
               InputType.feed_forward(3))
    params = net.params
    params[0]["b"] = torch.from_numpy(rng.normal(size=4))
    net.params = params
    with pytest.raises(AssertionError, match="Gradient check FAILED"):
        check_gradients(net, rng.normal(size=(4, 3)), _cls(rng, 4, 2))
    f32 = MultiLayerNetwork(net.conf, device="cpu").init()
    with pytest.raises(ValueError, match="float64"):
        check_gradients(f32, rng.normal(size=(4, 3)), _cls(rng, 4, 2))
