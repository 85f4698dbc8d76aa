"""The port's recurrent layers, RNN heads, recurrent preprocessors and
vertices, 1-D convolution and pooling, mask helpers and streaming
inference against the JAX package, on the CPU: the same seeded numpy
inputs and the JAX package's own weights (carried across as numpy) go
through the JAX function and its port.

Tolerances: forward outputs at rtol 1e-5 / atol 1e-6 in f32 (the JAX
package's golden bar, tests/test_parity_extras.py); `rnn_time_step`
against the full forward at the JAX package's own bar for it
(tests/test_smoke.py::test_rnn_time_step_matches_full_forward: rtol 1e-4
/ atol 1e-5); `bptt_remat` against the plain backward at 1e-6 (the same
arithmetic, recomputed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import graph_vertices as JV
from deeplearning4j_tpu.nn.conf import preprocessors as JP
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import nn_utils as jnu
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import graph_vertices as TV
from deeplearning4j_tpu_torch.nn.conf import preprocessors as TP
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.serde import layer_from_dict
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import nn_utils as tnu
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
STREAM_TOL = dict(rtol=1e-4, atol=1e-5)
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)
B, T, D, H = 3, 7, 5, 6


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_layer(jlayer):
    """The port's layer from the JAX layer's dict (n_in resolved)."""
    return layer_from_dict(jlayer.to_dict())


def _jlayer_params(jlayer, in_type, seed=0):
    jlayer.set_n_in(in_type)
    jp = jlayer.init_params(jax.random.PRNGKey(seed), in_type)
    return jp, params_from_jax(_tree_np(jp), device="cpu")[0]


def _mask(rng, zero_row=True):
    """A [B, T] mask with ragged lengths; its last row all zeros."""
    lengths = rng.integers(1, T + 1, B)
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    if zero_row:
        m[-1] = 0.0
    return m


RNN_LAYERS = {
    "LSTM": lambda: JL.LSTM(n_out=H, weight_init="xavier"),
    "GravesLSTM": lambda: JL.GravesLSTM(n_out=H, weight_init="xavier"),
    "GravesBidirectionalLSTM": lambda: JL.GravesBidirectionalLSTM(
        n_out=H, weight_init="xavier"),
}


@pytest.mark.parametrize("kind", sorted(RNN_LAYERS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("carried", [False, True])
def test_recurrent_layer_apply_matches_jax(kind, masked, carried):
    """apply() of each recurrent layer: outputs and final carries, with
    and without a [B, T] mask (one row all zeros), from zeros or from a
    nonzero carry (the forward direction's, for the bidirectional
    layer)."""
    rng = np.random.default_rng(1)
    jlayer = RNN_LAYERS[kind]()
    jp, tp = _jlayer_params(jlayer, JInputType.recurrent(D, T))
    layer = _port_layer(jlayer)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    m = _mask(rng) if masked else None
    state = None
    if carried:
        h0, c0 = (rng.normal(size=(B, H)).astype(np.float32)
                  for _ in range(2))
        state = (h0, c0)
        if kind == "GravesBidirectionalLSTM":
            state = (state, (np.zeros_like(h0), np.zeros_like(c0)))
    jy, jc = jlayer.apply(jp, jnp.asarray(x),
                          state=jax.tree_util.tree_map(jnp.asarray, state),
                          mask=None if m is None else jnp.asarray(m))
    with torch.no_grad():
        ty, tc = layer.apply(tp, _t(x),
                             state=jax.tree_util.tree_map(_t, state),
                             mask=_t(m))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(_np, tc))):
        np.testing.assert_allclose(b, np.asarray(a), **FWD_TOL)
    if masked:
        # a masked step repeats the frozen h: the all-zero row outputs its
        # initial h at every step
        want = np.zeros((T, H)) if state is None else np.broadcast_to(
            np.asarray(jax.tree_util.tree_leaves(state)[0])[-1], (T, H))
        np.testing.assert_allclose(_np(ty)[-1, :, :H], want, **FWD_TOL)


@pytest.mark.parametrize("kind", ["LSTM", "GravesLSTM"])
def test_recurrent_step_matches_jax(kind):
    rng = np.random.default_rng(2)
    jlayer = RNN_LAYERS[kind]()
    jp, tp = _jlayer_params(jlayer, JInputType.recurrent(D, T))
    layer = _port_layer(jlayer)
    x = rng.normal(size=(B, D)).astype(np.float32)
    h0, c0 = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    jy, (jh, jc) = jlayer.step(jp, jnp.asarray(x), (jnp.asarray(h0),
                                                    jnp.asarray(c0)))
    ty, (th, tc) = layer.step(tp, _t(x), (_t(h0), _t(c0)))
    for a, b in ((jy, ty), (jh, th), (jc, tc)):
        np.testing.assert_allclose(_np(b), np.asarray(a), **FWD_TOL)


def test_init_params_pack_gates_as_jax():
    """Shapes, keys and the forget-gate bias block of [i, f, o, g]."""
    for kind, make in RNN_LAYERS.items():
        jlayer = make()
        jlayer.forget_gate_bias_init = 0.5
        jp, _ = _jlayer_params(jlayer, JInputType.recurrent(D, T))
        layer = _port_layer(jlayer)
        tp = layer.init_params(torch.Generator().manual_seed(0),
                               InputType.recurrent(D, T))
        jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
        assert jshapes == tshapes, kind
        b = (tp["fwd"] if kind == "GravesBidirectionalLSTM" else tp)["b"]
        np.testing.assert_array_equal(
            _np(b), np.r_[np.zeros(H), np.full(H, 0.5), np.zeros(2 * H)])


def test_bptt_remat_gives_the_plain_gradients():
    """torch.utils.checkpoint around each step's cell: the same
    gradients as keeping every step's gates."""
    rng = np.random.default_rng(3)
    jlayer = JL.GravesLSTM(n_out=H, weight_init="xavier")
    _, tp = _jlayer_params(jlayer, JInputType.recurrent(D, T))
    x = _t(rng.normal(size=(B, T, D)).astype(np.float32))
    m = _t(_mask(rng, zero_row=False))
    grads = []
    for remat in (False, True):
        layer = dataclasses.replace(_port_layer(jlayer), bptt_remat=remat)
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        y, (h, c) = layer.apply(p, x, mask=m)
        loss = (y ** 2).sum() + (c * h).sum()
        grads.append(torch.autograd.grad(loss, [p[k] for k in sorted(p)]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(b), _np(a), **REMAT_TOL)


# ------------------------------------------------------------ the heads


def _head_case(kind, rng):
    """(jax layer, input type, x, labels, label mask) of an output head."""
    if kind == "RnnOutputLayer":
        x = rng.normal(size=(B, T, D)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, T))]
        return (JL.RnnOutputLayer(n_out=4, weight_init="xavier",
                                  loss="mcxent"),
                JInputType.recurrent(D, T), x, y, _mask(rng))
    if kind == "LossLayer":
        x = rng.normal(size=(B, 4)).astype(np.float32)
        y = rng.normal(size=(B, 4)).astype(np.float32)
        return JL.LossLayer(loss="mse"), JInputType.feed_forward(4), x, y, \
            None
    x = rng.normal(size=(B, D)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    return (JL.CenterLossOutputLayer(n_out=4, weight_init="xavier",
                                     lambda_=0.5, alpha=0.3),
            JInputType.feed_forward(D), x, y, None)


@pytest.mark.parametrize("kind", ["RnnOutputLayer", "LossLayer",
                                  "CenterLossOutputLayer"])
def test_output_heads_match_jax(kind):
    """apply() and the per-example loss (per timestep, label-masked, for
    the RNN head); the center loss with nonzero centers."""
    rng = np.random.default_rng(4)
    jlayer, in_type, x, y, lm = _head_case(kind, rng)
    jp, tp = _jlayer_params(jlayer, in_type)
    if kind == "CenterLossOutputLayer":
        jp["centers"] = jnp.asarray(rng.normal(size=(4, D)), jnp.float32)
        tp["centers"] = _t(np.asarray(jp["centers"]))
    layer = _port_layer(jlayer)
    jy, _ = jlayer.apply(jp, jnp.asarray(x))
    ty, _ = layer.apply(tp, _t(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    for mask in (None, lm):
        jl = jlayer.per_example_loss_from_input(
            jp, jnp.asarray(x), jnp.asarray(y),
            mask=None if mask is None else jnp.asarray(mask))
        tl = layer.per_example_loss_from_input(tp, _t(x), _t(y),
                                               mask=_t(mask))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD_TOL)


def test_embedding_layer_gathers_as_jax():
    rng = np.random.default_rng(5)
    jlayer = JL.EmbeddingLayer(n_out=H, weight_init="xavier", bias_init=0.1)
    jp, tp = _jlayer_params(jlayer, JInputType.feed_forward(10))
    layer = _port_layer(jlayer)
    for idx in (rng.integers(0, 10, (B,)), rng.integers(0, 10, (B, 1))):
        x = idx.astype(np.float32)
        jy, _ = jlayer.apply(jp, jnp.asarray(x))
        ty, _ = layer.apply(tp, _t(x))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_over_a_masked_time_series(pooling):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    m = _mask(rng, zero_row=False)
    jlayer = JL.GlobalPoolingLayer(pooling_type=pooling)
    layer = _port_layer(jlayer)
    for mask in (None, m):
        jy, _ = jlayer.apply({}, jnp.asarray(x),
                             mask=None if mask is None else jnp.asarray(mask))
        ty, _ = layer.apply({}, _t(x), mask=_t(mask))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    assert layer.feed_forward_mask(_t(m), None) is None


# ---------------------------------------------------- 1-D conv and pooling

CONV1D = [dict(kernel_size=3, stride=1, convolution_mode="same"),
          dict(kernel_size=4, stride=2, convolution_mode="same"),
          dict(kernel_size=3, stride=2, padding=1,
               convolution_mode="truncate")]


@pytest.mark.parametrize("kw", CONV1D, ids=lambda kw: str(kw))
def test_convolution1d_matches_jax(kw):
    rng = np.random.default_rng(7)
    jlayer = JL.Convolution1DLayer(n_out=4, weight_init="xavier",
                                   activation="tanh", bias_init=0.2, **kw)
    jp, tp = _jlayer_params(jlayer, JInputType.recurrent(D, T))
    layer = _port_layer(jlayer)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jy, _ = jlayer.apply(jp, jnp.asarray(x))
    ty, _ = layer.apply(tp, _t(x))
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    it = InputType.recurrent(D, T)
    assert layer.output_type(it).to_dict() == jlayer.output_type(
        JInputType.recurrent(D, T)).to_dict()


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("kw", [dict(kernel_size=2, stride=2),
                                dict(kernel_size=3, stride=2, padding=1)],
                         ids=["k2s2", "k3s2p1"])
def test_subsampling1d_matches_jax(pooling, kw):
    rng = np.random.default_rng(8)
    jlayer = JL.Subsampling1DLayer(pooling_type=pooling, **kw)
    layer = _port_layer(jlayer)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jy, _ = jlayer.apply({}, jnp.asarray(x))
    ty, _ = layer.apply({}, _t(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    assert layer.output_type(InputType.recurrent(D, T)).to_dict() == \
        jlayer.output_type(JInputType.recurrent(D, T)).to_dict()


# -------------------------------------------------------- preprocessors

PREPROCESSOR_CASES = {
    "RnnToFeedForwardPreProcessor": ((B, T, D), (B, T), ()),
    "FeedForwardToRnnPreProcessor": ((B * T, D), (B * T,), (T,)),
    "CnnToRnnPreProcessor": ((B, 4, 3, 2), None, (4, 3, 2)),
    "RnnToCnnPreProcessor": ((B, T, 12), (B, T), (2, 3, 2)),
    "ZeroMeanPrePreProcessor": ((B, T, D), None, ()),
    "UnitVarianceProcessor": ((B, T, D), None, ()),
    "ZeroMeanAndUnitVariancePreProcessor": ((B, 4, 3, 2), None, ()),
    "BinomialSamplingPreProcessor": ((B, D), None, ()),
}


@pytest.mark.parametrize("name", sorted(PREPROCESSOR_CASES))
def test_preprocessor_matches_jax(name):
    """preprocess, the mask it passes on and the dict round trip across
    the packages."""
    shape, mshape, args = PREPROCESSOR_CASES[name]
    rng = np.random.default_rng(9)
    x = rng.uniform(size=shape).astype(np.float32)
    jpre = JP.PREPROCESSORS[name](*args)
    tpre = TP.preprocessor_from_dict(jpre.to_dict())
    assert tpre.to_dict() == jpre.to_dict()
    np.testing.assert_allclose(_np(tpre.preprocess(_t(x))),
                               np.asarray(jpre.preprocess(jnp.asarray(x))),
                               **FWD_TOL)
    if mshape is not None:
        m = (rng.uniform(size=mshape) > 0.3).astype(np.float32)
        np.testing.assert_array_equal(
            _np(tpre.feed_forward_mask(_t(m), None)),
            np.asarray(jpre.feed_forward_mask(jnp.asarray(m), None)))


def test_composable_preprocessor_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jpre = JP.ComposableInputPreProcessor(
        JP.ZeroMeanAndUnitVariancePreProcessor(),
        JP.RnnToFeedForwardPreProcessor())
    tpre = TP.preprocessor_from_dict(jpre.to_dict())
    assert tpre.to_dict() == jpre.to_dict()
    np.testing.assert_allclose(_np(tpre.preprocess(_t(x))),
                               np.asarray(jpre.preprocess(jnp.asarray(x))),
                               **FWD_TOL)
    it = tpre.output_type(InputType.recurrent(D, T))
    assert it.to_dict() == jpre.output_type(
        JInputType.recurrent(D, T)).to_dict()


@pytest.mark.parametrize("prev, layer, want", [
    (JInputType.convolutional(4, 3, 2), "GravesLSTM", "CnnToRnnPreProcessor"),
    (JInputType.convolutional(4, 3, 2), "EmbeddingLayer",
     "CnnToFeedForwardPreProcessor"),
    (JInputType.recurrent(D, T), "DenseLayer", None),
    (JInputType.recurrent(D, T), "LSTM", None),
])
def test_infer_preprocessor_matches_jax(prev, layer, want):
    jlayer = getattr(JL, layer)(n_out=4)
    tprev = InputType.from_dict(prev.to_dict())
    got = TP.infer_preprocessor(tprev, _port_layer(jlayer))
    ref = JP.infer_preprocessor(prev, jlayer)
    assert (None if got is None else got.to_dict()) == \
        (None if ref is None else ref.to_dict())
    assert (None if ref is None else type(ref).__name__) == want


def test_infer_preprocessor_refuses_feed_forward_into_rnn():
    with pytest.raises(ValueError, match="FeedForwardToRnnPreProcessor"):
        TP.infer_preprocessor(InputType.feed_forward(D), TL.GravesLSTM(n_out=4))


# ------------------------------------------------------------- vertices

def _vertex_cases(rng):
    ff = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "SubsetVertex": (JV.SubsetVertex(from_index=1, to_index=3),
                         [ff(B, T, D)]),
        "L2NormalizeVertex": (JV.L2NormalizeVertex(), [ff(B, 4, 3, 2)]),
        "L2Vertex": (JV.L2Vertex(), [ff(B, T, D), ff(B, T, D)]),
        "ScaleVertex": (JV.ScaleVertex(scale_factor=2.5), [ff(B, D)]),
        "ShiftVertex": (JV.ShiftVertex(shift_factor=-0.75), [ff(B, D)]),
        "StackVertex": (JV.StackVertex(), [ff(B, D), ff(B, D), ff(B, D)]),
        "UnstackVertex": (JV.UnstackVertex(from_index=1, stack_size=3),
                          [ff(3 * B, D)]),
        "ReshapeVertex": (JV.ReshapeVertex(new_shape=(T, D)),
                          [ff(B, T * D)]),
        "PreprocessorVertex": (JV.PreprocessorVertex(
            preprocessor=JP.FeedForwardToRnnPreProcessor(T)),
            [ff(B * T, D)]),
        "PoolHelperVertex": (JV.PoolHelperVertex(), [ff(B, 4, 3, 2)]),
        "LastTimeStepVertex": (JV.LastTimeStepVertex(), [ff(B, T, D)]),
        "DuplicateToTimeSeriesVertex": (
            JV.DuplicateToTimeSeriesVertex(ts_input="seq"),
            [ff(B, D), ff(B, T, 2)]),
    }


@pytest.mark.parametrize("name", sorted(_vertex_cases(
    np.random.default_rng(0))))
def test_vertex_matches_jax(name):
    """apply, the dict round trip across the packages, and (for the last
    time step) the last unmasked step of each row."""
    jv, xs = _vertex_cases(np.random.default_rng(11))[name]
    tv = TV.vertex_from_dict(jv.to_dict())
    assert tv.to_dict() == jv.to_dict()
    jy = jv.apply([jnp.asarray(a) for a in xs])
    ty = tv.apply([_t(a) for a in xs])
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    if name == "LastTimeStepVertex":
        m = _mask(np.random.default_rng(12))
        jy = jv.apply([jnp.asarray(xs[0])], mask=jnp.asarray(m))
        ty = tv.apply([_t(xs[0])], mask=_t(m))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
        assert tv.feed_forward_mask([_t(m)], None) is None


def test_vertex_output_types_match_jax():
    for name, (jv, xs) in _vertex_cases(np.random.default_rng(13)).items():
        tv = TV.vertex_from_dict(jv.to_dict())
        jtypes = [JInputType.recurrent(a.shape[2], a.shape[1]) if a.ndim == 3
                  else JInputType.convolutional(*a.shape[1:]) if a.ndim == 4
                  else JInputType.feed_forward(a.shape[1]) for a in xs]
        ttypes = [InputType.from_dict(t.to_dict()) for t in jtypes]
        assert tv.output_type(ttypes).to_dict() == \
            jv.output_type(jtypes).to_dict(), name


# ------------------------------------------------------------ mask helpers

def test_nn_utils_mask_helpers_match_jax():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    m = _mask(rng)
    v = tnu.reshape_time_series_mask_to_vector(_t(m))
    np.testing.assert_array_equal(
        _np(v), np.asarray(jnu.reshape_time_series_mask_to_vector(m)))
    np.testing.assert_array_equal(
        _np(tnu.reshape_vector_to_time_series_mask(v, B)), m)
    for mask in (None, m):
        np.testing.assert_array_equal(
            _np(tnu.reverse_time_series(_t(x), _t(mask))),
            np.asarray(jnu.reverse_time_series(x, mask)))
    img = rng.normal(size=(B, 4, 3, 2)).astype(np.float32)
    img_m = (rng.uniform(size=(B, 4, 3)) > 0.4).astype(np.float32)
    for pt in ("max", "avg", "sum"):
        np.testing.assert_allclose(
            _np(tnu.masked_pooling_time_series(pt, _t(x), _t(m))),
            np.asarray(jnu.masked_pooling_time_series(pt, x, m)), **FWD_TOL)
        np.testing.assert_allclose(
            _np(tnu.masked_pooling_convolution(pt, _t(img), _t(img_m))),
            np.asarray(jnu.masked_pooling_convolution(pt, img, img_m)),
            **FWD_TOL)


# ------------------------------------------------- containers and streaming

def _jax_rnn_mln(bidirectional=False, pooled=False, seed=5):
    b = (JNNC.Builder().seed(seed).updater("adam").learning_rate(1e-2)
         .weight_init("xavier").activation("tanh").list())
    if bidirectional:
        b = b.layer(JL.GravesBidirectionalLSTM(n_out=H))
    else:
        b = b.layer(JL.GravesLSTM(n_out=H)).layer(JL.LSTM(n_out=H))
    if pooled:
        b = b.layer(JL.GlobalPoolingLayer(pooling_type="avg")).layer(
            JL.OutputLayer(n_out=3, loss="mcxent"))
    else:
        b = b.layer(JL.RnnOutputLayer(n_out=3, loss="mcxent"))
    return JMLN(b.set_input_type(JInputType.recurrent(D, T)).build()).init()


def _port_mln(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.params, net.states = params_from_jax(
        _tree_np(jnet.params), _tree_np(jnet.states), device="cpu")
    return net


def test_recurrent_list_configuration_json_matches_jax():
    for bi in (False, True):
        for pooled in (False, True):
            jnet = _jax_rnn_mln(bi, pooled)
            conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
            assert conf.to_json() == jnet.conf.to_json()


@pytest.mark.parametrize("bidirectional", [False, True])
def test_masked_mln_output_and_score_match_jax(bidirectional):
    """A feature mask through GravesLSTM/LSTM (or the bidirectional
    layer) into masked average pooling: the eval-mode score matches."""
    rng = np.random.default_rng(15)
    jnet = _jax_rnn_mln(bidirectional, pooled=True)
    net = _port_mln(jnet)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    fm = _mask(rng, zero_row=False)
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)),
                               **FWD_TOL)
    np.testing.assert_allclose(net.score((x, y, fm)),
                               jnet.score((x, y, jnp.asarray(fm))),
                               rtol=1e-5)


def test_rnn_time_step_matches_output_and_jax():
    """Step by step equals output() on the whole sequence (the JAX
    package's bar) and equals the JAX package's rnn_time_step after the
    same calls: single steps, then a chunk, then after clear_rnn_state."""
    rng = np.random.default_rng(16)
    jnet = _jax_rnn_mln()
    net = _port_mln(jnet)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    full = _np(net.output(x))
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)), **FWD_TOL)
    steps = []
    for t in range(T):
        got = net.rnn_time_step(x[:, t])
        ref = jnet.rnn_time_step(x[:, t])
        np.testing.assert_allclose(_np(got), np.asarray(ref), **FWD_TOL)
        assert not got.requires_grad
        steps.append(_np(got))
    np.testing.assert_allclose(np.stack(steps, 1), full, **STREAM_TOL)
    chunk = rng.normal(size=(B, 3, D)).astype(np.float32)
    np.testing.assert_allclose(_np(net.rnn_time_step(chunk)),
                               np.asarray(jnet.rnn_time_step(chunk)),
                               **FWD_TOL)
    net.clear_rnn_state()
    jnet.clear_rnn_state()
    np.testing.assert_allclose(_np(net.rnn_time_step(x[:, 0])), full[:, 0],
                               **FWD_TOL)


def test_rnn_time_step_state_stays_apart_from_training():
    """A fit between two streaming calls leaves the streaming carries
    free of autograd and where they were; clear_rnn_state resets them."""
    rng = np.random.default_rng(17)
    net = _port_mln(_jax_rnn_mln())
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T))]
    net.rnn_time_step(x[:, 0])
    kept = [None if c is None else tuple(t.clone() for t in c)
            for c in net.rnn_states]
    net.fit_batch((x, y))
    for c, k in zip(net.rnn_states, kept):
        if c is not None:
            assert all(not t.requires_grad for t in c)
            for a, b in zip(c, k):
                assert torch.equal(a, b)
    net.clear_rnn_state()
    assert net.rnn_states is None


def test_rnn_time_step_refuses_bidirectional_layers():
    net = _port_mln(_jax_rnn_mln(bidirectional=True))
    with pytest.raises(ValueError, match="bidirectional"):
        net.rnn_time_step(np.zeros((B, D), np.float32))
    jg = _jax_rnn_graph(bidirectional=True)
    g = _port_graph(jg)
    with pytest.raises(ValueError, match="bidirectional"):
        g.rnn_time_step(np.zeros((B, D), np.float32))


def _jax_rnn_graph(bidirectional=False):
    rnn = (JL.GravesBidirectionalLSTM(n_out=H) if bidirectional
           else JL.GravesLSTM(n_out=H))
    conf = (JNNC.Builder().seed(7).updater("sgd").learning_rate(0.1)
            .weight_init("xavier").activation("tanh").graph_builder()
            .add_inputs("seq")
            .add_layer("rnn", rnn, "seq")
            .add_vertex("last", JV.LastTimeStepVertex(mask_input="seq"),
                        "rnn")
            .add_vertex("dup", JV.DuplicateToTimeSeriesVertex(
                ts_input="seq"), "last")
            .add_vertex("merge", JV.MergeVertex(), "rnn", "dup")
            .add_layer("out", JL.RnnOutputLayer(n_out=3, loss="mcxent"),
                       "merge")
            .set_outputs("out")
            .set_input_types(seq=JInputType.recurrent(D, T))
            .build())
    return JGraph(conf).init()


def _port_graph(jg):
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    g = ComputationGraph(conf, device="cpu").init()
    g.params, g.states = params_from_jax(_tree_np(jg.params),
                                         _tree_np(jg.states), device="cpu")
    return g


def test_graph_masks_reach_last_time_step_and_stream():
    """A graph with LastTimeStepVertex(mask_input) and
    DuplicateToTimeSeriesVertex: its JSON (the implicit ts_input edge),
    the masked eval-mode score and rnn_time_step against the JAX
    package."""
    rng = np.random.default_rng(18)
    jg = _jax_rnn_graph()
    g = _port_graph(jg)
    assert g.conf.to_json() == jg.conf.to_json()
    assert g.conf.node("dup").inputs == ["last", "seq"]
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T))]
    fm = _mask(rng, zero_row=False)
    np.testing.assert_allclose(_np(g.output(x)), np.asarray(jg.output(x)),
                               **FWD_TOL)
    np.testing.assert_allclose(
        g.score(([x], [y], [fm])),
        jg.score(([x], [y], [jnp.asarray(fm)])), rtol=1e-5)
    for t in range(3):
        np.testing.assert_allclose(_np(g.rnn_time_step(x[:, t])),
                                   np.asarray(jg.rnn_time_step(x[:, t])),
                                   **FWD_TOL)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextGenerationLSTM(num_classes=5, input_shape=(4, 5)).init_model()
    conf = MultiLayerConfiguration.from_json(_jax_rnn_mln().conf.to_json())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf)


# ------------------------------------------------------------ model zips

def _embedding_mln():
    conf = (JNNC.Builder().seed(3).updater("adam").weight_init("xavier")
            .list()
            .layer(JL.EmbeddingLayer(n_out=H))
            .layer(JL.DenseLayer(n_out=4, activation="tanh"))
            .layer(JL.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(10))
            .build())
    return MultiLayerConfiguration.from_json(conf.to_json())


@pytest.mark.parametrize("kind", ["text_lstm", "bidirectional_graph",
                                  "embedding"])
def test_port_written_recurrent_zip_restores_in_jax(tmp_path, kind):
    """A port-trained net written by the port's write_model restores in
    the JAX package (GravesLSTM P/RW/W/b, the bidirectional {"bwd", "fwd"}
    pair, the embedding table, rmsprop/adam state in sorted-key leaf
    order) and predicts what the port predicts."""
    from deeplearning4j_tpu.util.model_serializer import ModelSerializer
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )

    rng = np.random.default_rng(19)
    if kind == "text_lstm":
        net = TextGenerationLSTM(num_classes=6, input_shape=(5, 6)) \
            .init_model(device="cpu")
        x = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (2, 5))]
        y = np.roll(x, -1, axis=1)
        restore = ModelSerializer.restore_multi_layer_network
    elif kind == "bidirectional_graph":
        net = _port_graph(_jax_rnn_graph(bidirectional=True))
        x = rng.normal(size=(B, T, D)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T))]
        restore = ModelSerializer.restore_computation_graph
    else:
        net = MultiLayerNetwork(_embedding_mln(), device="cpu").init()
        x = rng.integers(0, 10, (B, 1)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
        restore = ModelSerializer.restore_multi_layer_network
    net.fit_batch((x, y))
    path = str(tmp_path / f"{kind}.zip")
    write_model(net, path)
    jnet = restore(path)
    np.testing.assert_allclose(np.asarray(jnet.output(x)), _np(net.output(x)),
                               **FWD_TOL)
    back = restore_model(path, device="cpu")
    assert back.iteration == net.iteration
    np.testing.assert_array_equal(_np(back.output(x)), _np(net.output(x)))
