"""The port's MultiLayerNetwork (nn/multilayer.py), list builder
(nn/conf/network.py), MLN zoo and MLN model files against the JAX
package, on the CPU, with dropout off (the masks are pinned within the
port: tests/test_torch_dropout.py).

Tolerances: forward outputs at rtol 1e-5 / atol 1e-6 in f32 (the JAX
package's own golden bar, tests/test_parity_extras.py:150); train steps
at tests/test_torch_train.py's LOSS_RTOL / PARAM_TOL (the JAX package's
none-vs-fused training tolerances); the bf16 compute policy at rtol 2e-2
on losses and the f32 master params' update at rtol 2e-2 / atol 2e-4
(bf16 rounds each product to 8 bits; the gap is rounding, not math)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import DropoutLayer as JDropout
from deeplearning4j_tpu.nn.layers import LocalResponseNormalization as JLRN
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.layers import ZeroPaddingLayer as JZeroPad
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer,
)
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    LocalResponseNormalization,
    OutputLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_jax,
    restore_model,
    restore_multi_layer_network,
    write_model,
)
from deeplearning4j_tpu_torch.util.tree import leaves
from deeplearning4j_tpu_torch.zoo import models as tzoo
from test_torch_train import LOSS_RTOL, PARAM_TOL, _assert_trees_close

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# f32 forward: the JAX package's golden bar
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
# the bf16 compute policy against JAX's (each product rounded to bf16)
BF16_LOSS_RTOL = 2e-2
BF16_PARAM_TOL = dict(rtol=2e-2, atol=2e-4)


def _np(t):
    return t.detach().float().cpu().numpy()


def _no_dropout(jconf):
    for layer in jconf.layers:
        layer.dropout = 0.0
    return jconf


def _port_of(jnet, compute_dtype=None):
    """A port MLN on the CPU from a JAX MLN: its configuration through
    JSON, its params and states through params_from_jax."""
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, compute_dtype=compute_dtype,
                            device="cpu").init()
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    net.params, net.states = params_from_jax(
        tonp(jnet.params), tonp(jnet.states), device="cpu")
    return net


def _data(seed, shape, n_classes, rows=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows,) + tuple(shape)).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, rows)]
    return x, y


def _train_both(jnet, net, data, steps=3):
    for step in range(steps):
        x, y = data[step % len(data)]
        lj = float(jnet.fit_batch((x, y)))
        lt = float(net.fit_batch((x, y)))
        yield step, lj, lt


# ------------------------------------------------------------ golden file


def test_golden_mln_restores_in_port():
    """tests/fixtures/golden_mln.zip (conv, BN, pooling, dense, output, a
    CnnToFeedForward preprocessor, adam state) restores through the port
    and predicts the committed outputs at the JAX test's own bar."""
    net = restore_multi_layer_network(os.path.join(FIX, "golden_mln.zip"),
                                      device="cpu")
    exp = np.load(os.path.join(FIX, "golden_mln_expected.npz"))
    np.testing.assert_allclose(_np(net.output(exp["x"])), exp["y"],
                               **FWD_TOL)
    assert net.iteration == 3 and net.epoch == 1
    assert set(net.updater_states[0]) == {"m", "v"}
    assert isinstance(restore_model(os.path.join(FIX, "golden_mln.zip"),
                                    device="cpu"), MultiLayerNetwork)


# -------------------------------------------------------- configurations


ZOO = ("LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
       "TextGenerationLSTM")


@pytest.mark.parametrize("name", ZOO)
def test_zoo_list_configuration_json_matches_jax(name):
    """The port's zoo builds the JAX package's configuration, field for
    field (no net is built: VGG16 has 138M params)."""
    kw = dict(seed=7, updater="nesterovs", learning_rate=1e-2)
    ours = getattr(tzoo, name)(**kw).conf()
    theirs = getattr(jzoo, name)(**kw).conf()
    assert ours.to_json() == theirs.to_json()
    assert MultiLayerConfiguration.from_json(theirs.to_json()).to_json() \
        == theirs.to_json()


def _builder_confs(pkg):
    """One list configuration through every builder setter, built by
    the JAX package (pkg="jax") or the port."""
    if pkg == "jax":
        NNC, IT = JNNC, JInputType
        Conv, Pool, Dense, Drop, Out = JConv, JPool, JDense, JDropout, JOut
        LRN, ZP = JLRN, JZeroPad
    else:
        NNC, IT = NeuralNetConfiguration, InputType
        Conv, Pool, Dense, Drop, Out = (ConvolutionLayer, SubsamplingLayer,
                                        DenseLayer, DropoutLayer, OutputLayer)
        LRN, ZP = LocalResponseNormalization, ZeroPaddingLayer
    return (NNC.Builder().seed(3).updater("adam").learning_rate(0.02)
            .activation("tanh").weight_init("relu").dropout(0.1).l2(1e-4)
            .momentum(0.8).rho(0.9).epsilon(1e-7).adam_mean_decay(0.85)
            .adam_var_decay(0.99).rms_decay(0.9).minibatch(False)
            .optimization_algo("sgd").learning_rate_policy("step")
            .lr_policy_decay_rate(0.5).lr_policy_steps(10)
            .lr_policy_power(2.0).learning_rate_schedule({5: 0.01})
            .list()
            .layer(ZP(padding=(1, 2)))
            .layer(Conv(n_out=4, kernel_size=(3, 3)))
            .layer(LRN(n=3))
            .layer(Pool(kernel_size=(2, 2), stride=(2, 2)))
            .layer(Drop(dropout=0.3))
            .layer(Dense(n_out=8, l1=0.01))
            .layer(Out(n_out=3, loss="mcxent"))
            .set_input_type(IT.convolutional_flat(8, 8, 2))
            .build())


def test_list_builder_json_matches_jax_and_reads_it():
    theirs = _builder_confs("jax").to_json()
    assert _builder_confs("port").to_json() == theirs
    assert MultiLayerConfiguration.from_json(theirs).to_json() == theirs


def test_graph_builder_copies_the_training_setters():
    """The graph builder takes the builder's training setters onto its
    configuration, as the JAX package's does."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )

    def build(NNC, IT, Dense, Out):
        return (NNC.Builder().momentum(0.7).minibatch(False)
                .graph_builder().add_inputs("x")
                .add_layer("d", Dense(n_out=3), "x")
                .add_layer("out", Out(n_out=2), "d").set_outputs("out")
                .set_input_types(x=IT.feed_forward(4)).build())

    theirs = build(JNNC, JInputType, JDense, JOut).to_json()
    ours = build(NeuralNetConfiguration, InputType, DenseLayer, OutputLayer)
    assert ours.momentum == 0.7 and ours.minibatch is False
    assert ComputationGraphConfiguration.from_json(theirs).to_json() \
        == ours.to_json()


# ------------------------------------------------------ forward and train


def _zoo_pair(name, updater, input_shape, compute_dtype=None, lr=1e-3):
    kw = dict(updater=updater, learning_rate=lr, input_shape=input_shape)
    jconf = _no_dropout(getattr(jzoo, name)(**kw).conf())
    jnet = JMLN(jconf, compute_dtype=compute_dtype).init()
    return jnet, _port_of(jnet, compute_dtype)


CASES = [("LeNet", (28, 28, 1), 10), ("SimpleCNN", (16, 16, 3), 10)]


@pytest.mark.parametrize("updater", ["nesterovs", "adam"])
@pytest.mark.parametrize("name,shape,ncls", CASES,
                         ids=[c[0] for c in CASES])
def test_zoo_forward_and_train_steps_match_jax(name, shape, ncls, updater):
    """LeNet and SimpleCNN (at a reduced 16x16 input), dropout off, f32:
    the forward at the golden bar, then 3 train steps."""
    jnet, net = _zoo_pair(name, updater, shape)
    data = [_data(s, shape, ncls) for s in (1, 2, 3)]
    np.testing.assert_allclose(_np(net.output(data[0][0])),
                               np.asarray(jnet.output(data[0][0])),
                               **FWD_TOL)
    for step, lj, lt in _train_both(jnet, net, data):
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert net.iteration == jnet.iteration == 3
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.updater_states, net.updater_states, **PARAM_TOL)


def test_bf16_compute_policy_matches_jax():
    """LeNet under the bf16 compute policy with f32 master params."""
    jnet, net = _zoo_pair("LeNet", "nesterovs", (28, 28, 1),
                          compute_dtype="bfloat16")
    data = [_data(s, (28, 28, 1), 10) for s in (4, 5, 6)]
    np.testing.assert_allclose(_np(net.output(data[0][0])),
                               np.asarray(jnet.output(data[0][0])),
                               rtol=2e-2, atol=2e-3)
    for step, lj, lt in _train_both(jnet, net, data):
        np.testing.assert_allclose(lt, lj, rtol=BF16_LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert all(p.dtype == torch.float32 for p in leaves(net.params))
    _assert_trees_close(jnet.params, net.params, **BF16_PARAM_TOL)


def _narrow_vgg(NNC, IT, Conv, Pool, Dense, Out):
    """VGG's shape at narrow widths: two conv blocks, two dense layers."""
    b = (NNC.Builder().seed(5).updater("nesterovs").learning_rate(1e-2)
         .activation("relu").weight_init("relu").list())
    for n_convs, n_out in ((2, 8), (2, 16)):
        for _ in range(n_convs):
            b = b.layer(Conv(n_out=n_out, kernel_size=(3, 3),
                             convolution_mode="same"))
        b = b.layer(Pool(kernel_size=(2, 2), stride=(2, 2)))
    return (b.layer(Dense(n_out=32)).layer(Dense(n_out=32))
            .layer(Out(n_out=5, loss="mcxent"))
            .set_input_type(IT.convolutional(16, 16, 3)).build())


def test_narrow_vgg_trains_like_jax():
    jconf = _narrow_vgg(JNNC, JInputType, JConv, JPool, JDense, JOut)
    tconf = _narrow_vgg(NeuralNetConfiguration, InputType, ConvolutionLayer,
                        SubsamplingLayer, DenseLayer, OutputLayer)
    assert tconf.to_json() == jconf.to_json()
    jnet = JMLN(jconf).init()
    net = _port_of(jnet)
    data = [_data(s, (16, 16, 3), 5, rows=8) for s in (7, 8, 9)]
    for step, lj, lt in _train_both(jnet, net, data):
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)


# ------------------------------------------------------- AlexNet's layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrn_and_zero_padding_match_jax(rng, dtype):
    """LRN (channel-window sum of x^2) and zero padding against the JAX
    layers. f32 at 1e-6; bf16 at one bf16 ulp of the output (2^-8
    relative): the window sum and each scalar round at JAX's points."""
    x = rng.normal(size=(2, 5, 6, 7)).astype(np.float32) * 3
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2.0 ** -8, atol=1e-6)
    for jl, tl in ((JLRN(), LocalResponseNormalization()),
                   (JLRN(n=3, k=1.0, alpha=1e-2, beta=0.5),
                    LocalResponseNormalization(n=3, k=1.0, alpha=1e-2,
                                               beta=0.5))):
        ref = np.asarray(jl.apply({}, jx)[0].astype(jnp.float32))
        np.testing.assert_allclose(_np(tl.apply({}, tx)[0]), ref, **tol)
    for pad in ((1, 2), (0, 1, 2, 3)):
        ref = np.asarray(JZeroPad(padding=pad).apply({}, jx)[0]
                         .astype(jnp.float32))
        got = ZeroPaddingLayer(padding=pad).apply({}, tx)[0]
        np.testing.assert_array_equal(_np(got), ref)
        assert tuple(got.shape) == ref.shape


def test_alexnet_style_block_trains_like_jax():
    """An 11x11 stride-4 "same" conv, LRN, pooling and zero padding in
    one list, dropout off, 3 nesterovs steps."""
    def conf(NNC, IT, Conv, LRN, Pool, ZP, Dense, Out):
        return (NNC.Builder().seed(9).updater("nesterovs")
                .learning_rate(1e-3).activation("relu").weight_init("relu")
                .list()
                .layer(Conv(n_out=8, kernel_size=(11, 11), stride=(4, 4),
                            convolution_mode="same"))
                .layer(LRN())
                .layer(Pool(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ZP(padding=(1, 1)))
                .layer(Conv(n_out=8, kernel_size=(3, 3)))
                .layer(LRN())
                .layer(Dense(n_out=16))
                .layer(Out(n_out=4, loss="mcxent"))
                .set_input_type(IT.convolutional(36, 36, 3)).build())

    jnet = JMLN(conf(JNNC, JInputType, JConv, JLRN, JPool, JZeroPad, JDense,
                     JOut)).init()
    net = _port_of(jnet)
    assert net.conf.to_json() == conf(
        NeuralNetConfiguration, InputType, ConvolutionLayer,
        LocalResponseNormalization, SubsamplingLayer, ZeroPaddingLayer,
        DenseLayer, OutputLayer).to_json()
    data = [_data(s, (36, 36, 3), 4) for s in (10, 11, 12)]
    for step, lj, lt in _train_both(jnet, net, data):
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)


# ---------------------------------------------------------------- engine


def _lenet(**kw):
    return tzoo.LeNet(input_shape=(12, 12, 1), learning_rate=1e-3,
                      **kw).init_model(device="cpu")


def test_step_program_run_equals_fit_batch_bitwise():
    x, y = _data(13, (12, 12, 1), 10)
    a, b = _lenet(), _lenet()
    prog = StepProgram(a)
    for _ in range(2):
        prog.run(x, y)
        b.fit_batch((x, y))
    for p, q in zip(leaves(a.params) + leaves(a.updater_states),
                    leaves(b.params) + leaves(b.updater_states)):
        assert torch.equal(p, q)
    assert a.iteration == b.iteration == 2


def test_early_stopping_trainer_runs_an_mln(tmp_path):
    """EarlyStoppingTrainer end to end on an MLN (pipeline on, a file
    saver): the best model reloads as an MLN and rescores exactly."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(24, 12, 12, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 24)]
    held = [_data(15, (12, 12, 1), 10)]
    net = _lenet(updater="adam")
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
        model_saver=LocalFileModelSaver(tmp_path),
        score_calculator=DataSetLossCalculator(held),
        evaluate_every_n_epochs=1)
    res = EarlyStoppingTrainer(
        cfg, net, ListDataSetIterator(DataSet(x, y), batch_size=8,
                                      shuffle=True)).fit()
    assert res.total_epochs == 2 and net.iteration == 6
    best = res.best_model
    assert isinstance(best, MultiLayerNetwork)
    assert best.score(held[0]) == res.score_vs_epoch[res.best_model_epoch]
    mem = EarlyStoppingTrainer(
        EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(1)],
            model_saver=InMemoryModelSaver(),
            score_calculator=DataSetLossCalculator(held)),
        _lenet(), [(x[:8], y[:8])]).fit()
    assert mem.total_epochs == 1


def test_parallel_inference_serves_an_mln():
    """ParallelInference warms up from the MLN's input type and serves
    requests that equal a direct output."""
    net = _lenet()
    x = _data(16, (12, 12, 1), 10, rows=5)[0]
    pi = ParallelInference(net, batch_limit=4, pipeline_depth=0)
    try:
        assert pi.stats()["warmed_buckets"] == [1, 2, 4]
        got = [np.asarray(pi.output(x[i:i + 1])) for i in range(5)]
    finally:
        pi.shutdown()
    np.testing.assert_allclose(np.concatenate(got), _np(net.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_model_file_round_trips_with_jax(tmp_path):
    """A port-written MLN zip reads in the JAX package with the same
    outputs, and restores in the port bit for bit (updater state and
    iteration included)."""
    net = _lenet(updater="adam")
    x, y = _data(17, (12, 12, 1), 10)
    net.fit_batch((x, y))
    path = str(tmp_path / "mln.zip")
    write_model(net, path)
    jnet = JSerializer.restore_multi_layer_network(path)
    np.testing.assert_allclose(np.asarray(jnet.output(x)), _np(net.output(x)),
                               **FWD_TOL)
    back = restore_multi_layer_network(path, device="cpu")
    for p, q in zip(leaves(net.params) + leaves(net.updater_states),
                    leaves(back.params) + leaves(back.updater_states)):
        assert torch.equal(p, q)
    assert back.iteration == 1


def test_evaluate_matches_jax_evaluation():
    net = _lenet()
    data = [_data(s, (12, 12, 1), 10) for s in (18, 19)]
    ev = net.evaluate(data)
    ref = JEvaluation()
    for x, y in data:
        ref.eval(y, _np(net.output(x)))
    assert isinstance(ev, Evaluation)
    np.testing.assert_array_equal(ev.confusion.matrix, ref.confusion.matrix)
    assert ev.accuracy() == ref.accuracy() and ev.f1() == ref.f1()
    assert ev.stats() == ref.stats()


def test_unported_paths_name_their_queue():
    """The paths that raised until the slice that ported them: layerwise
    pretrain leaves a net without pretrain layers as it is, a line-search
    solver trains, and an unknown algorithm names the known ones."""
    net = _lenet()
    before = [t.clone() for t in leaves(net.params)]
    assert net.pretrain([_data(20, (12, 12, 1), 10)]) is net
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(net.params)))
    net.conf.optimization_algo = "lbfgs"
    assert np.isfinite(float(net.fit_batch(_data(20, (12, 12, 1), 10))))
    assert net.iteration == 1
    net.conf.optimization_algo = "newton"
    net._solver = None
    with pytest.raises(ValueError, match="Unknown optimization"):
        net.fit_batch(_data(20, (12, 12, 1), 10))
    assert "Total parameters" in net.summary()
    assert net.n_layers() == 6 and isinstance(net.get_layer(0),
                                              ConvolutionLayer)


def test_rnn_time_step_streams_the_zoo_text_model():
    """rnn_time_step (which raised before the recurrent slice) on the
    zoo's TextGenerationLSTM: one character at a time equals output() on
    the whole sequence at the JAX package's bar for it
    (tests/test_smoke.py: rtol 1e-4 / atol 1e-5); a feed-forward net
    streams as its plain output."""
    net = tzoo.TextGenerationLSTM(num_classes=7, input_shape=(9, 7)) \
        .init_model(device="cpu")
    rng = np.random.default_rng(21)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 9))]
    full = _np(net.output(x))
    steps = np.stack([_np(net.rnn_time_step(x[:, t])) for t in range(9)], 1)
    np.testing.assert_allclose(steps, full, rtol=1e-4, atol=1e-5)
    lenet = _lenet()
    img, _ = _data(22, (12, 12, 1), 10, rows=2)
    np.testing.assert_array_equal(_np(lenet.rnn_time_step(img)),
                                  _np(lenet.output(img)))
