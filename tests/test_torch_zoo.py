"""The port's graph zoo (GoogLeNet, InceptionResNetV1, FaceNetNN4Small2),
ModelSelector, pretrained loading, ModelGuesser and ImageNetLabels
against the JAX package, on the CPU.

The three graphs run at reduced input (64x64; FaceNet 32x32, as
tests/test_zoo.py does) with the JAX package's seeded weights carried
over. Tolerances: forward outputs in every helper mode at rtol 1e-5 /
atol 1e-6 in f32 (the JAX package's golden bar); one fit_batch in
float64 (the DropoutLayer's dropout set to 0 in both configurations) at
rtol 1e-10 on the loss and 1e-8 (rtol and atol) on every param, the
center-loss centers included, and the BatchNorm states: the step's math,
with float64 rounding."""

import copy
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer,
)
from deeplearning4j_tpu.zoo import ModelSelector as JSelector
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu.zoo.util import imagenet as jimagenet
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    CenterLossOutputLayer,
    DropoutLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from deeplearning4j_tpu_torch.zoo import (
    ImageNetLabels,
    ModelSelector,
    ZooType,
    decode_predictions,
)
from deeplearning4j_tpu_torch.zoo import models as tzoo
from test_torch_train import _assert_trees_close

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MODES = ("none", "fused", "pallas")
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_LOSS_RTOL = 1e-10
FIT_PARAM_TOL = dict(rtol=1e-8, atol=1e-8)
GRAPHS = {"GoogLeNet": 64, "InceptionResNetV1": 64, "FaceNetNN4Small2": 32}
_JAX = {}


def _np(t):
    return t.detach().float().cpu().numpy()


def _tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(name, seed=0, rows=2):
    hw = GRAPHS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, hw, hw, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, rows)]
    return x, y


def _jax_graph(name):
    """(conf, params, states, output on _batch) of the JAX package's
    seeded model, built once per module (dropout 0)."""
    if name not in _JAX:
        hw = GRAPHS[name]
        conf = getattr(jzoo, name)(num_classes=5,
                                   input_shape=(hw, hw, 3)).conf()
        for n in conf.nodes:
            if type(n.obj).__name__ == "DropoutLayer":
                n.obj.dropout = 0.0
        net = JGraph(conf).init()
        _JAX[name] = (conf, _tonp(net.params), _tonp(net.states),
                      np.asarray(net.output(_batch(name)[0])), net)
    return _JAX[name]


def _port(name, mode, dtype=torch.float32):
    conf, params, states = _jax_graph(name)[:3]
    tconf = ComputationGraphConfiguration.from_json(conf.to_json())
    tconf.helper_mode = mode
    net = ComputationGraph(tconf, dtype=dtype, device="cpu").init()
    net.params, net.states = params_from_jax(params, states, device="cpu",
                                             dtype=dtype)
    return net


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_zoo_configuration_json_matches_jax(name):
    hw = GRAPHS[name]
    kw = dict(num_classes=5, input_shape=(hw, hw, 3))
    ours = getattr(tzoo, name)(**kw).conf()
    theirs = getattr(jzoo, name)(**kw).conf()
    assert ours.to_json() == theirs.to_json()
    assert ComputationGraphConfiguration.from_json(
        theirs.to_json()).to_json() == ours.to_json()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_zoo_output_matches_jax(name, mode):
    net = _port(name, mode)
    want = _jax_graph(name)[3]
    np.testing.assert_allclose(_np(net.output(_batch(name)[0])), want,
                               **FWD_TOL)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_jax_written_zip_of_each_graph_loads_in_the_port(name, tmp_path):
    """The JAX package's model zip of each graph (its seeded weights,
    BatchNorm states and updater state) restores in the port, through
    restore_computation_graph and ModelGuesser, and predicts what JAX
    predicts at the golden bar."""
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_computation_graph,
    )

    path = str(tmp_path / f"{name}.zip")
    JSerializer.write_model(_jax_graph(name)[4], path)
    x, want = _batch(name)[0], _jax_graph(name)[3]
    for net in (restore_computation_graph(path, device="cpu"),
                ModelGuesser.load_model_guess(path, device="cpu")):
        assert isinstance(net, ComputationGraph)
        np.testing.assert_allclose(_np(net.output(x)), want, **FWD_TOL)


def _jax_f64(name):
    """The JAX package's model in float64 from the cached f32 weights (its
    updater state fresh, as after init)."""
    conf, params, states = _jax_graph(name)[:3]
    net = JGraph(copy.deepcopy(conf), dtype=jnp.float64)
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), t)
    net._rng = jax.random.PRNGKey(0)
    net.params, net.states = f64(params), f64(states)
    net._init_updaters()
    net.clear_rnn_state()
    return net


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_zoo_fit_batch_matches_jax(name, mode):
    """One fit_batch (nesterovs, the zoo default) against the JAX
    package's, both in float64 (f32 train-mode BatchNorm over GoogLeNet's
    last 2x2 stages amplifies rounding: its f32 losses differ by 1.6e-5,
    its float64 losses by 1e-14): the loss, every param (the
    CenterLossOutputLayer's centers included) and the BatchNorm running
    statistics, in every helper mode."""
    _, params, states = _jax_graph(name)[:3]
    x, y = _batch(name, seed=1)
    with jax.enable_x64(True):
        jnet = _jax_f64(name)
        lj = float(jnet.fit_batch(([x.astype(np.float64)],
                                   [y.astype(np.float64)])))
        jparams, jstates = _tonp(jnet.params), _tonp(jnet.states)
    net = _port(name, mode, dtype=torch.float64)
    lt = float(net.fit_batch(([x], [y])))
    np.testing.assert_allclose(lt, lj, rtol=FIT_LOSS_RTOL)
    _assert_trees_close(jparams, net.params, **FIT_PARAM_TOL)
    _assert_trees_close(jstates, net.states, **FIT_PARAM_TOL)
    out = net.conf.network_outputs[0]
    if isinstance(net.conf.node(out).obj, CenterLossOutputLayer):
        # the centers (zero at init) moved with the step, as JAX's do
        assert np.abs(_np(net.params[out]["centers"])).max() > 0


def test_googlenet_dropout_layer_and_embeddings():
    """GoogLeNet keeps its DropoutLayer(0.4) before the head; the
    embedding nets' L2NormalizeVertex rows have norm 1."""
    conf = tzoo.GoogLeNet(num_classes=5, input_shape=(64, 64, 3)).conf()
    drops = [n.obj for n in conf.nodes if isinstance(n.obj, DropoutLayer)]
    assert [d.dropout for d in drops] == [0.4]
    net = _port("FaceNetNN4Small2", "pallas")
    emb = net.feed_forward(_batch("FaceNetNN4Small2")[0])["embeddings"]
    np.testing.assert_allclose(np.linalg.norm(_np(emb), axis=1), 1.0,
                               rtol=1e-6)


def test_center_loss_under_the_bf16_policy_matches_jax(rng):
    """The embedding nets' head under the bf16 policy: bf16 features and
    centers, f32 labels, promoted as jnp's matmul promotes them (rtol
    2e-2: the features and centers are bf16)."""
    from deeplearning4j_tpu.nn.layers import (
        CenterLossOutputLayer as JCenterLoss,
    )

    x = rng.normal(size=(6, 8)).astype(np.float32)
    lab = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    p = {"W": rng.normal(size=(8, 4)).astype(np.float32),
         "b": rng.normal(size=4).astype(np.float32),
         "centers": rng.normal(size=(4, 8)).astype(np.float32)}
    kw = dict(n_in=8, n_out=4, loss="mcxent", lambda_=0.5, alpha=0.3)
    want = JCenterLoss(**kw).per_example_loss_from_input(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(lab))
    got = CenterLossOutputLayer(**kw).per_example_loss_from_input(
        {k: torch.from_numpy(v).bfloat16() for k, v in p.items()},
        torch.from_numpy(x).bfloat16(), torch.from_numpy(lab))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2)


# ------------------------------------------------------- zoo helpers


def test_model_selector_registries_match_jax():
    ours, theirs = ModelSelector.registry(), JSelector.registry()
    assert {k: v.__name__ for k, v in ours.items()} == \
        {k: v.__name__ for k, v in theirs.items()}
    for kind in (ZooType.ALL, ZooType.CNN, ZooType.RNN, ZooType.VGG16):
        got = ModelSelector.select(kind, num_classes=3)
        want = JSelector.select(kind, num_classes=3)
        assert {k: type(v).__name__ for k, v in got.items()} == \
            {k: type(v).__name__ for k, v in want.items()}
        assert all(m.num_classes == 3 for m in got.values())
    with pytest.raises(ValueError, match="Unknown zoo type"):
        ModelSelector.select("nope")


def _jax_lenet_zip(tmp_path):
    """A JAX-written LeNet model zip named as the pretrained lookup
    expects, and the JAX net's output on a seeded batch."""
    net = jzoo.LeNet(num_classes=4, input_shape=(12, 12, 1)).init_model()
    path = tmp_path / "lenet.zip"
    JSerializer.write_model(net, str(path))
    x = np.random.default_rng(2).normal(size=(3, 12, 12, 1)).astype(
        np.float32)
    return str(path), x, np.asarray(net.output(x))


def test_load_pretrained_reads_a_jax_written_zip(tmp_path, monkeypatch):
    path, x, want = _jax_lenet_zip(tmp_path)
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    model = tzoo.LeNet(num_classes=4, input_shape=(12, 12, 1))
    assert model.pretrained_available() and model.pretrained_path() == path
    net = model.load_pretrained(device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    np.testing.assert_allclose(_np(net.output(x)), want, **FWD_TOL)
    assert not tzoo.VGG16().pretrained_available()


def test_init_pretrained_checks_the_md5(tmp_path, monkeypatch):
    path, x, want = _jax_lenet_zip(tmp_path)
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    with open(path, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()

    class Good(tzoo.LeNet):
        PRETRAINED = {"imagenet": ("https://example.invalid/l.zip", md5)}

    class Bad(tzoo.LeNet):
        PRETRAINED = {"imagenet": ("https://example.invalid/l.zip", "0")}

    kw = dict(num_classes=4, input_shape=(12, 12, 1))
    good = Good(**kw)
    assert good.pretrained_checksum() == md5
    assert good.pretrained_url() == "https://example.invalid/l.zip"
    net = good.init_pretrained(path=path, device="cpu")
    np.testing.assert_allclose(_np(net.output(x)), want, **FWD_TOL)
    with pytest.raises(IOError, match="checksum mismatch"):
        Bad(**kw).init_pretrained(path=path, device="cpu")
    assert not os.path.exists(path)      # the corrupt file is removed
    with pytest.raises(FileNotFoundError, match="example.invalid"):
        Good(**kw).init_pretrained(device="cpu")


def test_model_guesser_loads_the_golden_zips_and_a_json_config(tmp_path):
    mln = ModelGuesser.load_model_guess(os.path.join(FIX, "golden_mln.zip"),
                                        device="cpu")
    exp = np.load(os.path.join(FIX, "golden_mln_expected.npz"))
    assert isinstance(mln, MultiLayerNetwork)
    np.testing.assert_allclose(_np(mln.output(exp["x"])), exp["y"],
                               **FWD_TOL)
    graph = ModelGuesser.load_model_guess(
        os.path.join(FIX, "golden_graph.zip"), device="cpu")
    exp = np.load(os.path.join(FIX, "golden_graph_expected.npz"))
    assert isinstance(graph, ComputationGraph)
    np.testing.assert_allclose(_np(graph.output(exp["x"])), exp["y"],
                               **FWD_TOL)
    for kind, conf, cls in (
            ("list", jzoo.LeNet().conf(), MultiLayerConfiguration),
            ("graph", jzoo.FaceNetNN4Small2().conf(),
             ComputationGraphConfiguration)):
        p = tmp_path / f"{kind}.json"
        p.write_text(conf.to_json())
        got = ModelGuesser.load_model_guess(str(p))
        assert isinstance(got, cls) and got.to_json() == conf.to_json()
        again = ModelGuesser.load_config_guess_dict(json.loads(p.read_text()))
        assert again.to_json() == conf.to_json()


def _class_index(tmp_path, n=12):
    idx = {str(i): [f"n{i:08d}", f"class_{i}"] for i in range(n)}
    p = tmp_path / "imagenet_class_index.json"
    p.write_text(json.dumps(idx))
    return str(p)


def test_imagenet_labels_decode_like_jax(tmp_path):
    src = _class_index(tmp_path)
    probs = np.random.default_rng(5).dirichlet(np.ones(12), size=3).astype(
        np.float32)
    ours, theirs = ImageNetLabels(src), jimagenet.ImageNetLabels(src)
    assert len(ours) == len(theirs) == 12
    assert ours.get_label(7) == theirs.get_label(7) == "class_7"
    assert ours.get_wnid(3) == theirs.get_wnid(3)
    assert ours.decode_predictions(probs, top=4) == \
        theirs.decode_predictions(probs, top=4)
    assert ours.decode_predictions_str(probs, top=3) == \
        theirs.decode_predictions_str(probs, top=3)
    assert ours.decodePredictions(probs[0]) == \
        theirs.decodePredictions(probs[0])
    assert decode_predictions(torch.from_numpy(probs), top=2, source=src) \
        == jimagenet.decode_predictions(probs, top=2, source=src)
    with pytest.raises(ValueError, match="classes"):
        decode_predictions(probs[:, :5], source=src)
    with pytest.raises(FileNotFoundError):
        ImageNetLabels(str(tmp_path / "missing.json"))


def test_util_package_matches_jax(rng):
    """The rest of util/*: the time-series and convolution helpers of
    nn_utils against the JAX package's (exact: reshapes, sums of a few
    f32 values in the same order, integer geometry) and the
    ModelSerializer facade."""
    from deeplearning4j_tpu import util as jutil
    from deeplearning4j_tpu_torch import util as tutil

    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tutil.moving_average(torch.from_numpy(x), 3)),
        np.asarray(jutil.moving_average(x, 3)), rtol=1e-6, atol=1e-6)
    flat = tutil.reshape_3d_to_2d(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(flat),
                                  np.asarray(jutil.reshape_3d_to_2d(x)))
    np.testing.assert_array_equal(_np(tutil.reshape_2d_to_3d(flat, 3)), x)
    for args in [((7, 9), (3, 3), (2, 2), (1, 1)),
                 ((28, 28), (5, 5), (1, 1), (0, 0)),
                 ((13, 8), (3, 2), (2, 3), (1, 0))]:
        for same in (False, True):
            assert tutil.get_output_size(*args, same_mode=same) == \
                jutil.get_output_size(*args, same_mode=same)
        out = tutil.get_output_size(*args, same_mode=True)
        geo = (out, args[0], args[1], args[2])
        assert tutil.get_same_mode_top_left_padding(*geo) == \
            jutil.get_same_mode_top_left_padding(*geo)
        assert tutil.get_same_mode_bottom_right_padding(*geo) == \
            jutil.get_same_mode_bottom_right_padding(*geo)
    with pytest.raises(ValueError, match="stride"):
        tutil.validate_cnn_kernel_stride_padding((3, 3), (0, 1), (0, 0))
    assert tutil.ModelSerializer.restoreMultiLayerNetwork is \
        tutil.restore_multi_layer_network
    assert tutil.ModelGuesser is ModelGuesser
