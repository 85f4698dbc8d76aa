"""The port's Keras importer (deeplearning4j_tpu_torch/modelimport/) on the
CPU, against the generating Keras models' outputs and against the JAX
package's importer on the same files.

Bars: Keras's own predictions (`*_expected.npz`) at rtol 1e-4 / atol
1e-5, tests/test_modelimport.py's; the JAX importer's outputs at rtol
1e-5 / atol 1e-6, the port's forward bar against the JAX package. The
keras_resblock fixture (a conv -> BN -> relu -> add block with conv bias,
BN epsilon 1.001e-5 and a ZeroPadding2D stem, as Keras ResNet50 builds
them) runs in every helper mode, the "pallas" mode on the kernels' plain
versions, so the fused planner is held on an imported graph."""

import glob
import json
import os

import h5py
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import KerasModelImport as JImport
from deeplearning4j_tpu_torch.modelimport import (
    KerasImportError,
    KerasModelImport,
    register_custom_layer,
    unregister_custom_layer,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
FIXTURES = sorted(glob.glob(os.path.join(FIX, "*.h5"))
                  + glob.glob(os.path.join(FIX, "torch", "*.h5")))
KERAS_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("none", "fused", "pallas")
RESBLOCK = os.path.join(FIX, "torch", "keras_resblock.h5")


def _expected(path):
    return np.load(path.replace(".h5", "_expected.npz"))


def _out(net, x):
    return net.output(x).detach().numpy()


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_fixture_matches_keras_and_the_jax_importer(path):
    net = KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    jnet = JImport.import_keras_model_and_weights(path)
    assert type(net).__name__ == type(jnet).__name__
    exp = _expected(path)
    out = _out(net, exp["x"])
    np.testing.assert_allclose(out, exp["y"], **KERAS_TOL)
    np.testing.assert_allclose(out, np.asarray(jnet.output(exp["x"])),
                               **JAX_TOL)
    assert net.conf.to_json() == jnet.conf.to_json()


@pytest.mark.parametrize("mode", MODES)
def test_resblock_in_every_helper_mode(mode):
    net = KerasModelImport.import_keras_model_and_weights(RESBLOCK,
                                                          device="cpu")
    assert isinstance(net, ComputationGraph) and not net.conf.helper_mode
    net.conf.helper_mode = mode
    exp = _expected(RESBLOCK)
    out = _out(net, exp["x"])
    np.testing.assert_allclose(out, exp["y"], **KERAS_TOL)
    jout = np.asarray(JImport.import_keras_model_and_weights(
        RESBLOCK).output(exp["x"]))
    np.testing.assert_allclose(out, jout, **JAX_TOL)
    plan = net._helper_plan()
    if mode == "none":
        assert plan is None
    else:
        # the stem conv and the block's four, each feeding a BatchNorm
        assert len(plan.conv) == 5
        assert plan.impl == ("pallas" if mode == "pallas" else "xla")


def test_resblock_follows_the_helpers_environment(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_HELPERS", "fused")
    net = KerasModelImport.import_keras_model_and_weights(RESBLOCK,
                                                          device="cpu")
    assert net._helper_plan() is not None


def test_imported_weights_are_the_files_bits():
    """Every weight lands in the port's params unchanged (the BatchNorm
    moving statistics in the states)."""
    net = KerasModelImport.import_keras_model_and_weights(RESBLOCK,
                                                          device="cpu")
    names = {"kernel": "W", "bias": "b", "gamma": "gamma", "beta": "beta"}
    n = 0
    with h5py.File(RESBLOCK, "r") as f:
        mw = f["model_weights"]
        for layer in mw:
            for wn in mw[layer].attrs["weight_names"]:
                wn = wn.decode() if isinstance(wn, bytes) else wn
                leaf = wn.split("/")[-1].split(":")[0]
                want = mw[layer][wn][()]
                if leaf in names:
                    got = net.params[layer][names[leaf]]
                else:
                    got = net.states[layer][{"moving_mean": "mean",
                                             "moving_variance": "var"}[leaf]]
                assert got.numpy().tobytes() == want.tobytes(), wn
                n += 1
    assert n == 5 * 2 + 5 * 4 + 2    # convs, BatchNorms, the head


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelImport.import_keras_model_and_weights(RESBLOCK)
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelImport.import_keras_sequential_model_and_weights(
            os.path.join(FIX, "seq_cnn.h5"))


def test_compute_dtype_is_taken():
    net = KerasModelImport.import_keras_model_and_weights(
        RESBLOCK, device="cpu", compute_dtype=torch.bfloat16)
    exp = _expected(RESBLOCK)
    out = net.output(exp["x"])
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - exp["y"]).max() < 0.05


def test_config_only_import_matches_jax():
    path = os.path.join(FIX, "seq_cnn.h5")
    conf = KerasModelImport.import_keras_model_configuration(path)
    # conv, pool, bn, dense, dropout, output (flatten dropped)
    assert len(conf.layers) == 6
    js = conf.to_json()
    assert js == JImport.import_keras_model_configuration(path).to_json()
    from deeplearning4j_tpu_torch.nn.conf.network import (
        MultiLayerConfiguration,
    )
    assert MultiLayerConfiguration.from_json(js).to_json() == js
    gconf = KerasModelImport.import_keras_model_configuration(RESBLOCK)
    assert gconf.to_json() == JImport.import_keras_model_configuration(
        RESBLOCK).to_json()


@pytest.mark.parametrize("name", ["keras_vgg16", "keras_resnet50"])
def test_full_width_configs_build_like_jax(name, tmp_path):
    """The committed tf.keras application configs (VGG16, ResNet50)
    import to the JAX importer's configuration; ResNet50's "pallas" plan
    routes 30 1x1 and 16 3x3 convs to the kernels."""
    with open(os.path.join(FIX, "torch", f"{name}_config.json")) as f:
        text = f.read()
    path = tmp_path / f"{name}.h5"
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = text
    conf = KerasModelImport.import_keras_model_configuration(str(path))
    assert conf.to_json() == JImport.import_keras_model_configuration(
        str(path)).to_json()
    if name == "keras_resnet50":
        from deeplearning4j_tpu_torch.nn.helpers.fused_graph import (
            build_plan,
        )
        from deeplearning4j_tpu_torch.nn.helpers.fused_ops import (
            kernel_route,
        )

        types = conf.resolve_shapes(return_layer_inputs=True)[1]
        plan = build_plan(conf.topological_order(), conf.network_outputs,
                          impl="pallas")
        routes = [kernel_route(conf.node(n).obj.kernel_size, s.stride,
                               s.padding, (types[n].height, types[n].width))
                  for n, s in plan.conv.items()]
        assert (routes.count("conv1x1"), routes.count("conv3x3"),
                len(routes)) == (30, 16, 53)


def test_imported_model_fine_tunes():
    """BASELINE config #4 shape: import -> TransferLearning freeze + head
    replace -> fit (ref TransferLearning.java:62)."""
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration,
        TransferLearning,
    )

    net = KerasModelImport.import_keras_sequential_model_and_weights(
        os.path.join(FIX, "seq_cnn.h5"), device="cpu")
    rng = np.random.default_rng(0)
    n, C = 64, 3
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, C, n)
    x[np.arange(n), 2 + labels, 3, 0] += 3.0
    y = np.eye(C, dtype=np.float32)[labels]

    ft = (TransferLearning.Builder(net)
          .fine_tune_configuration(FineTuneConfiguration.Builder()
                                   .updater("adam").learning_rate(5e-3)
                                   .build())
          .set_feature_extractor(2)       # freeze conv/pool/bn
          .n_out_replace(5, C)            # new 3-way head
          .build())
    ft.fit([(x, y)])
    l0 = float(ft.score())
    for _ in range(60):
        ft.fit([(x, y)])
    assert float(ft.score()) < l0 * 0.5
    assert torch.equal(ft.params[0]["W"], net.params[0]["W"])


def test_imported_model_gradient_checks():
    """The imported graph is differentiable end to end: the imported
    configuration at float64 with the imported weights passes the
    central-difference check."""
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients

    net = KerasModelImport.import_keras_model_and_weights(
        os.path.join(FIX, "func_merge.h5"), device="cpu")
    net64 = ComputationGraph(net.conf, dtype=torch.float64,
                             device="cpu").init()
    net64.params = {k: {n: t.double() for n, t in v.items()}
                    for k, v in net.params.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6))
    y = np.eye(3)[rng.integers(0, 3, 4)]
    assert check_gradients(net64, x, y)


def _write_config(path, layers, weights=None):
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps({
            "class_name": "Sequential", "config": {"layers": layers}})
        for layer, ws in (weights or {}).items():
            g = f.require_group("model_weights").create_group(layer)
            for k, a in ws.items():
                g.create_dataset(k, data=a)


def test_unsupported_layer_raises(tmp_path):
    path = tmp_path / "bad.h5"
    _write_config(path, [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, 4]}},
        {"class_name": "Lambda", "config": {"name": "lam"}}])
    with pytest.raises(KerasImportError, match="Lambda"):
        KerasModelImport.import_keras_model_and_weights(str(path),
                                                        device="cpu")


def test_channels_first_rejected(tmp_path):
    path = tmp_path / "cf.h5"
    _write_config(path, [
        {"class_name": "InputLayer",
         "config": {"batch_shape": [None, 3, 8, 8]}},
        {"class_name": "Conv2D",
         "config": {"name": "c", "filters": 4, "kernel_size": [3, 3],
                    "data_format": "channels_first"}}])
    with pytest.raises(KerasImportError, match="channels_last"):
        KerasModelImport.import_keras_model_and_weights(str(path),
                                                        device="cpu")


def test_sequential_final_lstm_clear_error(tmp_path):
    path = tmp_path / "seq_lstm.h5"
    _write_config(path, [
        {"class_name": "InputLayer",
         "config": {"batch_shape": [None, 5, 4]}},
        {"class_name": "LSTM",
         "config": {"name": "l", "units": 6, "return_sequences": False}}])
    with pytest.raises(KerasImportError, match="functional"):
        KerasModelImport.import_keras_sequential_model_and_weights(
            str(path), device="cpu")


def test_not_a_whole_model_file_raises(tmp_path):
    path = tmp_path / "weights_only.h5"
    with h5py.File(path, "w") as f:
        f.create_group("model_weights")
    with pytest.raises(KerasImportError, match="model_config"):
        KerasModelImport.import_keras_model_and_weights(str(path),
                                                        device="cpu")


def test_lrn_builtin_custom_mapping_predictions_match():
    from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization

    path = os.path.join(FIX, "lrn_cnn.h5")
    net = KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    lrn = next(l for l in net.conf.layers
               if isinstance(l, LocalResponseNormalization))
    assert lrn.n == 5 and abs(lrn.k - 1.5) < 1e-9
    exp = _expected(path)
    np.testing.assert_allclose(_out(net, exp["x"]), exp["y"], **KERAS_TOL)


def test_register_custom_layer_hook(tmp_path):
    """The KerasLayer.registerCustomLayer role: an unknown class raises
    with a registration hint; a mapper (plus a weight_mapper) imports it;
    unregistering restores the error."""
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer

    path = tmp_path / "custom.h5"
    rng = np.random.default_rng(5)
    K1 = rng.normal(size=(3, 4)).astype(np.float32)
    K2 = rng.normal(size=(4, 2)).astype(np.float32)
    b2 = rng.normal(size=(2,)).astype(np.float32)
    _write_config(path, [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, 3]}},
        {"class_name": "ScaledDense",
         "config": {"name": "sd1", "units": 4, "scale": 2.0}},
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 2, "activation": "linear"}}],
        {"sd1": {"kernel:0": K1}, "d1": {"kernel:0": K2, "bias:0": b2}})

    def load():
        return KerasModelImport.import_keras_model_and_weights(str(path),
                                                               device="cpu")

    with pytest.raises(KerasImportError, match="register_custom_layer"):
        load()

    def map_scaled_dense(cfg, *, is_output, loss):
        return DenseLayer(n_out=int(cfg["units"]), activation="identity")

    def weights_scaled_dense(layer, w):
        # the custom class folds its config 'scale' into the kernel
        return ({"W": w["kernel"] * 2.0,
                 "b": np.zeros((w["kernel"].shape[1],))}, None)

    register_custom_layer("ScaledDense", map_scaled_dense,
                          weights_scaled_dense)
    try:
        x = rng.normal(size=(6, 3)).astype(np.float32)
        np.testing.assert_allclose(_out(load(), x), (x @ (K1 * 2.0)) @ K2
                                   + b2, **KERAS_TOL)
    finally:
        unregister_custom_layer("ScaledDense")
    with pytest.raises(KerasImportError, match="ScaledDense"):
        load()


def test_weight_shape_mismatch_raises(tmp_path):
    path = tmp_path / "mismatch.h5"
    _write_config(path, [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, 3]}},
        {"class_name": "Dense",
         "config": {"name": "d1", "units": 2, "activation": "linear"}}],
        {"d1": {"kernel:0": np.zeros((4, 2), np.float32)}})
    with pytest.raises(KerasImportError, match="shape mismatch"):
        KerasModelImport.import_keras_model_and_weights(str(path),
                                                        device="cpu")
