"""Keras HDF5 model importer (counterpart of
deeplearning4j_tpu/modelimport/keras.py).

Parity: deeplearning4j-modelimport
(nn/modelimport/keras/KerasModelImport.java:48-119 — entry points;
KerasModel.java / KerasSequentialModel.java — config+weights mapping;
KerasLayer.java — the supported layer-type table; Hdf5Archive.java — the
HDF5 reader, here the port's own `modelimport/hdf5.py`, so no h5py is
needed).

Reads whole-model HDF5 files (`model.save("m.h5")`): the `model_config`
JSON attribute, the `model_weights/` groups and, when present,
`training_config` for the loss. It follows each layer group's
`weight_names` attribute, or else walks the group's datasets, so both
the Keras 2 and the Keras 3 weight paths load.

The mapping tables are the JAX module's: InputLayer, Dense, Conv2D,
Conv1D, MaxPooling2D, AveragePooling2D, the global poolings, Flatten (the
NHWC CnnToFeedForwardPreProcessor is the identity case), Dropout,
Activation, BatchNormalization, Embedding, LSTM (gate blocks keras [i, f,
g, o] -> [i, f, o, g]), ZeroPadding2D, the merge layers of functional
graphs, the loss from training_config; LRN through the built-in custom
mapping, and any other class through `register_custom_layer`. Layouts
need no transposition: the port is NHWC with HWIO kernels, as
TensorFlow's channels_last. channels_first models are rejected.

Entry points take `device` (None means "cuda"; without a GPU they raise
unless device="cpu" is passed) and `compute_dtype`, as the port's
`restore_model` does. The helper mode of an imported graph follows the
port's rule: the configuration's `helper_mode` (empty after import), or
else DL4J_TPU_HELPERS.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport import hdf5
from deeplearning4j_tpu_torch.modelimport.hdf5 import KerasImportError
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex,
    LastTimeStepVertex,
    MergeVertex,
    PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    ActivationLayer,
    BatchNormalization,
    Convolution1DLayer,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    LocalResponseNormalization,
    OutputLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.tree import tree_map

__all__ = ["KerasImportError", "KerasModelImport", "register_custom_layer",
           "unregister_custom_layer"]

_ACTIVATIONS = {
    "linear": "identity",
    "relu": "relu",
    "relu6": "relu6",
    "elu": "elu",
    "selu": "selu",
    "tanh": "tanh",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
    "swish": "swish",
    "silu": "swish",
    "gelu": "gelu",
    "leaky_relu": "leakyrelu",
    "mish": "mish",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse",
    "mse": "mse",
    "mean_absolute_error": "mae",
    "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge",
    "squared_hinge": "squared_hinge",
    "poisson": "poisson",
    "kullback_leibler_divergence": "kl_divergence",
    "kl_divergence": "kl_divergence",
    "cosine_proximity": "cosine_proximity",
}


def _map_activation(name) -> str:
    if name is None:
        return "identity"
    if isinstance(name, dict):   # serialized Activation object
        name = name.get("class_name", "linear")
    key = str(name).lower()
    if key not in _ACTIVATIONS:
        raise KerasImportError(
            f"Unsupported Keras activation '{name}'. "
            f"Supported: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


def _map_loss(name) -> Optional[str]:
    if name is None:
        return None
    if isinstance(name, dict):
        name = (name.get("config") or {}).get("name") or name.get(
            "class_name", "")
    return _LOSSES.get(str(name).lower())


def _check_channels_last(cfg: dict, cls: str):
    df = cfg.get("data_format", "channels_last")
    if df not in (None, "channels_last"):
        raise KerasImportError(
            f"{cls}: data_format='{df}' (Theano/channels_first ordering) "
            "is not supported; re-save the model with channels_last")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1] if len(v) > 1 else v[0])
    return int(v), int(v)


def _input_type_from_shape(shape) -> InputType:
    """batch_shape/batch_input_shape (leading None) -> InputType."""
    dims = list(shape[1:])
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(int(h), int(w), int(c))
    if len(dims) == 2:
        t, f = dims
        return InputType.recurrent(int(f), None if t is None else int(t))
    if len(dims) == 1:
        return InputType.feed_forward(int(dims[0]))
    raise KerasImportError(f"Unsupported Keras input shape {shape}")


# --------------------------------------------------------------------- HDF5

def _text(raw) -> str:
    return raw.decode("utf-8") if isinstance(raw, bytes) else str(raw)


def _read_archive(path: str):
    """(model_config, {layer: {weight: array}}, training_config) of a
    whole-model Keras file, read through the port's HDF5 reader."""
    with hdf5.File(path) as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise KerasImportError(
                f"{path}: no model_config attr — not a whole-model Keras "
                "HDF5 file (weights-only files need the architecture too)")
        model_config = json.loads(_text(raw))
        tc = f.attrs.get("training_config")
        training_config = None if tc is None else json.loads(_text(tc))

        weights: Dict[str, Dict[str, np.ndarray]] = {}
        mw = f.get("model_weights", f)   # some files are rooted at /
        for lname in mw:
            grp = mw[lname]
            if not isinstance(grp, hdf5.Group):
                continue
            found: Dict[str, np.ndarray] = {}
            wnames = grp.attrs.get("weight_names")
            if wnames is not None and len(wnames):
                for wn in wnames:
                    wn = _text(wn)
                    ds = grp.get(wn) or f.get(wn) or mw.get(wn)
                    if ds is not None:
                        leaf = wn.split("/")[-1].split(":")[0]
                        found[leaf] = np.asarray(ds)
            else:
                def walk(g):
                    for k in g:
                        it = g[k]
                        if isinstance(it, hdf5.Dataset):
                            found[k.split(":")[0]] = np.asarray(it)
                        else:
                            walk(it)
                walk(grp)
            if found:
                weights[lname] = found
    return model_config, weights, training_config


# ----------------------------------------------------------- layer mapping

# Custom-layer registration (the KerasLayer.registerCustomLayer role —
# KerasLayer.java:261 throws on unknown types unless a custom mapping
# was registered; the reference ships KerasLRN/KerasPoolHelper as
# built-in customs for Caffe-converted models).
_CUSTOM_LAYERS: Dict[str, Tuple[Any, Any]] = {}


def register_custom_layer(class_name: str, mapper,
                          weight_mapper=None) -> None:
    """Register an import mapping for a custom Keras layer class.

    mapper(cfg, is_output=..., loss=...) must return a port layer (or
    'flatten' / None skip markers, like _map_layer). Optional
    weight_mapper(layer, weights_dict) -> (params, state), trees of
    arrays or tensors, overrides the built-in weight copy for layers the
    mapper returns."""
    _CUSTOM_LAYERS[class_name] = (mapper, weight_mapper)


def unregister_custom_layer(class_name: str) -> None:
    _CUSTOM_LAYERS.pop(class_name, None)


def _map_lrn(cfg: dict, *, is_output: bool, loss: Optional[str]):
    """Built-in custom mapping for LRN layers from Caffe-converted
    models (the KerasLRN role). Accepts both Caffe-ish (k/n/alpha/beta)
    and tf.nn.local_response_normalization (bias/depth_radius) naming."""
    if "n" in cfg:
        n = int(cfg["n"])            # full window (Caffe naming)
    elif "depth_radius" in cfg:
        n = 2 * int(cfg["depth_radius"]) + 1   # radius -> window
    else:
        n = 5
    return LocalResponseNormalization(
        k=float(cfg.get("k", cfg.get("bias", 2.0))),
        n=n,
        alpha=float(cfg.get("alpha", 1e-4)),
        beta=float(cfg.get("beta", 0.75)))


register_custom_layer("LRN", _map_lrn)
register_custom_layer("LocalResponseNormalization", _map_lrn)


def _map_layer(cls: str, cfg: dict, *, is_output: bool, loss: Optional[str]):
    """Return a port layer, 'flatten' (skip marker), or None (skip).

    Ref: the per-type Keras*.java mapping classes
    (KerasDense.java, KerasConvolution.java, KerasLstm.java, ...)."""
    if cls == "Dense":
        act = _map_activation(cfg.get("activation"))
        if is_output:
            return OutputLayer(n_out=int(cfg["units"]), activation=act,
                               loss=loss or "mcxent")
        return DenseLayer(n_out=int(cfg["units"]), activation=act)
    if cls in ("Conv2D", "Convolution2D"):
        _check_channels_last(cfg, cls)
        kh, kw = _pair(cfg.get("kernel_size", 3))
        sh, sw = _pair(cfg.get("strides", 1))
        same = cfg.get("padding", "valid") == "same"
        dh, dw = _pair(cfg.get("dilation_rate", 1))
        return ConvolutionLayer(
            n_out=int(cfg["filters"]), kernel_size=(kh, kw),
            stride=(sh, sw), dilation=(dh, dw),
            convolution_mode="same" if same else "truncate",
            padding=(0, 0),
            activation=_map_activation(cfg.get("activation")))
    if cls in ("Conv1D", "Convolution1D"):
        _check_channels_last(cfg, cls)
        pad = cfg.get("padding", "valid")
        if pad == "causal":
            raise KerasImportError(
                "Conv1D padding='causal' is not supported (no "
                "reference counterpart; pre-pad with ZeroPadding1D)")
        d = cfg.get("dilation_rate", 1)
        d = d[0] if isinstance(d, (list, tuple)) else d
        if int(d) != 1 or int(cfg.get("groups", 1)) != 1:
            raise KerasImportError(
                "Conv1D with dilation_rate/groups != 1 has no "
                "Convolution1DLayer counterpart")
        k = cfg.get("kernel_size", 3)
        k = int(k[0]) if isinstance(k, (list, tuple)) else int(k)
        s = cfg.get("strides", 1)
        s = int(s[0]) if isinstance(s, (list, tuple)) else int(s)
        return Convolution1DLayer(
            n_out=int(cfg["filters"]), kernel_size=k, stride=s,
            convolution_mode="same" if pad == "same" else "truncate",
            padding=0,
            activation=_map_activation(cfg.get("activation")))
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        _check_channels_last(cfg, cls)
        kh, kw = _pair(cfg.get("pool_size", 2))
        sh, sw = _pair(cfg.get("strides") or (kh, kw))
        same = cfg.get("padding", "valid") == "same"
        return SubsamplingLayer(
            pooling_type="max" if cls.startswith("Max") else "avg",
            kernel_size=(kh, kw), stride=(sh, sw),
            convolution_mode="same" if same else "truncate")
    if cls in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
               "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        return GlobalPoolingLayer(
            pooling_type="max" if "Max" in cls else "avg")
    if cls == "Flatten":
        return "flatten"
    if cls == "Dropout":
        return DropoutLayer(dropout=float(cfg.get("rate", 0.5)))
    if cls == "Activation":
        return ActivationLayer(
            activation=_map_activation(cfg.get("activation")))
    if cls == "BatchNormalization":
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)) and len(axis) == 1:
            axis = axis[0]
        if axis not in (-1, 3):
            # the port normalizes the trailing (channel) axis; a non-last
            # axis is the channels_first BN layout
            raise KerasImportError(
                f"BatchNormalization axis={axis} is not the trailing "
                "axis (channels_first layout?); only channels_last "
                "models are supported")
        return BatchNormalization(
            eps=float(cfg.get("epsilon", 1e-3)),
            decay=float(cfg.get("momentum", 0.99)))
    if cls == "Embedding":
        return EmbeddingLayer(n_in=int(cfg["input_dim"]),
                              n_out=int(cfg["output_dim"]))
    if cls == "LSTM":
        return LSTM(n_out=int(cfg["units"]),
                    activation=_map_activation(cfg.get("activation", "tanh")),
                    gate_activation=_map_activation(
                        cfg.get("recurrent_activation", "sigmoid")))
    if cls == "ZeroPadding2D":
        _check_channels_last(cfg, cls)
        p = cfg.get("padding", 1)
        if isinstance(p, (list, tuple)) and len(p) == 2 \
                and isinstance(p[0], (list, tuple)):
            (t, b), (l, r) = p
            return ZeroPaddingLayer(padding=(int(t), int(b), int(l), int(r)))
        return ZeroPaddingLayer(padding=_pair(p))
    if cls == "InputLayer":
        return None
    # keras-3 registered custom classes serialize as "package>Name";
    # match both the qualified and the bare class name
    bare = cls.rsplit(">", 1)[-1]
    if cls in _CUSTOM_LAYERS or bare in _CUSTOM_LAYERS:
        mapper, wmap = _CUSTOM_LAYERS.get(cls) or _CUSTOM_LAYERS[bare]
        layer = mapper(cfg, is_output=is_output, loss=loss)
        if wmap is not None and layer is not None \
                and not isinstance(layer, str):
            layer._keras_weight_mapper = wmap
        return layer
    raise KerasImportError(
        f"Unsupported Keras layer type '{cls}' "
        "(ref KerasLayer.java:261 supported-type table; register a "
        "mapping with modelimport.keras.register_custom_layer)")


_MERGE_CLASSES = {"Add": "add", "Subtract": "subtract",
                  "Multiply": "product", "Average": "average",
                  "Maximum": "max"}


# -------------------------------------------------------------- weight copy

def _reorder_lstm(k: np.ndarray, H: int) -> np.ndarray:
    """keras gate blocks [i, f, g, o] -> ours [i, f, o, g] (last axis)."""
    i, f, g, o = (k[..., 0:H], k[..., H:2 * H],
                  k[..., 2 * H:3 * H], k[..., 3 * H:4 * H])
    return np.concatenate([i, f, o, g], axis=-1)


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _params_from_keras(layer, w: Dict[str, np.ndarray]):
    """Map a keras layer's weight dict onto (params, state) for `layer`:
    trees of f32 CPU tensors (None where the layer has none)."""
    wmap = getattr(layer, "_keras_weight_mapper", None)
    if wmap is not None:
        params, state = wmap(layer, w)
        conv = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
        return tree_map(conv, params), tree_map(conv, state)
    if isinstance(layer, (Convolution1DLayer, ConvolutionLayer, DenseLayer,
                          OutputLayer)):
        # keras Conv1D [k, Cin, Cout], Conv2D [kh, kw, Cin, Cout] and Dense
        # [in, out] kernels are the port's layouts
        k = w["kernel"]
        return ({"W": _f32(k),
                 "b": _f32(w.get("bias", np.zeros(k.shape[-1])))}, None)
    if isinstance(layer, BatchNormalization):
        c = w["gamma"].shape[0] if "gamma" in w else \
            w["moving_mean"].shape[0]
        params = {"gamma": _f32(w.get("gamma", np.ones(c))),
                  "beta": _f32(w.get("beta", np.zeros(c)))}
        state = {"mean": _f32(w["moving_mean"]),
                 "var": _f32(w["moving_variance"])}
        return params, state
    if isinstance(layer, EmbeddingLayer):
        emb = w["embeddings"]
        return ({"W": _f32(emb), "b": torch.zeros(emb.shape[1])}, None)
    if isinstance(layer, LSTM):
        H = layer.n_out
        return ({"W": _f32(_reorder_lstm(w["kernel"], H)),
                 "RW": _f32(_reorder_lstm(w["recurrent_kernel"], H)),
                 "b": _f32(_reorder_lstm(w.get("bias", np.zeros(4 * H)),
                                         H))},
                None)
    return None, None


def _check_shapes(name, have, want):
    shape = lambda t: tuple(t.shape)
    h, w = tree_map(shape, have), tree_map(shape, want)
    if h != w:
        raise KerasImportError(
            f"weight shape mismatch for layer '{name}': model expects {h}, "
            f"HDF5 provides {w}")


def _load_weights(net, mapped, weights):
    """Copy the file's weights into `net`: `mapped` pairs each keras layer
    name with (port layer, the params key its node or index has)."""
    params, states = net.params, net.states
    for kname, (layer, key) in mapped.items():
        w = weights.get(kname)
        if not w:
            continue
        p, s = _params_from_keras(layer, w)
        for tree, new in ((params, p), (states, s)):
            if new is not None:
                _check_shapes(kname, tree[key], new)
                tree[key] = tree_map(
                    lambda t, old: t.to(device=old.device, dtype=old.dtype),
                    new, tree[key])
    net.params = params
    return net


# ------------------------------------------------------------- entry points

class KerasModelImport:
    """Entry points mirroring KerasModelImport.java:48-119. `device`:
    None means "cuda" (raises without a GPU); pass device="cpu" to run
    on the CPU. `compute_dtype` as the port's networks take it."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path: str, enforce_training_config: bool = False, device=None,
            compute_dtype=None) -> MultiLayerNetwork:
        model_config, weights, training_config = _read_archive(path)
        if model_config.get("class_name") != "Sequential":
            raise KerasImportError(
                f"{path} is not a Sequential model; use "
                "import_keras_model_and_weights")
        conf, mapped = _sequential_conf(model_config, training_config,
                                        enforce_training_config)
        net = MultiLayerNetwork(conf, compute_dtype=compute_dtype,
                                device=device).init()
        return _load_weights(net, mapped, weights)

    @staticmethod
    def import_keras_model_and_weights(
            path: str, enforce_training_config: bool = False, device=None,
            compute_dtype=None):
        """Sequential -> MultiLayerNetwork; Functional -> ComputationGraph."""
        model_config, weights, training_config = _read_archive(path)
        if model_config.get("class_name") == "Sequential":
            conf, mapped = _sequential_conf(model_config, training_config,
                                            enforce_training_config)
            net_cls = MultiLayerNetwork
        else:
            conf, mapped = _functional_conf(model_config, training_config,
                                            enforce_training_config)
            net_cls = ComputationGraph
        net = net_cls(conf, compute_dtype=compute_dtype, device=device).init()
        return _load_weights(net, mapped, weights)

    @staticmethod
    def import_keras_model_configuration(path: str):
        """Configuration only, no weights (ref :119 overloads); builds no
        network, so it needs no device."""
        model_config, _, training_config = _read_archive(path)
        if model_config.get("class_name") == "Sequential":
            return _sequential_conf(model_config, training_config, False)[0]
        return _functional_conf(model_config, training_config, False)[0]


def _loss_from_training_config(training_config, enforce: bool):
    loss = _map_loss(training_config.get("loss")) if training_config else None
    if loss is None and enforce:
        raise KerasImportError(
            "no (supported) loss in training_config but "
            "enforce_training_config=True")
    return loss


def _sequential_conf(model_config, training_config, enforce):
    """(MultiLayerConfiguration, {keras name: (layer, index)})."""
    cfg = model_config.get("config")
    layer_list = cfg["layers"] if isinstance(cfg, dict) else cfg
    loss = _loss_from_training_config(training_config, enforce)

    input_type = None
    mapped: List[Tuple[Optional[str], Any]] = []   # (keras name, layer)
    n_real = sum(1 for lc in layer_list
                 if lc["class_name"] not in
                 ("InputLayer", "Flatten", "Dropout", "Activation"))
    seen_real = 0
    for lc in layer_list:
        cls = lc["class_name"]
        c = lc.get("config", {})
        if cls == "InputLayer":
            input_type = _input_type_from_shape(
                c.get("batch_shape") or c.get("batch_input_shape"))
            continue
        if input_type is None and (
                c.get("batch_input_shape") or c.get("batch_shape")):
            input_type = _input_type_from_shape(
                c.get("batch_input_shape") or c.get("batch_shape"))
        if cls == "LSTM" and not c.get("return_sequences", False):
            raise KerasImportError(
                "LSTM with return_sequences=False has no MultiLayerNetwork "
                "equivalent (needs last-time-step selection); import via "
                "import_keras_model_and_weights on a functional model — "
                "the importer maps it to a LastTimeStep vertex")
        is_out = False
        if cls not in ("Flatten", "Dropout", "Activation"):
            seen_real += 1
            is_out = seen_real == n_real and cls == "Dense"
        layer = _map_layer(cls, c, is_output=is_out, loss=loss)
        if layer == "flatten" or layer is None:
            continue   # CnnToFF preprocessor is auto-inserted
        mapped.append((c.get("name"), layer))

    if input_type is None:
        raise KerasImportError("could not determine the model input shape")

    lb = (NeuralNetConfiguration.Builder().updater("sgd")
          .learning_rate(1e-3).list())
    for _, layer in mapped:
        lb = lb.layer(layer)
    conf = lb.set_input_type(input_type).build()
    return conf, {name: (layer, i) for i, (name, layer) in enumerate(mapped)}


# ----------------------------------------------------------- functional API

def _inbound_shapes(node) -> List[Optional[list]]:
    """Collect tensor shapes attached to keras-3 inbound nodes (absent in
    keras-2 configs)."""
    out: List[Optional[list]] = []

    def rec(v):
        if isinstance(v, dict):
            cfgd = v.get("config") if isinstance(v.get("config"), dict) \
                else None
            if cfgd and "keras_history" in cfgd:
                out.append(cfgd.get("shape"))
                return
            for vv in v.values():
                rec(vv)
        elif isinstance(v, (list, tuple)):
            for vv in v:
                rec(vv)

    rec(node)
    return out


def _inbound_names(node) -> List[str]:
    """Parse inbound layer names from Keras 2 ([[name,0,0,{}],...]) or
    Keras 3 ({'args': [... keras_history ...]}) node formats."""
    out: List[str] = []

    def rec(v):
        if isinstance(v, dict):
            if "keras_history" in v:
                out.append(v["keras_history"][0])
                return
            kh = (v.get("config") or {}).get("keras_history")
            if kh:
                out.append(kh[0])
                return
            for vv in v.values():
                rec(vv)
        elif isinstance(v, (list, tuple)):
            if (len(v) >= 3 and isinstance(v[0], str)
                    and isinstance(v[1], int)):
                out.append(v[0])
                return
            for vv in v:
                rec(vv)

    rec(node)
    return out


def _functional_conf(model_config, training_config, enforce):
    """(ComputationGraphConfiguration, {keras name: (layer, node name)})."""
    cfg = model_config["config"]
    loss = _loss_from_training_config(training_config, enforce)
    # normalize: output_layers is [name,0,0] / [[name,0,0],...] / keras-3
    # dicts — _inbound_names parses all three
    out_names: List[str] = []
    for n in _inbound_names(cfg.get("output_layers", [])):
        if n not in out_names:
            out_names.append(n)

    gb = GraphBuilder(NeuralNetConfiguration.Builder()
                      .updater("sgd").learning_rate(1e-3))
    input_names: List[str] = []
    input_types: List[InputType] = []
    aliases: Dict[str, str] = {}            # skipped keras layer -> input
    mapped: Dict[str, Tuple[Any, str]] = {}
    resolve = lambda names: [aliases.get(n, n) for n in names]
    for lc in cfg["layers"]:
        cls = lc["class_name"]
        c = lc.get("config", {})
        name = c.get("name") or lc.get("name")
        inbound = list(dict.fromkeys(
            _inbound_names(lc.get("inbound_nodes", []))))
        if cls == "InputLayer":
            input_names.append(name)
            input_types.append(_input_type_from_shape(
                c.get("batch_shape") or c.get("batch_input_shape")))
            continue
        if cls in _MERGE_CLASSES:
            gb.add_vertex(name, ElementWiseVertex(op=_MERGE_CLASSES[cls]),
                          *resolve(inbound))
            continue
        if cls == "Concatenate":
            gb.add_vertex(name, MergeVertex(), *resolve(inbound))
            continue
        is_out = name in out_names and cls == "Dense"
        layer = _map_layer(cls, c, is_output=is_out, loss=loss)
        if layer == "flatten":
            # with a known 4D input shape, Flatten is a real reshape node
            # (a merge downstream must see the flattened vector); with an
            # already-flat input it is transparent
            shape4 = next((sh for sh in _inbound_shapes(
                lc.get("inbound_nodes", [])) if sh and len(sh) == 4), None)
            if shape4 is not None:
                h, w, ch = (int(d) for d in shape4[1:])
                gb.add_vertex(name, PreprocessorVertex(
                    preprocessor=CnnToFeedForwardPreProcessor(
                        height=h, width=w, channels=ch)),
                    *resolve(inbound))
            else:
                aliases[name] = resolve(inbound)[0]
            continue
        if layer is None:
            aliases[name] = resolve(inbound)[0]
            continue
        if cls == "LSTM" and not c.get("return_sequences", False):
            # keras folds last-step selection into the layer; here it is
            # an explicit LastTimeStep vertex named after the keras layer
            seq_name = name + "__seq"
            gb.add_layer(seq_name, layer, *resolve(inbound))
            gb.add_vertex(name, LastTimeStepVertex(), seq_name)
            mapped[name] = (layer, seq_name)
            continue
        gb.add_layer(name, layer, *resolve(inbound))
        mapped[name] = (layer, name)

    gb.add_inputs(*input_names)
    gb.set_outputs(*resolve(out_names))
    gb.set_input_types(**dict(zip(input_names, input_types)))
    return gb.build(), mapped
