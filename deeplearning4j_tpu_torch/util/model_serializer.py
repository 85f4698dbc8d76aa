"""The weight bridge and model files (counterpart of
deeplearning4j_tpu/util/model_serializer.py): JAX-package model zips and
param trees into the port, and `write_model`, which writes the same zip.

A JAX model zip holds `configuration.json` (ComputationGraphConfiguration
JSON, helper_mode included, or MultiLayerConfiguration JSON),
`coefficients.npz`, `states.npz`,
`updaterState.npz` (optimizer state, when saved), `normalizer.json` (a
data normalizer's `to_dict`, when one is saved) and `meta.json` (the
iteration and epoch). The arrays are stored as `leaf_i` in jax.tree_util
flatten order: nested dict keys sorted at every level, list/tuple items
in order, and no leaf for None or an empty dict. `_flatten` rebuilds that
order without jax, so a net the JAX package trained resumes training in
the port with its momentum and its learning-rate schedule position. A
graph's trees are dicts keyed by node name; a MultiLayerNetwork's are
lists with one dict per layer (`{}`, no leaf, for a layer without
params).

Layouts need no change: both packages keep conv kernels HWIO, dense
weights [n_in, n_out], LSTM weights [n_in, 4H] in [i, f, o, g] gate
order and activations NHWC, so the bridge only converts arrays to
tensors on the target device and dtype.

`write_model` writes the same layout in the same leaf order, so the JAX
package's `restore_computation_graph` reads a port-written zip. The write
is crash-safe (tmp file + fsync + os.replace) with a `<path>.sha256`
sidecar of the pre-publish bytes, and fires the `checkpoint.write` fault
point between the two, as the JAX package's writer does: a torn write
surfaces on restore as CheckpointIntegrityError.
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.checkpoint_integrity import (
    atomic_writer,
    sha256_file,
)
from deeplearning4j_tpu_torch.resilience.errors import CheckpointIntegrityError
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire
from deeplearning4j_tpu_torch.util.tree import leaves as _flatten
from deeplearning4j_tpu_torch.util.tree import tree_map as _tree_map
from deeplearning4j_tpu_torch.util.tree import unflatten as _unflatten

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
STATES_ENTRY = "states.npz"
UPDATER_ENTRY = "updaterState.npz"
NORMALIZER_ENTRY = "normalizer.json"
META_ENTRY = "meta.json"


def _to_tensor(a, device, dtype):
    t = torch.as_tensor(np.array(a, copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(params, states=None, device=None, dtype=torch.float32,
                    updater_states=None) -> Tuple[dict, ...]:
    """Carry the JAX package's param/state trees (a graph's dicts keyed by
    node name or a MultiLayerNetwork's per-layer lists, of numpy or jax
    arrays: conv W/b, BN gamma/beta and mean/var, dense, output and
    embedding W/b, LSTM W/RW/b and the Graves peepholes P, the
    bidirectional layer's {"bwd", "fwd"} pair, the center-loss head's
    centers, AutoEncoder/RBM W/b/vb, the VAE's encoder/decoder lists of
    {W, b} and its mu/logvar/out heads) into the port's tensors on
    `device` (default "cuda"; pass "cpu" explicitly), in the same
    structure.
    Returns (params, states), and the updater states (e.g. nesterovs'
    {"v": {...}} per layer) as a third item when they are given."""
    from deeplearning4j_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, dev, dtype)
    out = (_tree_map(conv, params),
           None if states is None else _tree_map(conv, states))
    if updater_states is None:
        return out
    return out + (_tree_map(conv, updater_states),)


def _npz_leaves(data: bytes) -> List[np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        return [np.array(z[f"leaf_{i}"]) for i in range(n)]


def _load_into(like, data: bytes, what: str):
    leaves = _npz_leaves(data)
    like_leaves = _flatten(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"{what}: checkpoint has {len(leaves)} arrays, model needs "
            f"{len(like_leaves)}")
    for i, (a, b) in enumerate(zip(leaves, like_leaves)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(
                f"{what}: checkpoint array {i} shape {a.shape} != model "
                f"{tuple(b.shape)}")
    tensors = [torch.as_tensor(a).to(device=b.device, dtype=b.dtype)
               for a, b in zip(leaves, like_leaves)]
    tree, _ = _unflatten(like, tensors)
    return tree


def _checksum_path(path) -> str:
    return os.fspath(path) + ".sha256"


def _structure(tree):
    """The nested key structure of a tree, "*" for each leaf (written as
    the npz's `treedef` entry, for readers; loaders use leaf order)."""
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None if tree is None else "*"


def _tree_to_npz_bytes(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, treedef=np.frombuffer(
        json.dumps(_structure(tree)).encode(), dtype=np.uint8),
        **{f"leaf_{i}": t.detach().cpu().numpy()
           for i, t in enumerate(_flatten(tree))})
    return buf.getvalue()


def write_model(net, path, save_updater: bool = True,
                normalizer=None) -> None:
    """Save a ComputationGraph or MultiLayerNetwork to a zip file the JAX
    package's `restore_computation_graph` / `restore_multi_layer_network`
    reads: configuration.json,
    coefficients.npz, states.npz, updaterState.npz (unless
    `save_updater` is False), normalizer.json (the `to_dict` of
    `normalizer`, when given; `read_normalizer` of either package reads
    it) and meta.json (iteration, epoch).

    Crash-safe: the zip is assembled in a tmp file and published with
    fsync + os.replace (a kill mid-write never leaves a partial model at
    `path`), and a `<path>.sha256` sidecar records the digest of the
    pre-publish bytes so torn writes are detected on restore. Reads the
    params without dropping the net's flat train carry."""
    if not net._initialized():
        raise ValueError("Network not initialized; nothing to save")
    t_write = time.perf_counter()
    path = os.fspath(path)
    with atomic_writer(path) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr(CONFIG_ENTRY, net.conf.to_json())
            z.writestr(COEFFICIENTS_ENTRY,
                       _tree_to_npz_bytes(net._params_view()))
            z.writestr(STATES_ENTRY, _tree_to_npz_bytes(net.states))
            upd = net._upd_view()
            if save_updater and upd is not None:
                z.writestr(UPDATER_ENTRY, _tree_to_npz_bytes(upd))
            if normalizer is not None:
                z.writestr(NORMALIZER_ENTRY,
                           json.dumps(normalizer.to_dict()))
            z.writestr(META_ENTRY, json.dumps({
                "format": "deeplearning4j_tpu",
                "version": 1,
                "model_type": type(net).__name__,
                "iteration": net.iteration,
                "epoch": net.epoch,
            }))
        digest = sha256_file(tmp)
        # chaos hook: 'raise' = kill mid-write, 'truncate' = torn write
        _fire("checkpoint.write", path=tmp)
        with open(_checksum_path(path) + ".tmp", "w") as f:
            f.write(digest)
        os.replace(_checksum_path(path) + ".tmp", _checksum_path(path))
    _obs.count("dl4j_checkpoint_writes_total")
    _obs.observe("dl4j_checkpoint_write_seconds",
                 time.perf_counter() - t_write)


def verify_model(path) -> bool:
    """True iff `path` matches its .sha256 sidecar (files without a
    sidecar pass on existence alone) — the JAX package's rule."""
    path = os.fspath(path)
    if not os.path.exists(path):
        return False
    sidecar = _checksum_path(path)
    if not os.path.exists(sidecar):
        return True
    try:
        with open(sidecar) as f:
            return sha256_file(path) == f.read().strip()
    except OSError:
        return False


def _restore(path, kind, device, compute_dtype, load_updater=True):
    """Load the network a model zip holds; `kind` "graph" or "list", or
    None to follow the configuration (a layer list has "layers")."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.network import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if not verify_model(path):
        raise CheckpointIntegrityError(
            f"{path} failed sha256 validation (truncated or torn write?)")
    with zipfile.ZipFile(path, "r") as z:
        conf_dict = json.loads(z.read(CONFIG_ENTRY).decode())
        if kind is None:
            kind = "list" if "layers" in conf_dict else "graph"
        conf_cls, net_cls = (
            (MultiLayerConfiguration, MultiLayerNetwork) if kind == "list"
            else (ComputationGraphConfiguration, ComputationGraph))
        conf = conf_cls.from_dict(conf_dict)
        net = net_cls(conf, compute_dtype=compute_dtype, device=device).init()
        net.params = _load_into(net.params, z.read(COEFFICIENTS_ENTRY),
                                COEFFICIENTS_ENTRY)
        names = set(z.namelist())
        if STATES_ENTRY in names:
            net.states = _load_into(net.states, z.read(STATES_ENTRY),
                                    STATES_ENTRY)
        if load_updater and UPDATER_ENTRY in names:
            net.updater_states = _load_into(
                net.updater_states, z.read(UPDATER_ENTRY), UPDATER_ENTRY)
        if META_ENTRY in names:
            meta = json.loads(z.read(META_ENTRY).decode())
            net.iteration = meta.get("iteration", 0)
            net.epoch = meta.get("epoch", 0)
    return net


def restore_computation_graph(path, device=None, compute_dtype=None):
    """Load a ComputationGraph from a zip that the JAX package's
    `ModelSerializer.write_model` or this module's `write_model` wrote —
    without jax — with its updater state and iteration count when the zip
    has them. Raises CheckpointIntegrityError if the file fails its
    sha256 sidecar."""
    return _restore(path, "graph", device, compute_dtype)


def restore_multi_layer_network(path, load_updater: bool = True,
                                device=None, compute_dtype=None):
    """Load a MultiLayerNetwork from a zip that the JAX package's
    `ModelSerializer.write_model` or this module's `write_model` wrote,
    as `restore_computation_graph` does for a graph."""
    return _restore(path, "list", device, compute_dtype, load_updater)


def restore_model(path, device=None, compute_dtype=None):
    """Load whichever network a model zip holds: a MultiLayerNetwork when
    its configuration is a layer list, else a ComputationGraph."""
    return _restore(path, None, device, compute_dtype)


def read_normalizer(path):
    """The data normalizer a model zip holds (its normalizer.json, written
    by either package's `write_model(..., normalizer=)`), or None."""
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        normalizer_from_dict,
    )

    with zipfile.ZipFile(path, "r") as z:
        if NORMALIZER_ENTRY not in z.namelist():
            return None
        return normalizer_from_dict(json.loads(z.read(NORMALIZER_ENTRY)))


class ModelSerializer:
    """Static facade over this module, as the JAX package's."""

    writeModel = write_model = staticmethod(write_model)
    verify_model = staticmethod(verify_model)
    restoreMultiLayerNetwork = restore_multi_layer_network = staticmethod(
        restore_multi_layer_network)
    restoreComputationGraph = restore_computation_graph = staticmethod(
        restore_computation_graph)
    readNormalizer = read_normalizer = staticmethod(read_normalizer)
