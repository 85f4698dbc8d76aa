"""The weight bridge: JAX-package model zips and param trees into the port
(counterpart of deeplearning4j_tpu/util/model_serializer.py, read side).

A JAX model zip holds `configuration.json` (ComputationGraphConfiguration
JSON, helper_mode included), `coefficients.npz`, `states.npz`,
`updaterState.npz` (optimizer state, when saved) and `meta.json` (the
iteration and epoch). The arrays are stored as `leaf_i` in jax.tree_util
flatten order: nested dict keys sorted at every level, list/tuple items
in order, and no leaf for None or an empty dict. `_flatten` rebuilds that
order without jax, so a net the JAX package trained resumes training in
the port with its momentum and its learning-rate schedule position.

Layouts need no change: both packages keep conv kernels HWIO, dense
weights [n_in, n_out] and activations NHWC, so the bridge only converts
arrays to tensors on the target device and dtype.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.errors import CheckpointIntegrityError
from deeplearning4j_tpu_torch.util.tree import leaves as _flatten
from deeplearning4j_tpu_torch.util.tree import tree_map as _tree_map
from deeplearning4j_tpu_torch.util.tree import unflatten as _unflatten

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
STATES_ENTRY = "states.npz"
UPDATER_ENTRY = "updaterState.npz"
META_ENTRY = "meta.json"


def _to_tensor(a, device, dtype):
    t = torch.as_tensor(np.array(a, copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(params, states=None, device=None, dtype=torch.float32,
                    updater_states=None) -> Tuple[dict, ...]:
    """Carry the JAX package's param/state trees (nested dicts of numpy or
    jax arrays: conv W/b, BN gamma/beta and mean/var, output W/b) into the
    port's tensors on `device` (default "cuda"; pass "cpu" explicitly).
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


def verify_model(path) -> bool:
    """True iff `path` matches its .sha256 sidecar (files without a
    sidecar pass on existence alone) — the JAX package's rule."""
    path = os.fspath(path)
    if not os.path.exists(path):
        return False
    sidecar = path + ".sha256"
    if not os.path.exists(sidecar):
        return True
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    with open(sidecar) as f:
        return h.hexdigest() == f.read().strip()


def restore_computation_graph(path, device=None, compute_dtype=None):
    """Load a ComputationGraph from a zip the JAX package's
    `ModelSerializer.write_model` wrote — without jax — with its updater
    state and iteration count when the zip has them. Raises
    CheckpointIntegrityError if the file fails its sha256 sidecar."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    if not verify_model(path):
        raise CheckpointIntegrityError(
            f"{path} failed sha256 validation (truncated or torn write?)")
    with zipfile.ZipFile(path, "r") as z:
        conf = ComputationGraphConfiguration.from_json(
            z.read(CONFIG_ENTRY).decode())
        net = ComputationGraph(conf, compute_dtype=compute_dtype,
                               device=device).init()
        net.params = _load_into(net.params, z.read(COEFFICIENTS_ENTRY),
                                COEFFICIENTS_ENTRY)
        names = set(z.namelist())
        if STATES_ENTRY in names:
            net.states = _load_into(net.states, z.read(STATES_ENTRY),
                                    STATES_ENTRY)
        if UPDATER_ENTRY in names:
            net.updater_states = _load_into(
                net.updater_states, z.read(UPDATER_ENTRY), UPDATER_ENTRY)
        if META_ENTRY in names:
            meta = json.loads(z.read(META_ENTRY).decode())
            net.iteration = meta.get("iteration", 0)
            net.epoch = meta.get("epoch", 0)
    return net
