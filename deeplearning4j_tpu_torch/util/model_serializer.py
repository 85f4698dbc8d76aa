"""The weight bridge: JAX-package model zips and param trees into the port
(counterpart of deeplearning4j_tpu/util/model_serializer.py, read side).

A JAX model zip holds `configuration.json` (ComputationGraphConfiguration
JSON, helper_mode included), `coefficients.npz` and `states.npz`. The
arrays are stored as `leaf_i` in jax.tree_util flatten order: nested dict
keys sorted at every level, list/tuple items in order, and no leaf for
None or an empty dict. `_flatten` rebuilds that order without jax.

Layouts need no change: both packages keep conv kernels HWIO, dense
weights [n_in, n_out] and activations NHWC, so the bridge only converts
arrays to tensors on the target device and dtype.
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import Any, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.errors import CheckpointIntegrityError

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
STATES_ENTRY = "states.npz"


def _flatten(tree) -> List[Any]:
    """Leaves of a nested dict/list tree in jax.tree_util order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k]))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out.extend(_flatten(v))
        return out
    return [tree]


def _unflatten(like, leaves, pos=0):
    """Rebuild `like`'s structure from `leaves` (same order as _flatten).
    Returns (tree, next position)."""
    if like is None:
        return None, pos
    if isinstance(like, dict):
        out = {}
        for k in sorted(like):
            out[k], pos = _unflatten(like[k], leaves, pos)
        return {k: out[k] for k in like}, pos
    if isinstance(like, (list, tuple)):
        items = []
        for v in like:
            item, pos = _unflatten(v, leaves, pos)
            items.append(item)
        return type(like)(items), pos
    return leaves[pos], pos + 1


def _to_tensor(a, device, dtype):
    t = torch.as_tensor(np.array(a, copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(v, fn) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def params_from_jax(params, states=None, device=None, dtype=torch.float32
                    ) -> Tuple[dict, dict]:
    """Carry the JAX package's param/state trees (nested dicts of numpy or
    jax arrays: conv W/b, BN gamma/beta and mean/var, output W/b) into the
    port's tensors on `device` (default "cuda"; pass "cpu" explicitly).
    Returns (params, states)."""
    from deeplearning4j_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, dev, dtype)
    return (_tree_map(params, conv),
            None if states is None else _tree_map(states, conv))


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
    `ModelSerializer.write_model` wrote — without jax. Raises
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
        if STATES_ENTRY in z.namelist():
            net.states = _load_into(net.states, z.read(STATES_ENTRY),
                                    STATES_ENTRY)
    return net
