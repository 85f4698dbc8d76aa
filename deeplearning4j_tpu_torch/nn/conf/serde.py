"""Layer config serde: class registry + dict round-trip (counterpart of
deeplearning4j_tpu/nn/conf/serde.py). Reads the layer dicts the JAX
package's `to_json()` writes."""

from __future__ import annotations

import dataclasses
from typing import Dict, Type

from deeplearning4j_tpu_torch.nn.layers.base import Layer

_LAYER_REGISTRY: Dict[str, Type[Layer]] = {}


def register_layer(cls: Type[Layer]) -> Type[Layer]:
    """Register a Layer subclass for JSON round-trip (usable as a decorator)."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def _register_builtins():
    from deeplearning4j_tpu_torch.nn import layers as L

    for obj in L.__dict__.values():
        if isinstance(obj, type) and issubclass(obj, Layer):
            _LAYER_REGISTRY.setdefault(obj.__name__, obj)


def layer_from_dict(d: dict) -> Layer:
    _register_builtins()
    d = dict(d)
    kind = d.pop("type")
    if kind not in _LAYER_REGISTRY:
        raise ValueError(
            f"Unknown layer type '{kind}'. Registered: "
            f"{sorted(_LAYER_REGISTRY)}. Custom layers must call "
            "register_layer(cls) before deserialization.")
    cls = _LAYER_REGISTRY[kind]
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in field_names:
            continue
        if isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)
