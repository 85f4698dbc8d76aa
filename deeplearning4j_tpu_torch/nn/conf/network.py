"""NeuralNetConfiguration.Builder: global defaults + fluent setters
(counterpart of deeplearning4j_tpu/nn/conf/network.py).

This slice ports the builder's graph path (`graph_builder()`); the
layer-list path (`list()` -> MultiLayerConfiguration) arrives with
MultiLayerNetwork. Defaults and the global-default resolution are the JAX
package's, so a configuration built here serializes to the same JSON.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict

if TYPE_CHECKING:
    from deeplearning4j_tpu_torch.nn.layers.base import Layer


class BackpropType:
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


# Fields a layer inherits from the global config when left as None.
_INHERITED = ("activation", "weight_init", "dropout", "l1", "l2",
              "updater", "learning_rate")


class NeuralNetConfiguration:
    """Global-defaults holder; entry point of the
    `NeuralNetConfiguration.Builder()....graph_builder()....build()` flow."""

    class Builder:
        def __init__(self):
            self._g: Dict[str, Any] = {
                "seed": 12345,
                "activation": "sigmoid",
                "weight_init": "xavier",
                "updater": "sgd",
                "learning_rate": 0.1,
                "dropout": 0.0,
                "l1": 0.0,
                "l2": 0.0,
            }

        def seed(self, v):             self._g["seed"] = int(v); return self
        def activation(self, v):       self._g["activation"] = v; return self
        def weight_init(self, v):      self._g["weight_init"] = v; return self
        def updater(self, v):          self._g["updater"] = str(v).lower(); return self
        def learning_rate(self, v):    self._g["learning_rate"] = float(v); return self
        def dropout(self, v):          self._g["dropout"] = float(v); return self
        def l1(self, v):               self._g["l1"] = float(v); return self
        def l2(self, v):               self._g["l2"] = float(v); return self

        def graph_builder(self):
            """DAG variant (ref: NeuralNetConfiguration.Builder.graphBuilder())."""
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
            return GraphBuilder(self)


def _apply_global_defaults(layer: Layer, g: Dict[str, Any]) -> None:
    """Resolve None fields on a layer from the global defaults."""
    for name in _INHERITED:
        if hasattr(layer, name) and getattr(layer, name, None) is None:
            if name in ("updater", "learning_rate"):
                continue  # None = use network-level value at train time
            default = g.get(name)
            if default is not None:
                setattr(layer, name, default)
