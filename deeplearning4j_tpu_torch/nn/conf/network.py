"""Network configuration: NeuralNetConfiguration (global defaults + fluent
Builder) and MultiLayerConfiguration (the built, serializable stack);
counterpart of deeplearning4j_tpu/nn/conf/network.py.

Defaults and the global-default resolution are the JAX package's, so a
configuration built here serializes to the same JSON, and `from_json`
reads what the JAX package's `to_json()` writes. `build()` resolves the
global defaults into every layer once, so the stored configuration is
fully explicit.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    infer_preprocessor,
    preprocessor_from_dict,
)

if TYPE_CHECKING:
    from deeplearning4j_tpu_torch.nn.layers.base import Layer


class BackpropType:
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


# Fields a layer inherits from the global config when left as None.
_INHERITED = ("activation", "weight_init", "dropout", "l1", "l2",
              "updater", "learning_rate")

_GRADIENT_NORMALIZATIONS = {
    "none", "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
    "clip_element_wise_absolute_value", "clip_l2_per_layer",
    "clip_l2_per_param_type",
}


@dataclass
class MultiLayerConfiguration:
    """The built configuration of a sequential network."""

    layers: List[Layer] = field(default_factory=list)
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, InputPreProcessor] = field(default_factory=dict)

    # training hyperparameters (global; per-layer overrides live on layers)
    seed: int = 12345
    updater: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9
    rho: float = 0.95
    epsilon: Optional[float] = None  # None = the updater's own default
    beta1: float = 0.9
    beta2: float = 0.999
    rmsprop_decay: float = 0.95
    max_grad_norm: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_schedule: Optional[Dict[int, float]] = None  # iteration -> lr
    minibatch: bool = True
    optimization_algo: str = "stochastic_gradient_descent"
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False

    # ---- serde ----
    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "layers":
                v = [l.to_dict() for l in v]
            elif f.name == "input_type":
                v = v.to_dict() if v is not None else None
            elif f.name == "preprocessors":
                v = {str(k): p.to_dict() for k, p in v.items()}
            elif f.name == "lr_schedule" and v is not None:
                v = {str(k): lr for k, lr in v.items()}
            d[f.name] = v
        return d

    def to_yaml(self) -> str:
        """YAML serde (ref NeuralNetConfiguration.toYaml :291); PyYAML is
        imported here, on use only."""
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml

        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.serde import layer_from_dict

        d = dict(d)
        layers = [layer_from_dict(ld) for ld in d.pop("layers", [])]
        it = d.pop("input_type", None)
        input_type = InputType.from_dict(it) if it else None
        preprocessors = {int(k): preprocessor_from_dict(pd)
                         for k, pd in d.pop("preprocessors", {}).items()}
        sched = d.pop("lr_schedule", None)
        if sched is not None:
            sched = {int(k): float(v) for k, v in sched.items()}
        known = {f.name for f in dataclasses.fields(MultiLayerConfiguration)}
        d = {k: v for k, v in d.items() if k in known}
        return MultiLayerConfiguration(
            layers=layers, input_type=input_type,
            preprocessors=preprocessors, lr_schedule=sched, **d)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    # ---- shapes ----
    def resolve_shapes(self) -> List[InputType]:
        """InputType propagation through preprocessors and layers: the
        per-layer input types (one per layer). Fills each layer's n_in
        and inserts the preprocessors `infer_preprocessor` names."""
        if self.input_type is None:
            raise ValueError("input_type must be set to resolve shapes")
        types = []
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            if i not in self.preprocessors:
                pre = infer_preprocessor(cur, layer)
                if pre is not None:
                    self.preprocessors[i] = pre
            if i in self.preprocessors:
                cur = self.preprocessors[i].output_type(cur)
            layer.set_n_in(cur)
            types.append(cur)
            cur = layer.output_type(cur)
        return types

    def validate(self) -> "MultiLayerConfiguration":
        """Check the registry-resolved names (activation, weight init,
        loss, updater, gradient normalization) so typos fail at build
        time, not mid-training."""
        from deeplearning4j_tpu_torch.nn.activations import get_activation
        from deeplearning4j_tpu_torch.nn.losses import get_loss
        from deeplearning4j_tpu_torch.nn.updater import get_updater
        from deeplearning4j_tpu_torch.nn.weights import WEIGHT_INITS

        get_updater(self.updater, self)
        if self.gradient_normalization and \
                self.gradient_normalization not in _GRADIENT_NORMALIZATIONS:
            raise ValueError(
                f"Unknown gradient_normalization "
                f"'{self.gradient_normalization}'. Known: "
                f"{sorted(_GRADIENT_NORMALIZATIONS)}")
        for i, layer in enumerate(self.layers):
            act = getattr(layer, "activation", None)
            if act is not None:
                get_activation(act)
            wi = getattr(layer, "weight_init", None)
            if wi is not None and not callable(wi) \
                    and str(wi).lower() not in WEIGHT_INITS:
                raise ValueError(
                    f"Layer {i}: unknown weight init '{wi}'. "
                    f"Known: {sorted(WEIGHT_INITS)}")
            loss = getattr(layer, "loss", None)
            if loss is not None:
                get_loss(loss)
            if layer.updater is not None:
                get_updater(layer.updater, self)
        return self

    def output_type(self) -> InputType:
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            if i in self.preprocessors:
                cur = self.preprocessors[i].output_type(cur)
            cur = layer.output_type(cur)
        return cur


class NeuralNetConfiguration:
    """Global-defaults holder; entry point of the
    `NeuralNetConfiguration.Builder()....list()....build()` and
    `....graph_builder()....build()` flows."""

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
            # training hyperparameters copied onto the built configuration
            self._extra: Dict[str, Any] = {}

        def seed(self, v):             self._g["seed"] = int(v); return self
        def activation(self, v):       self._g["activation"] = v; return self
        def weight_init(self, v):      self._g["weight_init"] = v; return self
        def updater(self, v):          self._g["updater"] = str(v).lower(); return self
        def learning_rate(self, v):    self._g["learning_rate"] = float(v); return self
        def dropout(self, v):          self._g["dropout"] = float(v); return self
        def l1(self, v):               self._g["l1"] = float(v); return self
        def l2(self, v):               self._g["l2"] = float(v); return self
        def momentum(self, v):         self._extra["momentum"] = float(v); return self
        def rho(self, v):              self._extra["rho"] = float(v); return self
        def epsilon(self, v):          self._extra["epsilon"] = float(v); return self
        def adam_mean_decay(self, v):  self._extra["beta1"] = float(v); return self
        def adam_var_decay(self, v):   self._extra["beta2"] = float(v); return self
        def rms_decay(self, v):        self._extra["rmsprop_decay"] = float(v); return self
        def minibatch(self, v):        self._extra["minibatch"] = bool(v); return self
        def optimization_algo(self, v):
            self._extra["optimization_algo"] = v; return self

        def learning_rate_policy(self, policy):
            self._extra["lr_policy"] = str(policy).lower(); return self
        def lr_policy_decay_rate(self, v):
            self._extra["lr_policy_decay_rate"] = float(v); return self
        def lr_policy_steps(self, v):
            self._extra["lr_policy_steps"] = float(v); return self
        def lr_policy_power(self, v):
            self._extra["lr_policy_power"] = float(v); return self
        def learning_rate_schedule(self, schedule: Dict[int, float]):
            self._extra["lr_schedule"] = dict(schedule); return self

        def list(self) -> "NeuralNetConfiguration.ListBuilder":
            """Layer-list variant (ref: NeuralNetConfiguration.Builder.list())."""
            return NeuralNetConfiguration.ListBuilder(self)

        def graph_builder(self):
            """DAG variant (ref: NeuralNetConfiguration.Builder.graphBuilder())."""
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
            return GraphBuilder(self)

    class ListBuilder:
        def __init__(self, builder: "NeuralNetConfiguration.Builder"):
            self._builder = builder
            self._layers: List[Layer] = []
            self._input_type: Optional[InputType] = None
            self._preprocessors: Dict[int, InputPreProcessor] = {}
            self._backprop_type = BackpropType.STANDARD
            self._tbptt_fwd = 20
            self._tbptt_back = 20

        def layer(self, *args) -> "NeuralNetConfiguration.ListBuilder":
            """layer(l) appends; layer(i, l) sets index i."""
            if len(args) == 1:
                self._layers.append(args[0])
            else:
                idx, l = args
                while len(self._layers) <= idx:
                    self._layers.append(None)  # type: ignore
                self._layers[idx] = l
            return self

        def set_input_type(self, input_type: InputType):
            self._input_type = input_type
            return self

        def input_pre_processor(self, idx: int, pre: InputPreProcessor):
            self._preprocessors[idx] = pre
            return self

        def backprop_type(self, t: str):
            self._backprop_type = t
            return self

        def t_bptt_forward_length(self, n: int):
            self._tbptt_fwd = int(n)
            return self

        def t_bptt_backward_length(self, n: int):
            self._tbptt_back = int(n)
            return self

        def build(self) -> MultiLayerConfiguration:
            g = self._builder._g
            layers = [copy.deepcopy(l) for l in self._layers]
            if any(l is None for l in layers):
                raise ValueError("Layer list has gaps")
            for l in layers:
                _apply_global_defaults(l, g)
            conf = MultiLayerConfiguration(
                layers=layers,
                input_type=self._input_type,
                preprocessors=dict(self._preprocessors),
                seed=g["seed"],
                updater=g["updater"],
                learning_rate=g["learning_rate"],
                backprop_type=self._backprop_type,
                tbptt_fwd_length=self._tbptt_fwd,
                tbptt_back_length=self._tbptt_back,
                **self._builder._extra,
            )
            if conf.input_type is not None:
                conf.resolve_shapes()
            return conf.validate()


def _apply_global_defaults(layer: Layer, g: Dict[str, Any]) -> None:
    """Resolve None fields on a layer from the global defaults."""
    for name in _INHERITED:
        if hasattr(layer, name) and getattr(layer, name, None) is None:
            if name in ("updater", "learning_rate"):
                continue  # None = use network-level value at train time
            default = g.get(name)
            if default is not None:
                setattr(layer, name, default)
