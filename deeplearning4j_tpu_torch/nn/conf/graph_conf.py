"""ComputationGraphConfiguration + GraphBuilder (counterpart of
deeplearning4j_tpu/nn/conf/graph_conf.py).

Same fields, same JSON: `from_json` reads what the JAX package's
`to_json()` writes, `helper_mode` included, and `to_json` writes what the
JAX package reads.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    DuplicateToTimeSeriesVertex,
    GraphVertex,
    MergeVertex,
    vertex_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import BackpropType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    infer_preprocessor,
    preprocessor_from_dict,
)

if TYPE_CHECKING:
    from deeplearning4j_tpu_torch.nn.layers.base import Layer


@dataclass
class GraphNode:
    name: str
    kind: str                      # "layer" | "vertex"
    obj: object                    # Layer or GraphVertex
    inputs: List[str]
    preprocessor: Optional[InputPreProcessor] = None

    def to_dict(self):
        return {
            "name": self.name,
            "kind": self.kind,
            "obj": self.obj.to_dict(),
            "inputs": list(self.inputs),
            "preprocessor": (self.preprocessor.to_dict()
                             if self.preprocessor else None),
        }

    @staticmethod
    def from_dict(d):
        from deeplearning4j_tpu_torch.nn.conf.serde import layer_from_dict

        obj = (layer_from_dict(d["obj"]) if d["kind"] == "layer"
               else vertex_from_dict(d["obj"]))
        pre = d.get("preprocessor")
        return GraphNode(
            name=d["name"], kind=d["kind"], obj=obj,
            inputs=list(d["inputs"]),
            preprocessor=preprocessor_from_dict(pre) if pre else None)


@dataclass
class ComputationGraphConfiguration:
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    nodes: List[GraphNode] = field(default_factory=list)
    input_types: Dict[str, InputType] = field(default_factory=dict)

    # training hyperparameters — carried for JSON parity with the JAX
    # package; the train step arrives with slice 2
    seed: int = 12345
    updater: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9
    rho: float = 0.95
    epsilon: Optional[float] = None
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
    lr_schedule: Optional[Dict[int, float]] = None
    minibatch: bool = True
    optimization_algo: str = "stochastic_gradient_descent"
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False
    # helper tier: "none" | "fused" | "pallas"; "" = unset (the
    # DL4J_TPU_HELPERS ambient default may apply) — nn/helpers/
    helper_mode: str = ""

    # ------------------------------------------------------------- topology
    def node(self, name: str) -> GraphNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def topological_order(self) -> List[GraphNode]:
        """Kahn topo sort — the JAX package's order, node for node."""
        by_name = {n.name: n for n in self.nodes}
        indeg = {n.name: 0 for n in self.nodes}
        dependents: Dict[str, List[str]] = {n.name: [] for n in self.nodes}
        for n in self.nodes:
            for src in n.inputs:
                if src in by_name:
                    indeg[n.name] += 1
                    dependents[src].append(n.name)
                elif src not in self.network_inputs:
                    raise ValueError(
                        f"node '{n.name}' input '{src}' is neither a node "
                        f"nor a network input")
        ready = [n.name for n in self.nodes if indeg[n.name] == 0]
        order = []
        while ready:
            cur = ready.pop(0)
            order.append(by_name[cur])
            for dep in dependents[cur]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    ready.append(dep)
        if len(order) != len(self.nodes):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise ValueError(f"graph has a cycle involving {cyc}")
        return order

    def resolve_shapes(self, return_layer_inputs: bool = False):
        """Propagate InputTypes through the DAG; set n_in on layers and
        auto-insert preprocessors."""
        if set(self.input_types) != set(self.network_inputs):
            missing = set(self.network_inputs) - set(self.input_types)
            raise ValueError(
                f"input types missing for network inputs {sorted(missing)}")
        types: Dict[str, InputType] = dict(self.input_types)
        layer_inputs: Dict[str, InputType] = {}
        for node in self.topological_order():
            in_types = [types[s] for s in node.inputs]
            if node.kind == "layer":
                t = in_types[0]
                if node.preprocessor is None:
                    node.preprocessor = infer_preprocessor(t, node.obj)
                if node.preprocessor is not None:
                    t = node.preprocessor.output_type(t)
                node.obj.set_n_in(t)
                layer_inputs[node.name] = t
                types[node.name] = node.obj.output_type(t)
            else:
                lo, hi = node.obj.n_inputs()
                if len(in_types) < lo or (hi is not None and len(in_types) > hi):
                    raise ValueError(
                        f"vertex '{node.name}' takes {lo}..{hi or 'N'} "
                        f"inputs, got {len(in_types)}")
                types[node.name] = node.obj.output_type(in_types)
        if return_layer_inputs:
            return types, layer_inputs
        return types

    def validate(self) -> "ComputationGraphConfiguration":
        """Eagerly validate activation and weight-init names so typos
        fail at build time. (Loss and updater names are checked by the
        train step, which arrives with slice 2.)"""
        from deeplearning4j_tpu_torch.nn.activations import get_activation
        from deeplearning4j_tpu_torch.nn.weights import WEIGHT_INITS

        for node in self.nodes:
            if node.kind != "layer":
                continue
            layer = node.obj
            act = getattr(layer, "activation", None)
            if act is not None:
                get_activation(act)
            wi = getattr(layer, "weight_init", None)
            if wi is not None and not callable(wi) \
                    and str(wi).lower() not in WEIGHT_INITS:
                raise ValueError(
                    f"Node '{node.name}': unknown weight init '{wi}'. "
                    f"Known: {sorted(WEIGHT_INITS)}")
        return self

    # ----------------------------------------------------------------- serde
    def to_dict(self):
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "nodes":
                v = [n.to_dict() for n in v]
            elif f.name == "input_types":
                v = {k: t.to_dict() for k, t in v.items()}
            elif f.name == "lr_schedule" and v is not None:
                v = {str(k): lr for k, lr in v.items()}
            d[f.name] = v
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        d = dict(d)
        nodes = [GraphNode.from_dict(nd) for nd in d.pop("nodes", [])]
        input_types = {k: InputType.from_dict(t)
                       for k, t in d.pop("input_types", {}).items()}
        sched = d.pop("lr_schedule", None)
        if sched is not None:
            sched = {int(k): float(v) for k, v in sched.items()}
        known = {f.name for f in dataclasses.fields(
            ComputationGraphConfiguration)}
        d = {k: v for k, v in d.items() if k in known}
        return ComputationGraphConfiguration(
            nodes=nodes, input_types=input_types, lr_schedule=sched, **d)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class GraphBuilder:
    """Fluent DAG builder, as in the JAX package:

        conf = (NeuralNetConfiguration.Builder().graph_builder()
                .add_inputs("x")
                .add_layer("dense1", DenseLayer(n_out=64), "x")
                .add_layer("out", OutputLayer(n_out=10), "dense1")
                .set_outputs("out")
                .set_input_types(x=InputType.feed_forward(30))
                .build())
    """

    def __init__(self, global_builder=None):
        self._global = global_builder
        self._conf = ComputationGraphConfiguration()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        if len(inputs) == 0:
            raise ValueError(f"layer '{name}' needs at least one input")
        if len(inputs) > 1:
            merge_name = f"{name}-merge"
            self.add_vertex(merge_name, MergeVertex(), *inputs)
            inputs = (merge_name,)
        layer.name = name
        self._conf.nodes.append(GraphNode(
            name=name, kind="layer", obj=layer, inputs=list(inputs),
            preprocessor=preprocessor))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        inputs = list(inputs)
        if (isinstance(vertex, DuplicateToTimeSeriesVertex)
                and vertex.ts_input and vertex.ts_input not in inputs):
            # the reference time series becomes an input edge, so topo
            # order and shape inference see the dependency
            inputs.append(vertex.ts_input)
        self._conf.nodes.append(GraphNode(
            name=name, kind="vertex", obj=vertex, inputs=inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    def helpers(self, mode: str) -> "GraphBuilder":
        """Select the helper tier ('none' | 'fused' | 'pallas')."""
        from deeplearning4j_tpu_torch.nn.helpers import validate_helper_mode

        self._conf.helper_mode = validate_helper_mode(mode) or "none"
        return self

    def set_input_types(self, **types: InputType) -> "GraphBuilder":
        self._conf.input_types.update(types)
        return self

    def set_input_types_ordered(self, *types: InputType) -> "GraphBuilder":
        for name, t in zip(self._conf.network_inputs, types):
            self._conf.input_types[name] = t
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = self._conf
        conf.nodes = [GraphNode(
            name=n.name, kind=n.kind, obj=copy.deepcopy(n.obj),
            inputs=list(n.inputs),
            preprocessor=copy.deepcopy(n.preprocessor))
            for n in conf.nodes]
        if not conf.network_inputs:
            raise ValueError("graph has no inputs (add_inputs)")
        if not conf.network_outputs:
            raise ValueError("graph has no outputs (set_outputs)")
        names = [n.name for n in conf.nodes]
        if len(set(names)) != len(names):
            dup = sorted({x for x in names if names.count(x) > 1})
            raise ValueError(f"duplicate node names: {dup}")
        clash = set(names) & set(conf.network_inputs)
        if clash:
            raise ValueError(
                f"node names collide with network inputs: {sorted(clash)}")
        for out in conf.network_outputs:
            if out not in names:
                raise ValueError(f"output '{out}' is not a node")
        if self._global is not None:
            from deeplearning4j_tpu_torch.nn.conf.network import (
                _apply_global_defaults,
            )

            g = self._global._g
            conf.seed = g["seed"]
            conf.updater = g["updater"]
            conf.learning_rate = g["learning_rate"]
            known = {f.name for f in dataclasses.fields(
                ComputationGraphConfiguration)}
            for k, v in self._global._extra.items():
                if k in known:
                    setattr(conf, k, v)
            for node in conf.nodes:
                if node.kind == "layer":
                    _apply_global_defaults(node.obj, g)
        if conf.input_types:
            conf.resolve_shapes()
        else:
            conf.topological_order()
        return conf.validate()
