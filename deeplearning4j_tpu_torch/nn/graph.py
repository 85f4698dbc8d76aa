"""ComputationGraph: the DAG network container (counterpart of
deeplearning4j_tpu/nn/graph.py), inference path.

Params are a dict node-name -> {param-name: tensor}; BatchNorm running
statistics live in `states`. The constructor, `init`, `_helper_plan`,
`_forward`, `_exec_node` and `output` mirror the JAX package's; training
(`fit`, the loss, the updaters) arrives with slice 2.

`device` follows the port's policy: "cuda" unless the caller passes
device="cpu"; no fallback. With `compute_dtype` (e.g. torch.bfloat16),
`output` casts params and inputs to it, keeps BatchNorm states uncast and
returns the outputs cast back to `dtype` — the JAX package's
mixed-precision inference policy.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    GraphNode,
)
from deeplearning4j_tpu_torch.nn.dtype import canonical_dtype, cast_floating


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 dtype=torch.float32, compute_dtype=None, device=None):
        if not conf.nodes:
            raise ValueError("Configuration has no nodes")
        self.device = resolve_device(device)
        self.conf = conf
        self.dtype = canonical_dtype(dtype)
        self.compute_dtype = canonical_dtype(compute_dtype)
        self.topo: List[GraphNode] = conf.topological_order()
        self.node_types = None
        self._layer_in_types = None
        if conf.input_types:
            self.node_types, self._layer_in_types = conf.resolve_shapes(
                return_layer_inputs=True)
        self._params: Optional[Dict[str, Any]] = None
        self.states: Optional[Dict[str, Any]] = None
        self._cast_params = None      # params in the compute dtype (cache)
        self._fusion_plan = "uninit"   # helper tier (nn/helpers/)

    # ---------------------------------------------------------------- params
    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        self._cast_params = None
        self._params = value

    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Initialize params from a seeded torch.Generator (drawn on the
        CPU, then moved to the device)."""
        if self.node_types is None:
            raise ValueError("set input types on the configuration "
                             "before init()")
        seed = self.conf.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params, states = {}, {}
        for node in self.topo:
            if node.kind != "layer":
                continue
            t = self._layer_in_types[node.name]
            params[node.name] = node.obj.init_params(gen, t, self.dtype)
            states[node.name] = node.obj.init_state(t, self.dtype)
        self.params = _tree_to(params, self.device)
        self.states = _tree_to(states, self.device)
        return self

    def num_params(self) -> int:
        return sum(int(t.numel()) for p in self.params.values()
                   for t in p.values())

    # --------------------------------------------------------------- forward
    def _helper_plan(self):
        """Lazily build the fusion plan when the helper tier is enabled
        (conf helper_mode, or env DL4J_TPU_HELPERS for unset configs)."""
        if self._fusion_plan == "uninit":
            from deeplearning4j_tpu_torch.nn.helpers import (
                validate_helper_mode,
            )

            mode = validate_helper_mode(getattr(self.conf, "helper_mode", ""))
            if not mode:
                mode = validate_helper_mode(
                    os.environ.get("DL4J_TPU_HELPERS", "")) or "none"
            if mode in ("fused", "pallas"):
                from deeplearning4j_tpu_torch.nn.helpers.fused_graph import (
                    build_plan,
                )
                self._fusion_plan = build_plan(
                    self.topo, self.conf.network_outputs,
                    impl="pallas" if mode == "pallas" else "xla")
            else:
                self._fusion_plan = None
        return self._fusion_plan

    def _forward(self, params, states, inputs: Dict[str, Any],
                 materialize_all: bool = False):
        """Inference forward over the DAG. Returns the activations dict."""
        if self._helper_plan() is not None:
            from deeplearning4j_tpu_torch.nn.helpers.fused_graph import (
                fused_forward,
            )
            return fused_forward(self, params, states, inputs,
                                 materialize_all=materialize_all)
        acts: Dict[str, Any] = dict(inputs)
        for node in self.topo:
            self._exec_node(node, [acts[s] for s in node.inputs], params,
                            states, acts)
        return acts

    def _exec_node(self, node, xs, params, states, acts):
        """Execute ONE node with resolved inputs, writing its activation.
        Shared by the default loop and the fused executor's fallback."""
        if node.kind == "layer":
            x = xs[0]
            if node.preprocessor is not None:
                x = node.preprocessor.preprocess(x)
            st = states[node.name] if states[node.name] else None
            out, _ = node.obj.apply(params[node.name], x, state=st)
            acts[node.name] = out
        else:
            acts[node.name] = node.obj.apply(xs)

    def _compute_params(self):
        if self.compute_dtype is None:
            return self.params
        if self._cast_params is None:
            self._cast_params = cast_floating(self.params, self.compute_dtype)
        return self._cast_params

    def _as_input(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------- inference
    def output(self, *xs):
        """Forward pass; returns the output-node activations (one tensor
        if one output), on the network's device in `dtype`."""
        conf = self.conf
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
            xs = tuple(xs[0])
        with torch.inference_mode():
            inputs = {name: self._as_input(x)
                      for name, x in zip(conf.network_inputs, xs)}
            cd = self.compute_dtype
            params = self._compute_params()
            if cd is not None:
                inputs = cast_floating(inputs, cd)
            acts = self._forward(params, self.states, inputs)
            outs = [acts[n].to(self.dtype) if cd is not None else acts[n]
                    for n in conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *xs):
        """All activations dict name -> tensor."""
        with torch.inference_mode():
            inputs = {name: self._as_input(x)
                      for name, x in zip(self.conf.network_inputs, xs)}
            return self._forward(self.params, self.states, inputs,
                                 materialize_all=True)
