"""ComputationGraph: the DAG network container (counterpart of
deeplearning4j_tpu/nn/graph.py).

Params are a dict node-name -> {param-name: tensor}; BatchNorm running
statistics live in `states`, updater state in `updater_states`. The
constructor, `init`, `_helper_plan`, `_forward`, `_exec_node`, `output`,
the loss and the train step (`fit`, `fit_batch`, `score`) mirror the JAX
package's. PyTorch runs eagerly, so a train step is one forward, one
`torch.autograd.grad` and one update on the host's order, not a compiled
program.

`device` follows the port's policy: "cuda" unless the caller passes
device="cpu"; no fallback. With `compute_dtype` (e.g. torch.bfloat16) the
JAX package's mixed-precision policy holds: params and inputs are cast to
it (inside autograd when training, so gradients arrive in f32 for the f32
master params), BatchNorm states and labels are not cast, and outputs and
the loss are cast back to `dtype`.

The train step carries one flat parameter vector and one flat vector per
updater-state field when the configuration allows (updater/flat_chain.py);
`params`/`updater_states` then materialize the per-layer trees on demand,
and any such access drops the flat carry, since the caller may mutate the
returned tree.

The train-step contract (the flat carry, `_step`, `_train_step`,
`_step_scalars`, the dropout generator) is nn/base_network.py's, shared
with MultiLayerNetwork: one function holds the step math, `_step(carry,
inputs, labels, lmasks, scalars)`, on an explicit carry (params, updater
state, BN states) and one row of per-step scalars (learning rate, step
index) that lives on the device. `_train_step` (fit_batch,
engine.StepProgram.run) and the k-step group of engine.StepProgram.run_group
both call it; since the scalars are tensors, the same step can be
captured once into a CUDA graph and replayed with new values.

Recurrent graphs: feature masks (one per network input) follow the nodes
— a layer passes its input's on, a vertex the first of its inputs'
(LastTimeStepVertex reads the mask of its `mask_input`, or its input's,
and passes none on); truncated BPTT and the RNN carries are
base_network's; `rnn_time_step` streams as MultiLayerNetwork's does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.base_network import BaseNetwork, batch_loss
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    GraphNode,
)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import LastTimeStepVertex
from deeplearning4j_tpu_torch.nn.dtype import cast_floating
from deeplearning4j_tpu_torch.nn.layers.core import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import RECURRENT_LAYERS


def _as_multi(data):
    """Normalize a batch to (inputs, labels, features_masks, label_masks)
    lists: MultiDataSet-like objects or (x, y[, fmask, lmask]) tuples."""
    as_list = lambda v: (None if v is None else
                         list(v) if isinstance(v, (list, tuple)) else [v])
    if hasattr(data, "features"):
        return (as_list(data.features), as_list(data.labels),
                as_list(getattr(data, "features_mask", None)),
                as_list(getattr(data, "labels_mask", None)))
    if isinstance(data, (tuple, list)):
        get = lambda i: data[i] if len(data) > i else None
        return as_list(data[0]), as_list(get(1)), as_list(get(2)), \
            as_list(get(3))
    return [data], None, None, None


class ComputationGraph(BaseNetwork):
    def __init__(self, conf: ComputationGraphConfiguration,
                 dtype=torch.float32, compute_dtype=None, device=None):
        if not conf.nodes:
            raise ValueError("Configuration has no nodes")
        self._init_state(dtype, compute_dtype, device)
        self.conf = conf
        self.topo: List[GraphNode] = conf.topological_order()
        self.node_types = None
        self._layer_in_types = None
        if conf.input_types:
            self.node_types, self._layer_in_types = conf.resolve_shapes(
                return_layer_inputs=True)
        self._layer_names = [n.name for n in self.topo if n.kind == "layer"]
        self._fusion_plan = "uninit"   # helper tier (nn/helpers/)

    # ------------------------------------------------- BaseNetwork hooks
    def _layer_items(self):
        return [(n.name, n.obj) for n in self.topo if n.kind == "layer"]

    def _pack(self, values):
        return dict(zip(self._layer_names, values))

    def _build_flat_chain(self):
        from deeplearning4j_tpu_torch.nn.updater.flat_chain import (
            FlatTrainChain,
        )
        return FlatTrainChain.build(self)

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Initialize params from a seeded torch.Generator (drawn on the
        CPU, then moved to the device), the updater states and the
        dropout generator."""
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
        return self._finish_init(params, states, seed)

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

    def _forward(self, params, states, inputs: Dict[str, Any], *,
                 train: bool = False, materialize_all: bool = False,
                 rng=None, input_masks: Optional[Dict[str, Any]] = None,
                 rnn_carries: Optional[Dict[str, Any]] = None):
        """Forward over the DAG. Returns (activations, new_states,
        new_carries); in train mode BatchNorm normalizes with batch
        statistics and new_states carries the updated running statistics,
        and layers with dropout draw their masks from `rng` in topological
        order. `input_masks`: feature masks by network input; a recurrent
        layer starts from its entry of `rnn_carries` (zeros without one)
        and its new carry lands in new_carries."""
        masks: Dict[str, Any] = dict(input_masks or {})
        new_carries: Dict[str, Any] = {}
        if self._helper_plan() is not None:
            from deeplearning4j_tpu_torch.nn.helpers.fused_graph import (
                fused_forward,
            )
            acts, new_states = fused_forward(
                self, params, states, inputs, train=train,
                materialize_all=materialize_all, rng=rng, masks=masks,
                rnn_carries=rnn_carries, new_carries=new_carries)
            return acts, new_states, new_carries
        acts: Dict[str, Any] = dict(inputs)
        new_states: Dict[str, Any] = {}
        for node in self.topo:
            self._exec_node(node, [acts[s] for s in node.inputs], params,
                            states, acts, train, new_states, rng, masks,
                            rnn_carries, new_carries)
        return acts, new_states, new_carries

    def _exec_node(self, node, xs, params, states, acts, train=False,
                   new_states=None, rng=None, masks=None, rnn_carries=None,
                   new_carries=None):
        """Execute ONE node with resolved inputs, writing its activation
        (and, given `new_states`, its state; given `masks`, its feature
        mask; given `new_carries`, a recurrent layer's carry). Shared by
        the default loop and the fused executor's fallback."""
        masks = {} if masks is None else masks
        in_masks = [masks.get(s) for s in node.inputs]
        layer = node.obj
        if node.kind == "layer":
            x, m = xs[0], in_masks[0]
            if node.preprocessor is not None:
                x = node.preprocessor.preprocess(x)
                m = node.preprocessor.feed_forward_mask(m, None)
            if isinstance(layer, RECURRENT_LAYERS):
                out, nc = layer.apply(
                    params[node.name], x, train=train, rng=rng, mask=m,
                    state=(None if rnn_carries is None
                           else rnn_carries.get(node.name)))
                ns = None
                if new_carries is not None:
                    new_carries[node.name] = nc
            else:
                st = states[node.name] if states[node.name] else None
                out, ns = layer.apply(params[node.name], x, train=train,
                                      rng=rng, state=st, mask=m)
            acts[node.name] = out
            masks[node.name] = layer.feed_forward_mask(m, None)
            if new_states is not None:
                new_states[node.name] = (ns if ns is not None
                                         else states[node.name])
        else:
            if isinstance(layer, LastTimeStepVertex):
                m = masks.get(layer.mask_input) if layer.mask_input \
                    else in_masks[0]
                acts[node.name] = layer.apply(xs, mask=m)
            else:
                acts[node.name] = layer.apply(xs)
            masks[node.name] = layer.feed_forward_mask(in_masks, None)

    # ------------------------------------------------------------------ loss
    def _output_layer_nodes(self) -> List[GraphNode]:
        return [self.conf.node(n) for n in self.conf.network_outputs]

    def _loss_fn(self, params, states, inputs, labels, label_masks=None,
                 train=True, rng=None, fmasks=None, rnn_carries=None):
        """Sum of output-layer losses + regularization (the JAX package's
        ComputationGraph._loss_fn). Returns (loss, (new_states,
        new_carries))."""
        conf = self.conf
        out_nodes = self._output_layer_nodes()
        for n in out_nodes:
            if n.kind != "layer" or not isinstance(n.obj, BaseOutputLayer):
                raise ValueError(
                    f"network output '{n.name}' must be an output layer "
                    f"to train; got {type(n.obj).__name__}")
        acts, new_states, new_carries = self._forward(
            params, states, inputs, train=train, rng=rng,
            input_masks=fmasks, rnn_carries=rnn_carries)
        total = 0.0
        for oi, node in enumerate(out_nodes):
            # the output layer's per-example loss, from its input
            x = acts[node.inputs[0]]
            if node.preprocessor is not None:
                x = node.preprocessor.preprocess(x)
            layer = node.obj
            x = layer._maybe_dropout_input(x, train, rng)
            lm = None if label_masks is None else label_masks[oi]
            per_ex = layer.per_example_loss_from_input(
                params[node.name], x, labels[oi], mask=lm)
            total = total + batch_loss(conf, per_ex, lm)
        reg = 0.0
        for node in self.topo:
            if node.kind == "layer":
                reg = reg + node.obj.regularization_loss(params[node.name])
        return total + reg, (new_states, new_carries)

    # ------------------------------------------------------------------- fit
    def fit_batch(self, batch):
        """Train on ONE batch and notify the listeners' iteration_done;
        returns the loss (a 0-d tensor on the device, no host sync)."""
        if not self._initialized():
            self.init()
        ins, labs, fms, lms = _as_multi(batch)
        self._fit_one(*self._batch_tensors(ins, labs, fms, lms))
        self._notify_iteration()
        return self._score

    def _batch_tensors(self, ins, labs, fms=None, lms=None):
        """(inputs dict, labels list, label masks, feature masks dict by
        network input) of a labelled batch as tensors on the device in
        the net's dtype, from per-input lists."""
        if labs is None:
            raise ValueError("fit needs labels")
        opt = lambda m: None if m is None else self._as_input(m)
        names = self.conf.network_inputs
        inputs = {name: self._as_input(x) for name, x in zip(names, ins)}
        labels = [self._as_input(y) for y in labs]
        lmasks = None if lms is None else [opt(m) for m in lms]
        fmasks = (None if fms is None else
                  {name: opt(m) for name, m in zip(names, fms)})
        return inputs, labels, lmasks, fmasks

    def score(self, data=None):
        """The last training loss, or the eval-mode loss on `data` (with
        the f32 params, as the JAX package's score). With the flat carry
        live the params are read as views of it; the carry stays live."""
        if data is None:
            return None if self._score is None else float(self._score)
        inputs, labels, lmasks, fmasks = self._batch_tensors(
            *_as_multi(data))
        with torch.no_grad():
            params = self._params_view()
            loss, _ = self._loss_fn(params, self.states, inputs, labels,
                                    lmasks, train=False, fmasks=fmasks)
        return float(loss)

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
            acts, _, _ = self._forward(params, self.states, inputs)
            outs = [acts[n].to(self.dtype) if cd is not None else acts[n]
                    for n in conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_time_step(self, *xs):
        """Stateful streaming inference over the network inputs (each
        [B, nIn] for one step or [B, T, nIn] for a chunk), as
        MultiLayerNetwork.rnn_time_step: the recurrent layers start from
        `rnn_states` and leave their new carries there; with a one-step
        input the outputs are that step's."""
        self._check_streamable()
        with torch.no_grad():
            inputs, single = {}, False
            for name, x in zip(self.conf.network_inputs, xs):
                x = self._as_input(x)
                if x.ndim == 2:
                    single, x = True, x[:, None, :]
                inputs[name] = x
            if self.rnn_states is None:
                self.rnn_states = self._initial_carries(
                    next(iter(inputs.values())).shape[0])
            acts, _, new = self._forward(self._params_view(), self.states,
                                         inputs, rnn_carries=self.rnn_states)
            self.rnn_states.update(new)
            outs = [acts[n] for n in self.conf.network_outputs]
        if single:
            outs = [o[:, -1, :] if o.ndim == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *xs):
        """All activations dict name -> tensor."""
        with torch.inference_mode():
            inputs = {name: self._as_input(x)
                      for name, x in zip(self.conf.network_inputs, xs)}
            acts, _, _ = self._forward(self.params, self.states, inputs,
                                       materialize_all=True)
            return acts
