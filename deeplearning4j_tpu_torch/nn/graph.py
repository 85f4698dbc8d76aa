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
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    GraphNode,
)
from deeplearning4j_tpu_torch.nn.dtype import canonical_dtype, cast_floating
from deeplearning4j_tpu_torch.nn.layers.core import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.updater import (
    apply_score_decay,
    fused_apply,
    get_updater,
    schedule_lr,
)
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


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


def _grad_norm(tree):
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves(tree)) + 1e-12)


def clip_grads(conf, grads):
    """Gradient normalization (the JAX package's
    MultiLayerNetwork._clip_grads): a global-norm clip (max_grad_norm),
    then the configured mode over a dict of per-layer grads, or over one
    flat gradient on the flat chain (elementwise modes only)."""
    if conf.max_grad_norm:
        total = torch.sqrt(sum(torch.sum(g * g) for g in leaves(grads)))
        scale = torch.clamp_max(conf.max_grad_norm / (total + 1e-12), 1.0)
        grads = tree_map(lambda g: g * scale, grads)
    gn = conf.gradient_normalization
    if not gn or gn == "none":
        return grads
    t = conf.gradient_normalization_threshold
    if gn == "clip_element_wise_absolute_value":
        return tree_map(lambda g: torch.clamp(g, -t, t), grads)
    if gn == "clip_l2_per_layer":
        return {k: tree_map(lambda g, s=torch.clamp_max(
            t / _grad_norm(lg), 1.0): g * s, lg) for k, lg in grads.items()}
    if gn == "renormalize_l2_per_layer":
        return {k: tree_map(lambda g, s=1.0 / _grad_norm(lg): g * s, lg)
                for k, lg in grads.items()}
    if gn == "clip_l2_per_param_type":
        return tree_map(lambda g: g * torch.clamp_max(
            t / torch.sqrt(torch.sum(g * g) + 1e-12), 1.0), grads)
    if gn == "renormalize_l2_per_param_type":
        return tree_map(lambda g: g / torch.sqrt(torch.sum(g * g) + 1e-12),
                        grads)
    raise ValueError(f"Unknown gradient normalization '{gn}'")


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
        self._upd_states: Optional[Dict[str, Any]] = None
        self._updaters: Optional[Dict[str, Any]] = None
        self._flat_train = None       # (flat params, flat updater state)
        self._flat_chain = "uninit"   # grad-over-flat carrier (updater/)
        self._cast_params = None      # params in the compute dtype (cache)
        self._fusion_plan = "uninit"   # helper tier (nn/helpers/)
        self.iteration = 0
        self.epoch = 0
        self._score = None
        self._lr_score_factor = 1.0   # lr_policy="score" decay state
        self._best_score = None

    # -------------------------------------------------- params (flat carry)
    def _materialize_flat(self):
        if self._flat_train is not None:
            chain = self._flat_chain
            flat, uflat = self._flat_train
            self._params = chain.unravel(flat)
            self._upd_states = chain.unravel_upd(uflat, self._upd_states)
            self._flat_train = None

    @property
    def params(self):
        self._materialize_flat()
        return self._params

    @params.setter
    def params(self, value):
        self._materialize_flat()
        self._cast_params = None
        self._params = value

    @property
    def updater_states(self):
        self._materialize_flat()
        return self._upd_states

    @updater_states.setter
    def updater_states(self, value):
        self._materialize_flat()
        self._upd_states = value

    def _flat_chain_obj(self):
        if self._flat_chain == "uninit":
            from deeplearning4j_tpu_torch.nn.updater.flat_chain import (
                FlatTrainChain,
            )
            self._flat_chain = FlatTrainChain.build(self)
        return self._flat_chain

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Initialize params from a seeded torch.Generator (drawn on the
        CPU, then moved to the device) and the updater states."""
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
        self._init_updaters()
        return self

    def _init_updaters(self):
        self._updaters = {}
        upd_states = {}
        for node in self.topo:
            if node.kind != "layer":
                continue
            upd = get_updater(node.obj.updater or self.conf.updater,
                              self.conf)
            self._updaters[node.name] = upd
            upd_states[node.name] = upd.init(self._params[node.name])
        self.updater_states = upd_states

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in leaves(self.params))

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
                 train: bool = False, materialize_all: bool = False):
        """Forward over the DAG. Returns (activations, new_states); in
        train mode BatchNorm normalizes with batch statistics and
        new_states carries the updated running statistics."""
        if self._helper_plan() is not None:
            from deeplearning4j_tpu_torch.nn.helpers.fused_graph import (
                fused_forward,
            )
            return fused_forward(self, params, states, inputs, train=train,
                                 materialize_all=materialize_all)
        acts: Dict[str, Any] = dict(inputs)
        new_states: Dict[str, Any] = {}
        for node in self.topo:
            self._exec_node(node, [acts[s] for s in node.inputs], params,
                            states, acts, train, new_states)
        return acts, new_states

    def _exec_node(self, node, xs, params, states, acts, train=False,
                   new_states=None):
        """Execute ONE node with resolved inputs, writing its activation
        (and, given `new_states`, its state). Shared by the default loop
        and the fused executor's fallback."""
        if node.kind == "layer":
            x = xs[0]
            if node.preprocessor is not None:
                x = node.preprocessor.preprocess(x)
            st = states[node.name] if states[node.name] else None
            out, ns = node.obj.apply(params[node.name], x, train=train,
                                     state=st)
            acts[node.name] = out
            if new_states is not None:
                new_states[node.name] = (ns if ns is not None
                                         else states[node.name])
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

    # ------------------------------------------------------------------ loss
    def _output_layer_nodes(self) -> List[GraphNode]:
        return [self.conf.node(n) for n in self.conf.network_outputs]

    def _loss_fn(self, params, states, inputs, labels, label_masks=None,
                 train=True):
        """Sum of output-layer losses + regularization (the JAX package's
        ComputationGraph._loss_fn). Returns (loss, new_states)."""
        conf = self.conf
        out_nodes = self._output_layer_nodes()
        for n in out_nodes:
            if n.kind != "layer" or not isinstance(n.obj, BaseOutputLayer):
                raise ValueError(
                    f"network output '{n.name}' must be an output layer "
                    f"to train; got {type(n.obj).__name__}")
        acts, new_states = self._forward(params, states, inputs, train=train)
        total = 0.0
        for oi, node in enumerate(out_nodes):
            # the output layer's per-example loss, from its input
            x = acts[node.inputs[0]]
            if node.preprocessor is not None:
                x = node.preprocessor.preprocess(x)
            layer = node.obj
            x = layer._maybe_dropout_input(x, train)
            lm = None if label_masks is None else label_masks[oi]
            per_ex = layer.per_example_loss_from_input(
                params[node.name], x, labels[oi], mask=lm)
            if lm is not None:
                active = lm if lm.ndim == 1 else torch.any(lm > 0, dim=1).to(
                    lm.dtype)
                s = per_ex.sum()
                total = total + (s / torch.clamp_min(active.sum(), 1.0)
                                 if conf.minibatch else s)
            elif conf.minibatch:
                total = total + per_ex.mean()
            else:
                total = total + per_ex.sum()
        reg = 0.0
        for node in self.topo:
            if node.kind == "layer":
                reg = reg + node.obj.regularization_loss(params[node.name])
        return total + reg, new_states

    def _loss_for_grad(self, params, inputs, labels, lmasks):
        """The train loss under the mixed-precision policy: params and
        inputs cast to the compute dtype inside autograd (so gradients
        reach the f32 master params in f32), the loss cast back."""
        cd = self.compute_dtype
        if cd is not None:
            params = cast_floating(params, cd)
            inputs = cast_floating(inputs, cd)
        loss, new_states = self._loss_fn(params, self.states, inputs,
                                         labels, lmasks, train=True)
        if cd is not None:
            loss = loss.to(self.dtype)
        return loss, new_states

    # ------------------------------------------------------------ train step
    def _train_step(self, inputs, labels, lmasks=None):
        """One forward, backward and update. The flat chain when the
        configuration is eligible and nothing is frozen, else the
        per-layer `fused_apply` path."""
        conf = self.conf
        frozen = {n.name for n in self.topo
                  if n.kind == "layer" and n.obj.frozen}
        chain = self._flat_chain_obj() if not frozen else None
        step = self.iteration
        lr = schedule_lr(conf, step) * self._lr_score_factor
        if chain is not None:
            if self._flat_train is None:
                flat = chain.ravel(self._params)
                uflat = chain.ravel_upd(self._upd_states)
                # the live state is the flat carry; keep only a skeleton
                self._upd_states = chain.upd_skeleton(self._upd_states)
                self._params = None
                self._flat_train = (flat, uflat)
            flat, uflat = self._flat_train
            leaf = flat.detach().requires_grad_()
            with torch.enable_grad():
                loss, new_states = self._loss_for_grad(
                    chain.unravel(leaf), inputs, labels, lmasks)
                (g,) = torch.autograd.grad(loss, leaf)
            with torch.no_grad():
                g = clip_grads(conf, g)
                deltas, new_u = chain.updater.update(g, uflat, flat, lr, step)
                self._flat_train = (flat + deltas, new_u)
        else:
            names = [n.name for n in self.topo if n.kind == "layer"]
            params = tree_map(lambda t: t.detach().requires_grad_(),
                              self.params)
            with torch.enable_grad():
                loss, new_states = self._loss_for_grad(params, inputs,
                                                       labels, lmasks)
                ps = leaves(params)
                gs = torch.autograd.grad(loss, ps, allow_unused=True)
            with torch.no_grad():
                gs = [torch.zeros_like(p) if g is None else g
                      for p, g in zip(ps, gs)]
                grads = clip_grads(conf, unflatten(params, gs)[0])
                lr_f = {n: self._lr_factor(n) for n in names}
                np_list, nu_list = fused_apply(
                    [(self._updaters[n], lr_f[n], n in frozen,
                      tree_map(torch.Tensor.detach, params[n]), grads[n],
                      self.updater_states[n]) for n in names], lr, step)
                self.params = dict(zip(names, np_list))
                self.updater_states = dict(zip(names, nu_list))
        self._cast_params = None
        self.states = new_states
        self.iteration += 1
        self._score = loss.detach()
        apply_score_decay(self, self._score)
        return self._score

    def _lr_factor(self, name):
        layer = self.conf.node(name).obj
        lr = getattr(layer, "learning_rate", None)
        if lr is None or self.conf.learning_rate == 0:
            return 1.0
        return lr / self.conf.learning_rate

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1):
        """Train on an iterator / list of batches / single batch."""
        if labels is not None:
            batches: Sequence = [(data, labels)]
        elif isinstance(data, tuple) or hasattr(data, "features"):
            batches = [data]
        elif hasattr(data, "__iter__"):
            batches = data
            if epochs > 1 and iter(batches) is batches and not hasattr(
                    batches, "reset"):
                raise ValueError(
                    "fit() got a one-shot iterator with epochs > 1; pass a "
                    "list or an iterator with reset()")
        else:
            batches = [data]
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for batch in batches:
                self.fit_batch(batch)
            self.epoch += 1
        return self

    def fit_batch(self, batch):
        """Train on ONE batch; returns the loss (a 0-d tensor on the
        device, no host sync)."""
        if self._params is None and self._flat_train is None:
            self.init()
        ins, labs, fms, lms = _as_multi(batch)
        if labs is None:
            raise ValueError("fit needs labels")
        if fms is not None and any(m is not None for m in fms):
            raise NotImplementedError("feature masks are not ported yet")
        if self.conf.optimization_algo not in (
                "stochastic_gradient_descent", "sgd"):
            raise NotImplementedError(
                f"optimization_algo {self.conf.optimization_algo!r} is not "
                f"ported yet")
        inputs = {name: self._as_input(x)
                  for name, x in zip(self.conf.network_inputs, ins)}
        labels = [self._as_input(y) for y in labs]
        lmasks = (None if lms is None else
                  [None if m is None else self._as_input(m) for m in lms])
        self._train_step(inputs, labels, lmasks)
        return self._score

    def score(self, data=None):
        """The last training loss, or the eval-mode loss on `data` (with
        the f32 params, as the JAX package's score)."""
        if data is None:
            return None if self._score is None else float(self._score)
        ins, labs, _, lms = _as_multi(data)
        inputs = {name: self._as_input(x)
                  for name, x in zip(self.conf.network_inputs, ins)}
        labels = [self._as_input(y) for y in labs]
        lmasks = (None if lms is None else
                  [None if m is None else self._as_input(m) for m in lms])
        with torch.no_grad():
            loss, _ = self._loss_fn(self.params, self.states, inputs, labels,
                                    lmasks, train=False)
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
            acts, _ = self._forward(params, self.states, inputs)
            outs = [acts[n].to(self.dtype) if cd is not None else acts[n]
                    for n in conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *xs):
        """All activations dict name -> tensor."""
        with torch.inference_mode():
            inputs = {name: self._as_input(x)
                      for name, x in zip(self.conf.network_inputs, xs)}
            acts, _ = self._forward(self.params, self.states, inputs,
                                    materialize_all=True)
            return acts
