"""Transfer learning (counterpart of deeplearning4j_tpu/nn/transferlearning.py):
FineTuneConfiguration, TransferLearning.Builder (a MultiLayerNetwork),
TransferLearning.GraphBuilder (a ComputationGraph) and
TransferLearningHelper.

Builder flow: take a trained network, freeze a feature-extractor prefix,
optionally replace or append heads, override training hyperparameters,
and get back a new network that keeps the old weights and BatchNorm
states wherever the architecture is unchanged. Re-initialized layers
follow the JAX package's rule: appended layers, a layer whose n_out is
replaced, and the layer after it (its n_in changes).

The new network lives on the source's device with the source's dtype
and compute dtype (the JAX package's builders keep the dtype only; a
source trained under the bf16 policy fine-tunes under it here).

A frozen layer's params are not autograd leaves in the train step
(nn/base_network.py `_step`), so the backward stops at the frozen
boundary; the update leaves them bit for bit, and a frozen BatchNorm
still normalizes with batch statistics and updates its running
statistics in train mode, as the JAX package's does.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.util.tree import clone, leaves


@dataclass
class FineTuneConfiguration:
    """Training-hyperparameter overrides applied to the rebuilt network."""

    updater: Optional[str] = None
    learning_rate: Optional[float] = None
    momentum: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, v):
            self._kw["updater"] = str(v).lower()
            return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        def momentum(self, v):
            self._kw["momentum"] = float(v)
            return self

        def l1(self, v):
            self._kw["l1"] = float(v)
            return self

        def l2(self, v):
            self._kw["l2"] = float(v)
            return self

        def dropout(self, v):
            self._kw["dropout"] = float(v)
            return self

        def seed(self, v):
            self._kw["seed"] = int(v)
            return self

        def build(self):
            return FineTuneConfiguration(**self._kw)

    def apply_to(self, conf):
        """Override a layer-list configuration: the updater, rate,
        momentum and seed on the configuration, l1/l2/dropout on every
        layer that has the field."""
        if self.updater is not None:
            conf.updater = self.updater
        if self.learning_rate is not None:
            conf.learning_rate = self.learning_rate
        if self.momentum is not None:
            conf.momentum = self.momentum
        if self.seed is not None:
            conf.seed = self.seed
        for layer in conf.layers:
            for f in ("l1", "l2", "dropout"):
                v = getattr(self, f)
                if v is not None and hasattr(layer, f):
                    setattr(layer, f, v)


def _same_shapes(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        tuple(x.shape) == tuple(y.shape) for x, y in zip(la, lb))


class TransferLearning:
    class Builder:
        def __init__(self, net):
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )

            if not isinstance(net, MultiLayerNetwork):
                raise TypeError(
                    "TransferLearning.Builder works on MultiLayerNetwork; "
                    "use TransferLearning.GraphBuilder for graphs")
            if not net._initialized():
                raise ValueError("source network must be initialized")
            self.net = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_up_to: Optional[int] = None
            self._nout_replace = {}      # layer_idx -> (n_out, weight_init)
            self._remove_from: Optional[int] = None
            self._appended: List = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers 0..layer_idx inclusive."""
            self._freeze_up_to = layer_idx
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: Optional[str] = None):
            """Change a layer's output width; its params and the next
            layer's are re-initialized."""
            self._nout_replace[layer_idx] = (n_out, weight_init)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            self._remove_from = len(self.net.conf.layers) - n
            return self

        def add_layer(self, layer):
            self._appended.append(layer)
            return self

        def build(self):
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )

            old = self.net
            conf = copy.deepcopy(old.conf)
            keep = (len(conf.layers) if self._remove_from is None
                    else self._remove_from)
            appended = [copy.deepcopy(l) for l in self._appended]
            for l in appended:
                # appended layers bypass the global builder's defaults:
                # fill the framework defaults for None fields
                if hasattr(l, "weight_init") and l.weight_init is None:
                    l.weight_init = "xavier"
                if hasattr(l, "activation") and l.activation is None:
                    l.activation = "sigmoid"
            conf.layers = conf.layers[:keep] + appended
            conf.preprocessors = {i: p for i, p in conf.preprocessors.items()
                                  if i < keep}
            reinit = set(range(keep, len(conf.layers)))
            for idx, (n_out, wi) in self._nout_replace.items():
                if idx >= keep:
                    raise ValueError(f"n_out_replace index {idx} was removed")
                conf.layers[idx].n_out = n_out
                if wi is not None:
                    conf.layers[idx].weight_init = wi
                reinit.add(idx)
                if idx + 1 < len(conf.layers):
                    reinit.add(idx + 1)   # its n_in changes
            if self._freeze_up_to is not None:
                for i in range(min(self._freeze_up_to + 1, len(conf.layers))):
                    conf.layers[i].frozen = True
            if self._ftc is not None:
                self._ftc.apply_to(conf)
            for idx, layer in enumerate(conf.layers):
                if idx in reinit and hasattr(layer, "n_in"):
                    layer.n_in = None
            conf.resolve_shapes()

            new = MultiLayerNetwork(conf, dtype=old.dtype,
                                    compute_dtype=old.compute_dtype,
                                    device=old.device).init()
            old_p = old._params_view()
            params, states = list(new.params), list(new.states)
            for i in range(min(keep, len(conf.layers))):
                if i not in reinit and _same_shapes(old_p[i], params[i]):
                    params[i] = clone(old_p[i])
                    states[i] = clone(old.states[i])
            new.params, new.states = params, states
            return new

    class GraphBuilder:
        """Graph variant: freeze a node and every ancestor of it, and the
        fine-tune overrides; every param and state is retained."""

        def __init__(self, graph):
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

            if not isinstance(graph, ComputationGraph):
                raise TypeError("GraphBuilder needs a ComputationGraph")
            if not graph._initialized():
                raise ValueError("source graph must be initialized")
            self.graph = graph
            self._ftc: Optional[FineTuneConfiguration] = None
            self._frozen_until: Optional[str] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, node_name: str):
            """Freeze node_name and every ancestor of it."""
            self._frozen_until = node_name
            return self

        def build(self):
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

            old = self.graph
            conf = copy.deepcopy(old.conf)
            if self._frozen_until is not None:
                by_name = {n.name: n for n in conf.nodes}
                frozen, todo = set(), [self._frozen_until]
                while todo:
                    name = todo.pop()
                    if name in frozen or name not in by_name:
                        continue
                    frozen.add(name)
                    todo.extend(by_name[name].inputs)
                for n in conf.nodes:
                    if n.name in frozen and n.kind == "layer":
                        n.obj.frozen = True
            ftc = self._ftc
            if ftc is not None:
                # the JAX package's GraphBuilder overrides these three only
                if ftc.updater is not None:
                    conf.updater = ftc.updater
                if ftc.learning_rate is not None:
                    conf.learning_rate = ftc.learning_rate
                if ftc.seed is not None:
                    conf.seed = ftc.seed
            new = ComputationGraph(conf, dtype=old.dtype,
                                   compute_dtype=old.compute_dtype,
                                   device=old.device).init()
            new.params = clone(old._params_view())
            new.states = clone(old.states)
            return new


class TransferLearningHelper:
    """Featurize once: run the frozen prefix (layers 0..frozen_up_to)
    once per dataset (`featurize`), train only the unfrozen tail on the
    cached features (`fit_featurized`), and write the trained tail back
    into the wrapped network."""

    def __init__(self, net, frozen_up_to: int):
        self.net = net
        self.frozen_up_to = frozen_up_to
        self._tail = None

    def featurize(self, x):
        """The prefix's output for `x` in inference mode: a tensor on the
        net's device in its dtype. Under a compute dtype the prefix runs
        in it (the values the net's own train step feeds its tail)."""
        from deeplearning4j_tpu_torch.nn.dtype import cast_floating

        net = self.net
        cd = net.compute_dtype
        with torch.no_grad():
            cur = net._as_input(x)
            params = net._params_view()
            if cd is not None:
                cur = cur.to(cd)
                params = cast_floating(params, cd)
            for i in range(self.frozen_up_to + 1):
                if i in net.conf.preprocessors:
                    cur = net.conf.preprocessors[i].preprocess(cur)
                cur, _ = net.conf.layers[i].apply(
                    params[i], cur, train=False,
                    state=net.states[i] if net.states[i] else None)
            return cur.to(net.dtype)

    @staticmethod
    def _input_type_of(feat):
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

        shape = tuple(feat.shape)
        if len(shape) == 4:
            return InputType.convolutional(*shape[1:])
        if len(shape) == 3:
            return InputType.recurrent(shape[-1])
        return InputType.feed_forward(shape[-1])

    def unfrozen_mln(self, example_features):
        """The tail-only network fit_featurized trains, built on first
        use from a featurized batch's shape; it starts from the wrapped
        net's current tail params and states."""
        if self._tail is None:
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )

            k = self.frozen_up_to
            net = self.net
            conf = net.conf
            tail_conf = copy.deepcopy(conf)
            tail_conf.layers = [copy.deepcopy(l) for l in conf.layers[k + 1:]]
            tail_conf.preprocessors = {
                i - (k + 1): p for i, p in conf.preprocessors.items()
                if i > k}
            tail_conf.input_type = self._input_type_of(example_features)
            tail_conf.resolve_shapes()
            tail = MultiLayerNetwork(tail_conf, dtype=net.dtype,
                                     compute_dtype=net.compute_dtype,
                                     device=net.device).init()
            n = len(conf.layers)
            params = net._params_view()
            tail.params = [params[i] for i in range(k + 1, n)]
            tail.states = [net.states[i] for i in range(k + 1, n)]
            self._tail = tail
        return self._tail

    def fit_featurized(self, data, epochs: int = 1):
        """Train the tail on (featurized_x, y) batches (a tuple, a
        DataSet, or an iterable of either), then write the trained
        params and states back into the wrapped network."""
        if not isinstance(data, (list, tuple)) and not hasattr(
                data, "features") and hasattr(data, "__iter__"):
            data = list(data)   # materialize one-shot iterators
        single = (not isinstance(data, (list, tuple))
                  or (len(data) in (2, 4) and hasattr(data[0], "shape")))
        batches = [data] if single else list(data)
        first = batches[0]
        fx = first.features if hasattr(first, "features") else first[0]
        tail = self.unfrozen_mln(fx)
        for _ in range(epochs):
            tail.fit(batches)
        k = self.frozen_up_to
        params, states = list(self.net.params), list(self.net.states)
        for j, i in enumerate(range(k + 1, len(self.net.conf.layers))):
            params[i] = tail.params[j]
            states[i] = tail.states[j]
        self.net.params, self.net.states = params, states
        return self

    # camelCase parity
    fitFeaturized = fit_featurized
    unfrozenMLN = unfrozen_mln
