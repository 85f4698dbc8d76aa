"""MultiLayerNetwork: the sequential network container (counterpart of
deeplearning4j_tpu/nn/multilayer.py).

Params, BatchNorm states and updater states are per-layer lists (one dict
per layer, `{}` for a layer without any), as in the JAX package; there is
no flat chain. The train-step contract (`_step`, `_train_step`,
`_train_carry`, `_step_scalars`, the dropout generator) is
nn/base_network.py's, shared with ComputationGraph, so the engine
(StepProgram.run / run_group, StepHarness, EarlyStoppingTrainer) drives
both containers through one interface.

Dropout: each layer with dropout > 0 draws its mask from the network's
generator in layer order, the output layer's input mask last, once per
train step. With `compute_dtype` the JAX package's mixed-precision policy
holds (nn/dtype.py).

Not ported yet (ROADMAP queue 5): truncated BPTT, the line-search solvers,
`rnn_time_step` and layerwise `pretrain`; they raise.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.base_network import BaseNetwork, batch_loss
from deeplearning4j_tpu_torch.nn.conf.network import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.core import BaseOutputLayer
from deeplearning4j_tpu_torch.util.tree import leaves


def _as_batch(data) -> Tuple:
    """Normalize a batch to (features, labels, features_mask, labels_mask)."""
    if hasattr(data, "features"):
        return (data.features, data.labels,
                getattr(data, "features_mask", None),
                getattr(data, "labels_mask", None))
    if isinstance(data, (tuple, list)):
        get = lambda i: data[i] if len(data) > i else None
        return data[0], get(1), get(2), get(3)
    return data, None, None, None


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 5)")


class MultiLayerNetwork(BaseNetwork):
    def __init__(self, conf: MultiLayerConfiguration, dtype=torch.float32,
                 compute_dtype=None, device=None):
        """`dtype` is the parameter and optimizer-state dtype;
        `compute_dtype` (e.g. torch.bfloat16 or "bfloat16") runs forward
        and backward in that dtype with f32 master params. `device`:
        "cuda" unless the caller passes "cpu"."""
        if not conf.layers:
            raise ValueError("Configuration has no layers")
        self._init_state(dtype, compute_dtype, device)
        self.conf = conf
        self.layer_input_types: Optional[List] = None
        if conf.input_type is not None:
            self.layer_input_types = conf.resolve_shapes()
        self.listeners: List = []

    # ------------------------------------------------- BaseNetwork hooks
    def _layer_items(self):
        return list(enumerate(self.conf.layers))

    def _pack(self, values):
        return list(values)

    def _helper_plan(self):
        """An MLN has no helper tier (the JAX package's MLN runs no fused
        or Pallas path)."""
        return None

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Allocate params from a seeded torch.Generator (drawn on the
        CPU, then moved to the device), the updater states and the
        dropout generator."""
        if self.layer_input_types is None:
            raise ValueError(
                "input_type must be set on the configuration before init()")
        seed = self.conf.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params, states = [], []
        for layer, t in zip(self.conf.layers, self.layer_input_types):
            params.append(layer.init_params(gen, t, self.dtype))
            states.append(layer.init_state(t, self.dtype))
        return self._finish_init(params, states, seed)

    # --------------------------------------------------------------- forward
    def _forward(self, params, states, x, *, train=False, rng=None,
                 layers_to: Optional[int] = None):
        """Forward through layers [0, layers_to). Returns (out,
        new_states); in train mode BatchNorm uses batch statistics and
        layers with dropout draw their masks from `rng`, in layer order."""
        conf = self.conf
        n = len(conf.layers) if layers_to is None else layers_to
        new_states = []
        cur = x
        for i, layer in enumerate(conf.layers[:n]):
            if i in conf.preprocessors:
                cur = conf.preprocessors[i].preprocess(cur)
            cur, ns = layer.apply(params[i], cur, train=train, rng=rng,
                                  state=states[i] if states[i] else None)
            new_states.append(ns if ns is not None else states[i])
        new_states.extend(states[n:])
        return cur, new_states

    # ------------------------------------------------------------------ loss
    def _loss_fn(self, params, states, x, y, lmask=None, train=True,
                 rng=None):
        """Score = the output layer's per-example loss reduced over the
        batch (`batch_loss`) + L1/L2 (the JAX package's
        MultiLayerNetwork._loss_fn). Returns (loss, new_states)."""
        conf = self.conf
        out_layer = conf.layers[-1]
        if not isinstance(out_layer, BaseOutputLayer):
            raise ValueError(
                "Last layer must be an OutputLayer to compute a training "
                f"loss; got {type(out_layer).__name__}")
        n_hidden = len(conf.layers) - 1
        cur, new_states = self._forward(params, states, x, train=train,
                                        rng=rng, layers_to=n_hidden)
        if n_hidden in conf.preprocessors:
            cur = conf.preprocessors[n_hidden].preprocess(cur)
        cur = out_layer._maybe_dropout_input(cur, train, rng)
        per_ex = out_layer.per_example_loss_from_input(
            params[-1], cur, y, mask=lmask)
        reg = 0.0
        for layer, p in zip(conf.layers, params):
            reg = reg + layer.regularization_loss(p)
        return batch_loss(conf, per_ex, lmask) + reg, new_states

    def _batch_tensors(self, x, y, fm=None, lm=None):
        """(x, y, label mask) of a labelled batch as tensors on the device
        in the net's dtype."""
        if y is None:
            raise ValueError("fit needs labels")
        if fm is not None:
            raise NotImplementedError(
                "feature masks are not ported yet (ROADMAP queue 5)")
        return (self._as_input(x), self._as_input(y),
                None if lm is None else self._as_input(lm))

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1):
        """Train on a dataset iterator, (x, y) arrays, a (x, y[, fm, lm])
        tuple (one batch) or an iterable of batches."""
        if not self._initialized():
            self.init()
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
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_start"):
                    listener.on_epoch_start(self)
            if hasattr(batches, "reset"):
                batches.reset()
            it = iter(batches)
            while True:
                # time spent waiting on the data pipeline for this batch
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                self._last_etl_ms = (time.perf_counter() - t0) * 1e3
                self.fit_batch(batch)
            self.epoch += 1
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(self)
        return self

    def fit_batch(self, batch):
        """Train on ONE batch without fit()'s epoch bookkeeping; returns
        the loss (a 0-d tensor on the device, no host sync)."""
        if not self._initialized():
            self.init()
        x, y, fm, lm = _as_batch(batch)
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and getattr(x, "ndim", 0) == 3):
            raise _not_ported("truncated BPTT")
        self._require_sgd()
        loss = self._train_step(*self._batch_tensors(x, y, fm, lm))
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)
        return loss

    # ------------------------------------------------------------- inference
    def output(self, x):
        """Full forward pass in inference mode; returns the output layer's
        activations on the network's device in `dtype`."""
        with torch.inference_mode():
            x = self._as_input(x)
            cd = self.compute_dtype
            if cd is not None:
                x = x.to(cd)
            out, _ = self._forward(self._compute_params(), self.states, x)
            return out.to(self.dtype) if cd is not None else out

    def feed_forward(self, x):
        """The input and every layer's output, in inference mode."""
        with torch.inference_mode():
            cur = self._as_input(x)
            acts = [cur]
            for i, layer in enumerate(self.conf.layers):
                if i in self.conf.preprocessors:
                    cur = self.conf.preprocessors[i].preprocess(cur)
                cur, _ = layer.apply(
                    self.params[i], cur,
                    state=self.states[i] if self.states[i] else None)
                acts.append(cur)
            return acts

    def predict(self, x):
        """Argmax class predictions."""
        return torch.argmax(self.output(x), dim=-1)

    def raw_score(self):
        """The last training loss as the device scalar (no host sync)."""
        return self._score

    def score(self, data=None, labels=None):
        """The last training loss, or the eval-mode loss on `data` with
        the f32 params."""
        if data is None:
            return None if self._score is None else float(self._score)
        x, y, fm, lm = _as_batch((data, labels) if labels is not None
                                 else data)
        x, y, lm = self._batch_tensors(x, y, fm, lm)
        with torch.no_grad():
            loss, _ = self._loss_fn(self._params_view(), self.states, x, y,
                                    lm, train=False)
        return float(loss)

    def evaluate(self, iterator, evaluation=None):
        """Accumulate an Evaluation over a DataSet iterator (or a list of
        batches) and return it."""
        from deeplearning4j_tpu_torch.eval import Evaluation

        ev = evaluation if evaluation is not None else Evaluation()
        for batch in iterator:
            x, y, _, lm = _as_batch(batch)
            out = self.output(x).float().cpu().numpy()
            ev.eval(np.asarray(y.cpu() if isinstance(y, torch.Tensor)
                               else y), out,
                    mask=None if lm is None else np.asarray(lm))
        return ev

    def summary(self) -> str:
        """Layer table with shapes and parameter counts."""
        rows = [("idx", "layer", "in -> out", "params")]
        total = 0
        types = self.layer_input_types or [None] * len(self.conf.layers)
        params = self._params_view() if self._initialized() else None
        for i, (layer, t) in enumerate(zip(self.conf.layers, types)):
            out_t = layer.output_type(t) if t is not None else "?"
            n = (sum(int(p.numel()) for p in leaves(params[i]))
                 if params is not None else 0)
            total += n
            rows.append((str(i), type(layer).__name__,
                         f"{t} -> {out_t}", f"{n:,}"))
        widths = [max(len(r[c]) for r in rows) for c in range(4)]
        lines = ["  ".join(v.ljust(w) for v, w in zip(r, widths))
                 for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        lines.append(f"Total parameters: {total:,}")
        return "\n".join(lines)

    def rnn_time_step(self, x):
        raise _not_ported("rnn_time_step (recurrent layers)")

    def pretrain(self, data_iterator, epochs: int = 1):
        raise _not_ported("layerwise pretrain (AutoEncoder, VAE, RBM)")

    # -------------------------------------------------------------- plumbing
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def get_layer(self, i: int) -> Layer:
        return self.conf.layers[i]

    def n_layers(self) -> int:
        return len(self.conf.layers)
