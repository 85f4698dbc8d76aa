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

Recurrent nets: a [B, T] feature mask follows the layers (each layer's
`feed_forward_mask`, each preprocessor's); truncated BPTT and the carries
are base_network's; `rnn_time_step` streams one step or chunk at a time
from `rnn_states`, under no_grad, with the f32 params, as the JAX
package's does.

Beside the updater step: the line-search solvers (optimize/solvers.py,
selected by `optimization_algo`, run by base_network's `_fit_one`) and
layerwise `pretrain` of the AutoEncoder, VariationalAutoencoder and RBM
layers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.base_network import BaseNetwork, batch_loss
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.core import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import RECURRENT_LAYERS
from deeplearning4j_tpu_torch.nn.updater import get_updater, schedule_lr
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


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
                 layers_to: Optional[int] = None, mask=None,
                 rnn_carries=None):
        """Forward through layers [0, layers_to). Returns (out,
        new_states, new_carries); in train mode BatchNorm uses batch
        statistics and layers with dropout draw their masks from `rng`, in
        layer order. `mask` is the [B, T] feature mask; a recurrent layer
        starts from its entry of `rnn_carries` (zeros without one) and
        its new carry lands in new_carries (None for other layers)."""
        conf = self.conf
        n = len(conf.layers) if layers_to is None else layers_to
        new_states, new_carries = [], []
        cur, cur_mask = x, mask
        for i, layer in enumerate(conf.layers[:n]):
            if i in conf.preprocessors:
                pre = conf.preprocessors[i]
                cur = pre.preprocess(cur)
                cur_mask = pre.feed_forward_mask(cur_mask, None)
            if isinstance(layer, RECURRENT_LAYERS):
                cur, nc = layer.apply(
                    params[i], cur, train=train, rng=rng, mask=cur_mask,
                    state=None if rnn_carries is None else rnn_carries[i])
                new_states.append(states[i])
            else:
                cur, ns = layer.apply(params[i], cur, train=train, rng=rng,
                                      state=states[i] if states[i] else None,
                                      mask=cur_mask)
                new_states.append(ns if ns is not None else states[i])
                nc = None
            new_carries.append(nc)
            cur_mask = layer.feed_forward_mask(cur_mask, None)
        new_states.extend(states[n:])
        return cur, new_states, new_carries

    # ------------------------------------------------------------------ loss
    def _loss_fn(self, params, states, x, y, lmask=None, train=True,
                 rng=None, fmasks=None, rnn_carries=None):
        """Score = the output layer's per-example loss reduced over the
        batch (`batch_loss`) + L1/L2 (the JAX package's
        MultiLayerNetwork._loss_fn). Returns (loss, (new_states,
        new_carries)), the carries one per layer."""
        conf = self.conf
        out_layer = conf.layers[-1]
        if not isinstance(out_layer, BaseOutputLayer):
            raise ValueError(
                "Last layer must be an OutputLayer to compute a training "
                f"loss; got {type(out_layer).__name__}")
        n_hidden = len(conf.layers) - 1
        cur, new_states, new_carries = self._forward(
            params, states, x, train=train, rng=rng, layers_to=n_hidden,
            mask=fmasks, rnn_carries=rnn_carries)
        if n_hidden in conf.preprocessors:
            cur = conf.preprocessors[n_hidden].preprocess(cur)
        cur = out_layer._maybe_dropout_input(cur, train, rng)
        per_ex = out_layer.per_example_loss_from_input(
            params[-1], cur, y, mask=lmask)
        reg = 0.0
        for layer, p in zip(conf.layers, params):
            reg = reg + layer.regularization_loss(p)
        return (batch_loss(conf, per_ex, lmask) + reg,
                (new_states, new_carries + [None]))

    def _batch_tensors(self, x, y, fm=None, lm=None):
        """(x, y, label mask, feature mask) of a labelled batch as tensors
        on the device in the net's dtype."""
        if y is None:
            raise ValueError("fit needs labels")
        opt = lambda m: None if m is None else self._as_input(m)
        return self._as_input(x), self._as_input(y), opt(lm), opt(fm)

    # ------------------------------------------------------------------- fit
    def fit_batch(self, batch):
        """Train on ONE batch without fit()'s epoch bookkeeping; returns
        the loss (a 0-d tensor on the device, no host sync)."""
        if not self._initialized():
            self.init()
        x, y, fm, lm = _as_batch(batch)
        loss = self._fit_one(*self._batch_tensors(x, y, fm, lm))
        self._notify_iteration()
        return loss

    # ------------------------------------------------------------- inference
    def output(self, x):
        """Full forward pass in inference mode; returns the output layer's
        activations on the network's device in `dtype`."""
        with torch.inference_mode():
            return self._jit_cache["predict"](
                self._compute_params(), self.states, self._as_input(x))

    def _predict(self, params, states, x):
        """The "predict" program's body: the forward in the compute
        dtype, the output back in `dtype`."""
        cd = self.compute_dtype
        if cd is not None:
            x = x.to(cd)
        out, _, _ = self._forward(params, states, x)
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
        x, y, lm, fm = self._batch_tensors(x, y, fm, lm)
        with torch.no_grad():
            loss, _ = self._loss_fn(self._params_view(), self.states, x, y,
                                    lm, train=False, fmasks=fm)
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
        """Stateful streaming inference: x [B, nIn] (one step; returns
        [B, nOut]) or [B, T, nIn] (a chunk; returns [B, T, nOut]). The
        recurrent layers start from `rnn_states` (zeros after init or
        `clear_rnn_state`) and leave their new carries there. Runs under
        no_grad with the f32 params, as the JAX package's does; raises
        ValueError for a bidirectional layer."""
        self._check_streamable()
        with torch.no_grad():
            x = self._as_input(x)
            single = x.ndim == 2
            if single:
                x = x[:, None, :]
            if self.rnn_states is None:
                self.rnn_states = self._initial_carries(x.shape[0])
            out, _, new = self._forward(self._params_view(), self.states,
                                        x, rnn_carries=self.rnn_states)
            self.rnn_states = [n if n is not None else o
                               for n, o in zip(new, self.rnn_states)]
        return out[:, -1, :] if single and out.ndim == 3 else out

    def pretrain(self, data_iterator, epochs: int = 1):
        """Greedy layerwise unsupervised pretraining of the AutoEncoder,
        VariationalAutoencoder and RBM layers, in layer order (frozen
        ones skipped): each trains on its `pretrain_loss` over the
        batches' features fed through the layers before it in inference
        mode, for `epochs` passes, with its own updater state (the
        configuration's updater, fresh per layer) and the configuration's
        rate schedule counted from 0 per layer. Sampling (corruption,
        Gibbs chains, reparameterization noise) draws from the network's
        generator, so a seed gives one result. Returns self."""
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            AutoEncoder,
        )
        from deeplearning4j_tpu_torch.nn.layers.rbm import RBM
        from deeplearning4j_tpu_torch.nn.layers.variational import (
            VariationalAutoencoder,
        )

        if not self._initialized():
            self.init()
        conf = self.conf
        params = list(self.params)
        for li, layer in enumerate(conf.layers):
            if layer.frozen or not isinstance(
                    layer, (AutoEncoder, VariationalAutoencoder, RBM)):
                continue
            upd = get_updater(layer.updater or conf.updater, conf)
            upd_state = upd.init(params[li])
            step = 0
            for _ in range(epochs):
                if hasattr(data_iterator, "reset"):
                    data_iterator.reset()
                for batch in data_iterator:
                    with torch.no_grad():
                        cur = self._as_input(_as_batch(batch)[0])
                        for j in range(li):
                            if j in conf.preprocessors:
                                cur = conf.preprocessors[j].preprocess(cur)
                            cur, _ = conf.layers[j].apply(
                                params[j], cur, train=False,
                                state=self.states[j] or None)
                        if li in conf.preprocessors:
                            cur = conf.preprocessors[li].preprocess(cur)
                    lp = tree_map(lambda t: t.detach().requires_grad_(),
                                  params[li])
                    with torch.enable_grad():
                        loss = layer.pretrain_loss(lp, cur, self._drop_gen)
                        grads = torch.autograd.grad(loss, leaves(lp))
                    with torch.no_grad():
                        grads = unflatten(lp, list(grads))[0]
                        deltas, upd_state = upd.update(
                            grads, upd_state, lp, schedule_lr(conf, step),
                            step)
                        params[li] = tree_map(lambda p, d: p.detach() + d,
                                              lp, deltas)
                    step += 1
            self.params = params
        return self

    def lint_program(self, x, y, fm=None, lm=None, carries=None):
        """The program-lint view of this net's train step: the k=1
        ProgramRecord (analysis/program_lint.py) of
        `StepProgram.lint_records`, the step `fit` runs, called on clones
        of the net's carry; `carries` must be None (a truncated-BPTT
        net's record starts from zero carries)."""
        from deeplearning4j_tpu_torch.engine.step_program import StepProgram

        if carries is not None:
            raise ValueError("lint_program records the step from zero "
                             "recurrent carries; pass carries=None")
        return StepProgram(self).lint_records(x, y, fm, lm)[0]

    # -------------------------------------------------------------- plumbing
    def get_layer(self, i: int) -> Layer:
        return self.conf.layers[i]

    def n_layers(self) -> int:
        return len(self.conf.layers)
