"""The train-step contract both network containers share: ComputationGraph
(nn/graph.py) and MultiLayerNetwork (nn/multilayer.py).

The JAX package writes this contract twice, once per container; here it
is one base class, so the engine (engine/step_program.py,
engine/harness.py, earlystopping/, resilience/) reads one interface:

  - state: `device`, `dtype`, `compute_dtype`, `iteration`, `epoch`,
    `_score`, `_params` / `_flat_train` (the per-layer params, or the
    flat carry of updater/flat_chain.py while it is live), `states` (BN
    running statistics), `updater_states`;
  - the step: `_train_carry` / `_set_train_carry`, `_step_scalars`,
    `_step` (forward, `torch.autograd.grad`, `clip_grads`, update on an
    explicit carry), `_train_step`, `_frozen`;
  - recurrent state: feature masks and RNN carries go through `_step`
    beside the train carry, never inside it; `_fit_one` runs a batch as
    one step or, for a truncated-BPTT net on 3-D input, as `_fit_tbptt`'s
    chunks (each a full `_train_step`, the carries detached between
    them); `rnn_states` holds `rnn_time_step`'s streaming carries, apart
    from any chunk's;
  - listeners: `listeners`, `set_listeners`, `add_listeners` and `fit`
    (on_epoch_start/on_epoch_end around each epoch, the fetch time in
    `_last_etl_ms`; the container's `fit_batch` calls iteration_done);
  - inference: `output` runs the program stored under "predict" in
    `_jit_cache` (nn/jit_cache.JitCache). It records a trace on its first
    call with each input signature (shapes, dtypes, the train flag) —
    where the JAX package's jitted predict retraces — so serving's "zero
    new traces after warmup" pin reads the same counters in both
    packages; the arithmetic is the container's `_predict` body;
  - dropout: one `torch.Generator` per network, on its device, seeded
    from the configuration's seed at `init`. Every train-mode layer with
    dropout draws its mask from it, in the network's fixed layer order,
    so one generator state gives one set of masks; `_rng_state` /
    `_set_rng_state` let snapshots rewind it with the rest of the state.

A container supplies `_layer_items()` (its (key, layer) pairs in
parameter order: node names for a graph, indices for a layer list),
`_pack(values)` (a per-layer container in that order: a dict for a
graph, a list for a layer list), `_loss_fn` (returning (loss,
(new_states, new_carries)), as the JAX package's) and, when it has one,
`_build_flat_chain`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.jit_cache import JitCache, policy_name
from deeplearning4j_tpu_torch.nn.conf.network import BackpropType
from deeplearning4j_tpu_torch.nn.dtype import canonical_dtype, cast_floating
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    RECURRENT_LAYERS,
    GravesBidirectionalLSTM,
)
from deeplearning4j_tpu_torch.nn.updater import (
    apply_score_decay,
    fused_apply,
    get_updater,
    schedule_lr,
)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import tp_scope
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


def tree_to(tree, device):
    """Every tensor of a nested dict/list moved to `device`."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


def _grad_norm(tree):
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves(tree)) + 1e-12)


def _per_layer(fn, grads):
    """fn over each layer's grads of a dict (graph) or list (layer list);
    a layer without gradients (no params, or frozen) passes through."""
    apply = lambda lg: fn(lg) if leaves(lg) else lg
    if isinstance(grads, dict):
        return {k: apply(lg) for k, lg in grads.items()}
    return [apply(lg) for lg in grads]


def clip_grads(conf, grads):
    """Gradient normalization (the JAX package's
    MultiLayerNetwork._clip_grads): a global-norm clip (max_grad_norm),
    then the configured mode over the per-layer grads (a dict or a list),
    or over one flat gradient on the flat chain (elementwise modes only)."""
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
        return _per_layer(lambda lg: tree_map(
            lambda g, s=torch.clamp_max(t / _grad_norm(lg), 1.0): g * s, lg),
            grads)
    if gn == "renormalize_l2_per_layer":
        return _per_layer(lambda lg: tree_map(
            lambda g, s=1.0 / _grad_norm(lg): g * s, lg), grads)
    if gn == "clip_l2_per_param_type":
        return tree_map(lambda g: g * torch.clamp_max(
            t / torch.sqrt(torch.sum(g * g) + 1e-12), 1.0), grads)
    if gn == "renormalize_l2_per_param_type":
        return tree_map(lambda g: g / torch.sqrt(torch.sum(g * g) + 1e-12),
                        grads)
    raise ValueError(f"Unknown gradient normalization '{gn}'")


def batch_loss(conf, per_ex, label_mask=None):
    """An output layer's per-example loss reduced as the JAX package
    reduces it: the mean over the batch (`minibatch`), or with a label
    mask the sum over the number of active examples (rows with any
    unmasked element), so fully masked padding rows do not dilute it.

    Under per-step data parallelism (a `collectives.dp_scope` of world
    W > 1) each rank holds its equal share of the global batch and the
    ranks' losses and gradients are averaged, so a rank returns W times
    its share of the GLOBAL loss: its masked sum over the global count of
    active rows (one all-reduce), or its sum without `minibatch`; the
    unmasked mean over equal shares needs no change."""
    from deeplearning4j_tpu_torch.parallel import collectives

    dp = collectives.current()
    w = 1 if dp is None else dp.world
    if label_mask is not None:
        lm = label_mask
        active = lm if lm.ndim == 1 else torch.any(lm > 0, dim=1).to(lm.dtype)
        s = per_ex.sum()
        if not conf.minibatch:
            return s * w if w > 1 else s
        n = active.sum()
        if w > 1:
            n = collectives.all_reduce_sum(n.detach().clone(), dp)
            return s * w / torch.clamp_min(n, 1.0)
        return s / torch.clamp_min(n, 1.0)
    if conf.minibatch:
        return per_ex.mean()
    return per_ex.sum() * w if w > 1 else per_ex.sum()


def _rng_seed(seed: int) -> int:
    """The dropout generator's seed: the configuration's seed folded with
    0xBEEF (the JAX package folds its dropout chain the same way), so
    masks and initial weights come from different streams."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0xBEEF) % (1 << 63)


def _dp_mean(grads, loss, group=None):
    """Per-step dp: the gradients (one flat tensor on the flat carry, else
    a per-layer tree, None leaves skipped) and the loss averaged over the
    ranks of the dp `group` (a collectives.AxisGroup; None: the live dp
    axis) in ONE all-reduce of a packed bucket. Returns (grads, loss)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    gl = leaves(grads)
    dt = gl[0].dtype if gl else loss.dtype
    buf = collectives.dp_all_reduce_mean(torch.cat(
        [g.reshape(-1).to(dt) for g in gl]
        + [loss.detach().reshape(1).to(dt)]), group)
    parts = torch.split(buf, [g.numel() for g in gl] + [1])
    out = [p.view(g.shape).to(g.dtype) for p, g in zip(parts, gl)]
    return unflatten(grads, out)[0], parts[-1][0].to(loss.dtype)


class BaseNetwork:
    """The state and train step both containers share (module docstring).
    Subclasses call `_init_state` from their constructor."""

    def _init_state(self, dtype, compute_dtype, device):
        self.device = resolve_device(device)
        self.dtype = canonical_dtype(dtype)
        self.compute_dtype = canonical_dtype(compute_dtype)
        self._params = None
        self.states = None
        self._upd_states = None
        self._updaters = None
        self._flat_train = None       # (flat params, flat updater state)
        self._flat_chain = "uninit"   # grad-over-flat carrier (updater/)
        self._solver = None           # line-search solver (optimize/)
        self._cast_params = None      # params in the compute dtype (cache)
        self._drop_gen: Optional[torch.Generator] = None
        self.rnn_states = None        # rnn_time_step's carries
        self.iteration = 0
        self.epoch = 0
        self._score = None
        self._lr_score_factor = 1.0   # lr_policy="score" decay state
        self._best_score = None
        # training listeners: iteration_done(net, iteration) after each
        # fit_batch, on_epoch_start/on_epoch_end(net) around fit's epochs
        self.listeners: List = []
        self._last_etl_ms = None
        self._last_batch_size = None
        # per-step data parallelism (parallel/collectives.py): the dp
        # group whose ranks average this net's gradients each step (None:
        # one process); a ZeRO-1 attach (StepProgram.attach_mesh) replaces
        # the step itself and keeps its engine/mesh.py MeshManager here
        self._dp = None
        self._step_impl = None
        self._mesh_manager = None
        # tensor parallelism (parallel/tensor_parallel.py): the plan whose
        # slices of the params this rank holds while a fit runs (None: the
        # params are whole)
        self._tp = None
        self._jit_cache = JitCache()
        self._jit_cache["predict"] = self._predict_program()
        self._jit_cache.register_policy("predict",
                                        policy_name(self.compute_dtype))

    # --------------------------------------------------------- inference
    def _predict_program(self):
        """The "predict" program: the container's `_predict(params,
        states, inputs)`, recording a trace on the first call with each
        input signature."""
        seen = set()
        lock = threading.Lock()

        def predict(params, states, inputs):
            items = inputs.items() if isinstance(inputs, dict) \
                else [(None, inputs)]
            sig = (tuple((k, tuple(x.shape), str(x.dtype))
                         for k, x in items), False)
            with lock:
                new = sig not in seen
                seen.add(sig)
            if new:
                self._jit_cache.record_trace("predict")
            return self._predict(params, states, inputs)

        return predict

    # --------------------------------------------------------- listeners
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def _notify_iteration(self) -> None:
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)

    def fit(self, data, labels=None, epochs: int = 1):
        """Train on a dataset iterator, (x, y) arrays, a (x, y[, fm, lm])
        tuple (one batch) or an iterable of batches; both containers'
        fit. Each epoch calls the listeners' on_epoch_start, times each
        batch's fetch into `_last_etl_ms`, runs `fit_batch` (which
        notifies iteration_done), advances `epoch` and calls
        on_epoch_end, as the JAX package's fit does."""
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

    # ------------------------------------------------- container hooks
    def _layer_items(self) -> List[Tuple[Any, Any]]:
        raise NotImplementedError

    def _pack(self, values):
        raise NotImplementedError

    def _build_flat_chain(self):
        return None

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
            self._flat_chain = self._build_flat_chain()
        return self._flat_chain

    def _initialized(self) -> bool:
        return self._params is not None or self._flat_train is not None

    # ------------------------------------------------------------------ init
    def _finish_init(self, params, states, seed):
        """Bind freshly drawn params and states (on the CPU) to the
        device, initialize the updaters and seed the dropout generator."""
        self._flat_train = None
        self._flat_chain = "uninit"
        self.params = tree_to(params, self.device)
        self.states = tree_to(states, self.device)
        self._init_updaters()
        self._drop_gen = torch.Generator(device=self.device).manual_seed(
            _rng_seed(seed))
        self.clear_rnn_state()
        return self

    def _init_updaters(self):
        items = self._layer_items()
        self._updaters = self._pack(
            [get_updater(l.updater or self.conf.updater, self.conf)
             for _, l in items])
        self.updater_states = self._pack(
            [self._updaters[k].init(self._params[k]) for k, _ in items])

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in leaves(self.params))

    # --------------------------------------------------------------- dropout
    def _has_dropout(self) -> bool:
        return any(l.dropout and l.dropout > 0 for _, l in
                   self._layer_items())

    def _train_rng(self) -> Optional[torch.Generator]:
        """The generator a train step's dropout masks come from (None
        when no layer has dropout)."""
        if not self._has_dropout():
            return None
        if self._drop_gen is None:
            self._drop_gen = torch.Generator(device=self.device).manual_seed(
                _rng_seed(self.conf.seed))
        return self._drop_gen

    def _rng_state(self):
        """A copy of the dropout generator's state (None without one)."""
        return None if self._drop_gen is None else self._drop_gen.get_state()

    def _set_rng_state(self, state) -> None:
        if state is not None:
            self._drop_gen.set_state(state)

    # ------------------------------------------------------------ inputs
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

    # ------------------------------------------------------------ train step
    def _frozen(self):
        return {k for k, l in self._layer_items() if l.frozen}

    def _loss_for_grad(self, params, states, inputs, labels, lmasks,
                       fmasks=None, rnn_carries=None):
        """The train loss under the mixed-precision policy: params, inputs
        and RNN carries cast to the compute dtype inside autograd (so
        gradients reach the f32 master params in f32), the loss and the
        new carries cast back to the master dtype, dropout masks drawn
        from the network's generator; feature masks, labels and label
        masks are not cast. Returns (loss, new_states, new_carries)."""
        cd = self.compute_dtype
        if cd is not None:
            params = cast_floating(params, cd)
            inputs = cast_floating(inputs, cd)
            rnn_carries = cast_floating(rnn_carries, cd)
        tp = getattr(self, "_tp", None)
        if tp is not None:
            params = tp.expand(params)
        with tp_scope(None if tp is None else tp.group):
            loss, (new_states, new_carries) = self._loss_fn(
                params, states, inputs, labels, lmasks, train=True,
                rng=self._train_rng(), fmasks=fmasks,
                rnn_carries=rnn_carries)
        if cd is not None:
            loss = loss.to(self.dtype)
            new_carries = cast_floating(new_carries, self.dtype)
        return loss, new_states, new_carries

    def _train_carry(self):
        """The state a train step reads: (params, updater state, BN
        states). On the flat chain (eligible configuration, nothing
        frozen) params is one flat tensor and the updater state {field:
        flat tensor}, raveled on first use; else the per-layer trees."""
        chain = self._flat_chain_obj() if not self._frozen() else None
        if chain is None:
            return self.params, self.updater_states, self.states
        if self._flat_train is None:
            flat = chain.ravel(self._params)
            uflat = chain.ravel_upd(self._upd_states)
            # the live state is the flat carry; keep only a skeleton
            self._upd_states = chain.upd_skeleton(self._upd_states)
            self._params = None
            self._flat_train = (flat, uflat)
        return self._flat_train + (self.states,)

    def _set_train_carry(self, carry):
        """Rebind the net's state to a carry shaped as `_train_carry`
        returns it."""
        params, upd, states = carry
        if isinstance(params, torch.Tensor):
            if self._flat_train is None:
                self._upd_states = self._flat_chain_obj().upd_skeleton(
                    self._upd_states)
            self._params = None
            self._flat_train = (params, upd)
        else:
            self.params = params
            self.updater_states = upd
        self._cast_params = None
        self.states = states

    def _params_view(self):
        """The per-layer params without dropping the flat carry (views
        of it when it is live): for readers that mutate nothing."""
        if self._flat_train is not None:
            return self._flat_chain.unravel(self._flat_train[0])
        return self._params

    def _upd_view(self):
        """The per-layer updater state, as `_params_view`."""
        if self._flat_train is not None:
            return self._flat_chain.unravel_upd(self._flat_train[1],
                                                self._upd_states)
        return self._upd_states

    def _step_scalars(self, first_step: int, k: int = 1) -> torch.Tensor:
        """[k, 2] per-step scalars of steps first_step .. first_step+k-1:
        (learning rate, step index), computed on the host in double and
        rounded once to f32 (f64 for an f64 master), whatever the master
        dtype: the JAX package passes the step as int32 and the rate in
        f32, so a bf16 master must not round step 257 to 256. On the
        device; the copy leaves from pinned memory without waiting."""
        conf = self.conf
        rows = [[schedule_lr(conf, s) * self._lr_score_factor, float(s)]
                for s in range(first_step, first_step + k)]
        host = torch.tensor(rows, dtype=torch.promote_types(
            self.dtype, torch.float32))
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _lr_factor(self, layer):
        lr = getattr(layer, "learning_rate", None)
        if lr is None or self.conf.learning_rate == 0:
            return 1.0
        return lr / self.conf.learning_rate

    def _apply_updates(self, params, upd, grads, lr, step):
        """The update: the flat chain's one elementwise rule when
        `params` is the flat vector, else the per-layer rules with their
        lr factors and frozen flags (`fused_apply`). Returns (params,
        updater state)."""
        if isinstance(params, torch.Tensor):
            deltas, new_u = self._flat_chain.updater.update(
                grads, upd, params, lr, step)
            return params + deltas, new_u
        frozen = self._frozen()
        np_list, nu_list = fused_apply(
            [(self._updaters[k], self._lr_factor(l), k in frozen, params[k],
              grads[k], upd[k]) for k, l in self._layer_items()], lr, step)
        return self._pack(np_list), self._pack(nu_list)

    def _grad_leaves(self, params):
        """The per-layer params as the train step differentiates them:
        detached, and autograd leaves except in frozen layers, so the
        backward stops at the frozen boundary and runs nothing for a
        frozen prefix. A global-norm clip (`max_grad_norm`) sums the
        frozen layers' gradients too, as the JAX package's does, so
        under it every layer is a leaf."""
        frozen = set() if self.conf.max_grad_norm else self._frozen()
        return self._pack([
            tree_map(lambda t: t.detach() if k in frozen
                     else t.detach().requires_grad_(), params[k])
            for k, _ in self._layer_items()])

    def _grads(self, params, states, inputs, labels, lmasks, fmasks=None,
               rnn_carries=None, dp=None):
        """Forward (`_loss_for_grad`) and `torch.autograd.grad` on `params`
        (the carry's: one flat tensor or the per-layer trees), BatchNorm
        statistics and the loss's row count global over `dp` (a
        collectives.DPGroup; None: this rank's batch alone). Returns
        (grads, loss, new_states, new RNN carries): grads one flat tensor
        or the per-layer tree with None for frozen leaves, unclipped and
        not averaged over ranks."""
        from deeplearning4j_tpu_torch.parallel import collectives

        flat = isinstance(params, torch.Tensor)
        if flat:
            leaf = params.detach().requires_grad_()
            ps = [leaf]
        else:
            leaf = self._grad_leaves(params)
            ps = [t for t in leaves(leaf) if t.requires_grad]
        with torch.enable_grad(), collectives.dp_scope(dp):
            loss, new_states, new_rnn = self._loss_for_grad(
                self._flat_chain.unravel(leaf) if flat else leaf, states,
                inputs, labels, lmasks, fmasks, rnn_carries)
            gs = (torch.autograd.grad(loss, ps, allow_unused=True)
                  if ps else ())
        gs = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(ps, gs)])
        if flat:
            grads = next(gs)
        else:
            # a frozen layer has no gradient: None leaves, which the
            # clip passes over and the update never reads
            grads = unflatten(leaf, [next(gs) if t.requires_grad
                                     else None for t in leaves(leaf)])[0]
        return grads, loss.detach(), new_states, new_rnn

    def _step(self, carry, inputs, labels, lmasks, scalars, fmasks=None,
              rnn_carries=None):
        """ONE train step on an explicit carry — the step math every
        caller shares (`run`, `run_group`, each truncated-BPTT chunk):
        forward and `torch.autograd.grad` (`_grads`), under per-step data
        parallelism (`_dp`, world > 1) the gradients and loss averaged
        over the dp ranks in one all-reduce, `clip_grads` (under tensor
        parallelism, `_tp`, the plan's: the params are this rank's
        slices) and the update (`_apply_updates`). `scalars` is one row of `_step_scalars` ([2]:
        lr, step index, as tensors, so no Python number of the step
        reaches a kernel); `fmasks` the feature masks, `rnn_carries` the
        recurrent layers' carries to start from (None: zeros). Returns
        (new carry, loss, new RNN carries, detached); reads no value back
        to the host, allocates only on the device, and of the net's state
        touches only the dropout generator, which its masks advance."""
        params, upd, states = carry
        dp = getattr(self, "_dp", None)
        tp = getattr(self, "_tp", None)
        grads, loss, new_states, new_rnn = self._grads(
            params, states, inputs, labels, lmasks, fmasks, rnn_carries, dp)
        with torch.no_grad():
            if dp is not None and dp.world > 1:
                grads, loss = _dp_mean(grads, loss, dp)
            grads = (clip_grads(self.conf, grads) if tp is None
                     else tp.clip(self.conf, grads))
            new_p, new_u = self._apply_updates(params, upd, grads,
                                               scalars[0], scalars[1])
        new_rnn = tree_map(lambda t: t.detach(), new_rnn)
        return (new_p, new_u, new_states), loss, new_rnn

    def _train_step(self, inputs, labels, lmasks=None, fmasks=None,
                    rnn_carries=None):
        """One forward, backward and update (`_step`) on the net's own
        carry; advances the iteration and sets the score (and the batch
        rows listeners read as `_last_batch_size`). Returns (loss, new RNN
        carries)."""
        self._last_batch_size = int(leaves(inputs)[0].shape[0])
        carry, loss, new_rnn = (getattr(self, "_step_impl", None)
                                 or self._step)(
            self._train_carry(), inputs, labels, lmasks,
            self._step_scalars(self.iteration)[0], fmasks, rnn_carries)
        self._set_train_carry(carry)
        self.iteration += 1
        self._score = loss
        apply_score_decay(self, self._score)
        return self._score, new_rnn

    # --------------------------------------------------- recurrent training
    def _fit_one(self, inputs, labels, lmasks=None, fmasks=None):
        """Train on one batch of tensors (as `_batch_tensors` gives them):
        truncated BPTT for a TBPTT net whose every input is 3-D, else one
        line-search solver iteration when the configuration names a
        solver, else one `_train_step`. Returns the (last chunk's) loss."""
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and all(t.ndim == 3 for t in leaves(inputs))):
            return self._fit_tbptt(inputs, labels, lmasks, fmasks)
        if self._use_solver():
            return self._solver_step(inputs, labels, lmasks, fmasks)
        return self._train_step(inputs, labels, lmasks, fmasks)[0]

    def _use_solver(self) -> bool:
        return getattr(self.conf, "optimization_algo",
                       "stochastic_gradient_descent") not in (
            "stochastic_gradient_descent", "sgd")

    def _solver_step(self, inputs, labels, lmasks, fmasks):
        """One iteration of the configuration's line-search solver
        (optimize/solvers.py, built on first use and kept, with its
        history, across batches); advances the iteration and sets the
        score."""
        from deeplearning4j_tpu_torch.optimize.solvers import make_solver

        if self._solver is None:
            self._solver = make_solver(self.conf.optimization_algo, self)
        self._last_batch_size = int(leaves(inputs)[0].shape[0])
        loss = self._solver.step(inputs, labels, lmasks, fmasks)
        self.iteration += 1
        self._score = torch.tensor(loss, dtype=self.dtype, device=self.device)
        return self._score

    def _fit_tbptt(self, inputs, labels, lmasks, fmasks):
        """Truncated BPTT: the time axis cut into chunks of
        `tbptt_fwd_length` (the last may be shorter), each chunk one full
        train step (iteration, updater step, lr schedule and dropout draw
        advance per chunk) that starts from the previous chunk's RNN
        carries, detached, so gradients stay within a chunk. Inputs and
        masks whose axis 1 is the time axis are sliced with it, labels
        when they are 3-D. Returns the last chunk's loss."""
        first = leaves(inputs)[0]
        batch, T = int(first.shape[0]), int(first.shape[1])
        L = self.conf.tbptt_fwd_length
        carries = self._initial_carries(batch)
        loss = None
        for start in range(0, T, L):
            timed = lambda t, s=slice(start, start + L): (
                t[:, s] if t.ndim >= 2 and t.shape[1] == T else t)
            loss, carries = self._train_step(
                tree_map(timed, inputs),
                tree_map(lambda y, s=slice(start, start + L):
                         y[:, s] if y.ndim == 3 else y, labels),
                tree_map(timed, lmasks), tree_map(timed, fmasks),
                rnn_carries=carries)
        return loss

    def _initial_carries(self, batch_size):
        """Zero carries, in the master dtype, for every recurrent layer
        (None for the others), packed per layer."""
        return self._pack([
            layer.initial_carry(batch_size, self.dtype, self.device)
            if isinstance(layer, RECURRENT_LAYERS) else None
            for _, layer in self._layer_items()])

    def _check_streamable(self):
        if any(isinstance(layer, GravesBidirectionalLSTM)
               for _, layer in self._layer_items()):
            # the backward direction needs the whole sequence
            raise ValueError(
                "rnn_time_step is not supported for bidirectional RNN "
                "layers; use output() on the full sequence")

    def clear_rnn_state(self):
        """Forget `rnn_time_step`'s carries; the next call starts from
        zeros."""
        self.rnn_states = None
