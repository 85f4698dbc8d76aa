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
  - dropout: one `torch.Generator` per network, on its device, seeded
    from the configuration's seed at `init`. Every train-mode layer with
    dropout draws its mask from it, in the network's fixed layer order,
    so one generator state gives one set of masks; `_rng_state` /
    `_set_rng_state` let snapshots rewind it with the rest of the state.

A container supplies `_layer_items()` (its (key, layer) pairs in
parameter order: node names for a graph, indices for a layer list),
`_pack(values)` (a per-layer container in that order: a dict for a
graph, a list for a layer list), `_loss_fn` and, when it has one,
`_build_flat_chain`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.dtype import canonical_dtype, cast_floating
from deeplearning4j_tpu_torch.nn.updater import (
    apply_score_decay,
    fused_apply,
    get_updater,
    schedule_lr,
)
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


def tree_to(tree, device):
    """Every tensor of a nested dict/list moved to `device`."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


def _grad_norm(tree):
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves(tree)) + 1e-12)


def _per_layer(fn, grads):
    """fn over each layer's grads of a dict (graph) or list (layer list)."""
    if isinstance(grads, dict):
        return {k: fn(lg) for k, lg in grads.items()}
    return [fn(lg) for lg in grads]


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
    unmasked element), so fully masked padding rows do not dilute it."""
    if label_mask is not None:
        lm = label_mask
        active = lm if lm.ndim == 1 else torch.any(lm > 0, dim=1).to(lm.dtype)
        s = per_ex.sum()
        return s / torch.clamp_min(active.sum(), 1.0) if conf.minibatch \
            else s
    return per_ex.mean() if conf.minibatch else per_ex.sum()


def _rng_seed(seed: int) -> int:
    """The dropout generator's seed: the configuration's seed folded with
    0xBEEF (the JAX package folds its dropout chain the same way), so
    masks and initial weights come from different streams."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0xBEEF) % (1 << 63)


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
        self._cast_params = None      # params in the compute dtype (cache)
        self._drop_gen: Optional[torch.Generator] = None
        self.iteration = 0
        self.epoch = 0
        self._score = None
        self._lr_score_factor = 1.0   # lr_policy="score" decay state
        self._best_score = None

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

    def _loss_for_grad(self, params, states, inputs, labels, lmasks):
        """The train loss under the mixed-precision policy: params and
        inputs cast to the compute dtype inside autograd (so gradients
        reach the f32 master params in f32), the loss cast back, dropout
        masks drawn from the network's generator. Returns (loss,
        new_states)."""
        cd = self.compute_dtype
        if cd is not None:
            params = cast_floating(params, cd)
            inputs = cast_floating(inputs, cd)
        loss, new_states = self._loss_fn(params, states, inputs, labels,
                                         lmasks, train=True,
                                         rng=self._train_rng())
        if cd is not None:
            loss = loss.to(self.dtype)
        return loss, new_states

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

    def _step(self, carry, inputs, labels, lmasks, scalars):
        """ONE train step on an explicit carry — the step math every
        caller shares: forward (`_loss_for_grad`), `torch.autograd.grad`,
        `clip_grads` and the update (`_apply_updates`). `scalars` is one
        row of `_step_scalars` ([2]: lr, step index, as tensors, so no
        Python number of the step reaches a kernel). Returns (new carry,
        loss); reads no value back to the host, allocates only on the
        device, and of the net's state touches only the dropout
        generator, which its masks advance."""
        params, upd, states = carry
        flat = isinstance(params, torch.Tensor)
        if flat:
            leaf = params.detach().requires_grad_()
            ps = [leaf]
        else:
            leaf = tree_map(lambda t: t.detach().requires_grad_(), params)
            ps = leaves(leaf)
        with torch.enable_grad():
            loss, new_states = self._loss_for_grad(
                self._flat_chain.unravel(leaf) if flat else leaf, states,
                inputs, labels, lmasks)
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        with torch.no_grad():
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ps, gs)]
            grads = clip_grads(self.conf, gs[0] if flat
                               else unflatten(leaf, gs)[0])
            new_p, new_u = self._apply_updates(params, upd, grads,
                                               scalars[0], scalars[1])
        return (new_p, new_u, new_states), loss.detach()

    def _train_step(self, inputs, labels, lmasks=None):
        """One forward, backward and update (`_step`) on the net's own
        carry; advances the iteration and sets the score."""
        carry, loss = self._step(self._train_carry(), inputs, labels,
                                 lmasks, self._step_scalars(self.iteration)[0])
        self._set_train_carry(carry)
        self.iteration += 1
        self._score = loss
        apply_score_decay(self, self._score)
        return self._score

    def _require_sgd(self):
        if self.conf.optimization_algo not in (
                "stochastic_gradient_descent", "sgd"):
            raise NotImplementedError(
                f"optimization_algo {self.conf.optimization_algo!r} is not "
                f"ported yet (ROADMAP queue 5)")

