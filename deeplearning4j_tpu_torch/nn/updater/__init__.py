"""Updaters and learning-rate schedules (counterpart of
deeplearning4j_tpu/nn/updater/__init__.py).

The same nine rules (sgd, none, nesterovs, adagrad, rmsprop, adadelta,
adam, adamax, nadam), the same `sig`s, registry and eight schedule
policies, and `fused_apply`'s cross-layer fusion:

    init(params) -> state
    update(grads, state, params, lr, step) -> (deltas, new_state)

with `new_params = params + deltas` applied by the container. `params`,
`grads` and states are trees of tensors (nested dicts, or one flat tensor
on the flat chain). The rules are pure: they return new tensors, run under
`torch.no_grad()` in the containers, and never update in place. `lr` and
`step` are host numbers (PyTorch runs eagerly; the schedule is computed
per step on the host).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


class Updater(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr, step)
    # hashable identity of the rule + hyperparams; layers whose sig and lr
    # factor match are fused into one flattened update (fused_apply).
    # None (custom updaters) opts out of fusion.
    sig: Any = None


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


# ---------------- updaters ----------------

def sgd() -> Updater:
    def init(params):
        return ()

    def update(grads, state, params, lr, step):
        return tree_map(lambda g: -lr * g, grads), state

    return Updater(init, update, ("sgd",))


def none_updater() -> Updater:
    def init(params):
        return ()

    def update(grads, state, params, lr, step):
        return tree_map(torch.zeros_like, grads), state

    return Updater(init, update, ("none",))


def nesterovs(momentum: float = 0.9) -> Updater:
    """Nesterov momentum, reference formulation:
    v' = mu*v - lr*g ; delta = mu*v' - lr*g."""

    def init(params):
        return {"v": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        v_new = tree_map(lambda v, g: momentum * v - lr * g, state["v"],
                         grads)
        deltas = tree_map(lambda v, g: momentum * v - lr * g, v_new, grads)
        return deltas, {"v": v_new}

    return Updater(init, update, ("nesterovs", momentum))


def adagrad(epsilon: float = 1e-6) -> Updater:
    def init(params):
        return {"h": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        h_new = tree_map(lambda h, g: h + g * g, state["h"], grads)
        deltas = tree_map(lambda h, g: -lr * g / (torch.sqrt(h) + epsilon),
                          h_new, grads)
        return deltas, {"h": h_new}

    return Updater(init, update, ("adagrad", epsilon))


def rmsprop(decay: float = 0.95, epsilon: float = 1e-8) -> Updater:
    def init(params):
        return {"ms": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        ms = tree_map(lambda m, g: decay * m + (1 - decay) * g * g,
                      state["ms"], grads)
        deltas = tree_map(lambda m, g: -lr * g / torch.sqrt(m + epsilon),
                          ms, grads)
        return deltas, {"ms": ms}

    return Updater(init, update, ("rmsprop", decay, epsilon))


def adadelta(rho: float = 0.95, epsilon: float = 1e-6) -> Updater:
    def init(params):
        return {"msg": _zeros_like(params), "msdx": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        msg = tree_map(lambda m, g: rho * m + (1 - rho) * g * g,
                       state["msg"], grads)
        deltas = tree_map(
            lambda m, d, g: -g * torch.sqrt(d + epsilon)
            / torch.sqrt(m + epsilon), msg, state["msdx"], grads)
        msdx = tree_map(lambda d, dx: rho * d + (1 - rho) * dx * dx,
                        state["msdx"], deltas)
        return deltas, {"msg": msg, "msdx": msdx}

    return Updater(init, update, ("adadelta", rho, epsilon))


def adam(beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8) -> Updater:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        t = step + 1
        m = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g, state["m"],
                     grads)
        v = tree_map(lambda v, g: beta2 * v + (1 - beta2) * g * g,
                     state["v"], grads)
        alpha = lr * math.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
        deltas = tree_map(lambda m, v: -alpha * m / (torch.sqrt(v) + epsilon),
                          m, v)
        return deltas, {"m": m, "v": v}

    return Updater(init, update, ("adam", beta1, beta2, epsilon))


def adamax(beta1: float = 0.9, beta2: float = 0.999,
           epsilon: float = 1e-8) -> Updater:
    def init(params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        t = step + 1
        m = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g, state["m"],
                     grads)
        u = tree_map(lambda u, g: torch.maximum(beta2 * u, torch.abs(g)),
                     state["u"], grads)
        alpha = lr / (1 - beta1 ** t)
        deltas = tree_map(lambda m, u: -alpha * m / (u + epsilon), m, u)
        return deltas, {"m": m, "u": u}

    return Updater(init, update, ("adamax", beta1, beta2, epsilon))


def nadam(beta1: float = 0.9, beta2: float = 0.999,
          epsilon: float = 1e-8) -> Updater:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def update(grads, state, params, lr, step):
        t = step + 1
        m = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g, state["m"],
                     grads)
        v = tree_map(lambda v, g: beta2 * v + (1 - beta2) * g * g,
                     state["v"], grads)
        bc1 = 1 - beta1 ** t
        bc2 = 1 - beta2 ** t
        deltas = tree_map(
            lambda m, v, g: -lr * (beta1 * m / bc1 + (1 - beta1) * g / bc1)
            / (torch.sqrt(v / bc2) + epsilon), m, v, grads)
        return deltas, {"m": m, "v": v}

    return Updater(init, update, ("nadam", beta1, beta2, epsilon))


_CUSTOM_UPDATERS: Dict[str, Callable] = {}


def register_updater(name: str, factory) -> None:
    """Register a custom updater factory `factory(conf) -> Updater` under
    `name`; registered names win over builtins."""
    _CUSTOM_UPDATERS[str(name).lower()] = factory


def get_updater(name: str, conf=None) -> Updater:
    """Build an updater by name, pulling hyperparams from a configuration
    when given (a conf attr of None means the updater's own default)."""
    n = str(name).lower()
    if n in _CUSTOM_UPDATERS:
        return _CUSTOM_UPDATERS[n](conf)

    def g(attr, default):
        v = getattr(conf, attr, None) if conf is not None else None
        return default if v is None else v

    if n == "sgd":
        return sgd()
    if n == "none":
        return none_updater()
    if n in ("nesterovs", "nesterov"):
        return nesterovs(momentum=g("momentum", 0.9))
    if n == "adagrad":
        return adagrad(epsilon=g("epsilon", 1e-6))
    if n == "rmsprop":
        return rmsprop(decay=g("rmsprop_decay", 0.95),
                       epsilon=g("epsilon", 1e-8))
    if n == "adadelta":
        return adadelta(rho=g("rho", 0.95), epsilon=g("epsilon", 1e-6))
    if n == "adam":
        return adam(beta1=g("beta1", 0.9), beta2=g("beta2", 0.999),
                    epsilon=g("epsilon", 1e-8))
    if n == "adamax":
        return adamax(beta1=g("beta1", 0.9), beta2=g("beta2", 0.999),
                      epsilon=g("epsilon", 1e-8))
    if n == "nadam":
        return nadam(beta1=g("beta1", 0.9), beta2=g("beta2", 0.999),
                     epsilon=g("epsilon", 1e-8))
    raise ValueError(
        f"Unknown updater '{name}'. Known: sgd, none, nesterovs, "
        "adagrad, rmsprop, adadelta, adam, adamax, nadam"
        + (f" + custom {sorted(_CUSTOM_UPDATERS)}"
           if _CUSTOM_UPDATERS else "")
        + ". Custom updaters register via "
        "nn.updater.register_updater(name, factory).")


# ---------------- LR schedules ----------------

def schedule_lr(conf, step) -> float:
    """Effective learning rate at `step`: none, exponential, inverse,
    poly, sigmoid, step, torch_step, schedule ('score' returns the base;
    the container multiplies in its host-tracked decay factor)."""
    base = conf.learning_rate
    policy = getattr(conf, "lr_policy", "none") or "none"
    decay = getattr(conf, "lr_policy_decay_rate", 0.0)
    steps = getattr(conf, "lr_policy_steps", 1.0)
    power = getattr(conf, "lr_policy_power", 1.0)
    it = float(step)
    if policy in ("none", "score"):
        return float(base)
    if policy == "exponential":
        return base * decay ** it
    if policy == "inverse":
        return base / (1.0 + decay * it) ** power
    if policy == "poly":
        frac = min(max(it / max(steps, 1.0), 0.0), 1.0)
        return base * (1.0 - frac) ** power
    if policy == "sigmoid":
        return base / (1.0 + math.exp(-decay * (it - steps)))
    if policy in ("step", "torch_step"):
        return base * decay ** math.floor(it / steps)
    if policy == "schedule":
        lr = float(base)
        for k in sorted(conf.lr_schedule or {}):
            if it >= k:
                lr = float(conf.lr_schedule[k])
        return lr
    raise ValueError(f"Unknown lr policy '{policy}'")


def fused_apply(items, lr, step):
    """Apply per-layer updater rules with cross-layer fusion.

    `items`: one (updater, lr_factor, frozen, params, grads, state) tuple
    per layer. Layers whose updater `sig` and lr factor match are updated
    as ONE flattened 1-D buffer per dtype: the same elementwise math as
    per layer, so the numbers are the same. Frozen and parameterless
    layers pass through; updaters without a `sig` take the per-layer path.
    Returns (new_params_list, new_state_list) aligned with `items`.
    """
    new_p = [None] * len(items)
    new_s = [None] * len(items)
    groups: Dict[Any, list] = {}
    for i, (upd, lf, frozen, p, g, s) in enumerate(items):
        if frozen or not leaves(p):
            new_p[i], new_s[i] = p, s
        elif getattr(upd, "sig", None) is None:
            deltas, ns = upd.update(g, s, p, lr * lf, step)
            new_p[i] = tree_map(lambda a, d: a + d, p, deltas)
            new_s[i] = ns
        else:
            groups.setdefault((upd.sig, lf), []).append(i)

    for (_, lf), idxs in groups.items():
        upd = items[idxs[0]][0]
        s0 = items[idxs[0]][5]
        fields = sorted(s0) if isinstance(s0, dict) else []
        by_dtype: Dict[Any, dict] = {}
        recs = []
        for i in idxs:
            _, _, _, p, g, s = items[i]
            pl, gl = leaves(p), leaves(g)
            sl = {f: leaves(s[f]) for f in fields}
            recs.append((i, [(a.shape, a.dtype, a.numel()) for a in pl]))
            for j, a in enumerate(pl):
                b = by_dtype.setdefault(
                    a.dtype, {"p": [], "g": [], "s": {f: [] for f in fields}})
                b["p"].append(a.reshape(-1))
                b["g"].append(gl[j].reshape(-1).to(a.dtype))
                for f in fields:
                    b["s"][f].append(sl[f][j].reshape(-1))
        out = {}
        for dt, b in by_dtype.items():
            P, G = torch.cat(b["p"]), torch.cat(b["g"])
            S = {f: torch.cat(v) for f, v in b["s"].items()} if fields else ()
            deltas, S_new = upd.update(G, S, P, lr * lf, step)
            out[dt] = (P + deltas, S_new)
        offsets = {dt: 0 for dt in out}
        for i, metas in recs:
            p_new, s_new = [], {f: [] for f in fields}
            for shape, dt, size in metas:
                P_new, S_new = out[dt]
                o = offsets[dt]
                p_new.append(P_new[o:o + size].view(shape))
                for f in fields:
                    s_new[f].append(S_new[f][o:o + size].view(shape))
                offsets[dt] = o + size
            p, s = items[i][3], items[i][5]
            new_p[i] = unflatten(p, p_new)[0]
            new_s[i] = ({f: unflatten(s[f], s_new[f])[0] for f in fields}
                        if fields else s)
    return new_p, new_s


def apply_score_decay(net, loss):
    """lr_policy='score': multiply the host-tracked lr factor by the decay
    rate whenever the score fails to improve (forces a device sync per
    step, which only users of this policy pay)."""
    if getattr(net.conf, "lr_policy", None) != "score":
        return
    s = float(loss)
    best = net._best_score
    if best is not None and s >= best:
        net._lr_score_factor *= getattr(
            net.conf, "lr_policy_decay_rate", 1.0) or 1.0
    if best is None or s < best:
        net._best_score = s
