"""A float32 executor for a model given as a list of nodes.

A node is a dict with `name`, `op`, `inputs` (names of earlier nodes)
and the op's attributes:

  input    shape [H, W, C]
  conv     k [kh, kw], s [sh, sw], cout; SAME padding as XLA pads it
           (out = ceil(in / s), the odd pixel at the bottom/right);
           params W [kh, kw, cin, cout] (HWIO) and b [cout]
  bn       eps, decay; params gamma, beta; statistics mean, var
           (training normalizes with the batch's biased variance and
           moves the statistics by `1 - decay` toward the batch's)
  relu, add (elementwise sum of its inputs), concat (channels, in order)
  maxpool  k, s; SAME, padded with -inf
  gap      mean over H and W
  dropout  rate (only 0 is supported in training: the reference cannot
           draw the program's masks)
  output   cout; params W [cin, cout], b; softmax, multi-class cross
           entropy averaged over the rows

`quant`, when given, rounds both operands of every conv and output
product and every node's output (its backward rounds the gradients):
the control of the correctness check computes in a lower precision than
the configuration states.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

PARAM_OPS = ("conv", "bn", "output")


def same_pads(size: int, k: int, s: int):
    """(low, high) padding of one spatial dim under SAME."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def infer_shapes(nodes: List[dict]) -> Dict[str, tuple]:
    """{node name: output shape (H, W, C)} (per image; `gap` and
    `output` give (C,))."""
    shapes: Dict[str, tuple] = {}
    for n in nodes:
        op, ins = n["op"], [shapes[i] for i in n.get("inputs", [])]
        if op == "input":
            shapes[n["name"]] = tuple(n["shape"])
        elif op in ("conv", "maxpool"):
            h, w, c = ins[0]
            sh, sw = n["s"]
            cout = n["cout"] if op == "conv" else c
            shapes[n["name"]] = (-(-h // sh), -(-w // sw), cout)
        elif op in ("bn", "relu", "dropout"):
            shapes[n["name"]] = ins[0]
        elif op == "add":
            if any(s != ins[0] for s in ins):
                raise ValueError(f"{n['name']}: add of shapes {ins}")
            shapes[n["name"]] = ins[0]
        elif op == "concat":
            h, w = ins[0][:2]
            shapes[n["name"]] = (h, w, sum(s[2] for s in ins))
        elif op == "gap":
            shapes[n["name"]] = (ins[0][-1],)
        elif op == "output":
            shapes[n["name"]] = (n["cout"],)
        else:
            raise ValueError(f"unknown op {op!r}")
    return shapes


def param_shapes(nodes: List[dict]) -> Dict[str, Dict[str, tuple]]:
    """{layer: {leaf: shape}} of the trained parameters, program layout."""
    shapes = infer_shapes(nodes)
    out = {}
    for n in nodes:
        if n["op"] == "conv":
            cin = shapes[n["inputs"][0]][-1]
            out[n["name"]] = {"W": (*n["k"], cin, n["cout"]),
                              "b": (n["cout"],)}
        elif n["op"] == "bn":
            c = shapes[n["inputs"][0]][-1]
            out[n["name"]] = {"gamma": (c,), "beta": (c,)}
        elif n["op"] == "output":
            cin = shapes[n["inputs"][0]][-1]
            out[n["name"]] = {"W": (cin, n["cout"]), "b": (n["cout"],)}
    return out


def _pad(x, n, value=0.0):
    (pt, pb), (pl, pr) = (same_pads(x.shape[2], n["k"][0], n["s"][0]),
                          same_pads(x.shape[3], n["k"][1], n["s"][1]))
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=value)
    return x


def forward(nodes: List[dict], params: dict, states: dict, x_nhwc,
            train: bool, quant: Optional[Callable] = None,
            batch_stats: bool = False):
    """Logits of `x_nhwc` (float32), and in training the new BatchNorm
    statistics. `batch_stats=True` normalizes with the batch's
    statistics outside training (the weight maker's calibration)."""
    q = quant or (lambda t: t)
    acts = {}
    new_states = {}
    for n in nodes:
        op, name = n["op"], n["name"]
        ins = [acts[i] for i in n.get("inputs", [])]
        if op == "input":
            y = x_nhwc.to(torch.promote_types(x_nhwc.dtype, torch.float32)
                          ).permute(0, 3, 1, 2)
        elif op == "conv":
            p = params[name]
            w = p["W"].permute(3, 2, 0, 1)
            y = F.conv2d(_pad(q(ins[0]), n), q(w), stride=tuple(n["s"]))
            y = y + p["b"].view(1, -1, 1, 1)
        elif op == "bn":
            p, x = params[name], ins[0]
            if train or batch_stats:
                mean = x.mean(dim=(0, 2, 3))
                var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
                if train:
                    d = n["decay"]
                    st = states[name]
                    new_states[name] = {
                        "mean": d * st["mean"] + (1 - d) * mean.detach(),
                        "var": d * st["var"] + (1 - d) * var.detach()}
                else:
                    new_states[name] = {"mean": mean, "var": var}
            else:
                mean, var = states[name]["mean"], states[name]["var"]
            scale = p["gamma"] * torch.rsqrt(var + n["eps"])
            shift = p["beta"] - mean * scale
            y = x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
        elif op == "relu":
            y = torch.relu(ins[0])
        elif op == "add":
            y = ins[0]
            for t in ins[1:]:
                y = y + t
        elif op == "concat":
            y = torch.cat(ins, dim=1)
        elif op == "maxpool":
            y = F.max_pool2d(_pad(ins[0], n, value=-math.inf),
                             tuple(n["k"]), tuple(n["s"]))
        elif op == "gap":
            y = ins[0].mean(dim=(2, 3))
        elif op == "dropout":
            if train and n["rate"] > 0:
                raise ValueError("the reference cannot follow dropout masks")
            y = ins[0]
        elif op == "output":
            p = params[name]
            y = q(ins[0]) @ q(p["W"]) + p["b"]
        else:
            raise ValueError(f"unknown op {op!r}")
        acts[name] = q(y) if quant is not None and op != "output" else y
    return acts[nodes[-1]["name"]], new_states


def loss_of(logits, labels):
    """Multi-class cross entropy of softmax(logits), mean over rows."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def leaf_items(tree: dict):
    """[(layer, leaf), tensor] in a fixed order."""
    return [((k, j), tree[k][j]) for k in sorted(tree) for j in
            sorted(tree[k])]


def train_steps(nodes, params, states, batches, lr: float,
                momentum: float, quant=None):
    """Follow `len(batches)` training steps of Nesterov momentum (v' =
    mu v - lr g; p += mu v' - lr g) from `params`/`states` (float32
    copies are made). Returns per-step losses and per-leaf norms:
    `grad` of the first step's gradient, `change` of the parameters'
    change after the last step, `stats` of the BatchNorm statistics'
    change."""
    p = {k: {j: t.detach().float().clone() for j, t in v.items()}
         for k, v in params.items()}
    s0 = {k: {j: t.detach().float().clone() for j, t in v.items()}
          for k, v in states.items()}
    st = {k: dict(v) for k, v in s0.items()}
    v = {k: {j: torch.zeros_like(t) for j, t in d.items()}
         for k, d in p.items()}
    p0 = {k: {j: t.clone() for j, t in d.items()} for k, d in p.items()}
    losses, grad_norms = [], None
    for x, y in batches:
        items = leaf_items(p)
        leaves = [t.requires_grad_() for _, t in items]
        with torch.enable_grad():
            logits, new_st = forward(nodes, p, st, x, train=True,
                                     quant=quant)
            loss = loss_of(logits, y.float())
            grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {key: float(g.norm()) for (key, _), g in
                          zip(items, grads)}
        with torch.no_grad():
            for ((k, j), t), g in zip(items, grads):
                vn = momentum * v[k][j] - lr * g
                v[k][j] = vn
                p[k][j] = (t + momentum * vn - lr * g).detach()
        st.update({k: {j: t.detach() for j, t in d.items()}
                   for k, d in new_st.items()})
        del logits, loss, grads, leaves
    with torch.no_grad():
        change = {key: float((t - p0[key[0]][key[1]]).norm())
                  for key, t in leaf_items(p)}
        stats = {key: float((t - s0[key[0]][key[1]]).norm())
                 for key, t in leaf_items(st)}
    return {"losses": losses, "grad": grad_norms, "change": change,
            "stats": stats}


def predict(nodes, params, states, x_nhwc, quant=None, block: int = 64):
    """log softmax of the logits in eval mode, in blocks of rows."""
    out = []
    with torch.no_grad():
        for i in range(0, x_nhwc.shape[0], block):
            logits, _ = forward(nodes, params, states, x_nhwc[i:i + block],
                                train=False, quant=quant)
            out.append(torch.log_softmax(logits, dim=-1))
    return torch.cat(out)


class _Fp8(torch.autograd.Function):
    """e4m3 forward rounding with a per-tensor scale; the gradient passes
    through rounded to e5m2 (fp8 training's two formats)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(t, dtype, fmax):
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


def fp8(t):
    """The control's precision: float8 operands (e4m3 forward, e5m2
    gradients), float32 accumulation."""
    return _Fp8.apply(t)


class _Bf16(torch.autograd.Function):
    """bfloat16 rounding forward, and of the gradient backward."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(t):
    """A bfloat16 twin of the reference (the configuration's own compute
    precision, float32 accumulation): a diagnostic of what bfloat16
    rounding alone does to a compared number (PERF.md, "correct")."""
    return _Bf16.apply(t)

