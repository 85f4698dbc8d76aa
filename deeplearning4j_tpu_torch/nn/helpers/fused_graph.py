"""Fusion planner + executor for ComputationGraph (counterpart of
deeplearning4j_tpu/nn/helpers/fused_graph.py).

A static planning pass over the topo order recognizes conv->BN(->relu)
(->add) chains and executes them through `fused_ops.fused_conv`, carrying
activations between fused convolutions as (raw conv output, per-channel
affine) pairs, so BN-apply / relu / residual-add never cost separate
passes. Unrecognized nodes run through the same node executor as the
default path. In train mode each fused conv emits the statistics its BN
consumer asks for (`stat_sample`: all rows, or the leading ceil(B/k)),
the BN becomes [C]-vector algebra (`bn_affine`) that autograd
differentiates, and the running statistics follow an EMA computed
outside autograd.

Port-only detail: PyTorch runs eagerly, so there is no dead-code
elimination of the emitted `u` byproduct. A conv asks its kernel for u
only when the source expression has another consumer that will read it
(the residual branch of the next add); otherwise u is never written.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.helpers.fused_ops import (
    _prologue,
    bn_affine,
    bn_affine_inference,
    fused_conv,
)


@dataclass
class ConvSpec:
    stride: Tuple[int, int]
    padding: object           # lax padding spec
    bn_name: Optional[str]    # BN node consuming this conv (stats sink)


@dataclass
class Plan:
    """Static fusion plan: node-name -> role."""
    impl: str = "xla"         # "xla" | "pallas" (kernel tier)
    conv: Dict[str, ConvSpec] = field(default_factory=dict)
    bn: Dict[str, str] = field(default_factory=dict)      # bn -> conv src
    vact: Dict[str, str] = field(default_factory=dict)    # act -> src node
    vadd: Dict[str, List[str]] = field(default_factory=dict)
    consumers: Dict[str, List[str]] = field(default_factory=dict)


def _consumers(topo) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {n.name: [] for n in topo}
    for n in topo:
        for s in n.inputs:
            if s in out:
                out[s].append(n.name)
    return out


def build_plan(topo, network_outputs, impl: str = "xla") -> Optional[Plan]:
    """Pattern-match fusable chains over the topo order — the JAX
    package's rules, node for node."""
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
        ElementWiseVertex,
    )
    from deeplearning4j_tpu_torch.nn.layers.conv import ConvolutionLayer, _pair
    from deeplearning4j_tpu_torch.nn.layers.core import ActivationLayer
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization

    by_name = {n.name: n for n in topo}
    cons = _consumers(topo)
    outputs = set(network_outputs)
    plan = Plan(impl=impl, consumers=cons)

    def conv_eligible(n) -> bool:
        l = n.obj
        return (n.kind == "layer" and isinstance(l, ConvolutionLayer)
                and (l.activation in (None, "identity"))
                and not l.dropout and tuple(l.dilation) == (1, 1)
                and n.preprocessor is None and n.name not in outputs)

    def bn_eligible(n) -> bool:
        l = n.obj
        return (n.kind == "layer" and isinstance(l, BatchNormalization)
                and not l.lock_gamma_beta and not l.dropout
                and n.preprocessor is None and n.name not in outputs)

    for n in topo:
        if conv_eligible(n):
            cs = cons[n.name]
            if not (len(cs) == 1 and bn_eligible(by_name[cs[0]])):
                continue
            bn_name = cs[0]
            plan.conv[n.name] = ConvSpec(_pair(n.obj.stride),
                                         n.obj.lax_padding(), bn_name)
            plan.bn[bn_name] = n.name

    virtual = set(plan.bn)
    for n in topo:
        if n.name in outputs or n.preprocessor is not None:
            continue
        if (n.kind == "layer" and isinstance(n.obj, ActivationLayer)
                and n.obj.activation == "relu" and not n.obj.dropout
                and len(n.inputs) == 1 and n.inputs[0] in virtual):
            plan.vact[n.name] = n.inputs[0]
            virtual.add(n.name)
        elif (n.kind == "vertex" and isinstance(n.obj, ElementWiseVertex)
              and n.obj.op == "add" and len(n.inputs) == 2
              and any(s in plan.bn for s in n.inputs)):
            plan.vadd[n.name] = list(n.inputs)
            virtual.add(n.name)
    if not plan.conv:
        return None
    return plan


# -------------------------------------------------------------- executor


class _Expr:
    """Deferred value: relu?(sum of affine/plain terms)."""

    __slots__ = ("terms", "relu")

    def __init__(self, terms, relu=False):
        # [(tensor, scale|None, shift|None)]; one or two terms, since a
        # virtual add takes exactly two inputs and resolves any input
        # that is not a single term
        self.terms = terms
        self.relu = relu

    def operands(self):
        """(x, scale, shift, x2, scale2, shift2) of the prologue."""
        second = self.terms[1] if len(self.terms) > 1 else (None,) * 3
        return (*self.terms[0], *second)


def _materialize(expr: _Expr):
    return _prologue(*expr.operands(), expr.relu)


def fused_forward(net, params, states, inputs, *, train=False,
                  materialize_all=False, rng=None):
    """Forward over the DAG when a fusion plan is active. Non-planned
    nodes run through ComputationGraph._exec_node (layers with dropout
    are never planned; they draw from `rng` there). Returns (activations,
    new_states)."""
    plan: Plan = net._fusion_plan
    by_name = {n.name: n for n in net.topo}
    acts: Dict[str, object] = dict(inputs)
    virts: Dict[str, _Expr] = {}
    raws: Dict[str, object] = {}
    stats: Dict[str, Tuple] = {}
    new_states: Dict[str, object] = {}

    def resolve(name):
        if name not in acts:
            acts[name] = _materialize(virts[name])
        return acts[name]

    def expr_of(name) -> _Expr:
        if name in acts:
            return _Expr([(acts[name], None, None)])
        return virts[name]

    for node in net.topo:
        name = node.name
        if name in plan.conv:
            spec = plan.conv[name]
            src = node.inputs[0]
            e = expr_of(src)
            x, s1, t1, x2, s2, t2 = e.operands()
            byproduct = src not in acts and (
                e.relu or len(e.terms) > 1 or e.terms[0][1] is not None)
            # u is worth writing only when another consumer will read src
            emit = byproduct and len(plan.consumers.get(src, ())) > 1
            # statistics as the BN consumer's stat_sample asks (1 = exact
            # full-batch, k>1 = ghost rows; <=0 means exact)
            bn_layer = by_name[spec.bn_name].obj
            stats_k = (max(1, int(getattr(bn_layer, "stat_sample", 1)))
                       if train else 0)
            p = params[name]
            y, ssum, ssq, u = fused_conv(
                x, p["W"], p["b"], s1, t1, x2, s2, t2,
                spec.stride, spec.padding, e.relu, stats_k, plan.impl,
                emit_u=emit)
            raws[name] = y
            stats[name] = (ssum, ssq)
            new_states[name] = states[name]
            if emit:
                acts[src] = u   # byproduct: src is now materialized
            continue
        if name in plan.bn:
            layer = node.obj
            conv_src = plan.bn[name]
            gamma, beta = params[name]["gamma"], params[name]["beta"]
            st = states[name]
            if train:
                ssum, ssq = stats[conv_src]
                raw = raws[conv_src]
                k = max(int(getattr(layer, "stat_sample", 1)), 1)
                nb = (raw.shape[0] - 1) // k + 1       # sampled rows
                count = nb * raw.shape[1] * raw.shape[2]
                scale, shift, mean, var = bn_affine(
                    gamma, beta, ssum, ssq, count, layer.eps)
                new_states[name] = st
                if st:
                    with torch.no_grad():
                        d, sd = layer.decay, st["mean"].dtype
                        new_states[name] = {
                            "mean": d * st["mean"]
                            + (1.0 - d) * mean.detach().to(sd),
                            "var": d * st["var"]
                            + (1.0 - d) * var.detach().to(sd)}
            else:
                scale, shift = bn_affine_inference(
                    gamma, beta, st["mean"], st["var"], layer.eps)
                new_states[name] = st
            virts[name] = _Expr([(raws[conv_src], scale, shift)])
            continue
        if name in plan.vact:
            e = expr_of(plan.vact[name])
            virts[name] = _Expr(list(e.terms), relu=True)
            new_states[name] = states.get(name)
            continue
        if name in plan.vadd:
            terms = []
            for s in plan.vadd[name]:
                e = expr_of(s)
                if e.relu or len(e.terms) > 1:
                    terms.append((resolve(s), None, None))
                else:
                    terms.append(e.terms[0])
            virts[name] = _Expr(terms)
            continue
        xs = [resolve(s) for s in node.inputs]
        net._exec_node(node, xs, params, states, acts, train, new_states,
                       rng)

    if materialize_all:
        for name, y in raws.items():
            acts.setdefault(name, y)   # raw conv outputs ARE the conv acts
        for name in virts:
            resolve(name)
    return acts, new_states
