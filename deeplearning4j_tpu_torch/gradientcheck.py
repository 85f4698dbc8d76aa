"""Numeric gradient checking (counterpart of deeplearning4j_tpu/gradientcheck.py):
central differences against autograd, in float64, over every parameter
of a MultiLayerNetwork or ComputationGraph.

The loss is the network's train-mode loss (`_loss_fn`, batch statistics
in BatchNorm); dropout masks come from a generator seeded with `seed`
and rewound before every evaluation, so each evaluation draws the same
masks. `subset` picks params per leaf with numpy's default_rng(seed), in
the JAX package's leaf order, so both packages check the same elements.
Meant for small networks on the CPU: every element checked costs two
forward passes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


def _as_list(v):
    return v if isinstance(v, (list, tuple)) else [v]


def check_gradients(net, x, y, fmask=None, lmask=None,
                    epsilon: float = 1e-6, max_rel_error: float = 1e-5,
                    min_abs_error: float = 1e-8,
                    subset: Optional[int] = None,
                    seed: int = 0, verbose: bool = False) -> bool:
    """Central difference against autograd over every parameter of `net`
    (built with dtype=torch.float64). Raises AssertionError on the first
    element whose relative error exceeds `max_rel_error` while its
    absolute error exceeds `min_abs_error`; returns True otherwise.
    `subset`: check only this many randomly chosen elements per param
    leaf; None = all. A graph takes per-input/per-output lists (or one
    array each)."""
    if not net._initialized():
        net.init()
    if net.dtype != torch.float64:
        raise ValueError(
            "gradient checks need a float64 network "
            "(MultiLayerNetwork(conf, dtype=torch.float64))")
    if hasattr(net.conf, "network_inputs"):
        names = net.conf.network_inputs
        xs = _as_list(x)
        if len(xs) != len(names):
            raise ValueError(
                f"graph has {len(names)} inputs {names}, got {len(xs)} arrays")
        inputs, labels, lmasks, fmasks = net._batch_tensors(
            xs, _as_list(y), None if fmask is None else _as_list(fmask),
            None if lmask is None else _as_list(lmask))
    else:
        inputs, labels, lmasks, fmasks = net._batch_tensors(x, y, fmask,
                                                            lmask)
    gen = torch.Generator(device=net.device).manual_seed(int(seed))
    gen_state = gen.get_state()

    def loss(params):
        gen.set_state(gen_state)
        value, _ = net._loss_fn(params, net.states, inputs, labels, lmasks,
                                train=True, rng=gen, fmasks=fmasks)
        return value

    params = tree_map(lambda t: t.detach().clone(), net._params_view())
    flat = leaves(params)
    with torch.enable_grad():
        req = [t.requires_grad_() for t in flat]
        grads = torch.autograd.grad(loss(unflatten(params, req)[0]), req,
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.detach()
             for p, g in zip(flat, grads)]
    flat = [t.detach() for t in flat]
    rs = np.random.default_rng(seed)
    total_checked, max_err = 0, 0.0
    with torch.no_grad():
        for li, (p, g) in enumerate(zip(flat, grads)):
            work = p.clone()
            view = work.view(-1)
            n = view.numel()
            idxs = (np.arange(n) if subset is None or n <= subset
                    else rs.choice(n, size=subset, replace=False))
            probe = list(flat)
            probe[li] = work
            tree = unflatten(params, probe)[0]
            g_flat = g.reshape(-1)
            for i in idxs:
                orig = float(view[i])
                view[i] = orig + epsilon
                lp = float(loss(tree))
                view[i] = orig - epsilon
                lm = float(loss(tree))
                view[i] = orig
                numeric = (lp - lm) / (2 * epsilon)
                a = float(g_flat[i])
                denom = abs(a) + abs(numeric)
                rel = 0.0 if denom == 0 else abs(a - numeric) / denom
                if rel > max_rel_error and abs(a - numeric) > min_abs_error:
                    raise AssertionError(
                        f"Gradient check FAILED: leaf {li} flat index {i}: "
                        f"analytic={a:.3e} numeric={numeric:.3e} "
                        f"rel={rel:.3e}")
                max_err = max(max_err, rel)
                total_checked += 1
    if verbose:
        print(f"gradient check OK: {total_checked} params, "
              f"max rel err {max_err:.3e}")
    return True
