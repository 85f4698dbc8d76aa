"""Grad-over-flat training chain (counterpart of
deeplearning4j_tpu/nn/updater/flat_chain.py).

The train step carries ONE flat f32 parameter vector, in the JAX
package's `ravel_pytree` order (sorted node names, then sorted param
names: util/tree.py), and one flat vector per updater-state field. Each
step differentiates through `unravel` — per-layer views made with
`torch.split(...).view(...)`, so autograd delivers the gradient as one
flat tensor — and the update rule runs as a single elementwise chain over
(flat, flat_state).

Eligibility (checked by `build`, the JAX package's rules): every
trainable layer shares one fusable updater rule at lr factor 1.0, nothing
is frozen, and gradient normalization is elementwise or absent; anything
else takes the per-layer `fused_apply` path. The container exposes
`params`/`updater_states` as lazily materialized trees.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


class FlatTrainChain:
    def __init__(self, updater, like, fields):
        self.updater = updater
        # the params structure with meta tensors for leaves: shapes only
        self._like = like
        self._shapes = [t.shape for t in leaves(like)]
        self._sizes = [t.numel() for t in leaves(like)]
        self.fields = fields          # updater state field names

    # ------------------------------------------------------------ factory
    @staticmethod
    def build(net) -> Optional["FlatTrainChain"]:
        """A chain for the ComputationGraph `net` if its configuration is
        eligible, else None. Needs initialized updaters."""
        conf = net.conf
        gn = getattr(conf, "gradient_normalization", None)
        if gn not in (None, "none", "clip_element_wise_absolute_value"):
            return None
        params = net.params
        sig = updater = None
        for node in net.topo:
            if node.kind != "layer" or not leaves(params[node.name]):
                continue
            layer = node.obj
            if layer.frozen:
                return None
            if getattr(layer, "learning_rate", None) is not None and \
                    conf.learning_rate != 0 and \
                    layer.learning_rate != conf.learning_rate:
                return None
            upd = net._updaters[node.name]
            if upd.sig is None:
                return None
            if sig is None:
                sig, updater = upd.sig, upd
            elif upd.sig != sig:
                return None
        if sig is None:
            return None
        like = tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
        s0 = None
        for node in net.topo:
            s = net.updater_states.get(node.name)
            if isinstance(s, dict) and s:
                s0 = s
                break
        return FlatTrainChain(updater, like, tuple(sorted(s0)) if s0 else ())

    # ------------------------------------------------------------- ravel
    @staticmethod
    def _cat(tree):
        ls = leaves(tree)
        if not ls:
            return torch.zeros(0)
        return torch.cat([t.reshape(-1) for t in ls])

    def ravel(self, params) -> torch.Tensor:
        return self._cat(params)

    def unravel(self, flat):
        """Per-layer views of `flat` (differentiable: autograd sums their
        gradients back into one flat gradient)."""
        views = [p.view(shape) for p, shape in
                 zip(torch.split(flat, self._sizes), self._shapes)]
        return unflatten(self._like, views)[0]

    def ravel_upd(self, upd_states) -> Any:
        """Per-layer updater states -> {field: flat} (or () for stateless
        rules), in the params' leaf order."""
        if not self.fields:
            return ()
        return {f: self._cat({k: (s.get(f, {}) if isinstance(s, dict)
                                  else {}) for k, s in upd_states.items()})
                for f in self.fields}

    def upd_skeleton(self, upd_states):
        """Structure-only template for unravel_upd, so the per-layer state
        buffers can be freed while the flat carry is live."""
        return {k: ({f: None for f in self.fields}
                    if isinstance(s, dict) else s)
                for k, s in upd_states.items()}

    def unravel_upd(self, flat_state, like_upd_states):
        """{field: flat} -> per-layer updater states shaped like
        `like_upd_states`."""
        if not self.fields:
            return like_upd_states
        per_field = {f: self.unravel(flat_state[f]) for f in self.fields}
        return {k: ({f: per_field[f][k] for f in self.fields}
                    if isinstance(s, dict) else s)
                for k, s in like_upd_states.items()}
