"""The program under test, through its public entry points: a zoo model
of `deeplearning4j_tpu_torch` built as the configuration says, given the
benchmark's seeded weights, and its state read back to be judged.

Imported only inside a run (never by the reference)."""

from __future__ import annotations

import torch


def build(cfg: dict, device):
    """The configuration's zoo network (a ComputationGraph), initialized,
    on `device`."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.helpers import validate_helper_mode

    p = cfg["program"]
    h, w, c = cfg["input_shape"]
    model = getattr(zoo, p["zoo"])(
        num_classes=cfg["num_classes"], input_shape=(h, w, c),
        updater=p["updater"], learning_rate=p["learning_rate"],
        compute_dtype=p["compute_dtype"], helpers=p["helpers"])
    conf = model.conf()
    conf.helper_mode = validate_helper_mode(p["helpers"])
    for name, attrs in p.get("layer_overrides", {}).items():
        for attr, value in attrs.items():
            setattr(conf.node(name).obj, attr, value)
    return ComputationGraph(conf, compute_dtype=p["compute_dtype"],
                            device=device).init()


def load(net, params: dict, states: dict) -> None:
    """Give the network copies of the benchmark's weights and BatchNorm
    statistics, leaf for leaf; a leaf of another shape, or a trained
    leaf the benchmark did not make, raises."""
    new_p = {k: dict(v) for k, v in net.params.items()}
    for k, leaves in new_p.items():
        if set(leaves) != set(params.get(k, {})):
            raise ValueError(f"layer {k}: the program trains "
                             f"{sorted(leaves)}, the benchmark made "
                             f"{sorted(params.get(k, {}))}")
        for j, t in leaves.items():
            src = params[k][j]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{k}.{j}: program {tuple(t.shape)}, "
                                 f"benchmark {tuple(src.shape)}")
            leaves[j] = src.detach().to(t.device, t.dtype).clone()
    new_s = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in net.states.items()}
    for k, st in states.items():
        for j, src in st.items():
            t = new_s[k][j]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{k}.{j} statistics: program "
                                 f"{tuple(t.shape)}, benchmark "
                                 f"{tuple(src.shape)}")
            new_s[k][j] = src.detach().to(t.device, t.dtype).clone()
    net.params = new_p
    net.states = new_s


def leaf_norms(tree: dict, minus: dict = None, scale: float = 1.0) -> dict:
    """{(layer, leaf): norm of scale * (tree - minus)} over the layers of
    `minus` (of `tree` without it), read back to the host as floats."""
    out = {}
    with torch.no_grad():
        for k in sorted(minus if minus is not None else tree):
            for j in sorted((minus if minus is not None else tree)[k]):
                t = tree[k][j].float()
                if minus is not None:
                    t = t - minus[k][j].to(t.device).float()
                out[(k, j)] = float(t.norm()) * abs(scale)
    return out
