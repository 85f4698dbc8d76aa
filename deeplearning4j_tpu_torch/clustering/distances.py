"""Batched pairwise distances and tiled k-NN (counterpart of
deeplearning4j_tpu/clustering/distances.py).

The reference walks pointer trees per query
(nearestneighbor-core: clustering/vptree/VPTree.java, kdtree/KDTree.java);
on the card the batched formulation is a dense distance block per tile of
queries — |x-y|^2 = |x|^2 + |y|^2 - 2<x,y> rides a matmul — and
`torch.topk`, tiled over queries so memory stays bounded. The host-side
trees (vptree.py/kdtree.py) remain for exact single-query search.

Precision: the matmuls run in f32. Exact neighbour sets against an f64
brute force need TF32 off (`torch.backends.cuda.matmul.allow_tf32`,
PyTorch's default); the port never turns it on. Ties between equal
distances may come back in another order than the JAX package's
`lax.top_k` gives them.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

_METRICS = ("euclidean", "sqeuclidean", "manhattan", "cosine", "dot")


def as_points(a, device=None) -> torch.Tensor:
    """`a` ([N, D] numpy array, list or tensor) as an f32 tensor on
    `device`; `device=None` keeps a tensor where it lies and puts
    anything else on the card."""
    if device is None and isinstance(a, torch.Tensor):
        device = a.device
    dev = resolve_device(device)
    t = a.detach() if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))
    return t.to(device=dev, dtype=torch.float32)


def pairwise_distance(x, y, metric: str = "euclidean",
                      device=None) -> torch.Tensor:
    """[N,D] x [M,D] -> [N,M] distances on `device` (module docstring)."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric '{metric}'; known {_METRICS}")
    x = as_points(x, device)
    y = as_points(y, x.device)
    if metric in ("euclidean", "sqeuclidean"):
        # |y|^2 - 2 x.y in the matmul's own output, then + |x|^2 in place:
        # three kernels over the [N, M] block where the plain expression
        # launches five
        x2 = torch.sum(x * x, dim=1)[:, None]
        y2 = torch.sum(y * y, dim=1)[None, :]
        d2 = torch.addmm(y2, x, y.T, alpha=-2.0).add_(x2).clamp_(min=0.0)
        return d2 if metric == "sqeuclidean" else d2.sqrt_()
    if metric == "manhattan":
        return torch.cdist(x, y, p=1.0)
    if metric == "cosine":
        xn = x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True),
                                 1e-12)
        yn = y / torch.clamp_min(torch.linalg.norm(y, dim=1, keepdim=True),
                                 1e-12)
        return 1.0 - xn @ yn.T
    # dot "distance": larger dot = closer
    return -(x @ y.T)


def knn(queries, corpus, k: int, metric: str = "euclidean",
        tile: int = 4096, device=None):
    """k nearest neighbours of each query in `corpus`.

    Returns (indices [N,k] int64, distances [N,k] f32) on the corpus's
    device, nearest first. Tiled over queries (`tile` per block) so the
    [tile, M] distance block stays bounded at any corpus size."""
    corpus = as_points(corpus, device)
    queries = as_points(queries, corpus.device)
    k = min(int(k), corpus.shape[0])
    out_i, out_d = [], []
    for s in range(0, queries.shape[0], tile):
        d = pairwise_distance(queries[s:s + tile], corpus, metric)
        dist, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        del d
        out_i.append(idx)
        out_d.append(dist)
    return torch.cat(out_i), torch.cat(out_d)
