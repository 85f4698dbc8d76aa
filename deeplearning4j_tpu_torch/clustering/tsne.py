"""t-SNE on the card (counterpart of deeplearning4j_tpu/clustering/tsne.py).

Parity: deeplearning4j-core plot/Tsne.java (exact) +
plot/BarnesHutTsne.java — perplexity-calibrated conditional
probabilities (binary search over precision), early exaggeration,
momentum gradient descent on the KL divergence.

Two tiers (method='auto'|'exact'|'chunked'), the JAX package's:

- exact (N <= DENSE_CAP = 16384): the full P/Q affinity matrices are
  dense [N, N] tensors, the per-point beta binary search is vectorized
  (all rows at once), one gradient iteration is a few dense passes and
  two matmuls.
- chunked (N beyond the dense cap — the BarnesHutTsne.java role): P is
  sparse over each point's 3*perplexity nearest neighbours (the
  reference's VPTree-KNN input stage), calibrated and symmetrized on the
  sparse pattern; the repulsive Q side streams in [row_block, N] blocks,
  so memory is O(N*row_block + N*K) instead of O(N^2). The block loop
  reuses one [row_block, N] buffer: eager PyTorch would otherwise keep
  each block's temporaries alive (573 MB per f32 block at N = 70,000 and
  row_block 2048). `y` is padded to a multiple of row_block with
  far-away sentinel rows (their student-t kernel ~ 0; masked anyway;
  they stay put).

`theta` is accepted for API parity and ignored (both tiers are exact in
the repulsive term), matching BarnesHutTsne(theta=0) semantics.

The initial embedding is 1e-4 x a standard normal draw from a CPU
`torch.Generator` seeded with `seed` (the JAX package draws from
`jax.random.PRNGKey(seed)`, which the port cannot reproduce), so a seed
gives the same start on the card and on the CPU. Sums run in another
order than XLA's, so the port agrees with the JAX package within a
tolerance, not bit for bit. The chunked tier's reverse-edge scatter is
an `index_add_`, whose order of additions on the card varies from run to
run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.distances import (
    as_points,
    knn,
    pairwise_distance,
)


def _beta_search(d2, drop_mask, perplexity, iters):
    """Shared perplexity calibration (ref Tsne.java hBeta loop):
    binary-search beta_i so each row of exp(-d2*beta) has entropy
    log(perplexity). `drop_mask` (or None) marks excluded entries
    (the diagonal in the dense tier)."""
    log_u = float(np.log(perplexity))

    def entropy_probs(beta):
        p = torch.exp(-d2 * beta[:, None])
        if drop_mask is not None:
            p.masked_fill_(drop_mask, 0.0)
        sum_p = torch.clamp_min(torch.sum(p, dim=1), 1e-12)
        h = torch.log(sum_p) + beta * torch.sum(d2 * p, dim=1) / sum_p
        return h, p

    n = d2.shape[0]
    beta = torch.ones(n, device=d2.device)
    lo = torch.zeros(n, device=d2.device)
    hi = torch.full((n,), float("inf"), device=d2.device)
    for _ in range(int(iters)):
        h, _ = entropy_probs(beta)
        too_high = h > log_u          # entropy too high -> raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        # hi still open -> double; else bisect (lo starts at 0, closed)
        beta = torch.where(torch.isinf(hi), beta * 2, (lo + hi) / 2)
    _, p = entropy_probs(beta)
    sum_p = torch.clamp_min(torch.sum(p, dim=1), 1e-12)
    return p.div_(sum_p[:, None])


def _p_conditional(x, perplexity, perplexity_iters: int = 50):
    """Dense-tier conditional affinities (diagonal excluded)."""
    d2 = pairwise_distance(x, x, "sqeuclidean")
    d2.fill_diagonal_(0.0)
    eye = torch.eye(d2.shape[0], dtype=torch.bool, device=d2.device)
    return _beta_search(d2, eye, perplexity, perplexity_iters)


def _tsne_grad(y, p, exaggeration):
    """Dense-tier (gradient, KL) at embedding `y` for symmetric `p`."""
    num = pairwise_distance(y, y, "sqeuclidean")
    num.add_(1.0).reciprocal_()                 # 1 / (1 + d2)
    num.fill_diagonal_(0.0)
    q = torch.clamp_min(num / torch.sum(num), 1e-12)
    pq = (p * exaggeration - q).mul_(num)
    # (diag(rowsum(pq)) - pq) @ y, built in place
    rows = torch.sum(pq, dim=1)
    pq.neg_().diagonal().add_(rows)
    grad = 4.0 * (pq @ y)
    kl = torch.sum(p * torch.log(torch.clamp_min(p, 1e-12) / q))
    return grad, kl


def _p_sparse(d2, perplexity, perplexity_iters: int = 50):
    """Conditional affinities over each row's K nearest neighbours
    ([N,K] sq-distances) — the sparse analogue of _p_conditional (ref
    BarnesHutTsne computeGaussianPerplexity over the KNN set)."""
    return _beta_search(d2, None, perplexity, perplexity_iters)


def _symmetrize_block(idx_blk, p_blk, row0, idx_all, p_all,
                      n_total: int):
    """((p_ij + p_ji) / 2N, mutual) for one row block: p_ji is
    recovered by matching i inside the neighbour lists of the block's
    neighbours ([B,K,K] compare — the sparse-transpose lookup as a
    dense batched op). `mutual` marks edges present in BOTH KNN lists;
    non-mutual edges additionally act on the REVERSE endpoint through a
    scatter in _chunked_step (BarnesHutTsne's union-pattern
    symmetrization, restructured for fixed shapes)."""
    B = idx_blk.shape[0]
    rows = int(row0) + torch.arange(B, device=idx_blk.device)
    match = idx_all[idx_blk] == rows[:, None, None]     # [B,K,K]
    mutual = torch.any(match, dim=-1)                    # [B,K]
    p_back = torch.sum(p_all[idx_blk] * match, dim=-1)  # [B,K]
    return (p_blk + p_back) / (2.0 * n_total), mutual


def _sparse_psym(idx, d, perplexity, row_block: int):
    """(psym, mutual) of the kNN pattern `idx` with distances `d`: the
    calibrated conditional P, symmetrized block by block."""
    n = idx.shape[0]
    p = _p_sparse(d * d, perplexity)
    blk = min(int(row_block), n)
    parts, mut_parts = [], []
    for r0 in range(0, n, blk):
        ps, mu = _symmetrize_block(idx[r0:r0 + blk], p[r0:r0 + blk], r0,
                                   idx, p, n)
        parts.append(ps)
        mut_parts.append(mu)
    return (torch.clamp_min(torch.cat(parts, dim=0), 1e-12),
            torch.cat(mut_parts, dim=0))


def _chunked_step(y, vel, idx, psym, mutual, exaggeration, momentum,
                  lr, row_block: int, n_real: int):
    """One full embedding iteration with the repulsive term streamed
    over [row_block, N] blocks; updates the padded `y` [n_pad,C] and
    `vel` in place and returns (y, vel, kl). The blocks accumulate
    BOTH the partition constant Z and the unscaled repulsive forces
    (1/Z is a scalar, applied after). Sentinel rows keep their
    far-away positions and zero velocity."""
    n_pad, C = y.shape
    dev = y.device
    # attractive term + sparse KL: gathers over the KNN pattern
    y_real = y[:n_real]
    diff = y_real[:, None, :] - y[idx]            # [n_real,K,C]
    d2a = torch.sum(diff * diff, dim=-1)
    numa = 1.0 / (1.0 + d2a)                      # [n_real,K]
    w = psym * exaggeration * numa
    f_attr = 4.0 * torch.sum(w[:, :, None] * diff, dim=1)
    # union-pattern completion: a NON-mutual edge i->j also attracts
    # its reverse endpoint j with the same symmetrized mass
    w_rev = torch.where(mutual, 0.0, w)
    f_attr.index_add_(0, idx.reshape(-1),
                      (4.0 * (w_rev[:, :, None] * -diff)).reshape(-1, C))
    del diff

    # repulsive term: 1 + d2 = [yb, |yb|^2, 1] . [-2y, 1, 1 + |y|^2] — one
    # matmul writes each block's 1 + squared distances
    ysq = torch.sum(y * y, dim=1, keepdim=True)
    ones = torch.ones_like(ysq)
    lhs = torch.cat([y, ysq, ones], dim=1)        # [n_pad, C+2]
    rhs = torch.cat([-2.0 * y, ones, ysq + 1.0], dim=1)
    y1 = torch.cat([y, ones], dim=1)              # rowsum rides the matmul
    buf = torch.empty(row_block, n_pad, device=dev)
    z = torch.zeros((), device=dev)
    f_rep = torch.empty(n_pad, C + 1, device=dev)
    for r0 in range(0, n_pad, row_block):
        num = torch.mm(lhs[r0:r0 + row_block], rhs.T, out=buf)
        num.clamp_(min=1.0).reciprocal_()         # 1 / (1 + max(d2, 0))
        num.diagonal(offset=r0).zero_()           # self pairs
        num[:, n_real:] = 0.0                     # sentinel columns
        real = max(0, min(row_block, n_real - r0))
        z += torch.sum(num[:real])
        torch.mm(num.square_(), y1, out=f_rep[r0:r0 + row_block])
    del buf
    z = torch.clamp_min(z, 1e-12)
    f = f_rep[:n_real]
    # rowsum(num^2) * y_i - (num^2 @ y)_i
    f_rep_real = f[:, C:] * y_real - f[:, :C]
    grad = f_attr - (4.0 / z) * f_rep_real

    q_sparse = torch.clamp_min(numa / z, 1e-12)
    p_safe = torch.clamp_min(psym, 1e-12)
    kl_terms = psym * torch.log(p_safe / q_sparse)
    # count non-mutual pairs from both endpoints, like the dense tier's
    # ordered-pair sum counts every pair twice
    kl = torch.sum(kl_terms) + torch.sum(torch.where(mutual, 0.0,
                                                     kl_terms))

    # momentum update + per-iteration recentering on the REAL rows
    v = vel[:n_real]
    v.mul_(momentum).sub_(grad.mul_(lr))
    y_real.add_(v)
    y_real.sub_(torch.mean(y_real, dim=0))
    return y, vel, kl


class Tsne:
    """ref: BarnesHutTsne builder — nDims, perplexity, theta (accepted
    for parity, ignored: both tiers are exact in the repulsive term),
    learningRate, maxIter, momentum schedule, early exaggeration
    (stopLyingIteration). `method` picks the tier ('auto' streams
    above DENSE_CAP points); `row_block` sizes the streamed tier's
    [row_block, N] kernel blocks (memory/speed trade); `device` is
    where it runs (None: the card).

    After a fit, `kl_` is the final KL divergence and `kl_history_` the
    KL of every iteration (the gradient's KL, before that iteration's
    update)."""

    # dense-tier cap: above this fit_transform streams (method='auto')
    DENSE_CAP = 16384

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 max_iter: int = 500, early_exaggeration: float = 12.0,
                 stop_lying_iteration: int = 100,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 momentum_switch: int = 250, seed: int = 0,
                 method: str = "auto", row_block: int = 2048,
                 device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.early_exaggeration = early_exaggeration
        self.stop_lying_iteration = stop_lying_iteration
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.seed = seed
        if method not in ("auto", "exact", "chunked"):
            raise ValueError(
                f"method must be auto|exact|chunked: {method}")
        self.method = method
        self.row_block = int(row_block)
        if self.row_block < 1:
            raise ValueError(f"row_block must be >= 1: {row_block}")
        self.device = device
        self.kl_: Optional[float] = None
        self.kl_history_: Optional[np.ndarray] = None

    def initial_embedding(self, n: int) -> torch.Tensor:
        """The seeded start, [n, n_components] f32 on the CPU."""
        gen = torch.Generator().manual_seed(int(self.seed))
        return 1e-4 * torch.randn((n, self.n_components), generator=gen)

    def _schedule(self, it: int):
        ex = (self.early_exaggeration
              if it < self.stop_lying_iteration else 1.0)
        mom = (self.initial_momentum
               if it < self.momentum_switch else self.final_momentum)
        return ex, mom

    def fit_transform(self, x) -> np.ndarray:
        x = as_points(x, self.device)
        n = x.shape[0]
        if n - 1 < 3 * self.perplexity:
            raise ValueError(
                f"perplexity {self.perplexity} too large for {n} points "
                "(need n-1 >= 3*perplexity)")
        y = as_points(self.initial_embedding(n), x.device)
        if self.method == "chunked" or (self.method == "auto"
                                        and n > self.DENSE_CAP):
            return self._fit_chunked(x, y)
        p_cond = _p_conditional(x, self.perplexity)
        p = (p_cond + p_cond.T) / (2.0 * n)   # symmetrize (Tsne.java)
        del p_cond
        p.clamp_(min=1e-12)
        vel = torch.zeros_like(y)
        kls = []
        for it in range(self.max_iter):
            ex, mom = self._schedule(it)
            grad, kl = _tsne_grad(y, p, ex)
            vel = mom * vel - self.learning_rate * grad
            y = y + vel
            y = y - torch.mean(y, dim=0)   # keep centered
            kls.append(kl)
        return self._finish(y, kls)

    def _finish(self, y, kls) -> np.ndarray:
        if kls:
            self.kl_history_ = torch.stack(kls).cpu().numpy()
            self.kl_ = float(self.kl_history_[-1])
        return y.cpu().numpy()

    def sparse_neighbours(self, x):
        """Each row's K = 3*perplexity nearest neighbours, itself left
        out: (idx [N,K] int64, distances [N,K])."""
        n = x.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        idx, dist = knn(x, x, k + 1, metric="euclidean",
                        tile=self.row_block)
        # drop each row's self entry (first occurrence; falls back to
        # the farthest column when duplicates displaced it)
        is_self = idx == torch.arange(n, device=idx.device)[:, None]
        is_self &= torch.cumsum(is_self, dim=1) <= 1
        order = torch.sort(is_self.to(torch.int8), dim=1,
                           stable=True).indices
        return (torch.gather(idx, 1, order)[:, :k].contiguous(),
                torch.gather(dist, 1, order)[:, :k])

    def sparse_affinities(self, x):
        """The chunked tier's P: (idx [N,K] int64, psym [N,K], mutual
        [N,K]) over each row's K nearest neighbours."""
        idx, d = self.sparse_neighbours(x)
        return (idx,) + _sparse_psym(idx, d, self.perplexity,
                                     self.row_block)

    def _fit_chunked(self, x, y0) -> np.ndarray:
        """Streamed tier (BarnesHutTsne.java role): KNN-sparse P +
        row-block-streamed repulsive term; memory O(N*row_block +
        N*K)."""
        n = x.shape[0]
        idx, psym, mutual = self.sparse_affinities(x)
        blk = min(self.row_block, n)
        n_pad = -(-n // blk) * blk
        # sentinel rows sit far away: their kernel vs everything ~ 0
        y = torch.cat([y0, torch.full((n_pad - n, self.n_components), 1e6,
                                      device=y0.device)], dim=0)
        vel = torch.zeros_like(y)
        kls = []
        for it in range(self.max_iter):
            ex, mom = self._schedule(it)
            y, vel, kl = _chunked_step(y, vel, idx, psym, mutual, ex, mom,
                                       self.learning_rate, blk, n)
            kls.append(kl)
        return self._finish(y[:n], kls)

    fit = fit_transform
