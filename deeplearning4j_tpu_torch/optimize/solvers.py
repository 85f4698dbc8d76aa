"""Line-search solvers (counterpart of deeplearning4j_tpu/optimize/solvers.py):
LBFGS, ConjugateGradient, LineGradientDescent and BackTrackLineSearch.

Selected with `optimization_algo("lbfgs"|"conjugate_gradient"|
"line_gradient_descent")` on the configuration builder;
"stochastic_gradient_descent" (the default) keeps the updater step. A
network's `fit_batch` runs one solver iteration per batch and the solver
carries its curvature history across batches, as the JAX package's.

The loss and its gradient run over the flat parameter vector (the
params' leaves in the JAX package's order, concatenated): one forward
and one backward per gradient, one forward under no_grad per line-search
probe. The line search reads each probe's loss on the host (its Armijo
test decides the next probe), so a solver iteration syncs with the
device a few times; the direction updates are O(N) vector ops.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.tree import leaves, unflatten


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class BackTrackLineSearch:
    """Armijo backtracking: sufficient decrease c1, halving steps (rho),
    at most `max_iterations` probes, a first step capped at `step_max`."""

    def __init__(self, c1: float = 1e-4, rho: float = 0.5,
                 max_iterations: int = 10, step_max: float = 10.0):
        self.c1 = c1
        self.rho = rho
        self.max_iterations = max_iterations
        self.step_max = step_max

    def search(self, f, x0, f0, g0, direction, alpha0: float = 1.0):
        """Minimize f along `direction` from x0. Returns (alpha, f_new),
        alpha 0.0 when no decrease was found or `direction` does not
        descend."""
        gd = _dot(g0, direction)
        if gd >= 0:
            return 0.0, f0
        alpha = min(float(alpha0), self.step_max)
        for _ in range(self.max_iterations):
            f_new = float(f(x0 + alpha * direction))
            if np.isfinite(f_new) and f_new <= f0 + self.c1 * alpha * gd:
                return alpha, f_new
            alpha *= self.rho
        return 0.0, f0


class _FlatProblem:
    """A network's train-mode loss over its flat parameter vector: the
    value and gradient for the solver, the value alone for each probe;
    the BatchNorm states of the accepted point are kept."""

    def __init__(self, net):
        self.net = net

    def flat_params(self):
        return torch.cat([t.detach().reshape(-1)
                          for t in leaves(self.net._params_view())])

    def unravel(self, flat):
        like = self.net._params_view()
        views, o = [], 0
        for t in leaves(like):
            views.append(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()
        return unflatten(like, views)[0]

    def _loss(self, flat, batch):
        inputs, labels, lmasks, fmasks = batch
        loss, (new_states, _) = self.net._loss_fn(
            self.unravel(flat), self.net.states, inputs, labels, lmasks,
            train=True, rng=None, fmasks=fmasks)
        return loss, new_states

    def value_and_grad(self, flat, batch):
        with torch.enable_grad():
            leaf = flat.detach().requires_grad_()
            loss, new_states = self._loss(leaf, batch)
            (grad,) = torch.autograd.grad(loss, [leaf])
        return float(loss.detach()), grad, new_states

    def value(self, flat, batch):
        with torch.no_grad():
            return self._loss(flat, batch)[0]

    def commit(self, flat, new_states=None):
        self.net.params = self.unravel(flat.detach().clone())
        if new_states is not None:
            self.net.states = new_states


class BaseLineSearchOptimizer:
    """One solver iteration per minibatch: a direction, a line search
    along it, and a restart from steepest descent when that finds no
    decrease."""

    name = "base"

    def __init__(self, net, line_search: Optional[BackTrackLineSearch]
                 = None):
        self.net = net
        self.problem = _FlatProblem(net)
        self.line_search = line_search or BackTrackLineSearch()
        self._state: Any = None

    def _direction(self, grad):
        raise NotImplementedError

    def _accepted(self, alpha, step, grad):
        pass

    def _restart(self, grad):
        """Align the bookkeeping with the steepest-descent direction the
        fallback takes."""

    def _alpha0(self) -> float:
        return 1.0

    def step(self, *batch) -> float:
        """One iteration on a batch given as the network's
        `_batch_tensors` returns it. Returns the accepted loss."""
        pb = self.problem
        flat = pb.flat_params()
        f0, grad, _ = pb.value_and_grad(flat, batch)
        probe = lambda v: pb.value(v, batch)
        d = self._direction(grad)
        alpha, f_new = self.line_search.search(probe, flat, f0, grad, d,
                                               self._alpha0())
        if alpha == 0.0:
            # no decrease along d: restart from steepest descent
            self._state = None
            d = -grad
            self._restart(grad)
            alpha, f_new = self.line_search.search(
                probe, flat, f0, grad, d, self.net.conf.learning_rate)
            if alpha == 0.0:
                return f0
        new_flat = flat + alpha * d
        # re-evaluate at the accepted point for its BatchNorm states
        _, _, new_states = pb.value_and_grad(new_flat, batch)
        pb.commit(new_flat, new_states)
        self._accepted(alpha, alpha * d, grad)
        return f_new


class LineGradientDescent(BaseLineSearchOptimizer):
    """Steepest descent with a line search."""

    name = "line_gradient_descent"

    def _direction(self, grad):
        return -grad

    def _alpha0(self):
        return self.net.conf.learning_rate


class ConjugateGradient(BaseLineSearchOptimizer):
    """Nonlinear conjugate gradient, Polak-Ribiere+ (restart when beta
    would be negative)."""

    name = "conjugate_gradient"

    def _direction(self, grad):
        if self._state is None:
            d = -grad
        else:
            g_prev, d_prev = self._state
            beta = _dot(grad, grad - g_prev) / max(_dot(g_prev, g_prev),
                                                   1e-20)
            d = -grad + max(beta, 0.0) * d_prev
        self._g_last = grad
        self._d_last = d
        return d

    def _restart(self, grad):
        self._g_last = grad
        self._d_last = -grad

    def _accepted(self, alpha, step, grad):
        self._state = (self._g_last, self._d_last)


class LBFGS(BaseLineSearchOptimizer):
    """Limited-memory BFGS, the two-loop recursion over the last m
    curvature pairs."""

    name = "lbfgs"

    def __init__(self, net, m: int = 10, **kw):
        super().__init__(net, **kw)
        self.m = m
        self._state = None   # (prev_flat, prev_grad, [(s, y, rho), ...])

    def _direction(self, grad):
        if self._state is None:
            self._hist = []
        else:
            prev_flat, prev_grad, hist = self._state
            s = self._flat_now - prev_flat
            yv = grad - prev_grad
            sy = _dot(s, yv)
            if sy > 1e-10:   # curvature condition
                hist = (hist + [(s, yv, 1.0 / sy)])[-self.m:]
            self._hist = hist
        q = grad
        alphas = []
        for s, yv, rho in reversed(self._hist):
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, yv))
            q = q - a * yv
        if self._hist:
            s, yv, _ = self._hist[-1]
            q = q * (torch.dot(s, yv) / torch.clamp_min(torch.dot(yv, yv),
                                                         1e-20))
        for a, rho, s, yv in reversed(alphas):
            b = rho * torch.dot(yv, q)
            q = q + s * (a - b)
        self._g_last = grad
        return -q

    def step(self, *batch) -> float:
        self._flat_now = self.problem.flat_params()
        return super().step(*batch)

    def _restart(self, grad):
        self._hist = []
        self._g_last = grad

    def _accepted(self, alpha, step, grad):
        self._state = (self._flat_now, self._g_last, self._hist)


_SOLVERS = {
    "lbfgs": LBFGS,
    "conjugate_gradient": ConjugateGradient,
    "line_gradient_descent": LineGradientDescent,
}


def make_solver(algo: str, net):
    """The solver `algo` names for `net`, or None for SGD."""
    key = str(algo).lower()
    if key in ("stochastic_gradient_descent", "sgd"):
        return None
    if key not in _SOLVERS:
        raise ValueError(
            f"Unknown optimization algorithm '{algo}'. Known: "
            f"stochastic_gradient_descent, {', '.join(sorted(_SOLVERS))}")
    return _SOLVERS[key](net)
