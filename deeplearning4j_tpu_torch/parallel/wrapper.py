"""ParallelWrapper: DL4J's in-process trainer (counterpart of
deeplearning4j_tpu/parallel/wrapper.py; parity:
deeplearning4j-scaleout-parallelwrapper/.../ParallelWrapper.java, fit
loop :211-260), on one card.

    pw = ParallelWrapper(net)                          # workers=1
    pw = ParallelWrapper(net, steps_per_dispatch=4)    # k-step windows
    pw.fit(iterator_or_list, epochs=2)

Each batch is one `StepProgram.run`, or with `steps_per_dispatch=k` the
batches group into k-windows, each one `StepProgram.run_group` (on CUDA
one replay of a captured graph of k steps): a shape break (a ragged last
batch) dispatches the window so far, and a window whose batches differ
in carrying a label mask gets all-ones masks where one is missing. The
batches go through the harness's input pipeline (pinned memory, a side
stream) unless `pipeline=False`; multi-input graphs take the host-only
pipeline and step through the net's own train step. A NonFiniteGuard
skips a poisoned batch (`skip_step`) or rewinds to an in-memory
snapshot refreshed every `snapshot_every` steps (`rollback`).

The net stays on its device with its train carry as it is (the flat
carry where the net has one): the JAX package drops the flat carry under
a mesh, where it forces an all-gather of the whole model per step, and
one card has no such all-gather.

Waiting for the port's mesh (ROADMAP queue 9, each raises
NotImplementedError): `workers > 1`, `tp > 1`, a mesh,
`averaging_frequency > 1` (the JAX package's LocalStepTrainer),
`sharding="zero1"`; StaleGradientTrainer.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.engine import StepHarness, stack_staged
from deeplearning4j_tpu_torch.nn.graph import _as_multi
from deeplearning4j_tpu_torch.nn.multilayer import _as_batch


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 9); the port's "
        "ParallelWrapper trains on one card (workers=1, tp=1)")


class ParallelWrapper:
    """In-process trainer around a MultiLayerNetwork/ComputationGraph on
    one card (module docstring)."""

    def __init__(self, net, workers: Optional[int] = None, tp: int = 1,
                 averaging_frequency: int = 1, average_updaters: bool = True,
                 mesh=None, prefetch_buffer: int = 2,
                 threshold_compression: float = 0.0,
                 guard=None, watchdog=None, snapshot_every: int = 0,
                 phase_profiler=None,
                 steps_per_dispatch: int = 1,
                 pipeline: Optional[bool] = None,
                 sharding: Optional[str] = None):
        """The JAX package's options (`average_updaters` and
        `threshold_compression` act only under local SGD, which waits).
        `guard`/`watchdog` give fit() the harness's self-healing
        hooks: the NonFiniteGuard checks loss+params after (sampled)
        steps and skips or aborts on non-finite state; `rollback` needs
        `snapshot_every=N` (an in-memory snapshot of the pre-step state
        refreshed every N guarded steps)."""
        if threshold_compression > 0.0 and max(1, averaging_frequency) <= 1:
            raise ValueError(
                "threshold_compression requires averaging_frequency > 1 "
                "(it encodes the k-step delta at the local-SGD rendezvous)")
        if max(1, averaging_frequency) > 1 and steps_per_dispatch > 1:
            raise ValueError(
                "steps_per_dispatch > 1 and averaging_frequency > 1 "
                "are mutually exclusive groupings")
        if sharding not in (None, "replicated", "zero1"):
            raise ValueError(
                f"sharding must be None|'replicated'|'zero1': {sharding}")
        for cond, what in (
                (workers not in (None, 1), f"workers={workers}"),
                (tp != 1, f"tp={tp}"),
                (mesh is not None, "a device mesh"),
                (averaging_frequency > 1, "averaging_frequency > 1 "
                 "(the JAX package's LocalStepTrainer)"),
                (sharding == "zero1", "sharding='zero1'")):
            if cond:
                raise _not_ported(what)
        self._snapshotter = None
        if guard is not None and guard.policy == "rollback":
            if snapshot_every <= 0:
                raise ValueError(
                    "NonFiniteGuard(policy='rollback') under "
                    "ParallelWrapper needs snapshot_every=N > 0 (an "
                    "in-memory rollback target; TrainingMaster uses "
                    "checkpoints instead)")
            from deeplearning4j_tpu_torch.resilience.supervisor import (
                PeriodicSnapshotter,
            )

            self._snapshotter = PeriodicSnapshotter(
                guard, every=snapshot_every)
        self.net = net
        self.averaging_frequency = 1
        self.prefetch_buffer = prefetch_buffer
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.pipeline = pipeline
        self._multi_io = False
        self._harness = StepHarness(
            net, guard=guard, watchdog=watchdog,
            snapshotter=self._snapshotter, phase_profiler=phase_profiler)
        self.guard = self._harness.guard
        self.watchdog = self._harness.watchdog
        self.phase_profiler = self._harness.phase_profiler

    def _ensure_ready(self):
        ins = getattr(self.net.conf, "network_inputs", None)
        outs = getattr(self.net.conf, "network_outputs", None)
        self._multi_io = ins is not None and (len(ins) > 1 or len(outs) > 1)
        if not self.net._initialized():
            self.net.init()

    def _run_guarded(self, thunk) -> bool:
        """Run one training step/window under the shared harness's
        guard dispatch (engine.StepHarness.guarded); False means the
        step was rejected and the pre-step (skip_step) or newest-
        snapshot (rollback) state restored (callers skip listeners for
        rejected steps)."""
        return self._harness.guarded(thunk, context="detected")

    def _pipeline_enabled(self) -> bool:
        return True if self.pipeline is None else bool(self.pipeline)

    # ------------------------------------------------------------------
    def fit(self, data, epochs: int = 1):
        """Train. `data` is any iterator/list of batches the wrapped net
        accepts (ref fit loop: ParallelWrapper.java:211-260), `epochs`
        passes over it (an iterator with `reset()` is reset per pass).
        The session closes the data source (an AsyncDataSetIterator's
        producer is joined) however the fit ends."""
        self._ensure_ready()
        batches = data if hasattr(data, "__iter__") else [data]
        pre_staged = False
        if self._pipeline_enabled():
            # multi-input graphs take their batches on the host (the
            # async ETL overlap only)
            batches = self._harness.build_iterator_pipeline(
                batches, depth=self.prefetch_buffer,
                host_only=self._multi_io, meta={"workers": 1})
            pre_staged = not self._multi_io
        else:
            self._harness.attach_data(batches)
        with self._harness.session():
            self._fit_loop(batches, epochs, pre_staged)
        return self

    def _listeners_done(self):
        net = self.net
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)

    def _fit_loop(self, batches, epochs, pre_staged=False):
        net = self.net
        k = self.steps_per_dispatch
        program = self._harness.program
        program.require_sgd("ParallelWrapper")
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            window = []     # run_group k-window (staged or host)
            for batch in batches:
                self._harness.beat("batch")
                if self._multi_io:
                    if self._run_guarded(
                            lambda b=batch: self._fit_multi_io(b)):
                        self._listeners_done()
                    continue
                entry = tuple(self._as_tensors(_as_batch(batch),
                                               pre_staged))
                if k > 1:
                    if window and not _window_compatible(window[-1], entry):
                        # shape break: dispatch the shorter window
                        self._run_window(window)
                        window = []
                    window.append(entry)
                    if len(window) == k:
                        self._run_window(window)
                        window = []
                    continue
                if self._run_guarded(lambda e=entry: program.run(*e)):
                    self._listeners_done()
            if window:
                self._run_window(window)
            net.epoch += 1

    def _as_tensors(self, batch, pre_staged):
        """(x, y, fm, lm) as tensors on the net's device: the pipeline
        staged them already, else they are converted here."""
        if pre_staged:
            return batch
        return (None if a is None else self.net._as_input(a) for a in batch)

    def _run_window(self, window) -> bool:
        """One `run_group` over a k-window, masks stacked alongside the
        features: a batch without a mask in a window where another has
        one gets an all-ones mask (a feature mask per example or per
        time step, a label mask per example or per label time step), so
        run_group(k) equals k sequential steps."""
        net = self.net
        program = self._harness.program
        any_fm = any(w[2] is not None for w in window)
        any_lm = any(w[3] is not None for w in window)
        xs, ys, fms, lms = [], [], [], []
        for x, y, fm, lm in window:
            ones = lambda shape: torch.ones(shape, dtype=net.dtype,
                                            device=x.device)
            if any_fm and fm is None:
                fm = ones(x.shape[:1] if x.ndim == 2 else x.shape[:2])
            if any_lm and lm is None:
                lm = ones(y.shape[:1] if y.ndim == 2 else y.shape[:2])
            xs.append(x)
            ys.append(y)
            fms.append(fm)
            lms.append(lm)
        ok = self._run_guarded(lambda: program.run_group(
            stack_staged(xs), stack_staged(ys),
            stack_staged(fms) if any_fm else None,
            stack_staged(lms) if any_lm else None))
        if ok:
            self._listeners_done()
        return ok

    def _fit_multi_io(self, batch):
        """Multi-input/multi-output graph batch: every input, label and
        mask converted onto the net's device, one train step."""
        net = self.net
        ins, labs, fms, lms = _as_multi(batch)
        net._train_step(*net._batch_tensors(ins, labs, fms, lms))

    def output(self, x):
        self._ensure_ready()
        return self.net.output(x)


def _window_compatible(a, b) -> bool:
    """Two batches may share a run_group k-window when their feature/
    label shapes match (the group stacks them) and any masks BOTH carry
    agree in shape (a missing mask is synthesized as ones)."""
    for i in (0, 1):
        if tuple(a[i].shape) != tuple(b[i].shape):
            return False
    for i in (2, 3):
        if a[i] is not None and b[i] is not None \
                and tuple(a[i].shape) != tuple(b[i].shape):
            return False
    return True
