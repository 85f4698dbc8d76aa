"""StepHarness: the ONE host-side supervisor every fit loop shares
(counterpart of deeplearning4j_tpu/engine/harness.py).

The host half of the engine: the guard-verdict dispatch (sampling
cadence, pre-step snapshot, skip/rollback/abort policy, max_rollbacks
bounding, counters and log lines), preemption handling, per-step
telemetry batching, the input pipeline's ownership and session teardown
live here once; the entry points keep only what is theirs (data
staging, checkpoint formats, epoch semantics). Rollback targets stay
pluggable: TrainingMaster rolls back to its newest valid checkpoint,
EarlyStoppingTrainer and ParallelWrapper to in-memory
PeriodicSnapshotter snapshots.

The watchdog (resilience.StepWatchdog), supervisor (resilience.Supervisor),
tracer (observability.Tracer) and phase profiler
(observability.perf.StepPhaseProfiler; `phase_profiler=True` builds the
default one) are duck-typed hooks that default to None: any object with
their methods serves.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.engine.step_program import StepProgram
from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import (
    FaultInjectedError,
    NonFiniteLossError,
    PreemptedError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire

logger = logging.getLogger("deeplearning4j_tpu_torch")


class StepHarness:
    """One supervisor for one fit loop.

    Owns: the StepProgram, NonFiniteGuard verdict dispatch, StepWatchdog
    lifecycle + tracer parenting, PreemptionHandler install + boundary
    checks, the StepAccumulator per-step metrics batch through, the
    StepPhaseProfiler, resilience counters, and session teardown
    (flush accumulator, stop watchdog, uninstall preemption, close
    attached data iterators). NOT thread-safe — one owner loop, like
    the accumulator it wraps."""

    def __init__(self, net, *, program: Optional[StepProgram] = None,
                 guard=None, watchdog=None, preemption=None,
                 snapshotter=None, supervisor=None, tracer=None,
                 phase_profiler=None, accumulator=None):
        self.net = net
        self.program = program or StepProgram(net)
        self.guard = guard
        self.watchdog = watchdog
        self.preemption = preemption
        self.snapshotter = snapshotter
        self.supervisor = supervisor
        self.tracer = tracer
        self.acc = accumulator or _obs.StepAccumulator()
        # opt-in phase attribution: True builds the default profiler;
        # its emission rides THIS harness's accumulator so the phase
        # histograms cost container appends, not registry locks
        if phase_profiler is True:
            from deeplearning4j_tpu_torch.observability.perf import (
                StepPhaseProfiler,
            )

            phase_profiler = StepPhaseProfiler()
        self.phase_profiler = phase_profiler
        if self.phase_profiler is not None:
            if self.phase_profiler.accumulator is None:
                self.phase_profiler.accumulator = self.acc
            if self.phase_profiler.tracer is None:
                self.phase_profiler.tracer = tracer
        self.counters = {"data_skipped_steps": 0,
                         "grad_poisoned_steps": 0,
                         "preemptions": 0}
        self.poisoned_steps = set()
        self._guard_steps = 0
        self._step_span = None
        self._closeables = []
        self._pipeline = None
        self._pipeline_meta = None

    # ------------------------------------------------------- lifecycle
    def attach_data(self, source) -> None:
        """Register a data source whose `close()` the session teardown
        must call (AsyncDataSetIterator's prefetch thread joins there —
        a fit that raises can no longer leak the producer)."""
        if source is not None and hasattr(source, "close") \
                and source not in self._closeables:
            self._closeables.append(source)

    @contextlib.contextmanager
    def session(self, close_data: bool = True):
        """Setup/teardown every fit shares: install the preemption
        handler, start the watchdog (parenting its monitor-thread hang
        events to this loop's tracer), and on the way out — crash or
        not — flush the metrics accumulator, stop the watchdog,
        uninstall the preemption handler, and close attached data
        iterators."""
        if self.preemption is not None:
            self.preemption.install()
        if self.watchdog is not None:
            self.watchdog.start()
            self.watchdog.tracer = self.tracer
        try:
            yield self
        finally:
            self.acc.flush()
            if self.watchdog is not None:
                self.watchdog.stop()
            if self.preemption is not None:
                self.preemption.uninstall()
            if close_data:
                self.close_data()

    # -------------------------------------------------- input pipeline
    def build_step_pipeline(self, fetch, *, start=0, stop=None,
                            depth=2, skip=None, meta=None):
        """Own a StepPrefetcher for a batch_fn-driven fit loop: the
        producer runs fetch→retry/skip→stage ahead of the compute so
        `data_wait`/`h2d` overlap `device_compute`; the session
        teardown joins its producer like any attached data source.
        `meta` records derivation facts (live world, sharding) for the
        `pipeline` block of training_stats()."""
        from deeplearning4j_tpu_torch.engine.pipeline import StepPrefetcher

        p = StepPrefetcher(fetch, start=start, stop=stop, depth=depth,
                           skip=skip)
        self.attach_data(p)
        self._pipeline = p
        self._pipeline_meta = dict(meta or {})
        return p

    def build_iterator_pipeline(self, source, *, depth=2, queue_size=4,
                                stage=None, host_only=False, meta=None):
        """Own an IteratorPipeline (AsyncDataSetIterator →
        DevicePrefetchIterator) for an iterator-driven fit loop, staging
        on the net's device in its dtype (`host_only=True`: no device
        staging, the host batches as they are); the session teardown
        closes the whole chain (the wrapped producer thread is
        joined)."""
        from deeplearning4j_tpu_torch.engine.pipeline import IteratorPipeline

        p = IteratorPipeline(
            source, depth=depth, queue_size=queue_size, stage=stage,
            device=self.net.device, dtype=self.net.dtype,
            host_only=host_only)
        self.attach_data(p)
        self._pipeline = p
        self._pipeline_meta = dict(meta or {})
        return p

    def pipeline_stats(self):
        """The `pipeline` facts block for training_stats(): None when
        no harness-owned pipeline was built, else its counters plus the
        derivation metadata recorded at build time (facts survive the
        session teardown — the pipeline object keeps its counters after
        close)."""
        if self._pipeline is None:
            return None
        out = {"enabled": True}
        out.update(self._pipeline.facts())
        if self._pipeline_meta:
            out.update(self._pipeline_meta)
        return out

    def close_data(self) -> None:
        """Close attached data sources (idempotent, exception-proof:
        teardown must never mask the fit's own error)."""
        for source in self._closeables:
            try:
                source.close()
            except Exception:   # noqa: BLE001 - teardown is best-effort
                logger.warning("harness: data source close() failed",
                               exc_info=True)
        self._closeables = []

    # ------------------------------------------------------ step scope
    @contextlib.contextmanager
    def step_scope(self, step, observe: bool = True):
        """Per-step accounting around one attempted step: tracer span,
        phase-profiler begin/end, watchdog trace parent, and the
        steps_total/step_seconds emission through the accumulator."""
        tr = self.tracer
        pp = self.phase_profiler
        t0 = time.perf_counter()
        sp = (tr.begin("train_step", cat="train", args={"step": step})
              if tr is not None else None)
        self._step_span = sp
        if self.watchdog is not None:
            self.watchdog.trace_parent = sp
        if pp is not None:
            pp.begin_step(step)
        try:
            yield sp
        finally:
            if observe:
                self.acc.count_observe(
                    "dl4j_train_steps_total", "dl4j_train_step_seconds",
                    time.perf_counter() - t0)
            if pp is not None:
                pp.end_step()
            self._step_span = None
            if sp is not None:
                sp.end()

    @property
    def step_span(self):
        return self._step_span

    def beat(self, phase: str, step=None) -> None:
        if self.watchdog is not None:
            self.watchdog.beat(phase, step=step)

    def mark(self, phase: str) -> None:
        if self.phase_profiler is not None:
            self.phase_profiler.mark(phase)

    def sync(self, value, step=None) -> None:
        if self.phase_profiler is not None:
            self.phase_profiler.sync(value, step=step)

    # ------------------------------------------------------ preemption
    def check_preemption(self, step,
                         save_checkpoint: Optional[Callable] = None):
        """Step-boundary preemption check: a pending SIGTERM/SIGINT (or
        a triggered `train.preempt` fault) checkpoints the CURRENT
        state (when the caller has a checkpoint path) and raises
        PreemptedError — a preempted job loses zero completed steps."""
        requested = False
        try:
            _fire("train.preempt")
        except FaultInjectedError:
            requested = True
            if self.preemption is not None:
                self.preemption.request(simulated=True)
        if self.preemption is not None and self.preemption.requested:
            requested = True
        if not requested:
            return
        self.counters["preemptions"] += 1
        _obs.count("dl4j_train_preemptions_total")
        if self.preemption is not None:
            self.preemption.counters["preemptions"] += 1
            self.preemption.clear()   # a supervised restart may resume
        if save_checkpoint is not None:
            save_checkpoint(step)
        raise PreemptedError(
            f"preempted at step {step}"
            + ("; checkpoint saved" if save_checkpoint is not None
               else ""),
            step=step)

    # ----------------------------------------------------------- guard
    def should_check(self, step=None, force: bool = False) -> bool:
        """This step's guard-check decision: the guard's sampling
        cadence, `force=True` for steps that publish a checkpoint (a
        checkpoint must never publish non-finite state)."""
        g = self.guard
        if g is None:
            return False
        if force:
            return g.check_every > 0
        s = self._guard_steps if step is None else step
        return g.should_check(s)

    def pre_step_snapshot(self, check: bool):
        """skip_step policy needs the pre-step state on checked steps;
        rollback/abort snapshot nothing here (their targets are
        checkpoints / the PeriodicSnapshotter)."""
        if self.snapshotter is not None:
            self.snapshotter.maybe_snapshot(self.net)
        if check and self.guard is not None \
                and self.guard.policy == "skip_step":
            return self.guard.snapshot(self.net)
        return None

    def dispatch_verdict(self, verdict: str, *, snap=None,
                         restore_rollback: Optional[Callable] = None,
                         context: str = "detected") -> str:
        """The ONE guard-verdict policy dispatch. Returns "ok" | "skip"
        | "rollback"; raises NonFiniteLossError for policy='abort' and
        when the rollback budget is exhausted. `restore_rollback`
        restores the caller's rollback target (a PeriodicSnapshotter
        restore for EarlyStoppingTrainer)."""
        if verdict == "ok":
            return "ok"
        g = self.guard
        if g.policy == "skip_step":
            g.restore(self.net, snap)
            g.note_skip()
            logger.warning("guard: %s training state %s — step "
                           "skipped, state restored", verdict, context)
            return "skip"
        if g.policy == "rollback":
            g.note_rollback()
            if g.counters["rollbacks"] > g.max_rollbacks:
                raise NonFiniteLossError(
                    f"guard exceeded max_rollbacks={g.max_rollbacks} "
                    f"(last verdict {verdict} {context})")
            if restore_rollback is not None:
                restore_rollback()
            return "rollback"
        raise NonFiniteLossError(
            f"{verdict} training state {context} (policy=abort)")

    def guarded(self, thunk: Callable, *, context: str = "detected",
                restore_rollback: Optional[Callable] = None,
                observe: bool = True) -> bool:
        """Run one step/group under the guard: sampling, pre-step
        snapshot, execution (with step timing emission when `observe`),
        post-step check, verdict dispatch. False means the step was
        rejected and the rollback/skip target restored — callers skip
        listeners and score checks for rejected steps.

        This is the loop body EarlyStoppingTrainer and ParallelWrapper
        adapt over; TrainingMaster drives the pieces itself (its guard
        check is forced on checkpoint steps and localizes a group's
        poisoned inner step)."""
        g = self.guard
        pp = self.phase_profiler
        step_index = self._guard_steps
        check = g is not None and g.should_check(step_index)
        self._guard_steps += 1
        snap = self.pre_step_snapshot(check)
        if pp is not None:
            pp.begin_step(step_index)
            pp.mark("dispatch")
        try:
            t0 = time.perf_counter()
            thunk()
            if pp is not None:
                pp.sync(getattr(self.net, "_score", None),
                        step=step_index)
                pp.mark("host_sync")
            if observe:
                self.acc.count_observe(
                    "dl4j_train_steps_total", "dl4j_train_step_seconds",
                    time.perf_counter() - t0)
            if not check:
                return True
            if restore_rollback is None and self.snapshotter is not None:
                restore_rollback = \
                    lambda: self.snapshotter.restore(self.net)
            return self.dispatch_verdict(
                g.post_step(self.net), snap=snap,
                restore_rollback=restore_rollback,
                context=context) == "ok"
        finally:
            if pp is not None:
                pp.end_step()

    def flush(self) -> None:
        """Publish the step counters accumulated so far to the metrics
        registry (observability.StepAccumulator.flush)."""
        self.acc.flush()

    # ------------------------------------------------------------ stats
    def resilience_stats(self):
        """Guard / watchdog / preemption / supervisor counters (None
        when no self-healing hook is attached and nothing counted) —
        the block training_stats() exposes."""
        out = {
            "guard": self.guard.stats() if self.guard else None,
            "watchdog": (self.watchdog.stats()
                         if self.watchdog else None),
            "preemption": (self.preemption.stats()
                           if self.preemption else None),
            "supervisor": (self.supervisor.stats()
                           if self.supervisor else None),
            "counters": dict(self.counters),
            "poisoned_steps": sorted(self.poisoned_steps),
        }
        if (all(v is None for k, v in out.items()
                if k not in ("counters", "poisoned_steps"))
                and not any(self.counters.values())
                and not self.poisoned_steps):
            return None
        return out
