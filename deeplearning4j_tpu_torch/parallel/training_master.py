"""TrainingMaster: step-indexed training with crash-safe checkpoints
(counterpart of deeplearning4j_tpu/parallel/training_master.py), on one
process and one card.

`TrainingMaster(net, checkpoint_dir=..., checkpoint_every=...,
steps_per_dispatch=k).fit(batch_fn, num_steps)` trains `num_steps`
global steps, `batch_fn(step) -> (x, y)` giving each step's batch (so a
resumed run replays the data stream from the checkpointed position: the
step index is the iterator position). A killed job relaunched with the
same arguments resumes from the newest valid checkpoint and ends bit for
bit where an uninterrupted run ends.

On the engine (engine/): `steps_per_dispatch=1` runs one
`StepProgram.run` per step; `k > 1` runs `StepProgram.run_group` over
[k, ...]-stacked windows (on CUDA one replay of a captured graph of k
steps; a shorter window — the run's tail, or one the guard shortened —
runs as eager steps). Batches go through the harness's step pipeline: a
producer thread fetches (the `data.next` fault point, `data_retry`,
`skip_bad_batches`, the `train.grad_nonfinite` poisoning) and copies
each batch into pinned host memory; the consumer sends it to the card on
a side stream (`datasets.iterators.DeviceStage`) and, for a window,
stacks the k batches on the card (`engine.pipeline.stack_staged`).

The net stays on its device, and its train carry stays as it is: the
flat carry of updater/flat_chain.py where the net has one (what
`run_group` captures for ResNet-50). The JAX package drops the flat
carry here because under a mesh it forces an all-gather of the whole
model per step; one card has no such all-gather.

Checkpoints (`step-%08d.npz`, the JAX package's layout, so either
package resumes the other's):
  params:i, states:i, upd:i   the leaves of the per-layer params, BN
                              states and updater state in jax.tree_util
                              order (util/tree.leaves), read through the
                              net's views of its flat carry and written
                              back through its params/updater_states
                              setters — never as one flat array;
  step, iteration, epoch      the resume position;
  rng                         a [2] uint32 array of zeros, there so the
                              JAX package's structural check and restore
                              accept the file. The port does not draw
                              from a JAX key: a JAX checkpoint's key is
                              not turned into a torch generator state,
                              and a JAX run restoring a port checkpoint
                              draws its dropout masks from key zero;
  torch_rng                   the net's dropout generator state (uint8),
                              which the JAX package ignores.
The directory's manifest.json records each file's sha256, size and
`extra` {step, state_sha256} (the canonical digest of the arrays), and
latest.json points at the newest step. Writes are atomic (tmp + fsync +
os.replace), fire the `checkpoint.write` fault point before publishing,
retry transient OSErrors (`checkpoint_retry`) and prune to `keep_last`.
A restore validates size, sha256 and structure, and falls back to the
newest valid step.

Waiting for the port's mesh and cluster layers (each raises
NotImplementedError naming its ROADMAP queue): a mesh, more than one
process or device, `averaging_frequency > 1` and
`threshold_compression` (local SGD), `sharding="zero1"`,
`per_rank_checkpoints`, `checkpoint_format="orbax"` and
`initialize_distributed` (queue 9); `export_stats_html` (queue 8).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.iterators import DeviceStage, host_stage
from deeplearning4j_tpu_torch.engine import SKIPPED, StepHarness, stack_staged
from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience import checkpoint_integrity as _ci
from deeplearning4j_tpu_torch.resilience.errors import (
    CheckpointIntegrityError,
    FaultInjectedError,
    PreemptedError,
    StepHangError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire
from deeplearning4j_tpu_torch.resilience.retry import Retry
from deeplearning4j_tpu_torch.resilience.supervisor import (
    PreemptionHandler,
    fire_hang_hard,
)
from deeplearning4j_tpu_torch.util.tree import leaves, unflatten

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _not_ported(what: str, queue: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue {queue}); the port's "
        "TrainingMaster trains on one process and one card")


def _distributed_world() -> int:
    dist = torch.distributed
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class TrainingMaster:
    """Step-indexed training of one net on one card with crash-safe
    checkpoints, a non-finite guard, preemption and data retries (module
    docstring)."""

    def __init__(self, net, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, mesh=None,
                 averaging_frequency: int = 1,
                 threshold_compression: float = 0.0,
                 checkpoint_format: str = "npz",
                 keep_last: int = 0,
                 checkpoint_retry: Optional[Retry] = None,
                 guard=None, watchdog=None, preemption=False,
                 data_retry: Optional[Retry] = None,
                 skip_bad_batches: bool = False,
                 supervisor=None, guard_inner_steps: bool = False,
                 tracer=None, phase_profiler=None,
                 steps_per_dispatch: int = 1,
                 per_rank_checkpoints: bool = False,
                 pipeline: Optional[bool] = None,
                 pipeline_depth: int = 2,
                 sharding: Optional[str] = None):
        """The JAX package's options. `guard`, `watchdog`, `supervisor`,
        `tracer` and `phase_profiler` are the harness's duck-typed hooks
        (engine/harness.py); `preemption=True` installs a
        PreemptionHandler on the main thread for each fit."""
        if checkpoint_format not in ("npz", "orbax"):
            raise ValueError(
                f"checkpoint_format must be npz|orbax: {checkpoint_format}")
        if sharding not in (None, "replicated", "zero1"):
            raise ValueError(
                f"sharding must be None|'replicated'|'zero1': {sharding}")
        if threshold_compression > 0.0 and max(1, averaging_frequency) <= 1:
            raise ValueError(
                "threshold_compression requires averaging_frequency > 1 "
                "(it encodes the k-step delta at the local-SGD rendezvous)")
        if max(1, averaging_frequency) > 1 and steps_per_dispatch > 1:
            raise ValueError(
                "steps_per_dispatch > 1 and averaging_frequency > 1 "
                "are mutually exclusive groupings")
        for cond, what in (
                (mesh is not None, "a device mesh"),
                (_distributed_world() > 1, "more than one process"),
                (averaging_frequency > 1, "averaging_frequency > 1 "
                 "(local SGD, the JAX package's LocalStepTrainer)"),
                (guard_inner_steps, "guard_inner_steps (local SGD)"),
                (sharding == "zero1", "sharding='zero1'"),
                (checkpoint_format == "orbax",
                 "checkpoint_format='orbax'"),
                (per_rank_checkpoints, "per_rank_checkpoints")):
            if cond:
                raise _not_ported(what, 9)
        if guard is not None and guard.policy == "rollback" \
                and not checkpoint_dir:
            raise ValueError(
                "NonFiniteGuard(policy='rollback') requires a "
                "checkpoint_dir to roll back to")
        self.net = net
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        # keep_last > 0 prunes old step checkpoints after each save;
        # transient filesystem errors on the checkpoint path retry with
        # backoff (injected faults / corruption are NOT retryable)
        self.keep_last = int(keep_last)
        self._ckpt_retry = checkpoint_retry or Retry(
            max_attempts=3, initial_backoff_s=0.05,
            retryable=lambda e: isinstance(e, OSError))
        self.guard = guard
        self.watchdog = watchdog
        if preemption is True:
            preemption = PreemptionHandler()
        self.preemption = preemption or None
        self.data_retry = data_retry
        self.skip_bad_batches = skip_bad_batches
        self.supervisor = supervisor
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # the harness-owned step pipeline: default on; pipeline=False
        # fetches and stages on the consumer thread
        self.pipeline = pipeline
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._prefetch = None
        self._stager = None
        self._harness = StepHarness(
            net, guard=guard, watchdog=watchdog,
            preemption=self.preemption, supervisor=supervisor,
            tracer=tracer, phase_profiler=phase_profiler)
        self._obs_acc = self._harness.acc
        self._poisoned_steps = self._harness.poisoned_steps
        self._resil_counters = self._harness.counters

    # tracer / phase_profiler delegate to the harness so post-
    # construction assignment reaches the loop that actually reads them
    @property
    def tracer(self):
        return self._harness.tracer

    @tracer.setter
    def tracer(self, tracer):
        self._harness.tracer = tracer
        pp = self._harness.phase_profiler
        if pp is not None and pp.tracer is None:
            pp.tracer = tracer

    @property
    def phase_profiler(self):
        return self._harness.phase_profiler

    @phase_profiler.setter
    def phase_profiler(self, pp):
        if pp is not None:
            if pp.accumulator is None:
                pp.accumulator = self._harness.acc
            if pp.tracer is None:
                pp.tracer = self._harness.tracer
        self._harness.phase_profiler = pp

    # ------------------------------------------------------------ world
    @staticmethod
    def initialize_distributed(coordinator_address: str,
                               num_processes: int, process_id: int):
        """A no-op for one process, as in the JAX package; more raise."""
        if num_processes > 1:
            raise _not_ported("initialize_distributed (more than one "
                              "process)", 9)

    @staticmethod
    def process_info() -> Tuple[int, int]:
        return 0, 1

    def world_info(self) -> dict:
        """The world this master trains in: one process, one device, dp
        1, replicated (the JAX package's keys)."""
        return {"processes": 1, "devices": 1, "dp": 1,
                "sharding": "replicated", "per_rank_checkpoints": False}

    def _stage_net(self):
        if not self.net._initialized():
            self.net.init()

    # ----------------------------------------------------------------- fit
    def fit(self, batch_fn: Callable[[int], Tuple], num_steps: int,
            start_step: Optional[int] = None,
            collect_training_stats: bool = False):
        """Train for `num_steps` global steps.

        `batch_fn(step) -> (x, y)`: the batch at `step` (deterministic in
        step, so resume replays the data stream from the checkpointed
        position). If `start_step` is None and a checkpoint exists,
        training resumes after the last checkpointed step.

        `collect_training_stats=True` records per-step phase timings
        (data staging / train step / checkpoint), with a host read of the
        loss as each step's barrier, retrievable via `training_stats()`.

        Self-healing (all opt-in via the constructor): a NonFiniteGuard
        checks loss+params after (sampled) steps and skips/rolls-back/
        aborts on NaN or loss spikes (a step that publishes a checkpoint
        is always checked); a PreemptionHandler turns SIGTERM/SIGINT (or
        the `train.preempt` fault) into checkpoint-then-PreemptedError at
        the next step boundary; `data_retry` + `skip_bad_batches` make a
        flaky batch_fn (the `data.next` fault point) survivable."""
        self._stage_net()
        _obs.set_gauge("dl4j_cluster_world_size",
                       self.world_info()["processes"])
        guard = self.guard
        if start_step is None:
            start_step = self.load_latest_checkpoint()
        if collect_training_stats:
            self._stats = []
        self._harness.program.require_sgd("TrainingMaster")
        if (guard is not None and guard.policy == "rollback"
                and self.checkpoint_dir and not self.list_checkpoints()):
            # a rollback target must exist before the first poisoned
            # step — seed one at the fit's starting state
            self.save_checkpoint(start_step)
        self._stager = DeviceStage(self.net.device)
        with self._harness.session():
            self._prefetch = None
            if self._pipeline_enabled():
                self._prefetch = self._harness.build_step_pipeline(
                    lambda s: self._produce(batch_fn, s),
                    start=start_step, stop=num_steps,
                    depth=self.pipeline_depth,
                    skip=self._poisoned_steps.__contains__,
                    meta={"world": self.world_info()})
            if self.steps_per_dispatch > 1:
                return self._fit_grouped(batch_fn, num_steps, start_step,
                                         collect_training_stats)
            step = start_step
            while step < num_steps:
                if step in self._poisoned_steps:
                    step += 1   # rollback replay: skip the poisoned
                    continue    # data window, train nothing on it
                self._check_preemption(step)
                with self._harness.step_scope(step):
                    step = self._fit_one_step(
                        batch_fn, step, collect_training_stats)
        return self

    def _fit_one_step(self, batch_fn, step,
                      collect_training_stats) -> int:
        """One attempted global step (fit() wraps it in the harness's
        step_scope for span + metric accounting): returns the step
        index to continue from — step+1 normally and on skips, the
        restored step after a rollback."""
        net = self.net
        guard = self.guard
        harness = self._harness
        tr = self.tracer
        sp = harness.step_span
        _fire("train.step")
        _fire("train.hang")
        fire_hang_hard()
        harness.beat("dispatch", step=step)
        harness.mark("data_wait")
        t0 = time.perf_counter()
        staged = self._fetch_step(batch_fn, step)
        if staged is None:      # bad batch skipped by policy
            return step + 1
        x, y = staged
        t1 = time.perf_counter()
        if tr is not None:
            tr.record("fetch_and_stage", t0, t1, cat="train", parent=sp)
        done = step + 1
        ckpt_due = bool(
            self.checkpoint_dir and self.checkpoint_every
            and done % self.checkpoint_every == 0)
        # a checkpoint must never publish non-finite state: force a
        # check on checkpoint steps even when the sampling cadence
        # would skip them
        check_now = harness.should_check(step=step) \
            or (ckpt_due and harness.should_check(force=True))
        snap = harness.pre_step_snapshot(check_now)
        harness.mark("dispatch")
        harness.program.run(x, y)
        t_disp = time.perf_counter()
        if tr is not None:
            tr.record("dispatch", t1, t_disp, cat="train", parent=sp)
        harness.beat("fetch", step=step)
        harness.sync(getattr(net, "_score", None), step=step)
        harness.mark("host_sync")
        if check_now:
            verdict = guard.post_step(net)
            if verdict != "ok":
                restored = {}

                def _rollback_to_checkpoint():
                    self._poisoned_steps.add(step)
                    restored["step"] = self.load_latest_checkpoint()
                    logger.warning(
                        "guard: rolled back to checkpoint step %d; "
                        "step %d will be skipped on replay",
                        restored["step"], step)

                action = harness.dispatch_verdict(
                    verdict, snap=snap,
                    restore_rollback=_rollback_to_checkpoint,
                    context=f"at step {step}")
                if action == "skip":
                    return step + 1
                if action == "rollback":
                    return restored["step"]
        if collect_training_stats:
            float(net.score())   # host read: the step's barrier
        t2 = time.perf_counter()
        if tr is not None and (check_now or collect_training_stats):
            tr.record("device_sync", t_disp, t2, cat="train", parent=sp)
        harness.mark("telemetry")
        for listener in getattr(net, "listeners", ()):
            listener.iteration_done(net, net.iteration)
        t3 = time.perf_counter()
        if ckpt_due:
            harness.mark("checkpoint")
            self.save_checkpoint(done)
        if collect_training_stats:
            self._stats.append({
                "step": step,
                "data_ms": (t1 - t0) * 1e3,
                "fit_ms": (t2 - t1) * 1e3,
                "listener_ms": (t3 - t2) * 1e3,
                "checkpoint_ms": (time.perf_counter() - t3) * 1e3,
            })
        return step + 1

    # --------------------------------------------------- input pipeline
    def _pipeline_enabled(self) -> bool:
        return True if self.pipeline is None else bool(self.pipeline)

    def _host_batch(self, batch):
        """A fetched batch after chaos poisoning, converted to the net's
        dtype in pinned host memory for a card (host arrays for the
        CPU): the host half of staging, safe on any thread."""
        x, y = batch[0], batch[1]
        return host_stage((self._maybe_poison(x), y),
                          device=self.net.device, dtype=self.net.dtype)

    def _to_device(self, host):
        """The device half: (x, y) tensors on the net's device."""
        return tuple(self.net._as_input(a)
                     for a in self._stager(host))

    def _produce(self, batch_fn, step):
        """Producer-side work for ONE step (runs on the prefetch
        thread): the `data.next` fault point + `data_retry`/
        `skip_bad_batches` policy, chaos poisoning and the host half of
        staging — a poisoned batch condemns the right step, and the
        fetch of step k+1 overlaps compute on step k. Returns the host
        batch, or SKIPPED when the skip policy consumed the failure."""
        b = self._next_batch(batch_fn, step, observe=False)
        if b is None:
            return SKIPPED
        return self._host_batch(b)

    def _fetch_host(self, batch_fn, step):
        """The host batch for `step` (None when skipped by policy):
        from the prefetcher when the pipeline is on (the residual wait
        is what data_wait shrinks to), else fetched here."""
        if self._prefetch is not None:
            t0 = time.perf_counter()
            out = self._prefetch.get(step)
            if out is not None:
                self._obs_acc.observe("dl4j_train_data_wait_seconds",
                                      time.perf_counter() - t0)
            return out
        batch = self._next_batch(batch_fn, step)
        return None if batch is None else self._host_batch(batch)

    def _fetch_step(self, batch_fn, step):
        """Staged (x, y) device tensors for `step`, or None when the step
        was skipped by policy."""
        host = self._fetch_host(batch_fn, step)
        self._harness.mark("h2d")
        return None if host is None else self._to_device(host)

    def _fetch_window(self, batch_fn, step, span):
        """(group, abs_steps) for a k-window's non-poisoned steps: host
        batches, in the same per-inner-step order (and so the same
        fault-point hit -> step mapping) with the pipeline on or off."""
        group, abs_steps = [], []
        for s in range(step, step + span):
            if s in self._poisoned_steps:
                continue   # rollback replay: skip poisoned data
            host = self._fetch_host(batch_fn, s)
            if host is not None:
                group.append(host)
                abs_steps.append(s)
        return group, abs_steps

    def _stack_window(self, group):
        """[k] host batches -> ([k, B, ...], [k, B, ...]) on the device:
        each batch sent on the side stream, then stacked on the card
        (stack_staged: no host-side stack of the window)."""
        staged = [self._to_device(h) for h in group]
        return (stack_staged([g[0] for g in staged]),
                stack_staged([g[1] for g in staged]))

    # ------------------------------------------------------- self-healing
    def _next_batch(self, batch_fn, step, observe: bool = True):
        """Fetch this step's batch through the `data.next` fault point,
        retried per `data_retry`; returns None (skip the step) when the
        fetch ultimately fails and `skip_bad_batches` is set.
        `observe=False` on the pipeline's producer thread: the
        StepAccumulator is single-owner, so the consumer observes its
        own (residual) wait instead."""
        def get():
            _fire("data.next")
            return batch_fn(step)

        t_fetch = time.perf_counter()
        try:
            if self.data_retry is not None:
                out = self.data_retry.call(get)
            else:
                out = get()
        except (StepHangError, PreemptedError):
            raise          # escalations, not data failures
        except Exception:
            if self.skip_bad_batches:
                self._resil_counters["data_skipped_steps"] += 1
                _obs.count("dl4j_train_data_skipped_steps_total")
                logger.warning("data.next failed at step %d — step "
                               "skipped (skip_bad_batches)", step)
                return None
            raise
        if observe:
            self._obs_acc.observe("dl4j_train_data_wait_seconds",
                                  time.perf_counter() - t_fetch)
        return out

    def _maybe_poison(self, x):
        """`train.grad_nonfinite` chaos hook: a triggered fire is
        consumed by poisoning the batch with NaN, so non-finite
        loss/grads flow through the REAL step math (what the guard must
        catch), not a synthetic exception."""
        try:
            _fire("train.grad_nonfinite")
        except FaultInjectedError:
            self._resil_counters["grad_poisoned_steps"] += 1
            x = np.full(tuple(x.shape), np.nan, np.float32)
        return x

    def _check_preemption(self, step):
        """Step-boundary preemption check (engine.StepHarness owns the
        logic): a pending SIGTERM/SIGINT or a triggered `train.preempt`
        fault checkpoints the CURRENT state and raises PreemptedError."""
        self._harness.check_preemption(
            step, save_checkpoint=(self.save_checkpoint
                                   if self.checkpoint_dir else None))

    def _fit_grouped(self, batch_fn, num_steps, start_step,
                     collect_training_stats=False):
        """`steps_per_dispatch=k`: one `run_group` per k-window, data
        stacked [k, B, ...] on the card. The group's per-inner-step
        losses are read only on checked groups, so the guard condemns
        the ONE poisoned inner step (the first non-finite loss; later
        ones are downstream contamination) and the window replays
        without it — eagerly, since it is shorter than the captured
        group."""
        net = self.net
        guard = self.guard
        harness = self._harness
        program = harness.program
        k = self.steps_per_dispatch
        every = self.checkpoint_every
        pp = self.phase_profiler
        step = start_step
        while step < num_steps:
            self._check_preemption(step)
            _fire("train.step")
            _fire("train.hang")
            fire_hang_hard()
            harness.beat("dispatch", step=step)
            if pp is not None:
                pp.begin_step(step)
                pp.mark("data_wait")
            t0 = time.perf_counter()
            span = min(step + k, num_steps) - step
            group, abs_steps = self._fetch_window(batch_fn, step, span)
            if not group:
                step += span
                continue
            if pp is not None:
                pp.mark("h2d")
            xs, ys = self._stack_window(group)
            t1 = time.perf_counter()
            # guard at group granularity: one check per dispatch
            check_now = guard is not None and guard.check_every > 0
            snap = harness.pre_step_snapshot(check_now)
            if pp is not None:
                pp.mark("dispatch")
            program.run_group(xs, ys)
            harness.beat("fetch", step=step)
            if pp is not None:
                pp.mark("host_sync")
            if check_now:
                finite = torch.isfinite(
                    program.last_step_losses).cpu().numpy()
                bad = ([abs_steps[int(np.argmax(~finite))]]
                       if not finite.all() else [])
                if bad:
                    guard.counters["checks"] += 1
                    guard.counters["nonfinite"] += 1
                    _obs.count("dl4j_train_guard_checks_total")
                    _obs.count("dl4j_train_guard_nonfinite_total")
                    self._poisoned_steps.update(bad)
                    restored = {}

                    def _rollback_group():
                        restored["step"] = self.load_latest_checkpoint()

                    action = harness.dispatch_verdict(
                        "nonfinite", snap=snap,
                        restore_rollback=_rollback_group,
                        context=f"at inner step(s) {bad} of group at "
                                f"step {step}")
                    if action == "skip":
                        logger.warning(
                            "guard: non-finite inner step(s) %s — "
                            "window replayed without them", bad)
                    else:   # rollback
                        step = restored["step"]
                    continue   # re-enter the window minus `bad`
                verdict = guard.post_step(net)
                if verdict != "ok":
                    restored = {}

                    def _rollback_window():
                        self._poisoned_steps.update(
                            range(step, step + span))
                        restored["step"] = self.load_latest_checkpoint()

                    action = harness.dispatch_verdict(
                        verdict, snap=snap,
                        restore_rollback=_rollback_window,
                        context=f"in group at step {step}")
                    step = step + span if action == "skip" \
                        else restored["step"]
                    continue
            if collect_training_stats:
                float(net.score())   # host read: the group's barrier
            t2 = time.perf_counter()
            # group telemetry: steps_total counts the inner steps
            # actually trained; step_seconds stays in per-step units
            self._obs_acc.count_observe(
                "dl4j_train_steps_total", "dl4j_train_step_seconds",
                (t2 - t0) / max(1, len(abs_steps)), n=len(abs_steps))
            if self.tracer is not None:
                self.tracer.record(
                    "train_group", t0, t2, cat="train",
                    args={"step": step, "steps": len(abs_steps)})
            for listener in getattr(net, "listeners", ()):
                listener.iteration_done(net, net.iteration)
            prev = step
            step += span
            # checkpoint when the group CROSSES a cadence boundary
            # (group ends rarely align with checkpoint_every)
            if (self.checkpoint_dir and every
                    and prev // every != step // every):
                if pp is not None:
                    pp.mark("checkpoint")
                self.save_checkpoint(step)
            if pp is not None:
                pp.end_step()
            if collect_training_stats:
                self._stats.append({
                    "step": prev,
                    "data_ms": (t1 - t0) * 1e3,
                    "fit_ms": (t2 - t1) * 1e3,
                    "listener_ms": 0.0,
                    "checkpoint_ms": (time.perf_counter() - t2) * 1e3,
                })
        return self

    # ------------------------------------------------------------ stats
    def training_stats(self):
        """Per-step phase timings recorded when fit(...,
        collect_training_stats=True): a list of dicts plus an aggregate
        row, the `resilience` block (guard / preemption / supervisor
        counters) and the `pipeline` facts. `wire` (local SGD) and
        `profiler` stay None until their ports (ROADMAP queues 9, 8)."""
        stats = list(getattr(self, "_stats", []))
        out = {"steps": stats, "summary": {}, "wire": None,
               "resilience": self.resilience_stats(), "profiler": None,
               "phases": (self.phase_profiler.report()
                          if self.phase_profiler is not None else None),
               "pipeline": self._harness.pipeline_stats()}
        if stats:
            out["summary"] = {
                k: float(np.mean([s[k] for s in stats]))
                for k in ("data_ms", "fit_ms", "listener_ms",
                          "checkpoint_ms")}
        return out

    def resilience_stats(self):
        """Guard / watchdog / preemption / restart counters (None when
        no self-healing hook is attached and nothing was counted)."""
        return self._harness.resilience_stats()

    def export_stats_html(self, path: str):
        raise _not_ported("export_stats_html (the stats/ package)", 8)

    # ------------------------------------------------------------ evaluate
    def evaluate(self, batch_fn: Callable[[int], Tuple], num_steps: int,
                 evaluation=None):
        """Classification counts over `num_steps` batches of
        `batch_fn(step) -> (x, y[, features_mask[, labels_mask]])`: the
        argmax confusion counts are summed on the device and folded into
        `evaluation` (the port's eval.Evaluation) once per batch. Only
        the label mask shapes the counts (rows or time steps whose mask
        is 0 are dropped), as the containers' evaluate() does."""
        from deeplearning4j_tpu_torch.eval import Evaluation

        self._stage_net()
        net = self.net
        if evaluation is None:
            evaluation = Evaluation()
        for step in range(num_steps):
            batch = batch_fn(step)
            out = net.output(batch[0])
            y = net._as_input(batch[1])
            c = y.shape[-1]
            cell = (torch.argmax(y, -1).reshape(-1) * c
                    + torch.argmax(out, -1).reshape(-1))
            lm = batch[3] if len(batch) > 3 else None
            if lm is not None:
                cell = cell[net._as_input(lm).reshape(-1) != 0]
            counts = torch.bincount(cell, minlength=c * c)
            evaluation._ensure(c)
            evaluation.confusion.matrix += \
                counts.reshape(c, c).cpu().numpy().astype(np.int64)
        return evaluation

    # ------------------------------------------------------- checkpointing
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, _ci.step_filename(step))

    def save_checkpoint(self, step: int):
        """Timed wrapper around the save: checkpoint write latency +
        count land in the registry, and with a tracer attached the save
        records a span parented to the current step span."""
        t0 = time.perf_counter()
        result = self._save_checkpoint_impl(step)
        t1 = time.perf_counter()
        _obs.count("dl4j_checkpoint_writes_total")
        _obs.observe("dl4j_checkpoint_write_seconds", t1 - t0)
        if self.tracer is not None:
            self.tracer.record("checkpoint_save", t0, t1,
                               cat="checkpoint",
                               parent=self._harness.step_span,
                               args={"step": step})
        return result

    def _payload(self, step: int) -> dict:
        """The checkpoint's arrays (module docstring): the net's state
        read through views of its carry, copied to the host."""
        net = self.net
        payload = {}
        for group, tree in (("params", net._params_view()),
                            ("states", net.states),
                            ("upd", net._upd_view())):
            for i, leaf in enumerate(leaves(tree)):
                payload[f"{group}:{i}"] = _host(leaf)
        payload["rng"] = np.zeros(2, np.uint32)
        gen = net._rng_state()
        if gen is not None:
            payload["torch_rng"] = _host(gen)
        payload["step"] = np.asarray(step)
        payload["iteration"] = np.asarray(int(net.iteration))
        payload["epoch"] = np.asarray(int(net.epoch))
        return payload

    def _save_checkpoint_impl(self, step: int):
        """Write the payload as one crash-safe .npz: tmp + fsync +
        os.replace with a sha256 manifest entry recorded from the
        pre-publish bytes, so a kill mid-write publishes nothing and a
        torn write is detected on load; transient OSErrors retry per
        `checkpoint_retry`; `keep_last` prunes old steps."""
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        net = self.net
        payload = self._payload(step)
        final = self._ckpt_path(step)
        fn = os.path.basename(final)
        state_sha = _ci.state_digest_of(payload)

        def _write():
            with _ci.atomic_writer(final, suffix=".tmp.npz") as tmp:
                with open(tmp, "wb") as f:
                    np.savez(f, **payload)
                digest = _ci.sha256_file(tmp)
                size = os.path.getsize(tmp)
                # chaos hook: 'raise' = kill mid-write (tmp discarded,
                # nothing published); 'truncate' = torn write slipping
                # past the atomic publish — caught by the checksum
                _fire("checkpoint.write", path=tmp)
            _ci.record_checksum(self.checkpoint_dir, fn, digest, size,
                                extra={"step": step,
                                       "state_sha256": state_sha})

        self._ckpt_retry.call(_write)
        meta = {"step": step, "iteration": int(net.iteration),
                "epoch": int(net.epoch)}
        _ci.atomic_write_json(
            os.path.join(self.checkpoint_dir, "latest.json"), meta)
        _ci.apply_retention(self.checkpoint_dir, self.keep_last)

    @staticmethod
    def _structural_ok(path: str) -> None:
        """Cheap structural probe: a truncated/torn .npz fails to open
        or to yield its zip directory. Raises on damage."""
        with np.load(path) as z:
            z["rng"]

    def _read_latest_meta(self):
        latest = os.path.join(self.checkpoint_dir, "latest.json")
        try:
            with open(latest) as f:
                return json.load(f)
        except (OSError, ValueError):
            # missing or torn latest pointer: fall back to a dir scan
            return None

    def _select_valid_step(self, meta) -> Optional[int]:
        """The step to restore: the latest pointer's target if it passes
        checksum + structural validation, else the newest checkpoint in
        the directory that does."""
        if meta is not None and "step" in meta:
            step = meta["step"]
            if _ci.validate_file(self.checkpoint_dir,
                                 _ci.step_filename(step)):
                try:
                    self._structural_ok(self._ckpt_path(step))
                    return step
                except Exception:   # noqa: BLE001 - damaged file
                    pass
        return _ci.newest_valid_checkpoint(
            self.checkpoint_dir, structural_check=self._structural_ok)

    def load_latest_checkpoint(self) -> int:
        """Restore the newest *valid* checkpoint if present; returns the
        step to resume FROM (0 if none survives validation).
        Corrupt/truncated candidates are skipped in favor of the newest
        one passing sha256 + structural checks."""
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return 0
        meta = self._read_latest_meta()
        step = self._select_valid_step(meta)
        if step is None:
            return 0
        return self._restore_npz(step, meta)

    def load_checkpoint_at(self, step: int) -> int:
        """Restore EXACTLY `step` (validated), raising on a missing/torn
        file instead of silently falling back. step <= 0 means 'no
        checkpoint': start fresh."""
        if step <= 0:
            self._stage_net()
            return 0
        path = self._ckpt_path(step)
        if not _ci.validate_file(self.checkpoint_dir or "",
                                 os.path.basename(path)):
            raise CheckpointIntegrityError(
                f"resume handshake: checkpoint step {step} missing or "
                f"failed validation in {self.checkpoint_dir}")
        self._structural_ok(path)
        return self._restore_npz(step, self._read_latest_meta())

    def _restore_npz(self, step: int, meta) -> int:
        """Rebind the net's params, updater state and BN states (and the
        dropout generator, for a port checkpoint) to checkpoint `step`,
        in the net's device and dtypes. The net's next step ravels its
        flat carry from them again; a captured group copies the carry
        into its static buffers per replay, so nothing is recaptured."""
        t_restore = time.perf_counter()
        net = self.net
        self._stage_net()
        with self._ckpt_retry.call(np.load, self._ckpt_path(step)) as data:
            def restore(group, like):
                old = leaves(like)
                new = []
                for i, t in enumerate(old):
                    a = data[f"{group}:{i}"]
                    if tuple(a.shape) != tuple(t.shape):
                        raise CheckpointIntegrityError(
                            f"checkpoint step {step}: {group}:{i} has "
                            f"shape {a.shape}, the net needs "
                            f"{tuple(t.shape)}")
                    new.append(torch.from_numpy(np.array(a)).to(
                        device=t.device, dtype=t.dtype))
                return unflatten(like, new)[0]

            params = restore("params", net._params_view())
            upd = restore("upd", net._upd_view())
            states = restore("states", net.states)
            gen = (np.array(data["torch_rng"])
                   if "torch_rng" in data.files else None)
            position = ((int(data["iteration"]), int(data["epoch"]))
                        if "iteration" in data.files else None)
        net.params = params
        net.updater_states = upd
        net.states = states
        if gen is not None and net._drop_gen is not None:
            net._set_rng_state(torch.from_numpy(gen))
        # newer checkpoints are self-describing; latest.json only covers
        # the pre-manifest format (and may describe a different step)
        if position is not None:
            net.iteration, net.epoch = position
        elif meta is not None and meta.get("step") == step:
            net.iteration = meta["iteration"]
            net.epoch = meta["epoch"]
        _obs.count("dl4j_checkpoint_restores_total")
        _obs.observe("dl4j_checkpoint_restore_seconds",
                     time.perf_counter() - t_restore)
        return step

    def list_checkpoints(self):
        return [s for s, _ in _ci.list_all_checkpoints(self.checkpoint_dir)]
