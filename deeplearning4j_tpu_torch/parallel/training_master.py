"""TrainingMaster: step-indexed training with crash-safe checkpoints
(counterpart of deeplearning4j_tpu/parallel/training_master.py), one
process per rank and one card per process.

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
`run_group` captures for ResNet-50; under per-step dp its gradient is
the one all-reduced bucket). The JAX package drops the flat carry here
because under a GSPMD mesh it forces an all-gather of the whole model
per step; a rank of the port holds its params whole. ZeRO-1 works on the
per-layer trees.

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

Scale-out (parallel/collectives.py: one process per rank, one device
per process). `initialize_distributed(address, n, rank)` joins the
process group (NCCL on CUDA, gloo on the CPU); every rank then builds
the same net (same configuration and seed) and calls the same methods.
The mesh (default: dp = the world size) may have other axes above 1, as
the JAX package's TrainingMaster takes any mesh and replicates its
params over them: the ranks that share a dp coordinate are replicas,
`batch_fn(step)` giving each of them that coordinate's partition of the
global batch (the global batch is dp equal shares in coordinate order),
and every dp collective runs over the dp axis group alone:
  - per-step dp (default): each step's gradient and loss averaged over
    the dp ranks inside the step, BatchNorm statistics (ghost rows
    included) and the loss's row count global; `steps_per_dispatch=k`
    captures the collectives with the k steps (NCCL);
  - `averaging_frequency=k > 1`: local SGD through LocalStepTrainer
    (`threshold_compression`, `guard_inner_steps`; the wire accounting in
    `training_stats()["wire"]`);
  - `sharding="zero1"`: the ZeRO-1 step through a MeshManager and
    `StepProgram.attach_mesh`, its state sharded over dp (replicas hold
    equal slices); each checkpoint's sharded optimizer leaves go to a
    per-rank `step-%08d.updshard.npz` sidecar holding the slice of the
    rank's dp coordinate (the save's gather timed into
    `dl4j_mesh_allgather_seconds`), the replicated rest and the layout
    (`upd_sharded_idx`, `shard_world` = dp) to the main file; a resume
    reassembles the slices by dp coordinate and re-slices them for the
    live dp (`dl4j_mesh_reshard_total` when the two differ);
  - `per_rank_checkpoints=True`: every rank writes its own copy under
    `<dir>/rank-<r>/` (the divergence quorum's voters: all ranks,
    replicas included); else rank 0 writes;
  - `evaluate` sums the confusion counts over the dp ranks.
`checkpoint_format="orbax"` raises ValueError naming the npz format
(orbax is a JAX library).

Observability: a `tracer` records a span per step ("train_step", with
its fetch/dispatch/device-sync/checkpoint children) or per k-window
("train_group", open while the window runs, so the watchdog's hang
instant parents to it); `phase_profiler` (True, or a StepPhaseProfiler)
attributes each step — each window under `steps_per_dispatch=k`, as in
the JAX package — to phases, its sampled device sync being the only sync
it adds (for a window: the wait for the previous window's replay, just
before this one's is launched, so the profiler does not stop the next
window's staging from overlapping the replay); `training_stats()` carries `phases`, `resilience` (guard,
watchdog, preemption, supervisor counters) and `profiler` (an attached
ProfilerListener's trace_dir); `export_stats_html` writes the timeline.
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


def _distributed_world() -> int:
    dist = torch.distributed
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class TrainingMaster:
    """Step-indexed training of one net, one card per rank, with crash-safe
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
        from deeplearning4j_tpu_torch.parallel.wrapper import (
            _require_local_sgd,
            resolve_mesh,
        )

        if checkpoint_format not in ("npz", "orbax"):
            raise ValueError(
                f"checkpoint_format must be npz|orbax: {checkpoint_format}")
        if checkpoint_format == "orbax":
            raise ValueError(
                "checkpoint_format='orbax' is a JAX library's format; the "
                "port writes checkpoint_format='npz' (the JAX package "
                "reads and writes it too)")
        if sharding not in (None, "replicated", "zero1"):
            raise ValueError(
                f"sharding must be None|'replicated'|'zero1': {sharding}")
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.threshold_compression = float(threshold_compression)
        _require_local_sgd(self.averaging_frequency,
                           self.threshold_compression)
        if self.averaging_frequency > 1 and steps_per_dispatch > 1:
            raise ValueError(
                "steps_per_dispatch > 1 and averaging_frequency > 1 "
                "are mutually exclusive groupings (the local-SGD "
                "rendezvous already groups its k steps)")
        self.zero1 = sharding == "zero1"
        if self.zero1 and self.averaging_frequency > 1:
            raise ValueError(
                "sharding='zero1' and averaging_frequency > 1 are "
                "incompatible (local SGD keeps per-shard params; "
                "ZeRO-1 shards the synchronous update)")
        if guard is not None and guard.policy == "rollback" \
                and not checkpoint_dir:
            raise ValueError(
                "NonFiniteGuard(policy='rollback') requires a "
                "checkpoint_dir to roll back to")
        self.mesh = resolve_mesh(mesh)
        self.net = net
        # per-rank checkpoint copies (`<dir>/rank-<r>/`): every process
        # writes its own copy — the divergence quorum's voters
        self.per_rank_checkpoints = bool(per_rank_checkpoints)
        self._ckpt_base = checkpoint_dir
        if self.per_rank_checkpoints and checkpoint_dir:
            checkpoint_dir = _ci.rank_checkpoint_dir(
                checkpoint_dir, self.mesh.rank)
        if (self.zero1 and checkpoint_dir and self.mesh.world > 1
                and not self.per_rank_checkpoints):
            raise ValueError(
                "sharding='zero1' in a multi-process gang needs "
                "per_rank_checkpoints=True (every rank must write its own "
                "optimizer-state slice)")
        self.checkpoint_format = checkpoint_format
        self.guard_inner_steps = bool(guard_inner_steps)
        self._local_step = None
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
        self._mesh_mgr = None
        if self.zero1:
            from deeplearning4j_tpu_torch.engine.mesh import MeshManager

            self._mesh_mgr = MeshManager(mesh=self.mesh)

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
                               num_processes: int, process_id: int,
                               backend: Optional[str] = None, device=None):
        """Join the process group of `num_processes` ranks as rank
        `process_id` (parallel/collectives.init_process_group), before
        any TrainingMaster is built. `backend=None`: NCCL for a CUDA
        `device` (None means "cuda") and gloo for "cpu". A no-op for one
        process, as in the JAX package."""
        if num_processes <= 1:
            return
        from deeplearning4j_tpu_torch.parallel import collectives

        collectives.init_process_group(coordinator_address, num_processes,
                                       process_id, backend=backend,
                                       device=device)

    @staticmethod
    def process_info() -> Tuple[int, int]:
        from deeplearning4j_tpu_torch.parallel import collectives

        return collectives.rank(), collectives.world_size()

    def world_info(self) -> dict:
        """The LIVE world this master trains in (the JAX package's keys):
        processes and devices are the process group's size (one device
        per process), dp the mesh's."""
        w = _distributed_world()
        return {"processes": w, "devices": w,
                "dp": int(self.mesh.shape["dp"]),
                "sharding": "zero1" if self.zero1 else "replicated",
                "per_rank_checkpoints": self.per_rank_checkpoints}

    def _stage_net(self):
        """Initialize the net and attach its data parallelism: the ZeRO-1
        step (a MeshManager), or per-step dp over a world > 1 (local SGD
        attaches nothing: its trainer averages at the rendezvous)."""
        from deeplearning4j_tpu_torch.parallel.wrapper import (
            attach_dp,
            decorrelate_dropout,
        )

        if not self.net._initialized():
            self.net.init()
        if getattr(self, "_attached", False):
            return
        self._attached = True
        if self._mesh_mgr is not None:
            self._harness.program.attach_mesh(self._mesh_mgr)
            decorrelate_dropout(self.net, self.mesh.dp_coord)
        elif self.averaging_frequency == 1:
            attach_dp(self.net, self.mesh)
        else:
            decorrelate_dropout(self.net, self.mesh.dp_coord)

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
            if self.averaging_frequency > 1:
                return self._fit_local_sgd(batch_fn, num_steps, start_step,
                                           collect_training_stats)
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
            # analyze: allow=jit-host-sync — opt-in stats barrier
            float(net.score())   # host read: the step's barrier
        t2 = time.perf_counter()
        if tr is not None and (check_now or collect_training_stats):
            tr.record("device_sync", t_disp, t2, cat="train", parent=sp)
        harness.mark("telemetry")
        for listener in net.listeners:
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
        harness = self._harness
        k = self.steps_per_dispatch
        every = self.checkpoint_every
        step = start_step
        while step < num_steps:
            self._check_preemption(step)
            # the window's span is open while it runs: the step span the
            # watchdog parents a hang to, and the checkpoint's parent
            sp = (self.tracer.begin("train_group", cat="train",
                                    args={"step": step})
                  if self.tracer is not None else None)
            harness._step_span = sp
            if harness.watchdog is not None:
                harness.watchdog.trace_parent = sp
            try:
                step = self._fit_window(batch_fn, num_steps, step, k,
                                        every, collect_training_stats, sp)
            finally:
                harness._step_span = None
                if sp is not None:
                    sp.end()
        return self

    def _fit_window(self, batch_fn, num_steps, step, k, every,
                    collect_training_stats, sp) -> int:
        """One k-window of `_fit_grouped`: returns the step to continue
        from (the window's end, or the restored step after a guard's
        rollback, or the same window minus a condemned inner step). As
        in the JAX package, only a completed window ends a profiler
        step."""
        net = self.net
        guard = self.guard
        harness = self._harness
        program = harness.program
        pp = self.phase_profiler
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
            return step + span
        if pp is not None:
            pp.mark("h2d")
        xs, ys = self._stack_window(group)
        t1 = time.perf_counter()
        # guard at group granularity: one check per dispatch
        check_now = guard is not None and guard.check_every > 0
        snap = harness.pre_step_snapshot(check_now)
        if pp is not None:
            # the sampled wait on the replay's stream (device_compute) is
            # for the previous window's replay, taken just before this
            # window's is launched: this window's fetch and staging still
            # ran under it, as they do without the profiler
            pp.sync(program.last_step_losses)
            pp.mark("dispatch")
        program.run_group(xs, ys)
        harness.beat("fetch", step=step)
        if pp is not None:
            pp.mark("host_sync")
        if check_now:
            # analyze: allow=jit-host-sync — checked windows only: the guard's verdict
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
                    return step   # re-enter the window minus `bad`
                return restored["step"]
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
                return step + span if action == "skip" \
                    else restored["step"]
        if collect_training_stats:
            # analyze: allow=jit-host-sync — opt-in stats barrier
            float(net.score())   # host read: the group's barrier
        t2 = time.perf_counter()
        # group telemetry: steps_total counts the inner steps
        # actually trained; step_seconds stays in per-step units
        self._obs_acc.count_observe(
            "dl4j_train_steps_total", "dl4j_train_step_seconds",
            (t2 - t0) / max(1, len(abs_steps)), n=len(abs_steps))
        if sp is not None:
            sp.args["steps"] = len(abs_steps)
        for listener in net.listeners:
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
        if collect_training_stats:
            self._stats.append({
                "step": prev,
                "data_ms": (t1 - t0) * 1e3,
                "fit_ms": (t2 - t1) * 1e3,
                "listener_ms": 0.0,
                "checkpoint_ms": (time.perf_counter() - t2) * 1e3,
            })
        if pp is not None:
            pp.end_step()   # a completed window is one profiler step
        return step

    def _fit_local_sgd(self, batch_fn, num_steps, start_step,
                       collect_training_stats=False):
        """k-step local-SGD groups (the DCN-traffic role of the
        reference's gradient compression): LocalStepTrainer's program on
        this rank's [k, B, ...] partitions, one rendezvous per group. The
        guard checks once per rendezvous; with `guard_inner_steps` the
        group's rank-averaged inner-step losses condemn the ONE poisoned
        inner step, and the window replays without it."""
        from deeplearning4j_tpu_torch.parallel.wrapper import LocalStepTrainer
        from deeplearning4j_tpu_torch.resilience.errors import (
            NonFiniteLossError,
        )

        net = self.net
        guard = self.guard
        harness = self._harness
        k = self.averaging_frequency
        if self._local_step is None:
            self._local_step = LocalStepTrainer(
                net, self.mesh, threshold=self.threshold_compression,
                per_step_losses=self.guard_inner_steps,
                program=harness.program)
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
            check_now = guard is not None and guard.check_every > 0
            snap = (guard.snapshot(net)
                    if check_now and guard.policy == "skip_step" else None)
            if pp is not None:
                pp.mark("dispatch")
            self._local_step.run_arrays(xs, ys)
            harness.beat("fetch", step=step)
            if pp is not None:
                pp.mark("host_sync")
            if check_now and self.guard_inner_steps:
                # analyze: allow=jit-host-sync — checked windows only: the guard's verdict
                inner = self._local_step.last_step_losses.cpu().numpy()
                bad = [abs_steps[i] for i in range(len(abs_steps))
                       if not np.isfinite(inner[i])]
                if bad:
                    guard.counters["checks"] += 1
                    guard.counters["nonfinite"] += 1
                    _obs.count("dl4j_train_guard_checks_total")
                    _obs.count("dl4j_train_guard_nonfinite_total")
                    if guard.policy == "abort":
                        raise NonFiniteLossError(
                            f"non-finite loss at inner step(s) {bad} of "
                            f"group at step {step} (policy=abort)")
                    self._poisoned_steps.update(bad)
                    if guard.policy == "skip_step":
                        guard.restore(net, snap)
                        guard.note_skip()
                        logger.warning(
                            "guard: non-finite inner step(s) %s — window "
                            "replayed without them", bad)
                    else:   # rollback
                        guard.note_rollback()
                        if guard.counters["rollbacks"] > guard.max_rollbacks:
                            raise NonFiniteLossError(
                                "guard exceeded max_rollbacks="
                                f"{guard.max_rollbacks}")
                        step = self.load_latest_checkpoint()
                    continue   # re-enter the window minus `bad`
            if check_now:
                verdict = guard.post_step(net)
                if verdict != "ok":
                    if guard.policy == "skip_step":
                        guard.restore(net, snap)
                        guard.note_skip()
                        step += span
                        continue
                    if guard.policy == "rollback":
                        self._poisoned_steps.update(range(step, step + span))
                        guard.note_rollback()
                        if guard.counters["rollbacks"] > guard.max_rollbacks:
                            raise NonFiniteLossError(
                                "guard exceeded max_rollbacks="
                                f"{guard.max_rollbacks}")
                        step = self.load_latest_checkpoint()
                        continue
                    raise NonFiniteLossError(
                        f"{verdict} training state in group at step {step} "
                        "(policy=abort)")
            if collect_training_stats:
                # analyze: allow=jit-host-sync — opt-in stats barrier
                float(net.score())   # host read: the group's barrier
            t2 = time.perf_counter()
            self._obs_acc.count_observe(
                "dl4j_train_steps_total", "dl4j_train_step_seconds",
                (t2 - t0) / max(1, len(abs_steps)), n=len(abs_steps))
            if self.tracer is not None:
                self.tracer.record(
                    "train_group", t0, t2, cat="train",
                    args={"step": step, "steps": len(abs_steps)})
            prev = step
            step += span
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
        row, the `resilience` block (guard / watchdog / preemption /
        supervisor counters), the phase profiler's report (`phases`), an
        attached ProfilerListener's trace facts (`profiler`) and the
        `pipeline` facts, and `wire`: the local-SGD rendezvous' wire
        accounting (LocalStepTrainer.wire_stats; None without local
        SGD)."""
        stats = list(getattr(self, "_stats", []))
        wire = (self._local_step.wire_stats()
                if self._local_step is not None else None)
        out = {"steps": stats, "summary": {}, "wire": wire,
               "resilience": self.resilience_stats(),
               "profiler": self._profiler_stats(),
               "phases": (self.phase_profiler.report()
                          if self.phase_profiler is not None else None),
               "pipeline": self._harness.pipeline_stats()}
        if stats:
            out["summary"] = {
                k: float(np.mean([s[k] for s in stats]))
                for k in ("data_ms", "fit_ms", "listener_ms",
                          "checkpoint_ms")}
        return out

    def _profiler_stats(self):
        """An attached ProfilerListener's device-trace facts (its
        trace_dir, log_dir, whether a trace is open or done)."""
        for listener in self.net.listeners:
            if hasattr(listener, "trace_dir") \
                    and hasattr(listener, "log_dir"):
                return {"trace_dir": listener.trace_dir,
                        "log_dir": listener.log_dir,
                        "active": bool(getattr(listener, "_active",
                                               False)),
                        "done": bool(getattr(listener, "_done", False))}
        return None

    def resilience_stats(self):
        """Guard / watchdog / preemption / restart counters (None when
        no self-healing hook is attached and nothing was counted)."""
        return self._harness.resilience_stats()

    def export_stats_html(self, path: str):
        """Timeline HTML export (ref StatsUtils.exportStatsAsHtml): the
        recorded steps, the summary and the resilience block."""
        data = self.training_stats()
        rows = "".join(
            f"<tr><td>{s['step']}</td><td>{s['data_ms']:.2f}</td>"
            f"<td>{s['fit_ms']:.2f}</td>"
            f"<td>{s['checkpoint_ms']:.2f}</td></tr>"
            for s in data["steps"])
        resil = ("" if data.get("resilience") is None else
                 f"<p>resilience: {json.dumps(data['resilience'])}</p>")
        page = (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>training timeline</title></head><body>"
            f"<h1>TrainingMaster timeline</h1>"
            f"<p>summary: {json.dumps(data['summary'])}</p>"
            f"{resil}"
            "<table border='1'><tr><th>step</th><th>data ms</th>"
            "<th>fit ms</th><th>checkpoint ms</th></tr>"
            f"{rows}</table></body></html>")
        with open(path, "w") as f:
            f.write(page)
        return path

    # ------------------------------------------------------------ evaluate
    def evaluate(self, batch_fn: Callable[[int], Tuple], num_steps: int,
                 evaluation=None):
        """Classification counts over `num_steps` batches of
        `batch_fn(step) -> (x, y[, features_mask[, labels_mask]])` (THIS
        rank's dp partition): the argmax confusion counts are summed on
        the device, over the dp ranks (one all-reduce per batch, so every
        rank holds the global counts; the replicas of a dp coordinate
        count its rows once), and folded into `evaluation` (the
        port's eval.Evaluation) once per batch. Only
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
            if self.mesh.shape["dp"] > 1:
                # every rank ends with the GLOBAL counts of the partitions
                from deeplearning4j_tpu_torch.parallel import collectives

                counts = collectives.all_reduce_sum(counts,
                                                    self.mesh.group("dp"))
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

    def _payload(self, step: int):
        """The checkpoint's arrays (module docstring): the net's state
        read through views of its carry, copied to the host; under ZeRO-1
        the replicated updater leaves and the layout, with the sharded
        leaves' slices returned apart for the sidecar. Returns (payload,
        sidecar slices or None)."""
        net = self.net
        payload = {}
        for group, tree in (("params", net._params_view()),
                            ("states", net.states)):
            for i, leaf in enumerate(leaves(tree)):
                payload[f"{group}:{i}"] = _host(leaf)
        slices = None
        if self._mesh_mgr is not None:
            slices = self._sharded_upd_payload(payload)
        else:
            for i, leaf in enumerate(leaves(net._upd_view())):
                payload[f"upd:{i}"] = _host(leaf)
        payload["rng"] = np.zeros(2, np.uint32)
        gen = net._rng_state()
        if gen is not None:
            payload["torch_rng"] = _host(gen)
        payload["step"] = np.asarray(step)
        payload["iteration"] = np.asarray(int(net.iteration))
        payload["epoch"] = np.asarray(int(net.epoch))
        return payload, slices

    def _sharded_upd_payload(self, payload) -> dict:
        """The ZeRO-1 checkpoint layout: the updater state gathered whole
        over dp (`MeshManager.gather_tree`, timed as
        `dl4j_mesh_allgather_seconds`), replicated leaves into the
        quorum-voted main `payload` as `upd:<i>`, sharded leaves cut to
        the rows of THIS rank's dp coordinate for the sidecar; the main
        payload records `upd_sharded_idx` and `shard_world` (dp), so its
        digest covers the layout."""
        from deeplearning4j_tpu_torch.engine.sharding import slice_rows

        mgr = self._mesh_mgr
        full = leaves(mgr.gather_tree(self.net.updater_states))
        world, rank = mgr.dp, mgr.rank
        slices, sharded_idx = {}, []
        for i, (leaf, sharded) in enumerate(zip(full, mgr.layout)):
            if sharded and leaf.shape[0] % world == 0:
                sharded_idx.append(i)
                slices[f"slice:{i}"] = slice_rows(leaf, rank, world)
            else:
                payload[f"upd:{i}"] = leaf
        payload["upd_sharded_idx"] = np.asarray(sharded_idx, np.int64)
        payload["shard_world"] = np.asarray(world)
        return slices

    def _write_shard_sidecar(self, step, slices, state_sha):
        """This rank's optimizer-state slice sidecar (the slice of its dp
        coordinate, `shard_rank`, of `shard_world` = dp): atomic write and
        a manifest entry carrying `main_state_sha256`, the digest of the
        main state the slice belongs to (what the sharded quorum checks),
        and `processes`, the world that wrote the step (which rank
        directories hold which coordinate)."""
        side_fn = _ci.shard_sidecar_filename(step)
        side = os.path.join(self.checkpoint_dir, side_fn)
        world, rank = self._mesh_mgr.dp, self._mesh_mgr.rank
        procs = self.mesh.world

        def _write_side():
            with _ci.atomic_writer(side, suffix=".tmp.npz") as tmp:
                with open(tmp, "wb") as f:
                    np.savez(f, shard_rank=np.asarray(rank),
                             shard_world=np.asarray(world), **slices)
                digest = _ci.sha256_file(tmp)
                size = os.path.getsize(tmp)
            _ci.record_checksum(
                self.checkpoint_dir, side_fn, digest, size,
                extra={"step": step, "shard_rank": rank,
                       "shard_world": world, "processes": procs,
                       "main_state_sha256": state_sha})

        self._ckpt_retry.call(_write_side)

    def _save_checkpoint_impl(self, step: int):
        """Write the payload as one crash-safe .npz: tmp + fsync +
        os.replace with a sha256 manifest entry recorded from the
        pre-publish bytes, so a kill mid-write publishes nothing and a
        torn write is detected on load; transient OSErrors retry per
        `checkpoint_retry`; `keep_last` prunes old steps. Rank 0 writes,
        or every rank into its own directory with `per_rank_checkpoints`
        (whose recorded state digest leaves out `torch_rng`, each rank's
        own dropout stream, so replicated copies vote equal); a ZeRO-1
        save gathers on every rank and writes the rank's slice sidecar
        first (a published main step implies its slice exists)."""
        if self.mesh.rank != 0 and not self.per_rank_checkpoints:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        net = self.net
        payload, slices = self._payload(step)
        final = self._ckpt_path(step)
        fn = os.path.basename(final)
        voted = payload
        if self.per_rank_checkpoints:
            voted = {k: v for k, v in payload.items() if k != "torch_rng"}
        state_sha = _ci.state_digest_of(voted)

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

        if slices is not None:
            self._write_shard_sidecar(step, slices, state_sha)
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

    def _restore_sharded_upd(self, data, step: int, like) -> list:
        """The FULL updater-state leaves of a ZeRO-1 checkpoint: the
        replicated leaves from the main payload, the sharded ones
        reassembled by dp coordinate from the save-time slice sidecars
        (one rank directory per coordinate, `_ci.shard_slice_dirs`;
        validated, and tied to the main state's recorded digest). A
        save-time dp other than the live one is a reshard
        (`dl4j_mesh_reshard_total`; the ZeRO-1 staging re-slices for the
        live dp)."""
        from deeplearning4j_tpu_torch.engine.sharding import assemble_rows

        world = int(data["shard_world"])
        sharded_idx = [int(i) for i in
                       np.asarray(data["upd_sharded_idx"]).reshape(-1)]
        n = len(leaves(like))
        new = [None if i in sharded_idx else np.array(data[f"upd:{i}"])
               for i in range(n)]
        if sharded_idx:
            fn = os.path.basename(self._ckpt_path(step))
            expect = _ci.state_digest(self.checkpoint_dir, fn)
            if self.per_rank_checkpoints or world > 1:
                dirs = _ci.shard_slice_dirs(self._ckpt_base, step, world)
            else:
                dirs = [self.checkpoint_dir]
            slices = _ci.collect_sharded_slices(dirs, step,
                                                expect_digest=expect)
            if slices is None:
                raise CheckpointIntegrityError(
                    f"sharded checkpoint step {step}: optimizer-state "
                    f"slice set incomplete or untrusted across "
                    f"{len(dirs)} rank dir(s)")
            opened = {r: np.load(p) for r, p in slices.items()}
            try:
                for i in sharded_idx:
                    new[i] = assemble_rows(
                        {r: d[f"slice:{i}"] for r, d in opened.items()},
                        world)
            finally:
                for d in opened.values():
                    d.close()
        cur_dp = int(self.mesh.shape["dp"])
        if world != cur_dp:
            if self._mesh_mgr is not None:
                self._mesh_mgr.reshards += 1
            _obs.count("dl4j_mesh_reshard_total")
            logger.warning(
                "sharded checkpoint step %d: resharding optimizer state "
                "from save-time dp %d to live dp %d", step, world, cur_dp)
        return new

    def _restore_npz(self, step: int, meta) -> int:
        """Rebind the net's params, updater state and BN states (and the
        dropout generator, for a port checkpoint) to checkpoint `step`,
        in the net's device and dtypes; under ZeRO-1 the updater state is
        assembled whole (from the sidecars of a sharded save) and cut to
        this rank's rows for the live world. The net's next step ravels
        its flat carry from them again; a captured group copies the carry
        into its static buffers per replay, so nothing is recaptured."""
        t_restore = time.perf_counter()
        net = self.net
        self._stage_net()
        mgr = self._mesh_mgr
        with self._ckpt_retry.call(np.load, self._ckpt_path(step)) as data:
            def check(group, i, a, shape):
                if tuple(a.shape) != tuple(shape):
                    raise CheckpointIntegrityError(
                        f"checkpoint step {step}: {group}:{i} has shape "
                        f"{a.shape}, the net needs {tuple(shape)}")

            def restore(group, like, arrays=None):
                old = leaves(like)
                new = []
                for i, t in enumerate(old):
                    a = (np.array(data[f"{group}:{i}"]) if arrays is None
                         else arrays[i])
                    check(group, i, a, t.shape)
                    new.append(torch.from_numpy(np.array(a)).to(
                        device=t.device, dtype=t.dtype))
                return unflatten(like, new)[0]

            params = restore("params", net._params_view())
            states = restore("states", net.states)
            like = net._upd_view()
            full = None
            if "shard_world" in data.files:
                full = self._restore_sharded_upd(data, step, like)
            if mgr is not None:
                # the whole state, checked against the full leaf shapes,
                # re-sliced for the live world
                local = leaves(like)
                arrays = full if full is not None else [
                    np.array(data[f"upd:{i}"]) for i in range(len(local))]
                for i, (a, t, sh) in enumerate(zip(arrays, local,
                                                   mgr.layout)):
                    check("upd", i, a, ((t.shape[0] * mgr.dp,)
                                        + tuple(t.shape[1:])) if sh
                          else t.shape)
                upd = mgr.shard_tree(unflatten(like, [
                    torch.from_numpy(np.array(a)).to(dtype=t.dtype)
                    for a, t in zip(arrays, local)])[0],
                    device=net.device)
            else:
                upd = restore("upd", like, full)
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
