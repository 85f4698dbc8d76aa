"""ParallelWrapper: DL4J's in-process data-parallel trainer (counterpart
of deeplearning4j_tpu/parallel/wrapper.py; parity:
deeplearning4j-scaleout-parallelwrapper/.../ParallelWrapper.java, fit
loop :211-260, parameter averaging :320, updater-state averaging
:332-365), one process per rank and one device per process.

    pw = ParallelWrapper(net)                          # dp = world size
    pw = ParallelWrapper(net, steps_per_dispatch=4)    # k-step windows
    pw = ParallelWrapper(net, averaging_frequency=4)   # local SGD
    pw = ParallelWrapper(net, sharding="zero1")        # ZeRO-1
    pw = ParallelWrapper(net, tp=2)                    # dp = world/2, tp 2
    pw.fit(iterator_or_list, epochs=2)

Every rank runs the same fit over the same global batches (SPMD): each
batch is padded to a multiple of dp (padded rows masked out of the loss)
and each rank trains on the contiguous rows of its dp coordinate
(parallel/sharding.py). The mesh spans the live process group
(parallel/mesh.py): `workers` x `tp` ranks (default workers = world //
tp), or the `mesh` given; one process is dp 1. The ranks of the other
axes (sp, pp, ep) replicate the work of their dp coordinate.

- averaging_frequency == 1: one step per batch, the gradient averaged
  over the ranks every step (per-step dp, the reference's
  SHARED_GRADIENTS), with BatchNorm statistics and the loss's row count
  over the global batch; `steps_per_dispatch=k` groups batches into
  k-windows, each one `StepProgram.run_group` (on CUDA one replay of a
  captured graph of k steps, the collectives inside; a shape break — a
  ragged last batch — dispatches the window so far, and a window whose
  batches differ in carrying a label mask gets all-ones masks).
- averaging_frequency == k > 1: `LocalStepTrainer` — k local steps per
  rank on its own rows, then params, BN states and (`average_updaters`)
  updater states averaged; `threshold_compression=t` sends the k-step
  delta threshold-encoded with a per-rank residual.
- sharding="zero1": the ZeRO-1 step (engine/sharding.py) through
  `StepProgram.attach_mesh`.
- tp > 1: tensor parallelism (parallel/tensor_parallel.py). While fit
  runs each rank holds only its `_tp_spec` slices of the params and the
  updater state (the flat carry off); Dense and Output layers compute
  column-parallel, every other sharded leaf is gathered on use, and the
  per-step gradient all-reduce runs over the dp group. When fit returns
  the params and updater state are whole on every rank again, so
  `output`, `evaluate`, `save` and checkpoints work as before. ZeRO-1,
  local SGD and the stale trainer refuse tp > 1, as the JAX package's
  do.

A NonFiniteGuard skips a poisoned batch (`skip_step`) or rewinds to an
in-memory snapshot refreshed every `snapshot_every` steps (`rollback`).
Dropout masks come from each rank's own generator, decorrelated by rank
(`decorrelate_dropout`): they cannot equal a JAX global-key draw.
`StaleGradientTrainer` applies each step the previous step's averaged
gradient (1-step staleness).

The net keeps its train carry as it is under per-step dp and local SGD
(the flat carry of updater/flat_chain.py where it has one: one flat
gradient bucket per all-reduce); ZeRO-1 and tp work on the per-layer
trees.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.engine import StepHarness, stack_staged
from deeplearning4j_tpu_torch.nn.graph import _as_multi
from deeplearning4j_tpu_torch.nn.multilayer import _as_batch
from deeplearning4j_tpu_torch.nn.updater import apply_score_decay
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh
from deeplearning4j_tpu_torch.parallel.sharding import (
    pad_batch_with_masks,
    shard_batch,
)
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


def _require_local_sgd(averaging_frequency: int, threshold: float):
    """Threshold compression only exists at the local-SGD rendezvous."""
    if threshold > 0.0 and max(1, averaging_frequency) <= 1:
        raise ValueError(
            "threshold_compression requires averaging_frequency > 1 "
            "(it encodes the k-step delta at the local-SGD rendezvous; "
            "the per-step all-reduce path has no host-visible exchange "
            "to encode)")


def resolve_mesh(mesh=None, workers: Optional[int] = None,
                 tp: int = 1) -> Mesh:
    """The Mesh a trainer runs on: `mesh` as given (a Mesh or a
    MeshSpec), else `make_mesh(dp=workers, tp=tp)`, workers defaulting to
    world // tp (the JAX package's `n // tp`)."""
    if isinstance(mesh, MeshSpec):
        return make_mesh(mesh)
    if mesh is None:
        if tp == 1:
            return make_mesh(dp=-1 if workers is None else int(workers))
        if workers is None:
            workers = max(1, collectives.world_size() // tp)
        return make_mesh(dp=int(workers), tp=tp)
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a parallel.mesh.Mesh (make_mesh) or "
                        f"a MeshSpec, got {type(mesh).__name__}")
    return mesh


def decorrelate_dropout(net, rank: int) -> None:
    """Reseed a rank > 0's dropout generator with its rank folded into the
    configuration's seed, so ranks draw different masks (rank 0 keeps the
    one-process stream)."""
    from deeplearning4j_tpu_torch.nn.base_network import _rng_seed

    if rank <= 0 or not net._has_dropout():
        return
    gen = net._train_rng()
    gen.manual_seed((_rng_seed(net.conf.seed) + 0x9E3779B1 * rank)
                    % (1 << 63))


def attach_dp(net, mesh: Mesh) -> None:
    """Per-step dp on `net` when the mesh's dp axis spans more than one
    rank: its `_step` averages gradients over the dp group and its
    BatchNorm statistics and loss row count become global over it.
    Dropout streams differ by dp coordinate only: the ranks of the other
    axes replicate their coordinate's work."""
    net._dp = mesh.group("dp") if mesh.shape["dp"] > 1 else None
    decorrelate_dropout(net, mesh.coords.get("dp", mesh.rank))


def _require_tp1(mesh, message: str) -> None:
    if mesh.shape.get("tp", 1) != 1:
        raise NotImplementedError(message)


def _mean_trees(trees, extra_sum=None, group=None):
    """The float leaves of `trees` averaged over the ranks of the dp
    `group` (None: the live dp axis) in one all-reduce per dtype, and
    `extra_sum` (a scalar tensor, summed, not averaged) riding in the
    first buffer. Returns (trees, summed extra)."""
    w = (group or collectives.dp_group()).world
    ls = [t for tree in trees for t in leaves(tree)]
    out = list(ls)
    by_dt = {}
    for i, t in enumerate(ls):
        if t.is_floating_point():
            by_dt.setdefault(t.dtype, []).append(i)
    summed = None
    for dt, idx in by_dt.items():
        n = sum(ls[i].numel() for i in idx)
        tail = extra_sum is not None and summed is None
        buf = collectives.all_reduce_sum(torch.cat(
            [ls[i].reshape(-1) for i in idx]
            + ([extra_sum.reshape(-1).to(dt)] if tail else [])), group)
        if w > 1:
            buf[:n].div_(w)
        for i, p in zip(idx, torch.split(buf[:n],
                                         [ls[i].numel() for i in idx])):
            out[i] = p.view(ls[i].shape)
        if tail:
            summed = buf[n:].reshape(extra_sum.shape).to(extra_sum.dtype)
    res, pos = [], 0
    for tree in trees:
        tree_out, pos = unflatten(tree, out, pos)
        res.append(tree_out)
    return res, summed


class ParallelWrapper:
    """Data-parallel trainer around a MultiLayerNetwork/ComputationGraph
    (module docstring)."""

    tp_memory = None   # the last tp fit's memory_facts (tensor_parallel)

    def __init__(self, net, workers: Optional[int] = None, tp: int = 1,
                 averaging_frequency: int = 1, average_updaters: bool = True,
                 mesh=None, prefetch_buffer: int = 2,
                 threshold_compression: float = 0.0,
                 guard=None, watchdog=None, snapshot_every: int = 0,
                 phase_profiler=None,
                 steps_per_dispatch: int = 1,
                 pipeline: Optional[bool] = None,
                 sharding: Optional[str] = None):
        """The JAX package's options. `guard`/`watchdog` give fit() the
        harness's self-healing hooks: the NonFiniteGuard checks loss and
        params after (sampled) steps and skips or aborts on non-finite
        state; `rollback` needs `snapshot_every=N` (an in-memory snapshot
        of the pre-step state refreshed every N guarded steps)."""
        self.net = net
        self.threshold_compression = float(threshold_compression)
        _require_local_sgd(averaging_frequency, self.threshold_compression)
        if max(1, averaging_frequency) > 1 and steps_per_dispatch > 1:
            raise ValueError(
                "steps_per_dispatch > 1 and averaging_frequency > 1 "
                "are mutually exclusive groupings")
        if sharding not in (None, "replicated", "zero1"):
            raise ValueError(
                f"sharding must be None|'replicated'|'zero1': {sharding}")
        zero1_tp = ("sharding='zero1' requires tp == 1 (the ZeRO update "
                    "shards the dp axis of replicated params)")
        if sharding == "zero1" and tp != 1:
            raise NotImplementedError(zero1_tp)
        self.mesh = resolve_mesh(mesh, workers, tp)
        self.dp = self.mesh.shape["dp"]
        self._tp = None
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
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.average_updaters = average_updaters
        self.prefetch_buffer = prefetch_buffer
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.pipeline = pipeline
        self._multi_io = False
        self._local_step = None
        self._harness = StepHarness(
            net, guard=guard, watchdog=watchdog,
            snapshotter=self._snapshotter, phase_profiler=phase_profiler)
        self.guard = self._harness.guard
        self.watchdog = self._harness.watchdog
        self.phase_profiler = self._harness.phase_profiler
        self.zero1 = sharding == "zero1"
        self._mesh_mgr = None
        if self.zero1:
            _require_tp1(self.mesh, zero1_tp)
            if self.averaging_frequency > 1:
                raise ValueError(
                    "sharding='zero1' and averaging_frequency > 1 are "
                    "incompatible (local SGD keeps per-shard params)")
            from deeplearning4j_tpu_torch.engine.mesh import MeshManager

            self._mesh_mgr = MeshManager(mesh=self.mesh)
            self._harness.program.attach_mesh(self._mesh_mgr)
            decorrelate_dropout(net, self.mesh.coords["dp"])
        elif self.averaging_frequency == 1:
            attach_dp(net, self.mesh)
        else:
            decorrelate_dropout(net, self.mesh.coords["dp"])

    def _ensure_ready(self):
        ins = getattr(self.net.conf, "network_inputs", None)
        outs = getattr(self.net.conf, "network_outputs", None)
        self._multi_io = ins is not None and (len(ins) > 1 or len(outs) > 1)
        if self._multi_io and self.averaging_frequency > 1:
            raise NotImplementedError(
                "averaging_frequency > 1 supports single-input/single-"
                "output graphs only")
        if not self.net._initialized():
            self.net.init()

    def _attach_tp(self):
        """tp > 1: this rank's slices of the params and updater state for
        the fit (parallel/tensor_parallel.py); None otherwise."""
        if self.mesh.shape.get("tp", 1) == 1:
            return None
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            TensorParallel,
        )

        if self._tp is None:
            self._tp = TensorParallel(self.net, self.mesh)
        return self._tp.attach()

    def _run_guarded(self, thunk) -> bool:
        """Run one training step/window under the shared harness's
        guard dispatch (engine.StepHarness.guarded); False means the
        step was rejected and the pre-step (skip_step) or newest-
        snapshot (rollback) state restored (callers skip listeners for
        rejected steps)."""
        return self._harness.guarded(thunk, context="detected")

    def _pipeline_enabled(self) -> bool:
        return True if self.pipeline is None else bool(self.pipeline)

    def _padded(self, batch):
        """The global (x, y, fm, lm) padded to a dp multiple, the padded
        rows masked out of the loss."""
        x, y, fm, lm = _as_batch(batch)
        host = lambda a: None if a is None else (
            a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))
        return pad_batch_with_masks(self.dp, host(x), host(y), host(fm),
                                    host(lm))

    def _local_rows(self, batch):
        """This rank's (x, y, fm, lm): the padded global batch cut to the
        rank's contiguous rows. dp 1 passes the batch through."""
        if self.dp == 1:
            return batch
        return tuple(shard_batch(self.mesh, self._padded(batch)))

    # ------------------------------------------------------------------
    def fit(self, data, epochs: int = 1):
        """Train. `data` is any iterator/list of global batches the
        wrapped net accepts (ref fit loop: ParallelWrapper.java:211-260),
        `epochs` passes over it (an iterator with `reset()` is reset per
        pass). The session closes the data source (an
        AsyncDataSetIterator's producer is joined) however the fit
        ends."""
        self._ensure_ready()
        net = self.net
        k = self.averaging_frequency
        if k > 1 and self._local_step is None:
            _require_tp1(self.mesh,
                         "averaging_frequency > 1 requires tp == 1 "
                         "(local-SGD shards carry full param replicas)")
            self._local_step = LocalStepTrainer(
                net, self.mesh, average_updaters=self.average_updaters,
                threshold=self.threshold_compression,
                program=self._harness.program)
        batches = data if hasattr(data, "__iter__") else [data]
        pre_staged = False
        # each rank trains on its rows of every padded global batch; local
        # SGD pads here and equalizes and cuts the whole group (run)
        stage = (None if self.dp == 1 or self._multi_io
                 else self._padded if k > 1 else self._local_rows)
        if self._pipeline_enabled():
            # multi-input graphs and local SGD take their batches on the
            # host (the async ETL overlap only)
            host_only = self._multi_io or k > 1
            batches = self._harness.build_iterator_pipeline(
                batches, depth=self.prefetch_buffer, stage=stage,
                host_only=host_only,
                meta={"workers": self.dp, "mesh": dict(self.mesh.shape)})
            pre_staged = not host_only
            stage = None
        else:
            self._harness.attach_data(batches)
        tp = self._attach_tp()
        try:
            with self._harness.session():
                self._fit_loop(batches, epochs, pre_staged, stage)
        finally:
            if tp is not None:
                self.tp_memory = tp.memory_facts()
                tp.detach()
        return self

    def _listeners_done(self):
        net = self.net
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)

    def _fit_loop(self, batches, epochs, pre_staged=False, stage=None):
        net = self.net
        k = self.averaging_frequency
        k2 = self.steps_per_dispatch
        program = self._harness.program
        program.require_sgd("ParallelWrapper")
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            group = []      # local-SGD rendezvous window (host)
            window = []     # run_group k-window (staged or host)
            for batch in batches:
                self._harness.beat("batch")
                if self._multi_io:
                    if self._run_guarded(
                            lambda b=batch: self._fit_multi_io(b)):
                        self._listeners_done()
                    continue
                if stage is not None:
                    batch = stage(batch)
                if k > 1:
                    group.append(_as_batch(batch))
                    if len(group) == k:
                        g, group = group, []
                        self._run_guarded(
                            lambda g=g: self._local_step.run(g))
                    continue
                entry = tuple(self._as_tensors(_as_batch(batch),
                                               pre_staged))
                if k2 > 1:
                    if window and not _window_compatible(window[-1], entry):
                        # shape break: dispatch the shorter window
                        self._run_window(window)
                        window = []
                    window.append(entry)
                    if len(window) == k2:
                        self._run_window(window)
                        window = []
                    continue
                if self._run_guarded(lambda e=entry: program.run(*e)):
                    self._listeners_done()
            if group:
                # trailing group smaller than k: a shorter local-step run
                g = group
                self._run_guarded(lambda: self._local_step.run(g))
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
        mask cut to this rank's rows (the batch must divide by dp: ragged
        padding is automated on the single-io path only) and converted
        onto the net's device, one train step."""
        net = self.net
        ins, labs, fms, lms = _as_multi(batch)
        if self.dp > 1:
            b = int(np.shape(ins[0])[0])
            if b % self.dp:
                raise ValueError(
                    f"multi-input batch size {b} must be divisible by "
                    f"dp={self.dp} (pad the batch or mask rows yourself)")
            cut = lambda xs: None if xs is None else [
                None if a is None else shard_batch(self.mesh, a) for a in xs]
            ins, labs, fms, lms = cut(ins), cut(labs), cut(fms), cut(lms)
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


def _check_trainable(net, what: str):
    if getattr(net.conf, "backprop_type", None) == "truncated_bptt":
        raise NotImplementedError(
            f"{what} does not support truncated BPTT (the local-step "
            "program carries no RNN state)")


class LocalStepTrainer:
    """`averagingFrequency=k` local SGD (the reference's AVERAGING mode,
    ParallelWrapper.java:320, averageUpdatersState :332-365): each rank
    carries its own params for k local steps on its own rows (no gradient
    exchange), then params, BN states and (with `average_updaters`)
    updater states are averaged over the ranks in one all-reduce. The
    program is built through `StepProgram.trainer_program` (the engine
    owns it, as in the JAX package); it runs the k steps eagerly, then
    the rendezvous.

    `threshold > 0` threshold-encodes the k-step parameter delta at each
    rendezvous (EncodingHandler.java:57-73): each rank sends
    sign(delta+residual)*threshold only where |delta+residual| >=
    threshold and keeps the remainder in a per-rank residual, so
    successive rendezvous eventually deliver everything; `wire_stats()`
    reports the bytes on the wire against a dense exchange. The residual
    is in-memory state, lost on a restart like the reference's.
    `per_step_losses=True` also keeps the k rank-averaged inner-step
    losses in `last_step_losses` (a guard localizes a poisoned inner
    step). Constraints: tp == 1, no truncated BPTT."""

    def __init__(self, net, mesh, average_updaters: bool = True,
                 threshold: float = 0.0, per_step_losses: bool = False,
                 program=None):
        from deeplearning4j_tpu_torch.engine import StepProgram

        mesh = resolve_mesh(mesh)
        _require_tp1(mesh, "averaging_frequency > 1 requires tp == 1 "
                     "(local-SGD shards carry full param replicas)")
        _check_trainable(net, "averaging_frequency > 1")
        self.net = net
        self.mesh = mesh
        self.average_updaters = average_updaters
        self.threshold = float(threshold)
        self.per_step_losses = bool(per_step_losses)
        self.last_step_losses = None
        self._program = program or StepProgram(net)
        self._residual = None
        self._sent_nnz = []          # per-rendezvous device scalars
        self._param_entries = None
        self._n_rendezvous = 0
        decorrelate_dropout(net, mesh.coords["dp"])

    # -------------------------------------------------------------- build
    def _build(self, k: int, with_fm: bool, with_lm: bool,
               trace_key: str = "local_sgd"):
        """The k-step local-SGD program on the net's state: k `_step`s on
        this rank's [k, rows, ...] data with no dp group attached, then
        the rendezvous. Returns (mean loss, [k] rank-averaged losses,
        sent spikes summed over ranks)."""
        net = self.net
        thr = self.threshold
        avg_upd = self.average_updaters
        group = self.mesh.group("dp")
        recorded = []

        def program(xs, ys, fms, lms):
            if not recorded:
                net._jit_cache.record_trace(trace_key)
                recorded.append(True)
            dp, net._dp = net._dp, None
            try:
                carry = net._train_carry()
                scalars = net._step_scalars(net.iteration, k)
                params0 = carry[0]
                losses = []
                for i in range(k):
                    at = lambda ts: tree_map(lambda t: t[i], ts)
                    carry, loss, _ = net._step(
                        carry, at(xs), at(ys), at(lms), scalars[i],
                        at(fms))
                    losses.append(loss)
            finally:
                net._dp = dp
            params, upd, states = carry
            losses = torch.stack(losses)
            with torch.no_grad():
                nnz = None
                if thr > 0.0:
                    if self._residual is None:
                        self._residual = tree_map(torch.zeros_like, params0)
                    p0, p1 = leaves(params0), leaves(params)
                    res = leaves(self._residual)
                    sends, new_res = [], []
                    nnz = torch.zeros((), dtype=torch.float32,
                                      device=losses.device)
                    for a0, a1, r in zip(p0, p1, res):
                        acc = (a1 - a0) + r
                        send = torch.where(acc.abs() >= thr,
                                           torch.sign(acc) * thr,
                                           torch.zeros_like(acc))
                        sends.append(send)
                        new_res.append(acc - send)
                        nnz = nnz + torch.count_nonzero(send).to(nnz.dtype)
                    self._residual = unflatten(self._residual, new_res)[0]
                    sent_tree = unflatten(params0, sends)[0]
                    (avg, states, upd_m, lsum), nnz = _mean_trees(
                        [sent_tree, states, upd if avg_upd else None,
                         losses], extra_sum=nnz, group=group)
                    params = unflatten(params0, [
                        a0 + a for a0, a in zip(p0, leaves(avg))])[0]
                else:
                    (params, states, upd_m, lsum), _ = _mean_trees(
                        [params, states, upd if avg_upd else None, losses],
                        group=group)
                if avg_upd:
                    upd = upd_m
            net._set_train_carry((params, upd, states))
            return lsum.mean(), lsum, nnz

        return program

    def wire_stats(self):
        """Bytes-on-wire accounting for the rendezvous exchanges
        (WiredEncodingHandler.java:40-57): dense = full param all-reduce
        per rendezvous; compressed = 4 bytes per threshold spike. The
        updater-state and BN-state averages stay dense in both modes and
        are counted in both totals."""
        n = self._n_rendezvous
        if self._param_entries is None or self.threshold <= 0.0 or not n:
            return {"threshold": self.threshold, "rendezvous": n,
                    "bytes_dense": None, "bytes_compressed": None,
                    "compression_ratio": None}
        net = self.net
        aux_entries = sum(int(t.numel()) for t in leaves(net.states))
        if self.average_updaters:
            aux_entries += sum(int(t.numel())
                               for t in leaves(net._upd_view()))
        dp = self.mesh.shape["dp"]
        sent = float(sum(float(v) for v in self._sent_nnz))
        dense_params = float(self._param_entries) * 4.0 * n * dp
        aux = float(aux_entries) * 4.0 * n * dp
        comp = sent * 4.0 + aux
        dense = dense_params + aux
        return {"threshold": self.threshold, "rendezvous": n,
                "bytes_dense": dense, "bytes_compressed": comp,
                "compression_ratio": comp / dense if dense else None}

    # ---------------------------------------------------------------- run
    def run(self, group):
        """One k-step group on a list of GLOBAL host batches (x, y, fm, lm),
        each padded to a dp multiple: batch sizes equalized with fully
        masked pad rows at the end of each global batch, masks
        synthesized where some batches carry one (as the JAX package
        stacks the group), then every rank takes its rows of each."""
        net = self.net
        host = lambda a: None if a is None else (
            a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))
        group = [tuple(host(a) for a in g) for g in group]
        bmax = max(g[0].shape[0] for g in group)
        any_fm = any(g[2] is not None for g in group)
        any_lm = any(g[3] is not None for g in group)
        ones_lm = lambda x, y: np.ones(
            (x.shape[0],) if y.ndim == 2 else (x.shape[0], y.shape[1]),
            np.float32)
        xs, ys, fms, lms = [], [], [], []
        for x, y, fm, lm in group:
            if any_lm and lm is None:
                lm = ones_lm(x, y)
            if any_fm and fm is None:
                fm = np.ones((x.shape[0],) + (() if x.ndim == 2
                                              else (x.shape[1],)),
                             np.float32)
            n = bmax - x.shape[0]
            if n:
                pad = lambda a: np.concatenate(
                    [a, np.zeros((n,) + a.shape[1:], a.dtype)], 0)
                x, y = pad(x), pad(y)
                if lm is None:
                    lm = ones_lm(x, y)
                    lm[-n:] = 0.0
                else:
                    lm = pad(lm)
                if fm is not None:
                    fm = pad(fm)
            xs.append(x)
            ys.append(y)
            fms.append(fm)
            lms.append(lm)
        if any(m is not None for m in lms):
            lms = [ones_lm(x, y) if lm is None else lm
                   for x, y, lm in zip(xs, ys, lms)]
        rows = lambda a: shard_batch(self.mesh, a)
        dev = lambda a: torch.as_tensor(np.stack([rows(b) for b in a])).to(
            device=net.device, dtype=net.dtype)
        return self.run_arrays(
            dev(xs), dev(ys), dev(fms) if any_fm else None,
            dev(lms) if any(m is not None for m in lms) else None)

    def run_arrays(self, xs_in, ys_in, fms_in=None, lms_in=None, k=None):
        """One k-step local-SGD group on this rank's device arrays with a
        leading [k, ...] step dim (a graph's single input as the tensor
        itself)."""
        net = self.net
        if not net._initialized():
            net.init()
        k = int(xs_in.shape[0]) if k is None else k
        with_fm, with_lm = fms_in is not None, lms_in is not None
        fn = self._program.trainer_program(
            "engine_local_sgd",
            lambda tk: self._build(k, with_fm, with_lm, tk),
            k, with_fm, with_lm, self.per_step_losses,
            self.threshold > 0.0)
        if self._param_entries is None:
            self._param_entries = sum(int(t.numel())
                                      for t in leaves(net._params_view()))
        inputs, labels, lmasks, fmasks = self._program._tensors(
            xs_in, ys_in, fms_in, lms_in)
        loss, step_losses, nnz = fn(inputs, labels, fmasks, lmasks)
        if self.per_step_losses:
            self.last_step_losses = step_losses
        if self.threshold > 0.0:
            # device scalars, summed only when wire_stats() is read
            self._sent_nnz.append(nnz)
            self._n_rendezvous += 1
        net.iteration += k
        net._score = loss
        apply_score_decay(net, loss)
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)
        return loss


class StaleGradientTrainer:
    """Bounded 1-step staleness (the dynamics of SharedTrainingMaster.java:72
    / SharedTrainingWrapper.java:196-240, whose workers train on late
    gradients): step t computes this batch's rank-averaged gradient g_t
    but APPLIES g_{t-1}, so g_t's all-reduce can overlap the next step's
    compute. BN states are averaged every step; `flush()` applies the
    last pending gradient (fit() calls it), and the first step applies
    nothing (a zero gradient). The updater state advances with the
    delayed gradient stream. Gradients are clipped per rank before the
    average, as the JAX package's shard_map does. Constraints: tp == 1,
    no truncated BPTT."""

    def __init__(self, net, mesh, program=None):
        from deeplearning4j_tpu_torch.engine import StepProgram

        mesh = resolve_mesh(mesh)
        _require_tp1(mesh, "StaleGradientTrainer requires tp == 1")
        _check_trainable(net, "StaleGradientTrainer")
        self.net = net
        self.mesh = mesh
        self._program = program or StepProgram(net)
        self._pending = None     # g_{t-1}, rank-averaged
        decorrelate_dropout(net, mesh.coords["dp"])

    def _build(self, flush: bool, trace_key: str = "stale_grad"):
        from deeplearning4j_tpu_torch.nn.base_network import clip_grads

        net = self.net
        recorded = []

        def program(inputs, labels, fmasks, lmasks):
            if not recorded:
                net._jit_cache.record_trace(trace_key)
                recorded.append(True)
            params, upd, states = net._train_carry()
            sc = net._step_scalars(net.iteration)[0]
            if flush:
                with torch.no_grad():
                    params, upd = net._apply_updates(
                        params, upd, self._pending, sc[0], sc[1])
                net._set_train_carry((params, upd, states))
                return None
            grads, loss, new_states, _ = net._grads(
                params, states, inputs, labels, lmasks, fmasks)
            with torch.no_grad():
                grads = clip_grads(net.conf, grads)
                (g_avg, new_states, lv), _ = _mean_trees(
                    [grads, new_states, loss.reshape(1)],
                    group=self.mesh.group("dp"))
                params, upd = net._apply_updates(
                    params, upd, self._pending, sc[0], sc[1])
            net._set_train_carry((params, upd, new_states))
            self._pending = g_avg
            return lv[0]

        return program

    def step(self, x, y, fm=None, lm=None):
        """One step on THIS rank's rows (tensors or arrays)."""
        net = self.net
        if not net._initialized():
            net.init()
        if self._pending is None:
            self._pending = tree_map(torch.zeros_like, net._train_carry()[0])
        with_fm, with_lm = fm is not None, lm is not None
        fn = self._program.trainer_program(
            "engine_stale", lambda tk: self._build(False, tk),
            with_fm, with_lm)
        inputs, labels, lmasks, fmasks = self._program._tensors(
            net._as_input(x), net._as_input(y),
            None if fm is None else net._as_input(fm),
            None if lm is None else net._as_input(lm))
        loss = fn(inputs, labels, fmasks, lmasks)
        net.iteration += 1
        net._score = loss
        apply_score_decay(net, loss)
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)
        return loss

    def flush(self):
        """Apply the final pending gradient (call at end of fit)."""
        if self._pending is None:
            return
        fn = self._program.trainer_program(
            "engine_stale_flush", lambda tk: self._build(True, tk))
        fn(None, None, None, None)
        self._pending = None

    def fit(self, batches):
        """Train over an iterable of GLOBAL batches in any _as_batch shape,
        flushing the last pending gradient at the end. Leading dims are
        padded to a dp multiple with loss-masked rows; each rank trains
        on its rows."""
        dp = self.mesh.shape["dp"]
        for batch in batches:
            x, y, fm, lm = _as_batch(batch)
            x, y, fm, lm = pad_batch_with_masks(
                dp, np.asarray(x), np.asarray(y), fm, lm)
            self.step(*shard_batch(self.mesh, (x, y, fm, lm)))
        self.flush()
        return self


__all__ = ["LocalStepTrainer", "ParallelWrapper", "StaleGradientTrainer",
           "attach_dp", "decorrelate_dropout", "resolve_mesh"]
