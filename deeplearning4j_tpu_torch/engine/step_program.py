"""StepProgram: the ONE train step every fit loop runs on (counterpart of
deeplearning4j_tpu/engine/step_program.py).

A StepProgram wraps a network (ComputationGraph or MultiLayerNetwork:
both carry nn/base_network.py's train-step contract) and owns:

  - `make_loss_and_apply(net)`: the two halves of the step math (the
    loss under the mixed-precision policy, and the update), which the
    net's `_step` composes with `torch.autograd.grad` and `clip_grads` —
    one source of step math for every grouping;
  - `run(x, y)`: one training step in the canonical (x, y, fm, lm) batch
    shape, adapted to a graph's named inputs where the net is a graph
    (the net's own `_fit_one`: one `_train_step`, or for a truncated-BPTT
    net on a 3-D batch its chunks, each a step);
  - `run_batch(batch)`: one step with full `fit_batch` semantics (the
    EarlyStoppingTrainer entry);
  - `run_group(xs, ys)`: k steps on stacked [k, ...] data in one
    dispatch (not for a truncated-BPTT net: it raises, as the JAX
    package's does). On the CPU the group body (k calls of the net's
    `_step`) runs directly. On CUDA the same body is captured once into a
    `torch.cuda.CUDAGraph` per group key and replayed: the counterpart of
    the JAX package's `lax.scan` group under one `jax.jit`. A window of
    fewer steps than a group already captured for the same key runs as
    eager steps (bit for bit the same) instead of capturing again. The state
    advances exactly as k `run()` calls would — bit for bit, since both
    run the same kernels on the same values — and `last_step_losses`
    holds the [k] per-step losses, so a NonFiniteGuard can condemn one
    poisoned inner step.

How the captured group keeps the eager step's contract:
  - Per-step scalars (learning rate, step index) are tensors: a [k, 2]
    static buffer the host fills before each replay with the values the
    eager steps would use (the network's `_step_scalars`); no Python
    number of the step is baked into the graph. lr_policy="score" (a
    host-side decay per step) is rejected, as in the JAX package.
  - State lives in static buffers: the net's carry (the flat params and
    flat updater state on the flat chain, else the per-layer trees), its
    BN states and the stacked inputs are copied in before each replay,
    and the results cloned out after it (the next replay overwrites the
    graph's outputs). A guard's skip or rollback restore between replays
    therefore needs no recapture.
  - The body holds no host read, no host-to-device copy and no host
    allocation: every kernel wrapper launches on the current stream.
  - The kernel launch counters (nn/helpers/pallas_conv.py) move on the
    host, so a replay would not move them: the launches one replay makes
    are recorded at capture and added once per replay.
  - A warm-up step runs on a side stream before capture, so the kernels
    are built and loaded and autograd's buffers exist; if capture fails,
    run_group raises — it never runs eager steps in place of the graph.
    The cyclic garbage collector runs just before the capture and not
    during it: a dead object holding another group's graph, finalized
    mid-capture, would destroy that graph where CUDA forbids it.
  - Dropout: the masks come from the net's own generator, registered
    with each graph (`CUDAGraph.register_generator_state`), so every
    replay draws new masks and advances the generator exactly as k
    eager steps would; the warm-up step's draws are rewound.
  - Forensics: each new capture records a compile event (the group's
    key and argument signature, k, the capture seconds) in the net's
    `_jit_cache` and bumps `dl4j_jit_compiles_total`; a replay records
    nothing.
  - Memory: every group of one StepProgram captures into ONE graph pool
    (`torch.cuda.graph_pool_handle()`), and at most MAX_GROUPS groups
    are kept (the oldest is dropped). Sharing is safe because a replay
    is self-contained: its inputs are copied in before it and its
    outputs cloned out right after it, so no graph reads memory another
    graph's replay may have written.

`register_perf(cost_model, key)` counts a step's FLOPs and bytes into an
observability.perf.CostModel: the k=1 step, or a captured `run_group(k)`
group (the counterpart of the JAX package's JitCache entry).

Data parallelism (parallel/collectives.py):
  - per-step dp: a net with a dp group attached (`net._dp`, world > 1)
    averages its gradients in its own `_step` (one packed all-reduce) and
    computes BatchNorm statistics and the loss's row count over the
    global batch; `run_group` captures those collectives with the k steps
    (NCCL at world 1 only: a gloo group cannot be captured, and NCCL
    collectives captured at world > 1 hung (ROADMAP F11), so on CUDA
    run_group raises for both; on the CPU the body runs directly);
  - `attach_mesh(manager)` (engine/mesh.py MeshManager) routes `run`,
    `run_batch` and `run_group` through the ZeRO-1 step
    (engine/sharding.py): the net leaves the flat carry, its updater
    state is cut to this rank's slices, and every step reduce-scatters,
    updates the slices and all-gathers;
  - before the first capture with an NCCL group, one all-reduce runs on
    the capture stream (`collectives.warm_up`), and each captured group
    records the collectives it holds (`group_collectives()`);
  - `trainer_program(kind, build, *key)`: the local-SGD and stale
    trainers' programs (parallel/wrapper.py) are built and cached here,
    keyed with the frozen signature, as in the JAX package.

Program lint (analysis/program_lint.py): `lint_records(x, y, k=...)`
gives the records of the single step and of a k-step group, and
`lint_record_zero1(x, y)` that of the ZeRO-1 step, each a call of the
same step math `run` and `run_group` run, on clones of the net's carry
(the dropout generator rewound after the call), with the program's
declared precision policy.

F11 drill (ROADMAP queue 3): DL4J_TPU_GRAPH_LOG=1 logs each rank's
warm-ups, captures and replays with the collective counts;
DL4J_TPU_NCCL_CAPTURE=1 lifts the refusal of NCCL capture at world > 1.
"""

from __future__ import annotations

import gc
import hashlib
import os
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.helpers import pallas_conv
from deeplearning4j_tpu_torch.nn.jit_cache import describe_signature
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.resilience.errors import StepHangError
from deeplearning4j_tpu_torch.util.tree import clone, leaves, tree_map

# captured groups a StepProgram keeps (k-step windows of distinct shapes)
MAX_GROUPS = 4
# "1": every rank logs the warm-up, capture and each replay of a group
# with its key and the collective counts, flushed to stderr (the F11
# gang drill reads them rank by rank)
GRAPH_LOG_ENV = "DL4J_TPU_GRAPH_LOG"
# "1": capture NCCL collectives at world > 1 anyway (the F11 probe;
# run_group refuses it otherwise)
NCCL_CAPTURE_ENV = "DL4J_TPU_NCCL_CAPTURE"


def _graph_log(event: str, key, k: int) -> None:
    if os.environ.get(GRAPH_LOG_ENV) != "1":
        return
    digest = hashlib.sha1(repr(key).encode()).hexdigest()[:8]
    print(f"graph rank {collectives.rank()}: {event} group {digest} k={k} "
          f"collectives {dict(collectives.COUNTS)}", file=sys.stderr,
          flush=True)
# batch rows of the twin steps register_perf counts and extrapolates from
COUNT_ROWS = (1, 2)


def make_loss_and_apply(net):
    """(loss_for_grad, apply_updates) of `net` — the step math's two
    halves that the network's `_step` composes.

    `loss_for_grad(params, states, inputs, labels, lmasks)` returns
    (loss, new_states) with the net's mixed-precision policy applied
    (compute-dtype params/inputs, f32 master params and loss), starting
    every recurrent layer from zeros.
    `apply_updates(params, upd_states, grads, lr, step)` runs the flat
    chain's rule (params one flat tensor) or the per-layer rules with
    their lr factors and frozen flags; `lr` and `step` may be tensors."""
    def loss_for_grad(params, states, inputs, labels, lmasks):
        loss, new_states, _ = net._loss_for_grad(params, states, inputs,
                                                 labels, lmasks)
        return loss, new_states

    return loss_for_grad, net._apply_updates


class _CapturedGroup:
    """One k-step group body captured into a CUDA graph: the static input
    buffers, the graph, its outputs, and the kernel launches one replay
    makes."""

    def __init__(self, body, args, device, pool, gen=None, stream=None,
                 key=None):
        self.static = clone(args)
        self._in = leaves(self.static)
        self.key = key
        self.k = k = int(self.static[4].shape[0])   # scalars are [k, 2]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        rng = None if gen is None else gen.get_state()
        # warm-up: builds and loads the kernels, creates autograd's and
        # the allocator's buffers; its launches are real and count, its
        # dropout draws are rewound
        _graph_log("warm-up start", key, k)
        with torch.cuda.stream(side):
            body(*self.static, steps=1)
        cur.wait_stream(side)
        _graph_log("warm-up end", key, k)
        if gen is not None:
            gen.set_state(rng)
        before = pallas_conv.launch_counts()
        by_dtype = dict(pallas_conv.LAUNCHES_BY_DTYPE)
        coll0 = dict(collectives.COUNTS)
        self.graph = torch.cuda.CUDAGraph()
        if gen is not None:
            self.graph.register_generator_state(gen)
        # a garbage collection inside the capture could finalize a dead
        # object holding another CUDA graph, whose cudaGraphExecDestroy is
        # not permitted while this stream captures (it invalidates the
        # capture): collect before it, and none during it
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        _graph_log("capture start", key, k)
        try:
            # thread_local: an input pipeline's producer thread may pin
            # host memory while this thread captures
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = body(*self.static)
        except StepHangError:
            raise   # the watchdog's escalation: the group is not kept
        except Exception as e:
            raise RuntimeError(
                "run_group: capturing the k-step group into a CUDA graph "
                f"failed ({type(e).__name__}: {e}); nothing ran") from e
        finally:
            if gc_on:
                gc.enable()
            self.collectives = {k: collectives.COUNTS[k] - coll0[k]
                                for k in coll0
                                if collectives.COUNTS[k] != coll0[k]}
            after = pallas_conv.launch_counts()
            # capture records the launches; each replay makes them
            self.launches = {n: after[n] - before[n] for n in after
                             if after[n] != before[n]}
            pallas_conv.add_launch_counts(self.launches, -1)
            # a capture launches nothing: its wrapper calls leave no
            # (kernel, route, dtype) count either
            pallas_conv.LAUNCHES_BY_DTYPE.clear()
            pallas_conv.LAUNCHES_BY_DTYPE.update(by_dtype)
            _graph_log("capture end", key, k)

    def replay(self, args):
        new = leaves(args)
        if len(new) != len(self._in):
            raise ValueError(
                f"run_group: {len(new)} state/input tensors, the captured "
                f"group takes {len(self._in)}")
        for dst, src in zip(self._in, new):
            dst.copy_(src)
        _graph_log("replay start", self.key, self.k)
        self.graph.replay()
        _graph_log("replay end", self.key, self.k)
        pallas_conv.add_launch_counts(self.launches)
        return clone(self.out)


class StepProgram:
    """One net's training step, in every grouping.

    `run` / `run_batch` execute exactly one optimizer step; `run_group`
    executes k steps in one dispatch. All three mutate the net the way a
    train step always has (carry and BN states rebound, iteration
    advanced, `_score` set) so guards, snapshots and checkpoints see one
    contract."""

    def __init__(self, net):
        self.net = net
        self.is_graph = hasattr(net.conf, "network_inputs")
        self.is_tbptt = getattr(net.conf, "backprop_type", None) \
            == "truncated_bptt"
        # [k] per-inner-step losses of the newest run_group (a device
        # tensor; read by the guard only on checked groups)
        self.last_step_losses = None
        self._groups = {}
        self._pool = None   # the graph pool every group captures into
        # the stream every group captures on under a process group (None:
        # torch.cuda.graph's own)
        self._capture_stream = None
        # engine/mesh.py MeshManager once attach_mesh routed the program
        # through the ZeRO-1 step
        self.mesh_manager = None
        # capture cost, replay count and eager-run windows of the groups
        self.group_stats = {"captures": 0, "capture_s": 0.0, "replays": 0,
                            "eager_windows": 0}

    @property
    def precision_policy(self) -> str:
        """The declared precision policy of this net's step programs
        ('bf16'/'f16' under a compute dtype, else 'f32')."""
        from deeplearning4j_tpu_torch.nn.jit_cache import policy_name

        return policy_name(getattr(self.net, "compute_dtype", None))

    # ------------------------------------------------------------ mesh
    def attach_mesh(self, manager) -> "StepProgram":
        """Route this program through the ZeRO-1 step (engine/sharding.py)
        over `manager`'s dp group: the net leaves the flat carry (its one
        vector would be gathered whole), its updater state is cut to this
        rank's slices (`manager.shard_tree`, which records the layout), and
        `run` / `run_batch` / `run_group` step through the sharded update.
        Idempotent for the same manager."""
        from deeplearning4j_tpu_torch.engine.mesh import MeshManager
        from deeplearning4j_tpu_torch.engine.sharding import build_zero1_step

        if not isinstance(manager, MeshManager):
            raise TypeError("attach_mesh takes an engine.mesh.MeshManager, "
                            f"got {type(manager).__name__}")
        if self.is_tbptt:
            raise NotImplementedError(
                "ZeRO-1 mesh sharding does not support truncated BPTT "
                "(per-chunk host carries); train unsharded")
        if self.mesh_manager is manager:
            return self
        net = self.net
        if not net._initialized():
            net.init()
        net._materialize_flat()
        net._flat_chain = None
        net.updater_states = manager.shard_tree(net.updater_states)
        net._dp = None
        # run, run_batch and run_group's body step through it
        net._step_impl = build_zero1_step(net, manager)
        self.mesh_manager = manager
        return self

    # -------------------------------------- engine-owned trainer programs
    def trainer_program(self, kind: str, build, *key_extra):
        """The local-SGD and stale trainers' programs (parallel/wrapper.py),
        built once per `(kind, *key_extra, frozen signature)` key by
        `build(trace_key)` and kept in the net's JitCache with the
        program's precision policy registered — one compilation owner for
        every training program, as in the JAX package."""
        from deeplearning4j_tpu_torch.nn.jit_cache import policy_name

        cache = self.net._jit_cache
        key = (kind,) + tuple(key_extra) + (self._frozen_sig(),)
        if key not in cache:
            cache[key] = build(str(key))
            cache.register_policy(
                key, policy_name(getattr(self.net, "compute_dtype", None)))
        return cache[key]

    # ------------------------------------------------------ validation
    def require_sgd(self, entry: str) -> None:
        """Line-search solvers drive multiple loss evaluations per
        iteration from the host — there is no single step to supervise.
        Every harness entry point calls this once."""
        if getattr(self.net.conf, "optimization_algo",
                   "stochastic_gradient_descent") not in (
                "stochastic_gradient_descent", "sgd"):
            raise NotImplementedError(
                f"line-search solvers are not supported under {entry}; "
                "use stochastic_gradient_descent")

    # ------------------------------------------------------- single step
    def _tensors(self, x, y, fm, lm):
        """The batch as the net's `_batch_tensors` gives it: a graph
        takes per-input lists (its one input and output named by the
        configuration), a layer list the tensors themselves."""
        net = self.net
        if not net._initialized():
            net.init()
        if self.is_graph:
            return net._batch_tensors([x], [y], None if fm is None else [fm],
                                      None if lm is None else [lm])
        return net._batch_tensors(x, y, fm, lm)

    def run(self, x, y, fm=None, lm=None):
        """One training step on a canonical (x, y[, fm, lm]) batch — for a
        truncated-BPTT net on a 3-D batch, one step per chunk; through the
        ZeRO-1 step once a mesh is attached (the net's `_step_impl`).
        Returns the (last) device loss (0-d tensor, no host sync)."""
        return self.net._fit_one(*self._tensors(x, y, fm, lm))

    def run_batch(self, batch):
        """One step on a batch in any container shape ((x, y), DataSet,
        (x, y, fm, lm), ...) with full fit_batch semantics — the
        EarlyStoppingTrainer entry."""
        return self.net.fit_batch(batch)

    # ------------------------------------------------------ k-step group
    def _frozen_sig(self):
        return tuple(sorted(self.net._frozen()))

    def group_key(self, inputs, labels, lmasks, fmasks, flat: bool):
        """Cache key of a captured group, k aside: the per-step shapes and
        dtypes of inputs, labels, label and feature masks (None kept in
        place), frozen signature, helper mode, compute dtype, whether the
        carry is the flat chain's and whether dropout draws masks."""
        net = self.net
        plan = net._helper_plan()
        sig = lambda ts: repr(tree_map(
            lambda t: (tuple(t.shape[1:]), str(t.dtype)), ts))
        dp = getattr(net, "_dp", None)
        mesh = (None if self.mesh_manager is None
                else ("zero1",) + self.mesh_manager.cache_token())
        return ("engine_group", sig(inputs), sig(labels), sig(lmasks),
                sig(fmasks), self._frozen_sig(),
                "none" if plan is None else plan.impl,
                str(net.compute_dtype), flat, net._has_dropout(),
                None if dp is None else dp.world, mesh)

    def _group_body(self, carry, inputs, labels, lmasks, scalars,
                    fmasks=None, steps=None):
        """`steps` (default: all k) calls of the net's `_step` over the
        stacked inputs. Returns (carry, [steps] losses)."""
        net = self.net
        step = getattr(net, "_step_impl", None) or net._step
        k = scalars.shape[0] if steps is None else steps
        losses = []
        for i in range(k):
            at = lambda ts: tree_map(lambda t: t[i], ts)
            carry, loss, _ = step(carry, at(inputs), at(labels),
                                  at(lmasks), scalars[i], at(fmasks))
            losses.append(loss)
        return carry, torch.stack(losses)

    def _captured(self, key, k, args):
        """The group captured for (key, k), capturing it on first use
        into the program's one pool; None when a group of more steps is
        captured for `key` already (the window then runs eagerly)."""
        net = self.net
        grp = self._groups.get((key, k))
        if grp is not None:
            return grp
        if any(gk == key and gn > k for gk, gn in self._groups):
            return None
        if self.mesh_manager is not None \
                or getattr(net, "_dp", None) is not None \
                or getattr(net, "_tp", None) is not None:
            if collectives.backend() == "gloo":
                raise RuntimeError(
                    "run_group: a gloo process group's collectives cannot "
                    "be captured into a CUDA graph; use an NCCL group on "
                    "CUDA (or steps_per_dispatch=1)")
            if collectives.world_size() > 1 \
                    and os.environ.get(NCCL_CAPTURE_ENV) != "1":
                raise NotImplementedError(
                    "run_group: capturing NCCL collectives at world > 1 "
                    "hung on four H100s (ROADMAP queue 3, F11); "
                    "use steps_per_dispatch=1 over more than one rank")
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            if collectives.initialized():
                # with a process group every group captures on this one
                # stream; NCCL builds its communicators' stream state
                # lazily: warm every group and collective kind on it,
                # never inside the first capture
                self._capture_stream = torch.cuda.Stream(net.device)
                self._capture_stream.wait_stream(
                    torch.cuda.current_stream(net.device))
                with torch.cuda.stream(self._capture_stream):
                    collectives.warm_up(net.device)
                torch.cuda.current_stream(net.device).wait_stream(
                    self._capture_stream)
        while len(self._groups) >= MAX_GROUPS:
            del self._groups[next(iter(self._groups))]
        t0 = time.perf_counter()
        grp = _CapturedGroup(self._group_body, args, net.device, self._pool,
                             net._train_rng(), self._capture_stream, key)
        # analyze: allow=jit-host-sync — once per new group key: times the capture
        torch.cuda.synchronize(net.device)
        capture_s = time.perf_counter() - t0
        self.group_stats["capture_s"] += capture_s
        self.group_stats["captures"] += 1
        self._groups[(key, k)] = grp
        # capture forensics: one compile event per new group, none on
        # replays (the JAX package records its group programs alike)
        net._jit_cache.record_compile(key, describe_signature(args or ()),
                                      capture_s, k=k)
        return grp

    def run_group(self, xs, ys, fms=None, lms=None):
        """k steps, one dispatch. `xs`/`ys` (and optional masks) carry a
        leading [k, ...] step dim; state advances exactly as k sequential
        `run` calls would (same per-step lr schedule). Sets
        `last_step_losses` to the [k] device losses and `_score` to the
        final one. On CUDA the first call per group key captures the
        group into a CUDA graph (group_stats["capture_s"]); every call
        replays it, except a window shorter than a group already
        captured for the same shapes, which runs as k eager steps."""
        net = self.net
        if self.is_tbptt:
            raise NotImplementedError(
                "k-step grouping does not support truncated BPTT (the "
                "group carries no RNN state); use steps_per_dispatch=1")
        if getattr(net.conf, "lr_policy", None) == "score":
            raise NotImplementedError(
                "k-step grouping does not support lr_policy='score' "
                "(the decay factor is host state updated per step); "
                "use steps_per_dispatch=1")
        k = int(np.shape(xs)[0])
        inputs, labels, lmasks, fmasks = self._tensors(xs, ys, fms, lms)
        carry = net._train_carry()
        scalars = net._step_scalars(net.iteration, k)
        args = (carry, inputs, labels, lmasks, scalars, fmasks)
        grp = None
        if net.device.type != "cpu":
            grp = self._captured(self.group_key(
                inputs, labels, lmasks, fmasks,
                isinstance(carry[0], torch.Tensor)), k, args)
            if grp is None:
                self.group_stats["eager_windows"] += 1
        if grp is None:
            carry, losses = self._group_body(*args)
        else:
            carry, losses = grp.replay(args)
            self.group_stats["replays"] += 1
        net._set_train_carry(carry)
        net.iteration += k
        self.last_step_losses = losses
        net._score = losses[-1]
        return net._score

    # ------------------------------------------------------------- perf
    def _step_key(self):
        return ("train", self._frozen_sig())

    def register_perf(self, cost_model, key=None, *example_args):
        """Count one train step's cost into `cost_model`
        (observability.perf.CostModel) and return its entry. `key`
        defaults to the k=1 step, whose batch `example_args` (x, y)
        gives; a key of `group_launches()` — (group key, k) of a
        captured `run_group(k)` — registers k steps at the captured
        group's batch shapes.

        The hand-written kernels launch through ctypes, invisible to
        torch's counters, so the step is counted on a twin: a fresh net
        of the same configuration and dtypes on the same device, with
        seeded weights (FLOPs and bytes depend on shapes only). On the
        CPU it keeps the helper mode, whose kernel wrappers run their
        plain versions there; on a card a "pallas" net's twin runs
        "fused", the same products as cuDNN and aten ops. Either way
        every product is an aten op. The twin runs at COUNT_ROWS batch
        rows and the
        counts are extrapolated linearly to the real batch (FLOPs are
        linear in the rows; bytes are linear plus the params' constant
        part). Counted once, outside any timed window."""
        from deeplearning4j_tpu_torch.observability.perf import count_cost

        net = self.net
        if key is None:
            if len(example_args) < 2:
                raise ValueError("register_perf: the k=1 step needs an "
                                 "example batch (x, y)")
            key, k = self._step_key(), 1
            x, y = example_args[0], example_args[1]
            x_shape, y_shape = tuple(np.shape(x)), tuple(np.shape(y))
        else:
            grp = self._groups.get(key)
            if grp is None:
                raise KeyError(f"register_perf: no captured group {key!r}"
                               " (see group_launches())")
            k = key[1]
            _, inputs, labels, *_ = grp.static
            x_shape = tuple(leaves(inputs)[0].shape[1:])
            y_shape = tuple(leaves(labels)[0].shape[1:])
        rows = x_shape[0]
        plan = net._helper_plan()
        mode = "none" if plan is None else plan.impl
        conf, dev = net.conf, net.device
        if mode == "pallas" and dev.type == "cuda":
            # the kernels launch outside aten: count "fused" (the same
            # products as cuDNN/aten ops) on the card
            conf = type(conf).from_json(conf.to_json())
            conf.helper_mode = mode = "fused"
        twin = type(net)(conf, dtype=net.dtype,
                         compute_dtype=net.compute_dtype,
                         device=dev).init()
        twin_prog = StepProgram(twin)
        counts = []
        for r in COUNT_ROWS:
            xs = torch.zeros((r,) + x_shape[1:], dtype=torch.float32)
            ys = torch.zeros((r,) + y_shape[1:], dtype=torch.float32)
            counts.append(count_cost(lambda: twin_prog.run(xs, ys)))
        (r1, c1), (r2, c2) = zip(COUNT_ROWS, counts)
        at = lambda f: k * (c1[f] + (c2[f] - c1[f]) * (rows - r1)
                            / (r2 - r1))
        source = (f"counted: {k} x one train step of a {dev.type} twin "
                  f"({mode} helpers"
                  + (", plain kernel versions" if mode == "pallas" else "")
                  + ", compute dtype "
                  f"{net.compute_dtype or net.dtype}) at rows "
                  f"{r1},{r2} extrapolated to {rows}; FLOPs by "
                  "FlopCounterMode (2 per multiply-add), bytes as each "
                  "aten op's inputs+outputs")
        return cost_model.register_counted(
            key, at("flops"), at("bytes_accessed"), source)

    def group_collectives(self):
        """{(group key, k): {collective kind: calls}} one replay of each
        captured group issues (empty for a group without collectives)."""
        return {key: dict(g.collectives) for key, g in self._groups.items()}

    def group_launches(self):
        """{(group key, k): kernel launches one replay makes} of the
        captured groups (launch_counts' keys)."""
        return {key: dict(g.launches) for key, g in self._groups.items()}

    # ------------------------------------------------------------- lint
    def _lint_rewind(self):
        """A restore() putting the dropout generator back where it was,
        or None when the net draws no masks."""
        gen = self.net._train_rng()
        if gen is None:
            return None
        state = gen.get_state()
        return lambda: gen.set_state(state)

    def lint_records(self, x, y, fm=None, lm=None, k=None, name=None):
        """ProgramRecords (analysis/program_lint.py) of this net's train
        step — the k=1 step (graph inputs adapted; for a truncated-BPTT
        net one chunk from zero carries) and, when `k` is given, the
        k-step group `run_group` runs — for `analysis/program_lint`.
        Each record calls the same step math `run`/`run_group` call, on
        clones of the net's carry, so the lint leaves the net's state as
        it was (the dropout generator is rewound). On CUDA a group
        already captured for the same key adds its per-replay launches
        and collectives to the group record's notes."""
        from deeplearning4j_tpu_torch.analysis.program_lint import (
            ProgramRecord,
        )

        net = self.net
        source = "deeplearning4j_tpu_torch/engine/step_program.py"
        base = name or ("engine_graph" if self.is_graph
                        else "engine_single")
        inputs, labels, lmasks, fmasks = self._tensors(x, y, fm, lm)
        step = getattr(net, "_step_impl", None) or net._step
        scalars = net._step_scalars(net.iteration)[0]
        carry = clone(net._train_carry())
        if self.is_tbptt:
            base = name or "engine_tbptt"
            first = leaves(inputs)[0]
            T, L = int(first.shape[1]), net.conf.tbptt_fwd_length
            timed = lambda t: (t[:, :L] if t.ndim >= 2 and t.shape[1] == T
                               else t)
            args = (carry, tree_map(timed, inputs),
                    tree_map(lambda t: t[:, :L] if t.ndim == 3 else t,
                             labels),
                    tree_map(timed, lmasks), scalars,
                    tree_map(timed, fmasks),
                    net._initial_carries(int(first.shape[0])))
            consumed = (0, 1, 2)
        else:
            args = (carry, inputs, labels, lmasks, scalars, fmasks)
            consumed = (0, 1)
        records = [ProgramRecord(
            name=base, fn=step, example_args=args,
            precision_policy=self.precision_policy, source=source,
            consumed_outputs=consumed, restore=self._lint_rewind())]
        if k and not self.is_tbptt:
            stack = lambda a: None if a is None else np.repeat(
                np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                           else a)[None], k, axis=0)
            g_in, g_lab, g_lm, g_fm = self._tensors(
                stack(x), stack(y), stack(fm), stack(lm))
            gcarry = clone(net._train_carry())
            gargs = (gcarry, g_in, g_lab, g_lm,
                     net._step_scalars(net.iteration, k), g_fm)
            notes = {}
            if net.device.type != "cpu":
                key = (self.group_key(g_in, g_lab, g_lm, g_fm,
                                      isinstance(gcarry[0], torch.Tensor)),
                       k)
                grp = self._groups.get(key)
                if grp is not None:
                    notes = {"captured_launches": dict(grp.launches),
                             "captured_collectives": dict(grp.collectives)}
            records.append(ProgramRecord(
                name=f"{base}_group_k{k}", fn=self._group_body,
                example_args=gargs, precision_policy=self.precision_policy,
                source=source, consumed_outputs=(0, 1),
                restore=self._lint_rewind(), notes=notes))
        return records

    def lint_record_zero1(self, x, y, name=None):
        """ProgramRecord of the ZeRO-1 step (requires attach_mesh): the
        full params, this rank's updater-state slices (argument 1) and
        the BN states, with the bytes the MeshManager plan gives this
        rank (`shard_plan_bytes`: each sharded leaf's rows over dp, the
        rest whole) — the facts `prog-unsharded-optimizer-state` holds
        the state to. Every rank of the group must lint it together
        (the step reduce-scatters and all-gathers)."""
        from deeplearning4j_tpu_torch.analysis.program_lint import (
            ProgramRecord,
        )
        from deeplearning4j_tpu_torch.engine.sharding import (
            zero1_leaf_sharded,
        )

        if self.mesh_manager is None:
            raise ValueError("lint_record_zero1 requires attach_mesh")
        net, mgr = self.net, self.mesh_manager
        inputs, labels, lmasks, fmasks = self._tensors(x, y, None, None)
        params = net.params
        full = net._pack([net._updaters[key].init(params[key])
                          for key, _ in net._layer_items()])
        plan = sum(int(t.numel()) * t.element_size()
                   // (mgr.dp if zero1_leaf_sharded(tuple(t.shape), mgr.dp)
                       else 1) for t in leaves(full))
        step = net._step_impl

        def zero1_step(p, u, s, inputs, labels, lmasks, scalars, fmasks):
            return step((p, u, s), inputs, labels, lmasks, scalars, fmasks)

        args = (clone(params), clone(net.updater_states), clone(net.states),
                inputs, labels, lmasks,
                net._step_scalars(net.iteration)[0], fmasks)
        return ProgramRecord(
            name=name or "engine_zero1", fn=zero1_step, example_args=args,
            precision_policy=self.precision_policy,
            source="deeplearning4j_tpu_torch/engine/sharding.py",
            consumed_outputs=(0, 1), sharded_argnums=(1,),
            shard_plan_bytes=plan, restore=self._lint_rewind())
