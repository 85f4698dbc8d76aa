"""The port's training engine against the JAX package's, and against itself.

Parity (the `_mini_resnet` of tests/test_helpers.py in f32, weights
carried over by `params_from_jax`, configurations through JSON, the
tolerances of tests/test_torch_train.py): `StepProgram.run` over 3 steps
in every helper mode, `run_group(3)`, and `EarlyStoppingTrainer` over 6
batches x 2 epochs with the pipeline on and off. Within the port, bit for
bit: `run_group(k)` against k `run()` calls (Adam and a step lr schedule,
so the per-step scalars matter), pipeline on against off, and a guard's
skip of a NaN batch against a run that never saw it. Guard drills, the
harness session, the serializer's write side (read by the JAX package,
sha256 sidecar, the `checkpoint.write` fault point) and the registries of
fault points and metrics."""

import ast
import copy
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.earlystopping import (
    DataSetLossCalculator as JLossCalc,
    EarlyStoppingConfiguration as JESConf,
    EarlyStoppingTrainer as JESTrainer,
    InMemoryModelSaver as JSaver,
    MaxEpochsTerminationCondition as JMaxEpochs,
)
from deeplearning4j_tpu.engine import StepProgram as JStepProgram
from deeplearning4j_tpu.util.model_serializer import (
    restore_computation_graph as jax_restore,
)
from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator,
    DataSet,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileGraphSaver,
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.engine import (
    StepHarness,
    StepProgram,
    make_loss_and_apply,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as tpc
from deeplearning4j_tpu_torch.observability import metrics as tobs
from deeplearning4j_tpu_torch.resilience import (
    CheckpointIntegrityError,
    NonFiniteGuard,
    NonFiniteLossError,
    PreemptedError,
    PreemptionHandler,
    injector,
)
from deeplearning4j_tpu_torch.resilience import faults as tfaults
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_computation_graph,
    verify_model,
    write_model,
)
from deeplearning4j_tpu_torch.util.tree import leaves
from test_helpers import _data, _mini_resnet
from test_torch_train import (
    LOSS_RTOL,
    PARAM_TOL,
    _assert_trees_close,
    _port_of,
)

MODES = ("none", "fused", "pallas")
PORT = Path(__file__).resolve().parent.parent / "deeplearning4j_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_injector():
    injector().clear()
    yield
    injector().clear()


def _batches(n, seed=2024, rows=8):
    rng = np.random.default_rng(seed)
    return [_data(rng, rows) for _ in range(n)]


def _port_net(mode="pallas", **conf_attrs):
    """A port net on the CPU from the mini ResNet's configuration (JSON),
    with its own seeded init."""
    conf = ComputationGraphConfiguration.from_json(
        _mini_resnet(mode).conf.to_json())
    for k, v in conf_attrs.items():
        setattr(conf, k, v)
    return ComputationGraph(conf, device="cpu").init()


def _state(net):
    """Every tensor a train step mutates, in a fixed order."""
    return (leaves(net.params) + leaves(net.updater_states)
            + leaves(net.states))


def _assert_bitwise(a, b):
    sa, sb = _state(a), _state(b)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert a.iteration == b.iteration


# ------------------------------------------------- StepProgram vs JAX


@pytest.mark.parametrize("mode", MODES)
def test_step_program_run_matches_jax(mode):
    jnet = _mini_resnet(mode)
    net = _port_of(jnet)
    jprog, prog = JStepProgram(jnet), StepProgram(net)
    for step, (x, y) in enumerate(_batches(3)):
        lj = float(jprog.run(jnp.asarray(x), jnp.asarray(y)))
        lt = float(prog.run(x, y))
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert net.iteration == jnet.iteration == 3
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)


@pytest.mark.parametrize("mode", ["fused", "pallas"])
def test_run_group_matches_jax(mode):
    jnet = _mini_resnet(mode)
    net = _port_of(jnet)
    data = _batches(3, seed=5)
    xs = np.stack([d[0] for d in data])
    ys = np.stack([d[1] for d in data])
    JStepProgram(jnet).run_group(jnp.asarray(xs), jnp.asarray(ys))
    prog = StepProgram(net)
    prog.run_group(xs, ys)
    assert net.iteration == jnet.iteration == 3
    assert tuple(prog.last_step_losses.shape) == (3,)
    np.testing.assert_allclose(float(net.score()), float(jnet.score()),
                               rtol=LOSS_RTOL)
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)


def test_run_group_losses_match_jax():
    """The [k] per-inner-step losses of one group, port against JAX."""
    jnet = _mini_resnet("pallas")
    net = _port_of(jnet)
    data = _batches(3, seed=6)
    xs = np.stack([d[0] for d in data])
    ys = np.stack([d[1] for d in data])
    jprog = JStepProgram(jnet)
    jprog.run_group(jnp.asarray(xs), jnp.asarray(ys))
    prog = StepProgram(net)
    prog.run_group(xs, ys)
    np.testing.assert_allclose(prog.last_step_losses.numpy(),
                               np.asarray(jprog.last_step_losses),
                               rtol=LOSS_RTOL)


# ------------------------------------------- run_group within the port

ADAM_STEP = dict(updater="adam", lr_policy="step", lr_policy_decay_rate=0.5,
                 lr_policy_steps=2.0)


@pytest.mark.parametrize("path", ["flat", "per_layer"])
@pytest.mark.parametrize("mode", MODES)
def test_run_group_equals_k_runs_bitwise(mode, path):
    """run_group(k) evolves params, updater state, BN states and the
    iteration exactly as k run() calls, with Adam (its bias correction
    reads the step) and a step lr schedule; on the flat chain and on the
    per-layer path."""
    data = _batches(4, seed=11)
    a, b = _port_net(mode, **ADAM_STEP), _port_net(mode, **ADAM_STEP)
    if path == "per_layer":
        a._flat_chain = b._flat_chain = None
    pa, pb = StepProgram(a), StepProgram(b)
    losses = [pa.run(x, y) for x, y in data]
    pb.run_group(np.stack([d[0] for d in data]),
                 np.stack([d[1] for d in data]))
    assert (b._flat_train is not None) == (path == "flat")
    _assert_bitwise(a, b)
    assert torch.equal(torch.stack(losses), pb.last_step_losses)
    assert torch.equal(b._score, losses[-1])


def test_masked_run_group_equals_k_runs_bitwise():
    """Label masks stacked beside the features ([k, B]) take the same
    path as k masked run() calls."""
    data = _batches(3, seed=13)
    lms = [np.ones(8, np.float32) for _ in data]
    for i, m in enumerate(lms):
        m[[i, i + 4]] = 0.0                  # two rows out of each batch
    a, b = _port_net(**ADAM_STEP), _port_net(**ADAM_STEP)
    pa, pb = StepProgram(a), StepProgram(b)
    losses = [pa.run(x, y, lm=m) for (x, y), m in zip(data, lms)]
    pb.run_group(np.stack([d[0] for d in data]),
                 np.stack([d[1] for d in data]), lms=np.stack(lms))
    assert torch.equal(torch.stack(losses), pb.last_step_losses)
    _assert_bitwise(a, b)
    unmasked = _port_net(**ADAM_STEP)
    StepProgram(unmasked).run(*data[0])
    assert not torch.equal(unmasked._score, losses[0])   # masks matter


def test_run_group_then_run_continues_the_schedule():
    """Two groups and a single step after them equal seven run() calls:
    the per-step scalars follow the iteration across groupings."""
    data = _batches(7, seed=12)
    a, b = _port_net(**ADAM_STEP), _port_net(**ADAM_STEP)
    pa, pb = StepProgram(a), StepProgram(b)
    for x, y in data:
        pa.run(x, y)
    for lo, hi in ((0, 3), (3, 6)):
        pb.run_group(np.stack([d[0] for d in data[lo:hi]]),
                     np.stack([d[1] for d in data[lo:hi]]))
    pb.run(*data[6])
    _assert_bitwise(a, b)


def test_step_scalars_are_the_schedule_in_the_nets_dtype():
    net = _port_net(**ADAM_STEP, learning_rate=0.1)
    s = net._step_scalars(3, 2)
    assert s.dtype == torch.float32 and tuple(s.shape) == (2, 2)
    np.testing.assert_array_equal(
        s.numpy(), np.float32([[0.1 * 0.5, 3.0], [0.1 * 0.25, 4.0]]))


def _bf16_master_graph(updater="adam"):
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.Builder().updater(updater)
            .learning_rate(0.01).graph_builder().add_inputs("x")
            .add_layer("d", DenseLayer(n_out=4), "x")
            .add_layer("out", OutputLayer(n_out=2), "d").set_outputs("out")
            .set_input_types(x=InputType.feed_forward(3)).build())
    return ComputationGraph(conf, dtype=torch.bfloat16, device="cpu").init()


def test_step_scalars_stay_f32_at_a_bf16_master():
    """At a bf16 master the step index 257 and lr 0.01 reach the update
    as the f32 schedule has them (a bf16 buffer rounds them to 256 and
    0.0100098): Adam's bias-corrected update equals the f32 schedule's."""
    net = _bf16_master_graph()
    lr, step = net._step_scalars(257)[0]
    assert lr.dtype == step.dtype == torch.float32
    assert step.item() == 257.0 and lr.item() == np.float32(0.01)
    upd, p = net._updaters["d"], net.params["d"]
    g = {k: torch.full_like(t, 0.5) for k, t in p.items()}
    state = {f: {k: torch.full_like(t, 0.25) for k, t in p.items()}
             for f in ("m", "v")}
    got, _ = upd.update(g, state, p, lr, step)
    ref, _ = upd.update(g, state, p, torch.tensor(0.01),
                        torch.tensor(257.0))
    for k in p:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], ref[k])


def test_captured_groups_share_one_pool_and_stay_bounded(monkeypatch):
    """The group policy without a card (the capture faked): every group
    of a StepProgram captures into one graph pool; a window shorter than
    a captured group of the same shapes runs eagerly (no capture); at
    most MAX_GROUPS groups are kept, the oldest dropped first. On the
    card: tests/test_torch_cuda.py."""
    from deeplearning4j_tpu_torch.engine import step_program as sp

    pools = []

    class FakeGroup:
        def __init__(self, body, args, device, pool, gen=None, stream=None,
                     key=None):
            pools.append(pool)

    handles = iter(range(100))
    monkeypatch.setattr(sp, "_CapturedGroup", FakeGroup)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(handles)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    prog = StepProgram(_port_net())
    g4 = prog._captured("shapes", 4, None)
    assert prog._captured("shapes", 4, None) is g4
    assert prog._captured("shapes", 2, None) is None     # eager window
    g8 = prog._captured("shapes", 8, None)
    assert g8 is not g4 and pools == [("pool", 0), ("pool", 0)]
    for i in range(sp.MAX_GROUPS + 2):
        prog._captured(("other", i), 4, None)
    assert len(prog._groups) == sp.MAX_GROUPS
    assert ("shapes", 4) not in prog._groups
    assert set(pools) == {("pool", 0)}
    assert prog.group_stats["captures"] == 2 + sp.MAX_GROUPS + 2


def test_each_new_capture_records_one_compile_event(monkeypatch):
    """Capture forensics without a card (the capture faked): a new group
    records one compile event in the net's JitCache — its key, argument
    signature, k and capture seconds — and bumps
    dl4j_jit_compiles_total; a group already captured records nothing
    (a replay never reaches the cache); the trace counters stay put."""
    from deeplearning4j_tpu_torch.engine import step_program as sp

    class FakeGroup:
        def __init__(self, body, args, device, pool, gen=None, stream=None,
                     key=None):
            pass

    monkeypatch.setattr(sp, "_CapturedGroup", FakeGroup)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    net = _port_net()
    prog = StepProgram(net)
    cache = net._jit_cache
    reg = tobs.get_registry()
    c0 = reg.counter_value("dl4j_jit_compiles_total")
    traces = cache.trace_counts()
    args = (torch.zeros(4, 3), [torch.ones(2)])
    prog._captured(("engine_group", "a"), 4, args)
    prog._captured(("engine_group", "a"), 4, args)      # cached: no event
    prog._captured(("engine_group", "a"), 2, args)      # eager window
    prog._captured(("engine_group", "b"), 8, args)
    events = cache.compile_events()
    assert [(e["key"], e["k"]) for e in events] \
        == [(str(("engine_group", "a")), 4), (str(("engine_group", "b")), 8)]
    assert all(e["signature"] == "(float32[4,3], [float32[2]])"
               and e["duration_s"] >= 0.0 for e in events)
    assert reg.counter_value("dl4j_jit_compiles_total") == c0 + 2
    assert cache.compiles_total() == 2
    assert cache.trace_counts() == traces


def test_run_group_rejects_score_policy_and_tbptt():
    x, y = _batches(1)[0]
    xs, ys = np.stack([x, x]), np.stack([y, y])
    net = _port_net(lr_policy="score", lr_policy_decay_rate=0.5)
    with pytest.raises(NotImplementedError, match="lr_policy='score'"):
        StepProgram(net).run_group(xs, ys)
    StepProgram(net).run(x, y)          # a single step still trains
    assert net.iteration == 1
    net = _port_net(backprop_type="truncated_bptt")
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        StepProgram(net).run_group(xs, ys)


def test_make_loss_and_apply_halves_compose_to_one_step():
    """The two halves, composed by hand, give the step's bits."""
    x, y = _batches(1)[0]
    a, b = _port_net(updater="nesterovs"), _port_net(updater="nesterovs")
    StepProgram(a).run(x, y)
    loss_for_grad, apply_updates = make_loss_and_apply(b)
    ins, labs, lms, _ = b._batch_tensors([x], [y])
    flat, upd, states = b._train_carry()
    leaf = flat.detach().requires_grad_()
    with torch.enable_grad():
        loss, new_states = loss_for_grad(b._flat_chain.unravel(leaf),
                                         states, ins, labs, lms)
        (g,) = torch.autograd.grad(loss, leaf)
    sc = b._step_scalars(0)[0]
    with torch.no_grad():
        new_flat, new_upd = apply_updates(flat, upd, g, sc[0], sc[1])
    b._set_train_carry((new_flat, new_upd, new_states))
    b.iteration += 1
    _assert_bitwise(a, b)


def test_attach_mesh_names_the_queue():
    # ZeRO-1 is ported (tests/test_torch_scaleout.py) and so is the tp
    # axis (queue 9c): in one process a tp mesh of 2 needs more processes
    # than the world has (ZeRO-1's tp refusal: tests/test_torch_tp.py)
    from deeplearning4j_tpu_torch.engine import MeshManager
    from deeplearning4j_tpu_torch.parallel import MeshSpec

    with pytest.raises(ValueError, match="mesh needs 2 processes"):
        StepProgram(_port_net()).attach_mesh(
            MeshManager(mesh=MeshSpec(tp=2)))
    with pytest.raises(TypeError, match="MeshManager"):
        StepProgram(_port_net()).attach_mesh(object())


def test_require_sgd_rejects_solvers():
    net = _port_net(optimization_algo="lbfgs")
    with pytest.raises(NotImplementedError, match="line-search"):
        StepProgram(net).require_sgd("EarlyStoppingTrainer")


# ------------------------------------------ EarlyStoppingTrainer vs JAX


def _es_conf(mod_conf, saver, calc, epochs):
    return mod_conf(epoch_termination_conditions=[epochs],
                    model_saver=saver, score_calculator=calc,
                    evaluate_every_n_epochs=1)


@pytest.mark.parametrize("pipeline", [True, False])
def test_early_stopping_matches_jax(pipeline):
    data = _batches(6, seed=21)
    held = _batches(1, seed=22)
    jnet = _mini_resnet("pallas")
    net = _port_of(jnet)
    jres = JESTrainer(_es_conf(JESConf, JSaver(), JLossCalc(held),
                               JMaxEpochs(2)), jnet, data,
                      pipeline=pipeline).fit()
    res = EarlyStoppingTrainer(
        _es_conf(EarlyStoppingConfiguration, InMemoryModelSaver(),
                 DataSetLossCalculator(held), MaxEpochsTerminationCondition(2)),
        net, data, pipeline=pipeline).fit()
    assert res.best_model_epoch == jres.best_model_epoch
    assert res.total_epochs == jres.total_epochs == 2
    assert sorted(res.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        np.testing.assert_allclose(res.score_vs_epoch[e], s, rtol=LOSS_RTOL)
    assert net.iteration == jnet.iteration == 12
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)


def _es_run(net, data, pipeline, guard=None, snapshot_every=0, epochs=2,
            saver=None):
    cfg = _es_conf(EarlyStoppingConfiguration, saver or InMemoryModelSaver(),
                   DataSetLossCalculator(_batches(1, seed=22)),
                   MaxEpochsTerminationCondition(epochs))
    trainer = EarlyStoppingTrainer(cfg, net, data, guard=guard,
                                   snapshot_every=snapshot_every,
                                   pipeline=pipeline)
    return trainer, trainer.fit()


def test_early_stopping_pipeline_on_equals_off_bitwise():
    data = _batches(6, seed=23)
    on, off = _port_net(updater="nesterovs"), _port_net(updater="nesterovs")
    t_on, r_on = _es_run(on, data, True)
    _, r_off = _es_run(off, data, False)
    assert r_on.score_vs_epoch == r_off.score_vs_epoch
    _assert_bitwise(on, off)
    facts = t_on._harness.pipeline_stats()
    assert facts["enabled"] and facts["kind"] == "iterator"
    assert facts["batches"] == 12


def test_early_stopping_trainer_matches_hand_loop_bitwise():
    """The trainer's net after one epoch equals a bare loop over the
    net's own train step (the JAX package's oracle shape)."""
    data = _batches(4, seed=24)
    net, ref = _port_net(), _port_net()
    _es_run(net, data, True, epochs=1)
    for x, y in data:
        ref._train_step(*ref._batch_tensors([x], [y]))
    # the trainer hands the best model (epoch 0: the only one) back
    _assert_bitwise(net, ref)


# --------------------------------------------------------- guard drills


def _poisoned(data, i):
    out = list(data)
    x, y = out[i]
    out[i] = (np.full_like(x, np.nan), y)
    return out


@pytest.mark.parametrize("pipeline", [True, False])
def test_guard_skip_step_equals_run_without_the_batch(pipeline):
    """skip_step over a NaN batch ends bit for bit where a run over the
    clean batches ends (each epoch skips it once)."""
    data = _batches(4, seed=31)
    net, ref = _port_net(updater="nesterovs"), _port_net(updater="nesterovs")
    guard = NonFiniteGuard("skip_step", check_every=1)
    _, res = _es_run(net, _poisoned(data, 2), pipeline, guard=guard)
    _, ref_res = _es_run(ref, data[:2] + data[3:], pipeline)
    assert guard.counters["skipped_steps"] == 2
    assert guard.counters["nonfinite"] == 2
    assert res.score_vs_epoch == ref_res.score_vs_epoch
    _assert_bitwise(net, ref)


def test_guard_rollback_with_snapshot_every():
    """rollback restores the newest periodic snapshot: with a snapshot
    before every step, a NaN batch is rolled back like a skip."""
    data = _batches(4, seed=32)
    net, ref = _port_net(updater="nesterovs"), _port_net(updater="nesterovs")
    guard = NonFiniteGuard("rollback", check_every=1, max_rollbacks=5)
    trainer, _ = _es_run(net, _poisoned(data, 1), False, guard=guard,
                         snapshot_every=1, epochs=1)
    _es_run(ref, data[:1] + data[2:], False, epochs=1)
    assert guard.counters["rollbacks"] == 1
    assert trainer._snapshotter.counters["restores"] == 1
    _assert_bitwise(net, ref)


def test_guard_rollback_needs_a_snapshot_cadence():
    with pytest.raises(ValueError, match="snapshot_every"):
        EarlyStoppingTrainer(
            EarlyStoppingConfiguration(), _port_net(), [],
            guard=NonFiniteGuard("rollback"))


def test_guard_snapshot_copies_the_flat_carry():
    """A snapshot of a net whose flat carry is live copies the carry
    itself and leaves it live (no unravel of the per-layer trees)."""
    x, y = _batches(1)[0]
    net = _port_net(updater="nesterovs")
    StepProgram(net).run(x, y)
    flat, uflat = net._flat_train
    guard = NonFiniteGuard()
    snap = guard.snapshot(net)
    assert net._flat_train is not None and net._params is None
    assert isinstance(snap["carry"][0], torch.Tensor)
    assert snap["carry"][0].data_ptr() != flat.data_ptr()
    StepProgram(net).run(x, y)
    guard.restore(net, snap)
    assert torch.equal(net._flat_train[0], flat)
    assert torch.equal(net._flat_train[1]["v"], uflat["v"])
    assert net.iteration == 1 and net._params is None


def test_guard_skip_around_run_group():
    """A group with a poisoned inner step is condemned whole by
    skip_step and the state restored bit for bit."""
    data = _batches(3, seed=33)
    net, ref = _port_net(), _port_net()
    harness = StepHarness(net, guard=NonFiniteGuard("skip_step"))
    xs = np.stack([d[0] for d in data])
    ys = np.stack([d[1] for d in data])
    xs[1] = np.nan
    ok = harness.guarded(lambda: harness.program.run_group(xs, ys))
    assert not ok and net.iteration == 0
    losses = harness.program.last_step_losses
    assert torch.isfinite(losses[0]) and not torch.isfinite(losses[1])
    _assert_bitwise(net, ref)


def test_dispatch_verdict_abort_raises():
    harness = StepHarness(_port_net(), guard=NonFiniteGuard(policy="abort"))
    with pytest.raises(NonFiniteLossError, match="policy=abort"):
        harness.dispatch_verdict("nonfinite", context="at step 0")


def test_dispatch_verdict_bounds_rollbacks():
    guard = NonFiniteGuard(policy="rollback", max_rollbacks=1)
    harness = StepHarness(_port_net(), guard=guard)
    assert harness.dispatch_verdict(
        "nonfinite", restore_rollback=lambda: None) == "rollback"
    with pytest.raises(NonFiniteLossError, match="max_rollbacks"):
        harness.dispatch_verdict("nonfinite",
                                 restore_rollback=lambda: None)


def test_guard_spike_detector():
    guard = NonFiniteGuard(loss_spike_factor=2.0)
    net = _port_net()
    for v, want in ((1.0, "ok"), (1.5, "ok"), (10.0, "spike")):
        net._score = torch.tensor(v)
        assert guard.post_step(net) == want
    assert guard.counters["spikes"] == 1 and guard.counters["checks"] == 3


def test_session_closes_attached_async_iterator():
    before = {t.name for t in threading.enumerate()}
    it = AsyncDataSetIterator(_batches(4), queue_size=2)
    harness = StepHarness(_port_net())
    harness.attach_data(it)
    with pytest.raises(RuntimeError):
        with harness.session():
            next(iter(it))        # producer thread is now live
            raise RuntimeError("fit crashed")
    after = [t for t in threading.enumerate()
             if t.name.startswith("AsyncDataSetIterator")
             and t.name not in before and t.is_alive()]
    assert not after, "prefetch thread leaked past session teardown"
    assert it._thread is None


def test_preemption_fault_checkpoints_then_raises():
    harness = StepHarness(_port_net(), preemption=PreemptionHandler())
    saved = []
    harness.check_preemption(0, save_checkpoint=saved.append)  # not armed
    injector().inject("train.preempt")
    with pytest.raises(PreemptedError, match="checkpoint saved"):
        harness.check_preemption(3, save_checkpoint=saved.append)
    assert saved == [3] and harness.counters["preemptions"] == 1
    assert harness.preemption.counters["simulated"] == 1
    assert not harness.preemption.requested


def test_harness_rejects_the_unported_default_profiler():
    """The default profiler was unported and raised; since the
    observability slice `phase_profiler=True` builds it, bound to the
    harness's accumulator."""
    from deeplearning4j_tpu_torch.observability.perf import StepPhaseProfiler

    h = StepHarness(_port_net(), phase_profiler=True)
    assert isinstance(h.phase_profiler, StepPhaseProfiler)
    assert h.phase_profiler.accumulator is h.acc


# ----------------------------------------------- serializer, write side


def _trained(mode="pallas", steps=2):
    net = _port_net(mode, updater="nesterovs")
    for x, y in _batches(steps, seed=41):
        net.fit_batch(([x], [y]))
    return net


def test_port_written_model_reads_in_jax(tmp_path):
    net = _trained()
    path = str(tmp_path / "port.zip")
    write_model(net, path)
    jnet = jax_restore(path)
    assert jnet.iteration == net.iteration == 2
    _assert_trees_close(jnet.params, net.params, rtol=0, atol=0)
    _assert_trees_close(jnet.states, net.states, rtol=0, atol=0)
    _assert_trees_close(jnet.updater_states, net.updater_states, rtol=0,
                        atol=0)
    x = _batches(1, seed=42)[0][0]
    np.testing.assert_allclose(np.asarray(net.output(x)),
                               np.asarray(jnet.output(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-6)


def test_port_write_then_read_is_bitwise_and_keeps_the_carry(tmp_path):
    net = _trained()
    assert net._flat_train is not None
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    assert net._flat_train is not None      # the write dropped nothing
    back = restore_computation_graph(path, device="cpu")
    assert verify_model(path)
    assert back.iteration == 2 and back.conf.to_json() == net.conf.to_json()
    _assert_bitwise(net, back)
    x, y = _batches(1, seed=43)[0]
    net.fit_batch(([x], [y]))
    back.fit_batch(([x], [y]))
    _assert_bitwise(net, back)


def test_sha256_sidecar_is_checked(tmp_path):
    net = _trained(steps=1)
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    with open(path + ".sha256") as f:
        digest = f.read()
    assert len(digest) == 64
    with open(path, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    assert not verify_model(path)
    with pytest.raises(CheckpointIntegrityError, match="sha256"):
        restore_computation_graph(path, device="cpu")


def test_checkpoint_write_truncate_fault_is_detected(tmp_path):
    net = _trained(steps=1)
    path = str(tmp_path / "m.zip")
    injector().inject("checkpoint.write", mode="truncate", truncate_to=64)
    write_model(net, path)
    assert os.path.getsize(path) == 64
    with pytest.raises(CheckpointIntegrityError):
        restore_computation_graph(path, device="cpu")


def test_checkpoint_write_raise_fault_publishes_nothing(tmp_path):
    net = _trained(steps=1)
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    before = open(path, "rb").read()
    injector().inject("checkpoint.write", mode="raise")
    with pytest.raises(Exception, match="checkpoint.write"):
        write_model(_trained(steps=2), path)
    assert open(path, "rb").read() == before    # the old model survives
    assert not os.path.exists(path + ".tmp")


def test_local_file_saver_best_model_rescores_exactly(tmp_path):
    data = _batches(3, seed=44)
    held = _batches(1, seed=45)
    net = _port_net(updater="nesterovs")
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
        model_saver=LocalFileGraphSaver(tmp_path),
        score_calculator=DataSetLossCalculator(held))
    res = EarlyStoppingTrainer(cfg, net, data).fit()
    best = res.best_model
    assert isinstance(best, ComputationGraph)
    assert verify_model(os.path.join(tmp_path, "bestModel.zip"))
    assert best.score(held[0]) == res.score_vs_epoch[res.best_model_epoch]
    assert res.best_model_score == res.score_vs_epoch[res.best_model_epoch]


def test_dataset_iterators_feed_the_trainer():
    x = np.concatenate([b[0] for b in _batches(2, seed=46)])
    y = np.concatenate([b[1] for b in _batches(2, seed=46)])
    it = ListDataSetIterator(DataSet(x, y), batch_size=8)
    a, b = _port_net(), _port_net()
    _es_run(a, it, True, epochs=2)
    _es_run(b, [(x[:8], y[:8]), (x[8:], y[8:])], False, epochs=2)
    _assert_bitwise(a, b)


# --------------------------------------------------------- registries


def _literal_calls(fn_names):
    out = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                f = node.func
                name = getattr(f, "attr", getattr(f, "id", ""))
                if name in fn_names:
                    out.append((node.args[0].value, path.name))
    return out


def test_port_fault_points_are_registered():
    fired = _literal_calls({"_fire", "fire"})
    assert {p for p, _ in fired} >= {"checkpoint.write", "train.preempt",
                                     "obs.emit"}
    assert all(p in tfaults.REGISTERED_POINTS for p, _ in fired), fired


def test_port_metrics_are_registered_and_emitted():
    emitted = {n for n, _ in _literal_calls(
        {"count", "observe", "set_gauge", "count_observe"})}
    emitted |= {n for n, _ in _literal_calls({"count_observe"})}
    # count_observe's second name is its histogram
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and len(node.args) > 1
                    and getattr(node.func, "attr", "") == "count_observe"
                    and isinstance(node.args[1], ast.Constant)):
                emitted.add(node.args[1].value)
    emitted = {n for n in emitted if n.startswith("dl4j_")}
    assert emitted <= tobs.REGISTERED_METRICS, \
        emitted - tobs.REGISTERED_METRICS
    assert tobs.REGISTERED_METRICS - emitted == {
        "dl4j_obs_dropped_emissions_total"}


def test_metrics_emission_survives_an_injected_failure():
    reg = tobs.get_registry()
    base = reg.counter_value("dl4j_train_steps_total")
    dropped = reg.dropped
    acc = tobs.StepAccumulator(flush_every=2)
    for _ in range(4):
        acc.count_observe("dl4j_train_steps_total",
                          "dl4j_train_step_seconds", 0.01)
    assert reg.counter_value("dl4j_train_steps_total") == base + 4
    injector().inject("obs.emit", times=2)
    tobs.count("dl4j_train_steps_total")        # swallowed
    acc.count_observe("dl4j_train_steps_total", "dl4j_train_step_seconds",
                      0.01)
    acc.flush()                                 # dropped, never raised
    assert reg.counter_value("dl4j_train_steps_total") == base + 4
    assert reg.dropped == dropped + 2
    snap = reg.snapshot()
    assert snap["histograms"]["dl4j_train_step_seconds"]["count"] >= 4


def test_launch_count_helpers_round_trip():
    saved = copy.deepcopy((tpc.LAUNCHES, tpc.FORWARD_ROUTES,
                           tpc.BACKWARD_ROUTES))
    try:
        tpc.reset_launch_counts()
        delta = {"fused_conv1x1": 30, "fused_conv1x1/wgmma": 30,
                 "dgrad_conv1x1": 2, "dgrad_conv1x1/simple": 2}
        tpc.add_launch_counts(delta, times=3)
        got = tpc.launch_counts()
        assert got["fused_conv1x1"] == 90
        assert got["fused_conv1x1/wgmma"] == 90
        assert got["dgrad_conv1x1/simple"] == 6
        assert got["wgrad_conv1x1"] == 0
        tpc.add_launch_counts(delta, times=-3)
        assert not any(tpc.launch_counts().values())
    finally:
        tpc.LAUNCHES.update(saved[0])
        tpc.FORWARD_ROUTES.update(saved[1])
        tpc.BACKWARD_ROUTES.update(saved[2])
