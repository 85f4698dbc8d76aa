"""The port's StepWatchdog and Supervisor (resilience/supervisor.py)
against the JAX package's drills (tests/test_selfhealing.py:203-251), on
the CPU, and the rule that every hook of the observability slice leaves
a fit bit for bit unchanged.

The hang is a `train.hang` delay on the training thread: the watchdog's
SIGUSR1 handler runs when that thread is back in the interpreter, which
a sleep allows (a wait inside CUDA would defer it; README). A supervised
fit that restarts from the newest checkpoint ends where JAX's unfaulted
fit ends, at the TrainingMaster tests' rtol 1e-5 / atol 1e-6 on the
dense MLN, and bit for bit where the port's own unfaulted fit ends."""

import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.observability import (
    CostModel,
    TelemetryListener,
    Tracer,
)
from deeplearning4j_tpu_torch.observability import metrics as tmetrics
from deeplearning4j_tpu_torch.optimize.listeners import (
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.parallel import TrainingMaster
from deeplearning4j_tpu_torch.resilience import (
    NonFiniteLossError,
    RestartsExhaustedError,
    StepWatchdog,
    Supervisor,
    injector,
)
from deeplearning4j_tpu_torch.stats import InMemoryStatsStorage, StatsListener
from test_helpers import _data
from test_torch_engine import _assert_bitwise, _port_net
from test_torch_training_master import (
    DENSE_TOL,
    _assert_close_to_jax,
    _batch,
    _jnet,
    _jtm,
    _tnet,
)


@pytest.fixture(autouse=True)
def _clean_injector():
    injector().clear()
    yield
    injector().clear()


@pytest.mark.chaos
@pytest.mark.parametrize("k", [1, 3])
def test_watchdog_escalates_hang_and_supervisor_resumes(tmp_path, k):
    """A wedged step (train.hang delay) is detected by the watchdog within
    its timeout and escalated as a restartable StepHangError; the
    Supervisor resumes from the newest checkpoint; the fit ends where
    JAX's unfaulted fit ends (DENSE_TOL) and bit for bit where the port's
    unfaulted fit ends. The hang instant is parented to the hung step's
    span (k=1: "train_step"; k=3: the window's "train_group")."""
    steps = 4 * k
    jnet = _jnet()
    _jtm(jnet, steps_per_dispatch=k).fit(_batch, steps)
    clean = _tnet()
    TrainingMaster(clean, steps_per_dispatch=k).fit(_batch, steps)

    net = _tnet()
    tr = Tracer()
    wd = StepWatchdog(timeout_s=2.0, poll_s=0.05)
    sup = Supervisor(max_restarts=2, initial_backoff_s=0.05)
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=k, watchdog=wd, supervisor=sup,
                        tracer=tr, steps_per_dispatch=k)
    hung = 2 * k   # the third step / window
    injector().inject("train.hang", mode="delay", at_hit=3, delay_s=30.0)
    sup.run(tm.fit, _batch, steps)
    assert wd.counters["hangs_detected"] == 1
    assert [e["error_class"] for e in sup.restart_ledger] \
        == ["StepHangError"]
    assert net.iteration == steps
    _assert_close_to_jax(jnet, net, **DENSE_TOL)
    _assert_bitwise(net, clean)
    spans = {s["id"]: s for s in tr.spans()}
    (hang,) = [s for s in spans.values() if s["name"] == "watchdog_hang"]
    parent = spans[hang["parent_id"]]
    assert parent["name"] == ("train_step" if k == 1 else "train_group")
    assert parent["args"]["step"] == hung
    resil = tm.training_stats()["resilience"]
    assert resil["watchdog"]["hangs_detected"] == 1
    assert resil["supervisor"]["restarts"] == 1


def test_supervisor_gives_up_after_max_restarts():
    calls = {"n": 0}

    def always_crashes():
        calls["n"] += 1
        raise RuntimeError("boom")

    before = tmetrics.get_registry().counter_value(
        "dl4j_train_supervisor_restarts_total")
    sup = Supervisor(max_restarts=2, initial_backoff_s=0.0,
                     sleep=lambda s: None)
    with pytest.raises(RestartsExhaustedError) as ei:
        sup.run(always_crashes)
    assert calls["n"] == 3                     # initial + 2 restarts
    assert len(ei.value.ledger) == 3
    assert ei.value.ledger[-1].get("gave_up") is True
    assert isinstance(ei.value.cause, RuntimeError)
    assert tmetrics.get_registry().counter_value(
        "dl4j_train_supervisor_restarts_total") == before + 2
    assert sup.stats()["restarts"] == 3


def test_supervisor_does_not_restart_abort_verdicts():
    calls = {"n": 0}

    def aborts():
        calls["n"] += 1
        raise NonFiniteLossError("policy=abort")

    sup = Supervisor(max_restarts=3, sleep=lambda s: None)
    with pytest.raises(NonFiniteLossError):
        sup.run(aborts)
    assert calls["n"] == 1 and sup.restart_ledger == []


def test_supervisor_backoff_is_capped_exponential():
    slept = []
    attempts = iter(range(10))

    def flaky():
        if next(attempts) < 4:
            raise OSError("transient")
        return "done"

    sup = Supervisor(max_restarts=5, initial_backoff_s=0.5, multiplier=2.0,
                     max_backoff_s=1.5, sleep=slept.append)
    assert sup.run(flaky) == "done"
    assert slept == [0.5, 1.0, 1.5, 1.5]


def test_watchdog_on_hang_replaces_the_signal_and_counts():
    seen = []
    before = tmetrics.get_registry().counter_value(
        "dl4j_train_watchdog_hangs_total")
    wd = StepWatchdog(timeout_s=0.2, poll_s=0.02,
                      on_hang=lambda phase, age: seen.append(phase))
    tr = Tracer()
    wd.tracer = tr
    with wd:
        wd.beat("fetch", step=5)
        t0 = time.monotonic()
        while not seen and time.monotonic() - t0 < 5.0:
            time.sleep(0.02)
    assert seen and seen[0] == "fetch"
    assert wd.stats()["hangs_detected"] >= 1
    assert tmetrics.get_registry().counter_value(
        "dl4j_train_watchdog_hangs_total") >= before + 1
    assert [s["name"] for s in tr.spans()][0] == "watchdog_hang"


def test_watchdog_cluster_heartbeat_waits_for_queue_8():
    with pytest.raises(NotImplementedError, match="queue 8"):
        StepWatchdog(heartbeat=object())


# ------------------------------------------------ hooks change nothing


@pytest.mark.parametrize("k", [1, 3])
def test_every_hook_leaves_the_fit_bit_for_bit(tmp_path, k):
    """The mini ResNet ("pallas", its plain kernel versions on the CPU)
    through TrainingMaster with a Tracer, the default phase profiler, a
    StepWatchdog, a Supervisor, TelemetryListener, StatsListener and
    ScoreIterationListener on net.listeners and a CostModel fed by
    register_perf ends bit for bit where the same fit without them
    ends."""
    data = [_data(np.random.default_rng(60 + s), 8) for s in range(7)]
    bare = _port_net("pallas")
    TrainingMaster(bare, steps_per_dispatch=k).fit(lambda s: data[s], 7)

    net = _port_net("pallas")
    tr = Tracer()
    sup = Supervisor()
    tm = TrainingMaster(net, steps_per_dispatch=k, tracer=tr,
                        phase_profiler=True, supervisor=sup,
                        watchdog=StepWatchdog(timeout_s=60.0),
                        checkpoint_dir=str(tmp_path), checkpoint_every=3)
    st = InMemoryStatsStorage()
    net.listeners += [TelemetryListener(frequency=1, tracer=tr),
                      StatsListener(st, frequency=1),
                      ScoreIterationListener(1, log=lambda m: None)]
    cm = CostModel(device="cpu")
    tm._harness.program.register_perf(cm, None, *data[0])
    sup.run(tm.fit, lambda s: data[s], 7)
    _assert_bitwise(net, bare)
    assert torch.equal(torch.as_tensor(net.score()),
                       torch.as_tensor(bare.score()))
    assert tm.training_stats()["phases"]["steps"] == (7 if k == 1 else 3)
    assert st.reports(st.session_ids()[0])
    assert cm.keys() == [str(tm._harness.program._step_key())]
    assert isinstance(tm._harness.program, StepProgram)
