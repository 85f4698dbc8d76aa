"""Registered metric and fault-point names that no port test named until
the port's analyzer (analysis/conformance.py, rule
reg-untested-registry-name) listed them, each driven through its
emission or fire site on the CPU and read back from the registry:
the guard's counters, the circuit breaker's transitions, the step
prefetcher's reseeks, the TrainingMaster's data wait, the cluster
supervisor's gang restarts and quarantines, and the `inference.complete`
and `serve.request` fault points."""

import sys
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.engine.pipeline import StepPrefetcher
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import get_registry
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.parallel.serving import (
    ModelClient,
    ModelServer,
)
from deeplearning4j_tpu_torch.resilience import (
    CircuitBreaker,
    InferenceUnavailableError,
    Retry,
    ServingError,
    injector,
)
from deeplearning4j_tpu_torch.resilience.cluster import (
    ClusterSupervisor,
    RestartsExhaustedError,
)
from deeplearning4j_tpu_torch.resilience.supervisor import NonFiniteGuard


@pytest.fixture(autouse=True)
def _clean_faults():
    injector().clear()
    yield
    injector().clear()


def _net(seed=3):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .list().layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _count(name, labels=None):
    return get_registry().counter_value(name, labels)


def test_guard_counters_reach_the_registry():
    net = _net()
    guard = NonFiniteGuard(policy="skip_step", loss_spike_factor=2.0)
    names = ("dl4j_train_guard_nonfinite_total",
             "dl4j_train_guard_spikes_total",
             "dl4j_train_guard_skipped_steps_total",
             "dl4j_train_guard_rollbacks_total")
    before = {n: _count(n) for n in names}
    net._score = torch.tensor(float("nan"))
    assert guard.post_step(net) == "nonfinite"
    net._score = torch.tensor(1.0)
    assert guard.post_step(net) == "ok"        # seeds the loss EMA
    net._score = torch.tensor(100.0)
    assert guard.post_step(net) == "spike"
    guard.note_skip()
    guard.note_rollback()
    assert {n: _count(n) - before[n] for n in names} == dict.fromkeys(
        names, 1.0)
    assert guard.stats()["nonfinite"] == guard.stats()["spikes"] == 1


def test_breaker_transitions_counted_per_target_state():
    now = [0.0]
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                        clock=lambda: now[0])
    name = "dl4j_breaker_transitions_total"
    before = {s: _count(name, {"to": s})
              for s in ("open", "half_open", "closed")}
    br.record_failure()
    assert br.state == "open"
    now[0] = 10.0
    assert br.state == "half_open"
    br.record_success()
    assert br.state == "closed"
    assert {s: _count(name, {"to": s}) - before[s] for s in before} == {
        "open": 1.0, "half_open": 1.0, "closed": 1.0}


def test_prefetcher_reseek_counted():
    pf = StepPrefetcher(lambda step: step, start=0, stop=8, depth=2)
    try:
        before = _count("dl4j_pipeline_reseeks_total")
        pf.seek(3)
        assert _count("dl4j_pipeline_reseeks_total") - before == 1.0
        assert pf.counters["reseeks"] == 1
    finally:
        pf.close()


def test_training_master_observes_its_data_wait():
    from deeplearning4j_tpu_torch.parallel import TrainingMaster

    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    name = "dl4j_train_data_wait_seconds"
    before = get_registry().snapshot()["histograms"].get(
        name, {"count": 0})["count"]
    TrainingMaster(_net()).fit(lambda step: (x, y), 3)
    after = get_registry().snapshot()["histograms"][name]["count"]
    assert after - before >= 3


def test_cluster_gang_restart_and_quarantine_counted(tmp_path):
    """A member that keeps crashing: two gang restarts, then its
    quarantine, each counted in the registry."""
    hb_dir = str(tmp_path / "hb")

    def command_fn(rank, nprocs, port, resume_step):
        if rank == 0:
            return [sys.executable, "-c", "import sys; sys.exit(3)"]
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    restarts = _count("dl4j_cluster_gang_restarts_total")
    quarantined = _count("dl4j_cluster_quarantined_workers_total")
    cs = ClusterSupervisor(2, command_fn, hb_dir, poll_s=0.05,
                           grace_s=0.5, restart_backoff_s=0.05,
                           max_restarts_per_worker=1,
                           startup_grace_s=60.0)
    t0 = time.monotonic()
    with pytest.raises(RestartsExhaustedError):
        cs.run(timeout_s=60.0)
    assert time.monotonic() - t0 < 30.0
    assert _count("dl4j_cluster_gang_restarts_total") - restarts == 2.0
    assert _count("dl4j_cluster_quarantined_workers_total") \
        - quarantined == 1.0
    assert cs.quarantined == [0]


def test_inference_complete_fault_kills_the_completion_stage():
    """`inference.complete`, fired at the top of each completion loop,
    kills the completion stage: the front end reports itself unhealthy
    and refuses requests."""
    pi = ParallelInference(_net(), batch_limit=4, queue_limit=8,
                           max_wait_ms=0.0, pipeline_depth=1,
                           default_timeout_s=10.0)
    try:
        assert pi.output(np.zeros((2, 4), np.float32)).shape == (2, 3)
        injector().inject("inference.complete", mode="raise", at_hit=1,
                          times=1 << 30)
        deadline = time.monotonic() + 10.0
        while pi.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not pi.healthy
        with pytest.raises(InferenceUnavailableError):
            pi.output(np.zeros((1, 4), np.float32))
    finally:
        pi.shutdown()


def test_serve_request_fault_answers_an_error():
    """`serve.request` fired in the request handler fails that request
    with a server error; the next one is served."""
    server = ModelServer(_net(), device="cpu").start()
    try:
        client = ModelClient(f"http://127.0.0.1:{server.port}",
                             retry=Retry(max_attempts=1), breaker=None)
        x = np.ones((1, 4), np.float32)
        injector().inject("serve.request", mode="raise", at_hit=1)
        with pytest.raises(ServingError) as ei:
            client.predict(x)
        assert ei.value.status >= 500
        out = np.asarray(client.predict(x)["outputs"], np.float32)
        assert out.shape == (1, 3)
    finally:
        server.stop()
