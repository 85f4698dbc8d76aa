"""The port's serving control plane on the CPU (serving/registry.py,
serving/admission.py, serving/router.py and the /v1/models routes of
parallel/serving.py): the counterparts of tests/test_serving_registry.py.

  * ModelRegistry lifecycle: register, swap, rollback, delete, verified
    loads (corrupted uploads rejected), restores onto the registry's
    device;
  * the hot-swap drill under client load: zero failed, zero mixed;
  * tenant admission: token buckets, shed-lowest-class-first driven
    with a given queue depth (and over HTTP with a held queue — no
    load-dependent shares), 429 + Retry-After;
  * ReplicaRouter: least-outstanding picking, failover, no healthy
    replica, non-retryable errors surfacing at once, real servers;
  * multi-input coalescing and dict inputs over HTTP;
  * the control-plane metrics on a /metrics scrape.

Outputs are compared at rtol 1e-4 / atol 1e-5 (the JAX tests' bound).
"""

import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import (
    REGISTERED_METRICS,
    get_registry,
)
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.parallel.serving import ModelClient, ModelServer
from deeplearning4j_tpu_torch.resilience import (
    CheckpointIntegrityError,
    CircuitBreaker,
    ModelNotFoundError,
    NoHealthyReplicaError,
    QuotaExceededError,
    Retry,
    ServingError,
    ShutdownError,
    injector,
)
from deeplearning4j_tpu_torch.serving import (
    AdmissionController,
    ModelRegistry,
    ReplicaRouter,
    TenantConfig,
    TokenBucket,
)
from deeplearning4j_tpu_torch.util import model_serializer

pytestmark = pytest.mark.serving

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    injector().clear()
    yield
    injector().clear()


def _net(seed=7, n_in=8, n_out=6):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=n_out, loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _two_input_graph(seed=3):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .graph_builder()
            .add_inputs("a", "b")
            .set_input_types(a=InputType.feed_forward(4),
                             b=InputType.feed_forward(3))
            .add_layer("da", DenseLayer(n_out=8), "a")
            .add_layer("db", DenseLayer(n_out=8), "b")
            .add_layer("out", OutputLayer(n_out=5, loss="mcxent"),
                       "da", "db")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def _direct(net, *xs):
    out = net.output(*xs)
    return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


class _EchoNet:
    """Synchronous echo stub, optionally gated: `gate` (an Event) holds
    every dispatch until set; `entered` is set on the first one."""

    def __init__(self, gate=None):
        self.gate = gate
        self.entered = threading.Event()

    def output(self, x):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=10.0)
        return np.asarray(x)


class _MultiIONet:
    def output(self, a, b):
        return [np.asarray(a), np.asarray(b)]


def _no_retry_client(port, **kw):
    return ModelClient(f"http://127.0.0.1:{port}",
                       retry=Retry(max_attempts=1), breaker=None, **kw)


def _wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def _bad_zip(tmp_path):
    bad = tmp_path / "bad.zip"
    bad.write_bytes(b"corrupted upload bytes")
    (tmp_path / "bad.zip.sha256").write_text("f" * 64)
    return bad


# ================================================= registry lifecycle
def test_registry_register_swap_rollback_retire():
    reg = ModelRegistry(batch_limit=4, warmup=False, max_wait_ms=0.0,
                        device="cpu")
    try:
        assert reg.register("m", _EchoNet()) == "v1"
        e = reg.entry("m")
        with e.lease() as (ver, pi):
            assert ver == "v1"
            np.testing.assert_allclose(pi.output(np.ones((1, 2),
                                                         np.float32)), 1.0)
        assert reg.register("m", _EchoNet()) == "v2"
        assert e.active == "v2" and e.previous == "v1"
        assert e.versions["v1"].state == "standby"
        assert reg.rollback("m") == "v1"
        assert e.active == "v1" and e.previous == "v2"
        with e.lease() as (ver, _):
            assert ver == "v1"
        with pytest.raises(ValueError, match="active"):
            reg.delete_version("m", "v1")
        reg.delete_version("m", "v2")
        assert _wait_for(lambda: "v2" not in e.versions)
        with pytest.raises(ModelNotFoundError):
            reg.entry("nope")
        with pytest.raises(ModelNotFoundError):
            reg.rollback("m")
    finally:
        reg.shutdown()


def test_registry_keep_warm_retires_old_standbys_in_background():
    """keep_warm=1: a third version retires the oldest standby (not the
    rollback target), which drains and shuts its batcher down off the
    swap's thread."""
    reg = ModelRegistry(keep_warm=1, batch_limit=2, warmup=False,
                        max_wait_ms=0.0, device="cpu")
    try:
        for _ in range(3):
            reg.register("m", _EchoNet())
        e = reg.entry("m")
        assert (e.active, e.previous) == ("v3", "v2")
        v1 = e.versions["v1"]
        assert _wait_for(lambda: v1.state == "retired")
        assert not v1.pi.healthy
        assert e.versions["v2"].state == "standby"
        assert e.versions["v2"].pi.healthy
    finally:
        reg.shutdown()


def test_lookups_racing_shutdown_are_503_not_404():
    """A request whose handler reaches the registry after `shutdown` is
    a ShutdownError (503, retryable: a router fails over), not the
    JAX package's ModelNotFoundError (404, surfaced to the caller)."""
    reg = ModelRegistry(batch_limit=2, warmup=False, device="cpu")
    reg.register("m", _EchoNet())
    reg.shutdown()
    for lookup in (lambda: reg.entry("m"), reg.default_entry,
                   lambda: reg.register("n", _EchoNet())):
        with pytest.raises(ShutdownError):
            lookup()


def test_registry_load_rejects_corrupted_upload(tmp_path):
    reg = ModelRegistry(batch_limit=4, warmup=False, device="cpu")
    try:
        with pytest.raises(CheckpointIntegrityError):
            reg.load_version("m", "v1", str(_bad_zip(tmp_path)))
        good = tmp_path / "good.zip"
        model_serializer.write_model(_net(), str(good))
        raw = good.read_bytes()
        good.write_bytes(raw[:len(raw) // 2])   # torn after the sidecar
        with pytest.raises(CheckpointIntegrityError):
            reg.load_version("m", "v1", str(good))
        assert reg.model_names() == ["m"] and reg.entry("m").versions == {}
        reg.register("live", _EchoNet())
        assert reg.healthy()
    finally:
        reg.shutdown()


def test_registry_load_version_and_auto_model_type(tmp_path):
    """A port-written zip restores onto the registry's device, in f32
    (a model zip carries no compute dtype), as the right container."""
    reg = ModelRegistry(batch_limit=4, device="cpu")
    try:
        net = _net(seed=5)
        p = tmp_path / "m.zip"
        model_serializer.write_model(net, str(p))
        g = _two_input_graph()
        pg = tmp_path / "g.zip"
        model_serializer.write_model(g, str(pg))
        reg.load_version("m", "v1", str(p))
        reg.load_version("g", "v1", str(pg))
        x = np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32)
        with reg.entry("m").lease() as (_, pi):
            assert type(pi.net).__name__ == "MultiLayerNetwork"
            assert pi.net.device == torch.device("cpu")
            assert pi.net.compute_dtype is None
            np.testing.assert_allclose(pi.output(x), _direct(net, x),
                                       rtol=RTOL, atol=ATOL)
        with reg.entry("g").lease() as (_, pi):
            assert type(pi.net).__name__ == "ComputationGraph"
    finally:
        reg.shutdown()


# =============================================== hot-swap chaos soak
@pytest.mark.chaos
def test_hot_swap_mid_soak_zero_failed_zero_mixed(tmp_path):
    """Clients hammer /v1/models/m/predict while a corrupted upload is
    rejected (409) and v2 is hot-swapped in. Every request succeeds and
    every response matches exactly the version it names. The drill
    waits on response counts, not on sleeps."""
    net1, net2 = _net(seed=1), _net(seed=2)
    x = np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32)
    refs = {"v1": _direct(net1, x), "v2": _direct(net2, x)}
    assert np.abs(refs["v1"] - refs["v2"]).max() > 1e-2
    p2 = tmp_path / "m2.zip"
    model_serializer.write_model(net2, str(p2))
    bad = _bad_zip(tmp_path)

    server = ModelServer(net1, model_name="m", queue_limit=256,
                         device="cpu").start()
    stop = threading.Event()
    failures, responses = [], []
    lock = threading.Lock()

    def hammer(i):
        client = _no_retry_client(server.port)
        while not stop.is_set():
            try:
                r = client.predict(x, model="m")
                with lock:
                    responses.append((r["version"],
                                      np.asarray(r["outputs"], np.float32),
                                      i))
            except Exception as e:   # noqa: BLE001 - recorded, asserted 0
                with lock:
                    failures.append(repr(e))

    def count(version=None):
        with lock:
            return sum(1 for v, _, _ in responses
                       if version is None or v == version)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        assert _wait_for(lambda: count() >= 20)
        admin = _no_retry_client(server.port)
        with pytest.raises(ServingError) as ei:
            admin.put_version("m", "vbad", str(bad))
        assert ei.value.status == 409
        assert ei.value.error_class == "CheckpointIntegrityError"
        admin.put_version("m", "v2", str(p2))
        assert _wait_for(lambda: count("v2") >= 20)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        server.stop()

    assert failures == [], f"requests failed during swap: {failures[:5]}"
    assert {v for v, _, _ in responses} == {"v1", "v2"}
    for version, out, _ in responses:
        np.testing.assert_allclose(out, refs[version], rtol=RTOL, atol=ATOL)
    # no flapping: each client's requests are sequential, so once one
    # of them saw v2 its later requests never lease v1 (across clients
    # a v1 request leased before the flip may finish after a v2 one)
    for i in range(4):
        versions = [v for v, _, t in responses if t == i]
        if "v2" in versions:
            first_v2 = versions.index("v2")
            assert all(v == "v2" for v in versions[first_v2:])


# ==================================================== tenant admission
def test_token_bucket_refills():
    tb = TokenBucket(rate=100.0, burst=2)
    assert tb.try_take() and tb.try_take()
    assert not tb.try_take()
    assert 0.0 < tb.retry_after_s() <= 1.0
    assert _wait_for(tb.try_take, timeout_s=1.0)   # 100/s refills


def test_admission_sheds_lowest_class_first():
    adm = AdmissionController({
        "gold": TenantConfig("gold", priority="high"),
        "silver": TenantConfig("silver", priority="normal"),
        "bronze": TenantConfig("bronze", priority="low"),
    })
    for depth, admitted in [(0, {"gold", "silver", "bronze"}),
                            (50, {"gold", "silver"}),
                            (85, {"gold"}),
                            (99, {"gold"})]:
        for tenant in ("gold", "silver", "bronze"):
            if tenant in admitted:
                adm.admit(tenant, "m", depth, 100)
            else:
                with pytest.raises(QuotaExceededError):
                    adm.admit(tenant, "m", depth, 100)
    st = adm.stats()
    assert st["admitted"] == 7 and st["shed_pressure"] == 5
    with pytest.raises(ValueError, match="priority"):
        TenantConfig("x", priority="urgent")


def test_admission_quota_over_http_and_retry_after():
    server = ModelServer(_EchoNet(), device="cpu", tenants={
        "burst2": {"rate": 0.5, "burst": 2, "priority": "normal"},
        "vip": {"priority": "high"},
    }).start()
    try:
        client = _no_retry_client(server.port)
        x = [[1.0, 2.0]]
        assert np.asarray(client.predict(x, tenant="burst2")["outputs"]).size
        assert np.asarray(client.predict(x, tenant="burst2")["outputs"]).size
        with pytest.raises(ServingError) as ei:
            client.predict(x, tenant="burst2")
        assert ei.value.status == 429
        assert ei.value.error_class == "QuotaExceededError"
        assert ei.value.retry_after_s >= 1
        assert np.asarray(client.predict(x, tenant="vip")["outputs"]).size
        assert np.asarray(client.predict(x)["outputs"]).size
        assert client.status()["admission"]["shed_quota"] == 1
    finally:
        server.stop()


@pytest.mark.chaos
def test_pressure_sheds_lowest_class_first_over_http():
    """The overload drill without load dependence: the model is held
    while gold requests fill the bounded queue to a known depth; then
    each class is asked once. Bronze (50%) and silver (85%) are shed
    with 429, gold still queues; releasing the model answers every
    admitted request."""
    gate = threading.Event()
    net = _EchoNet(gate=gate)
    server = ModelServer(net, batch_limit=1, queue_limit=10,
                         max_wait_ms=0.0, warmup=False, device="cpu",
                         tenants={"gold": {"priority": "high"},
                                  "silver": {"priority": "normal"},
                                  "bronze": {"priority": "low"}}).start()
    x = [[1.0, 2.0]]
    pool = cf.ThreadPoolExecutor(12)
    try:
        client = _no_retry_client(server.port)
        held = [pool.submit(client.predict, x, tenant="gold")]
        assert net.entered.wait(10.0)          # one inside the model
        held += [pool.submit(client.predict, x, tenant="gold")
                 for _ in range(9)]
        pi = server.pi
        assert _wait_for(lambda: pi.queue_depth() >= 9)
        for tenant in ("bronze", "silver"):
            with pytest.raises(ServingError) as ei:
                client.predict(x, tenant=tenant)
            assert ei.value.status == 429
            assert "pressure" in ei.value.message
        held.append(pool.submit(client.predict, x, tenant="gold"))
        assert _wait_for(lambda: pi.queue_depth() >= 10)
        gate.set()
        assert all(np.asarray(f.result(timeout=20.0)["outputs"]).size
                   for f in held)
        st = client.status()["admission"]
        assert st["shed_pressure"] == 2 and st["admitted"] == 11
    finally:
        gate.set()
        pool.shutdown(wait=True)
        server.stop()


# ===================================================== replica router
class _StubReplicaClient:
    """ModelClient stand-in: scripted failures, call recording."""

    def __init__(self, url, fail=0, exc=ConnectionError):
        self.url = url
        self.breaker = CircuitBreaker(failure_threshold=3,
                                      reset_timeout_s=60.0)
        self.calls = 0
        self._fail = fail
        self._exc = exc

    def predict(self, inputs, decode_top=0, model=None, tenant=None):
        self.calls += 1
        if self.calls <= self._fail:
            self.breaker.record_failure()
            raise self._exc(f"{self.url} down")
        self.breaker.record_success()
        return {"outputs": [[1.0]], "url": self.url}


def test_router_least_outstanding_and_failover():
    clients = {}

    def factory(url):
        clients[url] = _StubReplicaClient(url, fail=4 if "bad" in url else 0)
        return clients[url]

    router = ReplicaRouter(["http://bad:1", "http://ok-a:1",
                            "http://ok-b:1"], client_factory=factory)
    for _ in range(6):
        assert router.predict([[1.0]])["outputs"]
    st = router.stats()
    by_url = {r["url"]: r for r in st["replicas"]}
    assert clients["http://bad:1"].calls == 3
    assert by_url["http://bad:1"]["breaker"] == "open"
    assert st["failovers"] == 3
    assert clients["http://ok-a:1"].calls >= 2
    assert clients["http://ok-b:1"].calls >= 2
    assert sum(c.calls for c in clients.values()) == 6 + 3


def test_router_no_healthy_replica():
    router = ReplicaRouter(
        ["http://a:1", "http://b:1"],
        client_factory=lambda u: _StubReplicaClient(u, fail=10 ** 9))
    with pytest.raises(NoHealthyReplicaError) as ei:
        router.predict([[1.0]])
    assert isinstance(ei.value.cause, ConnectionError)
    with pytest.raises(NoHealthyReplicaError):
        router.predict([[1.0]])


def test_router_non_retryable_errors_surface_immediately():
    class _Client400(_StubReplicaClient):
        def predict(self, *a, **kw):
            self.calls += 1
            raise ServingError(status=400, message="bad inputs")

    made = {}

    def factory(url):
        made[url] = _Client400(url)
        return made[url]

    router = ReplicaRouter(["http://a:1", "http://b:1"],
                           client_factory=factory)
    with pytest.raises(ServingError) as ei:
        router.predict([[1.0]])
    assert ei.value.status == 400
    assert sum(c.calls for c in made.values()) == 1


def test_router_against_real_servers():
    s1 = ModelServer(_EchoNet(), device="cpu").start()
    s2 = ModelServer(_EchoNet(), device="cpu").start()
    try:
        router = ReplicaRouter(
            [f"http://127.0.0.1:{s1.port}", "http://127.0.0.1:9",
             f"http://127.0.0.1:{s2.port}"],
            client_factory=lambda u: ModelClient(
                u, timeout=2.0, retry=Retry(max_attempts=1)))
        for i in range(6):
            r = router.predict([[float(i), 0.0]])
            assert np.asarray(r["outputs"])[0][0] == float(i)
        st = router.stats()
        live = [r for r in st["replicas"] if ":9" not in r["url"]]
        assert all(r["requests"] >= 2 for r in live)
        assert st["failovers"] >= 1
    finally:
        s1.stop()
        s2.stop()


# ===================================== multi-input / dict coalescing
def test_multi_input_graph_batches_through_pooled_buckets():
    g = _two_input_graph()
    pi = ParallelInference(g, batch_limit=8, max_wait_ms=5.0)
    try:
        assert pi.stats()["warmed_buckets"] == [1, 2, 4, 8]
        for n in range(1, 6):   # the direct references' own traces
            g.output(np.zeros((n, 4), np.float32),
                     np.zeros((n, 3), np.float32))
        base = pi.trace_stats()["total_traces"]

        def one(seed):
            r = np.random.default_rng(seed)
            n = int(r.integers(1, 6))
            a = r.normal(size=(n, 4)).astype(np.float32)
            b = r.normal(size=(n, 3)).astype(np.float32)
            np.testing.assert_allclose(pi.output(a, b), _direct(g, a, b),
                                       rtol=RTOL, atol=ATOL)
            return n

        with cf.ThreadPoolExecutor(8) as ex:
            sizes = list(ex.map(one, range(24)))
        assert sum(sizes) > 24
        assert pi.trace_stats()["total_traces"] == base
        with pytest.raises(ValueError, match="2 input"):
            pi.output(np.zeros((1, 4), np.float32))
    finally:
        pi.shutdown()


def test_multi_input_split_and_multi_output_reassembly():
    pi = ParallelInference(_MultiIONet(), batch_limit=8, warmup=False,
                           max_wait_ms=0.0)
    try:
        a = np.arange(20 * 4, dtype=np.float32).reshape(20, 4)
        b = np.arange(20 * 3, dtype=np.float32).reshape(20, 3) * -1.0
        out = pi.output(a, b)
        assert isinstance(out, list) and len(out) == 2
        np.testing.assert_allclose(out[0], a)
        np.testing.assert_allclose(out[1], b)
        with pytest.raises(ValueError, match="batch dim"):
            pi.output(a, b[:3])
    finally:
        pi.shutdown()


def test_dict_inputs_over_http_ordered_by_graph():
    g = _two_input_graph()
    server = ModelServer(g, model_name="two-tower", device="cpu").start()
    try:
        client = _no_retry_client(server.port)
        rng = np.random.default_rng(1)
        a = rng.normal(size=(3, 4)).astype(np.float32)
        b = rng.normal(size=(3, 3)).astype(np.float32)
        r = client.predict({"a": a, "b": b}, model="two-tower")
        np.testing.assert_allclose(np.asarray(r["outputs"], np.float32),
                                   _direct(g, a, b), rtol=RTOL, atol=ATOL)
        with pytest.raises(ServingError) as ei:
            client.predict({"a": a}, model="two-tower")
        assert ei.value.status == 400
        assert "missing named inputs" in ei.value.message
    finally:
        server.stop()


# ========================================= metrics: per-tenant/model
def test_new_metrics_registered():
    assert {
        "dl4j_serving_model_requests_total", "dl4j_serving_admitted_total",
        "dl4j_serving_shed_total", "dl4j_serving_swaps_total",
        "dl4j_serving_rollbacks_total", "dl4j_serving_load_rejected_total",
        "dl4j_serving_active_models", "dl4j_serving_replica_failovers_total",
        "dl4j_serving_requests_total", "dl4j_serving_errors_total",
        "dl4j_serving_request_seconds", "dl4j_jit_traces_total",
        "dl4j_decode_migrations_total",
    } <= set(REGISTERED_METRICS)


def test_per_tenant_per_model_metrics_on_scrape(tmp_path):
    net2 = _net(seed=9)
    p2 = tmp_path / "v2.zip"
    model_serializer.write_model(net2, str(p2))
    bad = _bad_zip(tmp_path)
    server = ModelServer(_net(seed=8), model_name="m", device="cpu",
                         tenants={
                             "gold": {"priority": "high"},
                             "bronze": {"rate": 1.0, "burst": 1,
                                        "priority": "low"},
                         }).start()
    try:
        client = _no_retry_client(server.port)
        x = np.zeros((1, 8), np.float32)
        client.predict(x, model="m", tenant="gold")
        client.predict(x, model="m", tenant="bronze")
        with pytest.raises(ServingError):
            client.predict(x, model="m", tenant="bronze")
        with pytest.raises(ServingError):
            client.put_version("m", "vbad", str(bad))
        client.put_version("m", "v2", str(p2))
        client.predict(x, model="m", tenant="gold")
        client.rollback("m")
        m = client.metrics()
        mk = 'dl4j_serving_model_requests_total{model="m",version="%s"}'
        assert m[mk % "v1"] >= 2 and m[mk % "v2"] >= 1
        assert m['dl4j_serving_admitted_total'
                 '{priority="high",tenant="gold"}'] >= 2
        assert m['dl4j_serving_shed_total'
                 '{priority="low",reason="quota",tenant="bronze"}'] >= 1
        assert m['dl4j_serving_swaps_total{model="m"}'] >= 1
        assert m['dl4j_serving_rollbacks_total{model="m"}'] >= 1
        assert m['dl4j_serving_load_rejected_total{model="m"}'] >= 1
        assert m['dl4j_serving_active_models'] >= 1
        assert m['dl4j_serving_errors_total{code="429"}'] >= 1
        assert m['dl4j_serving_errors_total{code="409"}'] >= 1
        # lifecycle over the wire: catalog, per-model status, delete
        cat = client.models()
        assert cat["default"] == "m"
        assert set(cat["models"]["m"]["versions"]) == {"v1", "v2"}
        assert client.status(model="m")["active"] == "v1"
        with pytest.raises(ServingError) as ei:
            client.delete_version("m", "v1")       # active: conflict
        assert ei.value.status == 409
        assert client.delete_version("m", "v2")["deleted"] == "v2"
        with pytest.raises(ServingError) as ei:
            client.swap("m", "v9")
        assert ei.value.status == 404
        assert client.delete_model("m") == {"deleted": "m"}
        with pytest.raises(ServingError) as ei:
            client.status(model="m")
        assert ei.value.status == 404
    finally:
        server.stop()

    router = ReplicaRouter(
        ["http://a:1", "http://b:1"],
        client_factory=lambda u: _StubReplicaClient(
            u, fail=1 if "//a:" in u else 0))
    f0 = get_registry().counter_value("dl4j_serving_replica_failovers_total")
    router.predict([[1.0]])
    assert get_registry().counter_value(
        "dl4j_serving_replica_failovers_total") >= f0 + 1


def test_single_model_compat_surface_unchanged():
    net = _net()
    server = ModelServer(net, device="cpu").start()
    try:
        client = ModelClient(f"http://127.0.0.1:{server.port}")
        x = np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32)
        r = client.predict(x)
        np.testing.assert_allclose(np.asarray(r["outputs"], np.float32),
                                   _direct(net, x), rtol=RTOL, atol=ATOL)
        assert r["model"] == "default" and r["version"] == "v1"
        st = client.status()
        assert st["model"] == "MultiLayerNetwork"
        assert st["models"] == ["default"]
        assert st["pipeline"]["pipeline_depth"] == 2
        assert server.pi is not None and server.pi.healthy
    finally:
        server.stop()

    pi = ParallelInference(_EchoNet(), batch_limit=2, warmup=False,
                           max_wait_ms=0.0)
    server = ModelServer(pi, device="cpu").start()
    server.stop()
    assert pi.healthy   # a caller's ParallelInference is never shut down
    np.testing.assert_allclose(pi.output(np.ones((1, 2), np.float32)), 1.0)
    pi.shutdown()
