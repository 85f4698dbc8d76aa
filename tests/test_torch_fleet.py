"""The port's fleet rollout controller (serving/controller.py) on the
CPU — the counterparts of tests/test_fleet.py: the rollout state
machine (canary -> watch -> ramp, auto-rollback on SLO breach,
hold-down ledger), the metric-driven autoscaler (bounds, cooldown,
drain-before-retire, replica-death backfill), dynamic ReplicaRouter
membership with the removed-mid-flight accounting fix, the new
`dl4j_fleet_*`/`dl4j_rollout_*` telemetry, and the serving chaos fault
points (rollout.canary_poison, serving.replica_kill,
admission.quota_storm).

Drills run on stub replicas with an injected clock — no sleeps. The HTTP
drill kills a real replica mid-soak and rolls back a canary poisoned to
answer 500s (the error-rate bound: no latency threshold, so no load
dependence) over the wire."""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observability import get_registry
from deeplearning4j_tpu_torch.observability.metrics import (
    MetricsRegistry,
    parse_prometheus_snapshot,
    render_prometheus,
)
from deeplearning4j_tpu_torch.resilience.errors import (
    NoHealthyReplicaError,
    QuotaExceededError,
    RolloutHeldError,
    ServingError,
)
from deeplearning4j_tpu_torch.resilience.faults import injector
from deeplearning4j_tpu_torch.serving import (
    AdmissionController,
    FleetController,
    HttpReplica,
    LocalReplica,
    ModelRegistry,
    ReplicaRouter,
    SLOPolicy,
    TenantConfig,
    slo_sample,
)
from deeplearning4j_tpu_torch.serving.controller import ROLLOUT_STATES

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _fresh_registry():
    """Exact-value assertions need a clean default registry; the
    registry is process-global on purpose, so tests reset it
    explicitly (the test_observability pattern)."""
    get_registry().reset()
    yield
    get_registry().reset()


# ------------------------------------------------------- stub plumbing
class _MetricFeed:
    """A private MetricsRegistry standing in for one replica's scrape
    surface: cumulative counters/histograms exactly like the real
    thing, fed by the test instead of real traffic."""

    def __init__(self):
        self.r = MetricsRegistry()

    def traffic(self, n=0, err500=0, shed=0, latency_s=0.01,
                queue_depth=None):
        for _ in range(int(n)):
            self.r.inc("dl4j_serving_requests_total")
            self.r.observe("dl4j_serving_request_seconds", latency_s)
        if err500:
            self.r.inc("dl4j_serving_errors_total", err500,
                       labels={"code": "500"})
        if shed:
            self.r.inc("dl4j_serving_shed_total", shed,
                       labels={"reason": "pressure"})
        self.r.inc("dl4j_serving_admitted_total", n)
        if queue_depth is not None:
            self.r.set_gauge("dl4j_serving_queue_depth", queue_depth)

    def snapshot(self):
        return self.r.snapshot()


class _StubReplica:
    """Duck-typed replica handle: records lifecycle calls, serves its
    feed's snapshots, plays dead on demand."""

    _seq = [0]

    def __init__(self, name=None):
        if name is None:
            self._seq[0] += 1
            name = f"stub-{self._seq[0]}"
        self.name = name
        self.feed = _MetricFeed()
        self.versions = {"m": "v1"}
        self.previous = {}
        self.loads = []
        self.swaps = []
        self.rollbacks = []
        self.retired = False
        self.alive = True

    def snapshot(self):
        return self.feed.snapshot()

    def healthy(self):
        return self.alive

    def active_version(self, model):
        return self.versions.get(model)

    def load_version(self, model, version, path, **kw):
        self.loads.append((model, version, path))

    def swap(self, model, version):
        self.previous[model] = self.versions.get(model)
        self.versions[model] = version
        self.swaps.append((model, version))

    def rollback(self, model):
        prev = self.previous.get(model)
        self.previous[model] = self.versions.get(model)
        self.versions[model] = prev
        self.rollbacks.append(model)

    def retire(self):
        self.retired = True


class _FakeTime:
    """Injected clock+sleep: sleeping advances the clock and runs a
    test-supplied callback (the 'traffic during this window' hook)."""

    def __init__(self):
        self.t = 0.0
        self.on_sleep = None

    def clock(self):
        return self.t

    def sleep(self, s):
        self.t += s
        if self.on_sleep is not None:
            self.on_sleep()


def _controller(replicas, ft, **kw):
    kw.setdefault("slo", SLOPolicy(max_error_rate=0.1, min_requests=5,
                                   window_s=1.0, windows=2,
                                   ramp_windows=1))
    kw.setdefault("holddown_s", 100.0)
    return FleetController(replicas, clock=ft.clock, sleep=ft.sleep,
                           **kw)


class _RouterStub:
    """Scriptable ModelClient stand-in for ReplicaRouter tests."""

    breaker = None

    def __init__(self, url, behavior=None):
        self.url = url
        self.behavior = behavior   # None | callable(url)

    def predict(self, inputs, decode_top=0, model=None, tenant=None):
        if self.behavior is not None:
            return self.behavior(self.url)
        return {"outputs": [[1.0]], "url": self.url}

    def status(self, model=None):
        return {"url": self.url}


# ================================================ rollout state machine
def test_rollout_ramp_completes_canary_first():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(3)]
    ft.on_sleep = lambda: [s.feed.traffic(n=20, latency_s=0.01)
                           for s in stubs]
    c = _controller(stubs, ft)
    r0 = get_registry().counter_value(
        "dl4j_rollout_total", labels={"model": "m",
                                      "outcome": "completed"})
    report = c.rollout("m", "v2", path="/tmp/v2.zip")
    assert report["outcome"] == "completed"
    assert report["canary"] == stubs[0].name
    assert report["flipped"] == [s.name for s in stubs]
    # warm-before-flip everywhere: load(activate=False) then swap
    for s in stubs:
        assert s.loads == [("m", "v2", "/tmp/v2.zip")]
        assert s.versions["m"] == "v2" and not s.rollbacks
    # the canary flipped strictly before any ramp flip
    assert stubs[0].swaps and stubs[1].swaps and stubs[2].swaps
    assert c.rollout_state == "completed"
    assert get_registry().counter_value(
        "dl4j_rollout_total",
        labels={"model": "m", "outcome": "completed"}) == r0 + 1
    assert get_registry().gauge_value("dl4j_rollout_state") \
        == ROLLOUT_STATES.index("completed")


def test_rollout_canary_breach_rolls_back_and_holds_down():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(3)]

    def on_sleep():
        for s in stubs:
            if s.versions["m"] == "v2":    # the canary is poisoned
                s.feed.traffic(n=20, err500=10)
            else:
                s.feed.traffic(n=20)

    ft.on_sleep = on_sleep
    c = _controller(stubs, ft)
    rb0 = get_registry().counter_value("dl4j_rollout_rollbacks_total",
                                       labels={"model": "m"})
    hd0 = get_registry().counter_value("dl4j_rollout_holddowns_total",
                                       labels={"model": "m"})
    report = c.rollout("m", "v2", path="/tmp/v2.zip")
    assert report["outcome"] == "rolled_back"
    assert "error_rate" in report["breach"]["reason"]
    assert report["detection_s"] is not None
    # ONLY the canary ever flipped; it was rolled back to v1
    assert stubs[0].rollbacks == ["m"]
    assert [s.versions["m"] for s in stubs] == ["v1", "v1", "v1"]
    assert not stubs[1].swaps and not stubs[2].swaps
    assert c.rollout_state == "held"
    assert get_registry().counter_value(
        "dl4j_rollout_rollbacks_total",
        labels={"model": "m"}) == rb0 + 1
    assert get_registry().counter_value(
        "dl4j_rollout_holddowns_total",
        labels={"model": "m"}) == hd0 + 1
    # dl4j_rollout_detection_seconds landed in the registry
    snap = get_registry().snapshot()
    assert snap["histograms"]["dl4j_rollout_detection_seconds"][
        "count"] >= 1

    # ---- hold-down: the failed version cannot re-canary immediately
    with pytest.raises(RolloutHeldError) as ei:
        c.rollout("m", "v2")
    assert ei.value.version == "v2" and ei.value.failures == 1
    # a DIFFERENT version is not held
    ft.on_sleep = lambda: [s.feed.traffic(n=20) for s in stubs]
    assert c.rollout("m", "v3")["outcome"] == "completed"
    # after expiry the held version may retry; a second failure
    # doubles the hold-down (exponential back-off on bad builds)
    ft.t += 101.0
    ft.on_sleep = on_sleep
    report = c.rollout("m", "v2")
    assert report["outcome"] == "rolled_back"
    with pytest.raises(RolloutHeldError) as ei:
        c.rollout("m", "v2")
    assert ei.value.failures == 2
    assert ei.value.until_s - ft.t > 150.0   # 2x holddown_s
    c.clear_holddown("m", "v2")
    ft.on_sleep = lambda: [s.feed.traffic(n=20) for s in stubs]
    assert c.rollout("m", "v2")["outcome"] == "completed"


def test_rollout_latency_breach_via_histogram_p99():
    """p99 comes from histogram BUCKET deltas of the scrape — a slow
    canary breaches an absolute p99 bound even though no error is ever
    returned."""
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(2)]

    def on_sleep():
        for s in stubs:
            slow = s.versions["m"] == "v2"
            s.feed.traffic(n=20, latency_s=1.0 if slow else 0.01)

    ft.on_sleep = on_sleep
    c = _controller(stubs, ft,
                    slo=SLOPolicy(max_error_rate=None, max_p99_s=0.1,
                                  min_requests=5, window_s=1.0,
                                  windows=2))
    report = c.rollout("m", "v2")
    assert report["outcome"] == "rolled_back"
    assert "p99" in report["breach"]["reason"]
    assert report["breach"]["sample"]["p99_s"] > 0.1


def test_rollout_ramp_breach_rolls_back_all_flipped():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(3)]

    def on_sleep():
        # the SECOND flipped replica (first ramp target) goes bad
        for s in stubs:
            bad = s is stubs[1] and s.versions["m"] == "v2"
            s.feed.traffic(n=20, err500=10 if bad else 0)

    ft.on_sleep = on_sleep
    c = _controller(stubs, ft)
    report = c.rollout("m", "v2")
    assert report["outcome"] == "rolled_back"
    assert report["flipped"] == [stubs[0].name, stubs[1].name]
    # every flipped replica is back on v1; replica 2 never flipped
    assert [s.versions["m"] for s in stubs] == ["v1", "v1", "v1"]
    assert stubs[0].rollbacks == ["m"] and stubs[1].rollbacks == ["m"]
    assert not stubs[2].swaps


def test_concurrent_rollout_rejected():
    ft = _FakeTime()
    stubs = [_StubReplica()]
    c = _controller(stubs, ft)
    assert c._rollout_lock.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="already in progress"):
            c.rollout("m", "v2")
    finally:
        c._rollout_lock.release()


def test_slo_policy_grammar_round_trip():
    p = SLOPolicy.parse("error_rate<0.02,p99<250ms,p99_ratio<1.5,"
                        "min_requests=20,window=500ms,windows=3,"
                        "ramp_windows=2")
    assert p.max_error_rate == 0.02
    assert p.max_p99_s == 0.25
    assert p.max_p99_ratio == 1.5
    assert p.min_requests == 20 and p.window_s == 0.5
    assert p.windows == 3 and p.ramp_windows == 2
    p2 = SLOPolicy.parse(p.to_spec())
    assert p2.to_spec() == p.to_spec()
    with pytest.raises(ValueError, match="unknown SLO key"):
        SLOPolicy.parse("p42<0.5")
    with pytest.raises(ValueError, match="bad duration"):
        SLOPolicy.parse("p99<fast")
    # insufficient traffic is NO signal, not a breach
    assert p.breach({"requests": 3, "errors": 3, "error_rate": 1.0,
                     "p99_s": 9.9}, None) is None
    # ratio bound against a measured baseline
    pr = SLOPolicy(max_error_rate=None, max_p99_ratio=1.5,
                   min_requests=1)
    assert pr.breach({"requests": 10, "errors": 0, "error_rate": 0.0,
                      "p99_s": 0.2}, 0.1) is not None
    assert pr.breach({"requests": 10, "errors": 0, "error_rate": 0.0,
                      "p99_s": 0.12}, 0.1) is None


def test_slo_sample_ignores_backpressure_codes():
    """429 sheds and 503 backpressure are capacity signals, not
    version badness — only 500-class failures count toward the
    rollback guard's error rate."""
    r = MetricsRegistry()
    prev = r.snapshot()
    r.inc("dl4j_serving_requests_total", 100)
    r.inc("dl4j_serving_errors_total", 30, labels={"code": "503"})
    r.inc("dl4j_serving_errors_total", 10, labels={"code": "429"})
    r.inc("dl4j_serving_errors_total", 2, labels={"code": "500"})
    s = slo_sample(prev, r.snapshot())
    assert s["requests"] == 100 and s["errors"] == 2
    assert abs(s["error_rate"] - 0.02) < 1e-9


# ============================================== mixed-version lease proof
class _ScaledEcho:
    def __init__(self, k):
        self.k = float(k)

    def output(self, x):
        return np.asarray(x) * self.k


def test_controller_rollout_mixed_version_impossible():
    """The lease proof, controller-driven: requests hammer two real
    ModelRegistry replicas while the controller ramps v1 -> v2; every
    response is computed end-to-end by exactly the version it leased
    (v1 outputs x*1, v2 outputs x*2 — a mixed response matches
    neither)."""
    regs = [ModelRegistry(batch_limit=4, warmup=False, max_wait_ms=0.0,
                          device="cpu")
            for _ in range(2)]
    replicas = []
    try:
        for i, reg in enumerate(regs):
            reg.register("m", _ScaledEcho(1.0), version="v1")
            reg.register("m", _ScaledEcho(2.0), version="v2",
                         activate=False)
            replicas.append(LocalReplica(f"local-{i}", reg))
        x = np.arange(8, dtype=np.float32).reshape(2, 4) + 1.0
        stop = threading.Event()
        bad, seen = [], []
        lock = threading.Lock()

        def hammer(reg):
            while not stop.is_set():
                with reg.entry("m").lease() as (ver, pi):
                    out = np.asarray(pi.output(x))
                k = 1.0 if ver == "v1" else 2.0
                ok = np.allclose(out, x * k)
                with lock:
                    seen.append(ver)
                    if not ok:
                        bad.append((ver, out))

        threads = [threading.Thread(target=hammer, args=(reg,),
                                    name=f"lease-hammer-{i}")
                   for i, reg in enumerate(regs) for _ in range(2)]

        def count(version):
            with lock:
                return seen.count(version)

        def wait_for(cond):
            deadline = time.monotonic() + 10.0
            while not cond() and time.monotonic() < deadline:
                time.sleep(0.005)

        for t in threads:
            t.start()
        wait_for(lambda: count("v1") >= 20)
        c = FleetController(
            replicas,
            slo=SLOPolicy(max_error_rate=0.5, min_requests=10 ** 9,
                          window_s=0.05, windows=1))
        report = c.rollout("m", "v2")
        wait_for(lambda: count("v2") >= 20)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        assert report["outcome"] == "completed"
        assert bad == [], f"mixed-version responses: {bad[:3]}"
        assert {"v1", "v2"} <= set(seen)
        for reg in regs:
            assert reg.entry("m").active == "v2"
    finally:
        for reg in regs:
            reg.shutdown()


# ======================================================== autoscaler
def _stub_router(urls):
    return ReplicaRouter(list(urls),
                         client_factory=lambda u: _RouterStub(u))


def test_autoscaler_scales_up_on_shed_rate_bounded_and_cooled():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(2)]
    router = _stub_router([s.name for s in stubs])
    spawned = []

    def factory():
        r = _StubReplica()
        spawned.append(r)
        return r

    c = _controller(stubs, ft, router=router, replica_factory=factory,
                    min_replicas=1, max_replicas=3, cooldown_s=10.0,
                    scale_up_shed_rate=0.05)
    up0 = get_registry().counter_value(
        "dl4j_fleet_scale_events_total", labels={"direction": "up"})
    c.tick()                                  # baseline tick
    stubs[0].feed.traffic(n=50, shed=50)      # 50% shed rate
    ft.t += 1.0
    c.tick()
    assert len(c.replicas) == 3 and len(spawned) == 1
    assert spawned[0].name in router.urls()
    assert get_registry().counter_value(
        "dl4j_fleet_scale_events_total",
        labels={"direction": "up"}) == up0 + 1
    assert c.fleet_slo_sample()["shed_rate"] > 0.4
    # cooldown: more sheds inside the window do NOT scale again
    stubs[0].feed.traffic(n=50, shed=50)
    ft.t += 1.0
    c.tick()
    assert len(c.replicas) == 3
    # cooled down + still shedding -> would scale, but max bounds it
    stubs[0].feed.traffic(n=50, shed=50)
    ft.t += 10.0
    c.tick()
    assert len(c.replicas) == 3       # max_replicas cap
    assert get_registry().gauge_value("dl4j_fleet_replicas") == 3


def test_autoscaler_scales_down_idle_fleet_after_drain():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(3)]
    router = _stub_router([s.name for s in stubs])
    c = _controller(stubs, ft, router=router, min_replicas=2,
                    cooldown_s=5.0, scale_down_rps_per_replica=1.0,
                    drain_timeout_s=0.2)
    c.tick()
    ft.t += 1.0
    c.tick()                                   # idle: rps 0, no sheds
    assert len(c.replicas) == 2
    assert stubs[2].retired                    # drain-then-retire ran
    assert stubs[2].name not in router.urls()
    down = get_registry().counter_value(
        "dl4j_fleet_scale_events_total", labels={"direction": "down"})
    assert down >= 1
    # min_replicas floors the shrink even after cooldown
    ft.t += 10.0
    c.tick()
    ft.t += 10.0
    c.tick()
    assert len(c.replicas) == 2


def test_autoscaler_busy_fleet_does_not_scale_down():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(2)]
    c = _controller(stubs, ft, min_replicas=1, cooldown_s=0.0,
                    scale_down_rps_per_replica=1.0)
    c.tick()
    for s in stubs:
        s.feed.traffic(n=100)   # 50 rps/replica over the 2s window
    ft.t += 2.0
    c.tick()
    assert len(c.replicas) == 2


def test_replica_kill_fault_point_removes_and_backfills():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(2)]
    router = _stub_router([s.name for s in stubs])
    spawned = []

    def factory():
        r = _StubReplica()
        spawned.append(r)
        return r

    c = _controller(stubs, ft, router=router, replica_factory=factory,
                    min_replicas=2, max_replicas=4)
    d0 = get_registry().counter_value(
        "dl4j_fleet_replica_deaths_total")
    # the drill verdict: first health-poll fire says "dead"
    injector().inject("serving.replica_kill", at_hit=1, times=1)
    c.tick()
    assert stubs[0].retired
    assert stubs[0].name not in router.urls()
    assert len(c.replicas) == 2 and len(spawned) == 1   # backfilled
    assert spawned[0].name in router.urls()
    assert get_registry().counter_value(
        "dl4j_fleet_replica_deaths_total") == d0 + 1
    assert c.stats()["autoscaler"]["deaths"] == 1

    # a REAL health failure (no fault) takes the same path
    stubs[1].alive = False
    c.tick()
    assert stubs[1].retired and len(spawned) == 2


def test_controller_loop_thread_runs_and_joins():
    stubs = [_StubReplica()]
    c = FleetController(stubs, autoscale_interval_s=0.02)
    c.start()
    deadline = time.monotonic() + 5.0
    while c._prev_fleet is None and time.monotonic() < deadline:
        time.sleep(0.01)
    c.stop()
    assert c._prev_fleet is not None     # at least one tick ran
    assert c._thread is None             # joined in stop()


# =============================================== admission quota storm
def test_quota_storm_sheds_metered_classes_only():
    adm = AdmissionController({
        "gold": TenantConfig("gold", priority="high"),
        "bronze": TenantConfig("bronze", rate=1000.0, burst=100,
                               priority="low"),
    })
    injector().inject("admission.quota_storm", times=10 ** 9)
    # metered bronze is force-shed by the storm...
    for _ in range(5):
        with pytest.raises(QuotaExceededError):
            adm.admit("bronze", "m", 0, 100)
    # ...while unmetered gold rides through untouched
    for _ in range(5):
        adm.admit("gold", "m", 0, 100)
    injector().clear("admission.quota_storm")
    st = adm.stats()
    assert st["shed_quota"] == 5 and st["admitted"] == 5
    adm.admit("bronze", "m", 0, 100)      # storm over: bronze admits


def test_canary_poison_point_turns_requests_into_500s():
    from deeplearning4j_tpu_torch.parallel.serving import ModelServer
    from deeplearning4j_tpu_torch.resilience import Retry
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    class _Echo:
        def output(self, x):
            return np.asarray(x)

    server = ModelServer(_Echo(), model_name="m", device="cpu").start()
    try:
        client = ModelClient(f"http://127.0.0.1:{server.port}",
                             retry=Retry(max_attempts=1), breaker=None)
        x = [[1.0, 2.0]]
        assert np.asarray(client.predict(x, model="m")["outputs"]).size
        injector().inject("rollout.canary_poison", times=1)
        with pytest.raises(ServingError) as ei:
            client.predict(x, model="m")
        assert ei.value.status == 500
        assert ei.value.error_class == "FaultInjectedError"
        # poison consumed; the replica serves again
        assert np.asarray(client.predict(x, model="m")["outputs"]).size
    finally:
        server.stop()


# ================================================== router membership
def test_router_add_remove_replica_with_drain():
    router = _stub_router(["http://a:1", "http://b:1"])
    router.add_replica("http://c:1")
    assert router.urls() == ["http://a:1", "http://b:1", "http://c:1"]
    with pytest.raises(ValueError, match="already a member"):
        router.add_replica("http://c:1/")
    # drain: an in-flight request blocks removal until it completes
    release = threading.Event()
    entered = threading.Event()

    def slow(url):
        if url == "http://c:1":
            entered.set()
            release.wait(5.0)
        return {"outputs": [[1.0]], "url": url}

    for r in router._replicas:
        r.client.behavior = slow
    # pin the request to c by filling a/b's outstanding accounting
    with router._lock:
        for r in router._replicas:
            if r.url != "http://c:1":
                r.outstanding = 5
    t = threading.Thread(target=router.predict, args=([[1.0]],),
                         name="drain-req")
    t.start()
    assert entered.wait(5.0)
    t0 = time.monotonic()
    done = []
    rm = threading.Thread(
        target=lambda: done.append(router.remove_replica(
            "http://c:1", drain=True, drain_timeout_s=5.0)),
        name="drain-rm")
    rm.start()
    time.sleep(0.1)
    assert "http://c:1" in router.urls()       # still draining
    release.set()
    rm.join(timeout=5.0)
    t.join(timeout=5.0)
    assert done == [True]                      # drained cleanly
    assert time.monotonic() - t0 < 5.0
    assert router.urls() == ["http://a:1", "http://b:1"]
    with pytest.raises(ValueError, match="no replica"):
        router.remove_replica("http://c:1")


def test_removed_mid_flight_fails_over_without_breaker_accounting():
    """The satellite fix: a replica removed while its request is in
    flight (autoscale shrink or kill) fails over, but the failure does
    NOT count against the removed replica — no failover counter, no
    failure mark. An orchestrated removal is not replica badness."""
    entered = threading.Event()
    removed = threading.Event()

    def behavior(url):
        if url == "http://dying:1":
            entered.set()
            assert removed.wait(5.0)
            raise ConnectionError("socket died mid-request")
        return {"outputs": [[1.0]], "url": url}

    router = ReplicaRouter(
        ["http://dying:1", "http://ok:1"],
        client_factory=lambda u: _RouterStub(u, behavior))
    with router._lock:
        for r in router._replicas:
            if r.url == "http://ok:1":
                r.outstanding = 5    # force the pick onto dying
    f0 = get_registry().counter_value(
        "dl4j_serving_replica_failovers_total")
    out = []
    t = threading.Thread(
        target=lambda: out.append(router.predict([[1.0]])),
        name="midflight-req")
    t.start()
    assert entered.wait(5.0)
    router.remove_replica("http://dying:1", drain=False)
    removed.set()
    t.join(timeout=10.0)
    assert out and out[0]["url"] == "http://ok:1"   # failed over
    st = router.stats()
    assert st["failovers"] == 0
    assert all(r["failures"] == 0 for r in st["replicas"])
    assert get_registry().counter_value(
        "dl4j_serving_replica_failovers_total") == f0


def test_no_healthy_replica_carries_membership_snapshot():
    def always_down(url):
        raise ConnectionError(f"{url} down")

    router = ReplicaRouter(
        ["http://a:1", "http://b:1"],
        client_factory=lambda u: _RouterStub(u, always_down))
    with pytest.raises(NoHealthyReplicaError) as ei:
        router.predict([[1.0]])
    assert sorted(ei.value.membership) == ["http://a:1", "http://b:1"]
    assert isinstance(ei.value.cause, ConnectionError)
    # every per-replica failure rides along — "everyone shed me" and
    # "no one even answered" are distinguishable
    assert sorted(u for u, _ in ei.value.causes) \
        == ["http://a:1", "http://b:1"]
    assert all(isinstance(c, ConnectionError)
               for _, c in ei.value.causes)


# ===================================== fleet aggregation + exposition
def test_fleet_snapshot_aggregates_replica_scrapes():
    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(2)]
    stubs[0].feed.traffic(n=10)
    stubs[1].feed.traffic(n=5, err500=1)
    c = _controller(stubs, ft)
    agg = c.fleet_snapshot()
    assert sum(agg["counters"]["dl4j_serving_requests_total"]
               .values()) == 15
    hist = agg["histograms"]["dl4j_serving_request_seconds"]
    assert hist["count"] == 15
    text = c.fleet_prometheus_text()
    assert "dl4j_serving_requests_total 15" in text


def test_parse_prometheus_snapshot_round_trip_is_aggregatable():
    """Scrape text -> snapshot -> aggregate is the HttpReplica
    observation path; counters/gauges/buckets survive the wire
    exactly."""
    r = MetricsRegistry()
    r.inc("dl4j_serving_requests_total", 7)
    r.inc("dl4j_serving_errors_total", 2, labels={"code": "500"})
    r.set_gauge("dl4j_serving_queue_depth", 4)
    for v in (0.005, 0.02, 0.9):
        r.observe("dl4j_serving_request_seconds", v,
                  labels={"model": "m"})
    snap = r.snapshot()
    back = parse_prometheus_snapshot(render_prometheus(snap))
    assert back["counters"]["dl4j_serving_requests_total"] \
        == snap["counters"]["dl4j_serving_requests_total"]
    assert back["counters"]["dl4j_serving_errors_total"] \
        == snap["counters"]["dl4j_serving_errors_total"]
    assert back["gauges"]["dl4j_serving_queue_depth"] \
        == snap["gauges"]["dl4j_serving_queue_depth"]
    key = 'dl4j_serving_request_seconds{model="m"}'
    assert back["histograms"][key]["buckets"] \
        == snap["histograms"][key]["buckets"]
    assert back["histograms"][key]["count"] == 3
    # two scrapes aggregate like two ranks
    from deeplearning4j_tpu_torch.observability.perf import (
        aggregate_snapshots,
    )

    agg = aggregate_snapshots([back, back])
    assert sum(agg["counters"]["dl4j_serving_requests_total"]
               .values()) == 14


# ============================================ telemetry registration
def test_fleet_metrics_and_fault_points_registered():
    from deeplearning4j_tpu_torch.observability import REGISTERED_METRICS
    from deeplearning4j_tpu_torch.resilience.faults import REGISTERED_POINTS

    assert {
        "dl4j_fleet_replicas",
        "dl4j_fleet_scale_events_total",
        "dl4j_fleet_replica_deaths_total",
        "dl4j_rollout_state",
        "dl4j_rollout_total",
        "dl4j_rollout_rollbacks_total",
        "dl4j_rollout_holddowns_total",
        "dl4j_rollout_detection_seconds",
    } <= set(REGISTERED_METRICS)
    assert {
        "rollout.canary_poison",
        "serving.replica_kill",
        "admission.quota_storm",
    } <= set(REGISTERED_POINTS)


def test_dashboard_fleet_line_pinned():
    """telemetry_lines renders the fleet status line from the ONE
    metrics substrate, and the dashboard's inline state-name mirror
    stays equal to controller.ROLLOUT_STATES (every index renders its
    controller-side name)."""
    from deeplearning4j_tpu_torch.observability import metrics as obs
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    obs.set_gauge("dl4j_fleet_replicas", 3)
    obs.count("dl4j_rollout_rollbacks_total")
    for i, name in enumerate(ROLLOUT_STATES):
        obs.set_gauge("dl4j_rollout_state", i)
        lines = telemetry_lines(get_registry())
        fleet = [ln for ln in lines if ln.startswith("fleet — ")]
        assert fleet, lines
        assert "3 replicas" in fleet[0]
        assert f"rollout {name}" in fleet[0], (name, fleet[0])
        assert "1 rollbacks" in fleet[0]


def test_fleet_scrapeable_end_to_end_over_http():
    """dl4j_fleet_*/dl4j_rollout_* ride the real GET /metrics body."""
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient, ModelServer

    class _Echo:
        def output(self, x):
            return np.asarray(x)

    ft = _FakeTime()
    stubs = [_StubReplica() for _ in range(2)]
    ft.on_sleep = lambda: [s.feed.traffic(n=20) for s in stubs]
    c = _controller(stubs, ft)
    c.rollout("m", "v2")
    server = ModelServer(_Echo(), device="cpu").start()
    try:
        m = ModelClient(f"http://127.0.0.1:{server.port}").metrics()
        assert m["dl4j_fleet_replicas"] == 2
        assert m["dl4j_rollout_state"] \
            == ROLLOUT_STATES.index("completed")
        assert m['dl4j_rollout_total'
                 '{model="m",outcome="completed"}'] >= 1
    finally:
        server.stop()


# =========================================== HTTP fleet drill
@pytest.mark.chaos
def test_replica_kill_and_poisoned_canary_over_http():
    """The serving chaos drill over real HTTP: a replica dies abruptly
    mid-soak (router failover keeps every request whole, the controller
    backfills a fresh replica), then a canary poisoned to answer 500s is
    caught by the SLO watch and rolled back with the fleet restored and
    the version held down — zero failed requests, zero mixed-version
    responses throughout. Every wait is on a count, with a deadline."""
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )

    x = np.arange(8, dtype=np.float32).reshape(2, 4) + 1.0
    refs = {"v1": x * 1.0, "v2": x * 2.0}
    servers = []

    def spawn_server():
        srv = ModelServer(_ScaledEcho(1.0), model_name="m",
                          queue_limit=256, device="cpu").start()
        srv.registry.register("m", _ScaledEcho(2.0), version="v2",
                              activate=False)
        servers.append(srv)
        return srv

    def kill(server):
        try:
            server._httpd.socket.close()
        except (OSError, AttributeError):
            pass   # already dead
        server.stop()

    fleet = [spawn_server() for _ in range(3)]
    urls = [f"http://127.0.0.1:{s.port}" for s in fleet]
    router = ReplicaRouter(
        urls, client_factory=lambda u: ModelClient(u, timeout=5.0))

    def factory():
        srv = spawn_server()
        return HttpReplica(f"http://127.0.0.1:{srv.port}",
                           on_retire=lambda: kill(srv))

    slo = SLOPolicy(max_error_rate=0.05, min_requests=5, window_s=0.3,
                    windows=2)
    controller = FleetController(
        [HttpReplica(u) for u in urls], router=router, slo=slo,
        replica_factory=factory, min_replicas=3, max_replicas=3,
        autoscale_interval_s=0.05, cooldown_s=1e9, holddown_s=60.0)

    stop = threading.Event()
    failures, poisoned, mixed, seen = [], [], [], []
    phase = ["clean"]
    lock = threading.Lock()

    def hammer():
        while not stop.is_set():
            try:
                r = router.predict(x, model="m")
            except ServingError as e:
                # the injected 500s (the router surfaces a 500 at once:
                # another replica would answer the same); a request
                # fired while armed may land just after the disarm
                with lock:
                    injected = (e.status, e.error_class) == (
                        500, "FaultInjectedError") and phase[0] != "clean"
                    (poisoned if injected else failures).append(
                        (e.status, e.error_class))
                continue
            except Exception as e:   # noqa: BLE001 - recorded, asserted 0
                with lock:
                    failures.append(repr(e))
                continue
            out = np.asarray(r["outputs"], np.float32)
            with lock:
                seen.append(r["version"])
                if not np.allclose(out, refs[r["version"]],
                                   rtol=1e-4, atol=1e-5):
                    mixed.append((r["version"], out))

    def wait_for(cond, what):
        deadline = time.monotonic() + 20.0
        while not cond():
            if time.monotonic() > deadline:
                pytest.fail(f"{what} never happened")
            time.sleep(0.01)

    def n_seen():
        with lock:
            return len(seen)

    threads = [threading.Thread(target=hammer, name=f"fleet-ham-{i}")
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        wait_for(lambda: n_seen() >= 20, "traffic")
        controller.start()

        # ---- replica SIGKILL analogue mid-soak
        dead_port = fleet[1].port
        kill(fleet[1])
        wait_for(lambda: len(router.urls()) == 3 and dead_port not in [
            int(u.rsplit(":", 1)[1]) for u in router.urls()], "backfill")
        n0 = n_seen()
        wait_for(lambda: n_seen() >= n0 + 20, "traffic on the new fleet")

        # ---- poisoned canary: every request answers 500 while armed
        # (the replicas share the process's injector and metrics), the
        # watch sees the error rate, the canary rolls back
        with lock:
            phase[0] = "poison"
        injector().inject("rollout.canary_poison", mode="raise",
                          at_hit=1, times=10 ** 9)
        try:
            report = controller.rollout("m", "v2")
        finally:
            injector().clear("rollout.canary_poison")
            with lock:
                phase[0] = "after"
        assert report["outcome"] == "rolled_back", report
        assert "error_rate" in report["breach"]["reason"]
        for h in controller.replicas:
            assert h.active_version("m") == "v1"
        with pytest.raises(RolloutHeldError):
            controller.rollout("m", "v2")
        n0 = n_seen()
        wait_for(lambda: n_seen() >= n0 + 20, "traffic after rollback")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        controller.stop()
        for s in servers:
            kill(s)

    # nothing failed but the injected 500s
    assert failures == [], f"requests failed: {failures[:5]}"
    assert poisoned
    assert mixed == [], f"mixed-version responses: {mixed[:3]}"
