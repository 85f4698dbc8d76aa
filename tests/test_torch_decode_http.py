"""Decode serving over HTTP in the port (parallel/serving.py's generate
route, serving/router.py's migration, serving/controller.py's fleet and
state durability) on the CPU: the 13 counterparts of the JAX package's
HTTP decode tests — tests/test_decode.py (the npz and JSON wires, 429 +
Retry-After, the /metrics scrape), tests/test_decode_durability.py (wire
continuation and the 504 partial, resume on disconnect, router
migration, the migrate_fail drill, a fleet kill), tests/test_journal.py
(cold restart on a journal_dir, total fleet loss, the controller's
hold-down ledger across a restart) and tests/test_trace.py (trace ids
over the wire, one merged timeline for a migrated generation, the TTFT
SLO clause).

Every stream is held bit for bit against `sequential_decode`, the
per-request oracle. Mid-generation drills slow the engine's loop with a
`decode.hang` delay (20 ms per iteration), so "stop after 3 tokens" lands
mid-stream with a wide margin instead of racing the engine.
"""

import json
import random
import threading
import time

import pytest

from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
from deeplearning4j_tpu_torch.observability import get_registry
from deeplearning4j_tpu_torch.observability.tracing import (
    Tracer,
    merge_chrome_traces,
    new_trace_id,
)
from deeplearning4j_tpu_torch.resilience import (
    RolloutHeldError,
    ServingError,
    injector,
)
from deeplearning4j_tpu_torch.resilience.retry import Retry
from deeplearning4j_tpu_torch.serving import continuous as tcont
from deeplearning4j_tpu_torch.serving import journal as tjournal
from deeplearning4j_tpu_torch.serving.continuous import (
    DecodeEngine,
    sequential_decode,
)
from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

pytestmark = pytest.mark.serving

VOCAB, CTX, SLOTS, PAGE = 64, 64, 4, 8


@pytest.fixture(autouse=True)
def _isolation():
    injector().clear()
    yield
    injector().clear()
    tcont.reap_stray_engines()
    tjournal.reap_stray_journals()


@pytest.fixture(scope="module")
def program():
    model = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=CTX, seed=3,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE)
    prog.warmup(prog.init_kv(), buckets=(8, 16, 32))
    return prog


def _slow_loop():
    """Each engine loop iteration sleeps 20 ms: a 40-token generation
    takes 0.8 s or more, so a stop after its 3rd token is mid-stream."""
    injector().inject("decode.hang", mode="delay", delay_s=0.02,
                      times=10 ** 9)


def _requests(n, seed=0, max_prompt=20, max_new=12):
    rng = random.Random(seed)
    return [([rng.randrange(VOCAB)
              for _ in range(rng.randrange(2, max_prompt))],
             rng.randrange(2, max_new)) for _ in range(n)]


def _oracle(program, reqs, eos=None):
    kv = program.init_kv()
    out = []
    for prompt, mx in reqs:
        kv, toks = sequential_decode(program, prompt, mx, eos_id=eos, kv=kv)
        out.append(toks)
    return out


def _spawn_decode_server(program, name="decoder"):
    from deeplearning4j_tpu_torch.parallel.serving import ModelServer

    eng = DecodeEngine(program=program)
    server = ModelServer(port=0, device="cpu", decode_engine=eng,
                         model_name=name).start()
    return server, eng


def _bare_controller(state_dir):
    from deeplearning4j_tpu_torch.serving import FleetController

    return FleetController([], min_replicas=0, max_replicas=0,
                           holddown_s=60.0, state_dir=state_dir)


def _spans(doc, name=None, trace=None):
    out = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        if name is not None and ev.get("name") != name:
            continue
        if trace is not None \
                and (ev.get("args") or {}).get("trace") != trace:
            continue
        out.append(ev)
    return out


# ---- counterpart of test_decode.py
def test_generate_over_http_npz_json_and_429(program):
    """ModelClient.generate end to end: npz wire (variable-length
    int32 token payload), JSON wire parity, oracle parity, /status
    decode facts, and 429 + Retry-After on slot exhaustion."""
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )

    eng = DecodeEngine(program=program, queue_limit=0)
    server = ModelServer(port=0, device="cpu", decode_engine=eng,
                         model_name="decoder").start()
    try:
        client = ModelClient(f"http://127.0.0.1:{server.port}",
                             breaker=None)
        prompt = [5, 9, 11, 2, 7]
        resp = client.generate(prompt, max_new_tokens=6,
                               model="decoder")
        _, oracle = sequential_decode(program, prompt, 6)
        assert resp["tokens"] == oracle
        assert resp["finish_reason"] == "length"
        jclient = ModelClient(f"http://127.0.0.1:{server.port}",
                              wire="json", breaker=None)
        jresp = jclient.generate(prompt, max_new_tokens=6,
                                 model="decoder")
        assert jresp["tokens"] == oracle
        # variable-length wire: an eos id cuts the returned array at
        # its first occurrence
        eos = oracle[2]
        expect = oracle[:oracle.index(eos) + 1]
        cut = client.generate(prompt, max_new_tokens=6, eos_id=eos,
                              model="decoder")
        assert cut["tokens"] == expect and len(cut["tokens"]) < 6
        assert cut["finish_reason"] == "eos"
        facts = client.status()
        assert facts["decode"]["decoder"]["completed"] >= 3
        assert facts["decode"]["decoder"]["max_slots"] == SLOTS
        # page-table occupancy replaced the misleading per-slot
        # max_ctx capacity: /status reports the real pool state
        pages = facts["decode"]["decoder"]["pages"]
        assert pages["total"] == SLOTS * (CTX // PAGE)
        assert 0 <= pages["free"] <= pages["total"]
        assert "max_ctx" not in facts["decode"]["decoder"]
        assert facts["decode"]["decoder"]["window"] == CTX
        # slot exhaustion: stop the loop, queue a long generation per
        # slot (queue_limit=0 -> capacity == max_slots; a stopped
        # engine holds them pending deterministically), then one more
        # request must bounce 429 with Retry-After — the handler's
        # lazy restart races 4x40 sequential decode dispatches and
        # always loses
        eng.stop()
        slow = [eng.submit([1, 2, 3], 40) for _ in range(SLOTS)]
        # a no-retry client: the default Retry treats 429 as "try
        # again later" and would paper over the shed once slots free
        oneshot = ModelClient(f"http://127.0.0.1:{server.port}",
                              breaker=None,
                              retry=Retry(max_attempts=1))
        with pytest.raises(ServingError) as ei:
            oneshot.generate(prompt, max_new_tokens=4, model="decoder")
        assert ei.value.status == 429
        assert ei.value.retry_after_s is not None
        assert ei.value.error_class == "QuotaExceededError"
        for h in slow:
            h.result(timeout_s=30.0)
        # capacity restored
        ok = client.generate(prompt, max_new_tokens=4, model="decoder")
        assert len(ok["tokens"]) == 4
        # unknown model -> 404
        with pytest.raises(ServingError) as e404:
            client.generate(prompt, max_new_tokens=2, model="absent")
        assert e404.value.status == 404
    finally:
        server.stop()
    # the server started the engine lazily, so it must stop it too
    assert not eng.running




# ---- counterpart of test_decode.py
def test_metrics_exposed_on_http_scrape(program):
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )

    eng = DecodeEngine(program=program)
    server = ModelServer(port=0, device="cpu", decode_engine=eng,
                         model_name="decoder").start()
    try:
        client = ModelClient(f"http://127.0.0.1:{server.port}",
                             breaker=None)
        client.generate([2, 4, 6], max_new_tokens=3, model="decoder")
        text = client.metrics_text()
        assert "dl4j_decode_tokens_total" in text
        assert "dl4j_decode_prefill_seconds_bucket" in text
    finally:
        server.stop()




# ---- counterpart of test_decode_durability.py
def test_wire_continuation_and_deadline_504(program):
    """The resume_tokens wire field end to end (npz and JSON wires),
    plus the 504/partial surface for an expired deadline."""
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    server, eng = _spawn_decode_server(program)
    try:
        url = f"http://127.0.0.1:{server.port}"
        client = ModelClient(url, breaker=None)
        prompt = [5, 9, 11, 2, 7]
        full = client.generate(prompt, max_new_tokens=8,
                               model="decoder")
        _, oracle = sequential_decode(program, prompt, 8)
        assert full["tokens"] == oracle and full["replays"] == 0
        resumed = client.generate(prompt, max_new_tokens=8,
                                  model="decoder",
                                  resume_tokens=oracle[:3])
        assert resumed["tokens"] == oracle
        assert resumed["replays"] >= 1
        jclient = ModelClient(url, wire="json", breaker=None)
        jresumed = jclient.generate(prompt, max_new_tokens=8,
                                    model="decoder",
                                    resume_tokens=oracle[:5])
        assert jresumed["tokens"] == oracle
        # expired deadline -> HTTP 504 whose body IS the partial
        # result; the client returns it as a normal dict
        late = client.generate(prompt, max_new_tokens=8,
                               model="decoder", deadline_s=0.0)
        assert late["finish_reason"] == "deadline"
        assert late["tokens"] == []
    finally:
        server.stop()
    assert not eng.running




# ---- counterpart of test_decode_durability.py
def test_client_resumes_on_disconnect_byte_identical(program):
    """ModelClient.generate resume-on-disconnect: the engine is torn
    down mid-generation (the replica-retiring path); the 503 carries
    the partial stream, the client re-issues it as a continuation, and
    the final tokens are bitwise equal to an uninterrupted call."""
    _slow_loop()
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    server, eng = _spawn_decode_server(program)
    try:
        client = ModelClient(f"http://127.0.0.1:{server.port}",
                             breaker=None, retry=Retry(max_attempts=1))
        prompt = [7, 3, 12, 5]
        _, oracle = sequential_decode(program, prompt, 40)
        box = {}

        def call():
            box["resp"] = client.generate(prompt, max_new_tokens=40,
                                          model="decoder",
                                          timeout_s=30.0)

        t = threading.Thread(target=call, name="durab-client")
        t.start()
        deadline = time.monotonic() + 10.0
        while eng.stats()["tokens_total"] < 3:
            assert time.monotonic() < deadline, "generation never began"
            time.sleep(0.002)
        eng.stop()    # mid-generation teardown; server stays up
        injector().clear("decode.hang")
        t.join(timeout=30.0)
        assert not t.is_alive()
        resp = box["resp"]
        assert resp["tokens"] == oracle
        assert resp["finish_reason"] == "length"
        assert resp["replays"] >= 1    # it really resumed, not reran
    finally:
        server.stop()




# ---- counterpart of test_decode_durability.py
@pytest.mark.chaos
def test_router_migrates_generation_across_replicas(program):
    """A replica retires mid-generation: ReplicaRouter.generate picks
    up the resumable 503 partial and re-dispatches it to the healthy
    replica as a continuation — bitwise equal to an uninterrupted run,
    with the migration counted."""
    _slow_loop()
    from deeplearning4j_tpu_torch.serving import ReplicaRouter

    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    reg = get_registry()
    m0 = reg.counter_value("dl4j_decode_migrations_total")
    sa, ea = _spawn_decode_server(program)
    sb, eb = _spawn_decode_server(program)
    try:
        router = ReplicaRouter(
            [f"http://127.0.0.1:{sa.port}",
             f"http://127.0.0.1:{sb.port}"],
            client_factory=lambda u: ModelClient(
                u, breaker=None, retry=Retry(max_attempts=1)))
        prompt = [8, 1, 13, 4]
        _, oracle = sequential_decode(program, prompt, 40)
        box = {}

        def call():
            box["resp"] = router.generate(prompt, max_new_tokens=40,
                                          model="decoder",
                                          timeout_s=30.0)

        t = threading.Thread(target=call, name="durab-router")
        t.start()
        # the fresh router picks replica A first (round-robin from 0);
        # retire it once its generation is visibly in flight
        deadline = time.monotonic() + 10.0
        while ea.stats()["tokens_total"] < 3:
            assert time.monotonic() < deadline, "A never took the call"
            time.sleep(0.002)
        sa.stop()     # graceful retire: resumable 503 + migration
        injector().clear("decode.hang")
        t.join(timeout=30.0)
        assert not t.is_alive()
        resp = box["resp"]
        assert resp["tokens"] == oracle
        assert resp["migrations"] == 1
        assert resp["replays"] >= 1
        assert reg.counter_value("dl4j_decode_migrations_total") \
            == m0 + 1
        # the continuation really landed on B
        assert eb.stats()["tokens_total"] > 0
    finally:
        sa.stop()
        sb.stop()




# ---- counterpart of test_decode_durability.py
@pytest.mark.chaos
def test_migrate_fail_drill_restarts_from_prompt(program):
    """serving.migrate_fail: the handoff itself fails, the router
    DROPS the tokens-so-far continuation and restarts from the prompt
    on the next replica — still byte-identical (greedy decode), still
    zero requests lost, zero migrations counted."""
    _slow_loop()
    from deeplearning4j_tpu_torch.serving import ReplicaRouter

    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    reg = get_registry()
    m0 = reg.counter_value("dl4j_decode_migrations_total")
    sa, ea = _spawn_decode_server(program)
    sb, _ = _spawn_decode_server(program)
    try:
        router = ReplicaRouter(
            [f"http://127.0.0.1:{sa.port}",
             f"http://127.0.0.1:{sb.port}"],
            client_factory=lambda u: ModelClient(
                u, breaker=None, retry=Retry(max_attempts=1)))
        injector().inject("serving.migrate_fail", mode="raise",
                          at_hit=1, times=5)
        prompt = [6, 2, 9]
        _, oracle = sequential_decode(program, prompt, 40)
        box = {}

        def call():
            box["resp"] = router.generate(prompt, max_new_tokens=40,
                                          model="decoder",
                                          timeout_s=30.0)

        t = threading.Thread(target=call, name="durab-migfail")
        t.start()
        deadline = time.monotonic() + 10.0
        while ea.stats()["tokens_total"] < 3:
            assert time.monotonic() < deadline, "A never took the call"
            time.sleep(0.002)
        sa.stop()
        injector().clear("decode.hang")
        t.join(timeout=30.0)
        assert not t.is_alive()
        resp = box["resp"]
        assert resp["tokens"] == oracle
        assert resp["migrations"] == 0     # the continuation was dropped
        assert injector().hits("serving.migrate_fail") >= 1
        assert reg.counter_value("dl4j_decode_migrations_total") == m0
    finally:
        sa.stop()
        sb.stop()




# ---- counterpart of test_decode_durability.py
@pytest.mark.chaos
def test_fleet_kill_mid_generation_loses_nothing(program):
    """The 3-replica fleet drill: one replica is hard-killed
    mid-generation while the FleetController watches. Every in-flight
    request finishes bitwise equal to its sequential oracle (migrated
    as a continuation or restarted from its prompt — both exact), the
    controller backfills to 3, and zero requests are lost."""
    _slow_loop()
    from deeplearning4j_tpu_torch.serving import (
        FleetController,
        HttpReplica,
        ReplicaRouter,
        SLOPolicy,
    )

    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    servers = []

    def spawn():
        server, _ = _spawn_decode_server(program)
        servers.append(server)
        return server

    def kill(server):
        try:
            server._httpd.socket.close()
        except (OSError, AttributeError):
            pass
        server.stop()

    fleet = [spawn() for _ in range(3)]
    urls = [f"http://127.0.0.1:{s.port}" for s in fleet]
    router = ReplicaRouter(
        urls, client_factory=lambda u: ModelClient(
            u, timeout=10.0, breaker=None, retry=Retry(max_attempts=1)))

    def factory():
        srv = spawn()
        return HttpReplica(f"http://127.0.0.1:{srv.port}",
                           on_retire=lambda: kill(srv))

    controller = FleetController(
        [HttpReplica(u, on_retire=lambda s=None: None) for u in urls],
        router=router, slo=SLOPolicy(min_requests=10 ** 9),
        replica_factory=factory, min_replicas=3, max_replicas=3,
        autoscale_interval_s=0.1, cooldown_s=1e9, holddown_s=60.0)

    reqs = _requests(6, seed=9, max_prompt=10, max_new=12)
    reqs = [(p, 30) for p, _ in reqs]        # long enough to straddle
    oracle = _oracle(program, reqs)
    results = [None] * len(reqs)
    errors = []

    def run(i):
        prompt, mx = reqs[i]
        try:
            results[i] = router.generate(prompt, max_new_tokens=mx,
                                         model="decoder",
                                         timeout_s=30.0)
        except Exception as e:   # noqa: BLE001 - recorded, asserted 0
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,),
                                name=f"durab-fleet-{i}")
               for i in range(len(reqs))]
    try:
        controller.start()
        for t in threads:
            t.start()
        # let generations get airborne, then kill a replica hard
        deadline = time.monotonic() + 10.0
        while sum(s.decode_engines["decoder"].stats()["tokens_total"]
                  for s in servers[:3]) < 6:
            assert time.monotonic() < deadline, "fleet never warmed"
            time.sleep(0.002)
        kill(fleet[0])
        injector().clear("decode.hang")
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        # zero lost, every stream exact
        assert errors == [], f"requests failed: {errors}"
        assert [r["tokens"] for r in results] == oracle
        # the controller backfilled the hole
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if len(router.urls()) == 3 and fleet[0].port not in [
                    int(u.rsplit(":", 1)[1]) for u in router.urls()]:
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"backfill never landed: {router.urls()}")
    finally:
        controller.stop()
        for s in servers:
            kill(s)




# ---- counterpart of test_journal.py
@pytest.mark.chaos
def test_server_journal_dir_cold_restart_http(program, tmp_path):
    """ModelServer(journal_dir=...): a hard server kill mid-generation
    loses nothing — a replacement server on the same directory
    recovers the stream, the client re-submits under the same
    request_id, and the bytes match the oracle. /status carries the
    journal facts."""
    _slow_loop()
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )

    jdir = str(tmp_path / "journal")
    prompt, mx = [5, 11, 2, 7], 30
    _, want = sequential_decode(program, prompt, mx)
    eng1 = DecodeEngine(program=program)
    srv1 = ModelServer(port=0, device="cpu", decode_engine=eng1,
                       model_name="decoder", journal_dir=jdir).start()
    client = ModelClient(f"http://127.0.0.1:{srv1.port}",
                         timeout=10.0, breaker=None,
                         retry=Retry(max_attempts=1))
    errors = []

    def run():
        try:
            client.generate(prompt, max_new_tokens=mx,
                            model="decoder", timeout_s=30.0,
                            max_resumes=0, request_id="http-drill-0")
        except Exception as e:  # noqa: BLE001 - the kill IS the test
            errors.append(repr(e))

    t = threading.Thread(target=run, name="journal-http-drill")
    t.start()
    deadline = time.monotonic() + 10.0
    while eng1.stats()["tokens_total"] < 2:
        assert time.monotonic() < deadline, "server never warmed"
        time.sleep(0.002)
    try:
        srv1._httpd.socket.close()
    except (OSError, AttributeError):
        pass
    srv1.stop()
    injector().clear("decode.hang")
    t.join(timeout=30.0)
    assert not t.is_alive()
    # ---- cold restart on the same journal directory
    eng2 = DecodeEngine(program=program)
    srv2 = ModelServer(port=0, device="cpu", decode_engine=eng2,
                       model_name="decoder", journal_dir=jdir).start()
    try:
        assert eng2.stats()["journal"]["recovered"] == 1
        client2 = ModelClient(f"http://127.0.0.1:{srv2.port}",
                              timeout=10.0, breaker=None,
                              retry=Retry(max_attempts=1))
        out = client2.generate(prompt, max_new_tokens=mx,
                               model="decoder", timeout_s=30.0,
                               request_id="http-drill-0")
        assert out["tokens"] == want
        assert out["request_id"] == "http-drill-0"
        facts = client2.status()
        jfacts = facts["journal"]["decoder"]
        assert jfacts["records"] >= 1
        assert jfacts["live"] == 0     # the stream drained to done
    finally:
        srv2.stop()




# ---- counterpart of test_journal.py
@pytest.mark.chaos
def test_total_fleet_loss_drill(program, tmp_path):
    """The headline drill: a 3-replica fleet, its router, and its
    controller ALL die mid-generation. Cold restart on the same
    journal directories + controller state_dir: clients re-submit
    under their original request ids, every stream completes bitwise
    equal to the oracle (zero lost), and the restarted controller
    still refuses the held-down build."""
    _slow_loop()
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )
    from deeplearning4j_tpu_torch.serving import (
        FleetController,
        HttpReplica,
        ReplicaRouter,
        SLOPolicy,
    )

    jdirs = [str(tmp_path / f"replica-{i}") for i in range(3)]
    state_dir = str(tmp_path / "controller")

    def spawn(i):
        eng = DecodeEngine(program=program)
        return ModelServer(port=0, device="cpu", decode_engine=eng,
                           model_name="decoder",
                           journal_dir=jdirs[i]).start()

    def kill(server):
        try:
            server._httpd.socket.close()
        except (OSError, AttributeError):
            pass
        server.stop()

    def make_router(urls):
        return ReplicaRouter(
            urls, client_factory=lambda u: ModelClient(
                u, timeout=10.0, breaker=None,
                retry=Retry(max_attempts=1)))

    def make_controller(urls, router):
        return FleetController(
            [HttpReplica(u, on_retire=lambda s=None: None)
             for u in urls],
            router=router, slo=SLOPolicy(min_requests=10 ** 9),
            min_replicas=3, max_replicas=3,
            autoscale_interval_s=1e9, cooldown_s=1e9,
            holddown_s=60.0, state_dir=state_dir)

    reqs = _requests(6, seed=31, max_prompt=10, max_new=12)
    reqs = [(p, 30) for p, _ in reqs]    # long enough to straddle
    oracle = _oracle(program, reqs)
    fleet = [spawn(i) for i in range(3)]
    urls = [f"http://127.0.0.1:{s.port}" for s in fleet]
    router = make_router(urls)
    controller = make_controller(urls, router)
    controller._enter_holddown("decoder", "v2", "canary breach")

    def run(router, i, results, errors):
        prompt, mx = reqs[i]
        try:
            results[i] = router.generate(
                prompt, max_new_tokens=mx, model="decoder",
                timeout_s=30.0, request_id=f"drill-{i}")
        except Exception as e:  # noqa: BLE001 - total loss IS the test
            errors.append((i, repr(e)))

    results = [None] * len(reqs)
    errors = []
    threads = [threading.Thread(target=run,
                                args=(router, i, results, errors),
                                name=f"journal-fleet-{i}")
               for i in range(len(reqs))]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while sum(s.decode_engines["decoder"].stats()["tokens_total"]
                  for s in fleet) < 6:
            assert time.monotonic() < deadline, "fleet never warmed"
            time.sleep(0.002)
        # ---- TOTAL fleet loss: controller, then every replica
        controller.stop()
        for s in fleet:
            kill(s)
        injector().clear("decode.hang")
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        for s in fleet:
            kill(s)
    # ---- cold restart: same journal dirs, same controller state
    fleet2 = [spawn(i) for i in range(3)]
    urls2 = [f"http://127.0.0.1:{s.port}" for s in fleet2]
    router2 = make_router(urls2)
    controller2 = make_controller(urls2, router2)
    try:
        # at least one replica journaled in-flight work and recovered
        assert sum(s.decode_engines["decoder"].stats()["journal"]
                   ["recovered"] for s in fleet2) >= 1
        # the hold-down ledger survived the restart
        with pytest.raises(RolloutHeldError):
            controller2._check_holddown("decoder", "v2")
        assert controller2.stats()["autoscaler"]["restored_target"] \
            == 3
        # zero lost: every request re-submitted by id completes exact
        results2 = [None] * len(reqs)
        errors2 = []
        threads2 = [threading.Thread(
            target=run, args=(router2, i, results2, errors2),
            name=f"journal-refleet-{i}") for i in range(len(reqs))]
        for t in threads2:
            t.start()
        for t in threads2:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads2)
        assert errors2 == [], f"requests failed: {errors2}"
        assert [r["tokens"] for r in results2] == oracle
    finally:
        controller2.stop()
        for s in fleet2:
            kill(s)




# ---- counterpart of test_journal.py
def test_controller_holddown_survives_restart(tmp_path):
    """FleetController(state_dir=...): the hold-down ledger and the
    autoscaler target persist with the journal's record framing, so a
    restarted controller refuses to re-canary a held build."""
    state = str(tmp_path / "state")
    c1 = _bare_controller(state)
    c1._enter_holddown("m", "v2", "slo breach")
    c1._enter_holddown("m", "v2", "slo breach again")  # exp backoff
    c2 = _bare_controller(state)
    with pytest.raises(RolloutHeldError) as exc:
        c2._check_holddown("m", "v2")
    assert exc.value.failures == 2
    c2._check_holddown("m", "v1")      # other versions stay deployable
    assert c2.stats()["autoscaler"]["restored_target"] == 0
    assert c2.stats()["state_path"] is not None
    # clearing the hold-down persists too
    c2.clear_holddown("m", "v2")
    c3 = _bare_controller(state)
    c3._check_holddown("m", "v2")      # no raise




# ---- counterpart of test_trace.py
def test_trace_propagates_over_http_and_status(program):
    """The wire carries the trace id next to request_id (npz meta and
    JSON body alike): the response echoes it, the server's span tree
    records it, and /status decode facts surface the latency quantiles
    + flight-recorder state."""
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )

    tracer = Tracer()
    eng = DecodeEngine(program=program)
    server = ModelServer(port=0, device="cpu", decode_engine=eng,
                         model_name="decoder", tracer=tracer).start()
    try:
        # the engine inherits the server's tracer
        assert eng.tracer is tracer
        client = ModelClient(f"http://127.0.0.1:{server.port}",
                             breaker=None)
        tid = new_trace_id()
        resp = client.generate([5, 9, 11], max_new_tokens=4,
                               model="decoder", trace=tid)
        assert resp["trace"] == tid
        # JSON wire: no caller id -> the server mints one and echoes it
        jclient = ModelClient(f"http://127.0.0.1:{server.port}",
                              wire="json", breaker=None)
        jresp = jclient.generate([5, 9, 11], max_new_tokens=4,
                                 model="decoder")
        assert jresp["trace"] and jresp["trace"] != tid
        doc = tracer.export_chrome_trace()
        assert _spans(doc, name="rpc.generate", trace=tid)
        assert _spans(doc, name="generate", trace=tid)
        assert len(_spans(doc, name="token", trace=tid)) == 4
        dec = client.status()["decode"]["decoder"]
        assert dec["latency"]["ttft_p99_s"] is not None
        assert dec["flight"]["capacity"] > 0
        assert dec["flight"]["dumps"] == 0
        assert dec["tracing"]["recorded"] > 0
    finally:
        server.stop()




# ---- counterpart of test_trace.py
def test_migrated_generation_merges_into_one_timeline(program):
    """The acceptance drill: a generation starts on replica A, A
    retires mid-flight, the router migrates the resumable partial to
    replica B — three trace docs (client + two replicas), ONE trace
    id, merged into one timeline whose legs are bound by "trace-leg"
    flow arrows, with per-token spans on both replicas."""
    _slow_loop()
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )
    from deeplearning4j_tpu_torch.serving import ReplicaRouter

    tr_client, tr_a, tr_b = Tracer(), Tracer(), Tracer()
    ea = DecodeEngine(program=program)
    eb = DecodeEngine(program=program)
    sa = ModelServer(port=0, device="cpu", decode_engine=ea,
                     model_name="decoder", tracer=tr_a).start()
    sb = ModelServer(port=0, device="cpu", decode_engine=eb,
                     model_name="decoder", tracer=tr_b).start()
    try:
        router = ReplicaRouter(
            [f"http://127.0.0.1:{sa.port}",
             f"http://127.0.0.1:{sb.port}"],
            client_factory=lambda u: ModelClient(
                u, breaker=None, retry=Retry(max_attempts=1)),
            tracer=tr_client)
        prompt = [8, 1, 13, 4]
        _, oracle = sequential_decode(program, prompt, 40)
        box = {}

        def call():
            box["resp"] = router.generate(prompt, max_new_tokens=40,
                                          model="decoder",
                                          timeout_s=30.0)

        t = threading.Thread(target=call, name="trace-migrate")
        t.start()
        deadline = time.monotonic() + 10.0
        while ea.stats()["tokens_total"] < 3:
            assert time.monotonic() < deadline, "A never took the call"
            time.sleep(0.002)
        sa.stop()     # graceful retire: resumable 503 + migration
        injector().clear("decode.hang")
        t.join(timeout=30.0)
        assert not t.is_alive()
        resp = box["resp"]
        assert resp["tokens"] == oracle   # tracing never costs bytes
        assert resp["migrations"] == 1
        tid = resp["trace"]
        assert tid
        # ---- each process exported its own doc; the merge is ONE story
        merged = merge_chrome_traces(
            [tr_client.export_chrome_trace(),
             tr_a.export_chrome_trace(),
             tr_b.export_chrome_trace()],
            labels=["client", "replica-a", "replica-b"])
        assert merged["otherData"]["merged_docs"] == 3
        spans = _spans(merged, trace=tid)
        pids = {ev["pid"] for ev in spans}
        assert len(pids) == 3             # client + both replicas
        # both replica legs decoded tokens under the one trace id
        tok_pids = {ev["pid"] for ev in spans if ev["name"] == "token"}
        assert len(tok_pids) == 2
        # the client doc shows one leg per replica attempt
        legs = [ev for ev in spans if ev["name"] == "client.leg"]
        assert sorted(ev["args"]["ok"] for ev in legs) == [False, True]
        # consecutive legs are bound by trace-leg flow arrows
        starts = [ev for ev in merged["traceEvents"]
                  if ev.get("ph") == "s" and ev["name"] == "trace-leg"
                  and ev["id"].startswith(f"trace.{tid}.")]
        finishes = [ev for ev in merged["traceEvents"]
                    if ev.get("ph") == "f" and ev["name"] == "trace-leg"
                    and ev["id"].startswith(f"trace.{tid}.")]
        assert len(starts) == 2 and len(finishes) == 2   # 3 legs
        assert all(ev.get("bp") == "e" for ev in finishes)
        assert {ev["id"] for ev in starts} \
            == {ev["id"] for ev in finishes}
        # the merged doc is a plain JSON document (Perfetto-loadable)
        json.dumps(merged)
    finally:
        sa.stop()
        sb.stop()




# ---- counterpart of test_trace.py
def test_slo_gates_on_ttft_p99():
    """slo_sample derives ttft_p99_s from the histogram bucket deltas;
    SLOPolicy's `ttft_p99<...` clause parses, round-trips through
    to_spec, and breaches on a slow sample."""
    from deeplearning4j_tpu_torch.serving.controller import (
        SLOPolicy,
        slo_sample,
    )

    prev = {"counters": {}, "gauges": {}, "histograms": {}}
    cur = {
        "counters": {"dl4j_serving_requests_total": {"": 100.0}},
        "gauges": {},
        "histograms": {
            'dl4j_decode_ttft_seconds{tenant="gold"}': {
                "count": 100,
                "buckets": {"0.05": 99, "+Inf": 1}},
        },
    }
    sample = slo_sample(prev, cur)
    assert sample["ttft_p99_s"] == pytest.approx(0.05)
    pol = SLOPolicy.parse("ttft_p99<40ms,min_requests=10")
    assert pol.max_ttft_p99_s == pytest.approx(0.04)
    assert "ttft_p99<40ms" in pol.to_spec()
    reason = pol.breach(sample, None)
    assert reason is not None and "ttft_p99" in reason
    assert SLOPolicy.parse("ttft_p99<60ms").breach(sample, None) is None
    # no ttft traffic in the window -> the clause stays quiet
    quiet = dict(sample, ttft_p99_s=None)
    assert pol.breach(quiet, None) is None


def test_decode_only_server_is_live_and_kept_by_the_controller(program):
    """A decode-only replica (an engine, no registered model) answers
    /healthz 200 while it is started — the JAX server answers 503 there
    — so a FleetController's health poll keeps it; after `stop` its
    liveness reads false."""
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient
    from deeplearning4j_tpu_torch.serving import (
        FleetController,
        HttpReplica,
    )

    server, _ = _spawn_decode_server(program)
    url = f"http://127.0.0.1:{server.port}"
    try:
        assert ModelClient(url, breaker=None).healthz()
        replica = HttpReplica(url)
        controller = FleetController([replica], min_replicas=1,
                                     max_replicas=1)
        controller.tick()
        assert controller.replicas == [replica]
        assert controller.stats()["autoscaler"]["deaths"] == 0
    finally:
        server.stop()
    assert not server._healthy()
