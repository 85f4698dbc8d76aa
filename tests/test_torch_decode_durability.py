"""Generation durability in the port (serving/continuous.py,
serving/flight.py) on the CPU: the counterparts of the in-process pins
of tests/test_decode_durability.py and of tests/test_trace.py's engine,
latency and flight-recorder pins.

  * slot QUARANTINE (`decode.nonfinite`): a poisoned slot is retired for
    good and its request replays on a healthy slot, bitwise equal to
    the un-faulted oracle; repeated poison aborts with
    GenerationPoisonedError;
  * decode WATCHDOG (`decode.hang`): engine teardown + bounded restart
    with every live request replayed bitwise, RestartsExhaustedError
    once the budget is spent;
  * DEADLINES and cancel finish with PARTIAL tokens and a reason;
  * resume_tokens continuations are bitwise equal to the uninterrupted
    run;
  * tracing spans, TTFT/ITL/queue-wait histograms, the flight recorder,
    the durability metrics and the dashboard lines.

The wire, router-migration and fleet drills wait for ROADMAP item 7.
"""

import os
import random
import signal
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
from deeplearning4j_tpu_torch.observability.metrics import (
    REGISTERED_METRICS,
    get_registry,
)
from deeplearning4j_tpu_torch.observability.tracing import Tracer
from deeplearning4j_tpu_torch.resilience.errors import (
    GenerationPoisonedError,
    RestartsExhaustedError,
)
from deeplearning4j_tpu_torch.resilience.faults import (
    REGISTERED_POINTS,
    injector,
)
from deeplearning4j_tpu_torch.serving import continuous as tcont
from deeplearning4j_tpu_torch.serving import journal as tjournal
from deeplearning4j_tpu_torch.serving.continuous import (
    DecodeEngine,
    sequential_decode,
)
from deeplearning4j_tpu_torch.serving.flight import (
    FlightRecorder,
    install_signal_dump,
    load_dump,
    reap_stray_flight_dumps,
)
from deeplearning4j_tpu_torch.serving.journal import GenerationJournal
from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

pytestmark = pytest.mark.serving

VOCAB, CTX, SLOTS, PAGE = 64, 64, 4, 8


@pytest.fixture(autouse=True)
def _isolation():
    injector().clear()
    saved = (signal.getsignal(signal.SIGUSR2)
             if hasattr(signal, "SIGUSR2") else None)
    yield
    injector().clear()
    tcont.reap_stray_engines()
    tjournal.reap_stray_journals()
    reap_stray_flight_dumps()
    if saved is not None:
        signal.signal(signal.SIGUSR2, saved)


@pytest.fixture(scope="module")
def program():
    model = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=CTX, seed=3,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE)
    kv = prog.init_kv()
    prog.warmup(kv, buckets=(8, 16, 32))
    return prog


def _requests(n, seed=0, max_prompt=20, max_new=12):
    rng = random.Random(seed)
    return [([rng.randrange(VOCAB)
              for _ in range(rng.randrange(2, max_prompt))],
             rng.randrange(2, max_new)) for _ in range(n)]


def _oracle(program, reqs, eos=None):
    kv = program.init_kv()
    out = []
    for prompt, mx in reqs:
        kv, toks = sequential_decode(program, prompt, mx, eos_id=eos,
                                     kv=kv)
        out.append(toks)
    return out


def _drive_churn(program, reqs, stagger=2, eos=None, queue_limit=64,
                 max_prefills_per_step=2, max_steps=2000, **engine_kw):
    eng = DecodeEngine(program=program, queue_limit=queue_limit,
                       max_prefills_per_step=max_prefills_per_step,
                       **engine_kw)
    handles = []
    i = 0
    steps = 0
    while i < len(reqs) or any(not h.done for h in handles):
        if i < len(reqs) and steps % stagger == 0:
            prompt, mx = reqs[i]
            handles.append(eng.submit(prompt, mx, eos_id=eos))
            i += 1
        eng.step_once()
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return eng, handles


def _drive(eng, handles, max_steps=2000):
    steps = 0
    while any(not h.done for h in handles):
        eng.step_once()
        steps += 1
        assert steps < max_steps, "engine made no progress"


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


# ======================================================== registry pins
def test_durability_registry_names():
    """Every durability fault point and metric is registered under its
    canonical literal name (the conformance pass cross-checks these
    against fire()/emission sites)."""
    assert {"decode.nonfinite", "decode.hang",
            "serving.migrate_fail"} <= REGISTERED_POINTS
    # dl4j_decode_migrations_total is the router's (ROADMAP item 7)
    assert {"dl4j_decode_slot_quarantines_total",
            "dl4j_decode_replays_total",
            "dl4j_decode_deadline_expired_total",
            "dl4j_decode_engine_restarts_total",
            "dl4j_decode_ttft_seconds",
            "dl4j_decode_itl_seconds",
            "dl4j_decode_queue_wait_seconds",
            "dl4j_decode_flight_dumps_total"} \
        <= set(REGISTERED_METRICS)


# ===================================================== slot quarantine
@pytest.mark.chaos
def test_nonfinite_quarantine_byte_identical(program):
    """decode.nonfinite forces a poison verdict mid-soak: the slot is
    quarantined (never reused), the request replays on a healthy slot,
    and every output stays bitwise equal to the un-faulted oracle."""
    reqs = _requests(10, seed=7)
    oracle = _oracle(program, reqs)
    reg = get_registry()
    q0 = reg.counter_value("dl4j_decode_slot_quarantines_total")
    r0 = reg.counter_value("dl4j_decode_replays_total")
    inj = injector()
    inj.inject("decode.nonfinite", mode="raise", at_hit=4, times=1)
    inj.inject("decode.nonfinite", mode="raise", at_hit=11, times=1)
    eng, handles = _drive_churn(program, reqs, stagger=2)
    assert [h.result(timeout_s=0) for h in handles] == oracle
    stats = eng.stats()
    assert stats["quarantines"] == 2
    assert stats["quarantined_slots"] == 2
    assert stats["replays"] >= 2
    # quarantined slots are scratched for good
    assert not eng._active[eng._quarantined].any()
    assert reg.counter_value("dl4j_decode_slot_quarantines_total") \
        == q0 + 2
    assert reg.counter_value("dl4j_decode_replays_total") >= r0 + 2


@pytest.mark.chaos
def test_repeated_poison_aborts_with_typed_error(program):
    """Poison that travels WITH the request (every replay strikes
    again) aborts with GenerationPoisonedError after
    poison_strike_limit strikes — it must not quarantine the whole
    batch slot by slot."""
    eng = DecodeEngine(program=program, poison_strike_limit=2)
    injector().inject("decode.nonfinite", mode="raise", at_hit=1,
                      times=50)
    h = eng.submit([3, 1, 4, 1, 5], 8)
    for _ in range(60):
        if h.done:
            break
        eng.step_once()
    assert h.done
    with pytest.raises(GenerationPoisonedError) as ei:
        h.result(timeout_s=0)
    assert ei.value.strikes == 3
    assert h.finish_reason is None
    stats = eng.stats()
    assert stats["quarantined_slots"] == 3
    assert stats["active_slots"] == 0 and stats["pending"] == 0
    # the one healthy slot still serves — and quarantined slots are
    # never offered to admission again
    injector().clear("decode.nonfinite")
    prompt = [9, 2, 7]
    _, expect = sequential_decode(program, prompt, 5)
    h2 = eng.submit(prompt, 5)
    eng.step_once()
    assert list(np.flatnonzero(eng._active)) == [3]
    while not h2.done:
        eng.step_once()
    assert h2.result(timeout_s=0) == expect


# ================================================== deadlines + cancel
def test_deadline_finishes_partial_with_reason(program):
    """An expired submit deadline frees the slot at the next step
    boundary and finishes the handle with its PARTIAL tokens and
    finish_reason='deadline'; the metric counts it."""
    reg = get_registry()
    d0 = reg.counter_value("dl4j_decode_deadline_expired_total")
    eng = DecodeEngine(program=program)
    h = eng.submit([1, 2, 3, 4], 30, deadline_s=0.05)
    eng.step_once()
    eng.step_once()
    got_mid = h.tokens_so_far()
    assert 0 < len(got_mid) < 30
    time.sleep(0.06)
    eng.step_once()
    assert h.done and h.finish_reason == "deadline"
    assert h.result(timeout_s=0) == got_mid   # partial, not lost
    assert eng.stats()["active_slots"] == 0
    assert eng.stats()["deadline_expired"] == 1
    # a deadline that expires while still PENDING finishes empty
    h2 = eng.submit([5, 6], 4, deadline_s=0.0)
    eng.step_once()
    assert h2.finish_reason == "deadline" and h2.result(timeout_s=0) == []
    assert reg.counter_value("dl4j_decode_deadline_expired_total") \
        == d0 + 2


def test_cancel_frees_slot_and_returns_partial(program):
    eng = DecodeEngine(program=program)
    h = eng.submit([2, 7, 1], 30)
    eng.step_once()
    eng.step_once()
    partial = h.tokens_so_far()
    assert partial
    h.cancel()
    eng.step_once()
    assert h.done and h.finish_reason == "cancelled"
    assert h.result(timeout_s=0) == partial
    assert eng.stats()["cancelled"] == 1
    assert eng.stats()["active_slots"] == 0


# ============================================ watchdog + engine restart
@pytest.mark.chaos
def test_watchdog_restart_recovers_live_requests(program):
    """decode.hang wedges the loop thread; the StepWatchdog escalates
    to engine teardown + restart, and every live request is recovered
    via replay — outputs bitwise equal to the un-faulted oracle."""
    reqs = _requests(3, seed=8, max_prompt=12, max_new=12)
    oracle = _oracle(program, reqs)
    reg = get_registry()
    rs0 = reg.counter_value("dl4j_decode_engine_restarts_total")
    injector().inject("decode.hang", mode="delay", delay_s=1.5,
                      at_hit=3, times=1)
    eng = DecodeEngine(program=program, watchdog_timeout_s=0.25,
                       max_engine_restarts=3)
    eng.start()
    try:
        handles = [eng.submit(p, mx) for p, mx in reqs]
        got = [h.result(timeout_s=30.0) for h in handles]
        assert got == oracle
        assert eng.stats()["engine_restarts"] == 1
        assert reg.counter_value("dl4j_decode_engine_restarts_total") \
            == rs0 + 1
    finally:
        eng.stop()
    # teardown is clean: no loop/zombie thread survives stop()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("DecodeEngine-loop")
                and t.is_alive()]


@pytest.mark.chaos
def test_restart_budget_exhausted_fails_loudly(program):
    """Once max_engine_restarts is spent, live + pending requests fail
    with RestartsExhaustedError instead of wedging forever."""
    injector().inject("decode.hang", mode="delay", delay_s=1.0,
                      at_hit=1, times=5)
    eng = DecodeEngine(program=program, watchdog_timeout_s=0.2,
                       max_engine_restarts=0)
    eng.start()
    try:
        h = eng.submit([4, 2], 6)
        with pytest.raises(RestartsExhaustedError):
            h.result(timeout_s=10.0)
    finally:
        eng.stop()


# =========================================== continuation (engine-level)
def test_resume_tokens_continuation_byte_identical(program):
    """submit(resume_tokens=...) re-enters a stream whose earlier life
    ran elsewhere: re-prefill + forced replay, then greedy
    continuation — bitwise equal to the uninterrupted run, from every
    cut point."""
    prompt = [11, 3, 9, 14, 2]
    _, full = sequential_decode(program, prompt, 10)
    for cut in (1, 4, 9):
        eng = DecodeEngine(program=program)
        h = eng.submit(prompt, 10, resume_tokens=full[:cut])
        while not h.done:
            eng.step_once()
        assert h.result(timeout_s=0) == full
        assert h.replays >= 1
    # resume at the budget boundary finishes immediately
    eng = DecodeEngine(program=program)
    h = eng.submit(prompt, 10, resume_tokens=full)
    assert h.done and h.finish_reason == "length"
    assert h.result(timeout_s=0) == full
    # a resume stream that already hit eos finishes as eos
    eos = full[5]
    h = eng.submit(prompt, 10, eos_id=eos,
                   resume_tokens=full[:full.index(eos) + 1])
    assert h.done and h.finish_reason == "eos"



# ================================================== engine-level tracing
def test_engine_spans_and_trace_id_minting(program):
    """An engine with a tracer mints a trace id per generation and
    records the whole span tree: root `generate` span, admission wait,
    prefill chunks, and one `token` record per decoded token — all
    carrying the trace id in args."""
    tracer = Tracer()
    eng = DecodeEngine(program=program, tracer=tracer)
    h = eng.submit([5, 9, 11, 2], max_new_tokens=6, tenant="gold")
    _drive(eng, [h])
    assert h.trace and len(h.trace) == 16
    doc = tracer.export_chrome_trace()
    gen = _spans(doc, name="generate", trace=h.trace)
    assert len(gen) == 1
    assert gen[0]["args"]["tenant"] == "gold"
    assert gen[0]["args"]["finish_reason"] == "length"
    toks = _spans(doc, name="token", trace=h.trace)
    assert len(toks) == 6
    assert toks[0]["args"].get("first") is True
    assert _spans(doc, name="admission_wait", trace=h.trace)
    assert _spans(doc, name="prefill_chunk", trace=h.trace)
    # a caller-supplied id wins over minting
    h2 = eng.submit([1, 2, 3], max_new_tokens=2,
                    trace="cafe0000cafe0000")
    _drive(eng, [h2])
    assert h2.trace == "cafe0000cafe0000"
    assert _spans(tracer.export_chrome_trace(), name="token",
                  trace="cafe0000cafe0000")


def test_latency_histograms_observed_without_tracer(program):
    """TTFT/ITL/queue-wait attribution is NOT gated on the tracer:
    a plain engine still observes the tenant-labeled histograms, and
    stats() surfaces the engine-local p50/p99 rings plus the program's
    dispatch tally."""
    reg = get_registry()

    def counts():
        hists = reg.snapshot()["histograms"]
        return tuple(
            hists.get(f'{name}{{tenant="gold"}}', {}).get("count", 0)
            for name in ("dl4j_decode_ttft_seconds",
                         "dl4j_decode_itl_seconds",
                         "dl4j_decode_queue_wait_seconds"))

    before = counts()
    eng = DecodeEngine(program=program)
    assert eng.tracer is None
    h = eng.submit([3, 1, 4, 1, 5], max_new_tokens=5, tenant="gold")
    _drive(eng, [h])
    after = counts()
    assert after[0] == before[0] + 1          # one first token
    assert after[1] == before[1] + 4          # 4 inter-token gaps
    assert after[2] == before[2] + 1          # one placement
    lat = eng.stats()["latency"]
    for key in ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
                "queue_wait_p50_s", "queue_wait_p99_s"):
        assert lat[key] is not None and lat[key] >= 0.0
    disp = eng.stats()["dispatches"]
    assert disp["step"] > 0 and disp["chunk"] > 0


def test_journal_recovery_leg_carries_trace_id(program, tmp_path):
    """Cold-restart continuity: the trace id is journaled with the
    admitted record, so the recovery leg on a fresh engine rejoins the
    original timeline under the SAME id (and the recovered stream
    stays bitwise equal to the oracle)."""
    jdir = str(tmp_path / "journal")
    prompt, mx = [5, 11, 2, 7], 20
    _, want = sequential_decode(program, prompt, mx)
    j1 = GenerationJournal(jdir, fsync_interval_s=0.0)
    eng1 = DecodeEngine(program=program, tracer=Tracer(), journal=j1)
    h1 = eng1.submit(prompt, mx, request_id="trace-drill-0")
    tid = h1.trace
    assert tid
    for _ in range(6):          # a few tokens, then the crash
        eng1.step_once()
    assert not h1.done
    eng1.stop()                 # hard stop: the request is still live
    j1.close()
    # ---- cold restart on the same directory
    j2 = GenerationJournal(jdir, fsync_interval_s=0.0)
    assert "trace-drill-0" in j2.live()
    assert j2.live()["trace-drill-0"]["trace"] == tid
    tr2 = Tracer()
    eng2 = DecodeEngine(program=program, tracer=tr2)
    eng2.attach_journal(j2, recover=True)
    # the idempotent re-submit joins the recovered stream
    h2 = eng2.submit(prompt, mx, request_id="trace-drill-0")
    assert h2.trace == tid
    _drive(eng2, [h2])
    assert h2.result(timeout_s=0) == want
    assert _spans(tr2.export_chrome_trace(), name="token", trace=tid)
    j2.close()


# ====================================================== flight recorder
def test_flight_recorder_ring_dump_and_reap(tmp_path):
    """The ring is bounded, the dump is an atomic JSON document, and
    the module-level reaper removes every dump it wrote."""
    rec = FlightRecorder(capacity=16, dump_dir=str(tmp_path),
                         name="ringtest")
    for i in range(40):
        rec.note("join", i, slot=i % 4)
    assert rec.stats()["events"] == 16            # bounded
    assert rec.events()[0]["step"] == 24          # oldest dropped
    path = rec.dump("unit")
    assert path is not None and os.path.exists(path)
    doc = load_dump(path)
    assert doc["name"] == "ringtest"
    assert doc["reason"] == "unit"
    assert len(doc["events"]) == 16
    assert doc["events"][-1] == {
        "t_s": doc["events"][-1]["t_s"], "step": 39, "kind": "join",
        "slot": 3}
    assert rec.stats() == {"events": 16, "capacity": 16, "dumps": 1,
                           "last_dump": path, "last_reason": "unit"}
    # no half-written dump can masquerade as a whole one
    assert not [p for p in os.listdir(str(tmp_path))
                if p.endswith(".tmp")]
    reap_stray_flight_dumps()
    assert not os.path.exists(path)


def test_quarantine_dumps_flight_recorder(program, tmp_path):
    """A slot quarantine (decode.nonfinite) flags a dump reason under
    the step lock; step_once writes the postmortem AFTER releasing it,
    and the dump tells the quarantine story (join/chunk/quarantine
    events) with the metric counted."""
    reg = get_registry()
    d0 = reg.counter_value("dl4j_decode_flight_dumps_total",
                           labels={"reason": "quarantine"})
    injector().inject("decode.nonfinite", mode="raise", at_hit=3,
                      times=1)
    eng = DecodeEngine(program=program, flight_dir=str(tmp_path))
    rng = random.Random(11)
    reqs = [([rng.randrange(VOCAB) for _ in range(4)], 6)
            for _ in range(4)]
    oracle = []
    for p, mx in reqs:
        _, toks = sequential_decode(program, p, mx)
        oracle.append(toks)
    handles = [eng.submit(p, mx) for p, mx in reqs]
    _drive(eng, handles)
    assert [h.result(timeout_s=0) for h in handles] == oracle
    flight = eng.stats()["flight"]
    assert flight["dumps"] == 1
    assert flight["last_reason"] == "quarantine"
    doc = load_dump(flight["last_dump"])
    kinds = {ev["kind"] for ev in doc["events"]}
    assert "quarantine" in kinds and "join" in kinds
    assert reg.counter_value("dl4j_decode_flight_dumps_total",
                             labels={"reason": "quarantine"}) == d0 + 1


def test_sigusr2_dumps_live_recorders(tmp_path):
    """install_signal_dump: kill -USR2 is the live-postmortem path —
    every live recorder dumps with reason "sigusr2"; the previous
    handler is chained (and restored afterwards)."""
    if not hasattr(signal, "SIGUSR2"):
        pytest.skip("no SIGUSR2 on this platform")
    rec = FlightRecorder(capacity=8, dump_dir=str(tmp_path),
                         name="sigtest")
    rec.note("join", 1, slot=0)
    chained = []
    signal.signal(signal.SIGUSR2, lambda s, f: chained.append(s))
    install_signal_dump()
    os.kill(os.getpid(), signal.SIGUSR2)
    deadline = time.monotonic() + 5.0
    while rec.stats()["dumps"] < 1:
        assert time.monotonic() < deadline, "signal dump never landed"
        time.sleep(0.01)
    assert rec.stats()["last_reason"] == "sigusr2"
    assert chained == [signal.SIGUSR2]       # previous handler chained
    assert load_dump(rec.stats()["last_dump"])["events"]


def test_dashboard_decode_latency_line():
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    snapshot = {
        "counters": {},
        "gauges": {},
        "histograms": {
            'dl4j_decode_ttft_seconds{tenant="gold"}': {
                "count": 4, "sum": 0.08, "p50": 0.010, "p99": 0.050},
            'dl4j_decode_ttft_seconds{tenant="bronze"}': {
                "count": 2, "sum": 0.30, "p50": 0.020, "p99": 0.200},
            'dl4j_decode_itl_seconds{tenant="gold"}': {
                "count": 40, "sum": 0.08, "p50": 0.002, "p99": 0.004},
            'dl4j_decode_queue_wait_seconds{tenant="gold"}': {
                "count": 4, "sum": 0.006, "p50": 0.001, "p99": 0.0015},
        },
    }
    lines = telemetry_lines(snapshot)
    lat = [l for l in lines if l.startswith("decode latency — ")]
    # worst label set per quantile: bronze's ttft dominates gold's
    assert lat == [
        "decode latency — ttft p50 20.0ms p99 200.0ms · "
        "itl p50 2.0ms p99 4.0ms · queue wait p99 1.5ms"]
    # quiet domain -> no line
    assert not [l for l in telemetry_lines(
        {"counters": {}, "gauges": {}, "histograms": {}})
        if l.startswith("decode latency")]


# ================================================== dashboard + stats
def test_dashboard_decode_resilience_line():
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    snapshot = {
        "counters": {
            "dl4j_decode_slot_quarantines_total": {(): 2.0},
            "dl4j_decode_migrations_total": {(): 1.0},
            "dl4j_decode_engine_restarts_total": {(): 1.0},
            "dl4j_decode_deadline_expired_total": {(): 3.0},
        },
        "gauges": {},
        "histograms": {},
    }
    lines = telemetry_lines(snapshot)
    resil = [l for l in lines if l.startswith("decode resilience — ")]
    assert resil == [
        "decode resilience — 2 quarantines · 1 migrations · "
        "1 engine restarts · 3 deadline expiries"]
    # quiet domain -> no line
    assert not [l for l in telemetry_lines({"counters": {}})
                if l.startswith("decode resilience")]


def test_stats_surface_durability_counters(program):
    eng = DecodeEngine(program=program)
    stats = eng.stats()
    for key in ("quarantined_slots", "quarantines", "replays",
                "deadline_expired", "cancelled", "engine_restarts"):
        assert stats[key] == 0
