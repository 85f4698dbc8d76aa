"""The port's write-ahead generation journal and cold-restart recovery
(serving/journal.py + serving/continuous.py) on the CPU: the
counterparts of the in-process pins of tests/test_journal.py.

  * WRITE-AHEAD framing (`<u32 len><sha256><canonical json>`), torn-tail
    truncation (`journal.write_torn`, `journal.recover_corrupt`);
  * GROUP fsync and `journal.fsync_fail` degradation;
  * COMPACTION never drops a live request, and a kill at any stage of
    it recovers the same live set;
  * COLD-RESTART recovery bitwise equal to the sequential oracle, with
    idempotent re-submits;
  * the journal metrics and the dashboard line.

The HTTP cold-restart drills and FleetController's state_dir wait for
ROADMAP item 7.
"""

import os
import random

import pytest

from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
from deeplearning4j_tpu_torch.observability.metrics import (
    REGISTERED_METRICS,
    get_registry,
)
from deeplearning4j_tpu_torch.resilience.errors import QuotaExceededError
from deeplearning4j_tpu_torch.resilience.faults import (
    REGISTERED_POINTS,
    injector,
)
from deeplearning4j_tpu_torch.serving import continuous as tcont
from deeplearning4j_tpu_torch.serving import flight as tflight
from deeplearning4j_tpu_torch.serving import journal as tjournal
from deeplearning4j_tpu_torch.serving.continuous import (
    DecodeEngine,
    sequential_decode,
)
from deeplearning4j_tpu_torch.serving.journal import (
    GenerationJournal,
    frame_record,
    read_records,
    write_records,
)
from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

pytestmark = [pytest.mark.serving, pytest.mark.journal]

VOCAB, CTX, SLOTS, PAGE = 64, 64, 4, 8


@pytest.fixture(autouse=True)
def _isolation():
    injector().clear()
    yield
    injector().clear()
    tcont.reap_stray_engines()
    tjournal.reap_stray_journals()
    tflight.reap_stray_flight_dumps()


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


def _segments(directory):
    return sorted(os.path.join(directory, n)
                  for n in os.listdir(directory)
                  if n.startswith("seg-") and n.endswith(".wal"))


# ======================================================== registry pins
def test_journal_registry_names():
    """Every journal fault point and metric is registered under its
    canonical literal name (the conformance pass cross-checks these
    against fire()/emission sites)."""
    assert {"journal.write_torn", "journal.fsync_fail",
            "journal.recover_corrupt"} <= REGISTERED_POINTS
    assert {"dl4j_journal_records_total",
            "dl4j_journal_fsyncs_total",
            "dl4j_journal_torn_tails_total",
            "dl4j_journal_recovered_requests_total",
            "dl4j_journal_compactions_total",
            "dl4j_journal_bytes",
            "dl4j_journal_live"} <= set(REGISTERED_METRICS)


# ================================================== framing + recovery
def test_record_framing_roundtrip(tmp_path):
    """Appends survive a clean close/reopen exactly: the live set,
    progress deltas, and terminal states replay from disk, and the
    on-disk bytes are the canonical frames end to end."""
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    j.append_admitted("a", [1, 2, 3], 8, eos_id=5, tenant="t0")
    j.record_progress("a", [7])
    j.record_progress("a", [7, 9])     # delta: only token 9 appended
    j.append_admitted("b", [4, 5], 4)
    j.append_done("b", "eos")
    # idempotent re-appends are no-ops
    j.append_admitted("a", [1, 2, 3], 8)
    j.record_progress("a", [7, 9])
    j.append_done("b", "eos")
    stats = j.stats()
    assert stats["records"] == 5
    assert stats["live"] == 1 and stats["done"] == 1
    j.close()
    # the head segment is a pure prefix of valid frames
    segs = _segments(d)
    assert len(segs) == 1
    records, valid, total = read_records(segs[0])
    assert valid == total and len(records) == 5
    # cold reopen replays the same state
    j2 = GenerationJournal(d, fsync_interval_s=0)
    assert j2.stats()["torn_tails"] == 0
    live = j2.live()
    assert set(live) == {"a"}
    assert live["a"]["prompt"] == [1, 2, 3]
    assert live["a"]["tokens"] == [7, 9]
    assert live["a"]["eos_id"] == 5 and live["a"]["tenant"] == "t0"
    j2.close()


def test_torn_tail_truncation_recovers_prefix(tmp_path):
    """A torn tail — garbage past the last valid frame, or a frame cut
    mid-record — is truncated in place and the valid prefix recovers
    exactly (dl4j_journal_torn_tails_total counts the repair)."""
    reg = get_registry()
    t0 = reg.counter_value("dl4j_journal_torn_tails_total")
    # scenario 1: garbage appended past the last frame
    d1 = str(tmp_path / "garbage")
    j = GenerationJournal(d1, fsync_interval_s=0)
    j.append_admitted("a", [1, 2], 6)
    j.record_progress("a", [3])
    j.close()
    seg = _segments(d1)[0]
    good = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(b"\x07torn-write-garbage")
    j2 = GenerationJournal(d1, fsync_interval_s=0)
    assert j2.stats()["torn_tails"] == 1
    assert os.path.getsize(seg) == good          # truncated in place
    assert j2.live()["a"]["tokens"] == [3]
    j2.close()
    # scenario 2: the LAST frame is cut mid-record -> prefix survives
    d2 = str(tmp_path / "cut")
    j = GenerationJournal(d2, fsync_interval_s=0)
    j.append_admitted("a", [1, 2], 6)
    j.append_admitted("b", [9, 9], 4)
    j.close()
    seg = _segments(d2)[0]
    first = len(frame_record({"kind": "admitted", "id": "a",
                              "prompt": [1, 2],
                              "max_new_tokens": 6}))
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 3)
    j2 = GenerationJournal(d2, fsync_interval_s=0)
    assert j2.stats()["torn_tails"] == 1
    assert set(j2.live()) == {"a"}               # b's record was torn
    assert os.path.getsize(seg) == first
    j2.close()
    assert reg.counter_value("dl4j_journal_torn_tails_total") == t0 + 2


@pytest.mark.chaos
def test_write_torn_fault_drill(tmp_path):
    """journal.write_torn (truncate mode) mauls the head segment right
    after an append — the crash-during-write drill. Recovery truncates
    back to the last whole record and loses ONLY the torn one."""
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    j.append_admitted("a", [1, 2], 6)
    j.record_progress("a", [3])
    seg = _segments(d)[0]
    good = os.path.getsize(seg)
    # the NEXT append gets its tail torn 4 bytes in
    injector().inject("journal.write_torn", mode="truncate",
                      truncate_to=good + 4, at_hit=1, times=1)
    j.append_admitted("b", [5, 5, 5], 4)
    j.close()
    assert injector().hits("journal.write_torn") >= 1
    j2 = GenerationJournal(d, fsync_interval_s=0)
    assert j2.stats()["torn_tails"] == 1
    assert set(j2.live()) == {"a"}
    assert j2.live()["a"]["tokens"] == [3]
    assert os.path.getsize(seg) == good
    j2.close()


@pytest.mark.chaos
def test_fsync_fail_degrades_without_data_loss(tmp_path):
    """journal.fsync_fail makes the group commit fail: the failure is
    counted, the bytes stay pending, serving continues, and the next
    healthy flush lands everything."""
    injector().inject("journal.fsync_fail", mode="raise",
                      at_hit=1, times=2)
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    j.append_admitted("a", [1], 4)     # fsync attempt fails
    j.record_progress("a", [2])        # fails again
    f0 = j.stats()["fsyncs"]
    j.append_done("a", "eos")          # fault exhausted -> lands
    stats = j.stats()
    assert stats["fsync_failures"] == 2
    assert stats["fsyncs"] == f0 + 1
    j.close()
    j2 = GenerationJournal(d, fsync_interval_s=0)
    assert j2.stats()["done"] == 1 and j2.stats()["live"] == 0
    j2.close()


@pytest.mark.chaos
def test_recover_corrupt_fault_truncates_at_bad_record(tmp_path):
    """journal.recover_corrupt poisons the Nth record during the
    recovery scan: everything before it replays, everything from it on
    is truncated away — the deterministic bit-rot drill."""
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    j.append_admitted("a", [1, 2], 6)
    j.append_admitted("b", [3], 4)
    j.record_progress("b", [9])
    j.close()
    seg = _segments(d)[0]
    injector().inject("journal.recover_corrupt", mode="raise",
                      at_hit=3, times=1)
    j2 = GenerationJournal(d, fsync_interval_s=0)
    assert j2.stats()["torn_tails"] == 1
    live = j2.live()
    assert set(live) == {"a", "b"}
    assert live["b"]["tokens"] == []   # the progress record was "rot"
    kept = (len(frame_record({"kind": "admitted", "id": "a",
                              "prompt": [1, 2], "max_new_tokens": 6}))
            + len(frame_record({"kind": "admitted", "id": "b",
                                "prompt": [3], "max_new_tokens": 4})))
    assert os.path.getsize(seg) == kept
    j2.close()
    # with the fault gone the truncated journal reopens clean
    j3 = GenerationJournal(d, fsync_interval_s=0)
    assert j3.stats()["torn_tails"] == 0
    assert set(j3.live()) == {"a", "b"}
    j3.close()


# ========================================================= group fsync
def test_group_fsync_policy(tmp_path):
    """fsync_interval_s=0 syncs every append; a huge interval + byte
    budget batches everything until flush(force=True)."""
    strict = GenerationJournal(str(tmp_path / "strict"),
                               fsync_interval_s=0)
    s0 = strict.stats()["fsyncs"]
    for i in range(3):
        strict.append_admitted(f"r{i}", [1], 2)
    assert strict.stats()["fsyncs"] == s0 + 3
    strict.close()
    lazy = GenerationJournal(str(tmp_path / "lazy"),
                             fsync_interval_s=1e9,
                             fsync_bytes=1 << 30)
    l0 = lazy.stats()["fsyncs"]
    for i in range(10):
        lazy.append_admitted(f"r{i}", [1], 2)
    assert lazy.stats()["fsyncs"] == l0     # all pending
    lazy.flush(force=True)
    assert lazy.stats()["fsyncs"] == l0 + 1  # one group commit
    lazy.close()


# ========================================================== compaction
def test_compaction_never_drops_live(program, tmp_path):
    """Churn with a tiny segment budget so rotation+compaction fires
    repeatedly MID-decode; after every step each in-flight request is
    still journaled live and each finished one is not; the drained
    journal recovers empty and every output matches the oracle."""
    reqs = _requests(12, seed=11)
    oracle = _oracle(program, reqs)
    reg = get_registry()
    c0 = reg.counter_value("dl4j_journal_compactions_total")
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0.05,
                          segment_bytes=2048)
    eng = DecodeEngine(program=program, queue_limit=64,
                       max_prefills_per_step=2, journal=j)
    handles = []
    i = steps = 0
    while i < len(reqs) or any(not h.done for h in handles):
        if i < len(reqs) and steps % 2 == 0:
            prompt, mx = reqs[i]
            handles.append(eng.submit(prompt, mx,
                                      request_id=f"churn-{i}"))
            i += 1
        eng.step_once()
        steps += 1
        assert steps < 2000, "engine made no progress"
        # the audit: journal live set == in-flight handle set
        live = set(j.live())
        for k, h in enumerate(handles):
            rid = f"churn-{k}"
            if h.done:
                assert rid not in live
            else:
                assert rid in live
    assert [h.result(timeout_s=0) for h in handles] == oracle
    stats = j.stats()
    assert stats["compactions"] >= 1, "segment budget never tripped"
    assert stats["live"] == 0
    assert len(_segments(d)) <= 2      # consolidation, not sprawl
    j.flush(force=True)
    j.close()
    assert reg.counter_value("dl4j_journal_compactions_total") > c0
    j2 = GenerationJournal(d, fsync_interval_s=0)
    assert j2.stats()["torn_tails"] == 0
    assert j2.live() == {}
    j2.close()


def test_kill_during_compaction_recovers(tmp_path):
    """Compaction's crash windows, staged by hand: (1) consolidated
    segment written but old segments not yet deleted, (2) a stray .tmp
    from an interrupted atomic write, (3) partial deletes. Every stage
    recovers the same live set — replay is idempotent and consolidated
    segments sort after the segments they subsume."""
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    j.append_admitted("a", [1, 2], 8)
    j.record_progress("a", [5, 6])
    j.append_admitted("b", [3], 4)
    j.append_done("b", "eos")
    j.close()
    seg0 = _segments(d)[0]

    def live_after_reopen():
        jj = GenerationJournal(d, fsync_interval_s=0)
        live = jj.live()
        torn = jj.stats()["torn_tails"]
        jj.close()
        return live, torn

    # stage 1: consolidated written, old segment still present
    write_records(os.path.join(d, "seg-00000001.wal"), [
        {"kind": "admitted", "id": "a", "prompt": [1, 2],
         "max_new_tokens": 8},
        {"kind": "progress", "id": "a", "start": 0, "tokens": [5, 6]},
    ])
    live, torn = live_after_reopen()
    assert set(live) == {"a"} and live["a"]["tokens"] == [5, 6]
    assert torn == 0
    # stage 2: a stray tmp file from an interrupted atomic write
    with open(os.path.join(d, "seg-00000009.wal.tmp"), "wb") as f:
        f.write(b"half-written consolidation")
    live, torn = live_after_reopen()
    assert set(live) == {"a"} and torn == 0
    # stage 3: the old segment got deleted, consolidated survives
    os.unlink(seg0)
    live, torn = live_after_reopen()
    assert set(live) == {"a"} and live["a"]["tokens"] == [5, 6]
    assert torn == 0


# ========================================== cold restart, bitwise exact
@pytest.mark.chaos
def test_cold_restart_recovery_bitwise_vs_oracle(program, tmp_path):
    """The total-loss drill, in process: stop() WITHOUT closing the
    journal is the SIGKILL twin. A fresh engine on the same directory
    recovers every live stream mid-generation, a client re-submit by
    request_id joins the recovered stream (no double execution), and
    every output is bitwise equal to the sequential oracle."""
    reqs = _requests(5, seed=21, max_prompt=10, max_new=12)
    reqs = [(p, 10) for p, _ in reqs]
    oracle = _oracle(program, reqs)
    reg = get_registry()
    r0 = reg.counter_value("dl4j_journal_recovered_requests_total")
    d = str(tmp_path / "wal")
    j1 = GenerationJournal(d, fsync_interval_s=0)
    eng1 = DecodeEngine(program=program, journal=j1)
    for i, (prompt, mx) in enumerate(reqs):
        eng1.submit(prompt, mx, request_id=f"req-{i}")
    for _ in range(6):                 # partial progress only
        eng1.step_once()
    eng1.stop()                        # SIGKILL twin: journal NOT closed
    # ---- cold restart on the same directory
    j2 = GenerationJournal(d, fsync_interval_s=0)
    live = j2.live()
    assert set(live) == {f"req-{i}" for i in range(len(reqs))}
    assert any(live[rid]["tokens"] for rid in live), \
        "drill never got airborne"
    eng2 = DecodeEngine(program=program, journal=j2)
    assert eng2.stats()["journal"]["recovered"] == len(reqs)
    assert reg.counter_value(
        "dl4j_journal_recovered_requests_total") == r0 + len(reqs)
    # the client's idempotent re-submit joins the recovered streams
    handles = [eng2.submit(p, mx, request_id=f"req-{i}")
               for i, (p, mx) in enumerate(reqs)]
    steps = 0
    while any(not h.done for h in handles):
        eng2.step_once()
        steps += 1
        assert steps < 2000, "recovered engine made no progress"
    assert [h.result(timeout_s=0) for h in handles] == oracle
    assert j2.live() == {}             # every stream drained to done
    j2.close()
    j1.close()


def test_idempotent_submit_and_shed_journaling(program, tmp_path):
    """Same request_id -> the ORIGINAL handle, before and after it
    finishes, with nothing double-journaled; a shed admit is closed
    out as done("shed") so a restart cannot resurrect it."""
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    eng = DecodeEngine(program=program, queue_limit=0, journal=j)
    handles = [eng.submit([1 + i, 2], 3, request_id=f"id-{i}")
               for i in range(SLOTS)]
    with pytest.raises(QuotaExceededError):
        eng.submit([9, 9], 3, request_id="id-shed")
    assert set(j.live()) == {f"id-{i}" for i in range(SLOTS)}
    assert j.stats()["done"] == 1      # the shed one, terminal on disk
    n = j.stats()["records"]
    assert eng.submit([1, 2], 3, request_id="id-0") is handles[0]
    assert j.stats()["records"] == n   # duplicate wrote nothing
    steps = 0
    while any(not h.done for h in handles):
        eng.step_once()
        steps += 1
        assert steps < 2000
    # finished ids are retained: a late retry joins the done handle
    again = eng.submit([1, 2], 3, request_id="id-0")
    assert again is handles[0] and again.done
    assert j.live() == {}
    j.close()


def test_stale_journal_unrecoverable(program, tmp_path):
    """A journaled request a FRESH engine cannot carry (prompt past
    this engine's attention window) is marked done("unrecoverable")
    instead of wedging recovery."""
    d = str(tmp_path / "wal")
    j = GenerationJournal(d, fsync_interval_s=0)
    j.append_admitted("too-big", [1] * (CTX + 8), 4)
    j.append_admitted("fine", [1, 2], 2)
    eng = DecodeEngine(program=program, journal=j)
    assert eng.stats()["journal"]["recovered"] == 1
    assert set(j.live()) == {"fine"}
    j2_probe = j.stats()
    assert j2_probe["done"] == 1       # too-big is terminal on disk
    eng.stop()
    j.close()


# ================================================== dashboard + stats
def test_dashboard_journal_line():
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    snapshot = {
        "counters": {
            "dl4j_journal_records_total": {(): 9.0},
            "dl4j_journal_recovered_requests_total": {(): 2.0},
            "dl4j_journal_torn_tails_total": {(): 1.0},
        },
        "gauges": {"dl4j_journal_live": {(): 3.0}},
        "histograms": {},
    }
    lines = telemetry_lines(snapshot)
    jl = [l for l in lines if l.startswith("journal — ")]
    assert jl == ["journal — 3 live · 2 recovered · 1 torn tails"]
    # quiet domain -> no line
    assert not [l for l in telemetry_lines({"counters": {}})
                if l.startswith("journal")]


def test_engine_stats_surface_journal_facts(program, tmp_path):
    """stats()["journal"] mirrors the journal's own stats() plus the
    engine's recovered count; None without a journal attached."""
    bare = DecodeEngine(program=program)
    assert bare.stats()["journal"] is None
    j = GenerationJournal(str(tmp_path / "wal"), fsync_interval_s=0)
    eng = DecodeEngine(program=program, journal=j)
    facts = eng.stats()["journal"]
    for key in ("records", "fsyncs", "torn_tails", "compactions",
                "bytes", "live", "recovered"):
        assert facts[key] == 0
    assert facts["fsync_interval_s"] == 0
    j.close()
