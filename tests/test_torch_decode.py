"""The port's continuous-batching decode engine on the CPU
(deeplearning4j_tpu_torch/serving/continuous.py, engine/decode_program.py,
zoo/decoder.py, nn/jit_cache.py): the counterparts of the in-process
pins of tests/test_decode.py.

  * continuous-batched output is BITWISE equal to the port's sequential
    per-request oracle under slot churn — staggered joins and leaves,
    EOS leaves, and mid-soak forced evictions (serving.slot_evict);
  * each program key is built ONCE (JitCache build counters) and never
    again through join/leave traffic;
  * the decode metrics are registered and emitted, and the port's
    dashboard renders the decode line.

The HTTP surface (ModelServer/ModelClient) waits for ROADMAP item 7 and
the program lint for item 10c.
"""

import random

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.engine.decode_program import (
    SCRATCH_PAGE,
    DecodeProgram,
    host_outputs,
    next_pow2,
)
from deeplearning4j_tpu_torch.nn.jit_cache import (
    JitCache,
    describe_signature,
    policy_name,
)
from deeplearning4j_tpu_torch.observability import metrics as tobs
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
    tflight.reap_stray_flight_dumps()


@pytest.fixture(scope="module")
def program():
    model = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=CTX, seed=3,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE)
    # serving warmup discipline: builds land before traffic
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
                 max_prefills_per_step=2, max_steps=2000):
    """Deterministic churn: submit one request every `stagger` engine
    steps and drive `step_once` manually — no loop thread."""
    eng = DecodeEngine(program=program, queue_limit=queue_limit,
                       max_prefills_per_step=max_prefills_per_step)
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
    return eng, [h.result(timeout_s=0) for h in handles]


# ======================================================== the model
def test_causal_transformer_config_checks_and_device():
    with pytest.raises(ValueError):
        CausalTransformer(d_model=30, n_heads=4, device="cpu")
    with pytest.raises(ValueError):
        CausalTransformer(max_ctx=100, device="cpu")
    m = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                          n_layers=2, max_ctx=CTX, seed=3, device="cpu")
    assert m.num_params() == 0
    assert m.config() == {"vocab_size": VOCAB, "d_model": 32,
                          "n_heads": 4, "n_layers": 2, "d_ff": 128,
                          "max_ctx": CTX, "seed": 3}
    m.init()
    d, f = 32, 128
    per_layer = 4 * d * d + 2 * d * f + f + d + 4 * d
    assert m.num_params() == (VOCAB + CTX) * d + 2 * d + 2 * per_layer
    assert sorted(m.params) == ["layers", "lnf_b", "lnf_g", "pos_emb",
                                "tok_emb"]
    assert isinstance(m.params["layers"], tuple)
    assert m.params["tok_emb"].dtype == torch.float32
    assert abs(float(m.params["tok_emb"].std()) - 0.02) < 0.002
    # the same seed draws the same weights
    again = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=CTX, seed=3,
                              device="cpu").init()
    assert torch.equal(again.params["layers"][1]["w2"],
                       m.params["layers"][1]["w2"])
    if not torch.cuda.is_available():
        # the default device is cuda: no silent CPU fallback
        with pytest.raises(RuntimeError):
            CausalTransformer(vocab_size=VOCAB)
        with pytest.raises(RuntimeError):
            DecodeEngine(model=CausalTransformer(vocab_size=VOCAB))


# ===================================================== program shapes
def test_chunk_schedule_is_page_aligned(program):
    assert program.chunk_starts(1) == [0]
    assert program.chunk_starts(PAGE) == [0]
    assert program.chunk_starts(PAGE + 1) == [0, PAGE]
    assert program.chunk_starts(CTX) == list(range(0, CTX, PAGE))
    assert program.chunk_starts(21, from_token=PAGE) == [PAGE, 2 * PAGE]
    for n in range(1, CTX + 1):
        starts = program.chunk_starts(n)
        assert all(s % PAGE == 0 for s in starts)
        assert starts[-1] < n <= starts[-1] + PAGE
    with pytest.raises(ValueError):
        program.chunk_starts(CTX + 1)
    with pytest.raises(ValueError):
        program.chunk_starts(0)
    assert next_pow2(5) == 8 and next_pow2(8) == 8


def test_kv_pool_is_page_and_head_major(program):
    m = program.model
    assert program.pages_per_slot == CTX // PAGE
    assert program.n_pages == SLOTS * program.pages_per_slot + 1
    assert program.kv_shape == (m.n_layers, 2, program.n_pages,
                                m.n_heads, PAGE, m.head_dim)
    kv = program.init_kv()
    assert tuple(kv.shape) == program.kv_shape
    assert kv.dtype == torch.float32
    assert program.kv_bytes == kv.numel() * 4


def test_window_cells_logical_order(program):
    pps = program.pages_per_slot
    table = [10 + r for r in range(pps)]
    cp, co = program.window_cells(table, 20)
    assert list(cp[:21]) == [10 + (q // PAGE) % pps for q in range(21)]
    assert list(co[:21]) == [q % PAGE for q in range(21)]
    assert set(cp[21:]) == {SCRATCH_PAGE} and set(co[21:]) == {0}
    cp, co = program.window_cells(table, CTX + 3)
    qs = list(range(CTX + 4 - CTX, CTX + 4))
    assert list(cp) == [10 + (q // PAGE) % pps for q in qs]
    assert list(co) == [q % PAGE for q in qs]
    cp, co = program.window_cells(table, -1)
    assert set(cp) == {SCRATCH_PAGE}
    # a live position on an unmapped ring entry is a page-table bug
    with pytest.raises(ValueError):
        program.window_cells([None] * pps, 3)


def test_programs_update_the_pool_in_place(program):
    """The port's programs write the pool they are given and return the
    same tensor: every call site rebinds as in the JAX package, and
    each pool (engine, oracle, bench arm) stays its own."""
    kv = program.init_kv()
    ptr = kv.data_ptr()
    cp, co = program.window_cells([SCRATCH_PAGE] * program.pages_per_slot,
                                  -1)
    out = program.prefill_chunk(kv, [1, 2, 3], 0, cp, co, 5)
    assert out is kv and kv.data_ptr() == ptr
    assert float(kv[:, :, 5].abs().sum()) > 0
    out = program.copy_page(kv, 5, 7)
    assert out is kv and torch.equal(kv[:, :, 7], kv[:, :, 5])
    s, c = SLOTS, CTX
    out, nxt, ok = program.step(kv, np.zeros(s, np.int32),
                                np.zeros(s, np.int32),
                                np.zeros((s, c), np.int32),
                                np.zeros((s, c), np.int32),
                                np.zeros(s, np.int32),
                                np.zeros(s, np.int32))
    assert out is kv
    toks, verdict = host_outputs(nxt, ok)
    assert toks.shape == (s,) and verdict.dtype == bool and verdict.all()


def test_sequential_oracle_contract(program):
    _, toks = sequential_decode(program, [5, 9, 11], 6)
    assert len(toks) == 6
    assert all(0 <= t < VOCAB for t in toks)
    eos = toks[3]
    expect = toks[:toks.index(eos) + 1]
    _, cut = sequential_decode(program, [5, 9, 11], 6, eos_id=eos)
    assert cut == expect and cut[-1] == eos


# ============================================= byte-identity under churn
def test_continuous_matches_oracle_under_staggered_churn(program):
    reqs = _requests(12, seed=1)
    oracle = _oracle(program, reqs)
    eng, got = _drive_churn(program, reqs, stagger=2)
    assert got == oracle
    stats = eng.stats()
    assert stats["completed"] == len(reqs)
    assert stats["tokens_total"] == sum(len(t) for t in oracle)
    assert stats["active_slots"] == 0 and stats["pending"] == 0


def test_churn_with_eos_leaves_match_oracle(program):
    reqs = _requests(8, seed=2)
    free_run = _oracle(program, reqs)
    eos = free_run[0][-1]
    oracle = _oracle(program, reqs, eos=eos)
    assert any(len(a) < len(b) for a, b in zip(oracle, free_run))
    _, got = _drive_churn(program, reqs, stagger=3, eos=eos)
    assert got == oracle


def test_one_decode_build_serves_join_leave_traffic(program):
    """The build-once pin: after warmup, arbitrary join/leave traffic
    advances ZERO JitCache build counters."""
    reqs = _requests(10, seed=3)
    before = program.model._jit_cache.trace_counts()
    _oracle(program, reqs)
    _drive_churn(program, reqs, stagger=1)
    after = program.model._jit_cache.trace_counts()
    assert after == before
    for key in (program.decode_key(), program.chunk_key(),
                program.copy_key()):
        assert after[str(key)] == 1
    assert program.model._jit_cache.policy(program.decode_key()) == "f32"


def test_a_call_off_the_keys_shapes_moves_the_build_count():
    """The build counters can fail: a call whose pool or index arrays
    have shapes the key has not seen records a trace (the JAX program
    would retrace) and a compile event; a repeat of it does not."""
    model = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=CTX, seed=4,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE)
    prog.warmup(prog.init_kv())
    cache = model._jit_cache
    keys = [str(k) for k in (prog.decode_key(), prog.chunk_key(),
                             prog.copy_key())]
    assert [cache.trace_counts()[k] for k in keys] == [1, 1, 1]
    events = len(cache.compile_events())
    wide = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE,
                         n_pages=prog.n_pages + 3)
    kv = wide.init_kv()
    s, c = SLOTS, CTX
    zs, zc = np.zeros(s, np.int32), np.zeros((s, c), np.int32)
    for _ in range(2):
        prog.step(kv, zs, zs, zc, zc, zs, zs)
        prog.copy_page(kv, 1, 2)
    assert [cache.trace_counts()[k] for k in keys] == [2, 1, 2]
    assert len(cache.compile_events()) == events + 2


# ========================================================= eviction chaos
@pytest.mark.chaos
def test_slot_eviction_drill_byte_identical(program):
    reqs = _requests(10, seed=4)
    oracle = _oracle(program, reqs)
    inj = injector()
    inj.inject("serving.slot_evict", mode="raise", at_hit=6, times=1)
    inj.inject("serving.slot_evict", mode="raise", at_hit=14, times=2)
    eng, got = _drive_churn(program, reqs, stagger=2)
    assert got == oracle
    assert eng.stats()["evictions"] == 3
    assert injector().hits("serving.slot_evict") > 0


@pytest.mark.chaos
def test_eviction_storm_mid_soak_still_byte_identical(program):
    reqs = _requests(8, seed=5, max_prompt=16, max_new=10)
    oracle = _oracle(program, reqs)
    inj = injector()
    for at in (5, 10, 15, 20, 25):
        inj.inject("serving.slot_evict", mode="raise", at_hit=at, times=1)
    eng, got = _drive_churn(program, reqs, stagger=2, max_steps=4000)
    assert got == oracle
    assert eng.stats()["evictions"] == 5


# ===================================================== streaming + admission
def test_streaming_accumulation_mid_generation(program):
    eng = DecodeEngine(program=program)
    h = eng.submit([1, 2, 3, 4], max_new_tokens=8)
    assert h.tokens_so_far() == []
    eng.step_once()
    assert len(h.tokens_so_far()) == 1
    eng.step_once()
    assert len(h.tokens_so_far()) == 2
    eng.step_once()
    assert len(h.tokens_so_far()) == 3
    got_then = h.tokens_so_far()
    while not h.done:
        eng.step_once()
    final = h.result(timeout_s=0)
    assert final[:3] == got_then and len(final) == 8
    assert h.finish_reason == "length"
    assert h.wait_for_tokens(3, timeout_s=0.1) == final


def test_submit_validation_and_slot_exhaustion_429(program):
    eng = DecodeEngine(program=program, queue_limit=1)
    with pytest.raises(ValueError):
        eng.submit([], 4)
    with pytest.raises(ValueError):
        eng.submit([1], 0)
    with pytest.raises(ValueError):
        eng.submit([1] * (CTX + 1), 4)
    for _ in range(SLOTS + 1):
        eng.submit([1, 2], 4)
    with pytest.raises(QuotaExceededError) as ei:
        eng.submit([1, 2], 4)
    assert ei.value.retry_after_s > 0
    while eng._in_flight():
        eng.step_once()
    eng.submit([1, 2], 4)
    eng.submit([1] * 10, CTX)       # generation past the window: legal
    while eng._in_flight():
        eng.step_once()


class _Quota:
    """An object with the JAX package's AdmissionController interface:
    one token per tenant in `metered`, everyone else rides on."""

    def __init__(self, metered):
        self.left = {t: 1 for t in metered}
        self.calls = []

    def admit(self, tenant, model, depth, capacity):
        self.calls.append((tenant, model, depth, capacity))
        if tenant in self.left:
            if self.left[tenant] <= 0:
                raise QuotaExceededError("quota spent", tenant=tenant,
                                         retry_after_s=1.0)
            self.left[tenant] -= 1


def test_admission_object_fronts_the_engine(program):
    adm = _Quota({"metered"})
    eng = DecodeEngine(program=program, admission=adm)
    eng.submit([1, 2], 2, tenant="metered")
    with pytest.raises(QuotaExceededError):
        eng.submit([1, 2], 2, tenant="metered")
    eng.submit([1, 2], 2, tenant="unmetered")
    assert adm.calls[0] == ("metered", "decoder", 0,
                            SLOTS + eng.queue_limit)
    assert eng.stats()["pending"] == 2


def test_engine_loop_thread_lifecycle(program):
    eng = DecodeEngine(program=program)
    eng.start()
    assert eng.running
    h = eng.generate([3, 1, 4, 1, 5], max_new_tokens=6, timeout_s=30.0)
    assert h.result(timeout_s=0) == sequential_decode(
        program, [3, 1, 4, 1, 5], 6)[1]
    eng2 = DecodeEngine(program=program, queue_limit=8)
    stuck = eng2.submit([1, 2, 3], 4)
    eng2.stop()
    with pytest.raises(Exception):
        stuck.result(timeout_s=0)
    eng.stop()
    assert not eng.running


def test_engines_sharing_one_program_from_their_threads():
    """Two engines' loop threads drive one fresh program at once (its
    first builds race): every output equals the oracle and each program
    key is built exactly once."""
    import sys

    model = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=CTX, seed=9,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE)
    reqs = _requests(8, seed=12)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    engines = [DecodeEngine(program=prog, queue_limit=64) for _ in range(2)]
    try:
        for eng in engines:
            eng.start()
        handles = [engines[i % 2].submit(p, mx)
                   for i, (p, mx) in enumerate(reqs)]
        got = [h.result(timeout_s=60.0) for h in handles]
    finally:
        sys.setswitchinterval(interval)
        for eng in engines:
            eng.stop()
    assert not any(eng.running for eng in engines)
    assert got == _oracle(prog, reqs)
    counts = model._jit_cache.trace_counts()
    assert counts[str(prog.decode_key())] == 1
    assert counts[str(prog.chunk_key())] == 1


# ================================================== metrics + dashboard
def test_decode_metrics_registered_and_emitted(program):
    names = {"dl4j_decode_active_slots", "dl4j_decode_tokens_total",
             "dl4j_decode_tokens_per_s", "dl4j_decode_prefill_seconds",
             "dl4j_decode_slot_evictions_total"}
    assert names <= set(REGISTERED_METRICS)
    assert "serving.slot_evict" in REGISTERED_POINTS
    reg = get_registry()
    tokens_before = reg.counter_value("dl4j_decode_tokens_total")
    evicts_before = reg.counter_value("dl4j_decode_slot_evictions_total")
    reqs = _requests(4, seed=6)
    injector().inject("serving.slot_evict", mode="raise", at_hit=4)
    eng, got = _drive_churn(program, reqs, stagger=2)
    emitted = sum(len(t) for t in got)
    assert reg.counter_value("dl4j_decode_tokens_total") \
        == tokens_before + emitted
    assert reg.counter_value("dl4j_decode_slot_evictions_total") \
        == evicts_before + 1
    snap = reg.snapshot()
    assert snap["histograms"]["dl4j_decode_prefill_seconds"]["count"] > 0
    gauges = snap["gauges"]
    assert "dl4j_decode_active_slots" in gauges
    assert "dl4j_decode_tokens_per_s" in gauges
    # the Prometheus exposition carries them (the JAX package scrapes
    # it over HTTP; the port's server is ROADMAP item 7)
    text = tobs.get_registry().prometheus_text()
    assert "dl4j_decode_tokens_total" in text
    assert "dl4j_decode_prefill_seconds_bucket" in text


def test_dashboard_decode_line():
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    snapshot = {
        "counters": {"dl4j_decode_tokens_total": {(): 420.0},
                     "dl4j_decode_slot_evictions_total": {(): 2.0}},
        "gauges": {"dl4j_decode_active_slots": {(): 3.0},
                   "dl4j_decode_tokens_per_s": {(): 123.4}},
        "histograms": {},
    }
    lines = telemetry_lines(snapshot)
    decode = [l for l in lines if l.startswith("decode — ")]
    assert decode == [
        "decode — 3 slots · 123.4 tok/s · 420 tokens · 2 evictions"]
    snapshot["counters"]["dl4j_decode_prefix_hits_total"] = {(): 30.0}
    snapshot["counters"]["dl4j_decode_prefill_chunks_total"] = {(): 10.0}
    snapshot["gauges"]["dl4j_decode_pages_free"] = {(): 7.0}
    decode = [l for l in telemetry_lines(snapshot)
              if l.startswith("decode — ")]
    assert decode == [
        "decode — 3 slots · 123.4 tok/s · 420 tokens · 2 evictions"
        " · prefix hit 75% · 7 pages free"]
    assert not [l for l in telemetry_lines({"counters": {}})
                if l.startswith("decode")]


def test_dashboard_decode_line_from_a_live_engine(program):
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    eng = DecodeEngine(program=program)
    h = eng.submit([4, 4, 2, 1], 5)
    while not h.done:
        eng.step_once()
    lines = telemetry_lines(get_registry().snapshot())
    (line,) = [l for l in lines if l.startswith("decode — ")]
    assert "tok/s" in line and "pages free" in line


# ============================================================ lint, perf
def test_program_lint_waits_for_queue_10c(program):
    """Queue 10c landed: the decode programs' lint records exist, declare
    the pool updated in place, and lint clean."""
    from deeplearning4j_tpu_torch.analysis import program_lint

    recs = program.lint_records()
    assert [r.name for r in recs] == [
        f"decode_step_s{SLOTS}", f"decode_prefill_c{program.page_size}",
        "decode_page_copy"]
    assert all(r.inplace_argnums and r.precision_policy == "f32"
               for r in recs)
    assert program_lint.run(recs) == []


def test_register_perf_counts_from_the_shapes(program):
    from deeplearning4j_tpu_torch.observability import CostModel

    cm = CostModel(device="cpu", peak_flops=1e12, peak_bytes_per_s=1e11)
    entry = program.register_perf(cm, bucket_len=PAGE)
    m = program.model
    d, f, c, s = m.d_model, m.d_ff, CTX, SLOTS
    want = (m.n_layers * 2 * s * (4 * d * d + 2 * d * f + 2 * c * d)
            + 2 * s * d * VOCAB)
    assert entry["flops"] == want
    assert entry["bytes_accessed"] == program.step_bytes()
    assert sorted(cm.keys()) == sorted([str(program.decode_key()),
                                        str(program.chunk_key())])
    costs = m._jit_cache.costs()
    assert costs[str(program.decode_key())]["flops"] == want


# ============================================================ JitCache
def test_jit_cache_counts_builds_and_records_compile_events():
    reg = get_registry()
    c0 = reg.counter_value("dl4j_jit_compiles_total")
    cache = JitCache()
    first = [True]

    def f(x, scale=1.0):
        if first[0]:
            first[0] = False
            cache.record_trace("double")
        return x * 2 * scale

    cache["double"] = f
    x = torch.zeros(3, 4)
    cache["double"](x, scale=2.0)
    cache["double"](x)
    assert cache.trace_counts() == {"double": 1}
    assert cache.total_traces() == 1 and cache.compiles_total() == 1
    (ev,) = cache.compile_events()
    assert ev["key"] == "double" and ev["traces"] == 1
    assert ev["signature"] == "(float32[3,4], scale=float)"
    assert ev["cost_digest"] is None and ev["duration_s"] >= 0
    cache.register_cost("double", {"flops": 24.0, "bytes_accessed": 96.0})
    assert cache.compile_events()[0]["cost_digest"] == {
        "flops": 24.0, "bytes_accessed": 96.0}
    cache.register_policy("double", policy_name(torch.bfloat16))
    assert cache.policy("double") == "bf16"
    assert cache.policies() == {"double": "bf16"}
    assert reg.counter_value("dl4j_jit_compiles_total") == c0 + 1
    assert policy_name(None) == "f32"
    assert policy_name("float16") == "f16"
    assert describe_signature(([1, 2], {"a": None})) \
        == "([int,int], {a:None})"
