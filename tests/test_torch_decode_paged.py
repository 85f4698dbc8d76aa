"""Paged KV virtual memory in the port (serving/continuous.py
PagePool/PrefixTrie + engine/decode_program.py paged programs) on the
CPU: the counterparts of tests/test_decode_paged.py's pins.

  * shared-prefix output is BITWISE equal to its unshared twin, and
    the Kth identical prompt skips prefill entirely;
  * copy-on-write divergence mid-page changes nothing byte-wise and is
    counted;
  * ring wrap past the window is bitwise equal to a never-recycling
    contiguous-cache oracle driven over the same step program;
  * eviction replay and resume continuations survive against the paged
    cache with prefix sharing active;
  * refcount EXACTNESS under churn (PagePool.audit), pool-pressure
    reclaim, and the paged metrics.
"""

import random

import numpy as np
import pytest

from deeplearning4j_tpu_torch.engine.decode_program import (
    SCRATCH_PAGE,
    DecodeProgram,
)
from deeplearning4j_tpu_torch.observability.metrics import (
    REGISTERED_METRICS,
    get_registry,
)
from deeplearning4j_tpu_torch.resilience.faults import injector
from deeplearning4j_tpu_torch.serving import continuous as tcont
from deeplearning4j_tpu_torch.serving import flight as tflight
from deeplearning4j_tpu_torch.serving.continuous import (
    DecodeEngine,
    PagePool,
    PrefixTrie,
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
                              n_layers=2, max_ctx=CTX, seed=11,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=SLOTS, page_size=PAGE)
    prog.warmup(prog.init_kv())
    return prog


def _drain(eng, handles, max_steps=4000):
    steps = 0
    while any(not h.done for h in handles):
        eng.step_once()
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return [h.result(timeout_s=0) for h in handles]


# ==================================================== prefix sharing
def test_shared_prefix_bitwise_and_prefill_skipped(program):
    """N requests with a common prompt: the first computes the pages,
    every later twin MAPS them — byte-identical output, and the Kth
    identical prompt costs ZERO chunk dispatches."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]
    _, oracle = sequential_decode(program, prompt, 10)

    eng = DecodeEngine(program=program)
    first = eng.submit(prompt, 10)
    _drain(eng, [first])
    chunks_after_first = eng.stats()["prefill_chunks"]
    assert chunks_after_first == len(program.chunk_starts(len(prompt)))
    assert first.result(timeout_s=0) == oracle

    twins = [eng.submit(prompt, 10) for _ in range(3)]
    got = _drain(eng, twins)
    assert got == [oracle] * 3
    s = eng.stats()
    # identical prompts: full trie coverage, zero new chunk dispatches
    assert s["prefill_chunks"] == chunks_after_first
    assert s["prefix_requests_hit"] == 3
    assert s["prefix_hits"] >= 3 * len(program.chunk_starts(len(prompt)))
    assert s["cow_copies"] >= 1  # generation writes forked the tail page


def test_shared_prefix_divergent_tails_bitwise(program):
    """Common system prefix + unique user tails: shared pages serve
    the prefix, chunks only run for the uncovered tail, and every
    stream stays byte-identical to its unshared sequential twin."""
    system = list(range(1, 1 + 2 * PAGE))          # two full blocks
    rng = random.Random(7)
    prompts = [system + [rng.randrange(VOCAB) for _ in range(5 + i)]
               for i in range(4)]
    oracle = [sequential_decode(program, p, 8)[1] for p in prompts]

    eng = DecodeEngine(program=program)
    handles = [eng.submit(p, 8) for p in prompts]
    got = _drain(eng, handles)
    assert got == oracle
    s = eng.stats()
    assert s["prefix_requests_hit"] >= 3     # every twin mapped blocks
    # the shared blocks were computed once; only tails chunked after
    total_chunks_unshared = sum(len(program.chunk_starts(len(p)))
                                for p in prompts)
    assert s["prefill_chunks"] < total_chunks_unshared


def test_cow_divergence_mid_page(program):
    """The CoW pin, mid-page: a prompt whose tail is NOT page-aligned
    registers a partial page in the trie; the owner's FIRST generation
    write lands inside that shared page and must fork it (cow_copies
    moves) without disturbing the twin that mapped it — both streams
    byte-identical to the sequential oracle."""
    prompt = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4]     # 11 tokens: 8 + 3
    assert len(prompt) % PAGE != 0
    _, oracle = sequential_decode(program, prompt, 9)

    eng = DecodeEngine(program=program)
    a = eng.submit(prompt, 9)
    _drain(eng, [a])
    cow_after_a = eng.stats()["cow_copies"]
    assert cow_after_a >= 1          # a's own write forked the
    #                                  trie-registered partial page
    b = eng.submit(prompt, 9)        # maps the ORIGINAL partial page
    _drain(eng, [b])
    assert a.result(timeout_s=0) == oracle
    assert b.result(timeout_s=0) == oracle
    assert eng.stats()["cow_copies"] > cow_after_a


# ========================================================= ring wrap
def test_ring_wrap_vs_contiguous_window_oracle(program):
    """Drive the SAME compiled step two ways: (a) the engine's ring
    table (pages_per_slot pages recycled in place), (b) a
    never-recycling oracle that allocates a FRESH page per logical
    block in a large pool and gathers only the window. Identical cell
    values in identical logical order => bitwise equal tokens — page
    recycling IS sliding-window attention."""
    model = program.model
    big = DecodeProgram(model, max_slots=1, page_size=PAGE,
                        n_pages=64)   # never recycles within the run
    big.warmup(big.init_kv())
    prompt = [5, 3, 8, 13, 21, 34, 55, 29, 26, 12]
    n_new = CTX + 25                  # deep into wrap territory
    ps, pps, c = PAGE, big.pages_per_slot, big.window

    # (b) contiguous oracle: logical table grows forever
    kv = big.init_kv()
    logical = {}                      # block index -> physical page
    nxt_page = 1

    def page_for(block):
        nonlocal nxt_page
        if block not in logical:
            logical[block] = nxt_page
            nxt_page += 1
        return logical[block]

    def cells(pos):
        cp = np.full(c, SCRATCH_PAGE, np.int32)
        co = np.zeros(c, np.int32)
        live = min(pos + 1, c)
        for j, q in enumerate(range(pos + 1 - live, pos + 1)):
            cp[j] = logical[q // ps]
            co[j] = q % ps
        return cp, co

    for start in big.chunk_starts(len(prompt)):
        wp = page_for(start // ps)
        cp, co = cells(start - 1) if start else (
            np.full(c, SCRATCH_PAGE, np.int32), np.zeros(c, np.int32))
        kv = big.prefill_chunk(kv, prompt[start:start + ps], start,
                               cp, co, wp)
    oracle_toks = []
    pos, tok, suppress = len(prompt) - 1, prompt[-1], True
    while len(oracle_toks) < n_new:
        wp = np.array([SCRATCH_PAGE], np.int32)
        wo = np.zeros(1, np.int32)
        if not suppress:
            wp[0] = page_for(pos // ps)
            wo[0] = pos % ps
        cp, co = cells(pos)
        kv, nxt, _ = big.step(kv, np.array([tok], np.int32),
                              np.array([pos], np.int32),
                              cp[None], co[None], wp, wo)
        tok = int(nxt.cpu().numpy()[0])
        oracle_toks.append(tok)
        pos += 1
        suppress = False
    assert len(logical) > pps          # the oracle really outgrew a ring

    # (a) the engine: ring table, pages recycled in place
    eng = DecodeEngine(program=big)
    h = eng.submit(prompt, n_new)
    _drain(eng, [h])
    assert h.tokens_so_far() == oracle_toks
    assert eng.stats()["ctx_wraps"] >= 1
    # positions wrapped past the window but the stream finished whole
    assert len(h.tokens_so_far()) == n_new


# ========================================== durability on paged cache
def test_eviction_replay_with_prefix_sharing(program):
    """serving.slot_evict chaos against the paged cache WITH prefix
    sharing active: evicted requests re-enter through the trie (their
    prompt pages are usually still cached), replay force-feeds the
    recorded tokens, and every stream stays byte-identical."""
    system = list(range(2, 2 + PAGE))
    rng = random.Random(13)
    reqs = [(system + [rng.randrange(VOCAB) for _ in range(3 + i % 5)],
             4 + i % 6) for i in range(8)]
    kv_oracle = [sequential_decode(program, p, mx)[1]
                 for p, mx in reqs]
    inj = injector()
    inj.inject("serving.slot_evict", mode="raise", at_hit=4, times=1)
    inj.inject("serving.slot_evict", mode="raise", at_hit=9, times=1)
    inj.inject("serving.slot_evict", mode="raise", at_hit=14, times=1)
    eng = DecodeEngine(program=program, queue_limit=64,
                       max_prefills_per_step=2)
    handles = []
    for i, (p, mx) in enumerate(reqs):
        handles.append(eng.submit(p, mx))
        eng.step_once()
    got = _drain(eng, handles)
    assert got == kv_oracle
    assert eng.stats()["evictions"] == 3
    audit = eng._pool.audit()
    assert audit["leaked"] == 0 and not audit["double_freed"]


def test_migration_resume_on_paged_cache(program):
    """The migration contract (prompt + resume_tokens re-prefill +
    forced replay; the JAX package's router carries it between
    replicas) lands on the paged cache: the
    continuation is byte-identical to the uninterrupted run, and the
    source engine's pages are fully reclaimed."""
    prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8, 7]
    _, full = sequential_decode(program, prompt, 12)

    src = DecodeEngine(program=program)
    h = src.submit(prompt, 12)
    while len(h.tokens_so_far()) < 5:
        src.step_once()
    partial = h.tokens_so_far()[:5]
    src.stop()
    audit = src._pool.audit()
    assert audit["leaked"] == 0 and not audit["double_freed"]

    dst = DecodeEngine(program=program)
    resumed = dst.submit(prompt, 12, resume_tokens=partial)
    _drain(dst, [resumed])
    assert resumed.result(timeout_s=0) == full


# ================================================ refcount exactness
def test_refcount_exactness_under_churn(program):
    """Join/leave/evict churn with sharing, CoW, and wrap all active:
    after the engine drains, every page is free, trie-referenced, or
    quarantined — zero leaks, zero double-frees — and disabling the
    prefix cache (prefix_cache=False) leaves NOTHING referenced."""
    rng = random.Random(29)
    reqs = [([rng.randrange(VOCAB)
              for _ in range(rng.randrange(2, 3 * PAGE))],
             rng.randrange(2, 14)) for _ in range(12)]
    inj = injector()
    inj.inject("serving.slot_evict", mode="raise", at_hit=7, times=1)

    eng = DecodeEngine(program=program, queue_limit=64)
    handles = []
    for p, mx in reqs:
        handles.append(eng.submit(p, mx))
        eng.step_once()
    _drain(eng, handles)
    audit = eng._pool.audit()
    assert audit["leaked"] == 0 and not audit["double_freed"]
    # every remaining reference is a trie registration (slots are
    # empty), and each registered page holds exactly one trie ref
    assert audit["referenced"] == len(eng._trie)
    for page in list(eng._trie._where):
        assert int(eng._pool.ref[page]) == 1
    # trie teardown releases everything
    eng._trie.clear(eng._pool)
    audit = eng._pool.audit()
    assert audit["referenced"] == 0 and audit["leaked"] == 0

    off = DecodeEngine(program=program, prefix_cache=False,
                       queue_limit=64)
    handles = [off.submit(p, mx) for p, mx in reqs[:6]]
    _drain(off, handles)
    audit = off._pool.audit()
    assert audit["referenced"] == 0 and audit["leaked"] == 0
    assert off.stats()["prefix_requests_hit"] == 0


def test_pool_pressure_reclaims_trie_then_slots(program):
    """A pool too small for every tenant's working set: allocation
    falls back to trie LRU eviction, then to slot eviction (replay) —
    the engine keeps serving, byte-identically, and never leaks."""
    model = program.model
    tight = DecodeProgram(model, max_slots=3, page_size=PAGE,
                          n_pages=3 * (CTX // PAGE) // 2 + 1)
    tight.warmup(tight.init_kv())
    rng = random.Random(31)
    reqs = [([rng.randrange(VOCAB)
              for _ in range(rng.randrange(PAGE, 4 * PAGE))],
             rng.randrange(4, 20)) for _ in range(9)]
    oracle = [sequential_decode(tight, p, mx)[1] for p, mx in reqs]
    eng = DecodeEngine(program=tight, queue_limit=64)
    handles = []
    for p, mx in reqs:
        handles.append(eng.submit(p, mx))
        eng.step_once()
    got = _drain(eng, handles)
    assert got == oracle
    audit = eng._pool.audit()
    assert audit["leaked"] == 0 and not audit["double_freed"]


# ======================================================= unit pieces
def test_page_pool_audit_catches_leak_and_double_free():
    pool = PagePool(6)
    a, b = pool.alloc(), pool.alloc()
    pool.retain(a)
    pool.release(a)
    pool.release(b)
    assert pool.audit()["leaked"] == 0
    assert not pool.audit()["double_freed"]
    pool.release(b)                    # misuse: b re-enters free list
    assert pool.audit()["double_freed"]
    pool2 = PagePool(4)
    pool2.alloc()
    pool2.ref[1] = 0                   # corrupt: referenced page lost
    assert pool2.audit()["leaked"] == 1


def test_prefix_trie_match_register_evict():
    pool = PagePool(12)
    trie = PrefixTrie(page_size=4)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 9]      # 2 blocks + tail
    table = [pool.alloc() for _ in range(3)]
    inserted = trie.register(prompt, table, pool)
    assert inserted == table and len(trie) == 3
    pages, covered = trie.match(prompt)
    assert pages == table and covered == len(prompt)
    # block-aligned prefix of a DIFFERENT prompt shares the blocks
    pages, covered = trie.match([1, 2, 3, 4, 5, 6, 7, 8, 1, 1, 1])
    assert pages == table[:2] and covered == 8
    # a partial page never matches an extension that is not the tail
    pages, covered = trie.match(prompt + [1])
    assert pages == table[:2] and covered == 8
    # eviction is leaf-only: with the slot refs dropped, the tail and
    # then the deepest block go first; the ROOT block holds until last
    for p in table:
        pool.release(p)
    assert trie.evict_lru(pool) and len(trie) == 2
    assert trie.evict_lru(pool) and len(trie) == 1
    assert trie.evict_lru(pool) and len(trie) == 0
    assert not trie.evict_lru(pool)
    assert pool.audit()["leaked"] == 0


def test_trie_purge_quarantines_chains():
    """Purging a mid-chain block (poison) drops the stranded subtree
    and parks trie-only pages in quarantine — never back on the free
    list."""
    pool = PagePool(12)
    trie = PrefixTrie(page_size=2)
    prompt = [1, 2, 3, 4, 5, 6]
    table = [pool.alloc() for _ in range(3)]
    trie.register(prompt, table, pool)
    for p in table:
        pool.release(p)                # trie holds them alone
    trie.purge([table[1]], pool)       # mid-chain: drops table[2] too
    assert len(trie) == 1
    assert table[1] in pool.quarantined
    assert pool.audit()["leaked"] == 0
    assert pool.free_count == (pool.n_pages - 1) - 2 - 1


# ============================================================ metrics
def test_paged_metrics_registered_and_emitted(program):
    for name in ("dl4j_decode_prefix_hits_total",
                 "dl4j_decode_prefix_pages_shared",
                 "dl4j_decode_pages_free",
                 "dl4j_decode_prefill_chunks_total",
                 "dl4j_decode_ctx_wraps_total"):
        assert name in REGISTERED_METRICS
    reg = get_registry()
    reg.reset()
    try:
        eng = DecodeEngine(program=program)
        prompt = [6, 2, 8, 3, 1, 7, 4, 4, 9]
        h1 = eng.submit(prompt, CTX + 10)   # wraps
        h2 = eng.submit(prompt, 4)          # prefix twin
        _drain(eng, [h1, h2])
        assert reg.counter_value(
            "dl4j_decode_prefill_chunks_total") > 0
        assert reg.counter_value("dl4j_decode_prefix_hits_total") > 0
        assert reg.counter_value("dl4j_decode_ctx_wraps_total") > 0
        snap = reg.snapshot()
        assert "dl4j_decode_pages_free" in snap["gauges"]
        assert "dl4j_decode_prefix_pages_shared" in snap["gauges"]
    finally:
        reg.reset()
