"""Continuous batching: the slot-based autoregressive decode engine
(counterpart of deeplearning4j_tpu/serving/continuous.py; the host half
is a copy, the device half is engine/decode_program.py's PyTorch
programs on the model's device).

THE serving regime for autoregressive traffic. The fixed-shape request
pipeline
(ParallelInference) coalesces one-shot requests into pow2 buckets;
generation is different: a request is ALIVE for many steps, and naive
per-request serving pays a full program dispatch per token for ONE
stream. The DecodeEngine instead runs ONE decode step program over a
fixed `max_slots` batch (engine/decode_program.DecodeProgram) and
treats request lifecycle as pure data:

  join    an admitted request claims a free slot at ANY step: its
          prompt prefills in page_size CHUNKS, one chunk dispatch
          interleaved per engine step, so a long prompt never stalls
          resident generations; once its K/V pages are in, a uniform
          first-token decode step (write suppressed — the cells are
          already written) emits its first token and the slot rides
          the shared decode loop. No program is rebuilt;
  leave   EOS or max-tokens frees the slot between two steps; the
          program never learns a request ended (per-slot active masks
          are host state — the program's shapes are invariant);
  evict   the `serving.slot_evict` fault point (chaos drills) can rip
          an active request out mid-generation: its recovery is
          re-prefill of the ORIGINAL prompt on a free slot + forced
          replay of the already-emitted tokens through the shared
          decode loop. Replay recomputes the exact K/V the evicted
          slot held (same programs, same inputs), so the continuation
          is byte-identical to a never-evicted run — the property
          `sequential_decode` oracles pin.

Paged KV virtual memory (this file owns the HOST half; the device
half is engine/decode_program.py): each slot holds a ring page table
over a shared refcounted physical pool (PagePool) —

  share   a PrefixTrie caches prompt pages by page-aligned token
          blocks; N requests with a common prefix MAP the same
          read-only pages (one pool ref per referent), and the Kth
          identical prompt skips prefill entirely. Sharing is bitwise
          safe because a shared page holds exactly the bytes its
          unshared twin would have computed, and the uniform
          first-token step runs identically either way;
  CoW     the first generation write into a page something else still
          references (a trie entry, a prefix twin) copies it first
          (`decode_page_copy`) — divergence costs one page copy, not
          correctness;
  wrap    logical positions run PAST the attention window: the ring
          table recycles the slot's own oldest page (sliding-window
          attention), so long generations never die at max_ctx;
  reclaim under pool pressure the engine LRU-evicts trie-only cached
          pages, then evicts resident requests (replay makes that
          safe); page quarantine mirrors slot quarantine — a poisoned
          slot's PRIVATE pages are written off, its trie
          registrations purged, while genuinely shared pages merely
          lose a reference (the poison only ever wrote private
          cells).

Byte-identity contract: greedy decoding + per-slot independence of the
decode step mean every emitted token is a deterministic function of
the request's own tokens — independent of which slot it lands in, who
its neighbors are, and when it joins. The port's decode tests pin
engine output == sequential per-request oracle under staggered churn
AND mid-soak eviction chaos, on the CPU and on the card.

Generation durability (the crash-proof layer on the same replay
mechanism — a generation request is a durable object, not
slot-lifetime ephemera):

  continuation  `submit(resume_tokens=[...])` re-enters a stream that
          already emitted tokens ELSEWHERE (an evicted replica, a
          dropped connection): re-prefill + forced replay of the
          recorded tokens, then greedy continuation — byte-identical
          to an uninterrupted run. This is the eviction-recovery path
          crossing process boundaries (ModelServer's resumable 503 and
          ReplicaRouter's migration ride it).
  quarantine  the decode step returns a per-slot finite-logits
          verdict (engine/decode_program.py, the NonFiniteGuard
          discipline applied to serving); a non-finite slot is
          quarantined — NEVER reused — and its request replayed on a
          healthy slot. Poison that travels WITH a request (its own
          tokens drive the numerics) aborts with
          GenerationPoisonedError after `poison_strike_limit` strikes
          instead of quarantining the fleet slot by slot. The
          `decode.nonfinite` fault point forces the verdict
          deterministically.
  watchdog  `watchdog_timeout_s=` arms a StepWatchdog
          (resilience/supervisor.py) over the loop thread's
          heartbeats; a hung iteration (the `decode.hang` drill)
          escalates to engine teardown + bounded restart
          (`max_engine_restarts`): fresh KV cache, every live request
          re-queued as a replay continuation — never an indefinite
          hang, never a lost stream.
  deadline  `submit(deadline_s=)` / `GenerationHandle.cancel()` free
          the slot at the next step boundary and finish the handle
          with its PARTIAL tokens and an explicit finish_reason
          ("deadline" / "cancelled").

Admission: an optional `admission=` object in front — the
AdmissionController of serving/admission.py, or anything with its
`admit(tenant, model, depth, capacity)` raising QuotaExceededError to
shed — and a hard capacity bound
(`max_slots` resident + `queue_limit` waiting) that rejects with
QuotaExceededError on slot exhaustion.

Device discipline: a decode step has exactly ONE device-to-host read
(the [S] tokens and finite verdicts, `decode_program.host_outputs`);
live masks, positions and cell indices stay on the device. The loop
thread sets the engine's CUDA device before it dispatches anything,
and no CUDA call runs from a signal handler (the flight recorder's
SIGUSR2 dump is host-only).

Per-token accumulation is streaming-capable: tokens land in the
handle under a condition variable as they are emitted
(`tokens_so_far()` / `wait_for_tokens(n)`), so a streaming transport
can drain mid-generation; `result()` blocks for the final sequence.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.engine.decode_program import host_outputs
from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import (
    FaultInjectedError,
    GenerationPoisonedError,
    QuotaExceededError,
    RestartsExhaustedError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire
from deeplearning4j_tpu_torch.serving.flight import FlightRecorder

# every engine constructed in this process (weak — dead engines drop
# out); the decode tests reap whatever a failed chaos test left
# running so no loop/watchdog thread leaks into later tests
_LIVE_ENGINES: "weakref.WeakSet[DecodeEngine]" = weakref.WeakSet()


def _ring_quantile(ring, q: float) -> Optional[float]:
    """Exact quantile over a bounded ring of recent observations (the
    window IS the estimator — same discipline as _Hist.quantile)."""
    vals = sorted(ring)
    if not vals:
        return None
    idx = min(len(vals) - 1, max(0, int(q * len(vals))))
    return vals[idx]


def reap_stray_engines() -> None:
    """Stop every engine still running (loop thread, watchdog, zombie
    restart threads). Teardown backstop for chaos tests — idempotent,
    touches nothing if every engine was stopped properly."""
    for eng in list(_LIVE_ENGINES):
        if eng.running or eng._watchdog is not None:
            eng.stop()


class GenerationHandle:
    """One generation stream: prompt in, tokens accumulating out.

    Thread-safe: the engine loop appends, any number of consumers
    read. `finish_reason` is "eos" (the eos token was emitted — it IS
    included in the output), "length" (max_new_tokens reached),
    "deadline" (the submit deadline expired — the tokens are a
    PARTIAL result), or "cancelled" (`cancel()` was honored — also
    partial). Failure finishes carry reason None and an error that
    `result()` re-raises."""

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 eos_id: Optional[int],
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 tenant: Optional[str] = None,
                 trace: Optional[str] = None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.request_id = request_id
        self.tenant = tenant
        self.trace = trace
        self.finish_reason: Optional[str] = None
        self.evictions = 0
        self.replays = 0
        self.poison_strikes = 0
        # latency-attribution clock marks (perf_counter values, set by
        # the engine): submit -> first placement -> first/last emitted
        # token. TTFT = first_token - submit, ITL = successive token
        # gaps, queue wait = placed - submit; a resumed continuation
        # restarts the marks on its new engine, so attribution is
        # per-leg, never cross-process clock arithmetic
        self.t_submit = time.perf_counter()
        self.t_placed: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        # root span of this leg's span tree (engine-owned; None when
        # the engine has no tracer — the default-off zero-cost path)
        self._span = None
        self._deadline = (time.monotonic() + float(deadline_s)
                          if deadline_s is not None else None)
        self._cancel_requested = False
        self._tokens: List[int] = []
        self._cond = threading.Condition()
        self._done = False
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------- consumers
    def tokens_so_far(self) -> List[int]:
        with self._cond:
            return list(self._tokens)

    def wait_for_tokens(self, n: int, timeout_s: float = 30.0) -> List[int]:
        """Block until at least `n` tokens exist (or the stream ends);
        the streaming-transport primitive."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._done or len(self._tokens) >= n,
                timeout=timeout_s)
            return list(self._tokens)

    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def failed(self) -> bool:
        """True once the stream finished WITH an error (engine
        shutdown, poison exhaustion). A failed handle is a dead end:
        a re-submit under the same request_id is a retry of work that
        never completed, not a duplicate — the idempotency dedup must
        not pin the caller to it."""
        with self._cond:
            return self._done and self._error is not None

    def cancel(self) -> None:
        """Request cancellation: the engine frees the slot at its next
        step boundary and finishes the handle with the tokens emitted
        so far and finish_reason "cancelled"."""
        with self._cond:
            self._cancel_requested = True
            self._cond.notify_all()

    def result(self, timeout_s: Optional[float] = 60.0) -> List[int]:
        with self._cond:
            if not self._cond.wait_for(lambda: self._done,
                                       timeout=timeout_s):
                raise TimeoutError(
                    f"generation not finished within {timeout_s}s "
                    f"({len(self._tokens)}/{self.max_new_tokens} tokens)")
            if self._error is not None:
                raise self._error
            return list(self._tokens)

    # ---------------------------------------------------- engine side
    def _append(self, tok: int) -> None:
        with self._cond:
            self._tokens.append(tok)
            self._cond.notify_all()

    def _preload(self, tokens: Sequence[int]) -> None:
        """Seed already-emitted tokens into a fresh handle (wire
        continuation: the stream's earlier life happened on another
        replica / connection)."""
        with self._cond:
            self._tokens.extend(int(t) for t in tokens)
            self._cond.notify_all()

    def _finish(self, reason: Optional[str],
                error: Optional[BaseException] = None) -> None:
        with self._cond:
            self.finish_reason = reason
            self._error = error
            self._done = True
            self._cond.notify_all()


class PagePool:
    """Refcounted allocator over the physical page axis of the
    DecodeProgram pool. Page 0 is scratch (never allocated). A page is
    free iff its refcount is 0 and it is not quarantined; referents
    are slot page-table entries and prefix-trie registrations — one
    retain per referent, exact by construction (the refcount-exactness
    test drains the engine and audits this)."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self.ref = np.zeros(self.n_pages, np.int64)
        self._free: deque = deque(range(1, self.n_pages))
        # pages written by a quarantined slot: their bytes may be
        # numeric poison — written off, never freed (the page-granular
        # analog of never reusing a quarantined slot)
        self.quarantined: set = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        p = self._free.popleft()
        self.ref[p] = 1
        return p

    def retain(self, page: int) -> None:
        self.ref[page] += 1

    def release(self, page: int) -> None:
        self.ref[page] -= 1
        if self.ref[page] == 0 and page not in self.quarantined:
            self._free.append(page)

    def quarantine(self, page: int) -> None:
        """Drop one referent's ref AND write the page off: when the
        last referent lets go it parks in the quarantined set instead
        of the free list."""
        self.quarantined.add(page)
        self.release(page)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def shared_count(self) -> int:
        return int(np.sum(self.ref > 1))

    def audit(self) -> Dict:
        """Exact page accounting (the no-leak/no-double-free pin):
        every non-scratch page is free, referenced, or quarantined —
        `leaked` must be 0 and no page may appear twice."""
        free = list(self._free)
        referenced = int(np.sum(self.ref[1:] > 0))
        quarantined_parked = sum(1 for p in self.quarantined
                                 if self.ref[p] == 0)
        usable = self.n_pages - 1
        return {
            "total": usable,
            "free": len(free),
            "referenced": referenced,
            "quarantined": quarantined_parked,
            "leaked": usable - len(free) - referenced
                      - quarantined_parked,
            "double_freed": len(free) != len(set(free))
                            or any(self.ref[p] != 0 for p in free),
        }


class _TrieNode:
    __slots__ = ("children", "partials")

    def __init__(self):
        # full page_size block -> (physical page, child node)
        self.children: Dict[Tuple[int, ...], Tuple[int, "_TrieNode"]] = {}
        # partial tail block (< page_size tokens) -> physical page
        self.partials: Dict[Tuple[int, ...], int] = {}


class PrefixTrie:
    """Shared-prefix page cache: a trie over page-aligned token
    blocks, content-addressed (dict hashing of the block tuple chains
    the parent path, so equal pages are equal prompt prefixes — no
    collision risk, vLLM-style block hashing with exact keys). A node
    maps one full `page_size` block to the physical page holding its
    K/V; `partials` additionally cache a prompt's sub-page tail so the
    Kth IDENTICAL prompt skips prefill entirely. The trie holds one
    pool ref per registered page; pages it holds alone (ref==1) are
    reclaimable cache, evicted LRU when the pool runs dry."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _TrieNode()
        self._tick = 0
        self._last_used: Dict[int, int] = {}
        # page -> (owning node, "child"|"partial", key) for removal
        self._where: Dict[int, Tuple[_TrieNode, str, tuple]] = {}

    def __len__(self) -> int:
        return len(self._where)

    def _touch(self, page: int) -> None:
        self._tick += 1
        self._last_used[page] = self._tick

    def match(self, prompt: Sequence[int]
              ) -> Tuple[List[int], int]:
        """Walk the prompt's block chain: returns (pages, covered) —
        the physical pages holding its longest cached prefix and how
        many tokens they cover. A partial (sub-page) entry only
        matches when it covers the prompt's ENTIRE tail, so coverage
        is always page-aligned or total."""
        ps = self.page_size
        node, pages, i = self.root, [], 0
        n = len(prompt)
        while i + ps <= n:
            ent = node.children.get(tuple(prompt[i:i + ps]))
            if ent is None:
                break
            page, node = ent
            pages.append(page)
            self._touch(page)
            i += ps
        if 0 < n - i < ps:
            page = node.partials.get(tuple(prompt[i:]))
            if page is not None:
                pages.append(page)
                self._touch(page)
                return pages, n
        return pages, i

    def register(self, prompt: Sequence[int],
                 table: Sequence[Optional[int]],
                 pool: PagePool) -> List[int]:
        """Insert the prompt's freshly computed pages (ring `table`
        entries — during prefill block b lives at table[b]) into the
        trie, one pool retain per inserted page. Blocks already cached
        (this slot's own trie hits, or a concurrent twin that
        registered first) are left untouched. Returns the pages THIS
        call inserted — the slot keeps them for poison purge."""
        ps = self.page_size
        node, i, b = self.root, 0, 0
        inserted: List[int] = []
        n = len(prompt)
        while i + ps <= n:
            blk = tuple(prompt[i:i + ps])
            ent = node.children.get(blk)
            if ent is None:
                page = table[b]
                ent = (page, _TrieNode())
                node.children[blk] = ent
                pool.retain(page)
                self._where[page] = (node, "child", blk)
                self._touch(page)
                inserted.append(page)
            node = ent[1]
            i += ps
            b += 1
        tail = tuple(prompt[i:])
        if tail and tail not in node.partials:
            page = table[b]
            node.partials[tail] = page
            pool.retain(page)
            self._where[page] = (node, "partial", tail)
            self._touch(page)
            inserted.append(page)
        return inserted

    def _drop(self, page: int, pool: PagePool,
              quarantine: bool) -> None:
        loc = self._where.pop(page, None)
        self._last_used.pop(page, None)
        if loc is None:
            return
        node, kind, key = loc
        if kind == "partial":
            node.partials.pop(key, None)
            (pool.quarantine if quarantine else pool.release)(page)
            return
        ent = node.children.pop(key, None)
        (pool.quarantine if quarantine else pool.release)(page)
        if ent is not None:
            # removing a middle block strands its subtree (a child
            # chain is only reachable through its parent) — release
            # every descendant registration too, or their refs leak
            self._drop_subtree(ent[1], pool, quarantine)

    def _drop_subtree(self, node: _TrieNode, pool: PagePool,
                      quarantine: bool) -> None:
        for key, page in list(node.partials.items()):
            node.partials.pop(key, None)
            self._where.pop(page, None)
            self._last_used.pop(page, None)
            (pool.quarantine if quarantine else pool.release)(page)
        for key, (page, child) in list(node.children.items()):
            node.children.pop(key, None)
            self._where.pop(page, None)
            self._last_used.pop(page, None)
            (pool.quarantine if quarantine else pool.release)(page)
            self._drop_subtree(child, pool, quarantine)

    def purge(self, pages: Sequence[int], pool: PagePool) -> None:
        """Poison purge: a quarantined slot's registrations must never
        be served to a later prefix hit — remove them (and any chains
        through them), quarantining pages the trie held alone."""
        for p in pages:
            self._drop(p, pool, quarantine=True)

    def evict_lru(self, pool: PagePool) -> bool:
        """Reclaim ONE least-recently-used trie-only page (ref==1 —
        no slot maps it) whose entry is a leaf (evicting a middle
        block would strand the cached chain below it). Returns True if
        a page went back to the free list."""
        best, best_tick = None, None
        for page, loc in self._where.items():
            if pool.ref[page] != 1:
                continue
            node, kind, key = loc
            if kind == "child":
                child = node.children[key][1]
                if child.children or child.partials:
                    continue
            tick = self._last_used.get(page, 0)
            if best_tick is None or tick < best_tick:
                best, best_tick = page, tick
        if best is None:
            return False
        self._drop(best, pool, quarantine=False)
        return True

    def clear(self, pool: PagePool) -> None:
        """Release every registration (disable/reset path)."""
        self._drop_subtree(self.root, pool, quarantine=False)


class DecodeEngine:
    """Slot-based continuous-batching server for one decoder model.

    `submit()` is non-blocking admission; a background loop (or
    explicit `step_once()` calls — the deterministic-test drive)
    advances every resident stream one token per decode dispatch.
    One DecodeProgram = one decode-step build serves arbitrary
    join/leave traffic; `stats()["trace_counts"]` is the pin.

    With `model=` the engine builds its DecodeProgram on the model's
    device (cuda unless the model was built with device="cpu").

    `watchdog_timeout_s=` supervises the loop thread: heartbeats feed
    a StepWatchdog whose escalation tears the engine down and restarts
    it (bounded by `max_engine_restarts`), recovering every live
    request via replay."""

    def __init__(self, model=None, max_slots: int = 8,
                 page_size: int = 16, queue_limit: Optional[int] = None,
                 admission=None, model_name: str = "decoder",
                 program=None, max_prefills_per_step: int = 1,
                 watchdog_timeout_s: Optional[float] = None,
                 max_engine_restarts: int = 3,
                 poison_strike_limit: int = 2,
                 n_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 journal=None, tracer=None,
                 flight_dir: Optional[str] = None,
                 flight_capacity: int = 512):
        from deeplearning4j_tpu_torch.engine.decode_program import (
            DecodeProgram,
        )

        if program is None:
            if model is None:
                raise ValueError("DecodeEngine needs a model or a "
                                 "DecodeProgram")
            program = DecodeProgram(model, max_slots=max_slots,
                                    page_size=page_size,
                                    n_pages=n_pages)
        self.program = program
        self.max_slots = program.max_slots
        self.prefix_cache = bool(prefix_cache)
        self.admission = admission
        self.model_name = model_name
        self.queue_limit = (int(queue_limit) if queue_limit is not None
                            else 2 * self.max_slots)
        # a join costs one prefill dispatch between decode steps; cap
        # how many joins one step pays for so an admission burst can't
        # stall resident streams (the prefill-vs-decode phase split)
        self.max_prefills_per_step = max(1, int(max_prefills_per_step))
        self.watchdog_timeout_s = watchdog_timeout_s
        self.max_engine_restarts = int(max_engine_restarts)
        self.poison_strike_limit = int(poison_strike_limit)
        self.kv = program.init_kv()
        s = self.max_slots
        self._tokens = np.zeros(s, np.int32)
        self._positions = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        self._quarantined = np.zeros(s, bool)
        self._slot_req: List[Optional[GenerationHandle]] = [None] * s
        self._slot_replay: List[Optional[deque]] = [None] * s
        # ---- paged KV virtual memory (host side) ----
        # per-slot ring page table: logical page (pos // page_size)
        # lives at ring index (pos // page_size) % pages_per_slot, so
        # positions wrap through the table past max_ctx
        p = program.pages_per_slot
        self._pool = PagePool(program.n_pages)
        self._trie: Optional[PrefixTrie] = (
            PrefixTrie(program.page_size) if self.prefix_cache
            else None)
        self._table: List[List[Optional[int]]] = [[None] * p
                                                  for _ in range(s)]
        # -1 = not filling; else the next prompt position to chunk
        self._fill_next = np.full(s, -1, np.int64)
        # True while the slot's NEXT decode dispatch is the uniform
        # first-token step: position len(prompt)-1, write suppressed
        # (the prompt's cells are already paged in), emitting the
        # first generated token — shared and unshared twins run the
        # exact same step, which is what makes prefix sharing bitwise
        self._first_step = np.zeros(s, bool)
        # pages each slot registered into the trie (poison purge set)
        self._trie_owned: List[List[int]] = [[] for _ in range(s)]
        # pending entries: (handle, replay_tokens or None)
        self._pending: deque = deque()
        # requests popped from pending but not yet resident (prefill
        # in flight) — still counted against capacity, so admission
        # can't oversubscribe through the placement window
        self._placing = 0
        self._cond = threading.Condition()
        self._step_lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._watchdog = None
        # restart epoch: a loop thread abandoned by a watchdog restart
        # sees the bumped epoch when it wakes and exits without
        # touching the rebuilt state
        self._epoch = 0
        self._zombies: List[threading.Thread] = []
        self._t0 = time.monotonic()
        self._tokens_emitted = 0
        self._steps = 0
        self._prefills = 0
        self._prefill_chunks = 0
        self._prefix_hits = 0          # joins that mapped >=1 page
        self._prefix_page_hits = 0     # pages mapped from the trie
        self._ctx_wraps = 0            # page recycles past the window
        self._cow_copies = 0
        self._evictions = 0
        self._completed = 0
        self._quarantines = 0
        self._replays = 0
        self._deadline_expired = 0
        self._cancelled = 0
        self._restarts = 0
        # ---- durable serving (serving/journal.py) ----
        # idempotency keys: live AND recently-done handles by request
        # id (bounded retention), so a client retry after an ambiguous
        # disconnect joins the original stream instead of
        # double-executing; the journal (when attached) is the
        # disk-backed leg of the same contract
        self._journal = None
        self._handles_by_id: Dict[str, GenerationHandle] = {}
        self._done_ids: deque = deque()
        self._done_retention = 1024
        self._recovered = 0
        # journal events collected under the step lock, written after
        # it (file I/O is never a step-lock holder)
        self._jevents: List[tuple] = []
        # ---- tracing + latency attribution + flight recorder ----
        # `tracer=None` is the zero-cost default: every span/record
        # site is gated on it. Latency events (queue wait, TTFT, ITL,
        # prefill chunks, span ends) ride the _jevents pattern: cheap
        # tuples collected under the step lock, metrics/spans emitted
        # after it.
        self.tracer = tracer
        self._lat: List[tuple] = []
        self._ttft_ring: deque = deque(maxlen=512)
        self._itl_ring: deque = deque(maxlen=512)
        self._queue_ring: deque = deque(maxlen=512)
        self._flight = FlightRecorder(capacity=flight_capacity,
                                      dump_dir=flight_dir,
                                      name=model_name)
        # dump reason flagged under the step lock, dumped after it
        # (the dump does file I/O — never a step-lock holder)
        self._flight_dump_reason: Optional[str] = None
        _LIVE_ENGINES.add(self)
        if journal is not None:
            self.attach_journal(journal)

    # -------------------------------------------------------- lifecycle
    def start(self) -> "DecodeEngine":
        with self._cond:
            if self._running:
                return self
            self._running = True
            epoch = self._epoch
        if self.watchdog_timeout_s and self._watchdog is None:
            from deeplearning4j_tpu_torch.resilience.supervisor import (
                StepWatchdog,
            )

            self._watchdog = StepWatchdog(
                timeout_s=self.watchdog_timeout_s,
                on_hang=self._on_hang)
            self._watchdog.start()
        self._spawn_loop(epoch)
        return self

    def _spawn_loop(self, epoch: int) -> None:
        name = ("DecodeEngine-loop" if not self._restarts
                else f"DecodeEngine-loop-r{self._restarts}")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name, args=(epoch,))
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def ensure_started(self) -> "DecodeEngine":
        if not self.running:
            return self.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            pending = list(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for z in self._zombies:
            z.join(timeout=2.0)
        self._zombies = []
        # fail whatever never reached a slot; resident streams keep
        # their partial output readable (tokens_so_far) but never
        # finish — mark them failed too so result() callers unblock
        err = ShutdownError("decode engine stopped")
        for handle, _ in pending:
            handle._finish(None, error=err)
            self._end_span(handle, "shutdown")
        for s in range(self.max_slots):
            if self._active[s] and self._slot_req[s] is not None:
                handle = self._slot_req[s]
                handle._finish(None, error=err)
                self._end_span(handle, "shutdown")
                self._free_slot(s)

    def _loop(self, epoch: int) -> None:
        dev = self.program.device
        if dev.type == "cuda":
            import torch

            # a new thread starts on device 0: run on the engine's
            # (the program's device carries its index, which set_device
            # requires)
            torch.cuda.set_device(dev)
        while True:
            with self._cond:
                if not self._running or epoch != self._epoch:
                    return
            try:
                # `decode.hang` chaos site: a `delay` spec wedges the
                # loop HERE — outside the step lock, before the beat —
                # so the watchdog sees heartbeats go stale exactly as
                # it would for a dispatch stuck in the runtime
                _fire("decode.hang")
            except FaultInjectedError:
                pass
            with self._cond:
                # a watchdog restart may have replaced this thread
                # while it was wedged: leave without touching state
                if not self._running or epoch != self._epoch:
                    return
            if self._watchdog is not None:
                self._watchdog.beat("decode", self._steps)
            worked = self.step_once()
            if not worked:
                with self._cond:
                    if self._running and epoch == self._epoch:
                        self._cond.wait(timeout=0.02)

    # --------------------------------------------------- hang recovery
    def _on_hang(self, phase: str, age_s: float) -> None:
        """StepWatchdog escalation (runs on the watchdog monitor
        thread): the loop thread went silent — tear the engine down
        and restart it with every live request recovered via replay,
        up to `max_engine_restarts`."""
        self._restart_engine(f"decode loop hung in phase {phase!r} "
                             f"({age_s:.1f}s without a heartbeat)")

    def _restart_engine(self, reason: str) -> None:
        with self._cond:
            if not self._running:
                return
            self._epoch += 1        # abandoned thread exits on wake
            epoch = self._epoch
            exhausted = self._restarts >= self.max_engine_restarts
            if not exhausted:
                self._restarts += 1
            if self._thread is not None:
                self._zombies.append(self._thread)
                self._thread = None
            if exhausted:
                self._running = False
            pending = list(self._pending)
            self._pending.clear()
        err = (RestartsExhaustedError(
            f"decode engine gave up after {self.max_engine_restarts} "
            f"restarts: {reason}") if exhausted else None)
        # rebuild slot state under the step lock. A loop thread wedged
        # INSIDE a dispatch would still hold it — bounded wait, then
        # abandon the lock object with the thread (the stale thread
        # releases a lock nothing else uses, and its epoch check stops
        # it before it can touch the rebuilt state).
        got = self._step_lock.acquire(timeout=2.0)
        try:
            live: List[Tuple[GenerationHandle, List[int]]] = []
            for s in range(self.max_slots):
                if self._active[s] and self._slot_req[s] is not None:
                    h = self._slot_req[s]
                    live.append((h, h.tokens_so_far()))
            self.kv = self.program.init_kv()
            self._tokens[:] = 0
            self._positions[:] = 0
            self._active[:] = False
            self._quarantined[:] = False   # fresh KV clears quarantine
            self._slot_req = [None] * self.max_slots
            self._slot_replay = [None] * self.max_slots
            self._placing = 0
            # fresh pool => fresh virtual memory: page table, trie,
            # refcounts, and page quarantine all restart from zero
            p = self.program.pages_per_slot
            self._pool = PagePool(self.program.n_pages)
            self._trie = (PrefixTrie(self.program.page_size)
                          if self.prefix_cache else None)
            self._table = [[None] * p for _ in range(self.max_slots)]
            self._fill_next[:] = -1
            self._first_step[:] = False
            self._trie_owned = [[] for _ in range(self.max_slots)]
        finally:
            if got:
                self._step_lock.release()
            else:
                self._step_lock = threading.Lock()
        self._flight.note("restart", self._steps,
                          reason=str(reason)[:120],
                          exhausted=exhausted)
        self._flight.dump("restart")
        if err is not None:
            for handle, _ in live:
                handle._finish(None, error=err)
                self._end_span(handle, "restarts_exhausted")
            for handle, _ in pending:
                handle._finish(None, error=err)
                self._end_span(handle, "restarts_exhausted")
            return
        with self._cond:
            self._pending.extend(pending)
            for handle, recorded in reversed(live):
                handle.replays += 1
                self._pending.appendleft((handle, recorded or None))
            self._cond.notify_all()
        _obs.count("dl4j_decode_engine_restarts_total")
        if self._watchdog is not None:
            self._watchdog.beat("restart", self._steps)
        self._spawn_loop(epoch)

    # -------------------------------------------------------- admission
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               resume_tokens: Optional[Sequence[int]] = None,
               request_id: Optional[str] = None,
               trace: Optional[str] = None
               ) -> GenerationHandle:
        """Admit one generation request (non-blocking). Raises
        QuotaExceededError (429 + Retry-After over HTTP) on tenant quota /
        priority shed (AdmissionController) or on slot exhaustion —
        every slot resident and the wait queue full.

        `resume_tokens` re-enters a stream that already emitted tokens
        elsewhere (cross-replica migration / reconnect): the engine
        re-prefills the ORIGINAL prompt and force-replays the recorded
        tokens through the shared loop, so the continuation is
        byte-identical to an uninterrupted run. `max_new_tokens` is
        the request's ORIGINAL budget (resume tokens count toward it).

        `deadline_s` bounds the request's wall-clock life from this
        submit: past it, the slot is freed and the handle finishes
        with its partial tokens and finish_reason "deadline".

        `request_id` is the idempotency key: re-submitting an id the
        engine already knows (live, recently done, or recovered from
        the journal) returns the ORIGINAL handle — nothing is
        double-journaled or double-executed. With a journal attached,
        the admitted record is written BEFORE the request becomes
        visible to the step loop (write-ahead).

        `trace` is the request's cross-process trace id (rode the wire
        meta next to request_id). It is journaled with the admitted
        record so a cold-restart recovery leg carries the original id;
        with a tracer attached and no id supplied, the engine mints
        one."""
        prompt = [int(t) for t in np.asarray(prompt, np.int64).ravel()]
        if not prompt:
            raise ValueError("prompt must carry at least one token")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # the prompt must fit the attention window; the GENERATION may
        # run past it — logical positions wrap through the page table
        # (ring wrap), attending over the last `window` positions
        if len(prompt) > self.program.window:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the attention "
                f"window {self.program.window}")
        resume = [int(t) for t in resume_tokens or []]
        if len(resume) > max_new_tokens:
            raise ValueError(
                f"resume_tokens ({len(resume)}) exceeds "
                f"max_new_tokens ({max_new_tokens})")
        rid = str(request_id) if request_id else uuid.uuid4().hex
        # idempotency: join the id's existing stream — live, finished,
        # or recovered — EXCEPT one that failed (engine shutdown): the
        # retry after such a failure (the resume-on-disconnect leg)
        # must get a fresh life, not the dead handle back
        with self._cond:
            existing = self._handles_by_id.get(rid)
        if existing is not None and not existing.failed:
            return existing
        tid = str(trace) if trace else None
        if tid is None and self.tracer is not None:
            from deeplearning4j_tpu_torch.observability.tracing import (
                new_trace_id,
            )

            tid = new_trace_id()
        handle = GenerationHandle(prompt, max_new_tokens, eos_id,
                                  deadline_s=deadline_s,
                                  request_id=rid, tenant=tenant,
                                  trace=tid)
        if self.tracer is not None:
            # the leg's root span: opened on the submitting thread (an
            # enclosing server span parents it implicitly), closed by
            # the post-step-lock drain when the stream finishes
            handle._span = self.tracer.begin(
                "generate", cat="decode",
                args={"trace": tid, "request_id": rid,
                      "tenant": tenant or "default",
                      "model": self.model_name,
                      "resumed": bool(resume)})
        if resume:
            handle._preload(resume)
            handle.replays += 1
            # the earlier life may already have finished the stream
            finished = None
            if eos_id is not None and resume[-1] == eos_id:
                finished = "eos"
            elif len(resume) >= max_new_tokens:
                finished = "length"
            if finished is not None:
                handle._finish(finished)
                self._end_span(handle, finished)
                with self._cond:
                    cur = self._handles_by_id.get(rid)
                    if cur is None or cur.failed:
                        self._handles_by_id[rid] = handle
                self._journal_safe(
                    lambda: self._journal.append_admitted(
                        rid, prompt, max_new_tokens, eos_id=eos_id,
                        tenant=tenant, deadline_s=deadline_s,
                        trace=handle.trace))
                self._journal_safe(
                    lambda: self._journal.record_progress(rid, resume))
                self._journal_safe(
                    lambda: self._journal.append_done(rid, finished))
                self._note_done_id(rid)
                return handle
        capacity = self.max_slots + self.queue_limit
        depth = self._in_flight()
        if self.admission is not None:
            self.admission.admit(tenant, self.model_name, depth,
                                 capacity)
        # WRITE-AHEAD: the admitted record (and any resume progress)
        # lands on disk before the step loop can see the request; a
        # shed below appends done("shed") so the journal stays clean
        self._journal_safe(lambda: self._journal.append_admitted(
            rid, prompt, max_new_tokens, eos_id=eos_id, tenant=tenant,
            deadline_s=deadline_s, trace=handle.trace))
        if resume:
            self._journal_safe(
                lambda: self._journal.record_progress(rid, resume))
        with self._cond:
            racer = self._handles_by_id.get(rid)
            if racer is not None and not racer.failed:
                return racer
            if (int(self._active.sum()) + len(self._pending)
                    + self._placing) >= capacity:
                shed = True
            else:
                shed = False
                self._handles_by_id[rid] = handle
                self._pending.append((handle, resume or None))
                self._cond.notify_all()
        if shed:
            self._journal_safe(
                lambda: self._journal.append_done(rid, "shed"))
            self._end_span(handle, "shed")
            raise QuotaExceededError(
                f"decode slots exhausted ({self.max_slots} resident, "
                f"{self.queue_limit} waiting)", tenant=tenant or "",
                retry_after_s=0.5)
        return handle

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 tenant: Optional[str] = None,
                 timeout_s: float = 60.0,
                 deadline_s: Optional[float] = None,
                 resume_tokens: Optional[Sequence[int]] = None
                 ) -> GenerationHandle:
        """submit + wait: returns the FINISHED handle (tokens via
        `.tokens_so_far()` / `.result()`)."""
        handle = self.submit(prompt, max_new_tokens, eos_id=eos_id,
                             tenant=tenant, deadline_s=deadline_s,
                             resume_tokens=resume_tokens)
        handle.result(timeout_s=timeout_s)
        return handle

    def _in_flight(self) -> int:
        with self._cond:
            return (int(self._active.sum()) + len(self._pending)
                    + self._placing)

    # ------------------------------------------ durability (journal)
    def attach_journal(self, journal,
                       recover: bool = True) -> "DecodeEngine":
        """Arm the write-ahead journal. With `recover=True` (the
        default), every request the journal holds LIVE — a previous
        process's crash — is re-submitted as a resume_tokens
        continuation through the bitwise replay path, under its
        original request id (so a client's idempotent re-submit joins
        the recovered stream). A live request a FRESH engine cannot
        carry (stale journal: prompt past this engine's window, or
        recovery overflowing capacity) is marked done("unrecoverable")
        instead of wedging recovery forever."""
        self._journal = journal
        if not recover:
            return self
        recovered = 0
        live = journal.live()
        for rid in sorted(live):
            req = live[rid]
            try:
                # the journaled trace id rides into the recovery leg,
                # so the cold-restart continuation merges into the
                # request's original timeline
                self.submit(req["prompt"], req["max_new_tokens"],
                            eos_id=req.get("eos_id"),
                            tenant=req.get("tenant"),
                            deadline_s=req.get("deadline_s"),
                            resume_tokens=req.get("tokens") or None,
                            request_id=rid,
                            trace=req.get("trace"))
                recovered += 1
            except (ValueError, QuotaExceededError):
                journal.append_done(rid, "unrecoverable")
        self._recovered += recovered
        if recovered:
            _obs.count("dl4j_journal_recovered_requests_total",
                       n=recovered)
        return self

    def _journal_safe(self, fn) -> None:
        """Run one journal operation, swallowing its failure: a sick
        journal degrades durability, it never takes the data plane
        down (the same guarded-telemetry discipline as _obs)."""
        if self._journal is None:
            return
        try:
            fn()
        except Exception:  # noqa — durability degrades, serving continues; journal failures must not poison the data plane
            pass

    def _end_span(self, handle: GenerationHandle,
                  reason: str) -> None:
        """Close a handle's leg-root span (no-op without a tracer).
        Only ever called OUTSIDE the step lock — span completion takes
        the tracer lock and may flush."""
        sp = handle._span
        if sp is not None:
            sp.end(finish_reason=reason)

    def _emit_latency(self, lat: List[tuple]) -> None:
        """Drain one step's latency events OUTSIDE the step lock:
        TTFT/ITL/queue-wait histogram observations (labeled by tenant
        class) plus — with a tracer attached — the matching span
        records (`Tracer.record` over the pre-measured intervals; no
        span objects ever exist on the locked path)."""
        tracer = self.tracer
        for kind, handle, a, b in lat:
            tenant = handle.tenant or "default"
            targs = None
            if tracer is not None:
                targs = {"trace": handle.trace,
                         "request_id": handle.request_id}
            if kind == "queue_wait":
                self._queue_ring.append(b - a)
                _obs.observe("dl4j_decode_queue_wait_seconds", b - a,
                             labels={"tenant": tenant})
                if tracer is not None:
                    tracer.record("admission_wait", a, b, cat="decode",
                                  parent=handle._span, args=targs)
            elif kind == "ttft":
                dt = b - handle.t_submit
                self._ttft_ring.append(dt)
                _obs.observe("dl4j_decode_ttft_seconds", dt,
                             labels={"tenant": tenant})
                if tracer is not None:
                    targs["first"] = True
                    tracer.record("token", a, b, cat="decode",
                                  parent=handle._span, args=targs)
            elif kind == "itl":
                self._itl_ring.append(b - a)
                _obs.observe("dl4j_decode_itl_seconds", b - a,
                             labels={"tenant": tenant})
                if tracer is not None:
                    tracer.record("token", a, b, cat="decode",
                                  parent=handle._span, args=targs)
            elif kind == "chunk":
                if tracer is not None:
                    tracer.record("prefill_chunk", a, b, cat="decode",
                                  parent=handle._span, args=targs)
            elif kind == "end":
                self._end_span(handle, a)

    def _note_done_id(self, rid: Optional[str]) -> None:
        """Bounded retention for finished idempotency keys: keep the
        last `_done_retention` done handles findable (a retry joins
        them) without growing the map forever."""
        if not rid:
            return
        with self._cond:
            self._done_ids.append(rid)
            while len(self._done_ids) > self._done_retention:
                self._handles_by_id.pop(self._done_ids.popleft(), None)

    def _write_journal(self, events: List[tuple]) -> None:
        """Drain one step's journal events OUTSIDE the step lock:
        progress deltas first (the journal computes the delta from the
        handle's full token list — absolute positions keep replays
        idempotent), then terminal records, then a group-commit
        checkpoint under the journal's fsync policy. Crash-shaped
        finishes (engine stop, restart exhaustion, evictions) are
        never in `events` — those streams must stay live on disk."""
        j = self._journal
        if j is None or not events:
            return
        progressed = set()
        for ev in events:
            kind, handle = ev[0], ev[1]
            rid = handle.request_id
            if rid is None:
                continue
            if kind == "progress":
                if rid in progressed:
                    continue
                progressed.add(rid)
                self._journal_safe(lambda h=handle: j.record_progress(
                    h.request_id, h.tokens_so_far()))
            else:
                # the final tokens land before the done marker
                self._journal_safe(lambda h=handle: j.record_progress(
                    h.request_id, h.tokens_so_far()))
                self._journal_safe(lambda h=handle, r=ev[2]:
                                   j.append_done(h.request_id, r))
                self._note_done_id(rid)
        self._journal_safe(lambda: j.flush(force=False))

    # ------------------------------------------------------------- step
    def step_once(self) -> bool:
        """One engine iteration: deadline/cancel sweep, chaos check,
        admit/advance chunked prefills to free healthy slots (bounded
        chunk dispatches), one shared decode dispatch over the
        translated page table, per-slot finite-verdict quarantine,
        harvest. Returns False when there was nothing to do. Public so
        tests drive churn deterministically without the loop thread.
        Telemetry (fault points aside, counters, gauges) fires OUTSIDE
        the step lock — emission is never a blocking op under a
        lock."""
        try:
            _fire("serving.slot_evict")
            evict = False
        except FaultInjectedError:
            evict = True
        prefill_s: List[float] = []
        quar_before = self._quarantines
        replays_before = self._replays
        chunks_before = self._prefill_chunks
        hits_before = self._prefix_page_hits
        wraps_before = self._ctx_wraps
        with self._step_lock:
            n_deadline, n_cancel = self._sweep_deadlines()
            evicted = self._evict_lowest_active() if evict else 0
            admitted, emitted = self._admit_pending(prefill_s)
            # slots still mid-prefill sit out the decode dispatch
            # (their rows compute scratch-backed garbage the harvest
            # ignores); everyone else needs a writable cell for the
            # current position — alloc / ring wrap / copy-on-write
            self._prepare_write_cells()
            decoding = self._active & (self._fill_next < 0)
            stepped = bool(decoding.any())
            if stepped:
                cp, co, wp, wo = self._step_tables(decoding)
                self.kv, nxt, ok = self.program.step(
                    self.kv, self._tokens, self._positions, cp, co,
                    wp, wo)
                # the step's one device-to-host read
                nxt_host, ok_host = host_outputs(nxt, ok)
                try:
                    # `decode.nonfinite` chaos site: force a poison
                    # verdict on the lowest decoding slot — the NaN
                    # drill without corrupting the shared weights. A
                    # hit must mean "this decode step" (the verdict it
                    # corrupts), so the fire cannot move outside the
                    # step lock; the injector is a flag check, not I/O.
                    # analyze: allow=thr-blocking-under-lock — chaos hit must align with the decode step it poisons
                    _fire("decode.nonfinite")
                except FaultInjectedError:
                    victims = np.flatnonzero(decoding)
                    if victims.size:
                        ok_host = ok_host.copy()
                        ok_host[victims[0]] = False
                self._steps += 1
                self._quarantine_poisoned(ok_host, decoding)
                emitted += self._harvest(nxt_host, decoding)
            jevents, self._jevents = self._jevents, []
            lat, self._lat = self._lat, []
            dump_reason, self._flight_dump_reason = (
                self._flight_dump_reason, None)
        chunks = self._prefill_chunks - chunks_before
        if chunks:
            _obs.count("dl4j_decode_prefill_chunks_total", n=chunks)
        hits = self._prefix_page_hits - hits_before
        if hits:
            _obs.count("dl4j_decode_prefix_hits_total", n=hits)
        wraps = self._ctx_wraps - wraps_before
        if wraps:
            _obs.count("dl4j_decode_ctx_wraps_total", n=wraps)
        if evicted:
            _obs.count("dl4j_decode_slot_evictions_total", n=evicted)
        if n_deadline:
            _obs.count("dl4j_decode_deadline_expired_total",
                       n=n_deadline)
        quar = self._quarantines - quar_before
        if quar:
            _obs.count("dl4j_decode_slot_quarantines_total", n=quar)
        replays = self._replays - replays_before
        if replays:
            _obs.count("dl4j_decode_replays_total", n=replays)
        for dt in prefill_s:
            _obs.observe("dl4j_decode_prefill_seconds", dt)
        if emitted:
            _obs.count("dl4j_decode_tokens_total", n=emitted)
        self._emit_latency(lat)
        if dump_reason is not None:
            self._flight.dump(dump_reason)
        self._publish_gauges()
        self._write_journal(jevents)
        return bool(stepped or admitted or chunks or evicted
                    or n_deadline or n_cancel)

    def _sweep_deadlines(self) -> Tuple[int, int]:
        """Finish expired/cancelled streams with their PARTIAL tokens
        (explicit finish_reason) and free their slots. Runs at the top
        of every step — a deadline costs at most one step of slack."""
        now = time.monotonic()

        def _verdict(handle: GenerationHandle) -> Optional[str]:
            if handle._cancel_requested:
                return "cancelled"
            if handle._deadline is not None and now >= handle._deadline:
                return "deadline"
            return None

        n_deadline = n_cancel = 0
        with self._cond:
            if self._pending:
                kept: deque = deque()
                for handle, replay in self._pending:
                    reason = _verdict(handle)
                    if reason is None:
                        kept.append((handle, replay))
                        continue
                    handle._finish(reason)
                    self._jevents.append(("done", handle, reason))
                    if self.tracer is not None:
                        self._lat.append(("end", handle, reason, None))
                    n_deadline += reason == "deadline"
                    n_cancel += reason == "cancelled"
                self._pending = kept
        for s in range(self.max_slots):
            if not self._active[s] or self._slot_req[s] is None:
                continue
            reason = _verdict(self._slot_req[s])
            if reason is None:
                continue
            handle = self._slot_req[s]
            handle._finish(reason)
            self._jevents.append(("done", handle, reason))
            if self.tracer is not None:
                self._lat.append(("end", handle, reason, None))
            self._flight.note("leave", self._steps, slot=s,
                              reason=reason)
            self._free_slot(s)
            n_deadline += reason == "deadline"
            n_cancel += reason == "cancelled"
        self._deadline_expired += n_deadline
        self._cancelled += n_cancel
        return n_deadline, n_cancel

    def _admit_pending(self, prefill_s: List[float]):
        """Spend this step's chunk budget: advance in-flight chunked
        prefills first (oldest slot first — a resident prompt finishes
        before a new one starts competing), then place waiting
        requests onto free healthy slots. A placement whose prompt is
        FULLY covered by the prefix trie costs zero chunk dispatches —
        the Kth same-prompt request skips prefill entirely (bounded
        only by free slots)."""
        admitted = False
        emitted = 0
        budget = self.max_prefills_per_step
        for s in range(self.max_slots):
            if budget <= 0:
                break
            if self._active[s] and self._fill_next[s] >= 0:
                budget -= self._advance_fill(s, prefill_s)
        while budget > 0:
            free = [s for s in range(self.max_slots)
                    if not self._active[s] and not self._quarantined[s]]
            if not free:
                break
            with self._cond:
                if not self._pending:
                    break
                handle, replay = self._pending.popleft()
                self._placing += 1
            try:
                budget -= self._place(handle, replay, free[0],
                                      prefill_s)
            finally:
                with self._cond:
                    self._placing -= 1
            admitted = True
        return admitted, emitted

    def _place(self, handle: GenerationHandle,
               replay: Optional[List[int]], slot: int,
               prefill_s: List[float]) -> int:
        """Make `handle` resident on `slot`: map its longest cached
        prefix from the trie (refcounted read-only pages — the
        shared-prefix capacity win), then start chunked prefill of
        whatever the trie did not cover. `replay`
        (eviction/quarantine/migration recovery) carries the
        already-emitted tokens: the uniform first-token step
        regenerates the first one (same programs, same cells —
        bitwise the same token) and the recorded stream is force-fed
        through the decode loop instead of re-emitted, so the output
        is unaffected by the recovery. Returns the chunk dispatches
        spent (0 on a full prefix hit)."""
        self._slot_req[slot] = handle
        self._active[slot] = True
        self._slot_replay[slot] = deque(replay) if replay else None
        if handle.t_placed is None:
            # first placement only: a re-placement after eviction is
            # recovery churn, not admission wait
            handle.t_placed = time.perf_counter()
            self._lat.append(("queue_wait", handle, handle.t_submit,
                              handle.t_placed))
        self._flight.note("join", self._steps, slot=slot,
                          req=handle.request_id, replay=bool(replay))
        if replay:
            # forced replay: the recorded token stream IS the truth
            # (greedy decode would regenerate it; forcing makes the
            # recovery independent of it)
            self._replays += 1
        covered = 0
        if self._trie is not None:
            pages, covered = self._trie.match(handle.prompt)
            for i, p in enumerate(pages):
                self._pool.retain(p)
                self._table[slot][i] = p
            if pages:
                self._prefix_hits += 1
                self._prefix_page_hits += len(pages)
        if covered >= len(handle.prompt):
            self._fill_next[slot] = -1
            self._fill_done(slot)
            return 0
        self._fill_next[slot] = covered
        return self._advance_fill(slot, prefill_s)

    def _advance_fill(self, slot: int, prefill_s: List[float]) -> int:
        """Dispatch ONE prompt chunk for a filling slot (page_size
        tokens into one freshly allocated page). Returns the chunk
        dispatches spent; 0 means the pool is exhausted beyond
        recovery this step — the fill resumes next step."""
        handle = self._slot_req[slot]
        prompt = handle.prompt
        ps = self.program.page_size
        start = int(self._fill_next[slot])
        page = self._alloc_page(slot)
        if page is None:
            return 0
        t0 = time.perf_counter()
        ring = (start // ps) % self.program.pages_per_slot
        self._table[slot][ring] = page
        cp, co = self.program.window_cells(self._table[slot],
                                           start - 1)
        self.kv = self.program.prefill_chunk(
            self.kv, prompt[start:start + ps], start, cp, co, page)
        self._prefill_chunks += 1
        t1 = time.perf_counter()
        prefill_s.append(t1 - t0)
        if self.tracer is not None:
            self._lat.append(("chunk", handle, t0, t1))
        self._flight.note("chunk", self._steps, slot=slot, start=start)
        nxt = start + ps
        if nxt >= len(prompt):
            self._fill_next[slot] = -1
            self._fill_done(slot)
        else:
            self._fill_next[slot] = nxt
        return 1

    def _fill_done(self, slot: int) -> None:
        """The slot's prompt K/V is fully paged in (computed, shared,
        or both): register its freshly computed pages into the trie
        and arm the uniform first-token step — a decode dispatch at
        position len(prompt)-1 with its WRITE SUPPRESSED (the cell
        already holds the prefill's K/V), emitting the first generated
        token. Shared and unshared twins run this exact step over
        identical cell values, which is why prefix sharing is
        bitwise-safe."""
        handle = self._slot_req[slot]
        if self._trie is not None:
            self._trie_owned[slot] = self._trie.register(
                handle.prompt, self._table[slot], self._pool)
        self._prefills += 1
        self._positions[slot] = len(handle.prompt) - 1
        self._tokens[slot] = handle.prompt[-1]
        self._first_step[slot] = True

    # ------------------------------------------------ page allocation
    def _alloc_page(self, for_slot: int) -> Optional[int]:
        """Allocate one physical page for `for_slot`, reclaiming under
        pressure: first LRU-evict trie-only cached pages, then evict
        other resident requests (youngest slot first — they requeue
        with replay, byte-identity preserved). Returns None only when
        nothing more can be reclaimed this step."""
        page = self._pool.alloc()
        if page is not None:
            return page
        while self._trie is not None and self._trie.evict_lru(
                self._pool):
            page = self._pool.alloc()
            if page is not None:
                return page
        victims = [s for s in range(self.max_slots)
                   if self._active[s] and s != for_slot]
        for v in reversed(victims):
            self._evict_slot(v)
            while (self._pool.free_count == 0
                   and self._trie is not None
                   and self._trie.evict_lru(self._pool)):
                pass
            page = self._pool.alloc()
            if page is not None:
                return page
        return None

    def _prepare_write_cells(self) -> None:
        """Before the decode dispatch, every decoding slot (first-token
        steps excepted — their write is suppressed) needs exclusive
        ownership of the page holding its current position's cell:
        alloc fresh territory, recycle its own ring entry past the
        window (ctx wrap), or copy-on-write a page something else
        still references (a trie registration or a prefix twin). A
        slot the pool cannot serve even after reclaim is evicted —
        it requeues with replay, losing nothing."""
        ps = self.program.page_size
        c = self.program.window
        p = self.program.pages_per_slot
        for s in range(self.max_slots):
            if (not self._active[s] or self._fill_next[s] >= 0
                    or self._first_step[s]):
                continue
            pos = int(self._positions[s])
            ring = (pos // ps) % p
            page = self._table[s][ring]
            if pos >= c and pos % ps == 0:
                # the ring entry comes back around: this slot starts
                # recycling its own oldest page (sliding the window)
                self._ctx_wraps += 1
            if page is None:
                page = self._alloc_page(s)
                if page is None:
                    self._evict_slot(s)
                    continue
                self._table[s][ring] = page
            elif self._pool.ref[page] > 1:
                # copy-on-write divergence: someone else (trie entry /
                # prefix twin) still reads this page — fork it before
                # the first private write lands
                fresh = self._alloc_page(s)
                if fresh is None:
                    self._evict_slot(s)
                    continue
                self.kv = self.program.copy_page(self.kv, page, fresh)
                self._pool.release(page)
                self._table[s][ring] = fresh
                self._cow_copies += 1

    def _step_tables(self, decoding: np.ndarray):
        """Translate the page table into the decode dispatch's cell
        index arrays: [S, window] (page, offset) pairs in logical
        token order per slot, plus each slot's write cell
        (first-token steps and non-decoding rows write scratch)."""
        from deeplearning4j_tpu_torch.engine.decode_program import (
            SCRATCH_PAGE,
        )

        s_n = self.max_slots
        c = self.program.window
        ps = self.program.page_size
        p = self.program.pages_per_slot
        cp = np.full((s_n, c), SCRATCH_PAGE, np.int32)
        co = np.zeros((s_n, c), np.int32)
        wp = np.full(s_n, SCRATCH_PAGE, np.int32)
        wo = np.zeros(s_n, np.int32)
        for s in np.flatnonzero(decoding):
            pos = int(self._positions[s])
            cp[s], co[s] = self.program.window_cells(self._table[s],
                                                     pos)
            if not self._first_step[s]:
                wp[s] = self._table[s][(pos // ps) % p]
                wo[s] = pos % ps
        return cp, co, wp, wo

    def _harvest(self, nxt_host: np.ndarray,
                 decoding: np.ndarray) -> int:
        emitted = 0
        # one clock read per step: every slot's token materialized in
        # the same dispatch, so they share a timestamp (TTFT/ITL marks
        # are tuples into _lat — emission happens after the step lock)
        now = time.perf_counter()
        for s in range(self.max_slots):
            if not decoding[s] or not self._active[s]:
                continue
            self._positions[s] += 1
            self._first_step[s] = False
            replay = self._slot_replay[s]
            if replay is not None:
                forced = replay.popleft()
                if not replay:
                    self._slot_replay[s] = None
                self._tokens[s] = forced
                continue
            tok = int(nxt_host[s])
            self._tokens[s] = tok
            handle = self._slot_req[s]
            handle._append(tok)
            self._jevents.append(("progress", handle))
            if handle.t_first_token is None:
                handle.t_first_token = now
                self._lat.append((
                    "ttft", handle,
                    (handle.t_placed if handle.t_placed is not None
                     else handle.t_submit), now))
            else:
                self._lat.append(("itl", handle,
                                  handle.t_last_token, now))
            handle.t_last_token = now
            emitted += 1
            self._tokens_emitted += 1
            self._maybe_finish(s, tok)
        return emitted

    def _maybe_finish(self, slot: int, tok: int) -> None:
        handle = self._slot_req[slot]
        if handle.eos_id is not None and tok == handle.eos_id:
            reason = "eos"
        elif len(handle.tokens_so_far()) >= handle.max_new_tokens:
            reason = "length"
        else:
            return
        handle._finish(reason)
        self._jevents.append(("done", handle, reason))
        if self.tracer is not None:
            self._lat.append(("end", handle, reason, None))
        self._flight.note("leave", self._steps, slot=slot,
                          reason=reason)
        self._free_slot(slot)
        self._completed += 1

    def _free_slot(self, slot: int) -> None:
        for ring, page in enumerate(self._table[slot]):
            if page is not None:
                self._pool.release(page)
                self._table[slot][ring] = None
        self._trie_owned[slot] = []
        self._fill_next[slot] = -1
        self._first_step[slot] = False
        self._active[slot] = False
        self._slot_req[slot] = None
        self._slot_replay[slot] = None
        self._positions[slot] = 0
        self._tokens[slot] = 0

    # --------------------------------------------------------- eviction
    def _evict_slot(self, s: int) -> None:
        """Rip slot `s`'s request out mid-flight and queue it — FRONT
        of the line — for re-prefill + replay on the next free slot.
        Its mapped pages drop back to the pool (trie-cached copies of
        a shared prefix survive, so the replay often costs nothing).
        Replay-in-progress streams requeue with their full recorded
        output; nothing is emitted twice."""
        handle = self._slot_req[s]
        recorded = handle.tokens_so_far()
        self._flight.note("evict", self._steps, slot=s,
                          req=handle.request_id)
        self._free_slot(s)
        handle.evictions += 1
        self._evictions += 1
        with self._cond:
            self._pending.appendleft((handle, recorded))
            self._cond.notify_all()

    def _evict_lowest_active(self) -> int:
        """Forced mid-generation eviction (the serving.slot_evict
        drill): evict the lowest-indexed active request. Returns the
        eviction count (the caller emits the metric outside the step
        lock)."""
        victims = [s for s in range(self.max_slots) if self._active[s]]
        if not victims:
            return 0
        self._evict_slot(victims[0])
        return 1

    # ------------------------------------------------------- quarantine
    def _quarantine_poisoned(self, ok_host: np.ndarray,
                             decoding: np.ndarray) -> None:
        """Apply the per-slot finite-logits verdict: a non-finite slot
        is quarantined — never offered to `_admit_pending` again — and
        its request replayed on a healthy slot exactly like an
        eviction. Quarantine is PAGE-granular against the pool: the
        slot's privately-owned pages (nothing else references them)
        are written off with it, but pages a trie entry or a prefix
        twin still reads merely drop this slot's reference — the
        poison wrote into the slot's private write cell, never into a
        shared read-only page. The victim's own trie registrations ARE
        suspect (it computed them) and are purged with quarantine
        semantics. A request that poisons `poison_strike_limit`+1
        slots carries the poison in its own tokens: abort it with
        GenerationPoisonedError instead of quarantining the whole
        batch one slot at a time."""
        for s in range(self.max_slots):
            if (not self._active[s] or not decoding[s]
                    or bool(ok_host[s])):
                continue
            handle = self._slot_req[s]
            recorded = handle.tokens_so_far()
            if self._trie is not None and self._trie_owned[s]:
                self._trie.purge(self._trie_owned[s], self._pool)
                self._trie_owned[s] = []
            for ring, page in enumerate(self._table[s]):
                if page is None:
                    continue
                if int(self._pool.ref[page]) <= 1:
                    self._pool.quarantine(page)
                else:
                    self._pool.release(page)
                self._table[s][ring] = None
            self._free_slot(s)
            self._quarantined[s] = True
            self._quarantines += 1
            self._flight.note("quarantine", self._steps, slot=s,
                              req=handle.request_id,
                              strikes=handle.poison_strikes + 1)
            self._flight_dump_reason = "quarantine"
            handle.poison_strikes += 1
            if handle.poison_strikes > self.poison_strike_limit:
                handle._finish(None, error=GenerationPoisonedError(
                    f"generation poisoned {handle.poison_strikes} "
                    f"slots (limit {self.poison_strike_limit}) — "
                    f"aborting instead of replaying further",
                    model=self.model_name,
                    strikes=handle.poison_strikes))
                self._jevents.append(("done", handle, "poisoned"))
                if self.tracer is not None:
                    self._lat.append(("end", handle, "poisoned",
                                      None))
                continue
            with self._cond:
                self._pending.appendleft((handle, recorded or None))
                self._cond.notify_all()

    # ------------------------------------------------------------ stats
    def _publish_gauges(self) -> None:
        active = int(self._active.sum())
        _obs.set_gauge("dl4j_decode_active_slots", active)
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        _obs.set_gauge("dl4j_decode_tokens_per_s",
                       self._tokens_emitted / elapsed)
        _obs.set_gauge("dl4j_decode_pages_free", self._pool.free_count)
        _obs.set_gauge("dl4j_decode_prefix_pages_shared",
                       self._pool.shared_count())

    def tokens_per_s(self) -> float:
        return self._tokens_emitted / max(time.monotonic() - self._t0,
                                          1e-9)

    def latency_stats(self) -> Dict:
        """Per-engine latency attribution over the recent-observation
        rings (p50/p99 — the /status decode facts; the fleet-wide
        histograms live in the metrics registry)."""
        return {
            "ttft_p50_s": _ring_quantile(self._ttft_ring, 0.5),
            "ttft_p99_s": _ring_quantile(self._ttft_ring, 0.99),
            "itl_p50_s": _ring_quantile(self._itl_ring, 0.5),
            "itl_p99_s": _ring_quantile(self._itl_ring, 0.99),
            "queue_wait_p50_s": _ring_quantile(self._queue_ring, 0.5),
            "queue_wait_p99_s": _ring_quantile(self._queue_ring, 0.99),
        }

    def stats(self) -> Dict:
        with self._cond:
            pending = len(self._pending)
        return {
            "model": self.model_name,
            "max_slots": self.max_slots,
            "active_slots": int(self._active.sum()),
            "pending": pending,
            "queue_limit": self.queue_limit,
            "page_size": self.program.page_size,
            "window": self.program.window,
            "pages": {
                "total": self.program.n_pages - 1,
                "free": self._pool.free_count,
                "shared": self._pool.shared_count(),
                "quarantined": len(self._pool.quarantined),
            },
            "prefix_hits": self._prefix_page_hits,
            "prefix_requests_hit": self._prefix_hits,
            "prefill_chunks": self._prefill_chunks,
            "ctx_wraps": self._ctx_wraps,
            "cow_copies": self._cow_copies,
            "trie_blocks": (len(self._trie)
                            if self._trie is not None else 0),
            "steps": self._steps,
            "prefills": self._prefills,
            "tokens_total": self._tokens_emitted,
            "completed": self._completed,
            "evictions": self._evictions,
            "quarantined_slots": int(self._quarantined.sum()),
            "quarantines": self._quarantines,
            "replays": self._replays,
            "deadline_expired": self._deadline_expired,
            "cancelled": self._cancelled,
            "engine_restarts": self._restarts,
            "tokens_per_s": round(self.tokens_per_s(), 3),
            "trace_counts": self.program.trace_stats()["trace_counts"],
            "dispatches": self.program.trace_stats().get("dispatches"),
            "latency": self.latency_stats(),
            "flight": self._flight.stats(),
            "tracing": (self.tracer.stats()
                        if self.tracer is not None else None),
            "journal": (dict(self._journal.stats(),
                             recovered=self._recovered)
                        if self._journal is not None else None),
        }


def sequential_decode(program, prompt: Sequence[int],
                      max_new_tokens: int,
                      eos_id: Optional[int] = None, kv=None,
                      slot: int = 0):
    """The per-request ORACLE: chunked prefill + one-stream decode on
    the same programs the engine runs, one request at a time,
    through a trivially deterministic page allocator (pages handed out
    in order, the ring reusing each slot page in place — no trie, no
    sharing, no CoW). Returns (kv, tokens). Continuous-batched output
    must equal this bitwise for every request regardless of slot
    churn, prefix sharing, or context wrap — the correctness bar that
    makes the paged virtual address space trustworthy."""
    from deeplearning4j_tpu_torch.engine.decode_program import (
        SCRATCH_PAGE,
    )

    if kv is None:
        kv = program.init_kv()
    prompt = list(prompt)
    ps = program.page_size
    pps = program.pages_per_slot
    table: List[Optional[int]] = [None] * pps
    next_free = 1  # page 0 is scratch

    def alloc() -> int:
        nonlocal next_free
        if next_free >= program.n_pages:
            raise RuntimeError("oracle page pool exhausted")
        next_free += 1
        return next_free - 1

    for start in program.chunk_starts(len(prompt)):
        ring = (start // ps) % pps
        if table[ring] is None:
            table[ring] = alloc()
        cp, co = program.window_cells(table, start - 1)
        kv = program.prefill_chunk(kv, prompt[start:start + ps],
                                   start, cp, co, table[ring])
    out: List[int] = []
    pos = len(prompt) - 1
    tok = prompt[-1]
    suppress = True  # first step: the prefill already wrote this cell
    s_n = program.max_slots
    c = program.window
    tokens = np.zeros(s_n, np.int32)
    positions = np.zeros(s_n, np.int32)
    while len(out) < max_new_tokens and (eos_id is None or not out
                                         or out[-1] != eos_id):
        cp = np.full((s_n, c), SCRATCH_PAGE, np.int32)
        co = np.zeros((s_n, c), np.int32)
        wp = np.full(s_n, SCRATCH_PAGE, np.int32)
        wo = np.zeros(s_n, np.int32)
        ring = (pos // ps) % pps
        if not suppress:
            if table[ring] is None:
                table[ring] = alloc()
            wp[slot] = table[ring]
            wo[slot] = pos % ps
        tokens[slot] = tok
        positions[slot] = pos
        cp[slot], co[slot] = program.window_cells(table, pos)
        kv, nxt, _ = program.step(kv, tokens, positions, cp, co,
                                  wp, wo)
        tok = int(nxt.cpu().numpy()[slot])
        out.append(tok)
        pos += 1
        suppress = False
    return kv, out
