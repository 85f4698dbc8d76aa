"""Runtime concurrency sanitizer: lock-order + long-held-lock
(counterpart of deeplearning4j_tpu/analysis/sanitizers.py).

`LockOrderSanitizer.install()` replaces the `threading.Lock` /
`threading.RLock` factories with proxy-producing ones. Every proxy
knows its *creation site* (file:line), and every acquisition records
one edge per lock already held by the acquiring thread:

    held A, acquiring B   =>   edge  A -> B

Two threads acquiring the same pair in opposite orders produce the
cycle A -> B -> A — a potential deadlock even if the interleaving
never actually wedged this run. That is the point: the sanitizer turns
"we got lucky this time" into a failed test. It also flags locks held
longer than `long_hold_s` (a blocking operation living inside a
critical section — the runtime twin of thr-blocking-under-lock).

Arm it in a process with `install_from_env()` under

    DL4J_TPU_SANITIZE=locks

(or `LockOrderSanitizer().install()` directly, as chip_smoke.py's
analysis phase does around a serving and decode run). Only locks
created *after* install() are tracked; the production
threads (batcher/completion/watchdog/flush) all create their locks at
object construction time, so constructing the system under test with
the sanitizer armed covers them.

Edges aggregate by creation site, not lock instance, so an A→B/B→A
inversion between two *instances* of the same pair of sites is still a
cycle — exactly how native lock-order sanitizers (e.g. TSan's deadlock
detector) aggregate.

queue.Queue put/get ordering rides the SAME graph (the closed analyzer
gap): a `queue.Queue` created from an in-scope file becomes a node
(`q:file:line`). A *blocking* put on a BOUNDED queue (the only put
that can wedge) while holding lock L records the producer edge
``L -> Q``; after a blocking get returns, every lock the consumer
acquires before its next queue operation records the handoff edge
``Q -> L`` — "processing the item needs L". Together they catch the
classic coupled-queue deadlock (producer holds L blocked on a full
put; the consumer that would drain it needs L) as the cycle
``L -> Q -> L``, even on runs where the interleaving got lucky. Only
the three methods are instrumented — the queue's internal mutex and
conditions are created from stdlib frames and stay REAL C locks (see
DEFAULT_SCOPE below for why that is load-bearing).
"""

from __future__ import annotations

import os
import queue as _queue_mod
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

ENV_VAR = "DL4J_TPU_SANITIZE"

# real factories/methods, captured before any install() can patch them
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_Q_INIT = _queue_mod.Queue.__init__
_REAL_Q_PUT = _queue_mod.Queue.put
_REAL_Q_GET = _queue_mod.Queue.get

_ACTIVE: Optional["LockOrderSanitizer"] = None


def _creation_frame(skip_files: Tuple[str, ...]):
    """(path, lineno) of the first frame outside this module and
    threading.py — the lock's creation site."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if fn.endswith(skip_files) or "threading.py" in fn:
            continue
        return fn, frame.lineno
    return "<unknown>", 0


@dataclass
class _Held:
    proxy: "_LockProxy"
    count: int
    t0: float


class _HeldStack(threading.local):
    def __init__(self):
        self.stack: List[_Held] = []
        # queue-handoff marker: the site of the tracked queue this
        # thread last blocking-got from (None once the thread performs
        # its next queue operation) — locks acquired while it is set
        # record the consumer edge Q -> L
        self.qmark: Optional[str] = None


@dataclass
class Edge:
    src: str
    dst: str
    thread: str
    stack: str = ""


@dataclass
class LongHold:
    site: str
    duration_s: float
    thread: str


class _LockProxy:
    """Wraps one real lock; reports acquisitions to the sanitizer."""

    _SAN_IS_RLOCK = False

    def __init__(self, san: "LockOrderSanitizer", inner, site: str):
        self._san = san
        self._inner = inner
        self._site = site

    # ------------------------------------------------------- lock API
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san._note_acquire(self)
        return got

    def release(self):
        self._san._note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<sanitized {type(self._inner).__name__} @{self._site}>"


class _RLockProxy(_LockProxy):
    _SAN_IS_RLOCK = True

    # Condition-variable protocol: keep the sanitizer's held-stack
    # accounting exact across cond.wait()'s full release/re-acquire
    def _release_save(self):
        state = self._inner._release_save()
        self._san._note_release(self, all_levels=True)
        return state

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        self._san._note_acquire(self)

    def _is_owned(self):
        return self._inner._is_owned()

    def locked(self):
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else False


class LockOrderSanitizer:
    """Build the cross-thread lock-acquisition graph; detect cycles
    (potential deadlocks) and long-held locks."""

    # only locks created from files matching these substrings are
    # proxied. Scoping matters beyond noise: stdlib internals
    # (queue.Queue's mutex, executor work queues) are waited on by
    # daemon threads straight through interpreter finalization, where
    # a pure-Python acquire frame is a fatal error — those must stay
    # real C locks.
    DEFAULT_SCOPE = ("deeplearning4j_tpu_torch", "test")

    def __init__(self, long_hold_s: float = 1.0,
                 scope: Tuple[str, ...] = DEFAULT_SCOPE):
        self.long_hold_s = float(long_hold_s)
        self.scope = tuple(scope)
        self._meta = _REAL_LOCK()
        self._edges: Dict[Tuple[str, str], Edge] = {}
        self._long_holds: List[LongHold] = []
        self._held = _HeldStack()
        self._installed = False
        self._skip = (os.path.abspath(__file__),)

    # -------------------------------------------------------- install
    def install(self) -> "LockOrderSanitizer":
        global _ACTIVE
        if self._installed:
            return self
        san = self

        def make_lock():
            path, lineno = _creation_frame(san._skip)
            if not any(p in path for p in san.scope):
                return _REAL_LOCK()
            return _LockProxy(san, _REAL_LOCK(),
                              f"{os.path.basename(path)}:{lineno}")

        def make_rlock():
            path, lineno = _creation_frame(san._skip)
            if not any(p in path for p in san.scope):
                return _REAL_RLOCK()
            return _RLockProxy(san, _REAL_RLOCK(),
                               f"{os.path.basename(path)}:{lineno}")

        threading.Lock = make_lock
        threading.RLock = make_rlock

        # queue.Queue: instrument the three methods IN PLACE (so
        # pre-existing subclasses stay subclasses); only instances
        # created from in-scope frames get a `_san_site` and report.
        # The queue's own mutex/conditions come from stdlib creation
        # frames and therefore stay real C locks.
        def q_init(q, maxsize: int = 0):
            _REAL_Q_INIT(q, maxsize)
            path, lineno = _creation_frame(san._skip)
            if any(p in path for p in san.scope):
                q._san_site = f"q:{os.path.basename(path)}:{lineno}"

        def q_put(q, item, block: bool = True, timeout=None):
            site = getattr(q, "_san_site", None)
            # only a blocking put on a BOUNDED queue can wedge
            if site is not None and block and q.maxsize > 0:
                san._note_queue_put(site)
            return _REAL_Q_PUT(q, item, block, timeout)

        def q_get(q, block: bool = True, timeout=None):
            item = _REAL_Q_GET(q, block, timeout)
            site = getattr(q, "_san_site", None)
            if site is not None and block:
                san._note_queue_get(site)
            return item

        _queue_mod.Queue.__init__ = q_init
        _queue_mod.Queue.put = q_put
        _queue_mod.Queue.get = q_get
        self._installed = True
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if not self._installed:
            return
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        _queue_mod.Queue.__init__ = _REAL_Q_INIT
        _queue_mod.Queue.put = _REAL_Q_PUT
        _queue_mod.Queue.get = _REAL_Q_GET
        self._installed = False
        if _ACTIVE is self:
            _ACTIVE = None

    # ----------------------------------------------------- accounting
    def _record_edge(self, src: str, dst: str) -> None:
        if src == dst:
            return
        key = (src, dst)
        if key not in self._edges:
            tb = "".join(traceback.format_stack(limit=8)[:-2])
            with self._meta:
                if key not in self._edges:
                    self._edges[key] = Edge(
                        src, dst, threading.current_thread().name, tb)

    def _note_acquire(self, proxy: _LockProxy) -> None:
        stack = self._held.stack
        for held in stack:
            if held.proxy is proxy:          # RLock re-entry: no edge
                held.count += 1
                return
        now = time.perf_counter()
        if stack:
            self._record_edge(stack[-1].proxy._site, proxy._site)
        if self._held.qmark is not None:
            # consumer half of a queue handoff: processing the item
            # this thread got from Q needs this lock  =>  Q -> L
            self._record_edge(self._held.qmark, proxy._site)
        stack.append(_Held(proxy, 1, now))

    def _note_queue_put(self, site: str) -> None:
        """Blocking put on a bounded tracked queue: producer edge
        held-lock -> Q (the put can wedge while the lock is held)."""
        stack = self._held.stack
        if stack:
            self._record_edge(stack[-1].proxy._site, site)
        self._held.qmark = None       # a queue op ends the handoff window

    def _note_queue_get(self, site: str) -> None:
        """Blocking get returned: open the handoff window — locks this
        thread acquires before its next queue op record Q -> L."""
        if self._held.stack:
            # a blocking get UNDER a lock is itself a wedge hazard
            self._record_edge(self._held.stack[-1].proxy._site, site)
        self._held.qmark = site

    def _note_release(self, proxy: _LockProxy,
                      all_levels: bool = False) -> None:
        stack = self._held.stack
        for i in range(len(stack) - 1, -1, -1):
            held = stack[i]
            if held.proxy is not proxy:
                continue
            held.count -= 1
            if all_levels:
                held.count = 0
            if held.count <= 0:
                dur = time.perf_counter() - held.t0
                if dur >= self.long_hold_s:
                    with self._meta:
                        self._long_holds.append(LongHold(
                            proxy._site, dur,
                            threading.current_thread().name))
                stack.pop(i)
            return

    # -------------------------------------------------------- reports
    def edges(self) -> List[Edge]:
        with self._meta:
            return list(self._edges.values())

    def cycles(self) -> List[List[str]]:
        """Simple cycles in the site graph, each reported once in
        canonical rotation (smallest site first)."""
        with self._meta:
            adj: Dict[str, Set[str]] = {}
            for (src, dst) in self._edges:
                adj.setdefault(src, set()).add(dst)
        out: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str],
                visited: Set[str]) -> None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start and len(path) > 1:
                    i = path.index(min(path))
                    out.add(tuple(path[i:] + path[:i]))
                elif nxt not in visited and len(path) < 16:
                    visited.add(nxt)
                    dfs(start, nxt, path + [nxt], visited)
                    visited.discard(nxt)

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return [list(c) for c in sorted(out)]

    def long_holds(self) -> List[LongHold]:
        with self._meta:
            return list(self._long_holds)

    def violations(self) -> List[dict]:
        """Findings-shaped dicts for the two runtime rules."""
        out = []
        for cyc in self.cycles():
            out.append({
                "rule": "san-lock-order-cycle",
                "sites": cyc,
                "message": "cyclic lock order " +
                           " -> ".join(cyc + [cyc[0]]) +
                           " — potential deadlock",
            })
        for lh in self.long_holds():
            out.append({
                "rule": "san-long-held-lock",
                "sites": [lh.site],
                "message": f"lock at {lh.site} held "
                           f"{lh.duration_s:.3f}s by {lh.thread} "
                           f"(threshold {self.long_hold_s:.3f}s)",
            })
        return out

    def reset(self) -> None:
        with self._meta:
            self._edges.clear()
            self._long_holds.clear()


# ------------------------------------------------------------- wiring
def active_sanitizer() -> Optional[LockOrderSanitizer]:
    return _ACTIVE


def enabled_modes() -> Set[str]:
    raw = os.environ.get(ENV_VAR, "")
    return {m.strip() for m in raw.split(",") if m.strip()}


def install_from_env(long_hold_s: float = 1.0
                     ) -> Optional[LockOrderSanitizer]:
    """Install the lock sanitizer iff DL4J_TPU_SANITIZE names `locks`.
    Returns the active sanitizer (new or pre-existing) or None."""
    if "locks" not in enabled_modes():
        return None
    if _ACTIVE is not None:
        return _ACTIVE
    return LockOrderSanitizer(long_hold_s=long_hold_s).install()
