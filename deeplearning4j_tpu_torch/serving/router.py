"""ReplicaRouter: client-side spreading over N ModelServer replicas
(counterpart of deeplearning4j_tpu/serving/router.py).

The scale-out half of the serving story: one logical client over many
server URLs. Per-replica health is the CircuitBreaker already wired
into every ModelClient (503s/connection failures trip it; any response
proves liveness); the router adds:

  picking    least-outstanding-requests among replicas whose breaker
             admits traffic (open circuits are skipped without paying
             a connection attempt), with round-robin tie-breaking so
             equal replicas share load;
  failover   an unavailable-class failure (connection error, retry
             exhaustion, 503, open circuit) moves the request to the
             next-best replica automatically — the caller sees one
             logical call. Responses that prove the server is alive
             but unhappy (400/404/429/500) surface immediately:
             another replica would answer the same.
  membership `add_replica`/`remove_replica` at runtime — the
             FleetController's autoscaler grows and shrinks the pool
             through these. Removal DRAINS by default: the replica
             stops being picked immediately, and the call blocks
             (bounded) until its in-flight requests finish. A replica
             removed mid-flight (autoscale shrink, replica kill) still
             fails over, but the failure is NOT counted against the
             removed replica's accounting — an orchestrated removal is
             not replica badness.

`NoHealthyReplicaError` (with the last failure as `cause` and the
fleet `membership` snapshot at failure time) is raised only when every
replica has been tried or is open-circuited.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import (
    CircuitOpenError,
    FaultInjectedError,
    NoHealthyReplicaError,
    RetriesExhaustedError,
    ServingError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire

# NOTE: ModelClient is imported lazily inside _default_factory —
# parallel/serving.py imports this package for the control-plane
# classes, so a module-level import here would be circular.

# failures that mean "this REPLICA is unavailable" — fail over.
_FAILOVER = (ConnectionError, OSError, TimeoutError,
             RetriesExhaustedError, CircuitOpenError)


def _default_factory(timeout: float):
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient

    return lambda url: ModelClient(url, timeout=timeout)


class _Replica:
    __slots__ = ("url", "client", "outstanding", "requests",
                 "failures", "draining")

    def __init__(self, url: str, client):
        self.url = url
        self.client = client
        self.outstanding = 0
        self.requests = 0
        self.failures = 0
        self.draining = False


class ReplicaRouter:
    """Spread requests across ModelServer replicas with
    least-outstanding picking, automatic failover, and runtime
    membership (`add_replica`/`remove_replica` with in-flight
    draining).

    `client_factory(url)` defaults to a ModelClient with its stock
    CircuitBreaker and retry policy; inject a factory to tune either
    (or to stub replicas in tests)."""

    def __init__(self, urls: List[str], timeout: float = 30.0,
                 client_factory: Optional[Callable] = None,
                 tracer=None):
        if not urls:
            raise ValueError("ReplicaRouter needs at least one URL")
        self._factory = client_factory or _default_factory(timeout)
        self._replicas = [_Replica(u.rstrip("/"), self._factory(u))
                          for u in urls]
        self._lock = threading.Lock()
        self._rr = 0
        self.failovers = 0
        # optional observability.tracing.Tracer: when set, generate()
        # opens a client-side root span and a per-leg span per replica
        # attempt so the merged timeline shows the migration hops
        self.tracer = tracer

    # ----------------------------------------------------- membership
    def urls(self) -> List[str]:
        """Current fleet membership (draining replicas included — they
        are still finishing in-flight work)."""
        with self._lock:
            return [r.url for r in self._replicas]

    def add_replica(self, url: str, client=None) -> None:
        """Join a replica to the pool; it becomes pickable
        immediately. `client` defaults to one from the router's
        factory."""
        url = url.rstrip("/")
        with self._lock:
            if any(r.url == url for r in self._replicas):
                raise ValueError(f"replica {url!r} is already a member")
        # client construction stays outside the lock (it may do I/O)
        replica = _Replica(url, client if client is not None
                           else self._factory(url))
        with self._lock:
            if any(r.url == url for r in self._replicas):
                raise ValueError(f"replica {url!r} is already a member")
            self._replicas.append(replica)

    def remove_replica(self, url: str, drain: bool = True,
                       drain_timeout_s: float = 10.0) -> bool:
        """Leave the pool. The replica stops being picked immediately;
        with `drain=True` the call waits (bounded) for its in-flight
        requests to finish before membership drops. Returns True when
        the replica left with zero requests still in flight."""
        url = url.rstrip("/")
        with self._lock:
            target = next((r for r in self._replicas if r.url == url),
                          None)
            if target is None:
                raise ValueError(f"no replica {url!r} in the pool")
            target.draining = True
        deadline = time.monotonic() + (drain_timeout_s if drain else 0.0)
        while True:
            with self._lock:
                clear = target.outstanding == 0
            if clear or time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r is not target]
        return clear

    def _is_member(self, replica: _Replica) -> bool:
        with self._lock:
            return any(r is replica for r in self._replicas) \
                and not replica.draining

    # -------------------------------------------------------- picking
    def _pick(self, exclude: set) -> Optional[_Replica]:
        """Least outstanding among breaker-admitting, non-draining
        replicas not yet tried for this request; round-robin offset
        breaks ties so idle-equal replicas alternate."""
        with self._lock:
            n = len(self._replicas)
            best, best_key = None, None
            for i in range(n):
                r = self._replicas[(self._rr + i) % n]
                if r.url in exclude or r.draining:
                    continue
                if r.client.breaker is not None \
                        and not r.client.breaker.allow():
                    continue
                key = r.outstanding
                if best is None or key < best_key:
                    best, best_key = r, key
            if best is not None:
                self._rr = (self._rr + 1) % n
                best.outstanding += 1
                best.requests += 1
            return best

    def _release(self, r: _Replica, failed: bool) -> None:
        with self._lock:
            r.outstanding -= 1
            if failed:
                r.failures += 1

    # -------------------------------------------------------- calling
    def _call(self, fn: Callable[[_Replica], dict]) -> dict:
        tried: set = set()
        causes: list = []
        last: Optional[Exception] = None
        while True:
            r = self._pick(tried)
            if r is None:
                break
            tried.add(r.url)
            try:
                out = fn(r)
            except _FAILOVER as exc:
                # a replica removed mid-flight (shrink or kill) fails
                # over WITHOUT the failure counting against it — the
                # removal was orchestrated, not replica badness
                removed = not self._is_member(r)
                self._release(r, failed=not removed)
                if not removed:
                    last = exc
                    causes.append((r.url, exc))
                    with self._lock:
                        self.failovers += 1
                    _obs.count("dl4j_serving_replica_failovers_total")
                continue
            except ServingError as exc:
                removed = not self._is_member(r)
                self._release(r, failed=exc.retryable and not removed)
                if exc.retryable:   # 503/429: the replica is drowning
                    if not removed:
                        last = exc
                        causes.append((r.url, exc))
                        with self._lock:
                            self.failovers += 1
                        _obs.count(
                            "dl4j_serving_replica_failovers_total")
                    continue
                raise               # 400/404/500: same answer anywhere
            self._release(r, failed=False)
            return out
        raise NoHealthyReplicaError(
            f"no healthy replica answered (tried {sorted(tried)}; "
            f"last: {last!r})", cause=last, membership=self.urls(),
            causes=causes)

    def predict(self, inputs, model: Optional[str] = None,
                tenant: Optional[str] = None,
                decode_top: int = 0) -> dict:
        return self._call(lambda r: r.client.predict(
            inputs, decode_top=decode_top, model=model, tenant=tenant))

    @staticmethod
    def _resumable_partial(exc: Exception) -> Optional[dict]:
        """The resumable-partial body a retiring replica shipped with
        its failure, or None when the failure carries none."""
        if isinstance(exc, RetriesExhaustedError):
            exc = exc.cause
        if isinstance(exc, ServingError):
            body = exc.body or {}
            if body.get("resumable") and body.get("tokens") is not None:
                return body
        return None

    def generate(self, prompt, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 resume_tokens: Optional[list] = None,
                 request_id: Optional[str] = None,
                 trace: Optional[str] = None) -> dict:
        """One logical generation over the fleet, with cross-replica
        MIGRATION: when the serving replica dies or retires
        mid-generation, its resumable 503 body (tokens decoded so far)
        is re-dispatched to the next healthy replica as a continuation
        — the target re-prefills the ORIGINAL prompt and force-replays
        the recorded tokens through the shared decode loop, so the
        final stream is byte-identical to an un-faulted run. A
        hard-killed replica leaves no partial; the request restarts
        from the prompt, which greedy decode makes byte-identical
        anyway. The armed `serving.migrate_fail` fault drops the
        continuation (the handoff itself failed) and the request
        restarts from the prompt — still losing nothing.

        The response dict gains `migrations`: how many times this
        request's partial stream moved between replicas.

        `request_id` (client-generated here when not supplied) is ONE
        idempotency key for the whole logical request: every failover
        attempt carries it, so a replica that already journaled the
        stream — including one recovered from its journal after a
        fleet-wide outage — joins it instead of double-executing.

        `trace` rides the same road: ONE trace id for the whole
        logical request, re-sent with every failover attempt, so the
        legs a migrating generation leaves on different replicas merge
        into a single timeline (observability.tracing
        `merge_chrome_traces`). Minted here when the router has a
        tracer and the caller supplied none."""
        rid = str(request_id) if request_id else uuid.uuid4().hex
        tid = str(trace) if trace else None
        if self.tracer is not None:
            if tid is None:
                from deeplearning4j_tpu_torch.observability.tracing import (
                    new_trace_id,
                )
                tid = new_trace_id()
            with self.tracer.span("client.generate", cat="client",
                                  args={"trace": tid,
                                        "request_id": rid}):
                return self._generate_attempts(
                    prompt, max_new_tokens, eos_id, model, tenant,
                    timeout_s, deadline_s, resume_tokens, rid, tid)
        return self._generate_attempts(
            prompt, max_new_tokens, eos_id, model, tenant, timeout_s,
            deadline_s, resume_tokens, rid, tid)

    def _leg_span(self, tid, url, t0, ok: bool) -> None:
        """One pre-measured `client.leg` span per replica attempt —
        failed legs show on the timeline too (that's the point)."""
        if self.tracer is None or tid is None:
            return
        self.tracer.record("client.leg", t0, time.perf_counter(),
                           cat="client",
                           args={"trace": tid, "replica": url,
                                 "ok": ok})

    def _generate_attempts(self, prompt, max_new_tokens, eos_id, model,
                           tenant, timeout_s, deadline_s, resume_tokens,
                           rid, tid) -> dict:
        tried: set = set()
        causes: list = []
        last: Optional[Exception] = None
        resume = ([int(t) for t in resume_tokens]
                  if resume_tokens else [])
        migrations = 0
        while True:
            r = self._pick(tried)
            if r is None:
                break
            tried.add(r.url)
            continuation = list(resume)
            if continuation:
                try:
                    _fire("serving.migrate_fail")
                except FaultInjectedError:
                    # the migration handoff itself failed: drop the
                    # tokens-so-far and restart from the prompt on this
                    # replica — greedy decode is deterministic, so the
                    # output is unchanged either way
                    continuation = []
            if continuation:
                migrations += 1
                _obs.count("dl4j_decode_migrations_total")
            t_leg = time.perf_counter()
            try:
                # max_resumes=0: migration is the ROUTER's job here —
                # the client surfaces the resumable failure instead of
                # hammering the same dying replica with continuations
                out = r.client.generate(
                    prompt, max_new_tokens, eos_id=eos_id, model=model,
                    tenant=tenant, timeout_s=timeout_s,
                    deadline_s=deadline_s,
                    resume_tokens=continuation or None, max_resumes=0,
                    request_id=rid, trace=tid)
            except _FAILOVER as exc:
                self._leg_span(tid, r.url, t_leg, ok=False)
                removed = not self._is_member(r)
                self._release(r, failed=not removed)
                partial = self._resumable_partial(exc)
                if partial is not None:
                    got = partial.get("tokens") or []
                    if len(got) > len(resume):
                        resume = [int(t) for t in got]
                if not removed:
                    last = exc
                    causes.append((r.url, exc))
                    with self._lock:
                        self.failovers += 1
                    _obs.count("dl4j_serving_replica_failovers_total")
                continue
            except ServingError as exc:
                self._leg_span(tid, r.url, t_leg, ok=False)
                removed = not self._is_member(r)
                partial = self._resumable_partial(exc)
                self._release(r, failed=exc.retryable and not removed)
                if partial is not None:
                    got = partial.get("tokens") or []
                    if len(got) > len(resume):
                        resume = [int(t) for t in got]
                if not (exc.retryable or partial is not None):
                    raise       # 400/404/500: same answer anywhere
                if not removed:
                    last = exc
                    causes.append((r.url, exc))
                    with self._lock:
                        self.failovers += 1
                    _obs.count("dl4j_serving_replica_failovers_total")
                continue
            self._leg_span(tid, r.url, t_leg, ok=True)
            self._release(r, failed=False)
            out["migrations"] = migrations
            if tid is not None:
                out.setdefault("trace", tid)
            return out
        raise NoHealthyReplicaError(
            f"no healthy replica finished the generation "
            f"(tried {sorted(tried)}; last: {last!r})", cause=last,
            membership=self.urls(), causes=causes)

    def status(self, model: Optional[str] = None) -> dict:
        return self._call(lambda r: r.client.status(model=model))

    # ---------------------------------------------------------- facts
    def stats(self) -> dict:
        with self._lock:
            return {
                "failovers": self.failovers,
                "replicas": [{
                    "url": r.url,
                    "outstanding": r.outstanding,
                    "requests": r.requests,
                    "failures": r.failures,
                    "draining": r.draining,
                    "breaker": (r.client.breaker.state
                                if r.client.breaker is not None
                                else None),
                } for r in self._replicas],
            }
