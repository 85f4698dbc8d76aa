"""Typed failures (a copy of the classes of deeplearning4j_tpu/resilience/errors.py
that the ported serving, decode, model-loading, retry and training paths
raise). Callers route on type: shed load (Overloaded, QuotaExceeded),
surface (Shutdown / Unavailable), fail over (integrity, NoHealthyReplica),
stop training (non-finite, preempted), abort one generation
(GenerationPoisoned), map to HTTP (ModelNotFound, ServingError), refuse a
rollout (RolloutHeld)."""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base for every typed failure raised by this subsystem."""


class FaultInjectedError(ResilienceError):
    """Raised by FaultInjector 'raise' faults (a simulated crash)."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


class ShutdownError(ResilienceError):
    """The component was shut down; queued/pending work was cancelled."""


class OverloadedError(ResilienceError):
    """Bounded queue is full — backpressure instead of unbounded latency.

    `retry_after_s` is advisory (surfaced as HTTP Retry-After)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(ResilienceError):
    """An operation did not finish within its deadline."""


class InferenceUnavailableError(ResilienceError):
    """The batcher thread died; this front-end can no longer serve."""


class CircuitOpenError(ResilienceError):
    """CircuitBreaker is open — calls are rejected without attempting."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RetriesExhaustedError(ResilienceError):
    """Retry gave up; `cause` is the last underlying exception."""

    def __init__(self, msg: str, cause: Exception, attempts: int):
        super().__init__(msg)
        self.cause = cause
        self.attempts = attempts


class CheckpointIntegrityError(ResilienceError):
    """A checkpoint/model file failed checksum or structural validation."""


class CheckpointDivergenceError(CheckpointIntegrityError):
    """Per-rank checkpoints for one step disagree with NO quorum digest
    (a tie, or no strict majority): the replicas have silently forked
    and no copy can be trusted as "the" training state. Resume must
    fail loudly instead of electing an arbitrary fork. `step` is the
    contested step; `votes` maps state digest -> the ranks holding it."""

    def __init__(self, msg: str, step: int | None = None,
                 votes: dict | None = None):
        super().__init__(msg)
        self.step = step
        self.votes = votes or {}


class NonFiniteLossError(ResilienceError):
    """Non-finite loss/params (or an unrecoverable loss spike) detected
    by the training guard — raised by policy='abort', or when a
    skip/rollback policy exhausted its recovery budget."""


class StepHangError(ResilienceError):
    """The step watchdog saw no heartbeat within its timeout: a hung
    collective, data iterator, or host sync. TrainingMaster lets it
    through its data retries as an escalation, not a data failure."""


class PreemptedError(ResilienceError):
    """Preemption (SIGTERM/SIGINT or the `train.preempt` fault) was
    requested; training state was checkpointed before raising."""

    def __init__(self, msg: str, step: int | None = None):
        super().__init__(msg)
        self.step = step


class RestartsExhaustedError(ResilienceError):
    """The Supervisor's restart budget is spent: `cause` is the final
    crash, `ledger` the full restart history."""

    def __init__(self, msg: str, cause: Exception | None = None,
                 ledger: list | None = None):
        super().__init__(msg)
        self.cause = cause
        self.ledger = ledger or []


class GenerationPoisonedError(ResilienceError):
    """One generation request produced non-finite logits on every slot
    it was replayed onto — the poison travels WITH the request (its
    tokens drive the numerics), so further replays would quarantine
    healthy slots one by one. The engine aborts the request with this
    typed error after `poison_strike_limit` strikes instead of looping.
    `strikes` is how many slots the request poisoned before the abort."""

    def __init__(self, msg: str, model: str = "", strikes: int = 0):
        super().__init__(msg)
        self.model = model
        self.strikes = strikes


class QuotaExceededError(ResilienceError):
    """A tenant's quota is spent, or the decode engine's slots and wait
    queue are full. Maps to HTTP 429 + Retry-After — distinct from
    OverloadedError (503), which means the SERVER is saturated, not the
    tenant."""

    def __init__(self, msg: str, tenant: str = "",
                 retry_after_s: float = 1.0):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class ModelNotFoundError(ResilienceError):
    """The registry has no model (or no such version) under that name.
    Maps to HTTP 404 on the /v1/models routes."""


class NoHealthyReplicaError(ResilienceError):
    """Every replica behind a ReplicaRouter is open-circuited or
    failed the request — there is nowhere left to fail over to.
    `cause` is the last replica's failure; `causes` is every
    per-replica failure as (url, exception) pairs (a caller can tell
    "everyone shed me" from "everyone was unreachable"); `membership`
    is the router's fleet membership (replica URLs) at failure time,
    so a chaos drill can assert WHICH fleet had nowhere left to go."""

    def __init__(self, msg: str, cause: Exception | None = None,
                 membership: list | None = None,
                 causes: list | None = None):
        super().__init__(msg)
        self.cause = cause
        self.membership = list(membership or [])
        self.causes = list(causes or [])


class RolloutHeldError(ResilienceError):
    """The FleetController's hold-down ledger refused to re-canary a
    version that recently failed its SLO watch — a bad build cannot be
    re-rolled in a tight loop. `until_s` is the monotonic time the
    hold-down expires; `failures` how many rollouts of this (model,
    version) have been rolled back so far."""

    def __init__(self, msg: str, model: str = "", version: str = "",
                 until_s: float = 0.0, failures: int = 0):
        super().__init__(msg)
        self.model = model
        self.version = version
        self.until_s = until_s
        self.failures = failures


class ServingError(ResilienceError):
    """HTTP error surfaced by ModelClient with the server's own story.

    Carries the status code plus the parsed JSON error payload
    (`error`, `error_class`) the server returned, so callers see e.g.
    status=503 error_class='OverloadedError' instead of a bare
    HTTP status."""

    def __init__(self, status: int, message: str,
                 error_class: str = "", body: dict | None = None,
                 retry_after_s: float | None = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        self.error_class = error_class
        self.body = body or {}
        self.retry_after_s = retry_after_s

    @property
    def retryable(self) -> bool:
        """503 (and 429) mean 'try again later'; 4xx/500 do not."""
        return self.status in (429, 503)
