"""Typed failures (a copy of the classes of deeplearning4j_tpu/resilience/errors.py
that the ported serving, model-loading, retry and training paths raise). Callers
route on type: shed load (Overloaded), surface (Shutdown / Unavailable),
fail over (integrity), stop training (non-finite, preempted)."""

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
