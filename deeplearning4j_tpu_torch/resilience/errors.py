"""Typed failures (a copy of the classes of deeplearning4j_tpu/resilience/errors.py
that the ported serving and model-loading paths raise). Callers route on
type: shed load (Overloaded), surface (Shutdown / Unavailable), fail over
(integrity)."""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base for every typed failure raised by this subsystem."""


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


class CheckpointIntegrityError(ResilienceError):
    """A checkpoint/model file failed checksum or structural validation."""
