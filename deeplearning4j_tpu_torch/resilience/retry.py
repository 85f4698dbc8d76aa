"""Retry policies and a circuit breaker (a copy of
deeplearning4j_tpu/resilience/retry.py).

`Retry` is a value object describing *how* to retry (attempts, capped
exponential backoff with deterministic seeded jitter, an overall
deadline, and a retryable-exception predicate) — callers apply it with
`retry.call(fn)`. `CircuitBreaker` sits in front of a dependency and
fails fast after repeated failures, letting the dependency breathe
instead of hammering it. TrainingMaster applies a Retry to checkpoint
I/O (`checkpoint_retry`) and to its batch function (`data_retry`).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Type

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import (
    CircuitOpenError,
    DeadlineExceededError,
    RetriesExhaustedError,
)


def _default_retryable(exc: Exception) -> bool:
    return isinstance(exc, (OSError, ConnectionError, TimeoutError))


class Retry:
    """Bounded retry with capped exponential backoff + seeded jitter.

    Deterministic for a fixed seed: backoff sequence replays exactly,
    which keeps chaos tests reproducible. `deadline_s` bounds the WHOLE
    call including sleeps; the policy never sleeps past it."""

    def __init__(self, max_attempts: int = 3,
                 initial_backoff_s: float = 0.05,
                 multiplier: float = 2.0,
                 max_backoff_s: float = 2.0,
                 jitter: float = 0.1,
                 deadline_s: Optional[float] = None,
                 retryable: Callable[[Exception], bool] = _default_retryable,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.initial_backoff_s = initial_backoff_s
        self.multiplier = multiplier
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.retryable = retryable
        self.seed = seed
        self._sleep = sleep
        self._clock = clock

    def backoffs(self):
        """The (deterministic) backoff sequence this policy would sleep."""
        rng = random.Random(self.seed)
        b = self.initial_backoff_s
        for _ in range(self.max_attempts - 1):
            yield b * (1.0 + self.jitter * rng.random())
            b = min(b * self.multiplier, self.max_backoff_s)

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn` under this policy. Non-retryable exceptions pass
        through untouched; exhaustion raises RetriesExhaustedError with
        the last cause attached."""
        start = self._clock()
        backoffs = self.backoffs()
        last: Optional[Exception] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except Exception as exc:   # noqa: BLE001 - policy boundary
                if not self.retryable(exc):
                    raise
                last = exc
            if attempt == self.max_attempts:
                break
            pause = next(backoffs)
            if self.deadline_s is not None:
                remaining = self.deadline_s - (self._clock() - start)
                if remaining <= pause:
                    raise DeadlineExceededError(
                        f"retry deadline {self.deadline_s}s exhausted "
                        f"after {attempt} attempts") from last
            _obs.count("dl4j_retry_attempts_total")
            self._sleep(pause)
        raise RetriesExhaustedError(
            f"gave up after {self.max_attempts} attempts: {last!r}",
            cause=last, attempts=self.max_attempts)


class CircuitBreaker:
    """CLOSED -> OPEN after `failure_threshold` consecutive failures;
    OPEN rejects instantly with CircuitOpenError; after
    `reset_timeout_s` one probe call is let through (HALF_OPEN) — its
    success closes the circuit, its failure re-opens it."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0,
                 counted: Type[BaseException] = Exception,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.counted = counted
        self._clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._state = self.CLOSED

    @property
    def state(self) -> str:
        self._maybe_half_open()
        return self._state

    def _transition(self, state: str) -> None:
        if state != self._state:
            self._state = state
            _obs.count("dl4j_breaker_transitions_total",
                       labels={"to": state})

    def _maybe_half_open(self):
        if (self._state == self.OPEN and self._opened_at is not None
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._transition(self.HALF_OPEN)

    def allow(self) -> bool:
        self._maybe_half_open()
        return self._state != self.OPEN

    def record_success(self):
        self._failures = 0
        self._opened_at = None
        self._transition(self.CLOSED)

    def record_failure(self):
        self._failures += 1
        if (self._state == self.HALF_OPEN
                or self._failures >= self.failure_threshold):
            self._transition(self.OPEN)
            self._opened_at = self._clock()

    def call(self, fn: Callable, *args, **kwargs):
        if not self.allow():
            wait = 0.0
            if self._opened_at is not None:
                wait = max(0.0, self.reset_timeout_s
                           - (self._clock() - self._opened_at))
            raise CircuitOpenError(
                f"circuit open ({self._failures} consecutive failures); "
                f"retry in {wait:.2f}s", retry_after_s=wait)
        try:
            result = fn(*args, **kwargs)
        except self.counted:
            self.record_failure()
            raise
        self.record_success()
        return result
