"""Tenant admission: token-bucket quotas + priority load-shedding (a
copy of deeplearning4j_tpu/serving/admission.py).

The admission layer sits BETWEEN the HTTP surface and the bounded
request queue of a model's ParallelInference — it decides *whose*
request is allowed to contend for queue space, so the existing
backpressure/deadline machinery (OverloadedError when the queue fills,
per-call deadlines inside `output()`) keeps doing the mechanics while
this layer does the policy:

  quota      every tenant owns a token bucket (`rate` tokens/s, burst
             capacity `burst`); an empty bucket rejects with
             QuotaExceededError -> HTTP 429 + Retry-After, computed
             from the bucket's actual refill horizon;
  priority   each tenant carries a priority class (high/normal/low).
             When the model's queue is under pressure, LOW classes are
             shed first: a class is admitted only while queue depth is
             below its shed threshold (low 50%, normal 85%, high 100%
             of queue_limit by default). High-priority traffic is only
             ever rejected by the bounded queue itself — the
             "shed lowest class first" discipline of the serving SLO.

Every decision emits through the MetricsRegistry with per-tenant and
per-priority labels (`dl4j_serving_admitted_total`,
`dl4j_serving_shed_total{reason=quota|pressure}`), so a /metrics scrape
shows exactly who is being shed and why.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import (
    FaultInjectedError,
    QuotaExceededError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire

# priority classes, lowest number = most important = shed last
PRIORITY_CLASSES = {"high": 0, "normal": 1, "low": 2}

# fraction of queue_limit at which a class stops being admitted;
# high is 1.0: only the bounded queue itself can reject it
DEFAULT_SHED_THRESHOLDS = {"high": 1.0, "normal": 0.85, "low": 0.5}


class TokenBucket:
    """Classic token bucket on the monotonic clock (thread-safe).

    `rate` tokens/s refill up to `burst` capacity; `try_take` is
    non-blocking — admission never queues, it admits or sheds."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(1.0, self.rate))
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """How long until `n` tokens will have refilled (advisory)."""
        with self._lock:
            missing = max(0.0, n - self._tokens)
        if missing <= 0.0 or self.rate <= 0.0:
            return 1.0
        return max(0.05, missing / self.rate)

    def available(self) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
            return self._tokens


class TenantConfig:
    """One tenant's contract: rate/burst quota + priority class.

    `rate=None` means unmetered (no token bucket) — priority shedding
    still applies."""

    def __init__(self, name: str, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 priority: str = "normal"):
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {sorted(PRIORITY_CLASSES)}: "
                f"{priority!r}")
        self.name = name
        self.rate = rate
        self.burst = burst
        self.priority = priority
        self.bucket = (TokenBucket(rate, burst)
                       if rate is not None else None)

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "TenantConfig":
        return cls(name, rate=d.get("rate"), burst=d.get("burst"),
                   priority=d.get("priority", "normal"))

    def to_dict(self) -> dict:
        return {"rate": self.rate, "burst": self.burst,
                "priority": self.priority}


class AdmissionController:
    """Per-tenant quota + priority shedding in front of every model's
    bounded queue. Unknown tenants get `default` (unmetered, normal
    priority, sheddable under pressure) so the layer is zero-config
    until an operator writes a tenant table."""

    def __init__(self, tenants: Optional[Dict[str, TenantConfig]] = None,
                 default: Optional[TenantConfig] = None,
                 shed_thresholds: Optional[Dict[str, float]] = None):
        self.tenants: Dict[str, TenantConfig] = dict(tenants or {})
        self.default = default or TenantConfig("default",
                                               priority="normal")
        self.shed_thresholds = dict(DEFAULT_SHED_THRESHOLDS)
        if shed_thresholds:
            self.shed_thresholds.update(shed_thresholds)
        self.counters = {"admitted": 0, "shed_quota": 0,
                         "shed_pressure": 0}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, tenants: Dict[str, dict],
                    **kwargs) -> "AdmissionController":
        """Build from a plain {tenant: {rate, burst, priority}} table
        (the JSON an operator would ship)."""
        return cls({name: TenantConfig.from_dict(name, d)
                    for name, d in tenants.items()}, **kwargs)

    def config_for(self, tenant: Optional[str]) -> TenantConfig:
        if tenant is None:
            return self.default
        return self.tenants.get(tenant, self.default)

    def admit(self, tenant: Optional[str], model: str,
              queue_depth: int, queue_limit: int) -> TenantConfig:
        """Admit or shed one request. Raises QuotaExceededError (the
        HTTP 429) when the tenant's bucket is empty or its priority
        class is under pressure-shed; returns the tenant's config on
        admission so the caller can tag downstream accounting."""
        cfg = self.config_for(tenant)
        tname = tenant or cfg.name
        labels = {"tenant": tname, "priority": cfg.priority}
        # chaos drill: an armed `admission.quota_storm` raise is
        # consumed as a forced quota shed for METERED tenants only —
        # the synthetic storm drains token buckets, so unmetered
        # classes (gold) ride through it untouched
        storm = False
        try:
            _fire("admission.quota_storm")
        except FaultInjectedError:
            storm = cfg.bucket is not None
        if storm or (cfg.bucket is not None
                     and not cfg.bucket.try_take()):
            with self._lock:
                self.counters["shed_quota"] += 1
            _obs.count("dl4j_serving_shed_total",
                       labels={**labels, "reason": "quota"})
            raise QuotaExceededError(
                f"tenant {tname!r} quota exhausted "
                f"({cfg.rate:g} req/s)", tenant=tname,
                retry_after_s=cfg.bucket.retry_after_s())
        threshold = self.shed_thresholds.get(cfg.priority, 1.0)
        if queue_limit > 0 and threshold < 1.0 \
                and queue_depth >= threshold * queue_limit:
            with self._lock:
                self.counters["shed_pressure"] += 1
            _obs.count("dl4j_serving_shed_total",
                       labels={**labels, "reason": "pressure"})
            raise QuotaExceededError(
                f"queue under pressure ({queue_depth}/{queue_limit}); "
                f"priority class {cfg.priority!r} is being shed",
                tenant=tname, retry_after_s=0.5)
        with self._lock:
            self.counters["admitted"] += 1
        _obs.count("dl4j_serving_admitted_total", labels=labels)
        return cfg

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {
            "tenants": {name: cfg.to_dict()
                        for name, cfg in self.tenants.items()},
            "default": self.default.to_dict(),
            "shed_thresholds": dict(self.shed_thresholds),
            **counters,
        }
