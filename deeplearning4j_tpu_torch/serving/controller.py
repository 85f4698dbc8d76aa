"""FleetController: rollout and capacity for a ReplicaRouter fleet
(counterpart of deeplearning4j_tpu/serving/controller.py).

The serving fleet's supervisor — the same shape the training side
already has (Supervisor/ClusterSupervisor): a version flip stops being
a sequence of manual PUTs and becomes an observable, reversible,
automatically-guarded state machine; the replica pool stops being a
static URL list and becomes a control loop driven by the admission
layer's own shed/queue metrics.

Three responsibilities:

  rollout     `rollout(model, version)` canaries ONE replica first:
              warm-before-flip through the registry hot-swap the
              replica already implements (PUT with activate=False,
              then swap), then WATCHES the canary's error-rate / p99 /
              `dl4j_perf_*` telemetry — scraped per replica and merged
              through the cross-rank snapshot aggregation — in
              consecutive windows against a declared `SLOPolicy`.
              Healthy windows ramp the remaining replicas one by one;
              a breach auto-rolls the canary (and any already-flipped
              replica) back to the still-warm previous version and
              records the version in the HOLD-DOWN LEDGER, so a
              failing build cannot be re-canaried in a tight loop
              (`RolloutHeldError`, exponential hold-down). Zero
              mixed-version responses throughout: each flip is the
              ModelRegistry lease-pinned pointer write, so every
              request is computed end-to-end by exactly one version.
  autoscale   `start()` runs a control loop that (a) health-polls
              every replica — a dead one (real /healthz failure or the
              `serving.replica_kill` drill verdict) leaves the router
              WITHOUT counting against its breaker accounting and is
              backfilled from `replica_factory` up to `min_replicas` —
              and (b) grows/shrinks the pool from the
              AdmissionController's shed-rate and queue-depth metrics:
              bounded [min_replicas, max_replicas], one scale event
              per `cooldown_s`, scale-down only after the router
              DRAINS the victim's in-flight requests (then the
              replica's own drain-then-retire machinery tears it
              down).
  observe     every replica snapshot merges through
              `perf.aggregate_snapshots` into one fleet-level
              exposition (`fleet_prometheus_text`), and the controller
              emits `dl4j_fleet_*` / `dl4j_rollout_*` metrics so the
              dashboard's "fleet —" line and a /metrics scrape show
              pool size, rollout state, and rollback counts live.

Replica handles are duck-typed (name, snapshot, healthy,
active_version, load_version, swap, rollback, retire): `HttpReplica`
drives a remote ModelServer over the /v1/models surface + /metrics
scrape; `LocalReplica` drives an in-process ModelRegistry directly
(tier-1 drills, single-process fleets). In-process fleets share one
global MetricsRegistry, so per-replica scrape attribution is a
deployment property — one process per replica — not something the
controller can conjure; the drills account for this.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.observability.metrics import (
    parse_prometheus_snapshot,
)
from deeplearning4j_tpu_torch.observability.perf import aggregate_snapshots
from deeplearning4j_tpu_torch.resilience.errors import (
    FaultInjectedError,
    RolloutHeldError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire

logger = logging.getLogger("deeplearning4j_tpu_torch")

# rollout state machine; the dl4j_rollout_state gauge carries the index
ROLLOUT_STATES = ("idle", "canary", "ramping", "rolling_back", "held",
                  "completed")

_CODE = re.compile(r'code="(\d+)"')
_DURATION = re.compile(r"^([0-9.]+)(ms|s)?$")


def _parse_duration_s(raw: str) -> float:
    m = _DURATION.match(raw.strip())
    if not m:
        raise ValueError(f"bad duration {raw!r} (want e.g. 250ms, 2s)")
    v = float(m.group(1))
    return v / 1e3 if m.group(2) == "ms" else v


class SLOPolicy:
    """The declared rollout SLO: what a healthy canary looks like.

    Bounds (any may be None = unchecked):
      max_error_rate   5xx fraction of requests per window
      max_p99_s        absolute p99 latency bound
      max_p99_ratio    p99 vs. the pre-flip baseline window
      max_ttft_p99_s   absolute decode time-to-first-token p99 bound

    Watch shape:
      window_s       one observation window (snapshot delta)
      windows        consecutive healthy windows to clear the canary
      ramp_windows   healthy windows between ramp flips
      min_requests   below this a window carries no signal and counts
                     as healthy ("no traffic = no harm") — drills and
                     real rollouts always have traffic flowing

    Grammar (the README "Fleet control" section documents it):

        SLOPolicy.parse("error_rate<0.02,p99<250ms,p99_ratio<1.5,"
                        "ttft_p99<100ms,"
                        "min_requests=20,window=500ms,windows=3")
    """

    def __init__(self, max_error_rate: Optional[float] = 0.02,
                 max_p99_s: Optional[float] = None,
                 max_p99_ratio: Optional[float] = None,
                 max_ttft_p99_s: Optional[float] = None,
                 min_requests: int = 10, window_s: float = 1.0,
                 windows: int = 3, ramp_windows: int = 1):
        self.max_error_rate = max_error_rate
        self.max_p99_s = max_p99_s
        self.max_p99_ratio = max_p99_ratio
        self.max_ttft_p99_s = max_ttft_p99_s
        self.min_requests = int(min_requests)
        self.window_s = float(window_s)
        self.windows = int(windows)
        self.ramp_windows = int(ramp_windows)

    @classmethod
    def parse(cls, spec: str) -> "SLOPolicy":
        kw: dict = {"max_error_rate": None}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, val = (item.partition("<") if "<" in item
                             else item.partition("="))
            if not sep:
                raise ValueError(f"bad SLO clause {item!r} "
                                 "(want key<bound or key=value)")
            key, val = key.strip(), val.strip()
            if key == "error_rate":
                kw["max_error_rate"] = float(val)
            elif key == "p99":
                kw["max_p99_s"] = _parse_duration_s(val)
            elif key == "p99_ratio":
                kw["max_p99_ratio"] = float(val)
            elif key == "ttft_p99":
                kw["max_ttft_p99_s"] = _parse_duration_s(val)
            elif key == "min_requests":
                kw["min_requests"] = int(val)
            elif key == "window":
                kw["window_s"] = _parse_duration_s(val)
            elif key == "windows":
                kw["windows"] = int(val)
            elif key == "ramp_windows":
                kw["ramp_windows"] = int(val)
            else:
                raise ValueError(f"unknown SLO key {key!r}")
        return cls(**kw)

    def to_spec(self) -> str:
        parts = []
        if self.max_error_rate is not None:
            parts.append(f"error_rate<{self.max_error_rate:g}")
        if self.max_p99_s is not None:
            parts.append(f"p99<{self.max_p99_s * 1e3:g}ms")
        if self.max_p99_ratio is not None:
            parts.append(f"p99_ratio<{self.max_p99_ratio:g}")
        if self.max_ttft_p99_s is not None:
            parts.append(f"ttft_p99<{self.max_ttft_p99_s * 1e3:g}ms")
        parts += [f"min_requests={self.min_requests}",
                  f"window={self.window_s:g}s",
                  f"windows={self.windows}",
                  f"ramp_windows={self.ramp_windows}"]
        return ",".join(parts)

    def breach(self, sample: dict,
               baseline_p99_s: Optional[float]) -> Optional[str]:
        """The verdict for one watch window: a reason string when the
        sample violates the policy, None when it is healthy (or
        carries too little traffic to judge)."""
        if sample["requests"] < self.min_requests:
            return None
        if self.max_error_rate is not None \
                and sample["error_rate"] > self.max_error_rate:
            return (f"error_rate {sample['error_rate']:.4f} > "
                    f"{self.max_error_rate:g}")
        p99 = sample.get("p99_s")
        if p99 is not None:
            if self.max_p99_s is not None and p99 > self.max_p99_s:
                return f"p99 {p99 * 1e3:.1f}ms > " \
                       f"{self.max_p99_s * 1e3:g}ms"
            if self.max_p99_ratio is not None \
                    and baseline_p99_s is not None \
                    and baseline_p99_s > 0 \
                    and p99 > self.max_p99_ratio * baseline_p99_s:
                return (f"p99 {p99 * 1e3:.1f}ms > "
                        f"{self.max_p99_ratio:g}x baseline "
                        f"{baseline_p99_s * 1e3:.1f}ms")
        ttft = sample.get("ttft_p99_s")
        if self.max_ttft_p99_s is not None and ttft is not None \
                and ttft > self.max_ttft_p99_s:
            return (f"ttft_p99 {ttft * 1e3:.1f}ms > "
                    f"{self.max_ttft_p99_s * 1e3:g}ms")
        return None


# -------------------------------------------------- snapshot arithmetic
def _counter_total(snap: dict, name: str) -> float:
    return float(sum(snap.get("counters", {}).get(name, {}).values()))


def _error_total(snap: dict) -> float:
    """Genuine serving failures only. A shed (429) or a client error
    (4xx) is not replica badness, and a 503 is BACKPRESSURE — a
    capacity signal the autoscaler owns; judging a canary on it under
    a deliberate overload soak would roll back every version. The
    rollback guard counts 500-class handler failures."""
    total = 0.0
    for lab, v in snap.get("counters", {}).get(
            "dl4j_serving_errors_total", {}).items():
        m = _CODE.search(lab)
        code = int(m.group(1)) if m else 500
        if code >= 500 and code != 503:
            total += float(v)
    return total


def _hist_series(snap: dict, name: str) -> Tuple[int, Dict[str, int]]:
    """(count, per-bucket counts) summed over every label set of a
    histogram family."""
    count, buckets = 0, {}
    for full, h in snap.get("histograms", {}).items():
        if full != name and not full.startswith(name + "{"):
            continue
        count += int(h.get("count", 0))
        for le, c in h.get("buckets", {}).items():
            buckets[le] = buckets.get(le, 0) + int(c)
    return count, buckets


def _bucket_upper(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def _hist_p99_delta(prev: dict, cur: dict,
                    hist: str) -> Optional[float]:
    """p99 of one histogram family between two snapshots, read from
    the BUCKET deltas — an upper bound at bucket resolution, which is
    exactly what an SLO bound wants (never under-reports a breach).
    None when the window saw no observations."""
    c0, b0 = _hist_series(prev, hist)
    c1, b1 = _hist_series(cur, hist)
    dcount = c1 - c0
    if dcount <= 0:
        return None
    deltas = sorted(
        ((le, b1.get(le, 0) - b0.get(le, 0))
         for le in b1), key=lambda kv: _bucket_upper(kv[0]))
    cum, target = 0, 0.99 * dcount
    for le, c in deltas:
        cum += c
        if cum >= target:
            return _bucket_upper(le)
    return None


def slo_sample(prev: dict, cur: dict,
               hist: str = "dl4j_serving_request_seconds") -> dict:
    """Error-rate + latency p99s between two metric snapshots (the one
    watch window). `p99_s` is end-to-end request latency;
    `ttft_p99_s` is decode time-to-first-token (the user-visible
    responsiveness bound rollout policies gate on via `ttft_p99<...`).
    Both come from histogram bucket deltas via `_hist_p99_delta`."""
    req = (_counter_total(cur, "dl4j_serving_requests_total")
           - _counter_total(prev, "dl4j_serving_requests_total"))
    err = _error_total(cur) - _error_total(prev)
    p99 = _hist_p99_delta(prev, cur, hist)
    ttft_p99 = _hist_p99_delta(prev, cur, "dl4j_decode_ttft_seconds")
    mfu_series = cur.get("gauges", {}).get("dl4j_perf_mfu") or {}
    mfu = list(mfu_series.values())[-1] if mfu_series else None
    return {"requests": req, "errors": err,
            "error_rate": (err / req) if req > 0 else 0.0,
            "p99_s": p99, "ttft_p99_s": ttft_p99, "mfu": mfu}


# ------------------------------------------------------ replica handles
class HttpReplica:
    """A remote ModelServer replica driven over its own HTTP surface:
    lifecycle through the /v1/models routes, observation through a
    /metrics scrape parsed back into a registry snapshot."""

    def __init__(self, url: str, client=None, timeout: float = 10.0,
                 on_retire: Optional[Callable] = None):
        from deeplearning4j_tpu_torch.parallel.serving import ModelClient
        from deeplearning4j_tpu_torch.resilience.retry import Retry

        self.name = url.rstrip("/")
        self.client = client if client is not None else ModelClient(
            url, timeout=timeout, retry=Retry(max_attempts=2),
            breaker=None)
        self._on_retire = on_retire

    def snapshot(self) -> dict:
        return parse_prometheus_snapshot(self.client.metrics_text())

    def healthy(self) -> bool:
        try:
            return self.client.healthz()
        except Exception:   # noqa: BLE001 - unreachable means unhealthy
            return False

    def active_version(self, model: str) -> Optional[str]:
        return self.client.status(model=model).get("active")

    def load_version(self, model: str, version: str, path: str,
                     **kw) -> None:
        kw.setdefault("activate", False)   # warm BEFORE the flip
        self.client.put_version(model, version, path, **kw)

    def swap(self, model: str, version: str) -> None:
        self.client.swap(model, version)

    def rollback(self, model: str) -> None:
        self.client.rollback(model)

    def retire(self) -> None:
        if self._on_retire is not None:
            self._on_retire()


class LocalReplica:
    """An in-process replica: a ModelRegistry (optionally with the
    ModelServer wrapping it, so `retire` can stop the HTTP surface
    too). Snapshots read the process-global MetricsRegistry — an
    in-process fleet shares it, see the module docstring."""

    def __init__(self, name: str, registry, server=None):
        self.name = name
        self.registry = registry
        self.server = server

    def snapshot(self) -> dict:
        return _obs.get_registry().snapshot()

    def healthy(self) -> bool:
        try:
            return bool(self.registry.healthy())
        except Exception:   # noqa: BLE001 - unreachable means unhealthy
            return False

    def active_version(self, model: str) -> Optional[str]:
        return self.registry.entry(model).active

    def load_version(self, model: str, version: str, path: str,
                     **kw) -> None:
        kw.setdefault("activate", False)
        self.registry.load_version(model, version, path, **kw)

    def swap(self, model: str, version: str) -> None:
        self.registry.swap(model, version)

    def rollback(self, model: str) -> None:
        self.registry.rollback(model)

    def retire(self) -> None:
        if self.server is not None:
            self.server.stop()       # drains the registry behind it
        else:
            self.registry.shutdown()


# ------------------------------------------------------ the controller
class FleetController:
    """Rollout + capacity supervisor over a replica fleet (see the
    module docstring for the full story).

    `replicas` are handles (HttpReplica/LocalReplica/stubs); `router`
    is the ReplicaRouter whose membership this controller owns;
    `replica_factory()` mints a new handle (spawning whatever backs
    it) for backfill and scale-up — without one the pool can only
    shrink. `clock`/`sleep` are injectable for deterministic drills."""

    def __init__(self, replicas: List, router=None,
                 slo: Optional[SLOPolicy] = None,
                 replica_factory: Optional[Callable] = None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 autoscale_interval_s: float = 2.0,
                 cooldown_s: float = 30.0,
                 scale_up_shed_rate: float = 0.05,
                 scale_up_queue_depth: int = 32,
                 scale_down_rps_per_replica: float = 1.0,
                 drain_timeout_s: float = 10.0,
                 holddown_s: float = 300.0,
                 state_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.replicas = list(replicas)
        self.router = router
        self.slo = slo if slo is not None else SLOPolicy()
        self.replica_factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.cooldown_s = float(cooldown_s)
        self.scale_up_shed_rate = float(scale_up_shed_rate)
        self.scale_up_queue_depth = int(scale_up_queue_depth)
        self.scale_down_rps_per_replica = float(
            scale_down_rps_per_replica)
        self.drain_timeout_s = float(drain_timeout_s)
        self.holddown_s = float(holddown_s)
        self._clock = clock
        self._sleep = sleep

        self._lock = threading.Lock()           # membership + ledgers
        self._rollout_lock = threading.Lock()   # one rollout at a time
        self._holddown: Dict[Tuple[str, str], dict] = {}
        self._state = "idle"
        self._history: List[dict] = []
        self._scale_events = {"up": 0, "down": 0}
        self._deaths = 0
        self._last_scale_t: Optional[float] = None
        self._prev_fleet: Optional[dict] = None
        self._prev_tick_t: Optional[float] = None
        self._last_fleet_sample: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # durable control plane: hold-down ledger + autoscaler target
        # persisted with the journal's record framing (`state_dir`), so
        # a restarted controller refuses to re-canary a held build
        self._state_path: Optional[str] = None
        self._restored_target: Optional[int] = None
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
            self._state_path = os.path.join(state_dir,
                                            "controller.state")
            self._restore_state()
        self._emit_pool_gauge()
        self._set_state("idle")

    # ---------------------------------------------------- state/metrics
    def _set_state(self, state: str) -> None:
        self._state = state
        _obs.set_gauge("dl4j_rollout_state",
                       ROLLOUT_STATES.index(state))

    def _emit_pool_gauge(self) -> None:
        with self._lock:
            n = len(self.replicas)
        _obs.set_gauge("dl4j_fleet_replicas", n)

    @property
    def rollout_state(self) -> str:
        return self._state

    # -------------------------------------------------------- hold-down
    def _check_holddown(self, model: str, version: str) -> None:
        now = self._clock()
        with self._lock:
            entry = self._holddown.get((model, version))
            held = entry is not None and entry["until"] > now
            if held:
                entry = dict(entry)
        if held:
            raise RolloutHeldError(
                f"version {version!r} of {model!r} is held down for "
                f"{entry['until'] - now:.1f}s more after "
                f"{entry['failures']} failed rollout(s) "
                f"({entry['reason']})", model=model, version=version,
                until_s=entry["until"], failures=entry["failures"])

    def _enter_holddown(self, model: str, version: str,
                        reason: str) -> None:
        now = self._clock()
        with self._lock:
            entry = self._holddown.setdefault(
                (model, version), {"failures": 0, "until": 0.0,
                                   "reason": ""})
            entry["failures"] += 1
            # exponential: a repeatedly-failing build backs off harder
            entry["until"] = now + self.holddown_s \
                * (2 ** (entry["failures"] - 1))
            entry["reason"] = reason
        _obs.count("dl4j_rollout_holddowns_total",
                   labels={"model": model})
        self._persist_state()

    def clear_holddown(self, model: str, version: str) -> None:
        """Operator override: release a held-down version."""
        with self._lock:
            self._holddown.pop((model, version), None)
        self._persist_state()

    # -------------------------------------------------- state durability
    def _persist_state(self) -> None:
        """Publish the hold-down ledger + autoscaler target to the
        state file — the journal's record framing through the atomic
        writer, so a kill mid-write leaves the previous state intact.
        Monotonic deadlines convert to wall clock for the trip through
        disk (a restart gets a fresh monotonic epoch). Runs OUTSIDE
        the membership lock; file I/O never holds it."""
        if self._state_path is None:
            return
        from deeplearning4j_tpu_torch.serving.journal import write_records

        now_m, now_w = self._clock(), time.time()
        with self._lock:
            records = [{"kind": "holddown", "model": m, "version": v,
                        "failures": e["failures"],
                        "until_wall": now_w + (e["until"] - now_m),
                        "reason": e["reason"]}
                       for (m, v), e in self._holddown.items()]
            records.append({"kind": "autoscaler",
                            "target": len(self.replicas),
                            "scale_events": dict(self._scale_events)})
        try:
            write_records(self._state_path, records)
        except OSError:
            logger.warning("controller state persist to %s failed",
                           self._state_path, exc_info=True)

    def _restore_state(self) -> None:
        """Load whatever a previous controller persisted: expired
        hold-downs are dropped, live ones re-enter the ledger with
        their remaining wall-clock time; the autoscaler target is
        surfaced in stats() for the operator (membership itself is
        re-discovered from the router/factory, not conjured)."""
        if self._state_path is None \
                or not os.path.exists(self._state_path):
            return
        from deeplearning4j_tpu_torch.serving.journal import read_records

        now_m, now_w = self._clock(), time.time()
        records, _, _ = read_records(self._state_path)
        for rec in records:
            if rec.get("kind") == "holddown":
                remaining = float(rec.get("until_wall", 0.0)) - now_w
                if remaining <= 0:
                    continue
                key = (str(rec.get("model")), str(rec.get("version")))
                with self._lock:
                    self._holddown[key] = {
                        "failures": int(rec.get("failures", 1)),
                        "until": now_m + remaining,
                        "reason": str(rec.get("reason",
                                              "restored from disk")),
                    }
            elif rec.get("kind") == "autoscaler":
                target = rec.get("target")
                self._restored_target = (int(target)
                                         if target is not None
                                         else None)

    # ---------------------------------------------------------- rollout
    def rollout(self, model: str, version: str,
                path: Optional[str] = None, canary_index: int = 0,
                **load_kwargs) -> dict:
        """Run the full rollout state machine; returns a report dict
        (`outcome` is "completed" or "rolled_back"). With `path` the
        version is loaded warm (activate=False) on each replica just
        before its flip; without it every replica must already hold
        `version` as a warm standby. Raises RolloutHeldError when the
        version is in hold-down."""
        if not self._rollout_lock.acquire(blocking=False):
            raise RuntimeError(
                f"a rollout is already in progress ({self._state})")
        try:
            return self._rollout_locked(model, version, path,
                                        canary_index, load_kwargs)
        finally:
            self._rollout_lock.release()

    def _rollout_locked(self, model, version, path, canary_index,
                        load_kwargs) -> dict:
        self._check_holddown(model, version)
        with self._lock:
            if not self.replicas:
                raise RuntimeError("fleet is empty — nothing to roll")
            order = list(self.replicas)
        canary = order.pop(canary_index % len(order))
        t_start = self._clock()
        report = {"model": model, "version": version,
                  "canary": canary.name, "flipped": [],
                  "outcome": None, "breach": None,
                  "detection_s": None, "baseline_p99_s": None,
                  "slo": self.slo.to_spec()}
        try:
            # pre-flip baseline window (only needed for ratio bounds)
            baseline_p99 = None
            if self.slo.max_p99_ratio is not None:
                s0 = canary.snapshot()
                self._sleep(self.slo.window_s)
                base = slo_sample(s0, canary.snapshot())
                if base["requests"] >= self.slo.min_requests:
                    baseline_p99 = base["p99_s"]
                report["baseline_p99_s"] = baseline_p99

            # ---- canary: warm, flip, watch
            self._set_state("canary")
            previous = canary.active_version(model)
            report["previous"] = previous
            if path is not None:
                canary.load_version(model, version, path,
                                    **load_kwargs)
            canary.swap(model, version)
            t_flip = self._clock()
            report["flipped"].append(canary.name)
            breach = self._watch(canary, self.slo.windows,
                                 baseline_p99)
            if breach is not None:
                return self._roll_back(report, [canary], model,
                                       breach, t_flip)

            # ---- ramp: replica by replica, health-checked between
            self._set_state("ramping")
            for replica in order:
                if path is not None:
                    replica.load_version(model, version, path,
                                         **load_kwargs)
                replica.swap(model, version)
                report["flipped"].append(replica.name)
                breach = self._watch(replica, self.slo.ramp_windows,
                                     baseline_p99)
                if breach is not None:
                    flipped = [canary] + order[:order.index(replica)
                                               + 1]
                    return self._roll_back(report, flipped, model,
                                           breach, t_flip)

            report["outcome"] = "completed"
            report["duration_s"] = self._clock() - t_start
            self._set_state("completed")
            _obs.count("dl4j_rollout_total",
                       labels={"model": model, "outcome": "completed"})
            self._remember(report)
            return report
        except RolloutHeldError:
            raise
        except Exception:
            # lifecycle errors (missing standby, unreachable replica)
            # surface to the caller, but the machine never wedges in a
            # transient state and the abort is observable
            self._set_state("idle")
            _obs.count("dl4j_rollout_total",
                       labels={"model": model, "outcome": "aborted"})
            raise

    def _watch(self, replica, windows: int,
               baseline_p99: Optional[float]) -> Optional[dict]:
        """Watch one replica for `windows` consecutive healthy
        windows; returns the breach ({reason, sample}) or None."""
        clean = 0
        prev = replica.snapshot()
        while clean < windows:
            self._sleep(self.slo.window_s)
            cur = replica.snapshot()
            sample = slo_sample(prev, cur)
            prev = cur
            reason = self.slo.breach(sample, baseline_p99)
            if reason is not None:
                return {"reason": reason, "sample": sample,
                        "replica": replica.name}
            clean += 1
        return None

    def _roll_back(self, report, flipped, model, breach,
                   t_flip) -> dict:
        detection_s = self._clock() - t_flip
        self._set_state("rolling_back")
        for replica in reversed(flipped):
            try:
                replica.rollback(model)
            except Exception:   # noqa: BLE001 - roll the rest back anyway
                logger.exception("rollback of %s on %s failed",
                                 model, replica.name)
        self._enter_holddown(model, report["version"],
                             breach["reason"])
        report["outcome"] = "rolled_back"
        report["breach"] = breach
        report["detection_s"] = detection_s
        self._set_state("held")
        _obs.count("dl4j_rollout_rollbacks_total",
                   labels={"model": model})
        _obs.count("dl4j_rollout_total",
                   labels={"model": model, "outcome": "rolled_back"})
        _obs.observe("dl4j_rollout_detection_seconds", detection_s)
        self._remember(report)
        return report

    def _remember(self, report: dict) -> None:
        with self._lock:
            self._history.append(report)
            del self._history[:-32]

    # -------------------------------------------------- fleet snapshots
    def fleet_snapshot(self) -> dict:
        """Every live replica's metric snapshot merged through the
        cross-rank aggregation (observability.perf) — counters summed, histogram
        buckets merged, gauges re-keyed per replica."""
        snaps = []
        with self._lock:
            handles = list(self.replicas)
        for h in handles:
            try:
                snaps.append(h.snapshot())
            except Exception:   # noqa: BLE001 - a dead replica can't block the scrape
                logger.warning("fleet snapshot: %s unreachable", h.name)
        return aggregate_snapshots(snaps)

    def fleet_prometheus_text(self) -> str:
        from deeplearning4j_tpu_torch.observability.metrics import (
            render_prometheus,
        )

        return render_prometheus(self.fleet_snapshot())

    def fleet_slo_sample(self) -> Optional[dict]:
        """The most recent tick-over-tick SLO sample of the AGGREGATED
        fleet (None until two ticks have run)."""
        with self._lock:
            return (dict(self._last_fleet_sample)
                    if self._last_fleet_sample else None)

    # ------------------------------------------------------- autoscaler
    def start(self) -> "FleetController":
        """Run the health+autoscale control loop in a background
        thread (one `tick()` per autoscale_interval_s)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="FleetController-loop")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.autoscale_interval_s):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 - the loop must survive a bad tick
                logger.exception("FleetController tick failed")

    def tick(self) -> dict:
        """One control-loop step: health poll (replica death →
        remove + backfill), then the scale decision from the fleet's
        shed-rate / queue-depth / throughput deltas. Public so drills
        can step the loop deterministically."""
        now = self._clock()
        self._health_poll()
        self._backfill_to_min()

        agg = self.fleet_snapshot()
        decision = {"action": None, "reason": None}
        if self._prev_fleet is not None and self._prev_tick_t is not None:
            dt = max(1e-9, now - self._prev_tick_t)
            sample = slo_sample(self._prev_fleet, agg)
            admitted = (_counter_total(agg,
                                       "dl4j_serving_admitted_total")
                        - _counter_total(self._prev_fleet,
                                         "dl4j_serving_admitted_total"))
            shed = (_counter_total(agg, "dl4j_serving_shed_total")
                    - _counter_total(self._prev_fleet,
                                     "dl4j_serving_shed_total"))
            attempts = admitted + shed
            shed_rate = shed / attempts if attempts > 0 else 0.0
            depth = max([0.0] + [
                v for v in (agg.get("gauges", {})
                            .get("dl4j_serving_queue_depth") or {})
                .values()])
            rps = sample["requests"] / dt
            sample.update({"shed_rate": shed_rate,
                           "queue_depth": depth, "rps": rps,
                           "dt_s": dt})
            with self._lock:
                self._last_fleet_sample = sample
                n = len(self.replicas)
            cooled = (self._last_scale_t is None
                      or now - self._last_scale_t >= self.cooldown_s)
            if cooled and n < self.max_replicas and (
                    shed_rate > self.scale_up_shed_rate
                    or depth > self.scale_up_queue_depth):
                decision = {"action": "up",
                            "reason": f"shed_rate={shed_rate:.3f} "
                                      f"depth={depth:g}"}
                self._scale_up(now)
            elif cooled and n > self.min_replicas \
                    and shed_rate == 0.0 \
                    and depth <= 0.0 \
                    and rps / max(1, n) \
                    < self.scale_down_rps_per_replica:
                decision = {"action": "down",
                            "reason": f"rps/replica="
                                      f"{rps / max(1, n):.2f}"}
                self._scale_down(now)
        self._prev_fleet = agg
        self._prev_tick_t = now
        return decision

    def _health_poll(self) -> None:
        with self._lock:
            handles = list(self.replicas)
        for h in handles:
            dead = False
            try:
                # chaos drill: an armed raise is consumed as a forced
                # "this replica is dead" verdict — the SIGKILL drill
                # without killing a real process
                _fire("serving.replica_kill")
            except FaultInjectedError:
                dead = True
            if not dead:
                dead = not h.healthy()
            if dead:
                self._remove_dead(h)

    def _remove_dead(self, handle) -> None:
        """Drop a dead replica and retire its backing.

        Generation durability rides on this ordering: membership drops
        FIRST (drain=False — the replica is dead, nothing to wait for),
        so the router treats any in-flight failure on it as an
        orchestrated removal, not replica badness; then `retire()` —
        for a still-reachable ModelServer that stops the decode engines
        BEFORE the HTTP listener, so in-flight generations answer 503
        with their resumable partial streams and the router's
        `generate` failover re-dispatches them to a healthy replica as
        continuations. A hard-killed replica leaves no partial; those
        requests restart from their prompts, which greedy decode makes
        byte-identical anyway."""
        logger.warning("replica %s is dead; removing from the fleet",
                       handle.name)
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r is not handle]
            self._deaths += 1
        if self.router is not None:
            try:
                self.router.remove_replica(handle.name, drain=False)
            except ValueError:
                pass   # already gone from the router
        try:
            handle.retire()
        except Exception:   # noqa: BLE001 - it is already dead
            pass
        _obs.count("dl4j_fleet_replica_deaths_total")
        self._emit_pool_gauge()

    def _backfill_to_min(self) -> None:
        """Replace dead capacity up to min_replicas immediately —
        backfill is repair, not scaling, so no cooldown applies."""
        if self.replica_factory is None:
            return
        while True:
            with self._lock:
                need = len(self.replicas) < self.min_replicas
            if not need:
                return
            self._spawn_replica()

    def _spawn_replica(self) -> None:
        handle = self.replica_factory()
        if self.router is not None:
            self.router.add_replica(handle.name)
        with self._lock:
            self.replicas.append(handle)
        self._emit_pool_gauge()

    def _scale_up(self, now: float) -> None:
        if self.replica_factory is None:
            return
        self._spawn_replica()
        self._last_scale_t = now
        with self._lock:
            self._scale_events["up"] += 1
        _obs.count("dl4j_fleet_scale_events_total",
                   labels={"direction": "up"})
        self._persist_state()

    def _scale_down(self, now: float) -> None:
        with self._lock:
            if len(self.replicas) <= self.min_replicas:
                return
            victim = self.replicas[-1]
        # the router DRAINS the victim's in-flight requests before
        # membership drops; only then does the replica's own
        # drain-then-retire machinery tear it down
        if self.router is not None:
            try:
                self.router.remove_replica(
                    victim.name, drain=True,
                    drain_timeout_s=self.drain_timeout_s)
            except ValueError:
                pass
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r is not victim]
        try:
            victim.retire()
        except Exception:   # noqa: BLE001 - best-effort teardown
            logger.exception("retire of %s failed", victim.name)
        self._last_scale_t = now
        with self._lock:
            self._scale_events["down"] += 1
        _obs.count("dl4j_fleet_scale_events_total",
                   labels={"direction": "down"})
        self._emit_pool_gauge()
        self._persist_state()

    # ------------------------------------------------------------ facts
    def stats(self) -> dict:
        now = self._clock()
        with self._lock:
            return {
                "replicas": [r.name for r in self.replicas],
                "rollout": {"state": self._state,
                            "history": list(self._history)},
                "holddown": {
                    f"{m}:{v}": {
                        "failures": e["failures"],
                        "remaining_s": max(0.0, e["until"] - now),
                        "reason": e["reason"],
                    } for (m, v), e in self._holddown.items()},
                "autoscaler": {
                    "scale_events": dict(self._scale_events),
                    "deaths": self._deaths,
                    "last_sample": (dict(self._last_fleet_sample)
                                    if self._last_fleet_sample
                                    else None),
                    "min": self.min_replicas,
                    "max": self.max_replicas,
                    "restored_target": self._restored_target,
                },
                "state_path": self._state_path,
            }
