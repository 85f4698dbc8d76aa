"""MetricsRegistry: one thread-safe substrate for the port's counters (a
copy of deeplearning4j_tpu/observability/metrics.py without the
Prometheus text rendering, which waits for the port's serving front end).

  counters    monotonic floats, optional labels
  gauges      last-write-wins floats
  histograms  fixed-boundary buckets PLUS a bounded ring buffer of
              recent raw observations for p50/p90/p99 estimation

Emission is failure-proof by construction: code emits through the
module-level `count/observe/count_observe/set_gauge` helpers,
each of which passes through the `obs.emit` fault point and swallows ANY
exception (counted in `dl4j_obs_dropped_emissions_total`) — a telemetry
failure must never break a training step. `enable(False)` turns every
helper into a constant-time no-op. Hot single-threaded loops batch
through a `StepAccumulator`.

`REGISTERED_METRICS` names what the port emits: the training engine's
and TrainingMaster's `dl4j_train_*` (and `dl4j_cluster_world_size`), the
input pipeline's `dl4j_pipeline_*`, the checkpoint and model writers'
`dl4j_checkpoint_*` and the retry policies' metrics, under the JAX
package's names.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.resilience.faults import (
    fire as _fire,
    injector as _injector,
)

# latency-shaped default boundaries (seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# every metric name the port may emit (tests/test_torch_engine.py pins
# the emission sites against this registry)
REGISTERED_METRICS = frozenset({
    # training engine (engine/harness.py, resilience/supervisor.py)
    "dl4j_train_steps_total",
    "dl4j_train_step_seconds",
    "dl4j_train_loss",
    "dl4j_train_guard_checks_total",
    "dl4j_train_guard_nonfinite_total",
    "dl4j_train_guard_spikes_total",
    "dl4j_train_guard_skipped_steps_total",
    "dl4j_train_guard_rollbacks_total",
    "dl4j_train_preemptions_total",
    # TrainingMaster (parallel/training_master.py)
    "dl4j_train_data_wait_seconds",
    "dl4j_train_data_skipped_steps_total",
    "dl4j_cluster_world_size",
    # checkpoints and model files (parallel/training_master.py,
    # util/model_serializer.py, resilience/checkpoint_integrity.py)
    "dl4j_checkpoint_writes_total",
    "dl4j_checkpoint_write_seconds",
    "dl4j_checkpoint_restores_total",
    "dl4j_checkpoint_restore_seconds",
    "dl4j_checkpoint_validate_failures_total",
    # retry and circuit breaker (resilience/retry.py)
    "dl4j_retry_attempts_total",
    "dl4j_breaker_transitions_total",
    # input pipeline (engine/pipeline.py)
    "dl4j_pipeline_batches_total",
    "dl4j_pipeline_wait_seconds",
    "dl4j_pipeline_reseeks_total",
    "dl4j_pipeline_depth",
    # derived by the registry itself (no count()/observe() call site)
    "dl4j_obs_dropped_emissions_total",
})

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count", "ring")

    def __init__(self, buckets, ring_size: int):
        self.buckets: Tuple[float, ...] = tuple(
            sorted(float(b) for b in buckets))
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.ring: deque = deque(maxlen=ring_size)

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.ring.append(v)

    def quantile(self, q: float) -> Optional[float]:
        """Estimate from the ring of recent raw observations (exact over
        the window, no sketch error — the window IS the estimator)."""
        if not self.ring:
            return None
        vals = sorted(self.ring)
        idx = min(len(vals) - 1, max(0, int(q * len(vals))))
        return vals[idx]


class MetricsRegistry:
    """Thread-safe named counters/gauges/histograms.

    All mutation happens under one lock — exact totals under concurrent
    emission (pinned by test) beat lock-free approximations here; the
    protected section is a couple of dict operations."""

    def __init__(self, ring_size: int = 512):
        self._lock = threading.Lock()
        self._ring_size = int(ring_size)
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        # histograms are label-aware
        # — one _Hist per (name, label set), unlabeled = the () key
        self._hists: Dict[str, Dict[_LabelKey, _Hist]] = {}
        self._created = time.monotonic()
        self.dropped = 0

    # ------------------------------------------------------------ writes
    def inc(self, name: str, n: float = 1.0,
            labels: Optional[dict] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + n

    def set_gauge(self, name: str, value: float,
                  labels: Optional[dict] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def _hist(self, name: str, key: _LabelKey, buckets) -> _Hist:
        """The (name, label set) histogram, created on first observe.
        Caller holds the lock."""
        series = self._hists.setdefault(name, {})
        h = series.get(key)
        if h is None:
            h = _Hist(buckets if buckets is not None
                      else DEFAULT_BUCKETS, self._ring_size)
            series[key] = h
        return h

    def observe(self, name: str, value: float, buckets=None,
                labels: Optional[dict] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._hist(name, key, buckets).observe(float(value))

    def inc_observe(self, counter_name: str, hist_name: str,
                    value: float, n: float = 1.0,
                    buckets=None) -> None:
        """Fused counter-increment + histogram-observe under ONE lock
        acquisition — the per-step hot path (steps_total +
        step_seconds, batches_total + occupancy) emits two metrics for
        one lock's worth of overhead."""
        with self._lock:
            series = self._counters.setdefault(counter_name, {})
            series[()] = series.get((), 0.0) + n
            self._hist(hist_name, (), buckets).observe(float(value))

    def apply_batch(self, counts: Dict[str, float],
                    hist_values: Dict, buckets=None) -> None:
        """Atomically fold in a StepAccumulator's pending aggregate —
        totals and observations identical to emitting one by one, for
        one lock acquisition per flush instead of per step. Histogram
        keys are either a name or a (name, label-key) tuple (the
        accumulator's labeled-observation form)."""
        with self._lock:
            for name, n in counts.items():
                series = self._counters.setdefault(name, {})
                series[()] = series.get((), 0.0) + n
            for hkey, vals in hist_values.items():
                name, lk = (hkey if isinstance(hkey, tuple)
                            else (hkey, ()))
                h = self._hist(name, lk, buckets)
                for v in vals:
                    h.observe(v)

    def note_dropped(self) -> None:
        with self._lock:
            self.dropped += 1

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self.dropped = 0
            self._created = time.monotonic()

    # ------------------------------------------------------------- reads
    def uptime_s(self) -> float:
        return time.monotonic() - self._created

    def counter_value(self, name: str,
                      labels: Optional[dict] = None) -> float:
        """One series' value; with labels=None the sum over ALL label
        sets of `name` (the monotonic-total view)."""
        with self._lock:
            series = self._counters.get(name, {})
            if labels is None:
                return float(sum(series.values()))
            return float(series.get(_label_key(labels), 0.0))

    def snapshot(self) -> dict:
        """One coherent dict of everything: the in-process read
        surface."""
        with self._lock:
            counters = {
                name: {_label_str(k): v for k, v in series.items()}
                for name, series in self._counters.items()}
            gauges = {
                name: {_label_str(k): v for k, v in series.items()}
                for name, series in self._gauges.items()}
            hists = {}
            for name, series in self._hists.items():
                for lk, h in series.items():
                    # unlabeled series keeps the bare name (the
                    # pre-labeled-histogram snapshot contract)
                    hists[name + _label_str(lk)] = {
                        "count": h.count,
                        "sum": round(h.sum, 9),
                        "buckets": {("+Inf" if i == len(h.buckets)
                                     else repr(h.buckets[i])): c
                                    for i, c in enumerate(h.counts)},
                        "p50": h.quantile(0.50),
                        "p90": h.quantile(0.90),
                        "p99": h.quantile(0.99),
                    }
            dropped = self.dropped
        counters.setdefault(
            "dl4j_obs_dropped_emissions_total", {})[""] = float(dropped)
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "uptime_s": self.uptime_s()}


# ---------------------------------------------------- guarded emission
# process-global default registry: every subsystem of the port emits
# here
_DEFAULT = MetricsRegistry()
_ENABLED = True
_INJ = _injector()


def _maybe_fire() -> None:
    """The `obs.emit` fault point, gated on a LOCK-FREE armed check:
    until some fault is armed the happy-path emission pays one dict
    truthiness read instead of fire()'s lock + hit accounting (measured
    ~3 us per call in situ — the dominant third of emission cost).
    Chaos runs arm a spec and get the full fire."""
    if _INJ._specs:
        _fire("obs.emit")


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def enable(on: bool = True) -> None:
    """Global kill switch: enable(False) turns every emission helper
    into a constant-time no-op."""
    global _ENABLED
    _ENABLED = bool(on)


def telemetry_enabled() -> bool:
    return _ENABLED


def count(name: str, n: float = 1.0,
          labels: Optional[dict] = None) -> None:
    """Increment a counter. NEVER raises: the `obs.emit` fault point
    fires inside the guard, so injected (or real) emission failures are
    swallowed and counted as dropped — telemetry can't fail a step."""
    if not _ENABLED:
        return
    try:
        _maybe_fire()
        _DEFAULT.inc(name, n, labels)
    except Exception:   # noqa: BLE001 - telemetry must never propagate
        try:
            _DEFAULT.note_dropped()
        except Exception:   # noqa: BLE001 - even the drop note is best-effort
            pass


def observe(name: str, value: float, buckets=None,
            labels: Optional[dict] = None) -> None:
    if not _ENABLED:
        return
    try:
        _maybe_fire()
        _DEFAULT.observe(name, value, buckets=buckets, labels=labels)
    except Exception:   # noqa: BLE001 - telemetry must never propagate
        try:
            _DEFAULT.note_dropped()
        except Exception:   # noqa: BLE001
            pass


def count_observe(counter_name: str, hist_name: str, value: float,
                  n: float = 1.0, buckets=None) -> None:
    """Fused counter + histogram emission (one guarded call, one lock)
    for the hot per-step/per-batch sites."""
    if not _ENABLED:
        return
    try:
        _maybe_fire()
        _DEFAULT.inc_observe(counter_name, hist_name, value, n=n,
                             buckets=buckets)
    except Exception:   # noqa: BLE001 - telemetry must never propagate
        try:
            _DEFAULT.note_dropped()
        except Exception:   # noqa: BLE001
            pass


def set_gauge(name: str, value: float,
              labels: Optional[dict] = None) -> None:
    if not _ENABLED:
        return
    try:
        _maybe_fire()
        _DEFAULT.set_gauge(name, value, labels)
    except Exception:   # noqa: BLE001 - telemetry must never propagate
        try:
            _DEFAULT.note_dropped()
        except Exception:   # noqa: BLE001
            pass


class StepAccumulator:
    """Client-side aggregation for a single-threaded hot loop (the
    per-step training emissions): appends land in plain dicts/lists —
    no lock, no fault point, no histogram bisect — and the aggregate is
    flushed through ONE guarded registry write every `flush_every`
    loop iterations plus at loop end, so the per-step cost is two
    container appends.

    Totals and histogram observations are exactly what per-step
    emission would have produced; a snapshot between flushes
    just sees the registry up to `flush_every` steps stale. The flush
    passes the `obs.emit` fault point: an injected emission failure
    drops that flush's aggregate (counted in
    dl4j_obs_dropped_emissions_total) and never reaches the loop.

    NOT thread-safe by design — one owner loop per instance."""

    __slots__ = ("flush_every", "_counts", "_hist_vals", "_pending")

    def __init__(self, flush_every: int = 32):
        self.flush_every = max(1, int(flush_every))
        self._counts: Dict[str, float] = {}
        self._hist_vals: Dict[str, List[float]] = {}
        self._pending = 0

    def count(self, name: str, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        self._counts[name] = self._counts.get(name, 0.0) + n

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None) -> None:
        """Labeled observations key the
        pending dict on (name, label-key); apply_batch folds both forms
        into the registry identically."""
        if not _ENABLED:
            return
        key = (name, _label_key(labels)) if labels else name
        self._hist_vals.setdefault(key, []).append(float(value))

    def count_observe(self, counter_name: str, hist_name: str,
                      value: float, n: float = 1.0) -> None:
        """The per-iteration site: also advances the flush cadence."""
        if not _ENABLED:
            return
        self._counts[counter_name] = \
            self._counts.get(counter_name, 0.0) + n
        self._hist_vals.setdefault(hist_name, []).append(float(value))
        self._pending += 1
        if self._pending >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Push the pending aggregate through the guarded emission
        boundary. NEVER raises; a failure drops this batch only."""
        counts, hists = self._counts, self._hist_vals
        self._counts, self._hist_vals, self._pending = {}, {}, 0
        if not (counts or hists) or not _ENABLED:
            return
        try:
            _maybe_fire()
            _DEFAULT.apply_batch(counts, hists)
        except Exception:   # noqa: BLE001 - telemetry must never propagate
            try:
                _DEFAULT.note_dropped()
            except Exception:   # noqa: BLE001
                pass
