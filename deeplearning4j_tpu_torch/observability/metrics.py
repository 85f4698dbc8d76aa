"""MetricsRegistry: one thread-safe substrate for the port's counters,
with Prometheus text exposition (a copy of
deeplearning4j_tpu/observability/metrics.py: the same names, the same
snapshot shape and byte-identical exposition text for the same
emissions).

  counters    monotonic floats, optional labels ({"code": "503"})
  gauges      last-write-wins floats; `gauge_fn` registers a pull-style
              provider evaluated at snapshot/scrape time
  histograms  fixed-boundary buckets (Prometheus exposition) PLUS a
              bounded ring buffer of recent raw observations for
              p50/p90/p99 estimation

Emission is failure-proof by construction: code emits through the
module-level `count/observe/count_observe/set_gauge/gauge_fn` helpers,
each of which passes through the `obs.emit` fault point and swallows ANY
exception (counted in `dl4j_obs_dropped_emissions_total`) — a telemetry
failure must never break a training step or drop a request.
`enable(False)` turns every helper into a constant-time no-op. Hot
single-threaded loops batch through a `StepAccumulator`.

`prometheus_text()` / `render_prometheus(snapshot)` give the text
exposition format 0.0.4; `parse_prometheus` and
`parse_prometheus_snapshot` read it back (observability/perf.py merges
per-process snapshots through the same renderer).

`REGISTERED_METRICS` names what the port emits, under the JAX package's
names: the training engine's, TrainingMaster's, the watchdog's and the
Supervisor's `dl4j_train_*` (with the phase profiler's
`dl4j_train_phase_seconds`), `dl4j_cluster_world_size`, the input
pipeline's `dl4j_pipeline_*`, the checkpoint and model writers'
`dl4j_checkpoint_*`, the retry policies', the cost model's `dl4j_perf_*`,
ParallelInference's `dl4j_serving_*`, the decode engine's and flight
recorder's `dl4j_decode_*`, the generation journal's `dl4j_journal_*`,
the program cache's `dl4j_jit_*`, and the serving control plane's
(HTTP front end, registry, admission, router) `dl4j_serving_*`,
`dl4j_fleet_*` and `dl4j_rollout_*`.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.resilience.faults import (
    fire as _fire,
    injector as _injector,
)

# latency-shaped default boundaries (seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# row-count-shaped boundaries (batch occupancy, powers of two)
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

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
    "dl4j_train_watchdog_hangs_total",
    "dl4j_train_preemptions_total",
    "dl4j_train_supervisor_restarts_total",
    # TrainingMaster (parallel/training_master.py)
    "dl4j_train_data_wait_seconds",
    "dl4j_train_data_skipped_steps_total",
    "dl4j_cluster_world_size",
    # device-mesh sharding (engine/mesh.py, ZeRO-1 scale-out)
    "dl4j_mesh_world_size",
    "dl4j_mesh_reshard_total",
    "dl4j_mesh_allgather_seconds",
    # checkpoints and model files (parallel/training_master.py,
    # util/model_serializer.py, resilience/checkpoint_integrity.py)
    "dl4j_checkpoint_writes_total",
    "dl4j_checkpoint_write_seconds",
    "dl4j_checkpoint_restores_total",
    "dl4j_checkpoint_restore_seconds",
    "dl4j_checkpoint_validate_failures_total",
    # serving (parallel/inference.py)
    "dl4j_serving_queue_depth",
    "dl4j_serving_inflight_batches",
    "dl4j_serving_batches_total",
    "dl4j_serving_batch_occupancy",
    "dl4j_serving_bucket_splits_total",
    # continuous-batching decode engine (serving/continuous.py)
    "dl4j_decode_active_slots",
    "dl4j_decode_tokens_total",
    "dl4j_decode_tokens_per_s",
    "dl4j_decode_prefill_seconds",
    "dl4j_decode_slot_evictions_total",
    # paged KV virtual memory (prefix trie / chunked prefill / ring wrap)
    "dl4j_decode_prefix_hits_total",
    "dl4j_decode_prefix_pages_shared",
    "dl4j_decode_pages_free",
    "dl4j_decode_prefill_chunks_total",
    "dl4j_decode_ctx_wraps_total",
    # decode durability (quarantine / watchdog / deadlines)
    "dl4j_decode_slot_quarantines_total",
    "dl4j_decode_replays_total",
    "dl4j_decode_deadline_expired_total",
    "dl4j_decode_engine_restarts_total",
    # per-request latency attribution + the crash flight recorder
    # (serving/flight.py)
    "dl4j_decode_ttft_seconds",
    "dl4j_decode_itl_seconds",
    "dl4j_decode_queue_wait_seconds",
    "dl4j_decode_flight_dumps_total",
    # program cache (nn/jit_cache.py) and the trace gauge /metrics sets
    "dl4j_jit_compiles_total",
    "dl4j_jit_traces_total",
    # HTTP front end, registry and admission (parallel/serving.py,
    # serving/registry.py, serving/admission.py)
    "dl4j_serving_requests_total",
    "dl4j_serving_errors_total",
    "dl4j_serving_request_seconds",
    "dl4j_serving_model_requests_total",
    "dl4j_serving_active_models",
    "dl4j_serving_swaps_total",
    "dl4j_serving_rollbacks_total",
    "dl4j_serving_load_rejected_total",
    "dl4j_serving_admitted_total",
    "dl4j_serving_shed_total",
    # replica router (serving/router.py)
    "dl4j_serving_replica_failovers_total",
    "dl4j_decode_migrations_total",
    # fleet controller (serving/controller.py)
    "dl4j_fleet_replicas",
    "dl4j_fleet_scale_events_total",
    "dl4j_fleet_replica_deaths_total",
    "dl4j_rollout_state",
    "dl4j_rollout_total",
    "dl4j_rollout_rollbacks_total",
    "dl4j_rollout_holddowns_total",
    "dl4j_rollout_detection_seconds",
    # durable serving journal (serving/journal.py)
    "dl4j_journal_records_total",
    "dl4j_journal_fsyncs_total",
    "dl4j_journal_torn_tails_total",
    "dl4j_journal_recovered_requests_total",
    "dl4j_journal_compactions_total",
    "dl4j_journal_bytes",
    "dl4j_journal_live",
    # performance introspection (observability/perf.py)
    "dl4j_perf_mfu",
    "dl4j_perf_program_flops",
    "dl4j_perf_program_bytes",
    "dl4j_perf_arithmetic_intensity",
    "dl4j_train_phase_seconds",
    # retry and circuit breaker (resilience/retry.py)
    "dl4j_retry_attempts_total",
    "dl4j_breaker_transitions_total",
    # cluster supervision (resilience/cluster.py)
    "dl4j_cluster_gang_restarts_total",
    "dl4j_cluster_quarantined_workers_total",
    "dl4j_cluster_spare_reschedules_total",
    "dl4j_cluster_shrinks_total",
    # input pipeline (engine/pipeline.py)
    "dl4j_pipeline_batches_total",
    "dl4j_pipeline_wait_seconds",
    "dl4j_pipeline_reseeks_total",
    "dl4j_pipeline_depth",
    # derived by the registry itself (no count()/observe() call site)
    "dl4j_obs_dropped_emissions_total",
})

# registered names the registry synthesizes internally — the pin test
# excludes these from the "must have an emission call site" check
DERIVED_METRICS = frozenset({"dl4j_obs_dropped_emissions_total"})

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
    """Thread-safe named counters/gauges/histograms + exposition.

    All mutation happens under one lock — exact totals under concurrent
    emission (pinned by test) beat lock-free approximations here; the
    protected section is a couple of dict operations."""

    def __init__(self, ring_size: int = 512):
        self._lock = threading.Lock()
        self._ring_size = int(ring_size)
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}
        # histograms are label-aware (dl4j_train_phase_seconds{phase=})
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

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Register a pull-style gauge provider, evaluated (and
        swallowed on failure) at snapshot/scrape time."""
        with self._lock:
            self._gauge_fns[name] = fn

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
            self._gauge_fns.clear()
            self._hists.clear()
            self.dropped = 0
            self._created = time.monotonic()

    # ------------------------------------------------------------- reads
    def uptime_s(self) -> float:
        return time.monotonic() - self._created

    def counter_value(self, name: str,
                      labels: Optional[dict] = None) -> float:
        """One series' value; with labels=None the sum over ALL label
        sets of `name` (the /status monotonic-total view)."""
        with self._lock:
            series = self._counters.get(name, {})
            if labels is None:
                return float(sum(series.values()))
            return float(series.get(_label_key(labels), 0.0))

    def gauge_value(self, name: str,
                    labels: Optional[dict] = None) -> Optional[float]:
        with self._lock:
            fn = self._gauge_fns.get(name)
            series = dict(self._gauges.get(name, {}))
        if fn is not None and labels is None:
            try:
                return float(fn())
            except Exception:   # noqa: BLE001 - provider must not break reads
                self.note_dropped()
                return None
        return series.get(_label_key(labels))

    def _eval_gauge_fns(self) -> Dict[str, float]:
        with self._lock:
            fns = dict(self._gauge_fns)
        out = {}
        for name, fn in fns.items():
            try:
                out[name] = float(fn())
            except Exception:   # noqa: BLE001 - provider must not break scrape
                self.note_dropped()
        return out

    def snapshot(self) -> dict:
        """One coherent dict of everything: the dashboard's (and any
        in-process consumer's) read surface."""
        pulled = self._eval_gauge_fns()
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
        for name, v in pulled.items():
            gauges.setdefault(name, {})[""] = v
        counters.setdefault(
            "dl4j_obs_dropped_emissions_total", {})[""] = float(dropped)
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "uptime_s": self.uptime_s()}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4 (a GET /metrics
        body)."""
        return render_prometheus(self.snapshot())


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _split_hist_name(full: str) -> Tuple[str, str]:
    """'name{a="b"}' -> ('name', 'a="b"'); bare names -> (name, '')."""
    base, _, lab = full.partition("{")
    return base, (lab[:-1] if lab.endswith("}") else lab)


def _bucket_order(item) -> float:
    le = item[0]
    return float("inf") if le == "+Inf" else float(le)


def render_prometheus(snap: dict) -> str:
    """Render a `MetricsRegistry.snapshot()`-shaped dict to Prometheus
    text exposition 0.0.4. Module-level so perf.aggregate_snapshots can
    render a merged fleet-level snapshot through the exact same code
    path as a single registry's /metrics body."""
    lines: List[str] = []
    for name in sorted(snap.get("counters", {})):
        lines.append(f"# TYPE {name} counter")
        for lab, v in sorted(snap["counters"][name].items()):
            lines.append(f"{name}{lab} {_fmt(v)}")
    for name in sorted(snap.get("gauges", {})):
        lines.append(f"# TYPE {name} gauge")
        for lab, v in sorted(snap["gauges"][name].items()):
            lines.append(f"{name}{lab} {_fmt(v)}")
    typed = set()
    for full in sorted(snap.get("histograms", {})):
        h = snap["histograms"][full]
        base, inner = _split_hist_name(full)
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE {base} histogram")
        pre = inner + "," if inner else ""
        suffix = "{" + inner + "}" if inner else ""
        cum = 0
        for le, c in sorted(h["buckets"].items(), key=_bucket_order):
            cum += c
            lines.append(f'{base}_bucket{{{pre}le="{le}"}} {cum}')
        lines.append(f"{base}_sum{suffix} {_fmt(h['sum'])}")
        lines.append(f"{base}_count{suffix} {h['count']}")
    return "\n".join(lines) + "\n"


_LABEL_PAIR = re.compile(r'(\w+)="([^"]*)"')


def parse_prometheus_snapshot(text: str) -> dict:
    """Parse exposition text back into a `MetricsRegistry.snapshot()`-
    shaped dict — the inverse of `render_prometheus` (ring quantiles
    cannot survive the wire and come back as None; histogram bucket
    counts are de-cumulated back to per-bucket form).

    This is the scrape half of fleet-level aggregation: a controller
    scrapes each replica's /metrics body, rebuilds snapshots with this,
    and merges them through `perf.aggregate_snapshots` — the same merge
    path the cross-rank training exposition uses."""
    types: Dict[str, str] = {}
    snap: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    hist_raw: Dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        full, _, val = line.rpartition(" ")
        try:
            value = float(val)
        except ValueError:
            continue
        base, lab = _split_hist_name(full)
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) \
                    and types.get(base[:-len(suffix)]) == "histogram":
                hname = base[:-len(suffix)]
                pairs = _LABEL_PAIR.findall(lab)
                le = dict(pairs).get("le")
                rest = sorted((k, v) for k, v in pairs if k != "le")
                series_key = hname + _label_str(tuple(rest))
                h = hist_raw.setdefault(
                    series_key, {"count": 0, "sum": 0.0, "cum": []})
                if suffix == "_bucket" and le is not None:
                    h["cum"].append((le, value))
                elif suffix == "_sum":
                    h["sum"] = value
                else:
                    h["count"] = int(value)
                break
        else:
            kind = types.get(base)
            tgt = snap["gauges"] if kind == "gauge" else snap["counters"]
            tgt.setdefault(base, {})[
                "{" + lab + "}" if lab else ""] = value
    for series_key, h in hist_raw.items():
        cum = sorted(h["cum"], key=_bucket_order)
        buckets, prev = {}, 0
        for le, c in cum:
            buckets[le] = int(c) - prev
            prev = int(c)
        snap["histograms"][series_key] = {
            "count": h["count"], "sum": h["sum"], "buckets": buckets,
            "p50": None, "p90": None, "p99": None}
    return snap


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse exposition text into {sample_name_with_labels: value} —
    the flat view tests assert against."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out


# ---------------------------------------------------- guarded emission
# process-global default registry: every subsystem of the port emits
# here, prometheus_text() renders it, the dashboard reads it
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
    into a constant-time no-op. Hot single-threaded loops (the per-step
    training sites) batch through a `StepAccumulator` instead: container
    appends per step, one guarded registry write per flush — the same
    totals."""
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


def gauge_fn(name: str, fn: Callable[[], float]) -> None:
    if not _ENABLED:
        return
    try:
        _maybe_fire()
        _DEFAULT.gauge_fn(name, fn)
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
    emission would have produced; a /metrics scrape between flushes
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
        """Labeled observations (the phase-attribution site) key the
        pending dict on (name, label-key); apply_batch folds both forms
        into the registry identically."""
        if not _ENABLED:
            return
        key = (name, _label_key(labels)) if labels else name
        self._hist_vals.setdefault(key, []).append(float(value))

    def observe_keyed(self, key, value: float) -> None:
        """Pre-resolved (name, label-key) observation — the phase
        profiler's per-step fast path (no label dict built, no sort
        per call; the key tuples are computed once at import)."""
        if not _ENABLED:
            return
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
