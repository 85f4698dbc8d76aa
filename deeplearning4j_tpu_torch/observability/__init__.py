"""Observability of the port (counterpart of deeplearning4j_tpu/observability/):
the metrics registry with Prometheus text (metrics.py), span tracing with
Chrome trace export (tracing.py), the cost model, the step phase
profiler and cross-process aggregation (perf.py), and TelemetryListener
(telemetry.py)."""

from deeplearning4j_tpu_torch.observability.metrics import (  # noqa: F401
    DERIVED_METRICS,
    MetricsRegistry,
    REGISTERED_METRICS,
    StepAccumulator,
    count,
    count_observe,
    enable,
    gauge_fn,
    get_registry,
    observe,
    parse_prometheus,
    parse_prometheus_snapshot,
    render_prometheus,
    set_gauge,
    telemetry_enabled,
)
from deeplearning4j_tpu_torch.observability.perf import (  # noqa: F401
    CostModel,
    StepPhaseProfiler,
    aggregate_prometheus_text,
    aggregate_snapshots,
    count_cost,
    dump_snapshot,
)
from deeplearning4j_tpu_torch.observability.tracing import (  # noqa: F401
    Span,
    Tracer,
)
from deeplearning4j_tpu_torch.observability.telemetry import (  # noqa: F401
    TelemetryListener,
)
