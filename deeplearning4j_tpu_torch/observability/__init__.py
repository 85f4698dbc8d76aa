"""Observability of the port: the metrics registry (observability/metrics.py).
Tracing, telemetry and the cost model wait (ROADMAP queue 8)."""
