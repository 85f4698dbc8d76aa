"""TelemetryListener: registry emission for plain `net.fit` loops (counterpart
of deeplearning4j_tpu/observability/telemetry.py).

TrainingMaster / ParallelWrapper / ParallelInference emit natively (the
hooks live inside their loops); a bare `net.fit(...)` has no such loop
to instrument, so this listener is the adapter — attach it like any
other training listener and every iteration lands in the global
MetricsRegistry:

    net.listeners.append(TelemetryListener(frequency=10))
    net.fit(batches)
    print(get_registry().prometheus_text())

Per iteration it emits `dl4j_train_steps_total` and
`dl4j_train_step_seconds` (wall clock between iteration_done calls — on
a CUDA device this is launch cadence, not device latency; the forced
sync happens only on loss-sampling iterations). Every
`frequency` iterations it syncs the score to host and sets
`dl4j_train_loss` — budget that sync like StatsListener's collection
cadence. With a `tracer` attached, each loss-sampling iteration also
records a "train_step" span, so a plain fit shows up on the shared
timeline next to serving and checkpoint spans.
"""

from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.observability.tracing import Tracer


class TelemetryListener:
    """Emit per-iteration training metrics into the global registry.

    All emission rides the guarded helpers (`obs.emit` fault point), so
    a telemetry failure never breaks the fit."""

    def __init__(self, frequency: int = 10,
                 tracer: Optional[Tracer] = None):
        self.frequency = max(1, int(frequency))
        self.tracer = tracer
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        if self._last is None:
            _obs.count("dl4j_train_steps_total")
        else:
            _obs.count_observe(
                "dl4j_train_steps_total", "dl4j_train_step_seconds",
                now - self._last)
            if (self.tracer is not None
                    and iteration % self.frequency == 0):
                try:
                    self.tracer.record(
                        "train_step", self._last, now, cat="train",
                        args={"iteration": int(iteration)})
                except Exception:   # noqa: BLE001 - telemetry best-effort
                    pass
        self._last = now
        if iteration % self.frequency == 0:
            try:
                score = model.score()
            except Exception:   # noqa: BLE001 - telemetry best-effort
                score = None
            if score is not None:
                _obs.set_gauge("dl4j_train_loss", float(score))
