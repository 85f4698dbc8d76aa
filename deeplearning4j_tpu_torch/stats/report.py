"""StatsReport: one observation of training state (a copy of
deeplearning4j_tpu/stats/report.py: the same fields and JSON, so either
package reads the other's reports).

Parity: the reference's SBE-encoded StatsReport
(ui/stats/impl/SbeStatsReport.java; collected fields per
BaseStatsListener.java:106 — score, timing, memory, histograms and mean
magnitudes of params/updates), as a plain dataclass + JSON (reports are
small and collected every N iterations, off the hot path)."""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Histogram:
    """Fixed-bin histogram of one tensor group."""
    min: float
    max: float
    counts: list

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclass
class StatsReport:
    session_id: str
    worker_id: str = "local"
    iteration: int = 0
    epoch: int = 0
    timestamp: float = field(default_factory=time.time)
    score: Optional[float] = None
    samples_per_sec: Optional[float] = None
    batches_per_sec: Optional[float] = None
    iter_ms: Optional[float] = None
    etl_ms: Optional[float] = None
    mem: Dict[str, Any] = field(default_factory=dict)
    # per parameter-group ("0/W", "conv1/b", ...) summaries
    param_mean_magnitudes: Dict[str, float] = field(default_factory=dict)
    update_mean_magnitudes: Dict[str, float] = field(default_factory=dict)
    param_histograms: Dict[str, Histogram] = field(default_factory=dict)
    update_histograms: Dict[str, Histogram] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StatsReport":
        d = dict(d)
        for k in ("param_histograms", "update_histograms"):
            d[k] = {name: Histogram(**h) for name, h in (d.get(k) or {}).items()}
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "StatsReport":
        return cls.from_dict(json.loads(s))
