"""DCN scaling model (a copy of deeplearning4j_tpu/parallel/dcn_model.py:
arithmetic only): when does synchronous training stop scaling, and
which knob restores it.

Its default link describes a TPU slice's DCN; the port feeds it its
own measured step time and parameter bytes, and no output of it is a
figure for a GPU interconnect.

Round-3's verdict accepted replacing the reference's async parameter
server (SharedTrainingMaster.java:72) with synchronous SPMD
collectives "only while single-slice sync scaling stays efficient —
nothing in-repo measures when sync-over-DCN stops scaling". This
module is that measurement: an analytical ring-all-reduce cost model
(the standard alpha-beta model, the same arithmetic the scaling
playbooks use) evaluated against a measured single-slice step time,
comparing the four strategies this package implements:

- sync: per-step gradient all-reduce over DCN (TrainingMaster default)
- local_sgd(k): one parameter average every k steps
  (averaging_frequency=k)
- local_sgd(k) + threshold compression: the k-step delta shrinks by
  the measured wire ratio (threshold_compression=t; feed
  LocalStepTrainer.wire_stats()['compression_ratio'])
- stale: 1-step-delayed application (StaleGradientTrainer) — the
  exchange overlaps the next step's compute, costing only what
  exceeds one step time

All times in milliseconds, sizes in bytes, bandwidth in GB/s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class DcnLink:
    """Cross-slice interconnect spec. Defaults are a typical
    data-center NIC: 25 gigaBYTES/s effective per host, ~0.1 ms
    latency. (Field is GB/s, not Gbps — divide a NIC's line rate in
    gigabits by 8.)"""

    bandwidth_GBps: float = 25.0    # gigaBYTES per second
    latency_ms: float = 0.1


def allreduce_ms(nbytes: float, n_slices: int, link: DcnLink) -> float:
    """Ring all-reduce cost (alpha-beta model): 2(n-1)/n * bytes / BW
    + 2(n-1) * alpha."""
    if n_slices <= 1:
        return 0.0
    bw = link.bandwidth_GBps * 1e9 / 1e3          # bytes per ms
    return (2.0 * (n_slices - 1) / n_slices * nbytes / bw
            + 2.0 * (n_slices - 1) * link.latency_ms)


def efficiency(step_ms: float, exchange_ms: float,
               period_steps: int = 1, overlap_ms: float = 0.0) -> float:
    """Fraction of wall time spent computing: period_steps of compute
    against one exchange, of which overlap_ms hides under compute."""
    exposed = max(exchange_ms - overlap_ms, 0.0)
    compute = step_ms * period_steps
    return compute / (compute + exposed)


def crossover_report(param_bytes: float, step_ms: float,
                     n_slices: int, link: Optional[DcnLink] = None,
                     k: int = 8,
                     compression_ratio: float = 0.25,
                     target_efficiency: float = 0.9) -> Dict:
    """Evaluate the four strategies at one operating point and find the
    smallest local-SGD k that reaches `target_efficiency`.

    `compression_ratio` should come from a measured
    LocalStepTrainer.wire_stats()['compression_ratio'].
    """
    link = link or DcnLink()
    ex = allreduce_ms(param_bytes, n_slices, link)

    sync_eff = efficiency(step_ms, ex)
    local_eff = efficiency(step_ms, ex, period_steps=k)
    comp_eff = efficiency(
        step_ms,
        allreduce_ms(param_bytes * compression_ratio, n_slices, link),
        period_steps=k)
    stale_eff = efficiency(step_ms, ex, overlap_ms=step_ms)

    k_needed = 1
    while (efficiency(step_ms, ex, period_steps=k_needed)
           < target_efficiency and k_needed < 4096):
        k_needed += 1
    target_reachable = (efficiency(step_ms, ex, period_steps=k_needed)
                        >= target_efficiency)

    return {
        "exchange_ms": ex,
        "step_ms": step_ms,
        "n_slices": n_slices,
        "sync_efficiency": sync_eff,
        "sync_scales": sync_eff >= target_efficiency,
        "local_sgd_k": k,
        "local_sgd_efficiency": local_eff,
        "local_sgd_compressed_efficiency": comp_eff,
        "stale_overlap_efficiency": stale_eff,
        "k_for_target": k_needed if target_reachable else None,
        "target_reachable": target_reachable,
        "target_efficiency": target_efficiency,
    }


def sweep(param_bytes: float, step_ms: float, slice_counts,
          link: Optional[DcnLink] = None, **kw):
    """crossover_report at several slice counts — the scaling curve.
    The first entry with sync_scales == False is the crossover."""
    return [crossover_report(param_bytes, step_ms, n, link, **kw)
            for n in slice_counts]
