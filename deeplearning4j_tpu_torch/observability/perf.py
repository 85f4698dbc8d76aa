"""Performance introspection (counterpart of
deeplearning4j_tpu/observability/perf.py): cost-model MFU accounting,
step phase attribution, cross-process metric aggregation.

  CostModel            per-program FLOPs / bytes with MFU, arithmetic
                       intensity and a roofline verdict against the
                       card's peaks. The JAX package reads its numbers
                       from XLA's cost analysis; PyTorch runs eagerly
                       and has none, so the port COUNTS them:
                       `count_cost(fn)` runs fn once under
                       `torch.utils.flop_counter.FlopCounterMode` (a
                       multiply-add is TWO FLOPs, as XLA counts it) and
                       a dispatch mode that adds up the bytes of every
                       non-view aten op's tensor inputs and outputs.
                       The hand-written CUDA kernels launch through
                       ctypes, where neither mode sees them, so a step
                       is counted on a route whose every product is an
                       aten op (engine/step_program.py `register_perf`:
                       a CPU twin of the net, whose kernel wrappers run
                       their plain versions). `source` records what was
                       counted. The byte count is that route's
                       op-by-op traffic: the kernels fuse prologues and
                       epilogues, so it bounds their traffic from above.
  StepPhaseProfiler    decomposes every training step into named phases
                       (data_wait / h2d / dispatch / device_compute /
                       host_sync / checkpoint / telemetry) from
                       perf_counter marks the fit loops already pay for;
                       the sampled `sync` waits on the CUDA stream the
                       step ran on (its wait IS device_compute).
  aggregate_snapshots  merge per-process MetricsRegistry snapshot dumps
                       (`dump_snapshot`) into one snapshot, rendered by
                       the same `render_prometheus` as one registry.

Peaks are the card's, never a TPU's: `PEAK_FLOPS` / `PEAK_BYTES_PER_S`
are keyed by `torch.cuda.get_device_name()`; an unknown GPU raises unless
the caller passes the peaks. "cpu" is a nominal placeholder for the CPU
tests (an MFU there is a smoke-test number, not a claim).

MFU here is `flops / seconds / peak_flops` with the counter's two FLOPs
per multiply-add: the figure `chip_smoke.py` prints as `mfu_2flops`, not
its `mfu` (one FLOP per multiply-add, PERF.md section 2).

Host-side bookkeeping only: torch is imported where a count or a sync
needs it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.observability.metrics import render_prometheus

# per-card peak compute (dense bf16 tensor cores) and memory bandwidth —
# the two roofline axes — from the card's data sheet, keyed by
# torch.cuda.get_device_name(). "cpu" is a nominal placeholder.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "cpu": 1e12,
}
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "cpu": 50e9,
}


def device_peaks(device=None) -> Tuple[Optional[float], Optional[float],
                                       str]:
    """(peak_flops, peak_bytes_per_s, device_kind) of `device` ("cuda"
    when None, which raises without a card; "cpu" gives the
    placeholder). An unknown GPU gives (None, None, kind)."""
    from deeplearning4j_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        kind = "cpu"
    else:
        import torch

        kind = torch.cuda.get_device_name(dev)
    return PEAK_FLOPS.get(kind), PEAK_BYTES_PER_S.get(kind), kind


# ------------------------------------------------ analytic flop counts
def matmul_flops(m: int, k: int, n: int) -> float:
    """[m,k] @ [k,n]: one multiply + one add per MAC."""
    return 2.0 * m * k * n


def conv2d_flops(batch: int, out_h: int, out_w: int, c_out: int,
                 kh: int, kw: int, c_in: int) -> float:
    """Direct convolution MACs x2 (every output reads kh*kw*c_in inputs,
    SAME padding's zeros included — what FlopCounterMode counts too)."""
    return 2.0 * batch * out_h * out_w * c_out * kh * kw * c_in


def train_step_flops_from_params(n_params: int, rows: int) -> float:
    """The classic 6NB estimate (2NB forward + 4NB backward) for a dense
    model with N params on a B-row batch — the coarse analytic fallback."""
    return 6.0 * float(n_params) * float(rows)


# ------------------------------------------------------ counted cost
def count_cost(fn: Callable[[], object]) -> dict:
    """{flops, bytes_accessed} of one call of `fn()`: FLOPs from
    FlopCounterMode (two per multiply-add), bytes as the sum over every
    non-view aten op of its tensor inputs' and outputs' sizes (each op
    reads its inputs and writes its outputs once). Ops that launch
    outside aten (the ctypes kernels on a card) are invisible to both:
    count a route made of aten ops (module docstring)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                for t in tree_flatten((args, kwargs, out))[0]:
                    if isinstance(t, torch.Tensor):
                        self.total += t.numel() * t.element_size()
            return out

    nbytes = _Bytes()
    flops = FlopCounterMode(display=False)
    with flops, nbytes:
        fn()
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.total)}


class CostModel:
    """Per-program FLOPs/bytes registry + MFU / roofline arithmetic.

    Register each program once (outside the timed region), then
    `perf_report(key, seconds_per_call=...)` turns a measured step time
    into MFU, arithmetic intensity and a roofline verdict, and lands them
    as `dl4j_perf_*` registry gauges."""

    def __init__(self, peak_flops: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None,
                 device=None):
        det_flops, det_bw, kind = device_peaks(device)
        if (peak_flops or det_flops) is None \
                or (peak_bytes_per_s or det_bw) is None:
            raise ValueError(
                f"no peak FLOP/s and bytes/s known for {kind!r}; pass "
                "peak_flops= and peak_bytes_per_s= (known: "
                f"{sorted(k for k in PEAK_FLOPS if k != 'cpu')})")
        self.peak_flops = float(peak_flops or det_flops)
        self.peak_bytes_per_s = float(peak_bytes_per_s or det_bw)
        self.device_kind = kind
        self._entries: Dict[str, dict] = {}

    # ------------------------------------------------------- register
    def register_counted(self, key, flops: float,
                         bytes_accessed: Optional[float],
                         source: str) -> dict:
        """An entry counted by `count_cost` (or scaled from such counts);
        `source` says what was counted."""
        entry = {"flops": float(flops),
                 "bytes_accessed": (None if bytes_accessed is None
                                    else float(bytes_accessed)),
                 "peak_bytes": None, "source": str(source)}
        self._entries[str(key)] = entry
        return dict(entry)

    def register_analytic(self, key, flops: float,
                          bytes_accessed: float = 0.0) -> dict:
        entry = {"flops": float(flops),
                 "bytes_accessed": float(bytes_accessed),
                 "peak_bytes": None, "source": "analytic"}
        self._entries[str(key)] = entry
        return dict(entry)

    # ----------------------------------------------------------- reads
    def entry(self, key) -> Optional[dict]:
        e = self._entries.get(str(key))
        return dict(e) if e is not None else None

    def keys(self) -> List[str]:
        return list(self._entries)

    def arithmetic_intensity(self, key) -> Optional[float]:
        e = self._entries.get(str(key))
        if e is None or not e.get("bytes_accessed"):
            return None
        return e["flops"] / e["bytes_accessed"]

    def mfu(self, key, seconds_per_call: float) -> Optional[float]:
        """Model flops utilization: program flops / wall seconds /
        device peak (two FLOPs per multiply-add)."""
        e = self._entries.get(str(key))
        if e is None or seconds_per_call <= 0.0:
            return None
        return e["flops"] / seconds_per_call / self.peak_flops

    def roofline(self, key) -> Optional[dict]:
        """Where this program sits on the roofline: arithmetic intensity
        vs the ridge point (peak_flops / peak_bw), plus the
        bandwidth-bound attainable flops ceiling. None without a byte
        count."""
        ai = self.arithmetic_intensity(key)
        if ai is None:
            return None
        ridge = self.peak_flops / self.peak_bytes_per_s
        return {
            "arithmetic_intensity": ai,
            "ridge_point": ridge,
            "bound": "compute" if ai >= ridge else "memory",
            "attainable_flops_per_s": min(
                self.peak_flops, ai * self.peak_bytes_per_s),
        }

    def perf_report(self, key, seconds_per_call: Optional[float] = None,
                    items_per_call: Optional[float] = None) -> dict:
        """One dict with flops, bytes, arithmetic intensity, roofline
        verdict, and (when a measured `seconds_per_call` is given) MFU +
        achieved flops/s. Also lands the numbers as `dl4j_perf_*`
        gauges."""
        e = self._entries.get(str(key))
        if e is None:
            raise KeyError(f"no cost registered for {key!r}")
        report = {
            "program": str(key),
            "source": e["source"],
            "flops": e["flops"],
            "bytes_accessed": e["bytes_accessed"],
            "peak_bytes": e.get("peak_bytes"),
            "device_kind": self.device_kind,
            "peak_flops": self.peak_flops,
            "peak_bytes_per_s": self.peak_bytes_per_s,
        }
        roof = self.roofline(key)
        if roof is not None:
            report.update(roof)
        if items_per_call:
            report["flops_per_item"] = e["flops"] / items_per_call
        if seconds_per_call:
            report["seconds_per_call"] = seconds_per_call
            report["achieved_flops_per_s"] = \
                e["flops"] / seconds_per_call
            report["mfu"] = self.mfu(key, seconds_per_call)
        labels = {"program": str(key)}
        _obs.set_gauge("dl4j_perf_program_flops", e["flops"],
                       labels=labels)
        if e["bytes_accessed"] is not None:
            _obs.set_gauge("dl4j_perf_program_bytes",
                           e["bytes_accessed"], labels=labels)
        if roof is not None:
            _obs.set_gauge("dl4j_perf_arithmetic_intensity",
                           roof["arithmetic_intensity"], labels=labels)
        if report.get("mfu") is not None:
            _obs.set_gauge("dl4j_perf_mfu", report["mfu"],
                           labels=labels)
        return report

    def digest(self, key) -> Optional[dict]:
        """Compact {flops, bytes, ai} of one entry."""
        e = self._entries.get(str(key))
        if e is None:
            return None
        ai = self.arithmetic_intensity(key)
        return {"flops": e["flops"],
                "bytes_accessed": e["bytes_accessed"],
                "arithmetic_intensity":
                    round(ai, 3) if ai is not None else None}


# ------------------------------------------------ step phase profiler
PHASES = ("data_wait", "h2d", "dispatch", "device_compute",
          "host_sync", "checkpoint", "telemetry")
# pre-resolved accumulator keys: the per-step emission fast path pays
# a dict lookup per phase, not a label-dict build + sort per phase
_PHASE_KEYS = {p: ("dl4j_train_phase_seconds", (("phase", p),))
               for p in PHASES}


def _wait_for_device(value) -> None:
    """Block until the work that produced `value` is done: a CUDA
    tensor's device has its current stream synchronized (a captured
    group replays on the current stream, so that is the replay's
    stream); a CPU tensor is already done."""
    import torch

    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.current_stream(value.device).synchronize()


class StepPhaseProfiler:
    """Attribute every training step's wall time to named phases.

    The owning fit loop calls `begin_step()` once per step (one group of
    k under `steps_per_dispatch=k`), `mark(p)` at each phase boundary
    (phase p runs from its mark to the next mark), optionally
    `sync(device_value)` right after dispatch — when this step samples a
    device sync (`sync_every`), the blocked wait becomes the
    device_compute phase — and `end_step()` in its finally. Durations
    land as `dl4j_train_phase_seconds{phase=...}` through the loop's
    StepAccumulator, cumulative totals stay on the instance for
    `report()`, and with a tracer attached each phase records a span.

    NOT thread-safe — one owner loop per instance."""

    def __init__(self, accumulator=None, tracer=None,
                 sync_every: int = 1):
        self.accumulator = accumulator
        self.tracer = tracer
        # sync_every=N waits on the device every Nth step (0 = never):
        # the only place the profiler adds a sync
        self.sync_every = max(0, int(sync_every))
        self.totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.wall_s = 0.0
        self.steps = 0
        self._marks: List[Tuple[str, float]] = []
        self._t_begin: Optional[float] = None
        self._step = None

    def begin_step(self, step=None) -> None:
        self._t_begin = time.perf_counter()
        self._marks = []
        self._step = step

    def mark(self, phase: str) -> None:
        """Phase `phase` starts now (and the previous phase ends)."""
        self._marks.append((phase, time.perf_counter()))

    def should_sync(self, step=None) -> bool:
        if self.sync_every <= 0:
            return False
        s = self.steps if step is None else int(step)
        return s % self.sync_every == 0

    def sync(self, value, step=None) -> None:
        """Sampled device sync: on sampling steps, wait for `value`'s
        stream and attribute the wait to device_compute. Swallows
        everything — profiling must never fail a step."""
        if value is None or not self.should_sync(step):
            return
        self.mark("device_compute")
        try:
            _wait_for_device(value)
        except Exception:   # noqa: BLE001 - profiling is best-effort
            pass

    def end_step(self) -> None:
        if self._t_begin is None:
            return
        t_end = time.perf_counter()
        marks = self._marks
        durs: Dict[str, float] = {}
        for i, (ph, t) in enumerate(marks):
            t_next = marks[i + 1][1] if i + 1 < len(marks) else t_end
            durs[ph] = durs.get(ph, 0.0) + max(0.0, t_next - t)
        acc = self.accumulator
        tr = self.tracer
        for ph, d in durs.items():
            self.totals[ph] = self.totals.get(ph, 0.0) + d
            key = _PHASE_KEYS.get(ph)
            if acc is not None and key is not None:
                acc.observe_keyed(key, d)
            else:
                _obs.observe("dl4j_train_phase_seconds", d,
                             labels={"phase": ph})
        if tr is not None:
            for i, (ph, t) in enumerate(marks):
                t_next = marks[i + 1][1] if i + 1 < len(marks) else t_end
                tr.record(f"phase:{ph}", t, t_next, cat="phase",
                          args={"step": self._step})
        # the profiler's own emission cost is telemetry time too —
        # attribute it so coverage stays honest, not flattering
        t_done = time.perf_counter()
        self.totals["telemetry"] += t_done - t_end
        self.wall_s += t_done - self._t_begin
        self.steps += 1
        self._t_begin = None
        self._marks = []

    def report(self) -> dict:
        """Cumulative per-phase seconds + shares and the coverage
        fraction (sum of attributed phase time / wall time of the
        profiled steps)."""
        attributed = sum(self.totals.values())
        phases = {
            p: {"seconds": round(s, 6),
                "share": (s / attributed) if attributed else 0.0}
            for p, s in self.totals.items() if s > 0.0}
        return {
            "steps": self.steps,
            "wall_s": round(self.wall_s, 6),
            "attributed_s": round(attributed, 6),
            "coverage": (attributed / self.wall_s) if self.wall_s
            else 0.0,
            "phases": phases,
        }

    def top_phases(self, n: int = 2) -> List[Tuple[str, float]]:
        """The n largest phases by share — the dashboard line's view."""
        attributed = sum(self.totals.values())
        if attributed <= 0.0:
            return []
        ranked = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return [(p, s / attributed) for p, s in ranked[:n] if s > 0.0]


# --------------------------------------------- cross-process aggregation
def dump_snapshot(path: str, registry=None, rank: Optional[int] = None,
                  extra: Optional[dict] = None) -> str:
    """Write this process's MetricsRegistry snapshot to `path` (tmp +
    os.replace so a reader never sees a torn file); `aggregate_snapshots`
    merges such files, the JAX package's included."""
    snap = (registry or _obs.get_registry()).snapshot()
    doc = {"rank": rank, "wall_time": time.time(), "snapshot": snap}
    if extra:
        doc.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _load_snapshot(source, fallback_rank: int) -> Tuple[dict, int]:
    if isinstance(source, str):
        with open(source) as f:
            source = json.load(f)
    rank = fallback_rank
    snap = source
    if isinstance(source, dict) and "snapshot" in source:
        if source.get("rank") is not None:
            rank = int(source["rank"])
        snap = source["snapshot"]
    return snap, rank


def _with_rank(label_str: str, rank: int) -> str:
    inner = f'rank="{rank}"'
    if not label_str:
        return "{" + inner + "}"
    return label_str[:-1] + "," + inner + "}"


def aggregate_snapshots(sources) -> dict:
    """Merge per-process snapshot dumps (paths, dump_snapshot docs, or
    raw snapshot dicts) into ONE snapshot: counters summed per (name,
    label set), histogram buckets/counts/sums merged (ring quantiles
    cannot merge exactly and are dropped), gauges re-keyed with a rank
    label so per-rank values stay distinguishable."""
    merged: dict = {"counters": {}, "gauges": {}, "histograms": {},
                    "ranks": 0, "uptime_s": 0.0}
    for i, source in enumerate(sources):
        snap, rank = _load_snapshot(source, i)
        for name, series in snap.get("counters", {}).items():
            tgt = merged["counters"].setdefault(name, {})
            for lab, v in series.items():
                tgt[lab] = tgt.get(lab, 0.0) + float(v)
        for name, series in snap.get("gauges", {}).items():
            tgt = merged["gauges"].setdefault(name, {})
            for lab, v in series.items():
                tgt[_with_rank(lab, rank)] = float(v)
        for name, h in snap.get("histograms", {}).items():
            tgt = merged["histograms"].setdefault(
                name, {"count": 0, "sum": 0.0, "buckets": {},
                       "p50": None, "p90": None, "p99": None})
            tgt["count"] += int(h.get("count", 0))
            tgt["sum"] = round(tgt["sum"] + float(h.get("sum", 0.0)), 9)
            for le, c in h.get("buckets", {}).items():
                tgt["buckets"][le] = tgt["buckets"].get(le, 0) + int(c)
        merged["ranks"] += 1
        merged["uptime_s"] = max(merged["uptime_s"],
                                 float(snap.get("uptime_s", 0.0)))
    return merged


def aggregate_prometheus_text(sources) -> str:
    """One Prometheus exposition from per-process snapshot files/dicts —
    `render_prometheus(aggregate_snapshots(...))`."""
    return render_prometheus(aggregate_snapshots(sources))


__all__ = [
    "PEAK_FLOPS", "PEAK_BYTES_PER_S", "PHASES",
    "CostModel", "StepPhaseProfiler",
    "device_peaks", "count_cost",
    "matmul_flops", "conv2d_flops", "train_step_flops_from_params",
    "dump_snapshot", "aggregate_snapshots", "aggregate_prometheus_text",
    "render_prometheus",
]
