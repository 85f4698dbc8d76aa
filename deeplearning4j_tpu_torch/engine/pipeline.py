"""Harness-owned input pipeline: overlap data wait + host-to-device copies
with compute (counterpart of deeplearning4j_tpu/engine/pipeline.py).

Two shapes, one per fit-loop style:

  StepPrefetcher     for `batch_fn(step)`-driven loops: a background
                     producer runs fetch (and staging) for sequential
                     step indices ahead of the consumer; `get(step)`
                     returns the staged batch for exactly that step, a
                     fetch error is raised at the step whose fetch
                     failed, and a rollback that rewinds the step index
                     reseeks the producer (staged lookahead for
                     condemned windows is DISCARDED, never replayed).
  IteratorPipeline   for iterator-driven loops (EarlyStoppingTrainer):
                     AsyncDataSetIterator -> DevicePrefetchIterator — a
                     daemon thread keeps the host-side queue full while
                     the device stage sends the next batches to the card
                     on a side CUDA stream (datasets/iterators.py). The
                     thread also does the host half of staging (dtype
                     conversion, the copy into pinned memory), so the
                     consumer only issues the copy to the card.
                     `host_only=True` keeps the ETL overlap but skips
                     device staging (multi-input graphs, buffered
                     batches restack on the host).

Every yielded batch is freshly staged (one copy per yield, even when the
base iterator hands out the same host object repeatedly), consumed
entries leave the buffer, and reseeks drop staged entries instead of
re-yielding them.

Telemetry: `dl4j_pipeline_*` metrics through the failure-proof module
helpers (observability/metrics.py) — consumer-visible wait per batch,
batches through, reseeks, and the configured depth; `facts()` feeds the
harness's `pipeline_stats()`.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator,
    DataSetIterator,
    DevicePrefetchIterator,
    host_stage,
)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.observability import metrics as _obs


class _Skipped:
    """Producer-side marker: this step's batch was consumed by the
    skip_bad_batches policy (the fetch itself already counted it)."""

    __slots__ = ()

    def __repr__(self):   # pragma: no cover - debugging aid
        return "<SKIPPED>"


SKIPPED = _Skipped()


def stack_staged(parts):
    """Stack k already-staged (device-resident) tensors into one [k, ...]
    device tensor — the device-side k-window stack that feeds
    StepProgram.run_group without a host `np.stack` copy."""
    import torch

    return torch.stack([torch.as_tensor(p) for p in parts])


class StepPrefetcher:
    """Step-indexed prefetch + stage pipeline for batch_fn fit loops.

    `fetch(step)` runs on the producer thread and must do ALL
    producer-side work for one step: the `data.next` fault point,
    `data_retry`, `skip_bad_batches` (return SKIPPED when the policy
    consumed a failure), chaos poisoning, and the h2d staging itself —
    so h2d for step k+1 overlaps compute on step k. Fetch errors are
    carried to the consumer and raised at `get(step)` for the step
    whose fetch failed. `skip(step)` (live predicate, e.g. the
    poisoned-steps set) suppresses fetching condemned steps on replay.
    Staged lookahead that a reseek discards is never re-yielded.

    NOT thread-safe on the consumer side — one owner loop, like the
    StepHarness that builds it."""

    def __init__(self, fetch: Callable[[int], object], *,
                 start: int = 0, stop: Optional[int] = None,
                 depth: int = 2,
                 skip: Optional[Callable[[int], bool]] = None):
        self.fetch = fetch
        self.depth = max(1, int(depth))
        self.stop = stop
        self.skip = skip
        self.counters = {"batches": 0, "reseeks": 0, "wait_s": 0.0,
                         "errors": 0}
        self._gen = 0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        _obs.set_gauge("dl4j_pipeline_depth", self.depth)
        self._start(start)

    # ------------------------------------------------------- producer
    def _start(self, start: int) -> None:
        self._gen += 1
        gen = self._gen
        q = queue.Queue(maxsize=self.depth)
        self._q = q
        fetch, skip, stop = self.fetch, self.skip, self.stop

        def put(item) -> bool:
            while self._gen == gen:
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False   # superseded by a reseek/close

        def producer():
            s = start
            while self._gen == gen and (stop is None or s < stop):
                if skip is not None and skip(s):
                    s += 1   # condemned step: never refetched on replay
                    continue
                try:
                    payload = fetch(s)
                except BaseException as e:  # noqa: BLE001 - carried to
                    put((s, "error", e))    # the consumer's get(step)
                    return
                kind = "skip" if payload is None \
                    or payload is SKIPPED else "batch"
                if not put((s, kind, payload)):
                    return
                s += 1

        self._thread = threading.Thread(
            target=producer, daemon=True,
            name="StepPrefetcher-producer")
        self._thread.start()

    # ------------------------------------------------------- consumer
    def seek(self, step: int) -> None:
        """Restart the producer at `step` (rollback replay): staged
        lookahead is discarded, never re-yielded, and condemned steps
        are filtered by the live `skip` predicate."""
        self.counters["reseeks"] += 1
        _obs.count("dl4j_pipeline_reseeks_total")
        self._start(step)

    def get(self, step: int):
        """The staged batch for exactly `step`: SKIPPED when the
        producer's skip_bad_batches policy consumed the fetch failure;
        raises the producer's error for the step whose fetch failed.
        Stale entries (steps the consumer skipped) are discarded; an
        entry beyond `step` (the consumer rolled back) reseeks, and so
        does a producer that ran to its stop before the consumer went
        back (a replay of the run's last window)."""
        if self._closed:
            raise RuntimeError("StepPrefetcher is closed")
        if self._thread is None:
            self._start(step)   # restart after a consumed fetch error
        t0 = time.perf_counter()
        restarted = False
        while True:
            q, gen = self._q, self._gen
            try:
                s, kind, payload = q.get(timeout=0.1)
            except queue.Empty:
                if self._gen != gen:
                    continue   # reseek swapped the queue under us
                t = self._thread
                if t is None or not t.is_alive():
                    if restarted:
                        raise RuntimeError(
                            "StepPrefetcher producer exited without "
                            f"yielding step {step}")
                    restarted = True
                    self.seek(step)
                continue
            if self._gen != gen:
                continue       # stale generation: entry already void
            if s < step:
                continue       # consumer skipped ahead: discard
            if s > step:
                self.seek(step)
                continue
            dt = time.perf_counter() - t0
            self.counters["wait_s"] += dt
            _obs.observe("dl4j_pipeline_wait_seconds", dt)
            if kind == "error":
                self.counters["errors"] += 1
                # the producer exited after carrying the error; a later
                # get() (a caller that survives the raise) restarts it
                self._thread = None
                raise payload
            self.counters["batches"] += 1
            _obs.count("dl4j_pipeline_batches_total")
            return None if kind == "skip" else payload

    # ------------------------------------------------------- lifecycle
    def close(self, timeout_s: float = 5.0) -> None:
        """Stop and JOIN the producer (idempotent) — the harness
        session teardown calls this like any attached data source, so a
        fit that raises cannot leak the producer thread."""
        self._closed = True
        self._gen += 1           # stale producer self-terminates
        q = self._q
        if q is not None:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout_s)
        self._thread = None

    def __enter__(self) -> "StepPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def facts(self) -> dict:
        return {"kind": "step", "depth": self.depth,
                "batches": self.counters["batches"],
                "reseeks": self.counters["reseeks"],
                "errors": self.counters["errors"],
                "wait_s": round(self.counters["wait_s"], 6)}


class IteratorPipeline(DataSetIterator):
    """AsyncDataSetIterator -> DevicePrefetchIterator composition for
    iterator-driven fit loops, with close() propagation and pipeline
    telemetry.

    `stage(batch) -> batch` runs the entry point's own host-side mapping
    inside the prefetch; the device stage then sends the batch to
    `device` in `dtype` (floating arrays), so the consumer loop receives
    batches already on the card — the same values, and so the same
    training bits, as the synchronous path. `stage` and the host half of
    the device stage (`host_stage`) run on the producer thread; a source
    that is already an AsyncDataSetIterator is not wrapped again, and
    then the consumer does that half.

    `host_only=True` keeps the ETL overlap but skips device staging: the
    consumer receives the host batches (through `stage`), for paths that
    restack or route them on the host (ParallelWrapper's multi-input
    graphs, EarlyStoppingParallelTrainer's buffered batches)."""

    def __init__(self, source, *, depth: int = 2, queue_size: int = 4,
                 stage=None, device=None, dtype=torch.float32,
                 host_only: bool = False):
        self.source = source
        self.depth = max(1, int(depth))
        self.host_only = bool(host_only)
        device = resolve_device(device)
        if isinstance(source, AsyncDataSetIterator):
            self._async = source     # never double-wrap a producer
        else:
            prepare = stage if self.host_only else functools.partial(
                host_stage, transform=stage, device=device, dtype=dtype)
            self._async = AsyncDataSetIterator(
                source, queue_size=max(queue_size, self.depth),
                prepare=prepare)
        if self.host_only:
            self._it = self._async
        else:
            self._it = DevicePrefetchIterator(
                self._async, buffer_size=self.depth, transform=stage,
                device=device, dtype=dtype)
        self.counters = {"batches": 0, "wait_s": 0.0}
        _obs.set_gauge("dl4j_pipeline_depth", self.depth)

    def reset(self):
        self._it.reset()

    def __iter__(self):
        self._it.__iter__()
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self._it)
        dt = time.perf_counter() - t0
        self.counters["batches"] += 1
        self.counters["wait_s"] += dt
        _obs.count("dl4j_pipeline_batches_total")
        _obs.observe("dl4j_pipeline_wait_seconds", dt)
        return item

    def close(self, timeout_s: float = 5.0) -> None:
        """Close the whole chain: the device stage drops its staged
        buffer (never re-yielded) and the async producer is joined."""
        self._it.close(timeout_s=timeout_s)

    def __enter__(self) -> "IteratorPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def facts(self) -> dict:
        return {"kind": "iterator", "depth": self.depth,
                "host_only": self.host_only,
                "batches": self.counters["batches"],
                "wait_s": round(self.counters["wait_s"], 6)}


__all__ = ["SKIPPED", "StepPrefetcher", "IteratorPipeline",
           "stack_staged"]
