"""ParallelInference: batched inference serving (counterpart of
deeplearning4j_tpu/parallel/inference.py). `InferenceMode.SEQUENTIAL`
runs each request as one direct `net.output` under the lock, with host
numpy results; `InferenceMode.BATCHED` (the default) is the pipeline
below.

Concurrent small requests coalesce into one padded batch so the card runs
full tiles. Batch sizes are bucketed to powers of two, hard-capped at
next_pow2(batch_limit); a request that would overflow a batch is split
and its rows carried into the next one.

The data plane is a two-stage pipeline, as in the JAX package: the
ASSEMBLER stage coalesces requests into a pooled padded bucket buffer and
dispatches `net.output` (which enqueues the forward on the card and
returns); the COMPLETION stage copies the result to the host — the point
where the host waits for the device — and hands each caller its rows.
The in-flight window is bounded (`pipeline_depth`), so backpressure
cascades: window full -> assembler stalls -> bounded request queue fills
-> `output()` sheds load with OverloadedError.

Every wait carries a deadline (DeadlineExceededError), a dead pipeline
thread surfaces as InferenceUnavailableError, and `shutdown()` fails
queued, in-flight and carried requests fast with ShutdownError. The
fault points `inference.batch` and `inference.complete` kill either
stage, as in the JAX package.

Shapes: each request's per-example input shapes are checked against the
net's (from `warmup_inputs`, a graph's input types or a layer list's
`input_type`) before the request is queued, and a mismatch raises
ValueError on the caller's thread — the HTTP server's 400 — instead of
failing inside the batch. `trace_stats()` reads the net's `_jit_cache`
(a trace is the predict program's first call with an input signature),
so "zero new traces after warmup" is the same pin as in the JAX package.

Telemetry, at the JAX package's sites: `dl4j_serving_batches_total` and
the `dl4j_serving_batch_occupancy` histogram per dispatched batch,
`dl4j_serving_bucket_splits_total` per split request,
`dl4j_serving_queue_depth` and `dl4j_serving_inflight_batches` gauges. A
`tracer` (observability.Tracer) records a "request" span per call, an
"assemble_dispatch" span per batch parented to its first request's span
(caller thread -> batcher thread) and a "complete_deliver" span parented
to that (batcher -> completion thread).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.observability.metrics import COUNT_BUCKETS
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError,
    InferenceUnavailableError,
    OverloadedError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire


class InferenceMode:
    SEQUENTIAL = "sequential"
    BATCHED = "batched"


_PRIORITY_IDX = {"high": 0, "normal": 1, "low": 2}


def _to_host(o) -> np.ndarray:
    if isinstance(o, torch.Tensor):
        # analyze: allow=jit-host-sync — the completion stage: where the host waits for the device
        return o.detach().cpu().numpy()
    return np.asarray(o)


class _RequestQueue(queue.Queue):
    """Bounded request queue with priority-class ordering (high before
    normal before low, FIFO within a class), built on queue.Queue's
    `_init/_qsize/_put/_get` extension points."""

    def _init(self, maxsize: int) -> None:
        self._by_class = tuple(deque() for _ in range(3))

    def _qsize(self) -> int:
        return sum(len(d) for d in self._by_class)

    def _put(self, item) -> None:
        self._by_class[getattr(item, "priority_idx", 1)].append(item)

    def _get(self):
        for d in self._by_class:
            if d:
                return d.popleft()
        raise queue.Empty   # unreachable: guarded by queue.Queue's CV


class _Pending:
    """One caller's request: equal-row input arrays, delivered possibly
    across several batches (row ranges never overlap, so no lock)."""

    __slots__ = ("xs", "event", "result", "_left", "_out", "span",
                 "priority_idx")

    def __init__(self, xs, priority_idx: int = 1):
        self.xs = xs
        self.event = threading.Event()
        self.result = None
        self._left = xs[0].shape[0]
        self._out = None
        self.span = None   # open request span (tracer attached only)
        self.priority_idx = priority_idx

    @property
    def rows(self) -> int:
        return self.xs[0].shape[0]

    def resolve(self, result):
        if not self.event.is_set():
            self.result = result
            self.event.set()
            if self.span is not None:
                try:
                    self.span.end(
                        error=type(result).__name__
                        if isinstance(result, Exception) else None)
                except Exception:   # noqa: BLE001 - telemetry best-effort
                    pass

    def deliver(self, start: int, rows_list: List[np.ndarray],
                multi: bool) -> bool:
        """Hand this request rows [start, start+n) of every output.
        Returns True when the delivery completed the request."""
        if self.event.is_set():
            return False
        n = self.xs[0].shape[0]
        got = rows_list[0].shape[0]
        if self._out is None and start == 0 and got == n:
            self.resolve(list(rows_list) if multi else rows_list[0])
            return True
        if self._out is None:
            self._out = [np.empty((n,) + r.shape[1:], r.dtype)
                         for r in rows_list]
        for out, r in zip(self._out, rows_list):
            out[start:start + got] = r
        self._left -= got
        if self._left <= 0:
            self.resolve(self._out if multi else self._out[0])
            return True
        return False


_Slot = Tuple[_Pending, int, int]   # (request, src_row_start, n_rows)


class ParallelInference:
    """Thread-safe inference front-end over a network with
    `output(*xs)`. `default_timeout_s` bounds every `output()` call."""

    def __init__(self, net, inference_mode: str = InferenceMode.BATCHED,
                 batch_limit: int = 32, queue_limit: int = 64,
                 max_wait_ms: float = 2.0,
                 default_timeout_s: float = 30.0,
                 pipeline_depth: int = 2,
                 warmup: bool = True,
                 adaptive_wait: bool = True,
                 min_wait_ms: float = 0.0,
                 warmup_inputs=None,
                 completion_streams: int = 2,
                 tracer=None):
        """`warmup_inputs`: per-example input shapes for nets whose
        shape is underivable from the conf — one entry per network
        input, each a shape tuple (no batch dim) or an example array
        whose leading dim is the batch.

        `tracer` (observability.Tracer, optional): per-request and
        per-batch spans on both pipeline stages, parented across the
        threads (module docstring); None costs the hot path nothing."""
        if inference_mode not in (InferenceMode.SEQUENTIAL,
                                  InferenceMode.BATCHED):
            raise ValueError(f"inference_mode must be "
                             f"'sequential' or 'batched': {inference_mode!r}")
        self.net = net
        self.tracer = tracer
        self.warmup_inputs = warmup_inputs
        self.mode = inference_mode
        self.batch_limit = batch_limit
        self.max_wait_ms = max_wait_ms
        self.min_wait_ms = min_wait_ms
        self.adaptive_wait = adaptive_wait
        self.default_timeout_s = default_timeout_s
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.completion_streams = max(1, int(completion_streams))
        self._cap = self._bucket(batch_limit)
        self._queue: "queue.Queue[_Pending]" = _RequestQueue(
            maxsize=queue_limit)
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self._shutdown = False
        self._failure: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._completers: List[threading.Thread] = []
        self._inflight: Optional["queue.Queue"] = None
        # dispatched-but-not-completed batches, including the one being
        # fetched; _slot_free wakes the assembler when one completes
        self._inflight_n = 0
        self._slot_free = threading.Event()
        self._carry: Optional[Tuple[_Pending, int]] = None
        self._buf_pool: Dict[tuple, List[np.ndarray]] = {}
        self._wait_ms = float(max_wait_ms)
        self._warmed_buckets: List[int] = []
        self._batches_dispatched = 0
        self._requests_completed = 0
        self._bucket_fill: Dict[int, List[int]] = {}
        self._input_spec = self._derive_input_spec()
        if self.mode == InferenceMode.BATCHED:
            if warmup:
                self.warmup()
            if self.pipeline_depth > 0:
                self._inflight = queue.Queue()
                for i in range(self.completion_streams):
                    t = threading.Thread(
                        target=self._completion_loop, daemon=True,
                        name=f"ParallelInference-completer-{i}")
                    t.start()
                    self._completers.append(t)
                self._completer = self._completers[0]
            self._worker = threading.Thread(
                target=self._batch_loop, daemon=True,
                name="ParallelInference-batcher")
            self._worker.start()

    # ------------------------------------------------------------------
    @property
    def healthy(self) -> bool:
        """False once shut down or either pipeline thread has died."""
        if self._shutdown or self._failure is not None:
            return False
        if self.mode == InferenceMode.SEQUENTIAL:
            return True
        if self._worker is None or not self._worker.is_alive():
            return False
        return all(t.is_alive() for t in self._completers)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    @property
    def queue_limit(self) -> int:
        return self._queue.maxsize

    def trace_stats(self) -> dict:
        """The net's JitCache trace counters (empty for nets without
        one) plus the compile-event ring, so /status can answer "what
        was built, and why"."""
        cache = getattr(self.net, "_jit_cache", None)
        if cache is None or not hasattr(cache, "trace_counts"):
            return {}
        out = {"trace_counts": cache.trace_counts(),
               "total_traces": cache.total_traces()}
        if hasattr(cache, "compile_events"):
            out["compiles_total"] = cache.compiles_total()
            out["compile_events"] = cache.compile_events()
        return out

    def lint_records(self) -> list:
        """ProgramRecords (analysis/program_lint.py) of the serving data
        plane: the net's cached predict program at the largest warmed
        bucket (with its registered precision policy), called as
        `net.output` calls it (inference mode, the compute-dtype params),
        plus one fill-ratio record per dispatched bucket."""
        from deeplearning4j_tpu_torch.analysis.program_lint import (
            ProgramRecord,
        )

        source = "deeplearning4j_tpu_torch/parallel/inference.py"
        records = []
        net = self.net
        cache = getattr(net, "_jit_cache", None)
        shapes = self._warmup_shapes()
        if cache is not None and "predict" in cache and shapes:
            b = max(self._warmed_buckets or [self._cap])
            xs = [torch.zeros((b,) + tuple(sh), dtype=net.dtype,
                              device=net.device) for sh in shapes]
            names = getattr(net.conf, "network_inputs", None)
            inputs = dict(zip(names, xs)) if names else xs[0]
            predict = cache["predict"]

            def serving_predict(params, states, inputs):
                with torch.inference_mode():
                    return predict(params, states, inputs)

            records.append(ProgramRecord(
                name="serving_predict", fn=serving_predict,
                example_args=(net._compute_params(), net.states, inputs),
                precision_policy=cache.policy("predict"), source=source))
        for b, agg in self.bucket_fill().items():
            records.append(ProgramRecord(
                name=f"serving_bucket_{b}", source=source,
                bucket_capacity=b,
                bucket_rows_per_dispatch=(
                    agg["rows"] / agg["dispatches"]
                    if agg["dispatches"] else 0.0)))
        return records

    def bucket_fill(self) -> Dict[int, dict]:
        """{bucket: {dispatches, rows, fill}}; the pow2 coalescer keeps
        fill > 0.5 per dispatch."""
        return {b: {"dispatches": d, "rows": r,
                    "fill": (r / (d * b)) if d else 0.0}
                for b, (d, r) in sorted(self._bucket_fill.items())}

    def stats(self) -> dict:
        return {
            "pipeline_depth": self.pipeline_depth,
            "completion_streams": (self.completion_streams
                                   if self.pipeline_depth > 0 else 0),
            "in_flight": self._inflight_n,
            "queue_depth": self._queue.qsize(),
            "batches_dispatched": self._batches_dispatched,
            "requests_completed": self._requests_completed,
            "bucket_cap": self._cap,
            "warmed_buckets": list(self._warmed_buckets),
            "bucket_fill": self.bucket_fill(),
            "current_wait_ms": round(self._wait_ms, 4),
            "adaptive_wait": self.adaptive_wait,
            **self.trace_stats(),
        }

    # ------------------------------------------------------------ warmup
    def _input_types(self) -> Optional[list]:
        """The net's InputType per network input: a graph's input types,
        else a layer list's `input_type` (None when it has neither)."""
        conf = getattr(self.net, "conf", None)
        names = getattr(conf, "network_inputs", None)
        itypes = getattr(conf, "input_types", None)
        if names and itypes and set(itypes) >= set(names):
            return [itypes[n] for n in names]
        input_type = getattr(conf, "input_type", None)
        return None if input_type is None else [input_type]

    def _warmup_shapes(self) -> Optional[List[tuple]]:
        """Per-example shape of every network input: explicit
        `warmup_inputs` first, then the net's input types; None when
        underivable either way."""
        if self.warmup_inputs is not None:
            shapes = []
            for w in self.warmup_inputs:
                if isinstance(w, (tuple, list)) and all(
                        isinstance(d, (int, np.integer)) for d in w):
                    shapes.append(tuple(int(d) for d in w))
                else:
                    shapes.append(tuple(np.asarray(w).shape[1:]))
            return shapes
        itypes = self._input_types()
        if itypes is None:
            return None
        return [tuple(t.batch_shape(1))[1:] for t in itypes]

    def _derive_input_spec(self) -> Optional[List[tuple]]:
        """The per-example shapes a request must carry, None in a dim
        any size may take (the time axis of a recurrent input of unset
        length); None when the shapes are underivable."""
        shapes = self._warmup_shapes()
        if shapes is None or self.warmup_inputs is not None:
            return shapes
        return [(None,) + s[1:]
                if getattr(t, "timeseries_length", 0) is None else s
                for s, t in zip(shapes, self._input_types())]

    def _check_shapes(self, xs) -> None:
        spec = self._input_spec
        if spec is None:
            return
        if len(xs) != len(spec):
            raise ValueError(
                f"model takes {len(spec)} input(s), the request carries "
                f"{len(xs)}")
        for i, (x, want) in enumerate(zip(xs, spec)):
            got = tuple(x.shape[1:])
            if len(got) != len(want) or any(
                    w is not None and g != w for g, w in zip(got, want)):
                raise ValueError(
                    f"input {i}: per-example shape {got} does not match "
                    f"the model's {want}")

    def warmup(self) -> List[int]:
        """Run `net.output` once for every power-of-two bucket up to the
        cap (first-call costs — kernel builds, cuDNN algorithm choice —
        are paid here, not by the first requests). Returns the buckets
        run; skipped when the input shape is underivable."""
        shapes = self._warmup_shapes()
        if shapes is None:
            return []
        done = []
        b = 1
        while b <= self._cap:
            xs = [np.zeros((b,) + s, np.float32) for s in shapes]
            with self._lock:
                out = self.net.output(*xs)
                for o in (out if isinstance(out, (list, tuple)) else [out]):
                    _to_host(o)
            done.append(b)
            b <<= 1
        self._warmed_buckets = done
        return done

    # ------------------------------------------------------------------
    def _check_available(self):
        if self._shutdown:
            raise ShutdownError("ParallelInference is shut down")
        if self._failure is not None:
            raise InferenceUnavailableError(
                f"batcher thread died: {self._failure!r}")
        if self.mode == InferenceMode.BATCHED and self._threads_dead():
            raise InferenceUnavailableError("batcher thread is not running")

    def _threads_dead(self) -> bool:
        if self._worker is None or not self._worker.is_alive():
            return True
        return (self._completer is not None
                and not self._completer.is_alive())

    def output(self, *xs, timeout_s: Optional[float] = None,
               priority: Optional[str] = None):
        """Run inference on one request (one array per network input,
        sharing the batch dim). Raises ValueError when a per-example
        shape differs from the model's, OverloadedError when the bounded
        queue is full, DeadlineExceededError past the deadline, and
        InferenceUnavailableError/ShutdownError instead of hanging."""
        xs = tuple(np.asarray(x) for x in xs)
        if not xs:
            raise ValueError("output() needs at least one input array")
        if any(x.shape[0] != xs[0].shape[0] for x in xs[1:]):
            raise ValueError(
                "all inputs must share the batch dim: "
                f"{[x.shape[0] for x in xs]}")
        self._check_shapes(xs)
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        if self.mode == InferenceMode.SEQUENTIAL:
            self._check_available()
            with self._lock:
                out = self.net.output(*xs)
                return ([_to_host(o) for o in out]
                        if isinstance(out, (list, tuple)) else _to_host(out))
        self._check_available()
        p = _Pending(xs, priority_idx=_PRIORITY_IDX.get(priority, 1))
        if self.tracer is not None:
            try:
                p.span = self.tracer.begin(
                    "request", cat="serving",
                    args={"rows": int(xs[0].shape[0])})
            except Exception:   # noqa: BLE001 - telemetry best-effort
                p.span = None
        try:
            self._queue.put_nowait(p)
        except queue.Full:
            if p.span is not None:
                p.span.end(error="OverloadedError")
            raise OverloadedError(
                f"inference queue full ({self._queue.maxsize} waiting); "
                "retry later") from None
        deadline = time.monotonic() + timeout_s
        while not p.event.wait(timeout=min(
                0.05, max(0.0, deadline - time.monotonic()))):
            if p.event.is_set():
                break
            if (self._failure is not None or self._shutdown
                    or self._threads_dead()):
                self._drain(self._unavailable_error())
                if not p.event.is_set():
                    p.resolve(self._unavailable_error())
            elif time.monotonic() >= deadline:
                raise DeadlineExceededError(
                    f"inference did not complete within {timeout_s}s")
        if isinstance(p.result, Exception):
            raise p.result
        return p.result

    def _unavailable_error(self) -> Exception:
        if self._shutdown and self._failure is None:
            return ShutdownError(
                "ParallelInference shut down with requests in flight")
        return InferenceUnavailableError(
            f"batcher thread died: {self._failure!r}")

    def shutdown(self):
        """Fail fast: stop both stages, then signal every queued /
        in-flight request with ShutdownError."""
        self._shutdown = True
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
        for t in self._completers:
            t.join(timeout=2.0)
        err = ShutdownError(
            "ParallelInference shut down with requests in flight")
        self._drain(err)
        self._drain_inflight(err)

    def _drain(self, error: Exception):
        carry = self._carry
        self._carry = None
        if carry is not None and not carry[0].event.is_set():
            carry[0].resolve(error)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if not p.event.is_set():
                p.resolve(error)

    def _drain_inflight(self, error: Exception):
        if self._inflight is None:
            return
        while True:
            try:
                _, slots, keys, bufs, _ = self._inflight.get_nowait()
            except queue.Empty:
                return
            with self._count_lock:
                self._inflight_n -= 1
            for p, _, _ in slots:
                p.resolve(error)
            self._put_buffers(keys, bufs)

    # ------------------------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _get_buffer(self, key: tuple) -> np.ndarray:
        pool = self._buf_pool.get(key)
        if pool:
            return pool.pop()
        bucket, tail, dtype_str = key
        return np.zeros((bucket,) + tail, np.dtype(dtype_str))

    def _put_buffer(self, key: tuple, buf: np.ndarray):
        pool = self._buf_pool.setdefault(key, [])
        if len(pool) <= self.pipeline_depth:
            pool.append(buf)

    def _put_buffers(self, keys: List[tuple], bufs: List[np.ndarray]):
        for key, buf in zip(keys, bufs):
            self._put_buffer(key, buf)

    def _current_wait_s(self) -> float:
        if not self.adaptive_wait:
            return self.max_wait_ms / 1000.0
        if self._queue.qsize() >= self.batch_limit:
            return 0.0   # a full batch is already waiting
        return self._wait_ms / 1000.0

    def _adapt_wait(self, rows: int):
        if not self.adaptive_wait:
            return
        if rows >= self.batch_limit:
            self._wait_ms = max(self.min_wait_ms, self._wait_ms * 0.5)
        elif self._queue.qsize() == 0:
            self._wait_ms = min(self.max_wait_ms,
                                self._wait_ms * 1.5 + 0.05)

    # ------------------------------------------------------- assembler
    def _collect(self) -> Tuple[List[_Slot], int]:
        """Gather up to batch_limit rows: the carried remainder of a
        split request first, then queued requests."""
        slots: List[_Slot] = []
        rows = 0
        limit = self.batch_limit
        if self._carry is not None:
            p, src = self._carry
            self._carry = None
            take = min(p.rows - src, limit)
            slots.append((p, src, take))
            rows += take
            if src + take < p.rows:
                self._carry = (p, src + take)
                return slots, rows
        else:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                return slots, 0
            take = min(first.rows, limit)
            slots.append((first, 0, take))
            rows += take
            if take < first.rows:
                self._carry = (first, take)
                _obs.count("dl4j_serving_bucket_splits_total")
                return slots, rows
        wait_s = self._current_wait_s()
        t0 = time.monotonic()
        while rows < limit:
            window_full = (self._inflight is not None
                           and self._inflight_n >= self.pipeline_depth)
            if window_full:
                try:
                    p = self._queue.get_nowait()
                except queue.Empty:
                    if self._stop.is_set() or self._failure is not None:
                        break
                    self._slot_free.clear()
                    if self._inflight_n >= self.pipeline_depth:
                        self._slot_free.wait(timeout=0.05)
                    continue
            else:
                remaining = wait_s - (time.monotonic() - t0)
                if remaining <= 0 and self._queue.empty():
                    break
                try:
                    p = self._queue.get(timeout=max(0.0, remaining))
                except queue.Empty:
                    break
            take = min(p.rows, limit - rows)
            slots.append((p, 0, take))
            rows += take
            if take < p.rows:
                self._carry = (p, take)
                _obs.count("dl4j_serving_bucket_splits_total")
                break
        return slots, rows

    def _assemble(self, slots: List[_Slot], rows: int):
        """Coalesce request rows into pooled padded bucket buffers, one
        per network input."""
        n_inputs = len(slots[0][0].xs)
        if any(len(p.xs) != n_inputs for p, _, _ in slots):
            raise ValueError(
                "mixed input arity in one batch: all requests to a "
                f"model must carry {n_inputs} input(s)")
        bucket = self._bucket(rows)
        keys: List[tuple] = []
        bufs: List[np.ndarray] = []
        for i in range(n_inputs):
            x0 = slots[0][0].xs[i]
            dtype = np.result_type(*[p.xs[i].dtype for p, _, _ in slots]) \
                if len(slots) > 1 else x0.dtype
            key = (bucket, x0.shape[1:], np.dtype(dtype).str)
            buf = self._get_buffer(key)
            ofs = 0
            for p, src, n in slots:
                buf[ofs:ofs + n] = p.xs[i][src:src + n]
                ofs += n
            if bucket > rows:
                buf[rows:bucket] = 0   # pooled buffers carry stale rows
            keys.append(key)
            bufs.append(buf)
        return keys, bufs

    def _batch_loop(self):
        try:
            while not self._stop.is_set() and self._failure is None:
                _fire("inference.batch")   # chaos: kills the assembler
                slots, rows = self._collect()
                if not slots:
                    continue
                # assembler-stage span: explicitly parented to the FIRST
                # request's span — the request started on a caller
                # thread, this stage runs on the batcher thread
                dspan = None
                if self.tracer is not None:
                    try:
                        dspan = self.tracer.begin(
                            "assemble_dispatch", cat="serving",
                            parent=slots[0][0].span,
                            args={"rows": rows, "slots": len(slots)})
                    except Exception:   # noqa: BLE001 - telemetry
                        dspan = None
                try:
                    keys, bufs = self._assemble(slots, rows)
                except Exception as e:   # per-batch: propagate to callers
                    for p, _, _ in slots:
                        p.resolve(e)
                    if dspan is not None:
                        dspan.end(error=type(e).__name__)
                    continue
                try:
                    with self._lock:
                        # enqueues the forward on the card and returns;
                        # the completion stage waits for it
                        out = self.net.output(*bufs)
                except Exception as e:   # per-batch: propagate to callers
                    for p, _, _ in slots:
                        p.resolve(e)
                    self._put_buffers(keys, bufs)
                    if dspan is not None:
                        dspan.end(error=type(e).__name__)
                    continue
                self._batches_dispatched += 1
                agg = self._bucket_fill.setdefault(keys[0][0], [0, 0])
                agg[0] += 1
                agg[1] += rows
                _obs.count_observe(
                    "dl4j_serving_batches_total",
                    "dl4j_serving_batch_occupancy", rows,
                    buckets=COUNT_BUCKETS)
                _obs.set_gauge("dl4j_serving_queue_depth",
                               self._queue.qsize())
                if dspan is not None:
                    dspan.end()
                self._adapt_wait(rows)
                if self._completer is None:
                    self._complete_batch(out, slots, keys, bufs, dspan)
                else:
                    self._submit_inflight((out, slots, keys, bufs, dspan))
        except BaseException as e:   # noqa: BLE001 - loop-level death
            self._failure = e
        finally:
            if self._failure is not None:
                self._drain(self._unavailable_error())
            elif self._stop.is_set():
                self._drain(ShutdownError(
                    "ParallelInference shut down with requests in flight"))

    def _submit_inflight(self, item):
        """Bounded in-flight window: block until the completion stage
        frees a slot, never past stop/death."""
        while True:
            if self._stop.is_set() or self._failure is not None or any(
                    not t.is_alive() for t in self._completers):
                _, slots, keys, bufs, _ = item
                err = self._unavailable_error() \
                    if not self._stop.is_set() else ShutdownError(
                        "ParallelInference shut down with requests "
                        "in flight")
                for p, _, _ in slots:
                    p.resolve(err)
                self._put_buffers(keys, bufs)
                return
            if self._inflight_n >= self.pipeline_depth:
                self._slot_free.clear()
                if self._inflight_n >= self.pipeline_depth:
                    self._slot_free.wait(timeout=0.05)
                continue
            with self._count_lock:
                self._inflight_n += 1
            _obs.set_gauge("dl4j_serving_inflight_batches",
                           self._inflight_n)
            self._inflight.put(item)
            return

    # ------------------------------------------------------- completion
    def _complete_batch(self, out, slots: List[_Slot], keys, bufs,
                        dspan=None):
        # completion-stage span: parented to the assembler's dispatch
        # span — a cross-THREAD edge when the completer is running
        cspan = None
        if self.tracer is not None and dspan is not None:
            try:
                cspan = self.tracer.begin(
                    "complete_deliver", cat="serving", parent=dspan,
                    args={"slots": len(slots)})
            except Exception:   # noqa: BLE001 - telemetry best-effort
                cspan = None
        multi = isinstance(out, (list, tuple))
        outs = list(out) if multi else [out]
        try:
            hosts = [_to_host(o) for o in outs]   # waits for the device
        except Exception as e:   # per-batch: propagate to callers
            for p, _, _ in slots:
                p.resolve(e)
            self._put_buffers(keys, bufs)
            if cspan is not None:
                cspan.end(error=type(e).__name__)
            return
        for i, h in enumerate(hosts):
            if any(np.may_share_memory(h, b) for b in bufs):
                # never hand callers views into a pooled buffer
                hosts[i] = h.copy()
        self._put_buffers(keys, bufs)
        ofs = 0
        done = 0
        for p, src, n in slots:
            if p.deliver(src, [h[ofs:ofs + n] for h in hosts], multi):
                done += 1
            ofs += n
        if done:
            with self._count_lock:
                self._requests_completed += done
        if cspan is not None:
            cspan.end()

    def _completion_loop(self):
        try:
            while not self._stop.is_set() and self._failure is None:
                _fire("inference.complete")   # chaos: kills the completer
                try:
                    item = self._inflight.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    self._complete_batch(*item)
                finally:
                    with self._count_lock:
                        self._inflight_n -= 1
                    _obs.set_gauge("dl4j_serving_inflight_batches",
                                   self._inflight_n)
                    self._slot_free.set()
        except BaseException as e:   # noqa: BLE001 - loop-level death
            self._failure = e
        finally:
            if self._failure is not None:
                self._drain_inflight(self._unavailable_error())
                self._drain(self._unavailable_error())
            elif self._stop.is_set():
                self._drain_inflight(ShutdownError(
                    "ParallelInference shut down with requests in flight"))
