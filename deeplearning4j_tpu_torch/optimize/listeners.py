"""Training listeners (counterpart of deeplearning4j_tpu/optimize/listeners.py;
parity: deeplearning4j-nn optimize/listeners/ —
ScoreIterationListener, PerformanceListener.java:21-70 samples/batches per
sec, EvaluativeListener w/ InvocationType, CollectScoresIterationListener,
ParamAndGradientIterationListener, TimeIterationListener,
SleepyTrainingListener, CheckpointListener role of earlystopping savers).

Contract: `iteration_done(model, iteration)` each step (each k-window
under TrainingMaster's `steps_per_dispatch=k`); optional
`on_epoch_start/on_epoch_end(model)` (nn/base_network.py's fit loop).
Params are read through the net's views of its train carry, so no
listener drops the flat carry.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


class ScoreIterationListener:
    """Log the loss every N iterations (ref: ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10, log=None):
        self.n = max(1, print_iterations)
        self.log = log or (lambda msg: logger.info(msg))

    def iteration_done(self, model, iteration: int):
        if iteration % self.n == 0:
            self.log(f"Score at iteration {iteration} is {model.score()}")


class PerformanceListener:
    """Throughput reporting (ref: PerformanceListener.java:21-70)."""

    def __init__(self, frequency: int = 10, report_samples: bool = True,
                 log=None):
        self.frequency = max(1, frequency)
        self.report_samples = report_samples
        self.log = log or (lambda msg: logger.info(msg))
        self._last_time = None
        self._last_iter = None
        self.samples_per_sec = None
        self.batches_per_sec = None

    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            n_batches = iteration - self._last_iter
            if dt > 0 and n_batches > 0:
                self.batches_per_sec = n_batches / dt
                msg = (f"iteration {iteration}: "
                       f"{self.batches_per_sec:.2f} batches/sec")
                batch = getattr(model, "_last_batch_size", None)
                if self.report_samples and batch:
                    self.samples_per_sec = self.batches_per_sec * batch
                    msg += f", {self.samples_per_sec:.1f} samples/sec"
                self.log(msg)
                self._last_time = now
                self._last_iter = iteration
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration


class InvocationType:
    ITERATION_END = "iteration_end"
    EPOCH_END = "epoch_end"
    EPOCH_START = "epoch_start"


class EvaluativeListener:
    """Run an evaluation on a held-out iterator during training
    (ref: EvaluativeListener.java w/ InvocationType)."""

    def __init__(self, iterator, frequency: int = 1,
                 invocation_type: str = InvocationType.EPOCH_END,
                 evaluation=None, callback: Optional[Callable] = None):
        from deeplearning4j_tpu_torch.eval import Evaluation

        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.invocation_type = invocation_type
        self._eval_factory = evaluation or (lambda: Evaluation())
        self.callback = callback
        self.evaluations: List = []
        self._count = 0

    def _evaluate(self, model):
        import numpy as np

        ev = self._eval_factory()
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for batch in self.iterator:
            x = batch.features if hasattr(batch, "features") else batch[0]
            y = batch.labels if hasattr(batch, "features") else batch[1]
            out = model.output(x)
            ev.eval(y, out.detach().float().cpu().numpy())
        self.evaluations.append(ev)
        if self.callback:
            self.callback(model, ev)
        else:
            logger.info("EvaluativeListener:\n%s", ev.stats())

    def _maybe(self, model, kind):
        if kind != self.invocation_type:
            return
        self._count += 1
        if self._count % self.frequency == 0:
            self._evaluate(model)

    def iteration_done(self, model, iteration: int):
        self._maybe(model, InvocationType.ITERATION_END)

    def on_epoch_start(self, model):
        self._maybe(model, InvocationType.EPOCH_START)

    def on_epoch_end(self, model):
        self._maybe(model, InvocationType.EPOCH_END)


class CollectScoresIterationListener:
    """Accumulate (iteration, score) pairs
    (ref: CollectScoresIterationListener.java).

    Deferred materialization: `model.score()` pays a device->host sync,
    so `scores` holds the *device scalar* (the net's `_score`, a 0-d
    tensor) and `get_scores()` / `export_scores()` pay the syncs once,
    at read time, off the hot path."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, Any]] = []

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0:
            raw = getattr(model, "_score", None)
            self.scores.append(
                (iteration, raw if raw is not None else model.score()))

    def get_scores(self) -> List[Tuple[int, Optional[float]]]:
        """Materialized [(iteration, float score), ...] — the device
        syncs happen here, not per training iteration."""
        return [(it, None if s is None else float(s))
                for it, s in self.scores]

    def export_scores(self, path, delimiter=","):
        with open(path, "w") as f:
            f.write(f"iteration{delimiter}score\n")
            for it, s in self.get_scores():
                f.write(f"{it}{delimiter}{s}\n")


class ParamAndGradientIterationListener:
    """Tab-separated per-iteration parameter/update statistics written
    to a file or the log (ref: ParamAndGradientIterationListener.java
    :30-102 — printMean/printMinMax/printMeanAbsValue knobs). The
    update statistics come from parameter deltas between calls (the
    reference reads Model.gradient(); here the compiled step has no
    exposed gradient, and delta = applied update)."""

    def __init__(self, iterations: int = 1, print_mean: bool = True,
                 print_min_max: bool = True,
                 print_mean_abs_value: bool = True,
                 output_file: Optional[str] = None, delimiter: str = "\t",
                 log=None):
        self.n = max(1, iterations)
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs_value
        self.path = output_file
        self.delim = delimiter
        self.log = log or (lambda msg: logger.info(msg))
        self._prev = None
        self._wrote_header = False

    def _stats(self, arr):
        import numpy as np

        out = []
        if self.print_mean:
            out.append(f"{float(np.mean(arr)):.6g}")
        if self.print_min_max:
            out.append(f"{float(np.min(arr)):.6g}")
            out.append(f"{float(np.max(arr)):.6g}")
        if self.print_mean_abs:
            out.append(f"{float(np.mean(np.abs(arr))):.6g}")
        return out

    def _emit(self, line: str):
        if self.path:
            # first emit truncates: a rerun must not append a second
            # header after a previous run's rows
            mode = "a" if self._wrote_header else "w"
            with open(self.path, mode) as f:
                f.write(line + "\n")
        else:
            self.log(line)

    def _n_stat_cols(self):
        return (int(self.print_mean) + 2 * int(self.print_min_max)
                + int(self.print_mean_abs))

    def iteration_done(self, model, iteration: int):
        import numpy as np

        from deeplearning4j_tpu_torch.util.tree import leaves

        prints = iteration % self.n == 0
        next_prints = (iteration + 1) % self.n == 0
        if not (prints or next_prints):
            # neither this row nor the next one needs these params:
            # skip the device->host transfer entirely
            self._prev = None
            return
        flat = np.concatenate(
            [a.detach().float().cpu().numpy().ravel()
             for a in leaves(model._params_view())])
        if prints:
            if not self._wrote_header:
                cols = ["iteration", "score"]
                names = []
                if self.print_mean:
                    names.append("mean")
                if self.print_min_max:
                    names += ["min", "max"]
                if self.print_mean_abs:
                    names.append("meanAbs")
                for group in ("param", "update"):
                    cols += [f"{group}_{n}" for n in names]
                self._emit(self.delim.join(cols))
                self._wrote_header = True
            vals = [str(iteration), f"{model.score():.6g}"]
            vals += self._stats(flat)
            if self._prev is not None:
                vals += self._stats(flat - self._prev)
            else:
                vals += ["-"] * self._n_stat_cols()
            self._emit(self.delim.join(vals))
        self._prev = flat if next_prints else None


class TimeIterationListener:
    """ETA logging (ref: TimeIterationListener.java)."""

    def __init__(self, total_iterations: int, frequency: int = 1, log=None):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.log = log or (lambda msg: logger.info(msg))
        self._start = time.time()

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency:
            return
        elapsed = time.time() - self._start
        if iteration > 0:
            remaining = elapsed / iteration * (self.total - iteration)
            self.log(f"iteration {iteration}/{self.total}, "
                     f"ETA {remaining:.0f}s")


class SleepyTrainingListener:
    """Inject pauses for debugging/throttling
    (ref: SleepyTrainingListener.java)."""

    def __init__(self, timer_iteration_ms: float = 0.0,
                 timer_epoch_ms: float = 0.0):
        self.timer_iteration_ms = timer_iteration_ms
        self.timer_epoch_ms = timer_epoch_ms

    def iteration_done(self, model, iteration: int):
        if self.timer_iteration_ms:
            time.sleep(self.timer_iteration_ms / 1e3)

    def on_epoch_end(self, model):
        if self.timer_epoch_ms:
            time.sleep(self.timer_epoch_ms / 1e3)


class CheckpointListener:
    """Periodic model checkpoints (the reference exposes this via early-
    stopping savers and the later CheckpointListener)."""

    def __init__(self, directory, every_n_iterations: int = 0,
                 every_n_epochs: int = 1, keep_last: int = 3):
        import os

        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = keep_last
        self._saved: List[str] = []

    def _save(self, model, tag):
        import os

        from deeplearning4j_tpu_torch.util.model_serializer import write_model

        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        write_model(model, path)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iteration_done(self, model, iteration: int):
        if self.every_n_iterations and iteration > 0 \
                and iteration % self.every_n_iterations == 0:
            self._save(model, f"iter{iteration}")

    def on_epoch_end(self, model):
        if self.every_n_epochs and model.epoch % self.every_n_epochs == 0:
            self._save(model, f"epoch{model.epoch}")


class ProfilerListener:
    """Capture a `torch.profiler` trace (host ops and, on a card, CUDA
    kernels) for iterations [start_iteration, start_iteration +
    num_iterations) — the op-level tracer (the reference delegates to
    the ND4J profiler). The trace is written as Chrome trace JSON to
    `log_dir/trace.json` (Perfetto / chrome://tracing loadable).

    `stop()` is idempotent and safe from overlapping paths — an
    epoch-end flush racing an abort/`__del__` teardown must not stop
    the profiler twice. `trace_dir` surfaces through
    `TrainingMaster.training_stats()["profiler"]`.

    Pass `tracer=` (observability.Tracer) to register the device-trace
    window on the shared host-span timeline: the exported Chrome trace
    then carries a "torch_device_trace" span whose args point at the
    trace directory, so host spans and the device profile correlate (the
    profiler keeps its own clock; the two are not merged)."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 num_iterations: int = 5, log=None, tracer=None):
        self.log_dir = log_dir
        self.start = start_iteration
        self.stop_at = start_iteration + num_iterations
        self.log = log or (lambda msg: logger.info(msg))
        self.tracer = tracer
        self._active = False
        self._done = False
        self._span = None
        self._prof = None
        self.trace_dir = None

    def stop(self):
        """Finish an active trace. Idempotent: overlapping epoch-end /
        abort / __del__ paths may all call it; only the first stops the
        profiler and writes the trace."""
        if not self._active:
            return
        self._active = False   # flip FIRST: re-entry becomes a no-op
        self._done = True
        prof, self._prof = self._prof, None
        try:
            import os

            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(self.log_dir, "trace.json"))
        except Exception:   # noqa: BLE001 - a torn profiler session
            logger.exception("ProfilerListener: stopping the trace failed")
        self.trace_dir = self.log_dir
        if self._span is not None:
            try:
                self._span.end(trace_dir=self.log_dir)
            except Exception:   # noqa: BLE001 - telemetry best-effort
                pass
            self._span = None
        self.log(f"profiler trace written to {self.log_dir}")

    def _start(self, model):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        dev = getattr(model, "device", None)
        if dev is not None and dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._active = True
        if self.tracer is not None:
            try:
                self._span = self.tracer.begin(
                    "torch_device_trace", cat="device",
                    args={"log_dir": self.log_dir})
            except Exception:   # noqa: BLE001 - telemetry best-effort
                self._span = None

    def iteration_done(self, model, iteration: int):
        if not self._active and not self._done and iteration >= self.start:
            # >=, not ==: the counter can jump by k (k-step windows)
            self._start(model)
        elif self._active and iteration >= self.stop_at:
            # force pending device work into the traced window
            if model.score() is not None:
                # analyze: allow=jit-host-sync — deliberate trace flush
                float(model.score())
            self.stop()

    def on_epoch_end(self, model):
        """Epoch-end flush: a trace still open when the epoch (or an
        aborted fit calling the epoch-end hooks) finishes is closed
        here instead of leaking into teardown."""
        if self._active:
            if model is not None and model.score() is not None:
                # analyze: allow=jit-host-sync — deliberate trace flush
                float(model.score())
            self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:   # noqa: BLE001 - interpreter teardown
            pass
