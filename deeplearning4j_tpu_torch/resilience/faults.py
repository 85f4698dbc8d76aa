"""Deterministic, seedable fault injection (a copy of
deeplearning4j_tpu/resilience/faults.py).

One process-global registry of *named fault points*. Code is
instrumented once (`fire("checkpoint.write", path=tmp)`); by default
every fire is a no-op costing one dict lookup. Tests and chaos runs arm
faults through the same mechanism — programmatically via `inject(...)`
or from the environment via `DL4J_TPU_FAULTS` — so the chaos config a
test exercises and the one an operator replays are the same string.

The registry keeps the JAX package's point names, so one chaos string
drives either package. The port fires, so far:

  checkpoint.write   util/model_serializer.write_model and
                     TrainingMaster's checkpoint save, fired with the
                     tmp file path *after* bytes are written but
                     *before* the atomic publish — `raise` simulates a
                     kill mid-write, `truncate` a torn/partial write
                     (detected on load through the sha256 sidecar or
                     manifest)
  train.preempt      engine/harness.StepHarness.check_preemption, once
                     per step boundary — `raise` is consumed as a
                     simulated preemption (checkpoint, then
                     PreemptedError)
  train.step,        TrainingMaster, once per step (or k-step group):
  train.hang,        a crash, a hang (`delay`), and a hang with SIGUSR1
  train.hang_hard    and SIGTERM blocked (resilience.fire_hang_hard)
  train.grad_nonfinite  TrainingMaster, once per fetched batch: `raise`
                     is consumed by poisoning the batch with NaN
  data.next          TrainingMaster, before each batch_fn call (inside
                     `data_retry`)
  obs.emit           observability/metrics guarded-emission helpers —
                     `raise` simulates a broken telemetry backend; the
                     helpers swallow it (counted as dropped)
  serving.slot_evict serving/continuous.DecodeEngine.step_once, once
                     per engine iteration — `raise` evicts the lowest
                     active slot (re-prefill + forced replay)
  decode.hang        DecodeEngine's loop thread, before each heartbeat —
                     `delay` wedges the loop for the StepWatchdog drill
  decode.nonfinite   DecodeEngine.step_once, once per decode dispatch —
                     `raise` forces a poison verdict on the lowest
                     decoding slot (quarantine + replay)
  journal.write_torn serving/journal.py, right after each append —
                     `truncate` mauls the head segment's tail
  journal.fsync_fail serving/journal.py, before each group fsync —
                     `raise` keeps the bytes pending for the next flush
  journal.recover_corrupt  serving/journal.py, once per replayed record
                     of the recovery scan — `raise` declares it corrupt
  dist.heartbeat_stale  resilience/cluster.ClusterSupervisor, at every
                     lease check — `raise` is consumed as a forced
                     stale-lease verdict (kill + gang restart)
  dist.spare_exhausted  ClusterSupervisor, when a quarantined worker
                     finds the spare pool dry (before shrink or abort)

`REGISTERED_POINTS` is the canonical registry: every `fire(...)` site
in the port must use a name listed there (tests/test_torch_engine.py
pins it).

Env var grammar (comma-separated specs):

  DL4J_TPU_FAULTS="checkpoint.write:truncate@2,serve.request:raise@1x3"

  <point>:<mode>[@<at_hit>][x<times>][~<delay_s>][%<probability>]

`at_hit` is 1-based (trigger on the Nth fire), `times` is how many
consecutive fires trigger after that (default 1), `delay_s` applies to
mode=delay, `probability` arms a seeded Bernoulli gate (deterministic
for a fixed seed — same sequence of fires, same faults).
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.resilience.errors import FaultInjectedError

ENV_VAR = "DL4J_TPU_FAULTS"
_MODES = ("raise", "delay", "truncate")

# every fault point name of the JAX package's registry (the port fires
# the subset its docstring lists)
REGISTERED_POINTS = frozenset({
    "admission.quota_storm",
    "checkpoint.write",
    "data.next",
    "decode.hang",
    "decode.nonfinite",
    "dist.heartbeat_stale",
    "dist.spare_exhausted",
    "inference.batch",
    "inference.complete",
    "journal.fsync_fail",
    "journal.recover_corrupt",
    "journal.write_torn",
    "obs.emit",
    "rollout.canary_poison",
    "serve.request",
    "serving.migrate_fail",
    "serving.replica_kill",
    "serving.slot_evict",
    "train.grad_nonfinite",
    "train.hang",
    "train.hang_hard",
    "train.preempt",
    "train.step",
})


@dataclass
class FaultSpec:
    point: str
    mode: str = "raise"                 # raise | delay | truncate
    at_hit: int = 1                     # 1-based: trigger on the Nth fire
    times: int = 1                      # how many fires trigger after that
    delay_s: float = 0.05               # for mode=delay
    truncate_to: int = 0                # bytes kept by mode=truncate
    probability: float = 1.0            # Bernoulli gate (seeded)
    exc_factory: Optional[Callable[[str, int], Exception]] = None
    _rng: random.Random = field(default_factory=lambda: random.Random(0),
                                repr=False)
    _seen: int = 0                      # fires observed SINCE ARMING

    def should_trigger(self, hit: int) -> bool:
        if not (self.at_hit <= hit < self.at_hit + self.times):
            return False
        if self.probability >= 1.0:
            return True
        return self._rng.random() < self.probability


class FaultInjector:
    """Registry + firing engine. Thread-safe; no-op when nothing armed."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._hits: Dict[str, int] = {}
        self._seed = seed
        self._env_loaded = False

    # ------------------------------------------------------------- arming
    def inject(self, point: str, mode: str = "raise", at_hit: int = 1,
               times: int = 1, delay_s: float = 0.05,
               truncate_to: int = 0, probability: float = 1.0,
               exc_factory: Optional[Callable] = None,
               seed: Optional[int] = None) -> FaultSpec:
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}: {mode}")
        spec = FaultSpec(point=point, mode=mode, at_hit=at_hit,
                         times=times, delay_s=delay_s,
                         truncate_to=truncate_to, probability=probability,
                         exc_factory=exc_factory)
        spec._rng = random.Random(self._seed if seed is None else seed)
        with self._lock:
            self._specs.setdefault(point, []).append(spec)
        return spec

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._specs.clear()
                self._hits.clear()
            else:
                self._specs.pop(point, None)
                self._hits.pop(point, None)

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    @property
    def armed(self) -> bool:
        with self._lock:
            return bool(self._specs)

    # ------------------------------------------------------------- firing
    def fire(self, point: str, path: Optional[str] = None) -> None:
        """Hit a fault point. No-op unless a spec for `point` is armed.

        `at_hit` counts fires a spec has SEEN since it was armed (not a
        process-lifetime total), so late-armed faults stay deterministic.

        `path` gives mode=truncate something to maul (the not-yet-
        published tmp file of an atomic write)."""
        self._load_env_once()
        with self._lock:
            self._hits[point] = self._hits.get(point, 0) + 1
            specs = list(self._specs.get(point, ()))
            for spec in specs:
                spec._seen += 1
        for spec in specs:
            if not spec.should_trigger(spec._seen):
                continue
            if spec.mode == "delay":
                time.sleep(spec.delay_s)
            elif spec.mode == "truncate":
                if path and os.path.exists(path):
                    with open(path, "r+b") as f:
                        f.truncate(spec.truncate_to)
            else:   # raise — a simulated crash at this point
                if spec.exc_factory is not None:
                    raise spec.exc_factory(point, spec._seen)
                raise FaultInjectedError(point, spec._seen)

    # ---------------------------------------------------------------- env
    def _load_env_once(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        raw = os.environ.get(ENV_VAR, "").strip()
        if raw:
            self.load_spec_string(raw)

    def load_spec_string(self, raw: str) -> None:
        """Parse the ENV grammar (see module docstring) and arm it."""
        for item in raw.split(","):
            item = item.strip()
            if not item:
                continue
            point, _, rest = item.partition(":")
            mode, at_hit, times, delay_s, prob = "raise", 1, 1, 0.05, 1.0
            if rest:
                # split off ~delay and %probability and xN and @N markers
                body = rest
                if "%" in body:
                    body, _, p = body.rpartition("%")
                    prob = float(p)
                if "~" in body:
                    body, _, d = body.rpartition("~")
                    delay_s = float(d)
                if "x" in body.split("@")[-1] or (
                        "@" not in body and "x" in body):
                    body, _, t = body.rpartition("x")
                    times = int(t)
                if "@" in body:
                    body, _, a = body.rpartition("@")
                    at_hit = int(a)
                if body:
                    mode = body
            self.inject(point.strip(), mode=mode, at_hit=at_hit,
                        times=times, delay_s=delay_s, probability=prob)


# process-global registry: tests, chaos runs, and production code share it
_INJECTOR = FaultInjector()


def injector() -> FaultInjector:
    return _INJECTOR


def fire(point: str, path: Optional[str] = None) -> None:
    """Module-level shorthand used at instrumentation sites."""
    _INJECTOR.fire(point, path=path)
