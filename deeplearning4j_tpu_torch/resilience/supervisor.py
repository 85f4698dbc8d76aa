"""Self-healing training (counterpart of
deeplearning4j_tpu/resilience/supervisor.py): the non-finite guard, the
in-memory rollback snapshotter, the step watchdog, the preemption
handler, the bounded-restart supervisor and the `train.hang_hard` chaos
site.

  NonFiniteGuard     post-step all-finite check on loss + params (one
                     host read, only on checked steps — `check_every=N`
                     samples the hot path) with an optional loss-spike
                     detector. Policies: `skip_step` (restore the
                     pre-step snapshot — params, updater state, BN
                     states, the dropout generator, iteration — so the
                     poisoned batch never happened), `rollback` (restore the caller's
                     rollback target), `abort` (raise).
  PeriodicSnapshotter  in-memory rollback targets for fit loops without
                     a checkpoint directory.
  StepWatchdog       heartbeat timestamps around dispatch/fetch; a
                     monitor thread escalates a silent fit loop within
                     `timeout_s` by raising StepHangError in the training
                     thread via SIGUSR1 — crash-restartable instead of
                     wedged. The handler runs only when the main thread
                     is back in the interpreter: a wait inside CUDA
                     (`torch.cuda.synchronize`, `.item()`, an event) is
                     not interrupted: with `heartbeat=` (a
                     resilience/cluster.HeartbeatFile lease) the
                     watchdog marks the lease and hard-exits
                     (EXIT_HANG) after `hang_exit_after` silent
                     detections, and a ClusterSupervisor relaunches the
                     worker from its newest checkpoint.
  PreemptionHandler  SIGTERM/SIGINT set a flag; the fit loop checks it
                     at step boundaries and runs checkpoint-then-exit
                     (PreemptedError). The `train.preempt` fault point
                     simulates a preemption deterministically.
  Supervisor         `run(fit_fn)` catches restartable crashes, backs off
                     with a capped exponential, and re-enters the fit
                     (which resumes from the newest valid checkpoint) up
                     to `max_restarts`, recording a ledger.
  fire_hang_hard     the `train.hang_hard` site TrainingMaster fires
                     once per step or group: a `delay` armed there
                     wedges the loop with SIGUSR1 and SIGTERM blocked.

A snapshot copies the train carry itself (nn/base_network.py's
`_train_carry`) and the dropout generator's state:
on the flat chain that is one flat parameter vector and one flat vector
per updater-state field, so a checked step pays two device copies and no
unravel/re-ravel of the per-layer trees.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Callable, List, Optional

import torch

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.cluster import EXIT_HANG
from deeplearning4j_tpu_torch.resilience.errors import (
    NonFiniteLossError,
    RestartsExhaustedError,
    StepHangError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire
from deeplearning4j_tpu_torch.resilience.faults import injector
from deeplearning4j_tpu_torch.util.tree import clone, leaves

logger = logging.getLogger("deeplearning4j_tpu_torch")

POLICIES = ("skip_step", "rollback", "abort")


def fire_hang_hard() -> None:
    """`train.hang_hard` chaos site: a `delay` spec armed here wedges
    the fit loop with SIGUSR1 *and SIGTERM blocked* — immune to a step
    watchdog's signal escalation AND to a supervisor's polite SIGTERM,
    the deterministic analogue of a thread stuck inside a native
    collective. Only a hard exit or an external SIGKILL recovers it."""
    if not injector().armed or not hasattr(signal, "pthread_sigmask"):
        # happy path: no chaos armed — skip the two sigmask syscalls,
        # keep the hit accounting
        _fire("train.hang_hard")
        return
    blocked = {s for s in (getattr(signal, "SIGUSR1", None),
                           getattr(signal, "SIGTERM", None))
               if s is not None}
    old = signal.pthread_sigmask(signal.SIG_BLOCK, blocked)
    try:
        _fire("train.hang_hard")
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, old)


class NonFiniteGuard:
    """Detect non-finite (and optionally spiking) training state and
    recover per policy. One guard instance per fit loop / net.

    `check_every=N` checks every Nth step (the only per-step cost on
    unchecked steps is one modulo); each check is one all-finite
    reduction over loss + params (+ updater state when
    `check_updater_state=True`) followed by one host read.
    `loss_spike_factor=f > 0` additionally flags a checked loss
    exceeding f x the running EMA of accepted losses.

    skip_step needs a pre-step snapshot (a device copy of the train
    carry and the BN states) on checked steps — budget for that when
    choosing `check_every`; rollback and abort snapshot nothing.
    """

    def __init__(self, policy: str = "skip_step", check_every: int = 1,
                 loss_spike_factor: float = 0.0, ema_decay: float = 0.9,
                 max_rollbacks: int = 5,
                 check_updater_state: bool = False):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}: {policy}")
        self.policy = policy
        self.check_every = int(check_every)
        self.loss_spike_factor = float(loss_spike_factor)
        self.ema_decay = float(ema_decay)
        self.max_rollbacks = int(max_rollbacks)
        self.check_updater_state = check_updater_state
        self.counters = {"checks": 0, "nonfinite": 0, "spikes": 0,
                         "skipped_steps": 0, "rollbacks": 0}
        self._ema: Optional[float] = None

    # ---------------------------------------------------------- cadence
    def should_check(self, step: int) -> bool:
        return self.check_every > 0 and step % self.check_every == 0

    # --------------------------------------------------------- snapshot
    def snapshot(self, net) -> dict:
        """Device copies of everything a train step mutates."""
        return {
            "carry": clone(net._train_carry()),
            "rng": net._rng_state(),
            "iteration": net.iteration,
            "epoch": net.epoch,
            "score": net._score,
            "lr_score_factor": net._lr_score_factor,
        }

    def restore(self, net, snap: dict) -> None:
        """Rewind `net` to `snap`. The net gets copies, so one snapshot
        can be restored more than once."""
        net._set_train_carry(clone(snap["carry"]))
        net._set_rng_state(snap["rng"])
        net.iteration = snap["iteration"]
        net.epoch = snap["epoch"]
        net._score = snap["score"]
        net._lr_score_factor = snap["lr_score_factor"]

    # ------------------------------------------------------------ check
    def post_step(self, net) -> str:
        """Check the net after a step: 'ok' | 'nonfinite' | 'spike'.
        Accepted losses feed the spike EMA."""
        self.counters["checks"] += 1
        _obs.count("dl4j_train_guard_checks_total")
        params, upd, _ = net._train_carry()
        tensors = leaves(params) + (leaves(upd) if self.check_updater_state
                                    else [])
        loss = torch.as_tensor(net._score).detach().float().reshape(())
        oks = [torch.isfinite(loss)] + [
            torch.isfinite(t).all() for t in tensors
            if t.is_floating_point()]
        ok_dev = torch.stack([o.to(loss.device) for o in oks]).all()
        ok, loss_v = torch.stack([ok_dev.float(), loss]).tolist()
        if not ok:
            self.counters["nonfinite"] += 1
            _obs.count("dl4j_train_guard_nonfinite_total")
            return "nonfinite"
        # the loss is on the host now — the train-loss gauge rides the
        # guard's read for free
        _obs.set_gauge("dl4j_train_loss", loss_v)
        if (self.loss_spike_factor > 0.0 and self._ema is not None
                and loss_v > self.loss_spike_factor
                * max(abs(self._ema), 1e-8)):
            self.counters["spikes"] += 1
            _obs.count("dl4j_train_guard_spikes_total")
            return "spike"
        self._ema = (loss_v if self._ema is None else
                     self.ema_decay * self._ema
                     + (1.0 - self.ema_decay) * loss_v)
        return "ok"

    # --------------------------------------------------------- counters
    def note_skip(self) -> None:
        self.counters["skipped_steps"] += 1
        _obs.count("dl4j_train_guard_skipped_steps_total")

    def note_rollback(self) -> None:
        self.counters["rollbacks"] += 1
        _obs.count("dl4j_train_guard_rollbacks_total")

    def stats(self) -> dict:
        return {"policy": self.policy, "check_every": self.check_every,
                "loss_spike_factor": self.loss_spike_factor,
                **self.counters}


class PeriodicSnapshotter:
    """In-memory rollback targets for fit loops that have no checkpoint
    directory (EarlyStoppingTrainer): a device-copy snapshot
    (NonFiniteGuard.snapshot) of the PRE-step state every `every`
    guarded steps; `restore()` rewinds the net to the newest one — so
    NonFiniteGuard(policy='rollback') works without checkpoints.
    Recovery loses at most `every - 1` good steps."""

    def __init__(self, guard: NonFiniteGuard, every: int = 8):
        self.guard = guard
        self.every = max(1, int(every))
        self.counters = {"snapshots": 0, "restores": 0}
        self._snap = None
        self._calls = 0

    def maybe_snapshot(self, net) -> None:
        """Call BEFORE running a step: refreshes the rollback target on
        the cadence (and always on the very first step, so a target
        exists before the first possible poison)."""
        if self._snap is None or self._calls % self.every == 0:
            self._snap = self.guard.snapshot(net)
            self.counters["snapshots"] += 1
        self._calls += 1

    def restore(self, net) -> None:
        self.guard.restore(net, self._snap)
        self.counters["restores"] += 1

    def stats(self) -> dict:
        return {"every": self.every, **self.counters}


class StepWatchdog:
    """Detect a wedged fit loop. The loop calls `beat()` around
    dispatch/fetch (one clock read); a monitor thread checks heartbeat
    age every `poll_s` and, when it exceeds `timeout_s`, escalates:
    default is SIGUSR1 to the training (main) thread, whose handler
    raises StepHangError — interrupting signal-interruptible waits
    (sleeps, gloo/python-level polls) so the Supervisor can restart
    from the newest checkpoint instead of the job hanging forever.
    Pass `on_hang=fn(phase, age_s)` to override escalation (e.g. page).
    A wait inside CUDA defers the SIGUSR1 handler until the wait
    returns.

    Cluster mode: pass `heartbeat=HeartbeatFile(...)` (resilience/
    cluster.py) and every beat also renews the worker's liveness lease
    (throttled inside HeartbeatFile). With a heartbeat attached the
    watchdog ALSO gets the default escalation for the uninterruptible
    case: after `hang_exit_after` consecutive hang detections with no
    fresh beat between them (the SIGUSR1 raise never landed — the main
    thread is inside a CUDA wait, or the wait is signal-immune), the
    monitor thread writes a hang marker into the lease and
    `os._exit(EXIT_HANG)`s, so the external ClusterSupervisor relaunches
    the gang instead of the job hanging forever."""

    def __init__(self, timeout_s: float = 300.0,
                 poll_s: Optional[float] = None,
                 on_hang: Optional[Callable[[str, float], None]] = None,
                 heartbeat=None, hang_exit_after: int = 2):
        self.timeout_s = float(timeout_s)
        self.poll_s = poll_s if poll_s is not None else min(
            1.0, max(0.05, self.timeout_s / 4.0))
        self.on_hang = on_hang
        self.heartbeat = heartbeat
        self.hang_exit_after = int(hang_exit_after)
        # telemetry attach points (set by the engine's StepHarness when a
        # tracer is wired): hang events recorded on the monitor THREAD get
        # explicitly parented to the training thread's current step span
        self.tracer = None
        self.trace_parent = None
        self.counters = {"beats": 0, "hangs_detected": 0}
        self._last: Optional[float] = None
        self._phase = "idle"
        self._step: Optional[int] = None
        self._beats_at_hang: Optional[int] = None
        self._consecutive_hangs = 0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._target_tid: Optional[int] = None
        self._old_handler = None

    # ------------------------------------------------------------ beats
    def beat(self, phase: str = "step",
             step: Optional[int] = None) -> None:
        self._phase = phase
        if step is not None:
            self._step = step
        self._last = time.monotonic()
        self.counters["beats"] += 1
        if self.heartbeat is not None:
            self.heartbeat.write(phase=phase, step=self._step)

    # -------------------------------------------------------- lifecycle
    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self.beat("start")
        self._stop = threading.Event()
        if (self.on_hang is None and hasattr(signal, "SIGUSR1")
                and threading.current_thread()
                is threading.main_thread()):
            self._target_tid = threading.main_thread().ident
            self._old_handler = signal.signal(
                signal.SIGUSR1, self._raise_hang)
        self._thread = threading.Thread(
            target=self._monitor, daemon=True, name="StepWatchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None
        if self._old_handler is not None:
            try:
                signal.signal(signal.SIGUSR1, self._old_handler)
            except (ValueError, OSError):
                pass   # not the main thread anymore: leave it
            self._old_handler = None
            self._target_tid = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------- escalate
    def _raise_hang(self, signum, frame):
        raise StepHangError(
            f"step watchdog: no heartbeat for >= {self.timeout_s}s "
            f"(last phase {self._phase!r})")

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            last = self._last
            if last is None:
                continue
            age = time.monotonic() - last
            if age < self.timeout_s:
                continue
            self.counters["hangs_detected"] += 1
            _obs.count("dl4j_train_watchdog_hangs_total")
            if self.tracer is not None:
                try:
                    self.tracer.instant(
                        "watchdog_hang", cat="resilience",
                        parent=self.trace_parent,
                        args={"phase": self._phase,
                              "age_s": round(age, 3)})
                except Exception:   # noqa: BLE001 - telemetry best-effort
                    pass
            self._last = time.monotonic()   # re-arm, don't spam
            # consecutive = no fresh beat since the previous detection:
            # the soft (signal) escalation did not land
            if self._beats_at_hang == self.counters["beats"]:
                self._consecutive_hangs += 1
            else:
                self._consecutive_hangs = 1
            self._beats_at_hang = self.counters["beats"]
            logger.error("StepWatchdog: no heartbeat for %.1fs "
                         "(phase %r) — escalating", age, self._phase)
            if (self.heartbeat is not None
                    and self._consecutive_hangs >= self.hang_exit_after):
                self._hard_exit(age)
            try:
                if self.on_hang is not None:
                    self.on_hang(self._phase, age)
                elif self._target_tid is not None:
                    signal.pthread_kill(self._target_tid, signal.SIGUSR1)
            except Exception:   # noqa: BLE001 - escalation best-effort
                logger.exception("StepWatchdog escalation failed")

    def _hard_exit(self, age: float) -> None:
        """Uninterruptible hang: the training thread survived a SIGUSR1
        raise without beating — write the marker and hard-exit so the
        ClusterSupervisor relaunches the gang."""
        logger.error(
            "StepWatchdog: %d consecutive silent hangs (phase %r) — "
            "marking heartbeat and exiting %d for external relaunch",
            self._consecutive_hangs, self._phase, EXIT_HANG)
        try:
            self.heartbeat.mark_hang(self._phase, age)
        finally:
            os._exit(EXIT_HANG)

    def stats(self) -> dict:
        return {"timeout_s": self.timeout_s, **self.counters}


class PreemptionHandler:
    """Graceful preemption: SIGTERM/SIGINT (and the `train.preempt`
    fault point) set a flag instead of killing mid-step; the fit loop
    checks `requested` at step boundaries and runs checkpoint-then-exit
    (PreemptedError), so a preempted job loses zero completed steps."""

    def __init__(self, signals=None):
        if signals is None:
            signals = tuple(
                s for s in (getattr(signal, "SIGTERM", None),
                            getattr(signal, "SIGINT", None))
                if s is not None)
        self.signals = tuple(signals)
        self.counters = {"signals": 0, "simulated": 0, "preemptions": 0}
        self._requested = False
        self._old = {}

    @property
    def requested(self) -> bool:
        return self._requested

    def request(self, simulated: bool = False) -> None:
        """Flag a preemption programmatically (the fault-point path)."""
        self.counters["simulated" if simulated else "signals"] += 1
        self._requested = True

    def clear(self) -> None:
        self._requested = False

    def _on_signal(self, signum, frame):
        logger.warning("preemption signal %s received: will checkpoint "
                       "and exit at the next step boundary", signum)
        self.request()

    def install(self) -> "PreemptionHandler":
        if self._old or threading.current_thread() \
                is not threading.main_thread():
            return self   # already installed / not signal-capable
        for s in self.signals:
            try:
                self._old[s] = signal.signal(s, self._on_signal)
            except (ValueError, OSError):
                pass
        return self

    def uninstall(self) -> None:
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._old = {}

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def stats(self) -> dict:
        return dict(self.counters)


def _default_restartable(exc: Exception) -> bool:
    # abort-policy verdicts are final; everything else (injected
    # crashes, hangs, preemptions, I/O, runtime) is worth a resume
    # attempt — the fit re-enters through the newest VALID checkpoint,
    # so a restart can only lose uncheckpointed steps, never corrupt.
    return not isinstance(exc, NonFiniteLossError)


class Supervisor:
    """Bounded-restart wrapper around a fit call.

    `run(fit_fn)` returns fit_fn's result; on a restartable crash it
    sleeps a capped exponential backoff and calls fit_fn again (the fit
    resumes from the newest valid checkpoint), up to `max_restarts`
    times, then raises RestartsExhaustedError carrying the ledger.
    Every restart is recorded in `restart_ledger`."""

    def __init__(self, max_restarts: int = 3,
                 initial_backoff_s: float = 0.5,
                 multiplier: float = 2.0, max_backoff_s: float = 30.0,
                 restartable: Callable[[Exception], bool]
                 = _default_restartable,
                 on_restart: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.max_restarts = int(max_restarts)
        self.initial_backoff_s = initial_backoff_s
        self.multiplier = multiplier
        self.max_backoff_s = max_backoff_s
        self.restartable = restartable
        self.on_restart = on_restart
        self._sleep = sleep
        self._clock = clock
        self.restart_ledger: List[dict] = []

    def run(self, fit_fn: Callable, *args, **kwargs):
        attempt = 0
        while True:
            t0 = self._clock()
            try:
                return fit_fn(*args, **kwargs)
            except Exception as exc:   # noqa: BLE001 - policy boundary
                entry = {"attempt": attempt + 1,
                         "error_class": type(exc).__name__,
                         "error": str(exc)[:500],
                         "ran_s": round(self._clock() - t0, 3)}
                if not self.restartable(exc):
                    raise
                if attempt >= self.max_restarts:
                    entry["gave_up"] = True
                    self.restart_ledger.append(entry)
                    raise RestartsExhaustedError(
                        f"gave up after {self.max_restarts} restarts: "
                        f"{exc!r}", cause=exc,
                        ledger=list(self.restart_ledger)) from exc
                backoff = min(
                    self.initial_backoff_s * self.multiplier ** attempt,
                    self.max_backoff_s)
                entry["backoff_s"] = round(backoff, 3)
                self.restart_ledger.append(entry)
                _obs.count("dl4j_train_supervisor_restarts_total")
                logger.warning(
                    "Supervisor: restart %d/%d after %s: %s (backoff "
                    "%.2fs)", attempt + 1, self.max_restarts,
                    type(exc).__name__, exc, backoff)
                if self.on_restart is not None:
                    self.on_restart(exc, attempt + 1)
                self._sleep(backoff)
                attempt += 1

    def stats(self) -> dict:
        return {"max_restarts": self.max_restarts,
                "restarts": len(self.restart_ledger),
                "ledger": [dict(e) for e in self.restart_ledger]}
