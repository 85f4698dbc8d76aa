"""Self-healing training (counterpart of
deeplearning4j_tpu/resilience/supervisor.py): the non-finite guard, the
in-memory rollback snapshotter, the preemption handler and the
`train.hang_hard` chaos site. The step watchdog and the bounded-restart
supervisor wait (ROADMAP queue 8); the engine's StepHarness takes any
object with their methods.

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
  PreemptionHandler  SIGTERM/SIGINT set a flag; the fit loop checks it
                     at step boundaries and runs checkpoint-then-exit
                     (PreemptedError). The `train.preempt` fault point
                     simulates a preemption deterministically.
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
import signal
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.observability import metrics as _obs
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
