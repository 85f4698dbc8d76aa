"""Cluster supervision: external gang relaunch for hard hangs
(counterpart of deeplearning4j_tpu/resilience/cluster.py).

The in-process self-healing of resilience/supervisor.py recovers
everything a *live Python thread* can recover: crashes, preemptions,
NaNs, and hangs interruptible by SIGUSR1. Its blind spot is a training
thread that never returns to the interpreter — a wait inside CUDA
(`torch.cuda.synchronize`, an event, a host read) or a wedged native
collective: the SIGUSR1 handler is deferred until the wait returns, and
the job hangs forever. This module is the process-level half:

  HeartbeatFile      the worker's liveness lease: an atomically-
                     replaced JSON record {pid, step, phase, status,
                     time} written from the StepWatchdog beat path
                     (throttled — one write per `min_interval_s` at
                     most, so the training loop never pays more than a
                     small json dump + rename per interval).
  ClusterSupervisor  spawns the worker processes themselves (one per
                     rank, each in its own process group), monitors
                     exit codes AND heartbeat leases, and on any fault
                     performs a COHERENT GANG RESTART: kill every member
                     (SIGTERM, grace, SIGKILL — a thread wedged inside
                     CUDA defers a Python SIGTERM handler; SIGKILL cannot
                     be blocked), pick the newest valid checkpoint via
                     the integrity scan, and relaunch all ranks with a
                     fresh rendezvous port and a SHARED resume step, so
                     every rank restores the same state.

Fault domains detected, in detection order:

  crash              a member exited non-zero (incl. killed by signal)
  hang (hard)        a member's lease went stale while the process is
                     still alive; the supervisor SIGTERMs then SIGKILLs
                     it. A member that exits with EXIT_HANG (the
                     StepWatchdog's hard-exit escalation) is classified
                     the same way.
  nan abort          a member exited EXIT_NAN (NonFiniteLossError under
                     policy='abort'); the gang restarts from the last
                     checkpoint — before the poisoned step — bounded by
                     the ledger like any other fault.

Repeatedly failing members are QUARANTINED: each worker carries a
restart budget (`max_restarts_per_worker`); exhausting it retires the
member's SLOT. What happens next is the elastic part:

  spare pool      `spares=N` holds N standby slots. A quarantined
                  rank is RESCHEDULED onto a spare — fresh working
                  directory (a bad host's local disk is suspect), same
                  rank id, restart budget reset — and the gang
                  relaunches on a fresh port. One bad host costs a
                  reschedule, not the job.
  shrink-to-fit   with no spare left and `allow_shrink=True`, the gang
                  relaunches at REDUCED world size (floor
                  `min_workers`): the quarantined member is retired,
                  survivors are re-ranked 0..n-1, and every worker
                  learns the new world size through the resume
                  handshake (command_fn's nprocs argument).
  abort           only when spares are gone and shrink is disallowed
                  (or would go below `min_workers`) does the gang
                  abort with RestartsExhaustedError carrying the full
                  ledger. The `dist.spare_exhausted` fault point fires
                  at exactly that juncture so the no-spare path is
                  drillable.

`max_gang_restarts` bounds the total restart count independently, and
`dl4j_cluster_world_size` / `dl4j_cluster_spare_reschedules_total` /
`dl4j_cluster_shrinks_total` make every elastic event visible on a
/metrics scrape.

With `per_rank_checkpoints=True` every rank writes its own checkpoint
copy (`<checkpoint_dir>/rank-<r>/`) and the resume handshake runs the
checkpoint_integrity divergence quorum BEFORE any resume, and with
`sharded_optimizer=True` the sharded (ZeRO-1) quorum: replicated state
votes over the save-time world, the slice sets must be complete. The
supervisor is process-level: the workers it launches may train together
over `torch.distributed` (TrainingMaster.initialize_distributed); the
multi-rank gang drills wait for ROADMAP queue 9c. The JAX package's test of a
collateral death (a peer torn down by the distributed runtime, not
charged against its budget) has no counterpart until then: every
fault is charged, and each ledger entry says `"collateral": False`.

The `dist.heartbeat_stale` fault point fires at every lease check; an
armed `raise` spec is consumed as a forced stale verdict, so the
quarantine/kill path is drillable without real hangs. Lease records and
exit codes are the JAX package's: either package's supervisor reads the
other's workers.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import signal
import socket
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience import checkpoint_integrity as _ci
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError,
    FaultInjectedError,
    RestartsExhaustedError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire

logger = logging.getLogger("deeplearning4j_tpu_torch")

# well-known worker exit codes (chosen clear of shell/signal ranges):
# the StepWatchdog's hard-exit escalation and a worker's NaN-abort
# wrapper use these so the supervisor can classify without parsing logs
EXIT_HANG = 86   # os._exit by the watchdog: uninterruptible hang
EXIT_NAN = 87    # NonFiniteLossError under policy='abort'

# processes spawned by any ClusterSupervisor in this interpreter;
# `reap_stray_workers` sweeps it so a failing test cannot leak children
_LIVE_PROCS: List[subprocess.Popen] = []


def heartbeat_path(directory: str, rank: int) -> str:
    """The lease file for `rank` — one shared convention so the
    supervisor and the worker derive the same path independently."""
    return os.path.join(directory, f"worker-{rank}.hb.json")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def reap_stray_workers() -> int:
    """Kill the process group of every still-alive supervised worker
    (test teardown hook). Returns how many were reaped."""
    reaped = 0
    for proc in list(_LIVE_PROCS):
        if proc.poll() is None:
            _kill_group(proc, signal.SIGKILL)
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
            reaped += 1
        _LIVE_PROCS.remove(proc)
    return reaped


def _kill_group(proc: subprocess.Popen, sig) -> None:
    """Signal the worker's whole process group (workers are spawned
    with start_new_session=True, so pgid == pid and grandchildren die
    with the member)."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


class HeartbeatFile:
    """The worker side of the liveness lease.

    `write()` atomically replaces the record (tmp + os.replace — no
    fsync: heartbeats are advisory, a torn one just looks stale) and is
    throttled to one disk write per `min_interval_s` unless the status
    changes or `force=True`. The supervisor reads the wall-clock
    `time` field embedded in the record as the lease timestamp
    (immune to coarse-mtime filesystems like NFS), falling back to the
    file's mtime for torn/unparseable records — so a worker that stops
    calling write() — wedged, killed, or stuck inside the device —
    goes stale without any cooperation from the worker."""

    def __init__(self, path: str, min_interval_s: float = 0.2,
                 world_size: Optional[int] = None,
                 slot: Optional[int] = None):
        """`world_size` and `slot` (the elastic-gang identity this
        worker was launched with) ride in every lease record, so the
        supervisor — and a human reading the heartbeat dir — can see
        which generation/world a lease belongs to after a shrink or a
        spare reschedule."""
        self.path = path
        self.min_interval_s = float(min_interval_s)
        self.pid = os.getpid()
        self.world_size = (int(world_size) if world_size is not None
                           else None)
        self.slot = int(slot) if slot is not None else None
        self.counters = {"writes": 0, "throttled": 0}
        self._last_write = None
        self._last_status = None
        self._last = {"step": None, "phase": "init"}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, phase: str = "step", step: Optional[int] = None,
              status: str = "running", force: bool = False) -> None:
        now = time.monotonic()
        if step is None:
            step = self._last.get("step")
        self._last = {"step": step, "phase": phase}
        if (not force and status == self._last_status
                and self._last_write is not None
                and now - self._last_write < self.min_interval_s):
            self.counters["throttled"] += 1
            return
        record = {"pid": self.pid, "step": step, "phase": phase,
                  "status": status, "time": time.time()}
        if self.world_size is not None:
            record["world_size"] = self.world_size
        if self.slot is not None:
            record["slot"] = self.slot
        tmp = f"{self.path}.tmp.{self.pid}"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, self.path)
        except OSError:
            # a full/flaky disk must not take down training: the lease
            # goes stale and the SUPERVISOR decides, not an IOError here
            logger.warning("heartbeat write failed: %s", self.path)
            return
        self._last_write = now
        self._last_status = status
        self.counters["writes"] += 1

    def mark_hang(self, phase: str, age_s: float) -> None:
        """The StepWatchdog's hard-exit marker: recorded BEFORE
        os._exit so the supervisor can tell 'hang' from 'crash' even if
        the exit code is lost (e.g. the process is later SIGKILLed)."""
        self.write(phase=phase, status="hang", force=True)
        logger.error("heartbeat %s marked hang (age %.1fs)",
                     self.path, age_s)

    def mark(self, status: str) -> None:
        self.write(phase=self._last.get("phase") or "step",
                   status=status, force=True)

    @staticmethod
    def read(path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def age_s(path: str) -> Optional[float]:
        """Seconds since the lease was last renewed (None = no lease
        yet).

        Staleness reads the wall-clock `time` field EMBEDDED in the
        record — on NFS-style filesystems with coarse (whole-second or
        worse) mtime granularity, mtime alone inflates the age and
        fires false stale-lease kills. A torn/unparseable record still
        counts as a renewal via the mtime fallback: any write proves
        the process is alive."""
        try:
            mtime_age = max(0.0, time.time() - os.path.getmtime(path))
        except OSError:
            return None
        rec = HeartbeatFile.read(path)
        t = rec.get("time") if isinstance(rec, dict) else None
        if isinstance(t, (int, float)):
            rec_age = time.time() - float(t)
            if rec_age >= 0.0:
                return rec_age
            # record timestamp in the future = writer clock skew;
            # trust mtime rather than reporting a forever-fresh lease
        return mtime_age


class _Member:
    """Supervisor-side view of one worker rank.

    `rank` is the gang position (contiguous 0..n-1, re-assigned on a
    shrink); `slot` is the physical placement identity (stable, never
    reused — a rescheduled rank moves to a fresh spare slot and keeps
    its rank id). `workdir` is the slot's private scratch directory."""

    def __init__(self, rank: int, hb_path: str, slot: Optional[int] = None,
                 workdir: Optional[str] = None):
        self.rank = rank
        self.hb_path = hb_path
        self.slot = rank if slot is None else slot
        self.workdir = workdir
        self.proc: Optional[subprocess.Popen] = None
        self.spawned_at = 0.0
        self.restarts = 0
        self.done = False
        self.log_path: Optional[str] = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ClusterSupervisor:
    """Spawn, lease-monitor, and gang-restart a worker gang (the
    external-driver half of the fault-tolerance story; the in-process
    half is resilience/supervisor.py).

    `command_fn(rank, nprocs, port, resume_step) -> argv` builds each
    member's command line; the supervisor allocates a fresh rendezvous
    `port` per generation (a relaunched gang must not collide with the
    dead one's socket) and passes the SHARED `resume_step` (newest
    valid checkpoint at relaunch time, 0 when none) so every rank
    restores the same state — the resume-step handshake. `env_fn(rank)`
    may add per-rank environment (e.g. arm a fault on one member only).
    Worker stdout/stderr go to `<log_dir>/worker-<rank>.gen<G>.log`.

    Liveness: a member is faulted when its process exits non-zero OR
    its heartbeat lease (see HeartbeatFile) is older than
    `lease_timeout_s` while the process is still alive; a member that
    never heartbeats at all is given `startup_grace_s` (first beats
    wait on interpreter + torch import + the net's build and its first
    CUDA-graph capture when the worker warms up before its watchdog
    starts). Any fault triggers a coherent gang restart; per-member
    restarts are bounded by `max_restarts_per_worker` (exceeded → the
    member is quarantined), the total by `max_gang_restarts`, and
    `run(timeout_s=...)` bounds wall time — the supervisor can always
    be waited on, never hung on."""

    def __init__(self, nprocs: int,
                 command_fn: Callable[[int, int, int, int],
                                      Sequence[str]],
                 heartbeat_dir: str,
                 checkpoint_dir: Optional[str] = None,
                 lease_timeout_s: float = 30.0,
                 startup_grace_s: float = 120.0,
                 poll_s: float = 0.25,
                 grace_s: float = 3.0,
                 max_restarts_per_worker: int = 2,
                 max_gang_restarts: int = 8,
                 restart_backoff_s: float = 0.5,
                 structural_check: Optional[Callable] = None,
                 env: Optional[dict] = None,
                 env_fn: Optional[Callable[[int], dict]] = None,
                 log_dir: Optional[str] = None,
                 spares: int = 0,
                 allow_shrink: bool = False,
                 min_workers: int = 1,
                 per_rank_checkpoints: bool = False,
                 sharded_optimizer: bool = False):
        """Elastic knobs: `spares=N` holds N standby slots a
        quarantined rank reschedules onto (fresh workdir, same rank,
        budget reset); `allow_shrink=True` lets the gang relaunch at
        reduced world size — never below `min_workers` — once spares
        run out; `per_rank_checkpoints=True` switches the resume
        handshake to the checkpoint_integrity divergence quorum over
        `<checkpoint_dir>/rank-<r>/` directories (minority forks are
        quarantined aside and healed before any rank resumes).
        `sharded_optimizer=True` (ZeRO-1 workers) upgrades that quorum
        to the sharded one: the replicated state votes over the save-time
        world and an incomplete or untrusted slice set falls back to an
        older step."""
        self.sharded_optimizer = bool(sharded_optimizer)
        self.nprocs = int(nprocs)
        self.command_fn = command_fn
        self.heartbeat_dir = heartbeat_dir
        self.checkpoint_dir = checkpoint_dir
        self.lease_timeout_s = float(lease_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.poll_s = float(poll_s)
        self.grace_s = float(grace_s)
        self.max_restarts_per_worker = int(max_restarts_per_worker)
        self.max_gang_restarts = int(max_gang_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.structural_check = structural_check
        self.env = env
        self.env_fn = env_fn
        self.log_dir = log_dir or heartbeat_dir
        self.spares = max(0, int(spares))
        self.allow_shrink = bool(allow_shrink)
        self.min_workers = max(1, int(min_workers))
        self.per_rank_checkpoints = bool(per_rank_checkpoints)
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        self.members = [
            _Member(r, heartbeat_path(heartbeat_dir, r), slot=r)
            for r in range(self.nprocs)]
        # standby placement slots; slot ids continue past the primary
        # ranks and are never reused, so the ledger reads unambiguously
        self._spare_slots: List[int] = list(
            range(self.nprocs, self.nprocs + self.spares))
        self.generation = 0
        self.gang_restarts = 0
        self.shrinks = 0
        self.spare_reschedules = 0
        self.quarantined: List[int] = []
        self.quarantined_slots: List[int] = []
        self.slot_ledger: List[dict] = []
        self.restart_ledger: List[dict] = []
        self.resume_steps: List[int] = []
        self.quorum_reports: List[dict] = []
        self._t0 = time.monotonic()

    # ------------------------------------------------------------ slots
    def _slot_workdir(self, slot: int) -> str:
        """The slot's private scratch directory (fresh for a spare —
        a quarantined slot's disk contents are suspect)."""
        path = os.path.join(self.log_dir, f"slot-{slot}")
        os.makedirs(path, exist_ok=True)
        return path

    def _slot_event(self, event: str, m: _Member, **extra) -> None:
        self.slot_ledger.append({
            "event": event, "slot": m.slot, "rank": m.rank,
            "gang_restart": self.gang_restarts,
            "t_s": round(time.monotonic() - self._t0, 3), **extra})

    # ------------------------------------------------------------ spawn
    def _launch_gang(self, resume_step: int) -> None:
        port = free_port()
        # the LIVE world size: shrink events become visible the moment
        # the reduced gang launches
        _obs.set_gauge("dl4j_cluster_world_size", self.nprocs)
        for m in self.members:
            # stale lease files from the previous generation must not
            # trip the new one before its first beat
            try:
                os.remove(m.hb_path)
            except OSError:
                pass
            m.done = False
            if m.workdir is None:
                m.workdir = self._slot_workdir(m.slot)
            argv = list(self.command_fn(m.rank, self.nprocs, port,
                                        resume_step))
            env = dict(self.env if self.env is not None else os.environ)
            # slot identity rides the environment (command_fn's
            # signature stays the stable 4-arg contract)
            env["DL4J_TPU_SLOT"] = str(m.slot)
            env["DL4J_TPU_SLOT_DIR"] = m.workdir
            if self.env_fn is not None:
                env.update(self.env_fn(m.rank) or {})
            log = os.path.join(
                self.log_dir,
                f"worker-{m.rank}.gen{self.generation}.log")
            m.log_path = log
            with open(log, "ab") as logf:
                m.proc = subprocess.Popen(
                    argv, env=env, stdout=logf,
                    stderr=subprocess.STDOUT,
                    start_new_session=True)
            m.spawned_at = time.monotonic()
            _LIVE_PROCS.append(m.proc)
        logger.info(
            "cluster: launched gang generation %d (%d workers, port %d,"
            " resume_step %d)", self.generation, self.nprocs, port,
            resume_step)
        self.generation += 1

    # ------------------------------------------------------------- kill
    def _kill_member(self, m: _Member) -> None:
        """SIGTERM (a worker with a PreemptionHandler checkpoints and
        exits cleanly), grace, then SIGKILL the process group — the
        only signal a thread wedged inside the device cannot defer."""
        if not m.alive:
            return
        _kill_group(m.proc, signal.SIGTERM)
        try:
            m.proc.wait(timeout=self.grace_s)
        except subprocess.TimeoutExpired:
            _kill_group(m.proc, signal.SIGKILL)
            try:
                m.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                logger.error("cluster: worker %d pid %d survived "
                             "SIGKILL?!", m.rank, m.proc.pid)

    def _kill_gang(self) -> None:
        for m in self.members:
            self._kill_member(m)
        for m in self.members:
            if m.proc is not None and m.proc in _LIVE_PROCS \
                    and m.proc.poll() is not None:
                _LIVE_PROCS.remove(m.proc)

    # -------------------------------------------------------- detection
    @staticmethod
    def _classify_exit(rc: int) -> str:
        if rc == EXIT_HANG:
            return "hang_hard"
        if rc == EXIT_NAN:
            return "nan_abort"
        if rc < 0:
            return f"killed:sig{-rc}"
        return "crash"

    def _lease_stale(self, m: _Member) -> Optional[str]:
        """Stale-lease verdict for a LIVE member (None = healthy).
        The `dist.heartbeat_stale` fault point fires per check; an
        armed `raise` is consumed as a forced stale verdict."""
        try:
            _fire("dist.heartbeat_stale")
        except FaultInjectedError:
            return "heartbeat_stale(injected)"
        hb = HeartbeatFile.read(m.hb_path)
        if hb is not None and hb.get("status") == "hang":
            # the watchdog marked the hang but the process has not
            # exited (e.g. os._exit raced a wedged atexit) — treat as
            # hung now, don't wait out the lease
            return "hang_marker"
        age = HeartbeatFile.age_s(m.hb_path)
        if age is None:
            since_spawn = time.monotonic() - m.spawned_at
            if since_spawn > self.startup_grace_s:
                return "no_heartbeat_after_startup"
            return None
        if age > self.lease_timeout_s:
            return "heartbeat_stale"
        return None

    def _watch(self, deadline: Optional[float]) -> List[Tuple[int, str]]:
        """Block until the gang finishes ([]) or faults ([(rank,
        reason), ...])."""
        while True:
            if deadline is not None and time.monotonic() > deadline:
                self._kill_gang()
                raise DeadlineExceededError(
                    f"cluster run exceeded its deadline with "
                    f"{self.gang_restarts} gang restarts "
                    f"(ledger: {self.restart_ledger})")
            faults: List[Tuple[int, str]] = []
            running = False
            for m in self.members:
                if m.done:
                    continue
                rc = m.proc.poll()
                if rc is not None:
                    if rc == 0:
                        m.done = True
                        if m.proc in _LIVE_PROCS:
                            _LIVE_PROCS.remove(m.proc)
                        continue
                    faults.append((m.rank, self._classify_exit(rc)))
                    continue
                running = True
                verdict = self._lease_stale(m)
                if verdict is not None:
                    faults.append((m.rank, verdict))
            if faults:
                return faults
            if not running and all(m.done for m in self.members):
                return []
            time.sleep(self.poll_s)

    # ------------------------------------------------------ gang restart
    def _resume_step(self) -> int:
        """The shared resume step for the next generation: the newest
        checkpoint in the shared directory that passes integrity
        validation — every relaunched rank restores THIS step. 0 = no
        valid checkpoint, start from scratch.

        With per_rank_checkpoints the scan becomes the divergence
        quorum: the newest step a strict majority of rank copies agree
        on (by state digest), minority/torn copies quarantined aside
        and healed from the quorum copy BEFORE any rank resumes. An
        unresolvable fork raises CheckpointDivergenceError out of
        run() — fail loudly, never resume an arbitrary fork."""
        if not self.checkpoint_dir:
            return 0
        if self.per_rank_checkpoints:
            if self.sharded_optimizer:
                # ZeRO-1 checkpoints: quorum over the save-time world
                # (retired ranks still vote and contribute slices),
                # slice-set completeness gates the election
                report = _ci.sharded_quorum_resume_step(
                    self.checkpoint_dir, self.nprocs)
            else:
                report = _ci.quorum_resume_step(self.checkpoint_dir,
                                                self.nprocs)
            if report is None:
                return 0
            self.quorum_reports.append(report)
            if report["healed"]:
                logger.warning(
                    "cluster: divergence quorum healed rank(s) %s at "
                    "step %d (quarantined: %s)", report["healed"],
                    report["step"], report["quarantined"])
            return int(report["step"])
        step = _ci.newest_valid_checkpoint(
            self.checkpoint_dir, structural_check=self.structural_check)
        return 0 if step is None else int(step)

    def _record_faults(self, faults: List[Tuple[int, str]],
                       resume_step: int) -> None:
        self.gang_restarts += 1
        _obs.count("dl4j_cluster_gang_restarts_total")
        for rank, reason in faults:
            m = self.members[rank]
            m.restarts += 1
            self.restart_ledger.append({
                "gang_restart": self.gang_restarts,
                "worker": rank,
                "slot": m.slot,
                "reason": reason,
                "collateral": False,
                "worker_restarts": m.restarts,
                "resume_step": resume_step,
                "t_s": round(time.monotonic() - self._t0, 3),
            })
            logger.warning(
                "cluster: worker %d (slot %d) faulted (%s) — gang "
                "restart %d from step %d", rank, m.slot, reason,
                self.gang_restarts, resume_step)
        exhausted = [m for m in self.members
                     if m.restarts > self.max_restarts_per_worker]
        for m in exhausted:
            self._retire_or_abort(m)
        if self.gang_restarts > self.max_gang_restarts:
            raise RestartsExhaustedError(
                f"gang exceeded max_gang_restarts="
                f"{self.max_gang_restarts}",
                ledger=list(self.restart_ledger))

    def _retire_or_abort(self, m: _Member) -> None:
        """A member exhausted its restart budget: quarantine its slot,
        then — in preference order — reschedule the rank onto a spare,
        shrink the gang to fit, or abort with the full ledger."""
        self.quarantined.append(m.rank)
        self.quarantined_slots.append(m.slot)
        self._slot_event("quarantined", m, restarts=m.restarts)
        _obs.count("dl4j_cluster_quarantined_workers_total")
        logger.warning("cluster: worker %d slot %d quarantined after "
                       "%d restarts", m.rank, m.slot, m.restarts)
        if self._spare_slots:
            old_slot = m.slot
            m.slot = self._spare_slots.pop(0)
            m.workdir = self._slot_workdir(m.slot)   # fresh workdir
            m.restarts = 0                           # fresh budget
            self.spare_reschedules += 1
            self._slot_event("rescheduled", m, from_slot=old_slot)
            _obs.count("dl4j_cluster_spare_reschedules_total")
            logger.warning(
                "cluster: rank %d rescheduled from quarantined slot %d "
                "onto spare slot %d (%d spare(s) left)", m.rank,
                old_slot, m.slot, len(self._spare_slots))
            return
        # the spare pool is dry — this is the drillable juncture where
        # elasticity either degrades (shrink) or gives up (abort)
        _fire("dist.spare_exhausted")
        if self.allow_shrink and len(self.members) - 1 >= self.min_workers:
            self._slot_event("retired_shrink", m)
            self.members.remove(m)
            for i, survivor in enumerate(self.members):
                survivor.rank = i
                survivor.hb_path = heartbeat_path(self.heartbeat_dir, i)
            self.nprocs = len(self.members)
            self.shrinks += 1
            _obs.count("dl4j_cluster_shrinks_total")
            logger.warning(
                "cluster: no spare left — shrinking the gang to "
                "world size %d (floor min_workers=%d)", self.nprocs,
                self.min_workers)
            return
        raise RestartsExhaustedError(
            f"worker(s) {[m.rank]} exceeded "
            f"max_restarts_per_worker={self.max_restarts_per_worker} "
            f"— quarantined, no spare left and shrink "
            f"{'would go below min_workers' if self.allow_shrink else 'disallowed'}"
            f", gang aborted",
            ledger=list(self.restart_ledger))

    # --------------------------------------------------------------- run
    def run(self, timeout_s: Optional[float] = None) -> dict:
        """Run the gang to completion (every member exits 0), gang-
        restarting through faults; returns stats(). Raises
        RestartsExhaustedError when a member exhausts its restart
        budget (quarantine) or the gang exhausts its total, and
        DeadlineExceededError past `timeout_s` — in every exit path the
        gang is dead first."""
        self._t0 = time.monotonic()
        deadline = (None if timeout_s is None
                    else self._t0 + float(timeout_s))
        resume_step = self._resume_step()
        try:
            while True:
                self._launch_gang(resume_step)
                faults = self._watch(deadline)
                if not faults:
                    return self.stats()
                # coherent restart: the whole gang dies (a half-dead
                # gang cannot make progress), then every rank
                # relaunches on one shared resume step
                self._kill_gang()
                resume_step = self._resume_step()
                self.resume_steps.append(resume_step)
                self._record_faults(faults, resume_step)
                time.sleep(self.restart_backoff_s)
        except BaseException:
            self._kill_gang()
            raise

    def stats(self) -> dict:
        out = {
            "nprocs": self.nprocs,
            "world_size": self.nprocs,
            "generations": self.generation,
            "gang_restarts": self.gang_restarts,
            "max_restarts_per_worker": self.max_restarts_per_worker,
            "per_worker_restarts": {
                m.rank: m.restarts for m in self.members if m.restarts},
            "quarantined": list(self.quarantined),
            "quarantined_slots": list(self.quarantined_slots),
            "spares_left": len(self._spare_slots),
            "spare_reschedules": self.spare_reschedules,
            "shrinks": self.shrinks,
            "slots": {m.rank: m.slot for m in self.members},
            "slot_ledger": [dict(e) for e in self.slot_ledger],
            "resume_steps": list(self.resume_steps),
            "quorum_reports": [dict(q) for q in self.quorum_reports],
            "ledger": [dict(e) for e in self.restart_ledger],
        }
        fleet = self.fleet_metrics()
        if fleet is not None:
            out["fleet_metric_ranks"] = fleet["ranks"]
        return out

    def fleet_metrics(self,
                      metrics_dir: Optional[str] = None
                      ) -> Optional[dict]:
        """Merge the per-rank MetricsRegistry snapshot dumps the
        workers write at exit (`metrics-rank<N>.json`, see
        observability.perf.dump_snapshot) into ONE fleet-level view:
        summed counters, merged histograms, per-rank gauges, and a
        single Prometheus exposition. Returns None when no rank has
        dumped yet."""
        # imported here: observability imports resilience.faults, so a
        # module-level import of perf would be circular
        from deeplearning4j_tpu_torch.observability import perf as _perf

        d = metrics_dir or self.heartbeat_dir
        paths = sorted(glob.glob(os.path.join(d, "metrics-rank*.json")))
        if not paths:
            return None
        merged = _perf.aggregate_snapshots(paths)
        return {"ranks": merged["ranks"],
                "files": paths,
                "snapshot": merged,
                "prometheus": _obs.render_prometheus(merged)}
