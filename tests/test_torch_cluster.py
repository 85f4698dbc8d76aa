"""The port's cluster supervision (deeplearning4j_tpu_torch/resilience/
cluster.py), part 1: HeartbeatFile leases (and their crossing between
the packages), ClusterSupervisor's gang restart (crash, injected stale
lease, run deadline, resume scan), its stats and fleet metrics, and the
world-size-1 drills: a port worker training with TrainingMaster under
`StepWatchdog(heartbeat=..., hang_exit_after=2)` is wedged hard-hang
style, exits EXIT_HANG (or is found stale and killed), is relaunched
from its newest checkpoint and ends bit for bit where an unfaulted run
ends. Part 2 (spares, shrink, the divergence quorum) is
tests/test_torch_cluster_elastic.py.

The JAX package's tier-1 tests of tests/test_cluster.py, ported to the
port's supervisor with trivial workers (each imports the port's
HeartbeatFile); leases and exit codes are the JAX package's."""

import json
import os
import sys
import time

import numpy as np
import pytest

from deeplearning4j_tpu.resilience import cluster as jcluster
from deeplearning4j_tpu_torch.observability.metrics import get_registry
from deeplearning4j_tpu_torch.observability.perf import dump_snapshot
from deeplearning4j_tpu_torch.resilience import (
    EXIT_HANG,
    ClusterSupervisor,
    DeadlineExceededError,
    HeartbeatFile,
    RestartsExhaustedError,
    StepWatchdog,
    heartbeat_path,
    injector,
    reap_stray_workers,
    record_checksum,
    sha256_file,
)
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(REPO, "tests", "fixtures", "torch",
                      "cluster_worker.py")


@pytest.fixture(autouse=True)
def _reap_port_workers():
    """tests/conftest.py sweeps the JAX package's workers; this sweeps
    the port's, so a failing test leaks no child into later tests."""
    yield
    reap_stray_workers()
    injector().clear()


def _hb_writer_script(hb_dir: str, rank: int, loop: bool) -> str:
    """A trivial worker: renew the lease, then exit 0 (loop=False) or
    renew forever (loop=True)."""
    body = ("while True:\n    hb.write(step=1, force=True)\n"
            "    time.sleep(0.05)\n" if loop
            else "hb.write(step=1, force=True)\nhb.mark('done')\n")
    return (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from deeplearning4j_tpu_torch.resilience.cluster import (\n"
        "    HeartbeatFile, heartbeat_path)\n"
        f"hb = HeartbeatFile(heartbeat_path({hb_dir!r}, {rank}))\n"
        + body)


# ================================================= heartbeat leases
def test_heartbeat_file_roundtrip_and_throttle(tmp_path):
    path = str(tmp_path / "w.hb.json")
    hb = HeartbeatFile(path, min_interval_s=10.0)
    hb.write(phase="dispatch", step=3)
    rec = HeartbeatFile.read(path)
    assert rec["pid"] == os.getpid()
    assert rec["step"] == 3 and rec["phase"] == "dispatch"
    assert rec["status"] == "running"
    assert HeartbeatFile.age_s(path) < 5.0
    hb.write(phase="fetch", step=4)
    assert hb.counters == {"writes": 1, "throttled": 1}
    assert HeartbeatFile.read(path)["step"] == 3
    hb.mark_hang("dispatch", 12.0)
    rec = HeartbeatFile.read(path)
    assert rec["status"] == "hang" and rec["step"] == 4
    assert HeartbeatFile.read(str(tmp_path / "missing")) is None
    assert HeartbeatFile.age_s(str(tmp_path / "missing")) is None


def test_heartbeat_lease_world_size_and_slot_fields(tmp_path):
    path = str(tmp_path / "w.hb.json")
    hb = HeartbeatFile(path, min_interval_s=0.0, world_size=3, slot=4)
    hb.write(phase="dispatch", step=7)
    rec = HeartbeatFile.read(path)
    assert rec["world_size"] == 3 and rec["slot"] == 4
    hb.mark("done")
    rec = HeartbeatFile.read(path)
    assert rec["status"] == "done"
    assert rec["world_size"] == 3 and rec["slot"] == 4
    # torn write: still a renewal (mtime fallback), parses to None
    with open(path, "w") as f:
        f.write('{"pid": 1, "world_si')
    assert HeartbeatFile.read(path) is None
    age = HeartbeatFile.age_s(path)
    assert age is not None and age < 5.0
    # a record time in the future (clock skew) falls back to the mtime
    hb.write(phase="step", step=8, force=True)
    rec = HeartbeatFile.read(path)
    rec["time"] = time.time() + 3600.0
    with open(path, "w") as f:
        f.write(json.dumps(rec))
    past = time.time() - 40.0
    os.utime(path, (past, past))
    assert 30.0 < HeartbeatFile.age_s(path) < 120.0
    hb2 = HeartbeatFile(str(tmp_path / "w2.hb.json"))
    hb2.write(step=1)
    rec2 = HeartbeatFile.read(str(tmp_path / "w2.hb.json"))
    assert "world_size" not in rec2 and "slot" not in rec2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heartbeat_lease_crosses_packages(tmp_path, writer):
    """A lease written by either package's HeartbeatFile is read (record,
    age, hang marker) by the other's: one record format, one path
    convention, the same exit codes."""
    assert (EXIT_HANG, heartbeat_path("d", 2)) \
        == (jcluster.EXIT_HANG, jcluster.heartbeat_path("d", 2))
    path = heartbeat_path(str(tmp_path), 1)
    w_cls, r_cls = ((HeartbeatFile, jcluster.HeartbeatFile)
                    if writer == "port"
                    else (jcluster.HeartbeatFile, HeartbeatFile))
    hb = w_cls(path, world_size=2, slot=5)
    hb.write(phase="dispatch", step=11)
    rec = r_cls.read(path)
    assert {k: rec[k] for k in ("pid", "step", "phase", "status",
                                "world_size", "slot")} \
        == {"pid": os.getpid(), "step": 11, "phase": "dispatch",
            "status": "running", "world_size": 2, "slot": 5}
    assert 0.0 <= r_cls.age_s(path) < 5.0
    hb.mark_hang("dispatch", 3.0)
    assert r_cls.read(path)["status"] == "hang"


# ================================================= supervisor basics
def test_cluster_success_path(tmp_path):
    hb_dir = str(tmp_path / "hb")

    def command_fn(rank, nprocs, port, resume_step):
        assert nprocs == 2 and port > 0 and resume_step == 0
        return [sys.executable, "-c",
                _hb_writer_script(hb_dir, rank, loop=False)]

    cs = ClusterSupervisor(2, command_fn, hb_dir, poll_s=0.05,
                           startup_grace_s=60.0)
    stats = cs.run(timeout_s=60.0)
    assert stats["gang_restarts"] == 0
    assert stats["generations"] == 1
    assert stats["quarantined"] == [] and stats["ledger"] == []
    for rank in range(2):
        assert HeartbeatFile.read(
            heartbeat_path(hb_dir, rank))["status"] == "done"


def test_cluster_quarantine_after_restart_budget(tmp_path):
    """A member that keeps crashing exhausts its per-worker budget: the
    supervisor quarantines it and aborts the GANG with
    RestartsExhaustedError; the healthy member is killed too."""
    hb_dir = str(tmp_path / "hb")

    def command_fn(rank, nprocs, port, resume_step):
        if rank == 0:
            return [sys.executable, "-c", "import sys; sys.exit(3)"]
        return [sys.executable, "-c",
                _hb_writer_script(hb_dir, rank, loop=True)]

    cs = ClusterSupervisor(2, command_fn, hb_dir, poll_s=0.05,
                           grace_s=0.5, restart_backoff_s=0.05,
                           max_restarts_per_worker=1,
                           startup_grace_s=60.0)
    t0 = time.monotonic()
    with pytest.raises(RestartsExhaustedError) as ei:
        cs.run(timeout_s=60.0)
    assert time.monotonic() - t0 < 30.0
    assert cs.quarantined == [0]
    assert cs.gang_restarts == 2
    assert [e["worker"] for e in ei.value.ledger] == [0, 0]
    assert all(e["reason"] == "crash" for e in ei.value.ledger)
    for m in cs.members:
        assert not m.alive


def test_cluster_injected_stale_lease_kills_live_worker(tmp_path):
    """`dist.heartbeat_stale` armed in the SUPERVISOR process forces a
    stale verdict on a live worker: the SIGTERM-then-SIGKILL + gang
    restart path runs without a real hang."""
    hb_dir = str(tmp_path / "hb")

    def command_fn(rank, nprocs, port, resume_step):
        return [sys.executable, "-c",
                _hb_writer_script(hb_dir, rank, loop=True)]

    injector().inject("dist.heartbeat_stale", at_hit=1)
    cs = ClusterSupervisor(2, command_fn, hb_dir, poll_s=0.05,
                           grace_s=0.5, restart_backoff_s=0.05,
                           max_restarts_per_worker=0,
                           startup_grace_s=60.0)
    with pytest.raises(RestartsExhaustedError) as ei:
        cs.run(timeout_s=60.0)
    assert ei.value.ledger[0]["reason"] == "heartbeat_stale(injected)"
    assert cs.quarantined == [0]
    for m in cs.members:
        assert not m.alive


def test_cluster_run_deadline_never_hangs(tmp_path):
    hb_dir = str(tmp_path / "hb")

    def command_fn(rank, nprocs, port, resume_step):
        return [sys.executable, "-c",
                _hb_writer_script(hb_dir, rank, loop=True)]

    cs = ClusterSupervisor(1, command_fn, hb_dir, poll_s=0.05,
                           grace_s=0.5, startup_grace_s=60.0)
    with pytest.raises(DeadlineExceededError):
        cs.run(timeout_s=1.5)
    assert not cs.members[0].alive


def test_cluster_resume_step_scan_prefers_newest_valid(tmp_path):
    ck = tmp_path / "ckpt"
    ck.mkdir()
    for step, payload in ((2, b"x" * 64), (4, b"y" * 64)):
        p = ck / f"step-{step:08d}.npz"
        p.write_bytes(payload)
        record_checksum(str(ck), p.name, sha256_file(str(p)), 64,
                        extra={"step": step})
    cs = ClusterSupervisor(1, lambda *a: ["true"], str(tmp_path / "hb"),
                           checkpoint_dir=str(ck))
    assert cs._resume_step() == 4
    (ck / "step-00000004.npz").write_bytes(b"y" * 32)
    assert cs._resume_step() == 2
    cs_none = ClusterSupervisor(1, lambda *a: ["true"],
                                str(tmp_path / "hb2"))
    assert cs_none._resume_step() == 0


# ========================================= world-size-1 hard-hang drills
def _worker_run(out, wedge_window=0, hang_exit_after=2,
                lease_timeout_s=30.0):
    """One supervised run of the port worker (an 8-step MLP fit through
    TrainingMaster(steps_per_dispatch=2, checkpoint_every=2) under the
    heartbeat watchdog, timeout 1 s); returns (stats, final arrays)."""
    hb_dir = os.path.join(out, "hb")

    def command_fn(rank, nprocs, port, resume_step):
        return [sys.executable, WORKER, out, str(resume_step),
                "--hb", heartbeat_path(hb_dir, rank),
                "--wedge-window", str(wedge_window),
                "--hang-exit-after", str(hang_exit_after)]

    env = dict(os.environ)
    env.pop("DL4J_TPU_FAULTS", None)
    cs = ClusterSupervisor(1, command_fn, hb_dir,
                           checkpoint_dir=os.path.join(out, "ckpt"),
                           lease_timeout_s=lease_timeout_s,
                           startup_grace_s=60.0, poll_s=0.1, grace_s=1.0,
                           restart_backoff_s=0.05, env=env)
    stats = cs.run(timeout_s=90.0)
    with np.load(os.path.join(out, "final.npz")) as z:
        final = {k: z[k] for k in z.files}
    return stats, final


@pytest.fixture(scope="module")
def unfaulted(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("oracle"))
    stats, final = _worker_run(out)
    assert stats["gang_restarts"] == 0 and stats["generations"] == 1
    return final


@pytest.mark.parametrize("escalation", ["hang_exit", "stale_lease"])
def test_worker_hard_hang_relaunched_bit_for_bit(tmp_path, unfaulted,
                                                 escalation):
    """The first generation wedges at its third window (after the
    checkpoints of steps 2 and 4) inside `train.hang_hard` (SIGUSR1 and
    SIGTERM blocked). hang_exit: the watchdog marks the lease and exits
    EXIT_HANG after two silent detections; stale_lease: with the exit
    out of reach, the supervisor finds the lease stale, SIGTERMs (held)
    and SIGKILLs. Either way the gang relaunches from step 4 and ends
    bit for bit where the unfaulted run ends."""
    out = str(tmp_path)
    if escalation == "hang_exit":
        stats, final = _worker_run(out, wedge_window=3, hang_exit_after=2)
        reasons = ("hang_hard", "hang_marker")
        with open(os.path.join(out, "watchdog-0.log")) as f:
            log = f.read()
        assert "marking heartbeat and exiting 86" in log
    else:
        # the lease's margin over a healthy worker's longest silence:
        # whole gen-4 fits took up to 0.65 s (~0.3 s between beats) with
        # six OpenMP-bound torch processes loading the host
        stats, final = _worker_run(out, wedge_window=3,
                                   hang_exit_after=10 ** 6,
                                   lease_timeout_s=6.0)
        reasons = ("heartbeat_stale",)
    assert stats["gang_restarts"] == 1 and stats["generations"] == 2
    (entry,) = stats["ledger"]
    assert entry["reason"] in reasons and entry["resume_step"] == 4
    assert stats["resume_steps"] == [4]
    with open(os.path.join(out, "gen-4.json")) as f:
        gen = json.load(f)
    assert gen["steps_run"] == 4 and gen["iteration"] == 8
    assert not os.path.exists(os.path.join(out, "gen-0.json"))
    assert sorted(final) == sorted(unfaulted)
    for k in unfaulted:
        np.testing.assert_array_equal(final[k], unfaulted[k], err_msg=k)


def test_watchdog_beat_between_detections_resets_the_count(tmp_path):
    """A beat between two detections means the soft escalation landed:
    the consecutive count starts over and nothing exits."""
    from deeplearning4j_tpu_torch.resilience import supervisor as sup

    exits = []
    orig_exit = sup.os._exit
    sup.os._exit = exits.append
    try:
        wd = StepWatchdog(timeout_s=0.15, poll_s=0.03,
                          on_hang=lambda phase, age: None,
                          heartbeat=HeartbeatFile(str(tmp_path / "h.json")),
                          hang_exit_after=2)
        with wd:
            t0 = time.monotonic()
            while wd.stats()["hangs_detected"] < 4 \
                    and time.monotonic() - t0 < 10.0:
                n = wd.stats()["hangs_detected"]
                while wd.stats()["hangs_detected"] == n \
                        and time.monotonic() - t0 < 10.0:
                    time.sleep(0.01)
                wd.beat("fetch")
    finally:
        sup.os._exit = orig_exit
    assert wd.stats()["hangs_detected"] >= 4 and exits == []


# ================================================= stats surfacing
def test_cluster_stats_shape(tmp_path):
    cs = ClusterSupervisor(3, lambda *a: ["true"], str(tmp_path), spares=2)
    stats = cs.stats()
    assert stats["nprocs"] == 3
    assert stats["world_size"] == 3
    assert stats["gang_restarts"] == 0
    assert stats["per_worker_restarts"] == {}
    assert stats["quarantined"] == [] and stats["ledger"] == []
    assert stats["quarantined_slots"] == [] and stats["slot_ledger"] == []
    assert stats["spares_left"] == 2
    assert stats["spare_reschedules"] == 0 and stats["shrinks"] == 0
    assert stats["slots"] == {0: 0, 1: 1, 2: 2}
    assert stats["quorum_reports"] == []
    # the sharded (ZeRO-1) quorum is ported: the flag selects it
    sharded = ClusterSupervisor(2, lambda *a: ["true"], str(tmp_path),
                                per_rank_checkpoints=True,
                                sharded_optimizer=True)
    assert sharded.sharded_optimizer and sharded.per_rank_checkpoints


def _rank_registry(steps, seconds):
    r = MetricsRegistry()
    for _ in range(steps):
        r.inc("dl4j_train_steps_total")
        r.observe("dl4j_train_step_seconds", seconds)
    r.set_gauge("dl4j_cluster_world_size", 2)
    return r


def test_cluster_supervisor_fleet_metrics(tmp_path):
    """The supervisor's pull path: per-rank dumps in the heartbeat dir
    merge into one fleet view (no workers spawned); a JAX rank's dump
    merges with a port rank's."""
    from deeplearning4j_tpu.observability import perf as jperf
    from deeplearning4j_tpu.observability.metrics import (
        MetricsRegistry as JRegistry,
    )

    sup = ClusterSupervisor(nprocs=2, command_fn=lambda *a: ["true"],
                            heartbeat_dir=str(tmp_path))
    assert sup.fleet_metrics() is None
    dump_snapshot(os.path.join(str(tmp_path), "metrics-rank0.json"),
                  registry=_rank_registry(6, 0.002), rank=0)
    jr = JRegistry()
    for _ in range(6):
        jr.inc("dl4j_train_steps_total")
    jperf.dump_snapshot(os.path.join(str(tmp_path), "metrics-rank1.json"),
                        registry=jr, rank=1)
    fleet = sup.fleet_metrics()
    assert fleet["ranks"] == 2
    assert fleet["snapshot"]["counters"][
        "dl4j_train_steps_total"][""] == 12
    assert "dl4j_train_steps_total 12" in fleet["prometheus"]
    assert sup.stats()["fleet_metric_ranks"] == 2
    assert get_registry() is not None
