"""The port's cluster supervision at world > 1 (deeplearning4j_tpu_torch/
resilience/cluster.py): gangs of tests/fixtures/torch/gang_worker.py
(the port's TrainingMaster over a gloo group; it imports only the port)
under the port's ClusterSupervisor.

Tier-1 (fast): the collateral-death rule. A worker that dies because a
PEER died (its collective failed: the peer-lost marker, no traceback) is
recorded `"collateral": True` and not charged; with no primary fault
among the gang's faults every member is charged. Once with trivial
workers (deterministic), once with a real 2-rank gang whose rank 1
crashes on an injected `train.step` fault while rank 0 waits in the
step's all-reduce.

The seven gang drills of the JAX package's tests/test_cluster.py:574-893
(SIGKILL, uninterruptible hang, the watchdog's exit code, spare
reschedule, shrink 3 -> 2 with and without the sharded optimizer, the
divergent-checkpoint heal) are marked slow and chaos, as the JAX package
marks them: `python -m pytest tests/test_torch_cluster_gang.py -m slow`.
Parity bar: a relaunched gang replays the identical data stream from the
shared resume step, so its final params equal the unfaulted run's to
rtol 1e-6 / atol 1e-7 (the JAX drills' bar).
"""

import os
import shutil
import signal
import sys
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observability.metrics import get_registry
from deeplearning4j_tpu_torch.resilience import (
    EXIT_PEER_LOST,
    PEER_LOST_MARKER,
    ClusterSupervisor,
    HeartbeatFile,
    heartbeat_path,
    is_peer_loss,
    reap_stray_workers,
)
from deeplearning4j_tpu_torch.resilience.checkpoint_integrity import (
    compute_state_digest,
    list_all_checkpoints,
    rank_checkpoint_dir,
    record_checksum,
    sha256_file,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(REPO, "tests", "fixtures", "torch", "gang_worker.py")


@pytest.fixture(autouse=True)
def _reap_port_workers():
    yield
    reap_stray_workers()


def _worker_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("DL4J_TPU_FAULTS", None)
    env["PYTHONPATH"] = REPO
    return env


def _gang_cmd_fn(steps, out_dir, hb_dir, hang_timeout=0.0, extra=()):
    def command_fn(rank, nprocs, port, resume_step):
        ht = (hang_timeout(rank) if callable(hang_timeout)
              else hang_timeout)
        return [sys.executable, WORKER, str(rank), str(nprocs), str(port),
                str(steps), out_dir, "--checkpoint-every", "1",
                "--cluster", "--heartbeat-dir", hb_dir,
                "--resume-step", str(resume_step),
                "--hang-timeout", str(ht), *extra]
    return command_fn


def _gang_supervisor(out, steps=6, hang_timeout=0.0, extra=(), nprocs=2,
                     **kw):
    hb_dir = os.path.join(out, "hb")
    kw.setdefault("lease_timeout_s", 120.0)
    kw.setdefault("startup_grace_s", 240.0)
    kw.setdefault("poll_s", 0.2)
    kw.setdefault("restart_backoff_s", 0.2)
    kw.setdefault("env", _worker_env())
    return ClusterSupervisor(
        nprocs, _gang_cmd_fn(steps, out, hb_dir, hang_timeout, extra),
        hb_dir, checkpoint_dir=os.path.join(out, "ckpt"), **kw)


def _final(out):
    data = np.load(os.path.join(out, "final_params.npz"))
    return ([data[k] for k in data.files if k.startswith("arr_")],
            int(data["iteration"]))


def _final_world(out):
    return int(np.load(os.path.join(out, "final_params.npz"))["world"])


def _assert_parity(out, oracle):
    got, iteration = _final(out)
    ref, ref_iter = oracle
    assert iteration == ref_iter
    assert len(got) == len(ref)
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-7)


def _one_shot_fault_env(spec, target_rank=0):
    """Arm a DL4J_TPU_FAULTS spec on `target_rank` of the FIRST
    generation only: one fault means one gang restart."""
    launches = {"n": 0}

    def env_fn(rank):
        if rank == target_rank:
            launches["n"] += 1
            if launches["n"] == 1:
                return {"DL4J_TPU_FAULTS": spec}
        return {}

    return env_fn


# ==================================== the collateral-death rule (fast)
def _trivial_cmd_fn(hb_dir, flag, first_gen):
    """Trivial ranks: in the first generation each rank renews its lease,
    waits until both have (a file barrier, so the two die within
    milliseconds of each other whatever their start-up took: the
    supervisor sees both deaths in one poll), and runs `first_gen[r]`
    (python lines); later generations renew the lease and exit 0."""
    def command_fn(rank, nprocs, port, resume_step):
        ready = os.path.join(hb_dir, "ready-%d")
        body = (f"import os, sys, time\nsys.path.insert(0, {REPO!r})\n"
                "from deeplearning4j_tpu_torch.resilience.cluster import (\n"
                "    HeartbeatFile, heartbeat_path, exit_peer_lost)\n"
                f"hb = HeartbeatFile(heartbeat_path({hb_dir!r}, {rank}))\n"
                "hb.write(step=1, force=True)\n"
                f"if os.path.exists({flag!r}):\n"
                "    hb.mark('done')\n    sys.exit(0)\n"
                f"open({ready!r} % {rank}, 'w').close()\n"
                f"while not all(os.path.exists({ready!r} % r)"
                " for r in (0, 1)):\n    time.sleep(0.005)\n"
                + first_gen[rank])
        return [sys.executable, "-c", body]
    return command_fn


# the primary prints its own traceback and exits at once, as the gang
# worker does (an interpreter's teardown could outlast a poll)
_PRIMARY = ("open(%r, 'w').close()\nimport traceback\ntry:\n"
            "    raise RuntimeError('own error')\nexcept RuntimeError:\n"
            "    traceback.print_exc()\n    sys.stderr.flush()\n"
            "    os._exit(1)\n")
_COLLATERAL = "exit_peer_lost(RuntimeError('Connection closed by peer'))\n"


@pytest.mark.parametrize("case", ["one_primary", "no_primary"])
def test_collateral_death_is_recorded_and_not_charged(tmp_path, case):
    """Rank 1 dies on its own error (a traceback); rank 0 exits with the
    peer-lost marker and EXIT_PEER_LOST. Both are in the ledger; only
    rank 1 is charged. With both dying on the marker no primary can be
    found, and both are charged."""
    hb_dir, flag = str(tmp_path / "hb"), str(tmp_path / "gen1")
    first = ([_COLLATERAL, _PRIMARY % flag] if case == "one_primary"
             else [_COLLATERAL, "open(%r, 'w').close()\n" % flag
                   + _COLLATERAL])
    cs = ClusterSupervisor(2, _trivial_cmd_fn(hb_dir, flag, first), hb_dir,
                           poll_s=2.0, grace_s=0.5, restart_backoff_s=0.05,
                           startup_grace_s=60.0, max_restarts_per_worker=3,
                           env=_worker_env())
    stats = cs.run(timeout_s=60.0)
    assert stats["gang_restarts"] == 1 and stats["generations"] == 2
    ledger = {e["worker"]: e for e in stats["ledger"]}
    assert sorted(ledger) == [0, 1]
    assert ledger[0]["reason"] == "crash"
    if case == "one_primary":
        assert ledger[0]["collateral"] is True
        assert ledger[0]["worker_restarts"] == 0
        assert ledger[1]["collateral"] is False
        assert ledger[1]["worker_restarts"] == 1
    else:
        assert [ledger[r]["collateral"] for r in (0, 1)] == [False, False]
        assert [ledger[r]["worker_restarts"] for r in (0, 1)] == [1, 1]
    first_log = cs.members[0].log_path.replace(".gen1.", ".gen0.")
    with open(first_log) as f:
        assert f.read().strip().endswith(
            f"{PEER_LOST_MARKER} (Connection closed by peer)")


def test_peer_loss_errors_are_recognized():
    gloo = RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection "
        "closed by peer [127.0.0.1]:22411. This is typically caused by a "
        "remote worker crashing.")
    assert is_peer_loss(gloo)
    assert is_peer_loss(ConnectionResetError("Connection reset by peer"))
    assert not is_peer_loss(RuntimeError("CUDA out of memory"))
    assert not is_peer_loss(ValueError("connection closed by peer"))
    assert EXIT_PEER_LOST == 88


def test_real_gang_peer_of_a_crashed_rank_dies_collateral(tmp_path):
    """A 2-rank gloo gang: rank 1 raises at its third step (a traceback,
    primary); rank 0, inside the step's gradient all-reduce, sees the
    connection close within milliseconds, prints the marker and exits
    EXIT_PEER_LOST. The relaunched gang resumes from the newest checkpoint
    and finishes. Rank 0's death is in the ledger when a poll sees both
    deaths (all but a poll landing in those milliseconds): then it is
    collateral and free."""
    out = str(tmp_path)
    cs = _gang_supervisor(
        out, steps=4, poll_s=1.0, max_restarts_per_worker=1,
        env_fn=_one_shot_fault_env("train.step:raise@3", target_rank=1))
    stats = cs.run(timeout_s=120.0)
    assert stats["gang_restarts"] == 1
    ledger = {e["worker"]: e for e in stats["ledger"]}
    assert ledger[1]["reason"] == "crash" and not ledger[1]["collateral"]
    assert ledger[1]["worker_restarts"] == 1
    if 0 in ledger:
        assert ledger[0]["collateral"] is True
        assert ledger[0]["worker_restarts"] == 0
        log0 = cs.members[0].log_path.replace(".gen1.", ".gen0.")
        with open(log0) as f:
            assert PEER_LOST_MARKER in f.read()
    assert stats["resume_steps"] == [2]
    assert _final(out)[1] == 4


# ====================================== the gang drills (slow, chaos)
@pytest.fixture(scope="module")
def gang_oracle(tmp_path_factory):
    """Un-faulted 2-rank gang run: the parity reference of the drills."""
    out = str(tmp_path_factory.mktemp("gang_oracle"))
    stats = _gang_supervisor(out).run(timeout_s=280.0)
    assert stats["gang_restarts"] == 0
    return _final(out)


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_gang_restart_after_worker_sigkill(tmp_path_factory,
                                                   gang_oracle):
    """One worker SIGKILLed mid-step (from outside, via the pid in its own
    lease): the supervisor detects the death, kills the survivor (or
    records its collateral exit), relaunches the gang from the newest
    common checkpoint, and the final params match the oracle."""
    out = str(tmp_path_factory.mktemp("gang_kill"))
    cs = _gang_supervisor(out, extra=("--spin-ms", "250"),
                          max_restarts_per_worker=2)
    hb_dir = os.path.join(out, "hb")
    killed = {}

    def killer():
        while not killed:
            rec = HeartbeatFile.read(heartbeat_path(hb_dir, 1))
            if (rec and rec.get("status") == "running"
                    and (rec.get("step") or 0) >= 2):
                try:
                    os.kill(rec["pid"], signal.SIGKILL)
                    killed["pid"] = rec["pid"]
                except ProcessLookupError:
                    pass
                return
            time.sleep(0.05)

    th = threading.Thread(target=killer, daemon=True)
    th.start()
    stats = cs.run(timeout_s=280.0)
    th.join(timeout=5.0)
    assert killed, "chaos killer never fired"
    assert stats["gang_restarts"] == 1
    assert any(e["worker"] == 1 and e["reason"] == "killed:sig9"
               and not e["collateral"] for e in stats["ledger"])
    assert all(e["collateral"] for e in stats["ledger"] if e["worker"] == 0)
    assert stats["resume_steps"] and stats["resume_steps"][0] >= 1
    _assert_parity(out, gang_oracle)


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_gang_restart_after_uninterruptible_hang(
        tmp_path_factory, gang_oracle):
    """Rank 0 wedges in a SIGUSR1+SIGTERM-immune sleep (`train.hang_hard`)
    with no in-process escalation: only the stale lease shows it; SIGKILL
    lands, the gang relaunches and the final params match the oracle."""
    out = str(tmp_path_factory.mktemp("gang_hang"))
    cs = _gang_supervisor(
        out, hang_timeout=0.0, lease_timeout_s=15.0, poll_s=0.3,
        grace_s=1.0, max_restarts_per_worker=3,
        env_fn=_one_shot_fault_env("train.hang_hard:delay@3~120.0"))
    stats = cs.run(timeout_s=280.0)
    assert stats["gang_restarts"] == 1
    reasons = {e["worker"]: e["reason"] for e in stats["ledger"]}
    assert "heartbeat_stale" in reasons[0]
    _assert_parity(out, gang_oracle)


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_hard_hang_watchdog_exit_code(tmp_path_factory,
                                              gang_oracle):
    """With a heartbeat-attached StepWatchdog the monitor thread sees its
    SIGUSR1 never landed, writes the hang marker and exits EXIT_HANG: the
    supervisor relaunches without waiting out the lease."""
    out = str(tmp_path_factory.mktemp("gang_wd_exit"))
    cs = _gang_supervisor(
        out, hang_timeout=lambda rank: 4.0 if rank == 0 else 0.0,
        lease_timeout_s=120.0, grace_s=1.0, max_restarts_per_worker=3,
        env_fn=_one_shot_fault_env("train.hang_hard:delay@3~120.0"))
    stats = cs.run(timeout_s=280.0)
    assert stats["gang_restarts"] == 1
    assert any(e["worker"] == 0
               and e["reason"] in ("hang_hard", "hang_marker")
               for e in stats["ledger"])
    hb = HeartbeatFile.read(heartbeat_path(os.path.join(out, "hb"), 0))
    assert hb["status"] == "done"
    _assert_parity(out, gang_oracle)


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_spare_reschedule_gang(tmp_path_factory, gang_oracle):
    """Rank 1 crashes on an injected `train.step` fault with a zero
    restart budget — quarantined at once — and its rank is rescheduled
    onto the spare slot; the relaunched gang resumes and matches the
    oracle."""
    out = str(tmp_path_factory.mktemp("gang_spare"))
    cs = _gang_supervisor(
        out, max_restarts_per_worker=0, spares=1,
        env_fn=_one_shot_fault_env("train.step:raise@3", target_rank=1))
    stats = cs.run(timeout_s=280.0)
    assert stats["gang_restarts"] == 1
    assert stats["spare_reschedules"] == 1
    assert stats["quarantined"] == [1]
    assert stats["quarantined_slots"] == [1]
    assert stats["slots"][1] == 2
    assert [e["event"] for e in stats["slot_ledger"]] == \
        ["quarantined", "rescheduled"]
    assert stats["resume_steps"] and stats["resume_steps"][0] >= 1
    assert stats["world_size"] == 2
    assert _final_world(out) == 2
    _assert_parity(out, gang_oracle)


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_shrink_3_to_2_mid_run(tmp_path_factory):
    """A 3-rank gang loses rank 2 for good (no spares, zero budget) and
    SHRINKS to 2: the relaunched ranks take world size 2 through the
    resume handshake. The shrunk run's final params equal a NATIVE 2-rank
    gang resumed from the same checkpoint."""
    out = str(tmp_path_factory.mktemp("gang_shrink"))
    cs = _gang_supervisor(
        out, nprocs=3, max_restarts_per_worker=0, allow_shrink=True,
        min_workers=2,
        env_fn=_one_shot_fault_env("train.step:raise@3", target_rank=2))
    stats = cs.run(timeout_s=280.0)
    assert stats["shrinks"] == 1
    assert stats["world_size"] == 2
    assert stats["quarantined_slots"] == [2]
    assert ("retired_shrink", 2) in [
        (e["event"], e["slot"]) for e in stats["slot_ledger"]]
    s = stats["resume_steps"][-1]
    assert s >= 1
    assert _final_world(out) == 2
    assert get_registry().gauge_value("dl4j_cluster_world_size") == 2

    oracle_out = str(tmp_path_factory.mktemp("gang_shrink_oracle"))
    oracle_ckpt = os.path.join(oracle_out, "ckpt")
    shutil.copytree(os.path.join(out, "ckpt"), oracle_ckpt)
    for step, fn in list_all_checkpoints(oracle_ckpt):
        if step > s:
            os.remove(os.path.join(oracle_ckpt, fn))
    ostats = _gang_supervisor(oracle_out, nprocs=2).run(timeout_s=280.0)
    assert ostats["gang_restarts"] == 0
    assert _final_world(oracle_out) == 2
    _assert_parity(out, _final(oracle_out))


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_shrink_3_to_2_with_sharded_optimizer(tmp_path_factory):
    """The 3 -> 2 shrink with ZeRO-1 sharded optimizer state: every rank
    checkpoints its slice beside the quorum-voted main copy; the sharded
    quorum votes over the save-time world, and the relaunched ranks
    reassemble the three slices and re-slice them for two. Final params
    equal a NATIVE 2-rank zero1 gang resumed from the same checkpoint."""
    out = str(tmp_path_factory.mktemp("gang_shrink_z1"))
    extra = ("--per-rank-ckpt", "--zero1")
    cs = _gang_supervisor(
        out, nprocs=3, max_restarts_per_worker=0, allow_shrink=True,
        min_workers=2, extra=extra, per_rank_checkpoints=True,
        sharded_optimizer=True,
        env_fn=_one_shot_fault_env("train.step:raise@3", target_rank=2))
    stats = cs.run(timeout_s=280.0)
    assert stats["shrinks"] == 1
    assert stats["world_size"] == 2
    s = stats["resume_steps"][-1]
    assert s >= 1
    assert _final_world(out) == 2
    report = cs.quorum_reports[-1]
    assert report["shard_world"] == 3
    assert sorted(report["slices"]) == [0, 1, 2]
    for r in range(3):
        fns = os.listdir(rank_checkpoint_dir(os.path.join(out, "ckpt"), r))
        assert any(fn.endswith(".updshard.npz") for fn in fns)

    oracle_out = str(tmp_path_factory.mktemp("gang_shrink_z1_oracle"))
    oracle_ckpt = os.path.join(oracle_out, "ckpt")
    shutil.copytree(os.path.join(out, "ckpt"), oracle_ckpt)
    for r in range(3):
        d = rank_checkpoint_dir(oracle_ckpt, r)
        for step, fn in list_all_checkpoints(d):
            if step > s:
                os.remove(os.path.join(d, fn))
                side = os.path.join(d, f"step-{step:08d}.updshard.npz")
                if os.path.exists(side):
                    os.remove(side)
    ostats = _gang_supervisor(
        oracle_out, nprocs=2, extra=extra, per_rank_checkpoints=True,
        sharded_optimizer=True).run(timeout_s=280.0)
    assert ostats["gang_restarts"] == 0
    assert _final_world(oracle_out) == 2
    _assert_parity(out, _final(oracle_out))


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_divergent_checkpoint_healed_by_quorum(tmp_path_factory):
    """A deliberately perturbed rank-1 checkpoint (self-consistent file
    and manifest, wrong state) is OUT-VOTED by the 2-of-3 quorum on
    resume — quarantined aside, healed — and the resumed run matches an
    unfaulted oracle."""
    out = str(tmp_path_factory.mktemp("gang_quorum"))
    ckpt = os.path.join(out, "ckpt")
    extra = ("--per-rank-ckpt",)
    cs_a = _gang_supervisor(out, steps=4, nprocs=3, extra=extra,
                            per_rank_checkpoints=True)
    assert cs_a.run(timeout_s=280.0)["gang_restarts"] == 0

    d1 = rank_checkpoint_dir(ckpt, 1)
    fn = "step-00000004.npz"
    p1 = os.path.join(d1, fn)
    with np.load(p1) as z:
        payload = {k: np.array(z[k]) for k in z.files}
    first = sorted(k for k in payload if k.startswith("params"))[0]
    payload[first] = payload[first] + 1.0
    np.savez(p1, **payload)
    record_checksum(d1, fn, sha256_file(p1), os.path.getsize(p1),
                    extra={"step": 4,
                           "state_sha256": compute_state_digest(p1)})

    cs_b = _gang_supervisor(out, steps=7, nprocs=3, extra=extra,
                            per_rank_checkpoints=True)
    stats = cs_b.run(timeout_s=280.0)
    assert stats["gang_restarts"] == 0
    report = stats["quorum_reports"][0]
    assert report["step"] == 4 and report["healed"] == [1]
    aside = report["quarantined"][0]
    assert aside.endswith(".divergent") and os.path.exists(aside)
    finals = {compute_state_digest(os.path.join(
        rank_checkpoint_dir(ckpt, r), "step-00000007.npz"))
        for r in range(3)}
    assert len(finals) == 1
    oracle_out = str(tmp_path_factory.mktemp("gang_quorum_oracle"))
    cs_o = _gang_supervisor(oracle_out, steps=7, nprocs=3, extra=extra,
                            per_rank_checkpoints=True)
    assert cs_o.run(timeout_s=280.0)["gang_restarts"] == 0
    _assert_parity(out, _final(oracle_out))
