"""The port's cluster supervision, part 2 (part 1 is
tests/test_torch_cluster.py): the elastic gang — spare reschedule after
a quarantine, shrink-to-fit once the spares are dry, the
`dist.spare_exhausted` fault point and abort — and the per-rank
checkpoint divergence quorum (resilience/checkpoint_integrity.py:
`rank_checkpoint_dir`, `divergence_quorum`, `quorum_resume_step`),
ported from the JAX package's tier-1 tests of tests/test_cluster.py
with trivial workers and synthetic rank directories. The quorum is also
held against the JAX package's on the same directories, and its sharded
(ZeRO-1) form is held against the JAX package in
tests/test_torch_scaleout.py."""

import os
import shutil
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.resilience import checkpoint_integrity as jci
from deeplearning4j_tpu_torch.observability.metrics import get_registry
from deeplearning4j_tpu_torch.resilience import (
    CheckpointDivergenceError,
    ClusterSupervisor,
    FaultInjectedError,
    RestartsExhaustedError,
    compute_state_digest,
    divergence_quorum,
    injector,
    quorum_resume_step,
    rank_checkpoint_dir,
    reap_stray_workers,
    record_checksum,
    sha256_file,
    sharded_quorum_resume_step,
)
from deeplearning4j_tpu_torch.resilience.checkpoint_integrity import (
    _present_rank_dirs,
)
from test_torch_cluster import REPO, _hb_writer_script


@pytest.fixture(autouse=True)
def _reap_port_workers():
    yield
    reap_stray_workers()
    injector().clear()


def test_cluster_spare_reschedule_after_quarantine(tmp_path):
    """Tentpole: a worker that exhausts its restart budget is
    quarantined and its rank RESCHEDULED onto a spare slot — fresh
    workdir, same rank id, budget reset — and the gang completes
    instead of aborting. The per-slot ledger and the
    dl4j_cluster_spare_reschedules_total counter record the event."""
    hb_dir = str(tmp_path / "hb")
    marker = str(tmp_path / "crashed-once")
    reg = get_registry()
    resched0 = reg.counter_value("dl4j_cluster_spare_reschedules_total")

    def command_fn(rank, nprocs, port, resume_step):
        if rank == 0:
            # crash once (before the marker exists), then behave —
            # slot visibility via the DL4J_TPU_SLOT env the supervisor
            # sets (recorded into a slot-<n>.seen file)
            return [sys.executable, "-c", (
                "import os, sys, time\n"
                f"sys.path.insert(0, {REPO!r})\n"
                "slot = os.environ['DL4J_TPU_SLOT']\n"
                "slot_dir = os.environ['DL4J_TPU_SLOT_DIR']\n"
                "assert os.path.isdir(slot_dir), slot_dir\n"
                f"open(os.path.join({str(tmp_path)!r}, "
                "'slot-' + slot + '.seen'), 'w').close()\n"
                f"m = {marker!r}\n"
                "if not os.path.exists(m):\n"
                "    open(m, 'w').close(); sys.exit(3)\n"
                "from deeplearning4j_tpu_torch.resilience.cluster import (\n"
                "    HeartbeatFile, heartbeat_path)\n"
                f"hb = HeartbeatFile(heartbeat_path({hb_dir!r}, 0))\n"
                "hb.write(step=1, force=True)\n"
                "hb.mark('done')\n")]
        return [sys.executable, "-c",
                _hb_writer_script(hb_dir, rank, loop=False)]

    cs = ClusterSupervisor(2, command_fn, hb_dir, poll_s=0.05,
                           grace_s=0.5, restart_backoff_s=0.05,
                           max_restarts_per_worker=0, spares=1,
                           startup_grace_s=60.0)
    stats = cs.run(timeout_s=60.0)
    assert stats["spare_reschedules"] == 1
    assert stats["quarantined"] == [0]
    assert stats["quarantined_slots"] == [0]
    assert stats["spares_left"] == 0
    assert stats["slots"][0] == 2          # rank 0 now lives on slot 2
    events = [(e["event"], e["slot"], e["rank"])
              for e in stats["slot_ledger"]]
    assert events == [("quarantined", 0, 0), ("rescheduled", 2, 0)]
    # the rescheduled incarnation ran from the FRESH spare workdir
    assert os.path.exists(str(tmp_path / "slot-0.seen"))
    assert os.path.exists(str(tmp_path / "slot-2.seen"))
    assert os.path.isdir(os.path.join(hb_dir, "slot-2"))
    assert reg.counter_value("dl4j_cluster_spare_reschedules_total") \
        == resched0 + 1
    assert reg.gauge_value("dl4j_cluster_world_size") == 2


def test_cluster_shrink_to_fit_after_spares_dry(tmp_path):
    """Tentpole: with no spare left, `allow_shrink=True` relaunches the
    gang at reduced world size (floor min_workers) — the relaunched
    workers receive the NEW world size through command_fn's nprocs
    argument, and dl4j_cluster_world_size tracks the live gang."""
    hb_dir = str(tmp_path / "hb")
    launches = []
    reg = get_registry()
    shrinks0 = reg.counter_value("dl4j_cluster_shrinks_total")

    def command_fn(rank, nprocs, port, resume_step):
        launches.append((rank, nprocs))
        if nprocs == 3 and rank == 2:
            return [sys.executable, "-c", "import sys; sys.exit(3)"]
        return [sys.executable, "-c",
                _hb_writer_script(hb_dir, rank, loop=False)]

    cs = ClusterSupervisor(3, command_fn, hb_dir, poll_s=0.05,
                           grace_s=0.5, restart_backoff_s=0.05,
                           max_restarts_per_worker=0,
                           allow_shrink=True, min_workers=2,
                           startup_grace_s=60.0)
    stats = cs.run(timeout_s=60.0)
    assert stats["shrinks"] == 1
    assert stats["world_size"] == 2 and stats["nprocs"] == 2
    assert stats["quarantined_slots"] == [2]
    assert ("retired_shrink", 2, 2) in [
        (e["event"], e["slot"], e["rank"]) for e in stats["slot_ledger"]]
    # generation 0 launched 3 workers; generation 1 launched 2, and
    # every relaunched worker was told nprocs=2 (the resume handshake)
    assert [np for _, np in launches[:3]] == [3, 3, 3]
    assert [np for _, np in launches[3:]] == [2, 2]
    assert reg.counter_value("dl4j_cluster_shrinks_total") == shrinks0 + 1
    assert reg.gauge_value("dl4j_cluster_world_size") == 2
    # shrink below min_workers is refused: a 2-gang with min_workers=2
    # aborts instead of shrinking to 1
    hb2 = str(tmp_path / "hb2")

    def always_crash(rank, nprocs, port, resume_step):
        return [sys.executable, "-c", "import sys; sys.exit(3)"]

    cs2 = ClusterSupervisor(2, always_crash, hb2, poll_s=0.05,
                            grace_s=0.5, restart_backoff_s=0.05,
                            max_restarts_per_worker=0,
                            allow_shrink=True, min_workers=2,
                            startup_grace_s=60.0)
    with pytest.raises(RestartsExhaustedError) as ei:
        cs2.run(timeout_s=60.0)
    assert "min_workers" in str(ei.value)


def test_cluster_spare_exhausted_fault_point_and_abort(tmp_path):
    """`dist.spare_exhausted` fires exactly when a quarantined worker
    finds the spare pool dry: the drill arms it as a raise; unarmed,
    the same juncture aborts with RestartsExhaustedError whose ledger
    shows the reschedule that consumed the spare."""
    hb_dir = str(tmp_path / "hb")

    def always_crash(rank, nprocs, port, resume_step):
        return [sys.executable, "-c", "import sys; sys.exit(3)"]

    injector().inject("dist.spare_exhausted", at_hit=1)
    cs = ClusterSupervisor(1, always_crash, hb_dir, poll_s=0.05,
                           grace_s=0.5, restart_backoff_s=0.05,
                           max_restarts_per_worker=0, spares=1,
                           startup_grace_s=60.0)
    with pytest.raises(FaultInjectedError):
        cs.run(timeout_s=60.0)
    assert cs.spare_reschedules == 1   # the spare WAS consumed first
    injector().clear()

    cs2 = ClusterSupervisor(1, always_crash, str(tmp_path / "hb2"),
                            poll_s=0.05, grace_s=0.5,
                            restart_backoff_s=0.05,
                            max_restarts_per_worker=0, spares=1,
                            startup_grace_s=60.0)
    with pytest.raises(RestartsExhaustedError) as ei:
        cs2.run(timeout_s=60.0)
    assert cs2.spare_reschedules == 1
    assert "no spare left" in str(ei.value)
    assert cs2.quarantined_slots == [0, 1]
    for m in cs2.members:
        assert not m.alive


# ===================================== checkpoint divergence quorum
def _write_rank_ckpt(base, rank, step, val, iteration=0):
    """One rank's npz checkpoint copy + manifest entry (file sha AND
    the canonical state digest, like TrainingMaster records)."""
    d = rank_checkpoint_dir(str(base), rank)
    os.makedirs(d, exist_ok=True)
    fn = f"step-{step:08d}.npz"
    p = os.path.join(d, fn)
    np.savez(p, params=np.full(8, val, np.float32),
             rng=np.arange(4), iteration=np.asarray(iteration))
    record_checksum(d, fn, sha256_file(p), os.path.getsize(p),
                    extra={"step": step,
                           "state_sha256": compute_state_digest(p)})
    return p


def test_divergence_quorum_outvotes_and_heals_minority(tmp_path):
    """Tentpole: 2-of-3 ranks agree on step 3; the divergent rank-1
    copy is out-voted, quarantined ASIDE (renamed, never deleted) and
    replaced by the quorum copy — after healing all three rank copies
    hash identically."""
    for r in range(3):
        _write_rank_ckpt(tmp_path, r, 3, val=1.0)
    divergent = _write_rank_ckpt(tmp_path, 1, 3, val=99.0)  # the fork
    report = quorum_resume_step(str(tmp_path), 3)
    assert report["step"] == 3
    assert report["healed"] == [1]
    assert len(report["quarantined"]) == 1
    aside = report["quarantined"][0]
    assert aside.endswith(".divergent") and os.path.exists(aside)
    # the quarantined bytes ARE the divergent copy, preserved
    assert compute_state_digest(aside) != report["digest"]
    # post-heal: unanimous
    digests = {compute_state_digest(
        os.path.join(rank_checkpoint_dir(str(tmp_path), r),
                     "step-00000003.npz")) for r in range(3)}
    assert digests == {report["digest"]}
    # idempotent: a second quorum pass heals nothing
    again = divergence_quorum(str(tmp_path), 3, 3)
    assert again["healed"] == [] and again["quarantined"] == []
    assert divergent == os.path.join(
        rank_checkpoint_dir(str(tmp_path), 1), "step-00000003.npz")


def test_divergence_quorum_heals_missing_and_torn_ranks(tmp_path):
    """A rank whose copy is missing (crashed before the write) or torn
    (fails its own checksum) is a non-voter: quorum elects the healthy
    majority and copies the file in, so the shared resume handshake
    holds for EVERY relaunched rank."""
    for r in range(3):
        _write_rank_ckpt(tmp_path, r, 5, val=2.0)
    # rank 0: torn (truncate, keep stale manifest); rank 2: missing
    p0 = os.path.join(rank_checkpoint_dir(str(tmp_path), 0),
                      "step-00000005.npz")
    with open(p0, "r+b") as f:
        f.truncate(os.path.getsize(p0) // 2)
    os.remove(os.path.join(rank_checkpoint_dir(str(tmp_path), 2),
                           "step-00000005.npz"))
    report = divergence_quorum(str(tmp_path), 3, 5)
    # 1-of-3 valid votes is NOT a majority: no quorum at this step
    assert report["digest"] is None
    # with a second healthy rank the quorum elects and heals both
    _write_rank_ckpt(tmp_path, 2, 5, val=2.0)
    report = divergence_quorum(str(tmp_path), 3, 5)
    assert report["digest"] is not None
    assert report["healed"] == [0]
    assert divergence_quorum(str(tmp_path), 3, 5)["healed"] == []


def test_divergence_quorum_tie_fails_loudly(tmp_path):
    """No-quorum tie (1v1 across 2 ranks): CheckpointDivergenceError
    carries the step and the vote map — resume never silently elects
    an arbitrary fork."""
    _write_rank_ckpt(tmp_path, 0, 4, val=1.0)
    _write_rank_ckpt(tmp_path, 1, 4, val=2.0)
    with pytest.raises(CheckpointDivergenceError) as ei:
        quorum_resume_step(str(tmp_path), 2)
    assert ei.value.step == 4
    assert len(ei.value.votes) == 2
    assert sorted(sum(ei.value.votes.values(), [])) == [0, 1]


def test_quorum_resume_skips_minority_newest_step(tmp_path):
    """A newest step held by only a minority of ranks (the gang died
    mid-checkpoint-cadence) elects nothing; the scan falls back to the
    newest step with a real quorum — the per-rank analogue of the
    newest-common-valid scan."""
    for r in range(3):
        _write_rank_ckpt(tmp_path, r, 2, val=1.0)
    _write_rank_ckpt(tmp_path, 0, 6, val=3.0)   # only rank 0 got to 6
    report = quorum_resume_step(str(tmp_path), 3)
    assert report["step"] == 2
    # and the supervisor's handshake consumes exactly this scan
    cs = ClusterSupervisor(3, lambda *a: ["true"],
                           str(tmp_path / "hb"),
                           checkpoint_dir=str(tmp_path),
                           per_rank_checkpoints=True)
    assert cs._resume_step() == 2
    assert cs.quorum_reports and cs.quorum_reports[-1]["step"] == 2


@pytest.mark.parametrize("case", ["outvote", "minority_newest", "tie"])
def test_quorum_matches_the_jax_package(tmp_path, case):
    """The same rank directories elect the same step and digest, heal
    the same ranks, or raise the same divergence, in both packages
    (each on its own copy: healing renames files)."""
    vals = {"outvote": {0: 1.0, 1: 99.0, 2: 1.0},
            "minority_newest": {0: 1.0, 1: 1.0, 2: 1.0},
            "tie": {0: 1.0, 1: 2.0}}[case]
    src = tmp_path / "src"
    for r, v in vals.items():
        _write_rank_ckpt(src, r, 3, val=v)
    if case == "minority_newest":
        _write_rank_ckpt(src, 0, 7, val=5.0)
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    n = len(vals)
    if case == "tie":
        with pytest.raises(CheckpointDivergenceError) as ei:
            quorum_resume_step(str(tmp_path / "port"), n)
        with pytest.raises(jci.CheckpointDivergenceError) as ej:
            jci.quorum_resume_step(str(tmp_path / "jax"), n)
        assert (ei.value.step, ei.value.votes) \
            == (ej.value.step, ej.value.votes)
        return
    got = quorum_resume_step(str(tmp_path / "port"), n)
    want = jci.quorum_resume_step(str(tmp_path / "jax"), n)
    strip = lambda rep: {k: v for k, v in rep.items()
                         if k != "quarantined"}
    assert strip(got) == strip(want)
    assert [os.path.relpath(p, tmp_path / "port")
            for p in got["quarantined"]] \
        == [os.path.relpath(p, tmp_path / "jax")
            for p in want["quarantined"]]
    assert _present_rank_dirs(str(tmp_path / "port")) == list(range(n))


def test_sharded_quorum_waits_for_queue_9(tmp_path):
    # ported with ZeRO-1 (queue 9b): a directory without rank copies has
    # no step to resume; the sharded cases are in test_torch_scaleout.py
    assert sharded_quorum_resume_step(str(tmp_path), 2) is None
    os.makedirs(tmp_path / "rank-0")
    assert sharded_quorum_resume_step(str(tmp_path), 2) is None
