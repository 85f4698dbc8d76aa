"""The port's scale-out layers in one process (the multi-rank gang is
tests/test_torch_scaleout_gang.py): the numpy halves against the JAX
package's own functions on seeded shapes (ZeRO-1 slice arithmetic, the
partitioners, the DCN model), the mesh at world 1, the validations
against JAX's messages, local SGD and ZeRO-1 at world 1 on a gloo group
bit for bit against the plain and unsharded runs, the sharded quorum on
synthetic rank directories against the JAX package's, the MeshManager's
policy and metrics, and the engine-owned trainer programs.

A test that creates a process group destroys it in its fixture's
finalizer: the tests run many files per worker process, and a leaked
group would make later files' single-process TrainingMasters
distributed."""

import os
import shutil
import socket

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.engine import sharding as jsh
from deeplearning4j_tpu.parallel import dcn_model as jdcn
from deeplearning4j_tpu.parallel import repartition as jrep
from deeplearning4j_tpu.parallel.sharding import _tp_spec as j_tp_spec
from deeplearning4j_tpu.resilience import checkpoint_integrity as jci
from deeplearning4j_tpu_torch.engine import MeshManager, StepProgram
from deeplearning4j_tpu_torch.engine import sharding as tsh
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import get_registry
from deeplearning4j_tpu_torch.observability import metrics as tobs
from deeplearning4j_tpu_torch.parallel import (
    BalancedPartitioner,
    DcnLink,
    HashingBalancedPartitioner,
    LocalStepTrainer,
    MeshSpec,
    ParallelWrapper,
    StaleGradientTrainer,
    TrainingMaster,
    allreduce_ms,
    batch_sharding,
    collectives,
    crossover_report,
    dcn_sweep,
    make_mesh,
    param_shardings,
    replicated,
)
from deeplearning4j_tpu_torch.parallel.sharding import (
    _tp_spec,
    pad_batch_with_masks,
    shard_batch,
)
from deeplearning4j_tpu_torch.resilience import checkpoint_integrity as tci
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map

N_IN, ROWS = 24, 24


def _jnet(seed=7):
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import InputType
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("adam")
            .learning_rate(1e-2).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=N_IN))
            .layer(OutputLayer(n_out=N_IN, loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN))
            .build())
    return JMLN(conf).init()


_CONF = None


def _net():
    """tests/test_mesh.py's ZeRO-1 net in the port (its own seeded init)."""
    global _CONF
    if _CONF is None:
        _CONF = _jnet().conf.to_json()
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(_CONF),
                             device="cpu").init()


def _batch(step):
    rng = np.random.default_rng(500 + step)
    x = rng.normal(size=(ROWS, N_IN)).astype(np.float32)
    y = np.eye(N_IN, dtype=np.float32)[rng.integers(0, N_IN, ROWS)]
    return x, y


def _bitwise(a, b):
    for tree_a, tree_b in ((a.params, b.params),
                           (a.updater_states, b.updater_states),
                           (a.states, b.states)):
        la, lb = leaves(tree_a), leaves(tree_b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
    assert a.iteration == b.iteration


@pytest.fixture
def gloo1():
    """A world-1 gloo process group, destroyed in the finalizer."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    collectives.init_process_group(f"127.0.0.1:{port}", 1, 0,
                                   backend="gloo", device="cpu")
    try:
        yield collectives.dp_group()
    finally:
        collectives.destroy_process_group()
    assert not collectives.initialized()


@pytest.fixture(autouse=True)
def _no_group_leaks():
    assert not collectives.initialized()
    yield
    assert not collectives.initialized()


# ============================================ numpy halves against JAX
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zero1_slice_arithmetic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        shape = tuple(int(v) for v in rng.integers(0, 13, rng.integers(0, 4)))
        dp = int(rng.integers(1, 7))
        assert tsh.zero1_leaf_sharded(shape, dp) \
            == jsh.zero1_leaf_sharded(shape, dp)
    for world in (1, 2, 3, 4, 6):
        n = world * int(rng.integers(1, 5))
        full = rng.normal(size=(n, 3)).astype(np.float32)
        for r in range(world):
            assert tsh.slice_bounds(n, r, world) \
                == jsh.slice_bounds(n, r, world)
            np.testing.assert_array_equal(tsh.slice_rows(full, r, world),
                                          jsh.slice_rows(full, r, world))
        parts = {r: tsh.slice_rows(full, r, world) for r in range(world)}
        np.testing.assert_array_equal(tsh.assemble_rows(parts, world),
                                      jsh.assemble_rows(parts, world))
        for new in (1, 2, 3):
            if n % new == 0:
                for a, b in zip(tsh.reslice(full, new),
                                jsh.reslice(full, new)):
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="missing slice"):
        tsh.assemble_rows({0: full[:1]}, 2)
    with pytest.raises(ValueError):
        tsh.slice_bounds(10, 0, 3)


def test_tp_rule_matches_jax_shape_rule():
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh

    jmesh = jmake_mesh(dp=2, tp=2, devices=jax.devices("cpu")[:4])
    for shape in [(), (8,), (16,), (7,), (3, 4), (5, 3), (3, 3, 4, 6),
                  (3, 3, 5, 7)]:
        leaf = np.zeros(shape, np.float32)
        assert _tp_spec(shape, 2) == tuple(j_tp_spec("", leaf, jmesh, "tp"))


def test_partitioners_match_jax():
    for n_p, n_e in ((3, 10), (4, 4), (5, 17)):
        a, b = BalancedPartitioner(n_p, n_e), jrep.BalancedPartitioner(n_p,
                                                                       n_e)
        assert a.sizes == b.sizes
        assert [a.partition_of(i) for i in range(n_e)] \
            == [b.partition_of(i) for i in range(n_e)]
        assert [a.bounds(p) for p in range(n_p)] \
            == [b.bounds(p) for p in range(n_p)]
    keys = ["a"] * 40 + ["b"] * 40 + [("c", 1)] * 9
    np.testing.assert_array_equal(HashingBalancedPartitioner(4).assign(keys),
                                  jrep.HashingBalancedPartitioner(4)
                                  .assign(keys))
    with pytest.raises(IndexError):
        BalancedPartitioner(3, 10).partition_of(10)


def test_dcn_model_matches_jax():
    for params, step, n in ((25.6e6 * 4, 52.3, 8), (1e6, 5.0, 2),
                            (4e8, 120.0, 16)):
        assert crossover_report(params, step, n, compression_ratio=0.26) \
            == jdcn.crossover_report(params, step, n,
                                     compression_ratio=0.26)
        link = DcnLink(bandwidth_GBps=1.0)
        assert dcn_sweep(params, step, [2, 4, 8], link=link) \
            == jdcn.sweep(params, step, [2, 4, 8],
                          link=jdcn.DcnLink(bandwidth_GBps=1.0))
        assert allreduce_ms(params, n, DcnLink()) \
            == jdcn.allreduce_ms(params, n, jdcn.DcnLink())


# ====================================================== mesh at world 1
def test_mesh_spec_and_make_mesh_at_world_one():
    assert MeshSpec(dp=4, tp=2).total() == 8
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 1}
    assert make_mesh(dp=-1).shape["dp"] == 1
    assert mesh.world == 1 and mesh.rank == 0
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(dp=2)
    with pytest.raises(ValueError, match="at most one"):
        make_mesh(dp=-1, tp=-1)
    # every axis is ported; at world 1 a size of 2 is too many processes
    # (JAX's "only N available" error; tests/test_torch_tp.py at world 4)
    for axis in ("tp", "sp", "pp", "ep"):
        with pytest.raises(ValueError, match="mesh needs 2 processes"):
            make_mesh(**{axis: 2})
    assert replicated(mesh).replicated
    assert batch_sharding(mesh).spec == ("dp",)
    assert all(s.replicated for s in leaves(param_shardings(
        mesh, _net().params)))


def test_shard_batch_and_padding_match_jax_padding():
    from deeplearning4j_tpu.parallel.wrapper import _pad_batch_with_masks

    rng = np.random.default_rng(3)
    x = rng.normal(size=(13, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 13)]
    for dp in (1, 2, 4):
        for a, b in zip(pad_batch_with_masks(dp, x, y, None, None),
                        _pad_batch_with_masks(dp, x, y, None, None)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, np.asarray(b))
    mesh = make_mesh()
    assert shard_batch(mesh, (x, y))[0] is not None
    np.testing.assert_array_equal(shard_batch(mesh, x), x)


# ======================================= validations, JAX's messages
def test_zero1_validations():
    with pytest.raises(ValueError, match="averaging_frequency"):
        TrainingMaster(_net(), sharding="zero1", averaging_frequency=2)
    with pytest.raises(ValueError, match="npz"):
        TrainingMaster(_net(), sharding="zero1", checkpoint_format="orbax")
    with pytest.raises(ValueError, match="sharding"):
        TrainingMaster(_net(), sharding="zero2")
    with pytest.raises(NotImplementedError, match="tp"):
        ParallelWrapper(_net(), workers=4, tp=2, sharding="zero1")
    with pytest.raises(ValueError, match="averaging_frequency"):
        ParallelWrapper(_net(), sharding="zero1", averaging_frequency=2)
    with pytest.raises(ValueError, match="process group has 1"):
        ParallelWrapper(_net(), workers=4)


def test_threshold_compression_requires_local_sgd():
    with pytest.raises(ValueError, match="averaging_frequency > 1"):
        TrainingMaster(_net(), averaging_frequency=1,
                       threshold_compression=1e-3)
    with pytest.raises(ValueError, match="averaging_frequency > 1"):
        ParallelWrapper(_net(), threshold_compression=1e-3)


# ============================ world 1 on gloo, bit for bit within port
def test_zero1_at_world_one_equals_unsharded(gloo1):
    ref = _net()
    TrainingMaster(ref, steps_per_dispatch=4).fit(_batch, 8)
    net = _net()
    tm = TrainingMaster(net, sharding="zero1", steps_per_dispatch=4)
    tm.fit(_batch, 8)
    _bitwise(net, ref)
    assert tm.world_info() == {"processes": 1, "devices": 1, "dp": 1,
                               "sharding": "zero1",
                               "per_rank_checkpoints": False}
    # the policy shards nothing at dp 1: every leaf replicated
    facts = tm._mesh_mgr.memory_facts(net.updater_states)
    assert facts["replica_fraction"] == 1.0 and facts["dp"] == 1


def test_zero1_without_a_process_group_equals_unsharded():
    ref = _net()
    TrainingMaster(ref).fit(_batch, 5)
    net = _net()
    TrainingMaster(net, sharding="zero1").fit(_batch, 5)
    _bitwise(net, ref)


def test_local_sgd_at_world_one_equals_plain_steps(gloo1):
    batches = [_batch(s) for s in range(6)]
    ref = _net()
    ParallelWrapper(ref).fit(batches)
    net = _net()
    pw = ParallelWrapper(net, averaging_frequency=2)
    pw.fit(batches)
    _bitwise(net, ref)
    assert isinstance(pw._local_step, LocalStepTrainer)
    ref2 = _net()
    TrainingMaster(ref2).fit(_batch, 6)
    net2 = _net()
    tm = TrainingMaster(net2, averaging_frequency=3, guard_inner_steps=True)
    tm.fit(_batch, 6, collect_training_stats=True)
    _bitwise(net2, ref2)
    assert tm.training_stats()["wire"]["rendezvous"] == 0


def test_stale_gradient_trainer_at_world_one_is_the_delayed_oracle():
    """No group: the stale trainer equals plain SGD steps that apply the
    previous step's gradient (first step: nothing), then the flush."""
    from deeplearning4j_tpu_torch.nn.base_network import clip_grads

    batches = [_batch(s) for s in range(4)]
    net = _net()
    StaleGradientTrainer(net, make_mesh()).fit(batches)
    ref = _net()
    prev = None
    for x, y in batches + [(None, None)]:
        params, upd, states = ref._train_carry()
        sc = ref._step_scalars(ref.iteration)[0]
        g = prev
        if x is not None:
            grads, _, states, _ = ref._grads(params, states,
                                             ref._as_input(x),
                                             ref._as_input(y), None)
            prev = clip_grads(ref.conf, grads)
        if g is None:
            g = tree_map(torch.zeros_like, params)
        with torch.no_grad():
            params, upd = ref._apply_updates(params, upd, g, sc[0], sc[1])
        ref._set_train_carry((params, upd, states))
        if x is not None:
            ref.iteration += 1
    _bitwise(net, ref)


def test_early_stopping_zero1_matches_unsharded(gloo1):
    """EarlyStoppingTrainer(sharding="zero1") at world 1 against the
    unsharded trainer on the same batches: bit for bit, and the saver
    holds the whole updater state."""
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
    )

    batches = [_batch(s) for s in range(4)]
    nets = []
    for sharding in (None, "zero1"):
        net = _net()
        cfg = EarlyStoppingConfiguration(
            model_saver=InMemoryModelSaver(),
            epoch_termination_conditions=[MaxEpochsTerminationCondition(2)])
        res = EarlyStoppingTrainer(cfg, net, batches,
                                   sharding=sharding).fit()
        assert res.total_epochs == 2
        nets.append(net)
    _bitwise(nets[1], nets[0])
    with pytest.raises(ValueError, match="sharding"):
        EarlyStoppingTrainer(EarlyStoppingConfiguration(), _net(), batches,
                             sharding="zero3")


def test_zero1_checkpoint_roundtrip_and_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    TrainingMaster(_net(), checkpoint_dir=d, checkpoint_every=2,
                   sharding="zero1", keep_last=2).fit(_batch, 6)
    files = sorted(os.listdir(d))
    assert "step-00000006.updshard.npz" in files
    assert "step-00000002.npz" not in files
    assert "step-00000002.updshard.npz" not in files
    with np.load(os.path.join(d, "step-00000006.npz")) as z:
        assert int(z["shard_world"]) == 1
        assert np.asarray(z["upd_sharded_idx"]).size == 0
    resumed = _net()
    TrainingMaster(resumed, checkpoint_dir=d, checkpoint_every=2,
                   sharding="zero1", keep_last=2).fit(_batch, 8)
    ref = _net()
    TrainingMaster(ref, sharding="zero1").fit(_batch, 8)
    _bitwise(resumed, ref)
    # the JAX package reads the port's layout
    jnet = _jnet()
    from deeplearning4j_tpu.parallel.training_master import (
        TrainingMaster as JTM,
    )

    jtm = JTM(jnet, checkpoint_dir=d, sharding="zero1")
    assert jtm.load_latest_checkpoint() == 8
    for a, b in zip(leaves(resumed.updater_states),
                    jax.tree_util.tree_leaves(jnet.updater_states)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ================================= the sharded quorum, against JAX
def _rank_ckpt(base, step, seed, world=3):
    """tests/test_mesh.py's synthetic sharded rank set, built with the
    port's writers (identical main files, one slice sidecar per rank)."""
    rng = np.random.default_rng(seed)
    payload = {"params:0": rng.normal(size=(6, 4)).astype(np.float32),
               "states:0": np.zeros((2,), np.float32),
               "rng": np.arange(2, dtype=np.uint32),
               "step": np.asarray(step), "iteration": np.asarray(step),
               "epoch": np.asarray(0), "upd:1": np.ones((3,), np.float32),
               "upd_sharded_idx": np.asarray([0], np.int64),
               "shard_world": np.asarray(world)}
    full = rng.normal(size=(12, 4)).astype(np.float32)
    fn, side = tci.step_filename(step), tci.shard_sidecar_filename(step)
    for r in range(world):
        d = tci.rank_checkpoint_dir(base, r)
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, fn)
        with open(p, "wb") as f:
            np.savez(f, **payload)
        sha = tci.compute_state_digest(p)
        tci.record_checksum(d, fn, tci.sha256_file(p), os.path.getsize(p),
                            extra={"step": step, "state_sha256": sha})
        sp = os.path.join(d, side)
        with open(sp, "wb") as f:
            np.savez(f, shard_rank=np.asarray(r),
                     shard_world=np.asarray(world),
                     **{"slice:0": tsh.slice_rows(full, r, world)})
        tci.record_checksum(d, side, tci.sha256_file(sp),
                            os.path.getsize(sp),
                            extra={"step": step, "shard_rank": r,
                                   "shard_world": world,
                                   "main_state_sha256": sha})


def _fork_main(base, rank, step):
    d = tci.rank_checkpoint_dir(base, rank)
    fn = tci.step_filename(step)
    p = os.path.join(d, fn)
    with np.load(p) as z:
        forged = {k: np.asarray(z[k]) for k in z.files}
    forged["params:0"] = forged["params:0"] + 1.0
    with open(p, "wb") as f:
        np.savez(f, **forged)
    tci.record_checksum(d, fn, tci.sha256_file(p), os.path.getsize(p),
                        extra={"step": step,
                               "state_sha256": tci.compute_state_digest(p)})


def _fork_slice(base, rank, step, world=3):
    d = tci.rank_checkpoint_dir(base, rank)
    side = tci.shard_sidecar_filename(step)
    entry = tci.read_manifest(d)[side]
    tci.record_checksum(d, side, entry["sha256"], entry["size"],
                        extra={"step": step, "shard_rank": rank,
                               "shard_world": world,
                               "main_state_sha256": "f" * 64})


def _strip(report, base):
    out = dict(report)
    out["quarantined"] = [os.path.relpath(p, base)
                          for p in report["quarantined"]]
    if "slices" in out:
        out["slices"] = {int(r): os.path.relpath(p, base)
                         for r, p in report["slices"].items()}
    return out


@pytest.mark.parametrize("case", ["votes_replicated_not_slices",
                                  "forked_slice_falls_back",
                                  "missing_sidecar_falls_back",
                                  "save_world_after_shrink"])
def test_sharded_quorum_matches_the_jax_package(tmp_path, case):
    base = str(tmp_path / "port")
    _rank_ckpt(base, 2, seed=1)
    _rank_ckpt(base, 4, seed=2)
    nprocs, want_step = 3, 4
    if case == "votes_replicated_not_slices":
        _fork_main(base, 1, 4)
    elif case == "forked_slice_falls_back":
        _fork_slice(base, 1, 4)
        want_step = 2
    elif case == "missing_sidecar_falls_back":
        os.remove(os.path.join(tci.rank_checkpoint_dir(base, 2),
                               tci.shard_sidecar_filename(4)))
        want_step = 2
    else:
        nprocs = 2
    jbase = str(tmp_path / "jax")
    shutil.copytree(base, jbase)
    got = tci.sharded_quorum_resume_step(base, nprocs=nprocs)
    want = jci.sharded_quorum_resume_step(jbase, nprocs=nprocs)
    assert got["step"] == want_step and got["shard_world"] == 3
    assert sorted(got["slices"]) == [0, 1, 2]
    assert _strip(got, base) == _strip(want, jbase)
    if case == "votes_replicated_not_slices":
        assert got["healed"] == [1]
        d1 = tci.rank_checkpoint_dir(base, 1)
        assert tci.state_digest(d1, tci.step_filename(4)) == got["digest"]


def test_collect_sharded_slices_rejects_holes(tmp_path):
    base = str(tmp_path)
    _rank_ckpt(base, 2, seed=1)
    dirs = [tci.rank_checkpoint_dir(base, r) for r in range(3)]
    assert sorted(tci.collect_sharded_slices(dirs, 2)) == [0, 1, 2]
    assert tci.collect_sharded_slices(dirs[:2], 2) is not None
    assert tci.collect_sharded_slices(dirs, 2, expect_digest="0" * 64) \
        is None
    assert tci.collect_sharded_slices(dirs, 4) is None


# ================================================ MeshManager, metrics
def test_mesh_manager_derive_policy_and_facts(gloo1):
    mgr = MeshManager()
    assert mgr.dp == 1 and mgr.world_signature() == {
        "processes": 1, "devices": 1, "dp": 1}
    assert mgr.cache_token() == (1, 1, 1)
    assert mgr.leaf_spec(torch.zeros(4, 2)) == ()
    assert mgr.batch_sharding().spec == ("dp",)
    assert not mgr.refresh()
    tree = {"w": np.ones((8, 2), np.float32), "b": np.zeros(3, np.float32)}
    placed = mgr.shard_tree(tree)
    assert mgr.layout == [False, False]
    np.testing.assert_array_equal(mgr.gather_tree(placed)["w"], tree["w"])
    facts = mgr.memory_facts(placed)
    assert facts == {"full_bytes": 76, "replica_bytes": 76,
                     "replica_fraction": 1.0, "dp": 1}
    # a layout recorded at dp 2 (two ranks' slices of 4 rows each): the
    # facts count the full leaf, the rank holds half
    facts2 = mgr.memory_facts({"w": torch.ones(4, 2)}, layout=[True])
    assert facts2["full_bytes"] == 32 * mgr.dp
    assert facts2["replica_bytes"] == 32


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_tree_slices_each_leaf_by_its_own_shape(rank):
    """ROADMAP F12: a tree whose dict keys are not in sorted order (as a
    ResNet-50's layer names are) — each leaf is cut by its own shape at
    dp 2, the stem's 7-row kernel whole and the 4-row leaf to this
    rank's rows, and the recorded layout is in `leaves`' sorted order."""
    import types

    mgr = MeshManager()
    mgr._world["dp"] = 2
    mgr.mesh = types.SimpleNamespace(coords={"dp": rank},
                                     shape=mgr.mesh.shape)
    tree = {"stem": np.arange(21, dtype=np.float32).reshape(7, 3),
            "bn": np.arange(8, dtype=np.float32).reshape(4, 2)}
    placed = mgr.shard_tree(tree)
    assert mgr.layout == [True, False]
    np.testing.assert_array_equal(placed["stem"].numpy(), tree["stem"])
    np.testing.assert_array_equal(placed["bn"].numpy(),
                                  tree["bn"][2 * rank:2 * rank + 2])


def test_mesh_metrics_registered_and_emitted(gloo1):
    for name in ("dl4j_mesh_world_size", "dl4j_mesh_reshard_total",
                 "dl4j_mesh_allgather_seconds"):
        assert name in tobs.REGISTERED_METRICS
    reg = get_registry()
    mgr = MeshManager()
    assert reg.gauge_value("dl4j_mesh_world_size") == 1
    tree = mgr.shard_tree({"w": np.ones((8, 2), np.float32)})
    ag0 = reg.snapshot()["histograms"].get(
        "dl4j_mesh_allgather_seconds", {"count": 0})["count"]
    mgr.gather_tree(tree)
    assert reg.snapshot()["histograms"][
        "dl4j_mesh_allgather_seconds"]["count"] == ag0 + 1
    r0 = reg.counter_value("dl4j_mesh_reshard_total")
    out = mgr.reshard_tree(tree)
    assert reg.counter_value("dl4j_mesh_reshard_total") == r0 + 1
    assert torch.equal(out["w"], torch.ones(8, 2))
    assert mgr.reshards == 1


def test_dashboard_mesh_line():
    from deeplearning4j_tpu_torch.stats.dashboard import telemetry_lines

    tobs.set_gauge("dl4j_mesh_world_size", 3)
    tobs.count("dl4j_mesh_reshard_total")
    lines = telemetry_lines(get_registry().snapshot())
    mesh_lines = [ln for ln in lines if ln.startswith("mesh — ")]
    assert mesh_lines and "world 3" in mesh_lines[0]
    assert "reshards" in mesh_lines[0]


# ======================================= engine-owned trainer programs
def test_trainer_compilation_is_engine_owned():
    net = _net()
    prog = StepProgram(net)
    built = []

    def build(tk):
        built.append(tk)
        return lambda: None

    fn = prog.trainer_program("engine_local_sgd", build, 4, False, False)
    fn2 = prog.trainer_program(
        "engine_local_sgd",
        lambda tk: (_ for _ in ()).throw(AssertionError("rebuilt")),
        4, False, False)
    assert fn is fn2
    assert built and "engine_local_sgd" in built[0]
    key = ("engine_local_sgd", 4, False, False, prog._frozen_sig())
    assert net._jit_cache.policy(key) is not None
    mesh = make_mesh(dp=1)
    assert isinstance(LocalStepTrainer(net, mesh)._program, StepProgram)
    assert isinstance(StaleGradientTrainer(net, mesh)._program, StepProgram)


def test_initialize_distributed_joins_and_reports_the_world():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    TrainingMaster.initialize_distributed("127.0.0.1:1", 1, 0)  # no-op
    assert not collectives.initialized()
    collectives.init_process_group(f"tcp://127.0.0.1:{port}", 1, 0,
                                   device="cpu")
    try:
        assert collectives.backend() == "gloo"
        assert TrainingMaster.process_info() == (0, 1)
        with pytest.raises(RuntimeError, match="initialized already"):
            collectives.init_process_group(f"127.0.0.1:{port}", 1, 0,
                                           device="cpu")
        # the gloo group's reduce-scatter / all-gather (all-reduce based)
        flat = torch.arange(6, dtype=torch.float32)
        assert torch.equal(collectives.reduce_scatter(flat), flat)
        assert torch.equal(collectives.all_gather(flat), flat)
        x = torch.ones(3, requires_grad=True)
        y = collectives.dp_sum(x)
        (y * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
        assert torch.equal(x.grad, torch.tensor([1.0, 2.0, 3.0]))
    finally:
        collectives.destroy_process_group()
