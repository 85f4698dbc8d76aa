"""The port's data parallelism across processes: one 2-rank gloo gang
(tests/fixtures/torch/scaleout_worker.py, which imports only the port)
runs every scenario in sequence on the CPU, and the tests hold its
results against the port's own serial and unsharded runs and against the
JAX package on a `make_mesh(dp=2)` of the virtual CPU devices. One 3-rank
gang before it writes the ZeRO-1 checkpoint the 2-rank gang resumes (the
reshard from a larger world). Every net is dropout-free (the port's
dropout streams are per rank and cannot equal a JAX global-key draw).

Tolerances, stated per comparison:
  - bit for bit: ZeRO-1 against the unsharded 2-rank run (params and
    updater state), ZeRO-1 k=4 groups against k=1, a checkpoint resume
    against the uninterrupted run, every rank's params against rank 0's;
  - SERIAL_TOL (rtol 1e-5, atol 1e-5): per-step dp against the port's
    serial fit on the whole batch (BatchNorm statistics over the global
    batch), local SGD against the two-replica oracle;
  - JAX_TOL (rtol 1e-5, atol 1e-5): the port's gang against the JAX
    package's dp=2 programs on the same weights and batches (per-step
    dp, local SGD, the stale trainer, ZeRO-1; JAX's own zero1 bitwise
    pins fail on the JAX side, so it is a tolerance oracle here);
  - RESHARD_TOL (rtol 1e-5, atol 1e-6): a run resumed from a 3-rank
    save against the 2-rank run (three partial sums round differently
    from two).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JBN,
    ConvolutionLayer as JConv,
    DenseLayer as JDense,
    OutputLayer as JOut,
    SubsamplingLayer as JSub,
)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.training_master import (
    TrainingMaster as JTM,
)
from deeplearning4j_tpu.parallel.wrapper import StaleGradientTrainer as JStale
from deeplearning4j_tpu.resilience import checkpoint_integrity as jci
from deeplearning4j_tpu_torch.parallel import TrainingMaster
from deeplearning4j_tpu_torch.util.tree import leaves
from test_helpers import _mini_resnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch")
WORKER = os.path.join(FIXTURES, "scaleout_worker.py")
sys.path.insert(0, FIXTURES)
from scaleout_worker import Gang  # noqa: E402

SERIAL_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
RESHARD_TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the nets
def _mlp8(seed=7):
    """tests/test_parallel.py's net: dense tanh + softmax, SGD 0.1."""
    conf = (JNNC.Builder().seed(seed).updater("sgd").learning_rate(0.1)
            .activation("tanh").weight_init("xavier").list()
            .layer(JDense(n_out=16)).layer(JOut(n_out=4, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())
    return JMLN(conf).init()


def _conv(seed=3):
    """tests/test_parallel.py's conv + BatchNorm net."""
    conf = (JNNC.Builder().seed(seed).updater("sgd").learning_rate(0.05)
            .weight_init("xavier").list()
            .layer(JConv(kernel_size=(3, 3), n_out=4, activation="relu"))
            .layer(JBN())
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JOut(n_out=3, loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())
    return JMLN(conf).init()


def _adam24(seed=7):
    """tests/test_mesh.py's ZeRO-1 net (Adam, 24 wide)."""
    conf = (JNNC.Builder().seed(seed).updater("adam").learning_rate(1e-2)
            .activation("tanh").weight_init("xavier").list()
            .layer(JDense(n_out=24)).layer(JOut(n_out=24, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(24)).build())
    return JMLN(conf).init()


def _bnmlp():
    """tests/test_parallel.py's stale-trainer BatchNorm net."""
    conf = (JNNC.Builder().seed(7).updater("sgd").learning_rate(0.05)
            .activation("tanh").weight_init("xavier").list()
            .layer(JDense(n_out=8)).layer(JBN())
            .layer(JOut(n_out=4, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())
    return JMLN(conf).init()


def _dist():
    """tests/helpers/distributed_worker.py's net (5 features, 3 classes)."""
    conf = (JNNC.Builder().seed(7).updater("adam").learning_rate(1e-2)
            .activation("tanh").weight_init("xavier").list()
            .layer(JDense(n_out=16)).layer(JOut(n_out=3, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(5)).build())
    return JMLN(conf).init()


JNETS = {"mlp8": _mlp8, "conv": _conv, "adam24": _adam24,
         "bnmlp": _bnmlp, "dist": _dist,
         "mini": lambda: _mini_resnet("fused")}


def _data():
    rng = np.random.default_rng(16)
    onehot = lambda n, c: np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    d = {}
    x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    x[8:] = x[8:] * 3 + 1            # the two dp halves differ
    d["conv_x"], d["conv_y"] = x, onehot(16, 3)
    d["mlp_x"] = rng.normal(size=(64, 8)).astype(np.float32)
    d["mlp_y"] = onehot(64, 4)
    d["rag_x"] = rng.normal(size=(13, 8)).astype(np.float32)
    d["rag_y"] = onehot(13, 4)
    for key, n in (("lsgd", 4), ("thr1", 2)):
        d[f"{key}_x"] = rng.normal(size=(n, 16, 8)).astype(np.float32)
        d[f"{key}_y"] = np.stack([onehot(16, 4) for _ in range(n)])
    proj = rng.normal(size=(8, 4)).astype(np.float32)
    for key, n in (("thrw", 8), ("stale", 24)):
        xs = rng.normal(size=(n, 16, 8)).astype(np.float32)
        d[f"{key}_x"] = xs
        d[f"{key}_y"] = np.eye(4, dtype=np.float32)[np.argmax(xs @ proj, -1)]
    d["st1_x"] = rng.normal(size=(16, 8)).astype(np.float32)
    d["st1_y"] = onehot(16, 4)
    d["stbn_x"] = rng.normal(size=(4, 15, 8)).astype(np.float32)
    d["stbn_y"] = np.stack([onehot(15, 4) for _ in range(4)])
    zs = [np.random.default_rng(500 + s) for s in range(12)]
    d["z_x"] = np.stack([r.normal(size=(24, 24)).astype(np.float32)
                         for r in zs])
    d["z_y"] = np.stack([np.eye(24, dtype=np.float32)[r.integers(0, 24, 24)]
                         for r in zs])
    ds = [np.random.default_rng(1000 + s) for s in range(6)]
    d["dist_x"] = np.stack([r.normal(size=(32, 5)).astype(np.float32)
                            for r in ds])
    d["dist_y"] = np.stack([np.eye(3, dtype=np.float32)[r.integers(0, 3, 32)]
                            for r in ds])
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    x[4:] = x[4:] * 2 + 0.5
    d["mini_x"], d["mini_y"] = x, onehot(8, 5)
    return d


def _np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(io, world, only=""):
    """One gang of `world` ranks over `io`; raises with the ranks' logs
    when any rank fails."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.pop("JAX_PLATFORMS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(io, f"log-{world}-{r}.txt"), "w")
        logs.append(log)
        cmd = [sys.executable, WORKER, "--rank", str(r), "--world",
               str(world), "--port", str(port), "--io", io]
        if only:
            cmd += ["--only", only]
        procs.append(subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT, env=env))
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        text = "".join(open(os.path.join(io, f"log-{world}-{r}.txt")).read()
                       for r in range(world))
        raise AssertionError(f"gang of {world} failed {rcs}:\n{text}")


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The inputs (JAX-initialized nets, data), the 3-rank gang's save,
    then the 2-rank gang's every scenario: {"io", "out": [npz per rank],
    "facts": [dict per rank], "data"}."""
    io = str(tmp_path_factory.mktemp("gang"))
    spec = {"nets": {}, "helpers": {"mini": "fused"}}
    arrays = {}
    for name, build in JNETS.items():
        jnet = build()
        kind = "graph" if hasattr(jnet.conf, "network_inputs") else "mln"
        spec["nets"][name] = [kind, jnet.conf.to_json()]
        for prefix, tree in (("p", jnet.params), ("s", jnet.states)):
            for i, a in enumerate(_np(tree)):
                arrays[f"{name}/{prefix}:{i}"] = a
    data = _data()
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(io, "nets.npz"), **arrays)
    np.savez(os.path.join(io, "data.npz"), **data)
    _launch(io, 3, only="zero1_save3")
    _launch(io, 2)
    out = [dict(np.load(os.path.join(io, f"out-{r}.npz"))) for r in range(2)]
    facts = []
    for r in range(2):
        with open(os.path.join(io, f"out-{r}.json")) as f:
            facts.append(json.load(f))
    return {"io": io, "out": out, "facts": facts, "data": data}


def _field(g, scen, field, rank=0):
    o = g["out"][rank]
    n = sum(1 for k in o if k.startswith(f"{scen}/{field}:"))
    assert n, f"no {scen}/{field} in the gang's output"
    return [o[f"{scen}/{field}:{i}"] for i in range(n)]


def _close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _port(g, name):
    """The port's twin of JNETS[name] on the CPU, one process."""
    return Gang(g["io"], 0, 1, "cpu").net(name)


def _mesh2():
    return jmake_mesh(dp=2, devices=jax.devices("cpu")[:2])


# ----------------------------------------------------------- the gang
def test_gang_ranks_agree_and_no_scenario_failed(gang):
    for f in gang["facts"]:
        assert f["_failed"] == {}
    a, b = gang["out"]
    replicated = [k for k in a if "/upd:" not in k]
    assert len(replicated) > 100
    for k in replicated:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------- (i) per-step dp, BatchNorm
def test_dp_conv_bn_matches_port_serial(gang):
    """The two halves differ (one x3+1): the per-rank statistics of a
    naive dp would miss the serial fit by ~3e-2; global ones match."""
    d = gang["data"]
    ser = _port(gang, "conv")
    ser.fit([(d["conv_x"], d["conv_y"])] * 3)
    _close(_field(gang, "dp_conv", "params"),
           [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    _close(_field(gang, "dp_conv", "states"),
           [t.numpy() for t in leaves(ser.states)], SERIAL_TOL)


def test_dp_conv_bn_matches_jax_dp2(gang):
    d = gang["data"]
    jnet = _conv()
    JPW(jnet, mesh=_mesh2()).fit([(d["conv_x"], d["conv_y"])] * 3)
    _close(_field(gang, "dp_conv", "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, "dp_conv", "states"), _np(jnet.states), JAX_TOL)


def test_dp_matches_single_device_and_jax(gang):
    d = gang["data"]
    ser = _port(gang, "mlp8")
    ser.fit([(d["mlp_x"], d["mlp_y"])] * 5)
    got = _field(gang, "dp_mlp", "params")
    _close(got, [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    jnet = _mlp8()
    JPW(jnet, mesh=_mesh2()).fit([(d["mlp_x"], d["mlp_y"])] * 5)
    _close(got, _np(jnet.params), JAX_TOL)


def test_dp_pads_ragged_batch(gang):
    """13 rows over dp=2 pad to 14, the padded row masked out of the loss
    (its zeros still enter the BatchNorm-free forward): equal to the
    serial fit of the padded, masked batch and to JAX's dp=2."""
    from deeplearning4j_tpu_torch.parallel.sharding import (
        pad_batch_with_masks,
    )

    d = gang["data"]
    assert np.isfinite(gang["facts"][0]["dp_ragged"]["score"])
    ser = _port(gang, "mlp8")
    ser.fit([pad_batch_with_masks(2, d["rag_x"], d["rag_y"], None, None)])
    got = _field(gang, "dp_ragged", "params")
    _close(got, [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    jnet = _mlp8()
    JPW(jnet, mesh=_mesh2()).fit([(d["rag_x"], d["rag_y"])])
    _close(got, _np(jnet.params), JAX_TOL)


def test_dp_fused_tier_global_statistics_match_serial(gang):
    """The fused tier's kernel-epilogue (sum, sum of squares) go through
    dp_sum: the mini ResNet in "fused" at dp=2 on differing halves equals
    its serial fit, so the fused backward needs no dp change."""
    d = gang["data"]
    ser = _port(gang, "mini")
    ser.fit([(d["mini_x"], d["mini_y"])] * 2)
    _close(_field(gang, "dp_fused", "params"),
           [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    _close(_field(gang, "dp_fused", "states"),
           [t.numpy() for t in leaves(ser.states)], SERIAL_TOL)


# ------------------------------------------------------ (ii) local SGD
def test_averaging_frequency_matches_local_sgd_oracle_and_jax(gang):
    d = gang["data"]
    xs, ys = d["lsgd_x"], d["lsgd_y"]
    got = _field(gang, "lsgd", "params")
    reps = [_port(gang, "mlp8"), _port(gang, "mlp8")]
    for grp in range(2):
        for s in range(2):
            x, y = xs[grp * 2 + s], ys[grp * 2 + s]
            for i, rep in enumerate(reps):
                rep.fit([(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])])
        avg = [(a + b) / 2 for a, b in zip(leaves(reps[0].params),
                                           leaves(reps[1].params))]
        from deeplearning4j_tpu_torch.util.tree import unflatten

        for rep in reps:
            rep.params = unflatten(rep.params,
                                   [a.clone() for a in avg])[0]
    _close(got, [t.numpy() for t in leaves(reps[0].params)], SERIAL_TOL)
    jnet = _mlp8()
    JPW(jnet, mesh=_mesh2(), averaging_frequency=2).fit(
        [(xs[i], ys[i]) for i in range(len(xs))])
    _close(got, _np(jnet.params), JAX_TOL)


# ------------------------------------------- (iii) threshold compression
def test_threshold_compression_residual_carries_unsent_mass(gang):
    """An unreachable threshold sends nothing: params stay at the start,
    every local step's progress lives in the residual."""
    f = gang["facts"][0]["thr_res"]
    jinit = _np(_mlp8().params)
    _close(_field(gang, "thr_res", "params"), jinit,
           dict(rtol=0, atol=1e-7))
    assert f["residual_max"] > 0
    # SGD without BatchNorm: no dense updater/BN average rides along
    assert f["wire"]["bytes_compressed"] == 0.0
    assert f["wire"]["rendezvous"] == 1


def test_threshold_compression_wire_stats_agree_with_jax(gang):
    d = gang["data"]
    got = gang["facts"][0]["thr_wire"]["wire"]
    jnet = _mlp8()
    pw = JPW(jnet, mesh=_mesh2(), averaging_frequency=4,
             threshold_compression=3e-2)
    pw.fit([(d["thrw_x"][i], d["thrw_y"][i]) for i in range(8)])
    want = pw._local_step.wire_stats()
    assert got["rendezvous"] == want["rendezvous"] == 2
    assert got["bytes_dense"] == want["bytes_dense"]
    # spikes counted from values within rounding of the threshold may
    # differ by a handful across the packages
    assert abs(got["bytes_compressed"] - want["bytes_compressed"]) \
        <= 0.01 * want["bytes_compressed"]
    assert 0 < got["compression_ratio"] < 1
    _close(_field(gang, "thr_wire", "params"), _np(jnet.params),
           dict(rtol=1e-4, atol=1e-4))


# ---------------------------------------------- (iv) stale gradients
def test_stale_gradient_trainer_dynamics(gang):
    d = gang["data"]
    jnet = _mlp8()
    JStale(jnet, _mesh2()).fit(
        [(d["stale_x"][i], d["stale_y"][i]) for i in range(24)])
    _close(_field(gang, "stale", "params"), _np(jnet.params), JAX_TOL)
    assert gang["facts"][0]["stale"]["score"] < 1.0


def test_stale_gradient_first_step_applies_nothing(gang):
    jinit = _np(_mlp8().params)
    _equal(_field(gang, "stale_first", "after_step"), jinit)
    moved = [float(np.max(np.abs(a - b))) for a, b in zip(
        _field(gang, "stale_first", "after_flush"), jinit)]
    assert max(moved) > 1e-6


def test_stale_gradient_bn_states_and_ragged_batch(gang):
    d = gang["data"]
    jnet = _bnmlp()
    JStale(jnet, _mesh2()).fit(
        [(d["stbn_x"][i], d["stbn_y"][i]) for i in range(4)])
    _close(_field(gang, "stale_bn", "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, "stale_bn", "states"), _np(jnet.states), JAX_TOL)
    for a in _field(gang, "stale_bn", "states"):
        assert np.all(np.isfinite(a))


# ------------------------------------------------------ (v) ZeRO-1
def test_zero1_equals_unsharded_bit_for_bit(gang):
    _equal(_field(gang, "z1", "params"), _field(gang, "dp_tm", "params"))
    _equal(_field(gang, "z1", "upd"), _field(gang, "dp_tm", "upd"))
    facts = gang["facts"][0]["z1"]
    assert any(facts["layout"])       # the 24-row leaves shard over 2
    mem = facts["memory"]
    assert mem["dp"] == 2 and mem["replica_fraction"] < 1.0
    assert gang["facts"][1]["z1"]["memory"] == mem


def test_zero1_matches_jax_zero1_within_tolerance(gang):
    d = gang["data"]
    jnet = _adam24()
    JTM(jnet, mesh=_mesh2(), sharding="zero1").fit(
        lambda s: (d["z_x"][s], d["z_y"][s]), 6)
    _close(_field(gang, "z1", "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, "z1", "upd"), _np(jnet.updater_states), JAX_TOL)


def test_zero1_k_group_matches_k1(gang):
    _equal(_field(gang, "z1_k4", "params"), _field(gang, "z1_k1", "params"))
    _equal(_field(gang, "z1_k4", "upd"), _field(gang, "z1_k1", "upd"))


def test_zero1_checkpoint_roundtrip_and_retention(gang):
    _equal(_field(gang, "z1_rt", "params"), _field(gang, "z1_k1", "params"))
    _equal(_field(gang, "z1_rt", "upd"), _field(gang, "z1_k1", "upd"))
    for r in range(2):
        files = gang["facts"][r]["z1_rt"]["files"]
        assert "step-00000008.updshard.npz" in files
        assert "step-00000006.updshard.npz" in files
        assert "step-00000004.npz" not in files
        assert "step-00000004.updshard.npz" not in files


# ------------------------------------------ (vi) cross-package sidecars
def test_two_rank_sidecars_restore_at_world_one_in_the_port(gang):
    """The 2-rank save (sharded leaves in two sidecars) resumes in ONE
    process (2 -> 1 reshard, counted) and continues like the 2-rank run
    from the same state."""
    from deeplearning4j_tpu_torch.observability import get_registry

    base = os.path.join(gang["io"], "ckpt", "z1_save")
    assert os.path.exists(os.path.join(
        base, "rank-1", "step-00000004.updshard.npz"))
    with np.load(os.path.join(base, "rank-0", "step-00000004.npz")) as z:
        assert int(z["shard_world"]) == 2
        assert len(np.asarray(z["upd_sharded_idx"]).reshape(-1)) > 0
    reg = get_registry()
    before = reg.counter_value("dl4j_mesh_reshard_total")
    net = _port(gang, "adam24")
    tm = TrainingMaster(net, checkpoint_dir=base, per_rank_checkpoints=True,
                        sharding="zero1")
    assert tm.load_latest_checkpoint() == 4
    assert reg.counter_value("dl4j_mesh_reshard_total") == before + 1
    _equal([t.numpy() for t in leaves(net.params)],
           _field(gang, "z1_save", "params"))
    _equal([t.numpy() for t in leaves(net.updater_states)],
           _field(gang, "z1_save", "upd"))


def test_two_rank_sidecars_pass_the_jax_checks(gang):
    base = os.path.join(gang["io"], "ckpt", "z1_save")
    for r in range(2):
        d = jci.rank_checkpoint_dir(base, r)
        assert jci.validate_file(d, "step-00000004.npz")
        assert jci.validate_file(d, jci.shard_sidecar_filename(4))
    import shutil

    copy = os.path.join(gang["io"], "z1_save_jax_view")
    shutil.copytree(base, copy)
    report = jci.sharded_quorum_resume_step(copy, nprocs=2)
    assert report["step"] == 4 and report["shard_world"] == 2
    assert sorted(report["slices"]) == [0, 1]
    assert report["healed"] == []


def test_jax_dp2_zero1_save_restores_in_the_port(tmp_path, gang):
    d = gang["data"]
    ck = str(tmp_path / "jax")
    jnet = _adam24()
    JTM(jnet, mesh=_mesh2(), sharding="zero1", checkpoint_dir=ck,
        checkpoint_every=4).fit(lambda s: (d["z_x"][s], d["z_y"][s]), 4)
    net = _port(gang, "adam24")
    tm = TrainingMaster(net, checkpoint_dir=ck, sharding="zero1")
    assert tm.load_latest_checkpoint() == 4
    _equal([t.numpy() for t in leaves(net.params)], _np(jnet.params))
    _equal([t.numpy() for t in leaves(net.updater_states)],
           _np(jnet.updater_states))
    assert net.iteration == 4


def test_zero1_reshard_on_resume_from_larger_world(gang):
    """Steps 0-3 saved by three ranks (three slices per sharded leaf),
    resumed by the 2-rank gang (3 -> 2, counted once per rank) and
    trained to step 8: within RESHARD_TOL of the 2-rank run."""
    base = os.path.join(gang["io"], "ckpt3")
    for r in range(3):
        assert os.path.exists(os.path.join(
            base, f"rank-{r}", "step-00000004.updshard.npz"))
    assert gang["facts"][0]["z1_resume3"]["reshards"] == 1
    assert gang["facts"][0]["z1_resume3"]["iteration"] == 8
    _close(_field(gang, "z1_resume3", "params"),
           _field(gang, "z1_k1", "params"), RESHARD_TOL)
    _close(_field(gang, "z1_resume3", "upd"),
           _field(gang, "z1_k1", "upd"), RESHARD_TOL)


# --------------------------------------- (vii) processes against serial
def test_two_process_training_matches_serial(gang):
    d = gang["data"]
    ser = _port(gang, "dist")
    for s in range(6):
        ser.fit([(d["dist_x"][s], d["dist_y"][s])])
    _close(_field(gang, "dist", "params"),
           [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    assert gang["facts"][0]["dist"]["iteration"] == 6


def test_distributed_evaluate_sums_the_ranks_counts(gang):
    """Each rank evaluates its rows; the all-reduced counts equal one
    process's evaluate of the same params over the whole batches."""
    from deeplearning4j_tpu_torch.util.tree import unflatten

    d = gang["data"]
    net = _port(gang, "dist")
    net.params = unflatten(net.params, [torch.from_numpy(a) for a in
                                        _field(gang, "dist", "params")])[0]
    ev = TrainingMaster(net).evaluate(
        lambda s: (d["dist_x"][s], d["dist_y"][s]), 6)
    for f in gang["facts"]:
        assert f["dist"]["confusion"] == ev.confusion.matrix.tolist()
    assert int(np.sum(ev.confusion.matrix)) == 6 * 32


def test_kill_and_resume_matches_uninterrupted(gang):
    f = gang["facts"][0]["dist_kill"]
    assert f["resumed_from"] == 4 and f["iteration"] == 6
    _equal(_field(gang, "dist_kill", "params"),
           _field(gang, "dist_ref", "params"))
    _equal(_field(gang, "dist_kill", "upd"), _field(gang, "dist_ref", "upd"))
