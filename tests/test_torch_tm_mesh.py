"""TrainingMaster over a mesh with a tp axis, and ghost-batch BatchNorm
statistics whose rows split over the dp ranks, across processes: one
4-rank gloo gang (tests/fixtures/torch/mesh_worker.py, which imports only
the port) runs `tm_tp` (TrainingMaster on make_mesh(dp=2, tp=2): plain at
k=1 and k=2, ZeRO-1 with per-rank checkpoints, its round trip) and
`ghost_split` (ParallelWrapper on make_mesh(dp=4), stat_sample=3: the
statistics' leading 4 rows of 12 lie 3 / 1 / 0 / 0 on the ranks, then a
ragged batch) on the CPU. The tests hold its results against the JAX
package on the same meshes of the virtual CPU devices and against the
port's one-process runs. Every net is dropout-free.

Tolerances, stated per comparison:
  - bit for bit: the replicas of each dp coordinate (every rank's params,
    states and gathered updater state; the two ranks of a coordinate's
    ZeRO-1 slices), k=2 windows against k=1, ZeRO-1 against the unsharded
    run (two ranks' sums, as tests/test_torch_scaleout_gang.py pins), the
    round trip from the step-4 checkpoint against the uninterrupted run;
  - JAX_TOL (rtol 1e-5, atol 1e-5): against JAX's TrainingMaster and
    ParallelWrapper on the same mesh, weights and batches;
  - SERIAL_TOL (rtol 1e-5, atol 1e-5): against the port's one-process
    run on the global batches, and the resume at dp 1 from the gang's
    dp-2 sidecars against the uninterrupted gang.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JBN,
    ConvolutionLayer as JConv,
    OutputLayer as JOut,
    SubsamplingLayer as JSub,
)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.training_master import (
    TrainingMaster as JTM,
)
from deeplearning4j_tpu_torch.parallel import TrainingMaster
from deeplearning4j_tpu_torch.parallel.sharding import pad_batch_with_masks
from deeplearning4j_tpu_torch.resilience import checkpoint_integrity as ci
from deeplearning4j_tpu_torch.util.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch")
sys.path.insert(0, FIXTURES)
from mesh_worker import TM_STEPS, launch  # noqa: E402
from scaleout_worker import Gang  # noqa: E402
from test_torch_scaleout_gang import _adam24, _np  # noqa: E402

WORKER = os.path.join(FIXTURES, "mesh_worker.py")
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
SERIAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _ghost3(seed=3):
    """tests/test_parallel.py's conv + BatchNorm net, its statistics from
    the leading third of the batch."""
    conf = (JNNC.Builder().seed(seed).updater("sgd").learning_rate(0.05)
            .weight_init("xavier").list()
            .layer(JConv(kernel_size=(3, 3), n_out=4, activation="relu"))
            .layer(JBN(stat_sample=3))
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JOut(n_out=3, loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())
    return JMLN(conf).init()


JNETS = {"adam24": _adam24, "ghost3": _ghost3}


def _data():
    rng = np.random.default_rng(20)
    onehot = lambda n, c: np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    zs = [np.random.default_rng(500 + s) for s in range(TM_STEPS)]
    d = {"z_x": np.stack([r.normal(size=(24, 24)).astype(np.float32)
                          for r in zs]),
         "z_y": np.stack([np.eye(24, dtype=np.float32)[r.integers(0, 24, 24)]
                          for r in zs])}
    for key, n in (("gs", 12), ("gsr", 10)):
        x = rng.normal(size=(n, 8, 8, 1)).astype(np.float32)
        x[3:6] = x[3:6] * 3 + 1          # the ranks' shares differ
        d[f"{key}_x"], d[f"{key}_y"] = x, onehot(n, 3)
    return d


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The JAX-initialized nets and data, then the 4-rank gang's
    scenarios: {"io", "out": [npz per rank], "facts": [dict per rank],
    "data"}."""
    io = str(tmp_path_factory.mktemp("tm_mesh"))
    spec = {"nets": {}, "helpers": {}}
    arrays = {}
    for name, build in JNETS.items():
        jnet = build()
        spec["nets"][name] = ["mln", jnet.conf.to_json()]
        for prefix, tree in (("p", jnet.params), ("s", jnet.states)):
            for i, a in enumerate(_np(tree)):
                arrays[f"{name}/{prefix}:{i}"] = a
    data = _data()
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(io, "nets.npz"), **arrays)
    np.savez(os.path.join(io, "data.npz"), **data)
    launch(WORKER, io, 4, ("--only", "tm_tp,ghost_split"))
    out = [dict(np.load(os.path.join(io, f"out-{r}.npz"))) for r in range(4)]
    facts = []
    for r in range(4):
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


def _global_fn(d):
    return lambda s: (d["z_x"][s], d["z_y"][s])


def _jax_tm(d, sharding=None):
    jnet = _adam24()
    JTM(jnet, mesh=jmake_mesh(dp=2, tp=2, devices=jax.devices("cpu")[:4]),
        sharding=sharding).fit(_global_fn(d), TM_STEPS)
    return jnet


def _base(g):
    return os.path.join(g["io"], "ckpt", "tm_tp_z1")


# ------------------------------------------------------------ the gang
def test_gang_no_scenario_failed_and_replicas_bitwise(gang):
    """Params, states and the gathered updater state are equal on all
    four ranks; a coordinate's ZeRO-1 slices are equal on its two ranks
    and differ from the other coordinate's."""
    for f in gang["facts"]:
        assert f["_failed"] == {}
    ref = gang["out"][0]
    for o in gang["out"][1:]:
        for k in ref:
            if "/slices:" not in k:
                np.testing.assert_array_equal(o[k], ref[k], err_msg=k)
    s = [_field(gang, "tm_tp_z1", "slices", rank=r) for r in range(4)]
    _equal(s[1], s[0])
    _equal(s[3], s[2])
    assert any(a.shape == b.shape and not np.array_equal(a, b)
               for a, b in zip(s[0], s[2]))


# ------------------------------------- TrainingMaster on dp 2 x tp 2
def test_tm_tp_matches_jax_tm_on_the_tp_mesh_and_one_process(gang):
    d = gang["data"]
    jnet = _jax_tm(d)
    _close(_field(gang, "tm_tp", "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, "tm_tp", "upd"), _np(jnet.updater_states), JAX_TOL)
    ser = _port(gang, "adam24")
    TrainingMaster(ser).fit(_global_fn(d), TM_STEPS)
    _close(_field(gang, "tm_tp", "params"),
           [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    assert gang["facts"][0]["tm_tp"]["world"]["dp"] == 2
    assert gang["facts"][0]["tm_tp"]["iteration"] == TM_STEPS


def test_tm_tp_k2_windows_equal_single_steps(gang):
    _equal(_field(gang, "tm_tp_k2", "params"), _field(gang, "tm_tp", "params"))
    _equal(_field(gang, "tm_tp_k2", "upd"), _field(gang, "tm_tp", "upd"))


def test_tm_tp_zero1_matches_jax_zero1_and_unsharded(gang):
    d = gang["data"]
    jnet = _jax_tm(d, sharding="zero1")
    _close(_field(gang, "tm_tp_z1", "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, "tm_tp_z1", "upd"), _np(jnet.updater_states),
           JAX_TOL)
    _equal(_field(gang, "tm_tp_z1", "params"),
           _field(gang, "tm_tp", "params"))
    _equal(_field(gang, "tm_tp_z1", "upd"), _field(gang, "tm_tp", "upd"))
    for r, f in enumerate(gang["facts"]):
        z = f["tm_tp_z1"]
        assert z["dp"] == 2 and z["dp_rank"] == r // 2
        assert z["world"] == {"processes": 4, "devices": 4, "dp": 2}
        assert any(z["layout"])
        assert z["memory"]["dp"] == 2 and z["memory"]["replica_fraction"] < 1


def test_tm_tp_zero1_checkpoints_vote_over_every_rank(gang):
    """Every rank writes its copy; each sidecar holds its dp coordinate's
    slice (shard_world 2, written by 4 processes); the quorum votes over
    all four ranks and reads one slice per coordinate."""
    base = _base(gang)
    fn = ci.shard_sidecar_filename(6)
    for r in range(4):
        d = ci.rank_checkpoint_dir(base, r)
        entry = ci.read_manifest(d)[fn]
        assert (entry["shard_rank"], entry["shard_world"],
                entry["processes"]) == (r // 2, 2, 4)
        assert ci.validate_file(d, ci.step_filename(6))
        with np.load(os.path.join(d, ci.step_filename(6))) as z:
            assert int(z["shard_world"]) == 2
    copy = os.path.join(gang["io"], "tm_tp_z1_vote")
    shutil.copytree(base, copy)
    report = ci.sharded_quorum_resume_step(copy, nprocs=4)
    assert report["step"] == 6 and report["healed"] == []
    assert sorted(report["ranks"]) == [0, 1, 2, 3]
    assert len(set(report["ranks"].values())) == 1
    assert report["shard_world"] == 2
    assert report["slices"] == {
        0: os.path.join(copy, "rank-0", fn),
        1: os.path.join(copy, "rank-2", fn)}


def test_tm_tp_zero1_round_trip_from_step_4(gang):
    assert gang["facts"][0]["tm_tp_z1_rt"]["restored"] == 4
    _equal(_field(gang, "tm_tp_z1_rt", "params"),
           _field(gang, "tm_tp_z1", "params"))
    _equal(_field(gang, "tm_tp_z1_rt", "upd"),
           _field(gang, "tm_tp_z1", "upd"))


def test_sidecar_resume_at_dp1_matches_uninterrupted(gang, tmp_path):
    """The dp-2 sidecars of step 2 reassembled by dp coordinate in ONE
    process (a 2 -> 1 reshard, counted), trained to the end on the whole
    batches: within SERIAL_TOL of the uninterrupted gang."""
    from deeplearning4j_tpu_torch.observability import get_registry

    copy = str(tmp_path / "resume")
    shutil.copytree(_base(gang), copy)
    reg = get_registry()
    before = reg.counter_value("dl4j_mesh_reshard_total")
    net = _port(gang, "adam24")
    tm = TrainingMaster(net, checkpoint_dir=copy, per_rank_checkpoints=True,
                        sharding="zero1")
    assert tm.load_checkpoint_at(2) == 2
    assert reg.counter_value("dl4j_mesh_reshard_total") == before + 1
    tm.fit(_global_fn(gang["data"]), TM_STEPS, start_step=2)
    _close([t.numpy() for t in leaves(net.params)],
           _field(gang, "tm_tp_z1", "params"), SERIAL_TOL)
    _close([t.numpy() for t in leaves(net.updater_states)],
           _field(gang, "tm_tp_z1", "upd"), SERIAL_TOL)


def test_evaluate_sums_the_dp_ranks_counts_once(gang):
    """Each dp coordinate's rows are counted once (not once per replica):
    every rank's counts equal one process's evaluate of the same params
    over the whole batches."""
    from deeplearning4j_tpu_torch.util.tree import unflatten
    import torch

    net = _port(gang, "adam24")
    net.params = unflatten(net.params, [torch.from_numpy(a) for a in
                                        _field(gang, "tm_tp", "params")])[0]
    ev = TrainingMaster(net).evaluate(_global_fn(gang["data"]), TM_STEPS)
    for f in gang["facts"]:
        assert f["tm_tp"]["confusion"] == ev.confusion.matrix.tolist()
    assert int(np.sum(ev.confusion.matrix)) == TM_STEPS * 24


# -------------------------------- ghost rows split over dp 4
@pytest.mark.parametrize("scen,key", [("ghost_split", "gs"),
                                      ("ghost_split_rag", "gsr")])
def test_ghost_rows_split_over_ranks_match_jax_and_one_process(gang, scen,
                                                               key):
    d = gang["data"]
    x, y = d[f"{key}_x"], d[f"{key}_y"]
    jnet = _ghost3()
    JPW(jnet, mesh=jmake_mesh(dp=4, devices=jax.devices("cpu")[:4])).fit(
        [(x, y)] * 2)
    _close(_field(gang, scen, "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, scen, "states"), _np(jnet.states), JAX_TOL)
    ser = _port(gang, "ghost3")
    ser.fit([pad_batch_with_masks(4, x, y, None, None)] * 2)
    _close(_field(gang, scen, "params"),
           [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    _close(_field(gang, scen, "states"),
           [t.numpy() for t in leaves(ser.states)], SERIAL_TOL)


# ------------------------------------- chip_smoke.py's --phase option
def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("arg,want", [
    ("", None),
    ("tm_mesh", {"tm_mesh"}),
    ("cluster", {"cluster", "tm", "engine"}),
    ("timing,mesh", {"timing", "serving", "training", "mesh"}),
    ("control", {"control", "serving", "decode"}),
])
def test_chip_smoke_phase_selection_adds_what_a_phase_reads(arg, want):
    """`--phase` runs the named phases and the phases they read; no name
    runs every phase, in order, the new phase 5p (tm_mesh) among them."""
    cs = _chip_smoke()
    got = cs.phase_selection(arg, cs.PHASES, cs.PHASE_DEPS)
    assert got == (set(cs.PHASES) if want is None else want)
    assert cs.PHASES.index("tm_mesh") == cs.PHASES.index("analysis") + 1
    for name, deps in cs.PHASE_DEPS.items():
        assert all(cs.PHASES.index(d) < cs.PHASES.index(name) for d in deps)


def test_chip_smoke_phase_selection_refuses_unknown_names():
    cs = _chip_smoke()
    with pytest.raises(SystemExit):
        cs.phase_selection("tm_mesh,nope", cs.PHASES, cs.PHASE_DEPS)
    assert cs.phase_selection("ghost", cs.NCCL_LAUNCHES) == {"ghost"}
