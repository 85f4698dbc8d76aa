"""The port's tensor parallelism and five-axis mesh across processes: one
4-rank gloo gang (tests/fixtures/torch/mesh_worker.py, which imports only
the port) runs every scenario in sequence on the CPU, and the tests hold
its results against the JAX package on a `make_mesh(dp=2, tp=2)` of the
virtual CPU devices and against the port's one-process fit. Every net is
dropout-free.

Tolerances, stated per comparison:
  - bit for bit: every rank's whole params after the fit against rank 0's,
    the k=2 windows against the single steps, shard_params then
    gather_params against the tree;
  - TP_TOL (rtol 1e-3, atol 1e-4, JAX's tests/test_parallel.py): the
    port's dp 2 x tp 2 fit against JAX's tp fit and against the port's
    one-process fit (the gathered columns and the tp-summed input
    gradients round differently from one matmul).
"""

import os
import sys

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.sharding import _tp_spec as j_tp_spec
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, mesh_sizes
from deeplearning4j_tpu_torch.parallel.sharding import (
    _tp_spec,
    param_shardings,
    shard_batch,
    shard_params,
)
from deeplearning4j_tpu_torch.util.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch")
sys.path.insert(0, FIXTURES)
from mesh_worker import launch  # noqa: E402
from scaleout_worker import Gang  # noqa: E402
from test_torch_scaleout_gang import (  # noqa: E402
    _adam24,
    _conv,
    _data,
    _mlp8,
    _np,
)

WORKER = os.path.join(FIXTURES, "mesh_worker.py")
TP_TOL = dict(rtol=1e-3, atol=1e-4)
JNETS = {"mlp8": _mlp8, "conv": _conv, "adam24": _adam24}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The JAX-initialized nets and data, then the 4-rank gang's every
    scenario: {"io", "out": [npz per rank], "facts": [dict per rank],
    "data"}."""
    import json

    io = str(tmp_path_factory.mktemp("tp"))
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
    launch(WORKER, io, 4, ("--only", "mesh,tp_mlp,tp_adam,tp_conv,tp_k2,"
                                     "tp_early,tp_refusals"))
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


def _port(g, name):
    """The port's twin of JNETS[name] on the CPU, one process."""
    return Gang(g["io"], 0, 1, "cpu").net(name)


def _jax_tp(name, batches):
    jnet = JNETS[name]()
    JPW(jnet, mesh=jmake_mesh(dp=2, tp=2,
                              devices=jax.devices("cpu")[:4])).fit(batches)
    return jnet


# ----------------------------------------------------- the mesh alone
@pytest.mark.parametrize("kw,n", [
    (dict(dp=4, tp=2), 8), (dict(dp=-1, tp=2), 8), (dict(sp=-1), 8),
    (dict(dp=2, pp=2, ep=2), 8), (dict(dp=-1, tp=-1), 8),
    (dict(dp=-1, tp=3), 8), (dict(dp=4, tp=4), 8)])
def test_mesh_axis_arithmetic_matches_jax(kw, n):
    """JAX's make_mesh cases (tests/test_parallel.py:53-58) and its three
    errors, on n processes against n virtual devices."""
    from deeplearning4j_tpu_torch.parallel.mesh import AXES

    try:
        jm = jmake_mesh(**kw, devices=jax.devices("cpu")[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            mesh_sizes({a: kw.get(a, 1) for a in AXES}, n)
        assert str(ei.value).split(" (")[0] == str(e).replace(
            "devices", "processes")
        return
    assert mesh_sizes({a: kw.get(a, 1) for a in AXES}, n) == dict(jm.shape)


def test_tp_spec_shard_params_and_descriptors():
    """The shape rule against JAX's, and shard_params' slices: the
    trailing dim when it divides, else the leading dim, else whole; a 1-D
    leaf only when it divides and is at least tp*8."""
    jm = jmake_mesh(dp=1, tp=2, devices=jax.devices("cpu")[:2])
    for shape in [(16,), (8,), (6,), (8, 6), (6, 7), (7, 3), (3, 3, 4, 6)]:
        assert _tp_spec(shape, 2) == tuple(
            j_tp_spec("", np.zeros(shape), jm, "tp"))
    tree = {"W": np.arange(48.0).reshape(8, 6), "v": np.arange(32.0),
            "odd": np.arange(21.0).reshape(7, 3)}
    parts = [shard_params(Mesh({"dp": 1, "pp": 1, "sp": 1, "ep": 1,
                                "tp": 2}, 2, r, (), {"tp": r}), tree)
             for r in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p["W"] for p in parts], -1), tree["W"])
    np.testing.assert_array_equal(
        np.concatenate([p["v"] for p in parts]), tree["v"])
    assert parts[1]["odd"] is tree["odd"]
    specs = leaves(param_shardings(Mesh({"tp": 2}, 2, 0), tree))
    assert [s.spec for s in specs] == [(None, "tp"), (), ("tp",)]


def test_shard_batch_over_dp_and_sp_matches_jax_shards():
    """shard_batch(..., seq_axis="sp") on dp 2 x sp 2: each rank's rows
    and time steps are the shard JAX's P("dp", "sp") puts on the device
    at its coordinates; 1-D arrays split over dp only; a sequence that
    does not split raises."""
    from deeplearning4j_tpu.parallel.sharding import shard_batch as jshard

    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6, 3)).astype(np.float32)
    lab = np.arange(4.0, dtype=np.float32)
    jm = jmake_mesh(dp=2, sp=2, devices=jax.devices("cpu")[:4])
    jx = jshard(jm, x, seq_axis="sp")
    for shard in jx.addressable_shards:
        pos = {d: i for i, d in enumerate(jm.devices.reshape(-1))}
        flat = pos[shard.device]
        coords = {"dp": flat // 2, "sp": flat % 2, "tp": 0}
        m = Mesh({"dp": 2, "pp": 1, "sp": 2, "ep": 1, "tp": 1}, 4, flat,
                 (), coords)
        got_x, got_l = shard_batch(m, (x, lab), seq_axis="sp")
        np.testing.assert_array_equal(got_x, np.asarray(shard.data))
        np.testing.assert_array_equal(got_l, lab[2 * coords["dp"]:
                                                 2 * coords["dp"] + 2])
    m = Mesh({"dp": 1, "pp": 1, "sp": 4, "ep": 1, "tp": 1}, 4, 0, (),
             {"sp": 0})
    with pytest.raises(ValueError, match="sequence of 6 steps does not "
                                         "split over sp=4"):
        shard_batch(m, x, seq_axis="sp")


# ------------------------------------------------------------ the gang
def test_gang_ranks_agree_and_no_scenario_failed(gang):
    for f in gang["facts"]:
        assert f["_failed"] == {}
    ref = gang["out"][0]
    for o in gang["out"][1:]:
        for k in ref:
            if k.startswith("mesh/"):
                continue
            np.testing.assert_array_equal(o[k], ref[k], err_msg=k)


def test_make_mesh_coords_groups_and_hops(gang):
    """tp fastest, dp slowest: rank = dp*2 + tp on dp 2 x tp 2; each axis
    group holds the ranks that differ along it alone, and one ppermute hop
    delivers the previous coordinate's value."""
    for r, f in enumerate(gang["facts"]):
        m = f["mesh"]["meshes"][0]
        assert m["shape"] == {"dp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 2}
        assert m["coords"]["dp"] == r // 2 and m["coords"]["tp"] == r % 2
        assert m["groups"]["tp"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert m["groups"]["dp"] == [r % 2, r % 2 + 2]
        assert m["groups"]["sp"] == [r]
        assert m["hop"] == {"dp": float((r + 2) % 4),
                            "tp": float(r // 2 * 2 + (r + 1) % 2)}
        assert f["mesh"]["meshes"][1]["shape"]["dp"] == 2
        assert f["mesh"]["meshes"][2]["shape"]["tp"] == 4
        assert f["mesh"]["meshes"][2]["hop"] == {"tp": float((r - 1) % 4)}
        errs = f["mesh"]["errors"]
        assert errs["too_many"] == [
            "ValueError", "mesh needs 8 processes, only 4 available (the "
            "live process group has 4; one device per process: call "
            "TrainingMaster.initialize_distributed first)"]
        assert errs["too_few"][0] == "ValueError"
        assert "covers 1 processes" in errs["too_few"][1]
        assert errs["wild2"] == ["ValueError",
                                 "at most one mesh axis may be -1"]
        assert errs["indivisible"] == [
            "ValueError", "4 processes not divisible by fixed axes 3"]


def test_shard_then_gather_params_round_trip(gang):
    """Each rank's slices are its coordinate's, and gathering them over
    the tp group gives the tree back bit for bit."""
    for r, f in enumerate(gang["facts"]):
        assert f["roundtrip"] is True
        w, lead, odd, small, v = _field(gang, "mesh", "slices", rank=r)
        t = r % 2
        np.testing.assert_array_equal(
            w, np.arange(48.0).reshape(8, 6)[:, 3 * t:3 * t + 3])
        np.testing.assert_array_equal(
            lead, np.arange(42.0).reshape(6, 7)[3 * t:3 * t + 3])
        np.testing.assert_array_equal(odd, np.arange(21.0).reshape(7, 3))
        np.testing.assert_array_equal(small, np.arange(6.0))
        np.testing.assert_array_equal(v, np.arange(32.0)[16 * t:16 * t + 16])


def test_tp_fit_matches_jax_tp_and_one_process(gang):
    """JAX's tests/test_parallel.py:76-89 on dp 2 x tp 2: the port's gang
    against JAX's tp fit and against the port's one-process fit."""
    d = gang["data"]
    batches = [(d["mlp_x"], d["mlp_y"])] * 3
    got = _field(gang, "tp_mlp", "params")
    _close(got, _np(_jax_tp("mlp8", batches).params), TP_TOL)
    ser = _port(gang, "mlp8")
    ser.fit(batches)
    _close(got, [t.numpy() for t in leaves(ser.params)], TP_TOL)


def test_tp_adam_state_sliced_matches_jax_tp_and_one_process(gang):
    """Adam's m and v are sliced like their params, updated on the slices
    and gathered whole with them."""
    d = gang["data"]
    batches = [(d["z_x"][s], d["z_y"][s]) for s in range(3)]
    jnet = _jax_tp("adam24", batches)
    _close(_field(gang, "tp_adam", "params"), _np(jnet.params), TP_TOL)
    _close(_field(gang, "tp_adam", "upd"), _np(jnet.updater_states), TP_TOL)
    ser = _port(gang, "adam24")
    ser.fit(batches)
    _close(_field(gang, "tp_adam", "upd"),
           [t.numpy() for t in leaves(ser.updater_states)], TP_TOL)
    rec = gang["facts"][1]["tp_adam"]
    whole = [list(a.shape) for a in _field(gang, "tp_adam", "upd")]
    assert rec["upd"] == _slice_shapes(whole)
    assert rec["memory"]["updater_fraction"] == 0.5


def _slice_shapes(shapes, tp=2):
    out = []
    for s in shapes:
        spec = _tp_spec(tuple(s), tp)
        out.append([n // tp if a == "tp" else n
                    for n, a in zip(s, spec + (None,) * len(s))])
    return out


def test_tp_ranks_hold_only_their_slices(gang):
    """Inside fit every rank holds its `_tp_spec` slices of the params and
    the updater state, off the flat carry; after fit the params are whole
    again. The MLP's four leaves all shard except the output bias."""
    whole = [list(a.shape) for a in _field(gang, "tp_mlp", "params")]
    for f in gang["facts"]:
        rec = f["tp_mlp"]
        assert rec["mesh"]["tp"] == 2 and rec["mesh"]["dp"] == 2
        assert rec["params"] == _slice_shapes(whole)
        assert rec["whole_after"] == whole
        assert rec["flat_chain"] is False
        mem = rec["memory"]
        assert mem == rec["tp_memory"]
        n_whole = sum(int(np.prod(s)) for s in whole)
        n_mine = sum(int(np.prod(s)) for s in rec["params"])
        assert mem["param_bytes"] == 4 * n_mine
        assert mem["param_bytes_full"] == 4 * n_whole
        assert 0.5 < mem["param_fraction"] < 0.52     # b[4] replicated


def test_tp_conv_gathered_on_use_matches_jax_and_one_process(gang):
    d = gang["data"]
    batches = [(d["conv_x"], d["conv_y"])] * 3
    got = _field(gang, "tp_conv", "params")
    jnet = _jax_tp("conv", batches)
    _close(got, _np(jnet.params), TP_TOL)
    _close(_field(gang, "tp_conv", "states"), _np(jnet.states), TP_TOL)
    ser = _port(gang, "conv")
    ser.fit(batches)
    _close(got, [t.numpy() for t in leaves(ser.params)], TP_TOL)
    conv = gang["facts"][0]["tp_conv"]["params"]
    assert conv[0] == [3, 3, 1, 2]          # kernel HWIO on its cout
    assert conv[-1] == [3] and conv[-2][1] == 3    # output W on its rows


def test_tp_windows_equal_single_steps(gang):
    a = _field(gang, "tp_k2", "params")
    b = _field(gang, "tp_mlp", "params")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_early_stopping_parallel_trainer_passes_tp(gang):
    d = gang["data"]
    x, y = d["mlp_x"], d["mlp_y"]
    ref = _port(gang, "mlp8")
    ref.fit([(x[:32], y[:32]), (x[32:], y[32:])], epochs=2)
    assert gang["facts"][0]["tp_early"]["mesh"]["tp"] == 2
    _close(_field(gang, "tp_early", "params"),
           [t.numpy() for t in leaves(ref.params)], TP_TOL)


def test_refusals_under_tp_match_jax(gang):
    """ZeRO-1, local SGD and the stale trainer refuse tp > 1 with the JAX
    package's messages; TrainingMaster trains on the tp mesh as JAX's
    does (its params replicated over tp, each dp coordinate's ranks
    feeding that coordinate's rows), within TP_TOL of JAX's TrainingMaster
    on make_mesh(dp=2, tp=2)."""
    from deeplearning4j_tpu.parallel.training_master import (
        TrainingMaster as JTM,
    )

    r = gang["facts"][0]["tp_refusals"]
    assert r["zero1"] == [
        "NotImplementedError", "sharding='zero1' requires tp == 1 (the "
        "ZeRO update shards the dp axis of replicated params)"]
    local = ["NotImplementedError", "averaging_frequency > 1 requires tp "
             "== 1 (local-SGD shards carry full param replicas)"]
    assert r["local_sgd"] == local and r["local_step"] == local
    assert r["stale"] == ["NotImplementedError",
                          "StaleGradientTrainer requires tp == 1"]
    assert r["training_master"] is None
    assert gang["facts"][0]["tp_tm"]["iteration"] == 2
    d = gang["data"]
    jnet = _mlp8()
    JTM(jnet, mesh=jmake_mesh(dp=2, tp=2, devices=jax.devices("cpu")[:4])
        ).fit(lambda s: (d["mlp_x"], d["mlp_y"]), 2)
    _close(_field(gang, "tp_tm", "params"), _np(jnet.params), TP_TOL)
