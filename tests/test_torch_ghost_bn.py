"""Ghost-batch BatchNorm statistics (`stat_sample=k > 1`) under per-step
data parallelism: one 2-rank gloo gang (tests/fixtures/torch/
mesh_worker.py's `ghost_dp`, which imports only the port) trains
through ParallelWrapper at dp 2 on the CPU — the conv net's BatchNorm
layer (stat_sample=2), a ragged 13-row batch (stat_sample=3: padded to
14, the statistics' leading 5 rows on rank 0 alone), and the mini ResNet
with stat_sample=2 on every BatchNorm in "none" (the layer) and "pallas"
(the fused tier, whose ghost statistics take the composed route, as in
the JAX package). The tests hold each run against the JAX package's
ParallelWrapper on make_mesh(dp=2) of the virtual CPU devices and against
the port's one-process fit of the same (padded) batches. Every net is
dropout-free.

Tolerances, stated per comparison:
  - JAX_TOL (rtol 1e-5, atol 1e-5): against JAX's ParallelWrapper on the
    same mesh, weights and batches;
  - SERIAL_TOL (rtol 1e-5, atol 1e-5): against the port's one-process
    fit (the statistics of the global batch's leading rows, summed on
    the ranks that hold them);
  - exact: `collectives.ghost_rows`' split of the rows.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JBN,
    ConvolutionLayer as JConv,
    OutputLayer as JOut,
    SubsamplingLayer as JSub,
)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.sharding import pad_batch_with_masks
from deeplearning4j_tpu_torch.util.tree import leaves
from test_helpers import _mini_resnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch")
sys.path.insert(0, FIXTURES)
from mesh_worker import launch  # noqa: E402
from scaleout_worker import Gang  # noqa: E402
from test_torch_scaleout_gang import _np  # noqa: E402

WORKER = os.path.join(FIXTURES, "mesh_worker.py")
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
SERIAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _ghost_conv(k, seed=3):
    """tests/test_parallel.py's conv + BatchNorm net, its statistics from
    the leading 1/k of the batch."""
    conf = (JNNC.Builder().seed(seed).updater("sgd").learning_rate(0.05)
            .weight_init("xavier").list()
            .layer(JConv(kernel_size=(3, 3), n_out=4, activation="relu"))
            .layer(JBN(stat_sample=k))
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JOut(n_out=3, loss="mcxent"))
            .set_input_type(JInputType.convolutional(8, 8, 1)).build())
    return JMLN(conf).init()


def _ghost_mini(mode="none"):
    """The mini ResNet with stat_sample=2 on every BatchNorm."""
    conf = _mini_resnet(mode).conf
    for node in conf.nodes:
        if isinstance(node.obj, JBN):
            node.obj.stat_sample = 2
    return JGraph(conf).init()


JNETS = {"ghost2": lambda: _ghost_conv(2), "ghost3": lambda: _ghost_conv(3),
         "mini_none": lambda: _ghost_mini("none"),
         "mini_pallas": lambda: _ghost_mini("pallas")}
# scenario: (net, data key, steps) — mesh_worker.ghost_dp's cases
CASES = {"ghost_conv": ("ghost2", "conv", 3), "ghost_rag": ("ghost3", "rag", 1),
         "ghost_mini_none": ("mini_none", "mini", 2),
         "ghost_mini_pallas": ("mini_pallas", "mini", 2)}


def _data():
    rng = np.random.default_rng(21)
    onehot = lambda n, c: np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    d = {}
    for key, n in (("conv", 16), ("rag", 13)):
        x = rng.normal(size=(n, 8, 8, 1)).astype(np.float32)
        x[n // 2:] = x[n // 2:] * 3 + 1      # the two dp halves differ
        d[f"{key}_x"], d[f"{key}_y"] = x, onehot(n, 3)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    x[4:] = x[4:] * 2 + 0.5
    d["mini_x"], d["mini_y"] = x, onehot(8, 5)
    return d


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The JAX-initialized nets and data, then the 2-rank gang's
    `ghost_dp`: {"io", "out": [npz per rank], "facts": [dict per rank],
    "data"}."""
    io = str(tmp_path_factory.mktemp("ghost_bn"))
    spec = {"nets": {}, "helpers": {"mini_none": "none",
                                    "mini_pallas": "pallas"}}
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
    launch(WORKER, io, 2, ("--only", "ghost_dp"))
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


def _batches(g, scen):
    name, key, steps = CASES[scen]
    d = g["data"]
    return [(d[f"{key}_x"], d[f"{key}_y"])] * steps


def test_gang_ranks_agree_and_no_scenario_failed(gang):
    for f in gang["facts"]:
        assert f["_failed"] == {}
    a, b = gang["out"]
    assert sorted(k.split("/")[0] for k in a if k.endswith("params:0")) == \
        sorted(CASES)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("scen", sorted(CASES))
def test_ghost_statistics_under_dp_match_jax(gang, scen):
    jnet = JNETS[CASES[scen][0]]()
    JPW(jnet, mesh=jmake_mesh(dp=2, devices=jax.devices("cpu")[:2])).fit(
        _batches(gang, scen))
    _close(_field(gang, scen, "params"), _np(jnet.params), JAX_TOL)
    _close(_field(gang, scen, "states"), _np(jnet.states), JAX_TOL)


@pytest.mark.parametrize("scen", sorted(CASES))
def test_ghost_statistics_under_dp_match_one_process(gang, scen):
    ser = Gang(gang["io"], 0, 1, "cpu").net(CASES[scen][0])
    ser.fit([pad_batch_with_masks(2, x, y, None, None)
             for x, y in _batches(gang, scen)])
    _close(_field(gang, scen, "params"),
           [t.numpy() for t in leaves(ser.params)], SERIAL_TOL)
    _close(_field(gang, scen, "states"),
           [t.numpy() for t in leaves(ser.states)], SERIAL_TOL)


@pytest.mark.parametrize("world,rows,k,want", [
    (1, 13, 3, [(5, 5)]),
    (2, 7, 3, [(5, 5), (0, 5)]),
    (2, 8, 2, [(8, 8), (0, 8)]),
    (4, 3, 3, [(3, 4), (1, 4), (0, 4), (0, 4)]),
    (4, 3, 1, [(3, 12)] * 4),
    (3, 5, 2, [(5, 8), (3, 8), (0, 8)]),
])
def test_ghost_rows_split_the_global_leading_rows(world, rows, k, want):
    """ceil(N/k) of the global N = world * rows rows, counted from each
    coordinate's offset r * rows: all, some or none of a rank's rows."""
    got = []
    for r in range(world):
        g = collectives.AxisGroup(world, r, "gloo", tuple(range(world)))
        with collectives.dp_scope(g):
            got.append(collectives.ghost_rows(rows, k))
    assert got == want
