"""The port's ParallelWrapper and EarlyStoppingParallelTrainer against the
JAX package's (on a 1-device mesh, `make_mesh(dp=1)`), and against
itself.

Parity: the dense Adam MLN of tests/test_engine.py at rtol 1e-5 /
atol 1e-6 (k=1 and k=4 windows over 7 batches whose last is ragged, with
label masks on some batches), the `_mini_resnet("pallas")` graph (JAX's
Pallas in interpret mode) at tests/test_torch_train.py's LOSS_RTOL /
PARAM_TOL, a two-input two-output graph at the dense tolerance, and
EarlyStoppingParallelTrainer over 2 epochs at LOSS_RTOL / PARAM_TOL.
Within the port, bit for bit: a fit against a hand-driven StepProgram
(windows, shape breaks, synthesized masks), pipeline on against off,
a guard's skip and rollback against a fit that never saw the NaN batch,
and EarlyStoppingParallelTrainer against EarlyStoppingTrainer."""

import threading

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.earlystopping import (
    DataSetLossCalculator as JLossCalc,
    EarlyStoppingConfiguration as JESConf,
    EarlyStoppingParallelTrainer as JESParallel,
    InMemoryModelSaver as JSaver,
    MaxEpochsTerminationCondition as JMaxEpochs,
)
from deeplearning4j_tpu.parallel.mesh import make_mesh
from deeplearning4j_tpu.parallel.wrapper import (
    ParallelWrapper as JParallelWrapper,
)
from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator,
    DataSet,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingParallelTrainer,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileGraphSaver,
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper
from deeplearning4j_tpu_torch.resilience import NonFiniteGuard
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from test_helpers import _data, _mini_resnet
from test_torch_engine import _assert_bitwise, _port_net
from test_torch_train import (
    LOSS_RTOL,
    PARAM_TOL,
    _assert_trees_close,
    _port_of,
)
from test_torch_training_master import (
    DENSE_TOL,
    N_IN,
    N_OUT,
    _assert_close_to_jax,
    _jnet,
    _tnet,
)


def _batches(n=7, ragged=10, masked=(), seed=600):
    """n dense batches of 16 rows (the last `ragged` rows when given), a
    label mask with two rows out on the batches in `masked`."""
    out = []
    for s in range(n):
        rng = np.random.default_rng(seed + s)
        rows = ragged if (ragged and s == n - 1) else 16
        x = rng.normal(size=(rows, N_IN)).astype(np.float32)
        y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, rows)]
        if s in masked:
            lm = np.ones(rows, np.float32)
            lm[[s % rows, (s + 5) % rows]] = 0.0
            out.append((x, y, None, lm))
        else:
            out.append((x, y))
    return out


def _jpw(jnet, **kw):
    return JParallelWrapper(jnet, mesh=make_mesh(dp=1), **kw)


def _hand_driven(net, batches, k):
    """The oracle: StepProgram over the same windows a k-step fit forms
    (a shape break dispatches the window so far; a window that mixes
    masked and unmasked batches gets all-ones masks)."""
    prog = StepProgram(net)
    norm = [tuple(b) + (None,) * (4 - len(b)) for b in batches]
    if k == 1:
        for x, y, fm, lm in norm:
            prog.run(x, y, fm, lm)
        return net
    windows, cur = [], []
    for b in norm:
        if cur and (cur[-1][0].shape != b[0].shape
                    or (cur[-1][3] is not None and b[3] is not None
                        and cur[-1][3].shape != b[3].shape)):
            windows.append(cur)
            cur = []
        cur.append(b)
        if len(cur) == k:
            windows.append(cur)
            cur = []
    if cur:
        windows.append(cur)
    for w in windows:
        any_lm = any(b[3] is not None for b in w)
        lms = ([b[3] if b[3] is not None
                else np.ones(b[0].shape[0], np.float32) for b in w]
               if any_lm else None)
        prog.run_group(np.stack([b[0] for b in w]),
                       np.stack([b[1] for b in w]),
                       lms=None if lms is None else np.stack(lms))
    return net


# ------------------------------------------------------- parity with JAX


@pytest.mark.parametrize("k", [1, 4])
def test_parallel_wrapper_matches_jax_dense_adam(k):
    """7 batches, the last ragged (a shape break), label masks on
    batches 1 and 4 (windows mix masked and unmasked batches)."""
    data = _batches(masked=(1, 4))
    jnet = _jnet()
    net = _tnet(jnet)
    _jpw(jnet, steps_per_dispatch=k).fit(data)
    ParallelWrapper(net, steps_per_dispatch=k).fit(data)
    assert net.iteration == 7 and net.epoch == 1
    _assert_close_to_jax(jnet, net, **DENSE_TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_parallel_wrapper_matches_jax_mini_resnet_pallas(k):
    rng = np.random.default_rng(71)
    data = [_data(rng, 8) for _ in range(5)]
    jnet = _mini_resnet("pallas")
    net = _port_of(jnet)
    _jpw(jnet, steps_per_dispatch=k).fit(data)
    ParallelWrapper(net, steps_per_dispatch=k).fit(data)
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=LOSS_RTOL)
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)
    assert net.iteration == jnet.iteration == 5


def _two_io_jax():
    from deeplearning4j_tpu import ComputationGraph as JGraph
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import InputType
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.Builder().seed(9).updater("sgd")
            .learning_rate(0.1).weight_init("xavier").graph_builder()
            .add_inputs("a", "b")
            .add_layer("ha", DenseLayer(n_out=8, activation="tanh"), "a")
            .add_layer("hb", DenseLayer(n_out=8, activation="tanh"), "b")
            .add_layer("o1", OutputLayer(n_out=3, loss="mcxent"), "ha")
            .add_layer("o2", OutputLayer(n_out=2, loss="mcxent"), "hb")
            .set_outputs("o1", "o2")
            .set_input_types(a=InputType.feed_forward(5),
                             b=InputType.feed_forward(4))
            .build())
    return JGraph(conf).init()


def _two_io_port(jnet):
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    net.params, net.states = params_from_jax(
        tonp(jnet.params), tonp(jnet.states), device="cpu")
    return net


def _two_io_batches(n=4):
    rng = np.random.default_rng(81)
    out = []
    for _ in range(n):
        xa = rng.normal(size=(16, 5)).astype(np.float32)
        xb = rng.normal(size=(16, 4)).astype(np.float32)
        y1 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        y2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
        out.append(([xa, xb], [y1, y2]))
    return out


@pytest.mark.parametrize("pipeline", [True, False])
def test_multi_input_graph_matches_jax(pipeline):
    data = _two_io_batches()
    jnet = _two_io_jax()
    net = _two_io_port(jnet)
    _jpw(jnet).fit(data)
    pw = ParallelWrapper(net, pipeline=pipeline)
    pw.fit(data)
    assert pw._multi_io
    if pipeline:
        facts = pw._harness.pipeline_stats()
        assert facts["host_only"] and facts["batches"] == 4
    _assert_trees_close(jnet.params, net.params, **DENSE_TOL)
    assert net.iteration == 4


# -------------------------------------------------- bit for bit, in port


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_parallel_wrapper_equals_hand_driven_step_program(k, pipeline):
    data = _batches(masked=(1, 4))
    net = _tnet()
    ParallelWrapper(net, steps_per_dispatch=k, pipeline=pipeline).fit(data)
    _assert_bitwise(net, _hand_driven(_tnet(), data, k))


def test_mask_shapes_break_a_window_and_ragged_tail_runs_eagerly():
    """Batches 0-2 full, 3 ragged, 4-6 full: windows (0-2), (3), (4-6)
    at k=4 — the same state as seven steps."""
    data = _batches(n=7, ragged=0)
    x, y = data[3]
    data[3] = (x[:9], y[:9])
    net = _tnet()
    pw = ParallelWrapper(net, steps_per_dispatch=4)
    pw.fit(data)
    _assert_bitwise(net, _hand_driven(_tnet(), data, 1))


def test_fit_over_epochs_and_a_dataset_iterator():
    data = _batches(n=4, ragged=0)
    x = np.concatenate([b[0] for b in data])
    y = np.concatenate([b[1] for b in data])
    net = _tnet()
    ParallelWrapper(net, steps_per_dispatch=2).fit(
        ListDataSetIterator(DataSet(x, y), batch_size=16), epochs=2)
    assert net.epoch == 2 and net.iteration == 8
    _assert_bitwise(net, _hand_driven(_tnet(), data + data, 1))


def test_session_closes_the_iterator_and_it_stays_reusable():
    data = _batches(n=4, ragged=0)
    before = {t.name for t in threading.enumerate()}
    it = AsyncDataSetIterator(
        ListDataSetIterator(DataSet(np.concatenate([b[0] for b in data]),
                                    np.concatenate([b[1] for b in data])),
                            batch_size=16))
    ParallelWrapper(_tnet(), steps_per_dispatch=2).fit(it)
    assert it._thread is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("AsyncDataSetIterator")
                and t.name not in before and t.is_alive()]
    it.reset()
    assert len(list(it)) == 4            # a fresh pass afterwards
    it.close()


def test_session_closes_the_iterator_when_the_fit_raises():
    class Boom:
        def __init__(self):
            self.closed = False

        def __iter__(self):
            raise RuntimeError("data source down")

        def close(self):
            self.closed = True

    src = Boom()
    with pytest.raises(RuntimeError, match="down"):
        ParallelWrapper(_tnet(), pipeline=False).fit(src)
    assert src.closed


# --------------------------------------------------------- guard


@pytest.mark.parametrize("k", [1, 2])
def test_guard_skips_nan_batch(k):
    """A batch of NaN features is skipped (k=2: its window is rejected
    as a whole, so the fit equals one without that window)."""
    data = _batches(n=6, ragged=0)
    bad = (np.full_like(data[2][0], np.nan), data[2][1])
    g = NonFiniteGuard("skip_step", check_every=1)
    net = _tnet()
    ParallelWrapper(net, guard=g, steps_per_dispatch=k).fit(
        data[:2] + [bad] + data[3:])
    assert g.counters["skipped_steps"] == 1
    keep = data[:2] + data[3:] if k == 1 else data[:2] + data[4:]
    _assert_bitwise(net, _hand_driven(_tnet(), keep, 1))


def test_rollback_guard_needs_snapshots_and_restores_them():
    with pytest.raises(ValueError, match="snapshot_every"):
        ParallelWrapper(_tnet(), guard=NonFiniteGuard("rollback"))
    data = _batches(n=6, ragged=0)
    bad = (np.full_like(data[3][0], np.nan), data[3][1])
    g = NonFiniteGuard("rollback", check_every=1)
    net = _tnet()
    pw = ParallelWrapper(net, guard=g, snapshot_every=2)
    pw.fit(data[:3] + [bad] + data[4:])
    # snapshots before steps 0, 2, 4: the poison at step 3 rewinds to
    # the snapshot before step 2, dropping batch 2 as well
    assert g.counters["rollbacks"] == 1
    assert pw._snapshotter.counters["restores"] == 1
    _assert_bitwise(net, _hand_driven(_tnet(), data[:2] + data[4:], 1))


def test_output_is_the_nets_output():
    net = _tnet()
    pw = ParallelWrapper(net)
    x = _batches(n=1, ragged=0)[0][0]
    assert torch.equal(pw.output(x), net.output(x))


@pytest.mark.parametrize("kw", [
    # workers/mesh/local SGD/ZeRO-1 (queue 9a/9b, tests/test_torch_scaleout
    # *.py) and tensor and sequence parallelism (queue 9c, tests/
    # test_torch_tp.py) are ported: in one process a tp or sp mesh of 2
    # needs more processes than the world has, JAX's ValueError; ZeRO-1
    # refuses tp > 1 before any mesh is made
    dict(workers=2, tp=2), dict(tp=2), dict(mesh=MeshSpec(tp=2)),
    dict(averaging_frequency=2, mesh=MeshSpec(sp=2)),
    dict(sharding="zero1", tp=2),
])
def test_unported_options_raise_and_name_their_queue(kw):
    with pytest.raises((ValueError, NotImplementedError),
                       match="mesh needs [24] processes, only 1|"
                             "'zero1' requires tp == 1"):
        ParallelWrapper(_tnet(), **kw)


def test_invalid_options_raise_like_jax():
    with pytest.raises(ValueError, match="threshold_compression"):
        ParallelWrapper(_tnet(), threshold_compression=0.1)
    with pytest.raises(ValueError, match="sharding"):
        ParallelWrapper(_tnet(), sharding="fsdp")
    ParallelWrapper(_tnet(), workers=1, tp=1, sharding="replicated")


# ------------------------------------------ EarlyStoppingParallelTrainer


def _es_conf(cls, saver, calc, epochs):
    return cls(epoch_termination_conditions=[epochs], model_saver=saver,
               score_calculator=calc, evaluate_every_n_epochs=1)


def test_early_stopping_parallel_trainer_matches_jax():
    rng = np.random.default_rng(91)
    data = [_data(rng, 8) for _ in range(4)]
    held = [_data(rng, 8)]
    jnet = _mini_resnet("pallas")
    net = _port_of(jnet)
    jres = JESParallel(_es_conf(JESConf, JSaver(), JLossCalc(held),
                                JMaxEpochs(2)), jnet, data,
                       mesh=make_mesh(dp=1)).fit()
    res = EarlyStoppingParallelTrainer(
        _es_conf(EarlyStoppingConfiguration, InMemoryModelSaver(),
                 DataSetLossCalculator(held),
                 MaxEpochsTerminationCondition(2)), net, data).fit()
    assert res.total_epochs == jres.total_epochs == 2
    assert res.best_model_epoch == jres.best_model_epoch
    for e, s in jres.score_vs_epoch.items():
        np.testing.assert_allclose(res.score_vs_epoch[e], s, rtol=LOSS_RTOL)
    assert net.iteration == jnet.iteration == 8
    assert net.epoch == 1
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)


@pytest.mark.parametrize("pipeline", [True, False])
def test_early_stopping_parallel_equals_early_stopping_trainer(
        tmp_path, pipeline):
    rng = np.random.default_rng(92)
    data = [_data(rng, 8) for _ in range(4)]
    held = [_data(rng, 8)]
    a, b = _port_net(updater="nesterovs"), _port_net(updater="nesterovs")
    trainer = EarlyStoppingParallelTrainer(
        _es_conf(EarlyStoppingConfiguration,
                 LocalFileGraphSaver(str(tmp_path)),
                 DataSetLossCalculator(held),
                 MaxEpochsTerminationCondition(2)), a, data,
        pipeline=pipeline)
    res = trainer.fit()
    ref = EarlyStoppingTrainer(
        _es_conf(EarlyStoppingConfiguration,
                 LocalFileGraphSaver(str(tmp_path / "ref")),
                 DataSetLossCalculator(held),
                 MaxEpochsTerminationCondition(2)), b, data,
        pipeline=pipeline).fit()
    assert res.score_vs_epoch == ref.score_vs_epoch
    _assert_bitwise(a, b)
    if pipeline:
        assert trainer._harness.pipeline_stats()["host_only"]
    best = res.best_model
    assert best.score(held[0]) == res.score_vs_epoch[res.best_model_epoch]
