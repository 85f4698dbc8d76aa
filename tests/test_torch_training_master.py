"""The port's TrainingMaster, Retry/CircuitBreaker and checkpoint
integrity against the JAX package's, and against itself.

Parity (the JAX side on a 1-device mesh, `make_mesh(dp=1)`): the dense
Adam MLN of tests/test_engine.py at rtol 1e-5 / atol 1e-6 and the
`_mini_resnet("pallas")` graph (JAX's Pallas in interpret mode) at
tests/test_torch_train.py's LOSS_RTOL / PARAM_TOL, at
`steps_per_dispatch` 1 and 3 (a 7-step run: two groups and a 1-step
tail). A JAX-written checkpoint directory resumes in the port and
continues like JAX (dense tolerance), and the JAX package validates and
loads a port-written one bit for bit. Within the port, bit for bit: a
TrainingMaster fit against a hand-driven StepProgram, pipeline on
against off, a resume against an uninterrupted run, a guard's skip or
rollback against a run that never saw the poisoned batch. Counterparts
of the JAX package's resilience, engine and self-healing drills."""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.parallel.mesh import make_mesh
from deeplearning4j_tpu.parallel.training_master import (
    TrainingMaster as JTrainingMaster,
)
from deeplearning4j_tpu.resilience import (
    checkpoint_integrity as jci,
)
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import metrics as tobs
from deeplearning4j_tpu_torch.parallel import MeshSpec, TrainingMaster
from deeplearning4j_tpu_torch.resilience import (
    CheckpointIntegrityError,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    FaultInjectedError,
    NonFiniteGuard,
    NonFiniteLossError,
    PreemptedError,
    Retry,
    RetriesExhaustedError,
    apply_retention,
    atomic_writer,
    compute_state_digest,
    fire_hang_hard,
    injector,
    list_all_checkpoints,
    newest_valid_checkpoint,
    read_manifest,
    record_checksum,
    require_valid,
    require_valid_tree,
    sha256_file,
    state_digest,
    validate_file,
    validate_tree,
    write_tree_manifest,
)
from deeplearning4j_tpu_torch.resilience import checkpoint_integrity as tci
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from deeplearning4j_tpu_torch.util.tree import leaves
from test_helpers import _data, _mini_resnet
from test_torch_engine import _assert_bitwise, _port_net, _state
from test_torch_train import (
    LOSS_RTOL,
    PARAM_TOL,
    _assert_trees_close,
    _nesterov_mini_resnet,
    _port_of,
)

N_IN, N_OUT, ROWS = 4, 3, 16
# the dense MLN against JAX (tests/test_torch_mln.py's forward bar)
DENSE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_injector():
    injector().clear()
    yield
    injector().clear()


def _jnet(seed=7, lr=1e-2):
    """tests/test_engine.py's net: dense tanh + softmax output, Adam."""
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import InputType
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("adam")
            .learning_rate(lr).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=N_OUT, loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN))
            .build())
    return JMLN(conf).init()


def _tnet(jnet=None):
    """The port's twin of `jnet` (default: a fresh `_jnet()`): its
    configuration through JSON, its params through params_from_jax."""
    jnet = _jnet() if jnet is None else jnet
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    net.params, net.states = params_from_jax(
        tonp(jnet.params), tonp(jnet.states), device="cpu")
    return net


def _batch(step):
    rng = np.random.default_rng(500 + step)
    x = rng.normal(size=(ROWS, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, ROWS)]
    return x, y


def _jtm(jnet, **kw):
    return JTrainingMaster(jnet, mesh=make_mesh(dp=1), **kw)


def _np_leaves(tree):
    return [np.asarray(t.detach().cpu()) if isinstance(t, torch.Tensor)
            else np.asarray(JTrainingMaster._host_leaf(t))
            for t in (leaves(tree) if _is_port(tree)
                      else jax.tree_util.tree_leaves(tree))]


def _is_port(tree):
    return any(isinstance(t, torch.Tensor) for t in leaves(tree))


def _assert_close_to_jax(jnet, net, **tol):
    _assert_trees_close(jnet.params, net.params, **tol)
    _assert_trees_close(jnet.updater_states, net.updater_states, **tol)
    _assert_trees_close(jnet.states, net.states, **tol)
    assert net.iteration == jnet.iteration


def _oracle(order):
    """A hand-driven StepProgram over the batches of `order`."""
    net = _tnet()
    prog = StepProgram(net)
    for s in order:
        prog.run(*_batch(s))
    return net


# ------------------------------------------------------- parity with JAX


@pytest.mark.parametrize("k", [1, 3])
def test_training_master_matches_jax_dense_adam(k):
    jnet = _jnet()
    net = _tnet(jnet)
    _jtm(jnet, steps_per_dispatch=k).fit(_batch, 7)
    TrainingMaster(net, steps_per_dispatch=k).fit(_batch, 7)
    assert net.iteration == 7
    _assert_close_to_jax(jnet, net, **DENSE_TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_training_master_matches_jax_mini_resnet_pallas(k):
    rng = np.random.default_rng(31)
    data = [_data(rng, 8) for _ in range(7)]
    jnet = _mini_resnet("pallas")
    net = _port_of(jnet)
    _jtm(jnet, steps_per_dispatch=k).fit(lambda s: data[s], 7)
    TrainingMaster(net, steps_per_dispatch=k).fit(lambda s: data[s], 7)
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=LOSS_RTOL)
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)
    assert net.iteration == jnet.iteration == 7


# -------------------------------------------------- bit for bit, in port


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_training_master_equals_hand_driven_step_program(k, pipeline):
    """The mini ResNet on its flat carry (Adam, a step lr schedule): a
    fit of 7 steps equals seven StepProgram.run calls, and at k=3 the
    hand-driven run_group windows (3, 3, 1), bit for bit."""
    data = [_data(np.random.default_rng(40 + s), 8) for s in range(7)]
    kw = dict(updater="adam", lr_policy="step", lr_policy_decay_rate=0.5,
              lr_policy_steps=2.0)
    net, ref, grp = _port_net(**kw), _port_net(**kw), _port_net(**kw)
    tm = TrainingMaster(net, steps_per_dispatch=k, pipeline=pipeline)
    tm.fit(lambda s: data[s], 7)
    assert net._flat_train is not None        # the carry stayed flat
    prog = StepProgram(ref)
    for x, y in data:
        prog.run(x, y)
    _assert_bitwise(net, ref)
    gprog = StepProgram(grp)
    for lo, hi in ((0, 3), (3, 6), (6, 7)):
        gprog.run_group(np.stack([d[0] for d in data[lo:hi]]),
                        np.stack([d[1] for d in data[lo:hi]]))
    _assert_bitwise(net, grp)
    assert tm._harness.program.net is net
    facts = tm.training_stats()["pipeline"]
    assert (facts is not None) == pipeline
    if pipeline:
        assert facts["kind"] == "step" and facts["batches"] == 7


def test_training_master_follows_the_nets_device_and_keeps_it():
    net = _tnet()
    TrainingMaster(net).fit(_batch, 2)
    assert all(t.device.type == "cpu" for t in _state(net))


def test_steps_per_dispatch_is_a_pure_dispatch_knob():
    a, b = _tnet(), _tnet()
    TrainingMaster(a).fit(_batch, 8)
    TrainingMaster(b, steps_per_dispatch=4).fit(_batch, 8)
    _assert_bitwise(a, b)


# ------------------------------------------------ checkpoints across packages


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A directory the JAX package wrote (Adam m/v, iteration) resumes in
    the port at its newest step, and the port's continuation ends where
    JAX's own continuation ends (dense tolerance)."""
    ck = str(tmp_path / "jax")
    _jtm(_jnet(), checkpoint_dir=ck, checkpoint_every=2).fit(_batch, 4)
    jref = _jnet(seed=8)                       # other init: restore wins
    _jtm(jref, checkpoint_dir=_copy(ck, tmp_path / "j2")).fit(_batch, 6)
    net = _tnet(_jnet(seed=8))
    tm = TrainingMaster(net, checkpoint_dir=_copy(ck, tmp_path / "p"))
    assert tm.load_latest_checkpoint() == 4 and net.iteration == 4
    tm.fit(_batch, 6)
    assert net.iteration == jref.iteration == 6
    _assert_close_to_jax(jref, net, **DENSE_TOL)


@pytest.mark.parametrize("model", ["dense", "mini_resnet"])
def test_port_checkpoint_validates_and_loads_in_jax(tmp_path, model):
    """JAX's validate_file, compute_state_digest and TrainingMaster read
    a port-written directory: the same params, updater state, BN states
    and iteration, bit for bit."""
    ck = str(tmp_path / "ck")
    if model == "dense":
        net, jnet, bf = _tnet(), _jnet(seed=8), _batch
    else:
        data = [_data(np.random.default_rng(50 + s), 8) for s in range(4)]
        net = _port_of(_nesterov_mini_resnet("pallas"))
        jnet, bf = _nesterov_mini_resnet("pallas"), (lambda s: data[s])
    TrainingMaster(net, checkpoint_dir=ck, checkpoint_every=2,
                   steps_per_dispatch=2).fit(bf, 4)
    fn = "step-00000004.npz"
    assert jci.validate_file(ck, fn) and validate_file(ck, fn)
    entry = jci.read_manifest(ck)[fn]
    assert entry["step"] == 4
    assert entry["state_sha256"] == jci.compute_state_digest(
        os.path.join(ck, fn)) == compute_state_digest(os.path.join(ck, fn))
    with open(os.path.join(ck, "latest.json")) as f:
        assert json.load(f) == {"step": 4, "iteration": 4, "epoch": 0}
    jtm = _jtm(jnet, checkpoint_dir=ck)
    assert jtm.load_latest_checkpoint() == 4
    assert jnet.iteration == 4
    for group, mine, theirs in (
            ("params", net.params, jnet.params),
            ("upd", net.updater_states, jnet.updater_states),
            ("states", net.states, jnet.states)):
        a, b = _np_leaves(mine), _np_leaves(theirs)
        assert len(a) == len(b), group
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes(), group


def test_checkpoint_keys_follow_the_jax_layout(tmp_path):
    net = _port_net(updater="nesterovs")
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path))
    tm.fit(lambda s: _data(np.random.default_rng(s), 8), 1)
    tm.save_checkpoint(1)
    with np.load(tmp_path / "step-00000001.npz") as z:
        files = set(z.files)
        assert z["rng"].shape == (2,) and z["rng"].dtype == np.uint32
        assert z["torch_rng"].dtype == np.uint8
        assert int(z["step"]) == 1 and int(z["iteration"]) == 1
    n = lambda tree: len(leaves(tree))
    want = ({f"params:{i}" for i in range(n(net.params))}
            | {f"states:{i}" for i in range(n(net.states))}
            | {f"upd:{i}" for i in range(n(net.updater_states))}
            | {"rng", "torch_rng", "step", "iteration", "epoch"})
    assert files == want


# ----------------------------------------------- resume, bit for bit


def test_resume_from_a_checkpoint_is_bitwise(tmp_path):
    """8 uninterrupted steps against a fresh net (another init) that
    restores step 4 and trains to 8."""
    data = [_data(np.random.default_rng(60 + s), 8) for s in range(8)]
    bf = lambda s: data[s]
    ref = _port_net(updater="nesterovs")
    TrainingMaster(ref, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                   steps_per_dispatch=4).fit(bf, 8)
    net = _port_net(updater="nesterovs", seed=3)
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        steps_per_dispatch=4)
    assert tm.load_checkpoint_at(4) == 4
    tm.fit(bf, 8, start_step=4)
    _assert_bitwise(ref, net)


def test_dropout_generator_state_rides_the_checkpoint(tmp_path):
    def build():
        conf = MultiLayerConfiguration.from_json(_jnet().conf.to_json())
        conf.layers[0].dropout = 0.5
        return MultiLayerNetwork(conf, device="cpu").init()

    ref = build()
    TrainingMaster(ref, checkpoint_dir=str(tmp_path),
                   checkpoint_every=2).fit(_batch, 4)
    net = build()
    TrainingMaster(net).fit(_batch, 1)          # moves the generator
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path))
    tm.load_checkpoint_at(2)
    tm.fit(_batch, 4, start_step=2)
    _assert_bitwise(ref, net)
    assert torch.equal(ref._rng_state(), net._rng_state())


def test_load_checkpoint_at_raises_on_a_missing_or_torn_step(tmp_path):
    tm = TrainingMaster(_tnet(), checkpoint_dir=str(tmp_path),
                        checkpoint_every=2)
    tm.fit(_batch, 4)
    with pytest.raises(CheckpointIntegrityError):
        tm.load_checkpoint_at(3)
    with open(tmp_path / "step-00000004.npz", "r+b") as f:
        f.truncate(30)
    with pytest.raises(CheckpointIntegrityError):
        tm.load_checkpoint_at(4)
    assert tm.load_checkpoint_at(0) == 0
    assert tm.load_latest_checkpoint() == 2


# ------------------------------------------ retry / circuit breaker


def test_retry_recovers_from_transient_errors():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 42

    assert Retry(max_attempts=4, initial_backoff_s=0.001).call(flaky) == 42
    assert len(calls) == 3


def test_retry_exhaustion_and_passthrough():
    with pytest.raises(RetriesExhaustedError) as ei:
        Retry(max_attempts=2, initial_backoff_s=0.001).call(
            lambda: (_ for _ in ()).throw(OSError("down")))
    assert ei.value.attempts == 2
    assert isinstance(ei.value.cause, OSError)
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        Retry(max_attempts=5, initial_backoff_s=0.001).call(boom)
    assert len(calls) == 1


def test_retry_backoff_matches_jax_for_a_seed():
    from deeplearning4j_tpu.resilience import Retry as JRetry

    a = list(Retry(max_attempts=5, seed=9).backoffs())
    assert a == list(Retry(max_attempts=5, seed=9).backoffs())
    assert a == list(JRetry(max_attempts=5, seed=9).backoffs())
    assert all(x > 0 for x in a)


def test_retry_deadline():
    fake_now = [0.0]
    with pytest.raises(DeadlineExceededError):
        Retry(max_attempts=10, initial_backoff_s=5.0, deadline_s=1.0,
              sleep=lambda s: fake_now.__setitem__(0, fake_now[0] + s),
              clock=lambda: fake_now[0]).call(
            lambda: (_ for _ in ()).throw(OSError("down")))


def test_circuit_breaker_open_halfopen_close():
    now = [0.0]
    cb = CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                        clock=lambda: now[0])

    def fail():
        raise OSError("down")

    for _ in range(2):
        with pytest.raises(OSError):
            cb.call(fail)
    assert cb.state == CircuitBreaker.OPEN
    with pytest.raises(CircuitOpenError) as ei:
        cb.call(lambda: 1)
    assert ei.value.retry_after_s > 0
    now[0] = 11.0   # past reset_timeout: one probe allowed
    assert cb.state == CircuitBreaker.HALF_OPEN
    assert cb.call(lambda: "ok") == "ok"
    assert cb.state == CircuitBreaker.CLOSED
    # a failed probe re-opens at once
    for _ in range(2):
        with pytest.raises(OSError):
            cb.call(fail)
    now[0] = 22.0
    with pytest.raises(OSError):
        cb.call(fail)
    assert cb.state == CircuitBreaker.OPEN


# ----------------------------------------- atomic writes + manifests


def test_atomic_writer_publishes_nothing_on_crash(tmp_path):
    target = str(tmp_path / "file.bin")
    with pytest.raises(RuntimeError):
        with atomic_writer(target) as tmp:
            with open(tmp, "wb") as f:
                f.write(b"half a paylo")
            raise RuntimeError("kill -9 mid-write")
    assert not os.path.exists(target)
    assert not os.path.exists(target + ".tmp")


def _write_step(d, step):
    p = os.path.join(d, tci.step_filename(step))
    with atomic_writer(p, suffix=".tmp.npz") as tmp:
        with open(tmp, "wb") as f:
            np.savez(f, a=np.arange(step))
        digest, size = sha256_file(tmp), os.path.getsize(tmp)
    record_checksum(d, os.path.basename(p), digest, size)
    return p


def test_checksum_manifest_detects_torn_write(tmp_path):
    d = str(tmp_path)
    p = _write_step(d, 2)
    assert validate_file(d, os.path.basename(p))
    require_valid(d, os.path.basename(p))
    assert jci.read_manifest(d) == read_manifest(d)
    before = tobs.get_registry().counter_value(
        "dl4j_checkpoint_validate_failures_total")
    with open(p, "r+b") as f:
        f.truncate(10)
    assert not validate_file(d, os.path.basename(p))
    assert not jci.validate_file(d, os.path.basename(p))
    with pytest.raises(CheckpointIntegrityError):
        require_valid(d, os.path.basename(p))
    assert newest_valid_checkpoint(d) is None
    assert tobs.get_registry().counter_value(
        "dl4j_checkpoint_validate_failures_total") > before


def test_retention_prunes_oldest(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        _write_step(d, step)
    os.makedirs(os.path.join(d, "step-5.orbax"))
    assert [s for s, _ in list_all_checkpoints(d)] == [1, 2, 3, 4, 5]
    assert apply_retention(d, keep_last=2) == [1, 2, 3]
    assert newest_valid_checkpoint(d) == 4
    assert sorted(os.listdir(d)) == [
        "manifest.json", "step-00000004.npz", "step-5.orbax"]
    assert set(read_manifest(d)) == {"step-00000004.npz"}
    assert apply_retention(d, keep_last=0) == []


def test_tree_manifest_detects_a_torn_directory(tmp_path):
    d = tmp_path / "step-3.orbax"
    (d / "sub").mkdir(parents=True)
    (d / "a.bin").write_bytes(b"x" * 100)
    (d / "sub" / "b.bin").write_bytes(b"y" * 50)
    entries = write_tree_manifest(str(d))
    assert set(entries) == {"a.bin", os.path.join("sub", "b.bin")}
    assert validate_tree(str(d)) and jci.validate_tree(str(d))
    require_valid_tree(str(d))
    (d / "sub" / "b.bin").write_bytes(b"y" * 49)
    assert not validate_tree(str(d))
    with pytest.raises(CheckpointIntegrityError):
        require_valid_tree(str(d))
    assert not validate_tree(str(tmp_path / "missing"))


def test_state_digest_is_recorded_or_recomputed(tmp_path):
    d = str(tmp_path)
    p = _write_step(d, 3)
    fn = os.path.basename(p)
    assert state_digest(d, fn) == compute_state_digest(p) \
        == jci.compute_state_digest(p)
    record_checksum(d, fn, sha256_file(p), os.path.getsize(p),
                    extra={"state_sha256": "abc"})
    assert state_digest(d, fn) == "abc"
    assert state_digest(d, "step-00000009.npz") is None


# ------------------------------------ crash-safe TrainingMaster resume


def test_resume_skips_corrupt_newest_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    TrainingMaster(_tnet(), checkpoint_dir=ck, checkpoint_every=2).fit(
        _batch, 4)
    with open(os.path.join(ck, "step-00000004.npz"), "r+b") as f:
        f.truncate(20)
    tm = TrainingMaster(_tnet(), checkpoint_dir=ck, checkpoint_every=2)
    assert tm.load_latest_checkpoint() == 2


def test_checkpoint_kill_mid_write_resumes_identically(tmp_path):
    """A 'raise' at checkpoint.write kills the step-4 save mid-flight:
    nothing partial is published, a relaunch resumes from step 2 and
    ends bit for bit where an uninterrupted run ends."""
    ref = _tnet()
    TrainingMaster(ref, checkpoint_dir=str(tmp_path / "ref"),
                   checkpoint_every=2).fit(_batch, 6)
    ck = str(tmp_path / "chaos")
    injector().inject("checkpoint.write", mode="raise", at_hit=2)
    with pytest.raises(FaultInjectedError):
        TrainingMaster(_tnet(), checkpoint_dir=ck,
                       checkpoint_every=2).fit(_batch, 6)
    injector().clear()
    assert sorted(f for f in os.listdir(ck) if f.startswith("step-")) \
        == ["step-00000002.npz"]
    net = _tnet()
    TrainingMaster(net, checkpoint_dir=ck, checkpoint_every=2).fit(_batch, 6)
    _assert_bitwise(ref, net)


def test_checkpoint_torn_write_falls_back_and_resumes(tmp_path):
    ref = _tnet()
    TrainingMaster(ref, checkpoint_dir=str(tmp_path / "ref"),
                   checkpoint_every=2).fit(_batch, 6)
    ck = str(tmp_path / "chaos")
    injector().inject("checkpoint.write", mode="truncate", at_hit=2,
                      truncate_to=16)
    TrainingMaster(_tnet(), checkpoint_dir=ck, checkpoint_every=2).fit(
        _batch, 4)   # completes; the step-4 file is silently torn
    injector().clear()
    assert not jci.validate_file(ck, "step-00000004.npz")
    tm = TrainingMaster(_tnet(), checkpoint_dir=ck, checkpoint_every=2)
    assert tm.load_latest_checkpoint() == 2
    tm.fit(_batch, 6)
    _assert_bitwise(ref, tm.net)


def test_checkpoint_retry_survives_a_transient_oserror(tmp_path):
    injector().inject("checkpoint.write", mode="raise", at_hit=1,
                      exc_factory=lambda p, n: OSError("flaky disk"))
    tm = TrainingMaster(_tnet(), checkpoint_dir=str(tmp_path),
                        checkpoint_every=2,
                        checkpoint_retry=Retry(max_attempts=2,
                                               initial_backoff_s=0.001))
    tm.fit(_batch, 2)
    assert tm.list_checkpoints() == [2]
    assert validate_file(str(tmp_path), "step-00000002.npz")


def test_keep_last_retention_through_training(tmp_path):
    tm = TrainingMaster(_tnet(), checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=1, keep_last=2)
    tm.fit(_batch, 5)
    assert tm.list_checkpoints() == [4, 5]


def test_checkpoint_metrics_are_emitted(tmp_path):
    reg = tobs.get_registry()
    w0 = reg.counter_value("dl4j_checkpoint_writes_total")
    r0 = reg.counter_value("dl4j_checkpoint_restores_total")
    tm = TrainingMaster(_tnet(), checkpoint_dir=str(tmp_path),
                        checkpoint_every=1)
    tm.fit(_batch, 3)
    tm.load_latest_checkpoint()
    assert reg.counter_value("dl4j_checkpoint_writes_total") == w0 + 3
    assert reg.counter_value("dl4j_checkpoint_restores_total") == r0 + 1
    snap = reg.snapshot()
    assert snap["histograms"]["dl4j_checkpoint_restore_seconds"]["count"]
    assert snap["gauges"]["dl4j_cluster_world_size"][""] == 1.0


# -------------------------------------------- guard drills (k-groups)


def test_k_group_condemns_single_poisoned_inner_step(tmp_path):
    """One NaN batch inside a k=4 window condemns THAT inner step only:
    the window replays without it (rolled back to the checkpoint) and
    the run ends where a run that never saw the batch ends."""
    net = _tnet()
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=4, steps_per_dispatch=4,
                        guard=NonFiniteGuard("rollback", check_every=1))
    injector().inject("train.grad_nonfinite", at_hit=3)  # poison step 2
    tm.fit(_batch, 8)
    assert sorted(tm._poisoned_steps) == [2]
    assert tm.guard.counters["nonfinite"] >= 1
    _assert_bitwise(net, _oracle([0, 1, 3, 4, 5, 6, 7]))


@pytest.mark.parametrize("pipeline", [True, False])
def test_k_group_skip_step_policy(pipeline):
    net = _tnet()
    tm = TrainingMaster(net, steps_per_dispatch=4, pipeline=pipeline,
                        guard=NonFiniteGuard("skip_step", check_every=1))
    injector().inject("train.grad_nonfinite", at_hit=4)  # poison step 3
    tm.fit(_batch, 8)
    assert sorted(tm._poisoned_steps) == [3]
    assert tm.guard.counters["skipped_steps"] == 1
    assert tm.resilience_stats()["counters"]["grad_poisoned_steps"] == 1
    _assert_bitwise(net, _oracle([0, 1, 2, 4, 5, 6, 7]))


@pytest.mark.parametrize("policy", ["skip_step", "rollback"])
def test_k_group_condemns_a_step_of_the_last_window(tmp_path, policy):
    """A poisoned step in the run's last window, whose batches the
    pipeline's producer fetched before it ran to its stop and exited:
    the window's replay restarts the producer instead of failing."""
    net = _tnet()
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=4, steps_per_dispatch=4,
                        guard=NonFiniteGuard(policy, check_every=1))
    injector().inject("train.grad_nonfinite", at_hit=7)  # poison step 6
    tm.fit(_batch, 8)
    assert sorted(tm._poisoned_steps) == [6]
    assert tm.training_stats()["pipeline"]["reseeks"] >= 1
    _assert_bitwise(net, _oracle([0, 1, 2, 3, 4, 5, 7]))


def test_rollback_after_nan_through_harness(tmp_path):
    net = _tnet()
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=2,
                        guard=NonFiniteGuard("rollback", check_every=1))
    injector().inject("train.grad_nonfinite", at_hit=5)  # poison step 4
    tm.fit(_batch, 8)
    assert tm.guard.counters["rollbacks"] == 1
    assert sorted(tm._poisoned_steps) == [4]
    _assert_bitwise(net, _oracle([0, 1, 2, 3, 5, 6, 7]))


# ------------------------------------------- guard policies (k=1)


def test_guard_skip_step_leaves_state_byte_identical():
    net = _tnet()
    g = NonFiniteGuard("skip_step", check_every=1)
    tm = TrainingMaster(net, guard=g)
    tm.fit(_batch, 2)
    before = [t.clone() for t in _state(net)]
    it = net.iteration
    injector().inject("train.grad_nonfinite", at_hit=1)
    tm.fit(_batch, 3, start_step=2)
    assert g.counters["nonfinite"] == 1 and g.counters["skipped_steps"] == 1
    assert net.iteration == it
    for a, b in zip(before, _state(net)):
        assert torch.equal(a, b)


def test_guard_skip_matches_run_without_poisoned_batch():
    net = _tnet()
    g = NonFiniteGuard("skip_step", check_every=1)
    injector().inject("train.grad_nonfinite", at_hit=4)   # poison step 3
    TrainingMaster(net, guard=g).fit(_batch, 6)
    assert g.counters["skipped_steps"] == 1 and net.iteration == 5
    _assert_bitwise(net, _oracle([0, 1, 2, 4, 5]))


def test_guard_rollback_restores_checkpoint_and_skips_window(tmp_path):
    net = _tnet()
    g = NonFiniteGuard("rollback", check_every=1)
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=1, guard=g)
    injector().inject("train.grad_nonfinite", at_hit=4)   # poison step 3
    tm.fit(_batch, 6)
    assert g.counters["rollbacks"] == 1 and tm._poisoned_steps == {3}
    _assert_bitwise(net, _oracle([0, 1, 2, 4, 5]))
    _assert_checkpoints_finite(str(tmp_path))


def test_guard_rollback_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TrainingMaster(_tnet(), guard=NonFiniteGuard("rollback"))


def test_guard_abort_raises():
    tm = TrainingMaster(_tnet(), guard=NonFiniteGuard("abort",
                                                      check_every=1))
    injector().inject("train.grad_nonfinite", at_hit=2)
    with pytest.raises(NonFiniteLossError):
        tm.fit(_batch, 4)


def _assert_checkpoints_finite(ck):
    for step, fn in list_all_checkpoints(ck):
        with np.load(os.path.join(ck, fn)) as z:
            for key in z.files:
                if z[key].dtype.kind == "f":
                    assert np.isfinite(z[key]).all(), (fn, key)


def test_checkpoints_never_publish_nonfinite_state(tmp_path):
    """With sampled checking (check_every=3), a poison landing on an
    UNCHECKED step is still caught by the forced pre-checkpoint check."""
    net = _tnet()
    g = NonFiniteGuard("rollback", check_every=3)
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=1, guard=g)
    injector().inject("train.grad_nonfinite", at_hit=2)   # step 1
    tm.fit(_batch, 4)
    assert g.counters["nonfinite"] == 1 and tm._poisoned_steps == {1}
    _assert_checkpoints_finite(str(tmp_path))
    _assert_bitwise(net, _oracle([0, 2, 3]))


# ------------------------------------------------------- preemption


def test_preemption_fault_checkpoints_then_resumes(tmp_path):
    """The `train.preempt` fault checkpoints the current state and raises
    PreemptedError; a relaunch resumes to the un-faulted result."""
    net = _tnet()
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=2, preemption=True)
    injector().inject("train.preempt", at_hit=4)   # boundary of step 3
    with pytest.raises(PreemptedError) as ei:
        tm.fit(_batch, 6)
    assert ei.value.step == 3
    assert tm._resil_counters["preemptions"] == 1
    assert 3 in tm.list_checkpoints()
    assert signal.getsignal(signal.SIGTERM) is not \
        tm.preemption._on_signal   # uninstalled by the session
    tm.fit(_batch, 6)              # a supervised restart re-enters fit
    _assert_bitwise(net, _oracle(range(6)))


@pytest.mark.parametrize("k", [1, 2])
def test_sigterm_checkpoints_then_exits_and_resume_matches(tmp_path, k):
    net = _tnet()

    class KillAt:
        def iteration_done(self, n, iteration):
            if iteration == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    net.listeners.append(KillAt())
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=10, preemption=True,
                        steps_per_dispatch=k)
    with pytest.raises(PreemptedError) as ei:
        tm.fit(_batch, 6)
    assert ei.value.step == 2 and tm.list_checkpoints() == [2]
    net2 = _tnet()
    TrainingMaster(net2, checkpoint_dir=str(tmp_path), checkpoint_every=10,
                   preemption=True, steps_per_dispatch=k).fit(_batch, 6)
    _assert_bitwise(net2, _oracle(range(6)))


# --------------------------------------------------- flaky data


@pytest.mark.parametrize("pipeline", [True, False])
def test_data_next_transient_fault_is_retried(pipeline):
    net = _tnet()
    retry = Retry(max_attempts=3, initial_backoff_s=0.01,
                  retryable=lambda e: isinstance(e, FaultInjectedError))
    tm = TrainingMaster(net, data_retry=retry, pipeline=pipeline)
    injector().inject("data.next", at_hit=2)   # step 1, first attempt
    tm.fit(_batch, 4)
    assert net.iteration == 4
    assert injector().hits("data.next") == 5   # 4 fetches + 1 retry
    _assert_bitwise(net, _oracle(range(4)))


@pytest.mark.parametrize("k", [1, 2])
def test_data_fault_exhaustion_skips_step_without_corruption(k):
    net = _tnet()
    retry = Retry(max_attempts=2, initial_backoff_s=0.01,
                  retryable=lambda e: isinstance(e, FaultInjectedError))
    tm = TrainingMaster(net, data_retry=retry, skip_bad_batches=True,
                        steps_per_dispatch=k)
    before = tobs.get_registry().counter_value(
        "dl4j_train_data_skipped_steps_total")
    # hits 2+3 = both attempts of step 1 (exhausted -> skipped);
    # hit 4 = step 2's first attempt (retried ok on hit 5)
    injector().inject("data.next", at_hit=2, times=3)
    tm.fit(_batch, 4)
    assert tm._resil_counters["data_skipped_steps"] == 1
    assert tobs.get_registry().counter_value(
        "dl4j_train_data_skipped_steps_total") == before + 1
    assert net.iteration == 3
    _assert_bitwise(net, _oracle([0, 2, 3]))


def test_data_fault_without_a_policy_raises():
    injector().inject("data.next", at_hit=2)
    with pytest.raises(FaultInjectedError):
        TrainingMaster(_tnet()).fit(_batch, 4)


def test_train_step_fault_points_fire_once_per_step_or_group():
    TrainingMaster(_tnet()).fit(_batch, 3)
    assert [injector().hits(p) for p in
            ("train.step", "train.hang", "train.hang_hard")] == [3, 3, 3]
    injector().clear()
    injector().inject("train.hang_hard", mode="delay", at_hit=1,
                      delay_s=0.0)
    TrainingMaster(_tnet(), steps_per_dispatch=4).fit(_batch, 8)
    assert injector().hits("train.hang_hard") == 2
    fire_hang_hard()                 # armed: runs with signals blocked
    assert injector().hits("train.hang_hard") == 3


# -------------------------------------------------- evaluate, stats


def test_evaluate_matches_jax_evaluation_counts():
    jnet = _jnet()
    net = _tnet(jnet)

    def bf(step):
        x, y = _batch(step)
        lm = (np.arange(ROWS) % 3 != 0).astype(np.float32)
        return x, y, None, lm

    jev = _jtm(jnet).evaluate(bf, 3, JEvaluation())
    ev = TrainingMaster(net).evaluate(bf, 3, Evaluation())
    np.testing.assert_array_equal(ev.confusion.matrix,
                                  jev.confusion.matrix)
    assert ev.confusion.matrix.sum() == 3 * (ROWS - 6)
    unmasked = TrainingMaster(net).evaluate(_batch, 2)
    assert unmasked.confusion.matrix.sum() == 2 * ROWS
    assert unmasked.accuracy() == pytest.approx(
        JTrainingMaster(jnet, mesh=make_mesh(dp=1)).evaluate(
            _batch, 2).accuracy())


def test_training_stats_and_world_info():
    tm = TrainingMaster(_tnet(), steps_per_dispatch=2)
    tm.fit(_batch, 4, collect_training_stats=True)
    st = tm.training_stats()
    assert [s["step"] for s in st["steps"]] == [0, 2]
    assert set(st["summary"]) == {"data_ms", "fit_ms", "listener_ms",
                                  "checkpoint_ms"}
    assert st["resilience"] is None and st["wire"] is None
    assert tm.world_info() == {"processes": 1, "devices": 1, "dp": 1,
                               "sharding": "replicated",
                               "per_rank_checkpoints": False}
    assert TrainingMaster.process_info() == (0, 1)
    TrainingMaster.initialize_distributed("tcp://localhost:1", 1, 0)


@pytest.mark.parametrize("kw,queue", [
    # local SGD, ZeRO-1 and per-rank checkpoints are ported (queue 9a/9b,
    # tests/test_torch_scaleout*.py) and the non-dp mesh axes too (queue
    # 9c): in one process a mesh axis of 2 needs more processes than the
    # world has, JAX's ValueError (TrainingMaster's dp-only refusal at
    # world 4: tests/test_torch_tp.py)
    (dict(mesh=MeshSpec(tp=2)), 9),
    (dict(mesh=MeshSpec(sp=2), averaging_frequency=2), 9),
    (dict(mesh=MeshSpec(pp=2), averaging_frequency=2,
          threshold_compression=0.1), 9),
    (dict(mesh=MeshSpec(tp=2), sharding="zero1"), 9),
    (dict(mesh=MeshSpec(ep=2)), 9),
    (dict(mesh=MeshSpec(dp=-1, tp=2), per_rank_checkpoints=True), 9),
    (dict(mesh=MeshSpec(sp=2), guard_inner_steps=True), 9),
])
def test_unported_options_raise_and_name_their_queue(kw, queue):
    with pytest.raises(ValueError,
                       match="mesh needs 2 processes, only 1 available|"
                             "1 processes not divisible by fixed axes 2"):
        TrainingMaster(_tnet(), **kw)


def test_unported_entry_points_raise_and_name_their_queue(tmp_path):
    tm = TrainingMaster(_tnet())
    # export_stats_html raised (queue 8) until the observability slice
    tm.fit(_batch, 3, collect_training_stats=True)
    page = tmp_path / "x.html"
    assert tm.export_stats_html(str(page)) == str(page)
    assert page.read_text().count("<tr><td>") == 3
    # initialize_distributed joins a process group now (queue 9a); orbax
    # (a JAX library's format) is refused naming npz
    with pytest.raises(ValueError, match="npz"):
        TrainingMaster(_tnet(), checkpoint_format="orbax")
    with pytest.raises(ValueError, match="mesh needs 2 processes"):
        TrainingMaster(_tnet(), mesh=MeshSpec(tp=2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TrainingMaster(_tnet(), steps_per_dispatch=4, averaging_frequency=2)
    with pytest.raises(ValueError):
        TrainingMaster(_tnet(), threshold_compression=0.1)
    with pytest.raises(ValueError):
        TrainingMaster(_tnet(), checkpoint_format="zip")
