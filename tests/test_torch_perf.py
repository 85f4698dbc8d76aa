"""The port's cost model and step phase profiler against the JAX
package's, on the CPU (observability/perf.py, engine/step_program.py
`register_perf`, the harness's `phase_profiler`).

Tolerances: the analytic FLOP helpers and `perf_report`'s arithmetic
exactly (the same float expressions); `register_perf`'s counted FLOPs of
the mini ResNet within 3% of 3x its layers' forward FLOPs (forward plus
the two backward products of every conv and dense layer); phase names,
profiler steps and histogram counts exactly."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import perf as jperf
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JWrapper
from deeplearning4j_tpu_torch.engine import StepHarness, StepProgram
from deeplearning4j_tpu_torch.observability import metrics as tmetrics
from deeplearning4j_tpu_torch.observability import perf as tperf
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMaster
from test_helpers import _data
from test_torch_engine import _port_net
from test_torch_training_master import _batch, _jnet, _jtm, _tnet


@pytest.mark.parametrize("shape", [(7, 3, 5), (128, 2048, 1000),
                                   (1, 1, 1)])
def test_matmul_flops_equal_jax(shape):
    assert tperf.matmul_flops(*shape) == jperf.matmul_flops(*shape)


@pytest.mark.parametrize("shape", [(128, 112, 112, 64, 7, 7, 3),
                                   (32, 56, 56, 64, 3, 3, 64),
                                   (2, 7, 7, 2048, 1, 1, 512)])
def test_conv2d_flops_equal_jax(shape):
    assert tperf.conv2d_flops(*shape) == jperf.conv2d_flops(*shape)
    assert tperf.train_step_flops_from_params(25_583_592, 128) \
        == jperf.train_step_flops_from_params(25_583_592, 128)


def test_perf_report_equals_jax_for_the_same_entry_and_peaks():
    peaks = dict(peak_flops=989e12, peak_bytes_per_s=3.35e12)
    jcm = jperf.CostModel(**peaks)
    tcm = tperf.CostModel(device="cpu", **peaks)
    flops, nbytes = 3 * 2 * 4.09e9 * 128, 7.5e10
    for cm in (jcm, tcm):
        cm.register_analytic("step", flops, nbytes)
    jmetrics.get_registry().reset()
    tmetrics.get_registry().reset()
    got = tcm.perf_report("step", seconds_per_call=0.0733,
                          items_per_call=128)
    want = jcm.perf_report("step", seconds_per_call=0.0733,
                           items_per_call=128)
    assert got == want
    assert got["bound"] == "memory" and 0 < got["mfu"] < 1
    assert tcm.digest("step") == jcm.digest("step")
    jg, tg = (m.get_registry().snapshot()["gauges"]
              for m in (jmetrics, tmetrics))
    for name in ("dl4j_perf_mfu", "dl4j_perf_program_flops",
                 "dl4j_perf_program_bytes",
                 "dl4j_perf_arithmetic_intensity"):
        assert tg[name] == jg[name]


def test_peak_table_is_the_cards_and_unknown_gpus_raise(monkeypatch):
    assert not [k for k in tperf.PEAK_FLOPS if "TPU" in k]
    assert tperf.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
    assert tperf.PEAK_BYTES_PER_S["NVIDIA H100 80GB HBM3"] == 3.35e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cm = tperf.CostModel()
    assert (cm.peak_flops, cm.device_kind) == (989e12,
                                               "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-40GB")
    with pytest.raises(ValueError, match="A100"):
        tperf.CostModel()
    cm = tperf.CostModel(peak_flops=312e12, peak_bytes_per_s=1.555e12)
    assert cm.device_kind == "NVIDIA A100-SXM4-40GB"


def test_cost_model_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tperf.CostModel()


def _mini_forward_flops(rows):
    """The mini ResNet's (tests/test_helpers.py) conv and dense products
    at 16x16x3 input: stem 3x3/2 to 8x8x8, a 2x2 pool to 4x4, then the
    conv block (1x1 8, 3x3 8, 1x1 16, shortcut 1x1 16), the identity
    block (1x1 8, 3x3 8, 1x1 16) and the 16 -> 5 output layer."""
    c = tperf.conv2d_flops
    return (c(rows, 8, 8, 8, 3, 3, 3) + c(rows, 4, 4, 8, 1, 1, 8)
            + c(rows, 4, 4, 8, 3, 3, 8) + c(rows, 4, 4, 16, 1, 1, 8)
            + c(rows, 4, 4, 16, 1, 1, 8) + c(rows, 4, 4, 8, 1, 1, 16)
            + c(rows, 4, 4, 8, 3, 3, 8) + c(rows, 4, 4, 16, 1, 1, 8)
            + tperf.matmul_flops(rows, 16, 5))


@pytest.mark.parametrize("mode", ["pallas", "fused"])
def test_register_perf_counts_three_times_the_forward(mode):
    net = _port_net(mode)
    prog = StepProgram(net)
    cm = tperf.CostModel(device="cpu")
    x, y = _data(np.random.default_rng(2), 8)
    before = [t.clone() for t in
              (net._params_view()["b0a_conv"]["W"],)]
    entry = prog.register_perf(cm, None, x, y)
    # the forward and the two backward products of every layer, less the
    # stem's input gradient: nothing asks for the image's gradient
    want = 3 * _mini_forward_flops(8) - tperf.conv2d_flops(8, 8, 8, 8, 3, 3,
                                                           3)
    assert abs(entry["flops"] / want - 1) < 0.03, (entry["flops"], want)
    assert entry["bytes_accessed"] > 0
    assert "cpu twin" in entry["source"]
    rep = cm.perf_report(prog._step_key(), seconds_per_call=0.01)
    assert rep["bound"] in ("memory", "compute")
    # counting trains a twin, never the net itself
    assert net.iteration == 0
    assert torch.equal(before[0], net._params_view()["b0a_conv"]["W"])
    with pytest.raises(KeyError):
        prog.register_perf(cm, ("engine_group", 4))
    with pytest.raises(ValueError):
        prog.register_perf(cm)


def test_count_cost_counts_a_multiply_add_as_two_flops():
    a, b = torch.ones(4, 6), torch.ones(6, 5)
    c = tperf.count_cost(lambda: a @ b)
    assert c["flops"] == 2 * 4 * 6 * 5
    assert c["bytes_accessed"] == 4 * (4 * 6 + 6 * 5 + 4 * 5)


# ------------------------------------------------- phase profiler


def _fit_both(jpp, tpp, steps, **kw):
    jmetrics.get_registry().reset()
    tmetrics.get_registry().reset()
    jnet = _jnet()
    net = _tnet(jnet)
    jtm = _jtm(jnet, phase_profiler=jpp, **{
        k: (v + "/jax" if k == "checkpoint_dir" else v)
        for k, v in kw.items()})
    ttm = TrainingMaster(net, phase_profiler=tpp, **{
        k: (v + "/port" if k == "checkpoint_dir" else v)
        for k, v in kw.items()})
    jtm.fit(_batch, steps)
    ttm.fit(_batch, steps)
    hist = lambda m: {k: v["count"] for k, v in
                      m.get_registry().snapshot()["histograms"].items()
                      if k.startswith("dl4j_train_phase_seconds")}
    return jtm, ttm, hist(jmetrics), hist(tmetrics)


def test_phase_profiler_covers_the_fit_like_jax():
    """test_perf_introspection.py's acceptance on the port: >= 95% of the
    profiled wall time attributed (sampled sync every step), the phase
    names, steps and per-phase histogram counts equal to JAX's."""
    jpp, tpp = jperf.StepPhaseProfiler(sync_every=1), \
        tperf.StepPhaseProfiler(sync_every=1)
    _, tm, jh, th = _fit_both(jpp, tpp, 25)
    rep, jrep = tpp.report(), jpp.report()
    assert rep["steps"] == jrep["steps"] == 25
    assert rep["coverage"] >= 0.95, rep
    assert set(rep["phases"]) <= set(tperf.PHASES)
    assert set(rep["phases"]) == set(jrep["phases"])
    assert th == jh
    assert th['dl4j_train_phase_seconds{phase="dispatch"}'] == 25
    assert sum(p["share"] for p in rep["phases"].values()) \
        == pytest.approx(1.0)
    assert tm.training_stats()["phases"]["steps"] == 25


def test_phase_profiler_sync_sampling_and_checkpoints_like_jax(tmp_path):
    jpp, tpp = jperf.StepPhaseProfiler(sync_every=4), \
        tperf.StepPhaseProfiler(sync_every=4)
    _, _, jh, th = _fit_both(jpp, tpp, 8, checkpoint_dir=str(tmp_path),
                             checkpoint_every=2)
    assert th == jh
    assert th['dl4j_train_phase_seconds{phase="device_compute"}'] == 2
    assert th['dl4j_train_phase_seconds{phase="checkpoint"}'] == 4
    assert set(tpp.report()["phases"]) == set(jpp.report()["phases"])


def test_phase_profiler_counts_a_window_as_one_step_like_jax(tmp_path):
    """Under steps_per_dispatch=4 one profiler step is one window, as in
    the JAX package. The port's window also waits on the stream of the
    previous window's replay (sync_every) before launching its own, so
    device_compute is the one phase JAX's window lacks (the fit's first
    window has no replay to wait for)."""
    jpp, tpp = jperf.StepPhaseProfiler(sync_every=1), \
        tperf.StepPhaseProfiler(sync_every=1)
    _, _, jh, th = _fit_both(jpp, tpp, 10, steps_per_dispatch=4,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=4)
    assert tpp.steps == jpp.steps == 3
    assert set(tpp.report()["phases"]) \
        == set(jpp.report()["phases"]) | {"device_compute"}
    assert th.pop('dl4j_train_phase_seconds{phase="device_compute"}') == 2
    assert th == jh
    assert tpp.report()["coverage"] >= 0.95


def test_harness_and_wrapper_build_the_default_profiler():
    h = StepHarness(_tnet(), phase_profiler=True)
    assert isinstance(h.phase_profiler, tperf.StepPhaseProfiler)
    assert h.phase_profiler.accumulator is h.acc
    batches = [_batch(s) for s in range(3)]
    jnet = _jnet()
    jpw = JWrapper(jnet, workers=1, phase_profiler=True)
    pw = ParallelWrapper(_tnet(jnet), phase_profiler=True)
    jpw.fit(batches)
    pw.fit(batches)
    rep, jrep = pw.phase_profiler.report(), jpw.phase_profiler.report()
    assert rep["steps"] == jrep["steps"] == 3
    assert rep["coverage"] >= 0.95
    assert set(rep["phases"]) == set(jrep["phases"])
    assert "dispatch" in rep["phases"]


def test_profiler_sync_on_the_cpu_marks_device_compute_only_when_sampled():
    pp = tperf.StepPhaseProfiler(sync_every=2)
    for s in range(4):
        pp.begin_step(s)
        pp.mark("dispatch")
        pp.sync(torch.ones(1), step=s)
        pp.mark("host_sync")
        pp.end_step()
    assert pp.steps == 4
    assert pp.top_phases(3)
    counts = tmetrics.get_registry().snapshot()["histograms"]
    assert 'dl4j_train_phase_seconds{phase="device_compute"}' in counts
