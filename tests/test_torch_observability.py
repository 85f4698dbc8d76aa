"""The port's observability layer against the JAX package's, on the CPU:
Prometheus text (byte-identical for the same emissions), its parsers and
the cross-process aggregation; the Tracer's Chrome export (equal once
ts/dur/pid/tid are normalised) and a merge of a JAX leg with a port leg;
the containers' listener hooks (F6: the port's ComputationGraph called
no listener before); TelemetryListener, ScoreIterationListener and
ProfilerListener; ParallelInference's spans and serving metrics.

Tolerances: text, counts and span structure exactly; losses of the dense
MLN at tests/test_torch_training_master.py's rtol 1e-5."""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import perf as jperf
from deeplearning4j_tpu.observability import tracing as jtracing
from deeplearning4j_tpu.observability.telemetry import (
    TelemetryListener as JTelemetryListener,
)
from deeplearning4j_tpu.optimize.listeners import (
    ScoreIterationListener as JScoreListener,
)
from deeplearning4j_tpu.parallel.inference import (
    ParallelInference as JParallelInference,
)
from deeplearning4j_tpu_torch.observability import metrics as tmetrics
from deeplearning4j_tpu_torch.observability import perf as tperf
from deeplearning4j_tpu_torch.observability import tracing as ttracing
from deeplearning4j_tpu_torch.observability.telemetry import (
    TelemetryListener,
)
from deeplearning4j_tpu_torch.optimize.listeners import (
    ProfilerListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.parallel import TrainingMaster
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from test_helpers import _data, _mini_resnet
from test_torch_train import _port_of
from test_torch_training_master import _batch, _jnet, _tnet

# the dense MLN's losses against JAX (test_torch_training_master.py)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- metrics


def _emit(mod):
    """One emission script into a fresh registry of `mod` (either
    package's metrics module): counters with and without labels, gauges,
    a pull gauge, histograms on both bucket sets, labeled histograms, the
    fused counter+histogram and a StepAccumulator-shaped batch."""
    reg = mod.MetricsRegistry(ring_size=16)
    rng = np.random.default_rng(5)
    for i in range(7):
        reg.inc("dl4j_train_steps_total")
        reg.inc("dl4j_retry_attempts_total", 2.0,
                labels={"op": "checkpoint", "outcome": "ok" if i % 2
                        else "retry"})
        reg.observe("dl4j_train_step_seconds", float(rng.uniform(0, 0.3)))
        reg.observe("dl4j_serving_batch_occupancy", float(rng.integers(1, 40)),
                    buckets=mod.COUNT_BUCKETS)
        reg.observe("dl4j_train_phase_seconds", float(rng.uniform(0, 0.01)),
                    labels={"phase": ("dispatch", "h2d")[i % 2]})
        reg.inc_observe("dl4j_serving_batches_total",
                        "dl4j_checkpoint_write_seconds",
                        float(rng.uniform(0.5, 2.0)))
    reg.set_gauge("dl4j_train_loss", 0.125)
    reg.set_gauge("dl4j_perf_mfu", 0.3710000001, labels={"program": "k4"})
    reg.gauge_fn("dl4j_pipeline_depth", lambda: 3)
    reg.apply_batch({"dl4j_train_steps_total": 4.0},
                    {"dl4j_pipeline_wait_seconds": [0.002, 0.03],
                     ("dl4j_train_phase_seconds",
                      (("phase", "checkpoint"),)): [1.25]})
    reg.note_dropped()
    return reg


def test_prometheus_text_is_byte_identical_to_jax():
    jtext = _emit(jmetrics).prometheus_text()
    ttext = _emit(tmetrics).prometheus_text()
    assert ttext == jtext
    assert "# TYPE dl4j_train_phase_seconds histogram" in ttext
    assert 'dl4j_train_phase_seconds_bucket{phase="h2d",le="+Inf"}' in ttext


def test_prometheus_text_round_trips_through_both_parsers():
    text = _emit(tmetrics).prometheus_text()
    assert tmetrics.parse_prometheus(text) == jmetrics.parse_prometheus(text)
    snap = tmetrics.parse_prometheus_snapshot(text)
    assert snap == jmetrics.parse_prometheus_snapshot(text)
    assert tmetrics.render_prometheus(snap) == text
    flat = tmetrics.parse_prometheus(text)
    assert flat["dl4j_train_steps_total"] == 11.0
    assert flat['dl4j_train_phase_seconds_count{phase="dispatch"}'] == 4.0


def test_aggregate_snapshots_of_jax_dumps_equals_jax(tmp_path):
    paths = []
    for rank in range(3):
        reg = _emit(jmetrics)
        reg.inc("dl4j_train_preemptions_total", float(rank))
        p = str(tmp_path / f"rank{rank}.json")
        jperf.dump_snapshot(p, registry=reg, rank=rank)
        paths.append(p)
    # a port-written dump rides along
    p = str(tmp_path / "port.json")
    tperf.dump_snapshot(p, registry=_emit(tmetrics), rank=3)
    paths.append(p)
    got, want = tperf.aggregate_snapshots(paths), \
        jperf.aggregate_snapshots(paths)
    got.pop("uptime_s")
    want.pop("uptime_s")
    assert got == want
    assert got["ranks"] == 4
    assert tperf.aggregate_prometheus_text(paths) \
        == jperf.aggregate_prometheus_text(paths)


def test_emission_helpers_register_pull_gauges_and_keyed_observations():
    reg = tmetrics.get_registry()
    tmetrics.gauge_fn("dl4j_pipeline_depth", lambda: 7)
    assert reg.gauge_value("dl4j_pipeline_depth") == 7.0
    acc = tmetrics.StepAccumulator(flush_every=100)
    before = reg.snapshot()["histograms"].get(
        'dl4j_train_phase_seconds{phase="telemetry"}', {"count": 0})
    acc.observe_keyed(("dl4j_train_phase_seconds",
                       (("phase", "telemetry"),)), 0.5)
    acc.flush()
    after = reg.snapshot()["histograms"][
        'dl4j_train_phase_seconds{phase="telemetry"}']
    assert after["count"] == before["count"] + 1


# ------------------------------------------------------------ tracer


def _span_script(mod):
    """One span script on a Tracer of `mod`: implicit nesting, an
    explicit cross-thread parent, `record`, `instant`, an error arg and a
    trace id — run with joins so the order is fixed."""
    tr = mod.Tracer(max_spans=64)
    with tr.span("request", cat="serving", args={"rows": 3}) as req:
        with tr.span("assemble", cat="serving"):
            pass
        def other():
            sp = tr.begin("complete", cat="serving", parent=req,
                          args={"trace": "abc"})
            tr.instant("watchdog_hang", cat="resilience", parent=sp,
                       args={"phase": "fetch"})
            sp.end(error=None)

        t = threading.Thread(target=other, name="completer")
        t.start()
        t.join()
    t0 = 100.0
    tr.record("checkpoint_save", t0, t0 + 0.25, cat="checkpoint",
              parent=req, args={"step": 4, "trace": "abc"})
    return tr


def _normalised(doc):
    tids = {}
    out = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        for k in ("ts", "dur", "pid"):
            ev.pop(k, None)
        if "tid" in ev:
            ev["tid"] = tids.setdefault(ev["tid"], len(tids))
        out.append(ev)
    other = dict(doc["otherData"])
    other.pop("unix_time_origin_s")
    other.pop("exporter")
    return out, other, doc["displayTimeUnit"]


def test_chrome_trace_export_matches_jax():
    jdoc = _span_script(jtracing).export_chrome_trace()
    tdoc = _span_script(ttracing).export_chrome_trace()
    assert _normalised(tdoc) == _normalised(jdoc)
    assert tdoc["otherData"]["exporter"] == "deeplearning4j_tpu_torch"
    flows = [e for e in tdoc["traceEvents"] if e.get("cat") == "flow"]
    assert {e["ph"] for e in flows} == {"s", "f"}
    hang = [e for e in tdoc["traceEvents"] if e["name"] == "watchdog_hang"]
    assert hang and "parent_id" in hang[0]["args"]


def test_merge_chrome_traces_takes_a_jax_leg_and_a_port_leg(tmp_path):
    jdoc = _span_script(jtracing).export_chrome_trace()
    tpath = str(tmp_path / "port.json")
    _span_script(ttracing).export_chrome_trace(tpath)
    got = ttracing.merge_chrome_traces([jdoc, tpath], labels=["jax", "port"])
    want = jtracing.merge_chrome_traces([jdoc, tpath],
                                        labels=["jax", "port"])
    assert got["traceEvents"] == want["traceEvents"]
    legs = [e for e in got["traceEvents"] if e.get("name") == "trace-leg"]
    assert len(legs) == 2 and {e["pid"] for e in legs} == {1, 2}


def test_background_flush_drains_to_jsonl_that_jax_reads(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    tr = ttracing.Tracer(max_spans=8, flush_path=path, flush_interval_s=0.05)
    for i in range(20):
        with tr.span("s", args={"i": i}):
            pass
    tr.stop_background_flush()
    st = tr.stats()
    assert st["recorded"] == 20 and st["dropped"] == 0
    assert [s["args"]["i"] for s in jtracing.Tracer.load_flushed(path)] \
        == list(range(20))
    assert ttracing.Tracer.load_flushed(path) \
        == jtracing.Tracer.load_flushed(path)
    assert len(ttracing.new_trace_id()) == 16


# ------------------------------------------- F6: listeners on a graph


class _Recorder:
    def __init__(self):
        self.events = []

    def iteration_done(self, model, iteration):
        self.events.append(("iteration_done", int(iteration),
                            int(model.epoch)))

    def on_epoch_start(self, model):
        self.events.append(("on_epoch_start", int(model.iteration),
                            int(model.epoch)))

    def on_epoch_end(self, model):
        self.events.append(("on_epoch_end", int(model.iteration),
                            int(model.epoch)))


def test_graph_calls_its_listeners_in_the_jax_sequence():
    """F6: the port's ComputationGraph had no `listeners`; its fit and
    fit_batch now call on_epoch_start / iteration_done / on_epoch_end in
    the JAX graph's order and record the fetch time."""
    rng = np.random.default_rng(3)
    batches = [_data(rng, 4) for _ in range(3)]
    jnet = _mini_resnet("pallas")
    net = _port_of(jnet)
    jrec, rec = _Recorder(), _Recorder()
    jnet.listeners.append(jrec)
    assert net.set_listeners(rec) is net
    jnet.fit(batches, epochs=2)
    net.fit(batches, epochs=2)
    jnet.fit_batch(batches[0])
    net.fit_batch(batches[0])
    assert rec.events == jrec.events
    assert rec.events[0] == ("on_epoch_start", 0, 0)
    assert rec.events[-2:] == [("on_epoch_end", 6, 2),
                               ("iteration_done", 7, 2)]
    assert net._last_etl_ms is not None and net._last_etl_ms >= 0.0
    more = _Recorder()
    net.add_listeners(more)
    net.fit_batch(batches[1])
    assert net.listeners == [rec, more]
    assert more.events == [("iteration_done", 8, 2)]


def test_training_master_calls_graph_listeners():
    data = [_data(np.random.default_rng(10 + s), 4) for s in range(6)]
    for k in (1, 3):
        net = _port_of(_mini_resnet("pallas"))
        rec = _Recorder()
        net.listeners.append(rec)
        TrainingMaster(net, steps_per_dispatch=k).fit(lambda s: data[s], 6)
        assert [e[1] for e in rec.events] == list(range(k, 7, k))


# ---------------------------------------- TelemetryListener and scores


def test_telemetry_and_score_listeners_match_jax():
    jnet, logs = _jnet(), {"jax": [], "port": []}
    net = _tnet(jnet)
    batches = [_batch(s) for s in range(6)]
    jmetrics.get_registry().reset()
    tmetrics.get_registry().reset()
    jnet.listeners += [JTelemetryListener(frequency=2),
                       JScoreListener(2, log=logs["jax"].append)]
    net.listeners += [TelemetryListener(frequency=2),
                      ScoreIterationListener(2, log=logs["port"].append)]
    jnet.fit(batches)
    net.fit(batches)
    jreg, treg = jmetrics.get_registry(), tmetrics.get_registry()
    for name in ("dl4j_train_steps_total",):
        assert treg.counter_value(name) == jreg.counter_value(name) == 6
    jh = jreg.snapshot()["histograms"]["dl4j_train_step_seconds"]
    th = treg.snapshot()["histograms"]["dl4j_train_step_seconds"]
    assert th["count"] == jh["count"] == 5
    np.testing.assert_allclose(treg.gauge_value("dl4j_train_loss"),
                               jreg.gauge_value("dl4j_train_loss"),
                               **LOSS_TOL)
    assert len(logs["port"]) == len(logs["jax"]) == 3
    for a, b in zip(logs["port"], logs["jax"]):
        ha, _, sa = a.rpartition(" ")
        hb, _, sb = b.rpartition(" ")
        assert ha == hb
        np.testing.assert_allclose(float(sa), float(sb), **LOSS_TOL)


def test_profiler_listener_writes_a_trace_and_survives_a_double_stop(
        tmp_path):
    tr = ttracing.Tracer()
    net = _tnet()
    prof = ProfilerListener(str(tmp_path / "prof"), start_iteration=1,
                            num_iterations=2, tracer=tr,
                            log=lambda m: None)
    net.listeners.append(prof)
    tm = TrainingMaster(net)
    tm.fit(_batch, 5)
    assert prof._done and not prof._active
    assert prof.trace_dir == str(tmp_path / "prof")
    with open(os.path.join(prof.trace_dir, "trace.json")) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    prof.stop()
    prof.stop()
    prof.on_epoch_end(net)
    spans = [s for s in tr.spans() if s["name"] == "torch_device_trace"]
    assert len(spans) == 1
    assert spans[0]["args"]["trace_dir"] == prof.trace_dir
    assert tm.training_stats()["profiler"] == {
        "trace_dir": prof.trace_dir, "log_dir": prof.log_dir,
        "active": False, "done": True}


def test_profiler_listener_epoch_end_closes_an_open_trace(tmp_path):
    net = _tnet()
    prof = ProfilerListener(str(tmp_path / "p"), start_iteration=1,
                            num_iterations=100, log=lambda m: None)
    net.listeners.append(prof)
    net.fit([_batch(s) for s in range(3)])
    assert prof._done and prof.trace_dir is not None


# ---------------------------------------------------------- serving


def _serve(pi_cls, net, tr, script):
    pi = pi_cls(net, batch_limit=4, max_wait_ms=0.0, warmup=False,
                tracer=tr)
    try:
        outs = [pi.output(x) for x in script]
    finally:
        pi.shutdown()
    return outs


def _chains(spans):
    by_id = {s["id"]: s for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: s["id"]):
        if s["name"] != "request":
            continue
        kids = [c for c in spans if c["parent_id"] == s["id"]]
        out.append((s["args"]["rows"], sorted(
            (c["name"], sorted(g["name"] for g in spans
                               if g["parent_id"] == c["id"]))
            for c in kids)))
    assert all(s["parent_id"] is None or s["parent_id"] in by_id
               for s in spans)
    return out


def test_serving_spans_and_metrics_match_jax():
    """Sequential requests (one in flight at a time, so the batching is
    fixed): the same span names and parent edges per request, and the
    same dl4j_serving_* values, in both packages. A 10-row request at
    batch_limit 4 splits once and rides three batches."""
    rng = np.random.default_rng(8)
    script = [_data(rng, n)[0] for n in (1, 3, 10, 2)]
    jnet = _mini_resnet("none")
    net = _port_of(jnet)
    jmetrics.get_registry().reset()
    tmetrics.get_registry().reset()
    jtr, ttr = jtracing.Tracer(), ttracing.Tracer()
    jouts = _serve(JParallelInference, jnet, jtr,
                   [jnp.asarray(x) for x in script])
    outs = _serve(ParallelInference, net, ttr, script)
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    assert _chains(ttr.spans()) == _chains(jtr.spans())
    assert _chains(ttr.spans())[2] == (
        10, [("assemble_dispatch", ["complete_deliver"])] * 3)
    jsnap = jmetrics.get_registry().snapshot()
    tsnap = tmetrics.get_registry().snapshot()
    for name in ("dl4j_serving_batches_total",
                 "dl4j_serving_bucket_splits_total"):
        assert tsnap["counters"][name] == jsnap["counters"][name]
    assert tsnap["counters"]["dl4j_serving_batches_total"][""] == 6
    assert tsnap["counters"]["dl4j_serving_bucket_splits_total"][""] == 1
    occ = "dl4j_serving_batch_occupancy"
    assert tsnap["histograms"][occ]["buckets"] \
        == jsnap["histograms"][occ]["buckets"]
    assert tsnap["histograms"][occ]["sum"] == sum(x.shape[0]
                                                  for x in script)
    for g in ("dl4j_serving_queue_depth", "dl4j_serving_inflight_batches"):
        assert tsnap["gauges"][g] == jsnap["gauges"][g]


def test_serving_without_a_tracer_records_nothing_and_still_serves():
    net = _port_of(_mini_resnet("none"))
    x = _data(np.random.default_rng(1), 5)[0]
    pi = ParallelInference(net, batch_limit=4, warmup=False)
    try:
        out = pi.output(x)
    finally:
        pi.shutdown()
    with torch.inference_mode():
        want = net.output(x).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("module", ["metrics", "perf", "tracing",
                                    "telemetry"])
def test_observability_exports_match_jax(module):
    import importlib

    j = importlib.import_module(f"deeplearning4j_tpu.observability.{module}")
    t = importlib.import_module(
        f"deeplearning4j_tpu_torch.observability.{module}")
    public = {n for n in dir(j) if not n.startswith("_")
              and getattr(getattr(j, n), "__module__", "") == j.__name__}
    # XLA's cost-analysis readers have the counted cost in their place
    jax_only = {"extract_cost"}
    missing = public - jax_only - set(dir(t))
    assert not missing, missing
