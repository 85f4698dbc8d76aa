"""The port's stats package against the JAX package's, on the CPU:
StatsListener's summaries on the same weights and batches, the storages
(a FileStatsStorage written by one package is read by the other), the
dashboard's page, embedded data and status lines, the network-flow and
conv-activation tabs, and UIServer on localhost.

Tolerances: min and max within 1e-6 (absolute), mean magnitudes at rtol
1e-5 for the params and 1e-4 for the window's update (a difference of
two f32 params: both packages round each param once, so the delta
carries their 1e-6 disagreement); histogram counts equal except where a
value lies on a bin edge: the packages compute the f32 edges by
different expressions (jnp.linspace there), so such a value may land
one bin apart — at most 2 values moved per group."""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.stats import dashboard as jdash
from deeplearning4j_tpu.stats.listener import StatsListener as JStats
from deeplearning4j_tpu.stats.storage import (
    FileStatsStorage as JFileStorage,
)
from deeplearning4j_tpu.stats.storage import (
    InMemoryStatsStorage as JMemStorage,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import metrics as tmetrics
from deeplearning4j_tpu_torch.parallel import TrainingMaster
from deeplearning4j_tpu_torch.stats import (
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteStatsStorageRouter,
    StatsListener,
    UIServer,
    collect_conv_activations,
    collect_network_flow,
    embedding_scatter,
    render_html,
    telemetry_lines,
)
from deeplearning4j_tpu_torch.stats.listener import summarize
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from test_helpers import _mini_resnet
from test_torch_train import _port_of
from test_torch_training_master import _batch, _jnet, _tnet

MINMAX_ATOL = 1e-6
MEAN_RTOL = {"params": 1e-5, "updates": 1e-4}
EDGE_MOVES = 2


def _assert_reports_close(trep, jrep):
    assert (trep.iteration, trep.epoch) == (jrep.iteration, jrep.epoch)
    np.testing.assert_allclose(trep.score, jrep.score, rtol=1e-5)
    for kind, tm, jm, th, jh in (
            ("params", trep.param_mean_magnitudes,
             jrep.param_mean_magnitudes, trep.param_histograms,
             jrep.param_histograms),
            ("updates", trep.update_mean_magnitudes,
             jrep.update_mean_magnitudes, trep.update_histograms,
             jrep.update_histograms)):
        assert list(tm) == list(jm) and list(th) == list(jh)
        for name in tm:
            np.testing.assert_allclose(tm[name], jm[name],
                                       rtol=MEAN_RTOL[kind], err_msg=name)
            a, b = th[name], jh[name]
            np.testing.assert_allclose([a.min, a.max], [b.min, b.max],
                                       atol=MINMAX_ATOL, err_msg=name)
            assert sum(a.counts) == sum(b.counts)
            moved = np.abs(np.cumsum(a.counts) - np.cumsum(b.counts))
            assert moved.max() <= EDGE_MOVES, (name, a.counts, b.counts)


@pytest.mark.parametrize("fit", ["net", "training_master"])
def test_stats_listener_matches_jax(fit):
    jnet = _jnet()
    net = _tnet(jnet)
    jst, tst = JMemStorage(), InMemoryStatsStorage()
    jnet.listeners.append(JStats(jst, frequency=2, session_id="s"))
    net.listeners.append(StatsListener(tst, frequency=2, session_id="s"))
    batches = [_batch(s) for s in range(7)]
    jnet.fit(batches)
    if fit == "net":
        net.fit(batches)
    else:
        TrainingMaster(net).fit(_batch, 7)
    trs, jrs = tst.reports("s"), jst.reports("s")
    assert [r.iteration for r in trs] == [r.iteration for r in jrs] \
        == [2, 4, 6]
    for trep, jrep in zip(trs, jrs):
        _assert_reports_close(trep, jrep)
        for name, h in trep.update_histograms.items():
            assert trep.update_mean_magnitudes[name] > 0, name
        assert trep.mem["host_rss_mb"] > 0
    assert trs[-1].samples_per_sec is not None


def test_stats_listener_reads_nothing_off_collection_and_keeps_the_carry():
    """On the mini ResNet's flat carry: the listener reads the params
    through views (the carry stays live), its baseline is a clone (the
    update is non-zero), and every histogram counts its group's size."""
    net = _port_of(_mini_resnet("pallas"))
    st = InMemoryStatsStorage()
    net.listeners.append(StatsListener(st, frequency=3, session_id="m"))
    rng = np.random.default_rng(4)
    from test_helpers import _data

    batches = [_data(rng, 4) for _ in range(6)]
    net.fit(batches)
    assert net._flat_train is not None
    (rep,) = [r for r in st.reports("m") if r.iteration == 6]
    sizes = {}
    for (layer, p), t in (((k, n), v) for k, d in
                          net._params_view().items() for n, v in d.items()):
        sizes[f"{layer}/{p}"] = t.numel()
    for name, h in rep.param_histograms.items():
        assert sum(h.counts) == sizes[name]
    assert all(m > 0 for m in rep.update_mean_magnitudes.values())


@pytest.mark.parametrize("chunk", [1 << 16, 3])
def test_summarize_follows_numpys_histogram_rule(monkeypatch, chunk):
    """Per group min, max, mean |x| and numpy's histogram; at chunk 3 the
    groups span several chunks of the per-group reductions."""
    from deeplearning4j_tpu_torch.stats import listener

    monkeypatch.setattr(listener, "_CHUNK", chunk)
    rng = np.random.default_rng(9)
    named = [(f"g{i}", torch.from_numpy(rng.normal(size=n).astype(
        np.float32))) for i, n in enumerate((1, 2, 3, 7, 100))]
    for (name, t), row in zip(named, summarize(named, 8).numpy()):
        a = t.numpy()
        assert (row[0], row[1]) == (a.min(), a.max()), name
        np.testing.assert_allclose(row[2], np.abs(a.astype(np.float64))
                                   .mean(), rtol=1e-12)
        np.testing.assert_array_equal(row[3:],
                                      np.histogram(a, bins=8)[0])
    x = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0, 1.0, 0.1])
    row = summarize([("g", x)], 4)[0].numpy()
    want, _ = np.histogram(x.numpy(), bins=4)
    assert row[0] == 0.0 and row[1] == 1.0
    np.testing.assert_array_equal(row[3:], want)
    np.testing.assert_allclose(row[2], np.abs(x.numpy()).mean())
    same = summarize([("c", torch.full((5,), 2.0))], 3)[0].numpy()
    np.testing.assert_array_equal(same[3:], np.histogram(
        np.full(5, 2.0), bins=3)[0])


def test_file_stats_storage_is_read_by_either_package(tmp_path):
    jnet = _jnet()
    net = _tnet(jnet)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    js, ts = JFileStorage(jpath), FileStatsStorage(tpath)
    jnet.listeners.append(JStats(js, frequency=1, session_id="j"))
    net.listeners.append(StatsListener(ts, frequency=1, session_id="t"))
    batches = [_batch(s) for s in range(3)]
    jnet.fit(batches)
    net.fit(batches)
    js.close()
    ts.close()
    from_port = JFileStorage(tpath)
    from_jax = FileStatsStorage(jpath)
    assert [r.to_dict() for r in from_port.reports("t")] \
        == [r.to_dict() for r in ts.reports("t")]
    assert [r.to_dict() for r in from_jax.reports("j")] \
        == [r.to_dict() for r in js.reports("j")]
    from_port.close()
    from_jax.close()


def _jax_storage_and_snapshot(tmp_path):
    jnet = _jnet()
    st = JFileStorage(str(tmp_path / "s.jsonl"))
    jnet.listeners.append(JStats(st, frequency=1, session_id="dash"))
    jnet.fit([_batch(s) for s in range(3)])
    st.close()
    reg = jmetrics.MetricsRegistry()
    for name, n in (("dl4j_train_guard_checks_total", 4),
                    ("dl4j_train_watchdog_hangs_total", 1),
                    ("dl4j_train_supervisor_restarts_total", 1),
                    ("dl4j_serving_requests_total", 50),
                    ("dl4j_serving_batches_total", 12)):
        reg.inc(name, n)
    reg.set_gauge("dl4j_perf_mfu", 0.41, labels={"program": "k4"})
    reg.set_gauge("dl4j_serving_queue_depth", 3)
    for p, v in (("dispatch", 0.01), ("device_compute", 0.29)):
        reg.observe("dl4j_train_phase_seconds", v, labels={"phase": p})
    reg.observe("dl4j_serving_batch_occupancy", 8.0,
                buckets=jmetrics.COUNT_BUCKETS)
    return str(tmp_path / "s.jsonl"), reg.snapshot()


def test_render_html_and_telemetry_lines_equal_jax(tmp_path):
    path, snap = _jax_storage_and_snapshot(tmp_path)
    jst, tst = JFileStorage(path), FileStatsStorage(path)
    lines = telemetry_lines(snap)
    assert lines == jdash.telemetry_lines(snap)
    assert any(line.startswith("self-healing") for line in lines)
    assert any(line.startswith("perf — MFU 0.410") for line in lines)
    assert telemetry_lines(None) == []
    page = render_html(tst, telemetry=snap,
                       path=str(tmp_path / "port.html"))
    assert page == jdash.render_html(jst, telemetry=snap)
    with open(tmp_path / "port.html") as f:
        assert f.read() == page
    data = json.loads(page.split("const DATA = ", 1)[1].split(";\n", 1)[0])
    # three iterations: the first sets the baseline, two reports
    assert len(data["reports"]) == 2
    assert data["telemetry_lines"] == lines and data["telemetry"] == snap
    jst.close()
    tst.close()
    with pytest.raises(ValueError):
        render_html(InMemoryStatsStorage())


def test_network_flow_equals_jax_for_a_graph_and_a_layer_list():
    jgraph = _mini_resnet("pallas")
    graph = _port_of(jgraph)
    assert collect_network_flow(graph) == jdash.collect_network_flow(jgraph)
    jnet = _jnet()
    assert collect_network_flow(_tnet(jnet)) \
        == jdash.collect_network_flow(jnet)


def test_conv_activations_equal_jax():
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import InputType
    from deeplearning4j_tpu.nn.layers import ConvolutionLayer, OutputLayer

    conf = (NeuralNetConfiguration.Builder().seed(3).list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                    activation="relu"))
            .layer(OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(InputType.convolutional(20, 20, 2)).build())
    jnet = JMLN(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    net.params, net.states = params_from_jax(
        tonp(jnet.params), tonp(jnet.states), device="cpu")
    x = np.random.default_rng(6).normal(size=(2, 20, 20, 2)).astype(
        np.float32)
    got = collect_conv_activations(net, x, max_hw=7)
    want = jdash.collect_conv_activations(jnet, x, max_hw=7)
    assert [(g["name"], g["shape"]) for g in got] \
        == [(w["name"], w["shape"]) for w in want]
    for g, w in zip(got, want):
        for gc, wc in zip(g["channels"], w["channels"]):
            np.testing.assert_allclose(gc["grid"], wc["grid"], atol=2e-4)


def test_embedding_scatter_waits_for_tsne(tmp_path):
    """(Named for the raise this test pinned before t-SNE was ported.)
    embedding_scatter against the JAX package's on the same vectors: the
    same subsample (the seeded NumPy choice), the same palette indices,
    the same structure; both embeddings separate the three blobs and
    their KLs agree within 25% (the two start from different seeded
    draws: JAX's PRNGKey, the port's torch.Generator); the port's points
    are its own Tsne's on the selected rows, rounded to 3 places."""
    from deeplearning4j_tpu_torch.clustering import Tsne

    rng = np.random.default_rng(12)
    x = np.concatenate([rng.normal(size=(60, 8)) + c
                        for c in (0.0, 9.0, -9.0)]).astype(np.float32)
    labels = [f"c{i // 60}" for i in range(180)]
    kw = dict(labels=labels, perplexity=20.0, max_points=150,
              max_iter=250, seed=4)
    # small tensors: one intra-op thread runs them fastest, and test
    # processes sharing the cores do not wait on each other's pools
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = embedding_scatter(x, device="cpu", **kw)
        t = Tsne(perplexity=20.0, max_iter=250, seed=4, device="cpu")
        sel = np.random.default_rng(4).choice(180, 150, replace=False)
        mine = np.round(t.fit_transform(x[sel]), 3).tolist()
    finally:
        torch.set_num_threads(threads)
    want = jdash.embedding_scatter(x, **kw)
    assert sorted(got) == sorted(want) == ["kl", "labels", "points"]
    assert got["labels"] == want["labels"]
    assert np.shape(got["points"]) == np.shape(want["points"]) == (150, 2)
    np.testing.assert_array_equal(got["points"], mine)
    assert got["kl"] == round(t.kl_, 4)
    assert abs(got["kl"] - want["kl"]) < 0.25 * want["kl"]
    blob = np.asarray(got["labels"])
    for pts in (np.asarray(got["points"]), np.asarray(want["points"])):
        cents = np.stack([pts[blob == i].mean(0) for i in range(3)])
        spread = max(np.linalg.norm(pts[blob == i] - cents[i], axis=1).mean()
                     for i in range(3))
        gaps = min(np.linalg.norm(cents[i] - cents[j])
                   for i in range(3) for j in range(i + 1, 3))
        assert 2.0 * spread < gaps
    # too few points: the empty structure, in both packages
    assert embedding_scatter(x[:5], device="cpu") \
        == jdash.embedding_scatter(x[:5])
    # the page embeds it as JAX's page does
    path, _ = _jax_storage_and_snapshot(tmp_path)
    page = render_html(FileStatsStorage(path), embedding=got)
    assert page == jdash.render_html(JFileStorage(path), embedding=got)
    data = json.loads(page.split("const DATA = ", 1)[1].split(";\n", 1)[0])
    assert data["embedding"] == got


def test_ui_server_answers_a_get_and_receives_remote_reports(tmp_path):
    path, _ = _jax_storage_and_snapshot(tmp_path)
    st = FileStatsStorage(path)
    srv = UIServer(port=0).attach(st).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert r.status == 200
            body = r.read().decode()
        assert "<code>dash</code>" in body
        with urllib.request.urlopen(base + "/session/dash",
                                    timeout=10) as r:
            assert r.status == 200
        rep = st.reports("dash")[-1]
        rep.session_id = "remote"
        RemoteStatsStorageRouter(base, timeout=10).put_report(rep)
        assert [r.iteration for r in st.reports("remote")] \
            == [rep.iteration]
        assert tmetrics.get_registry() is not None
    finally:
        srv.stop()
        st.close()
