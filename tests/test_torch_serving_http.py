"""The port's HTTP front end (deeplearning4j_tpu_torch/parallel/serving.py)
on the CPU, server side: the counterparts of tests/test_serving.py's
server and wire cases, tests/test_resilience.py's server taxonomy cases
and tests/test_serving_perf.py's /status and zero-new-traces pins, plus
the port's own points: a wrong-shape request answers 400, the SEQUENTIAL
mode, and an error raised before the body is read still answers. The
client's side is tests/test_torch_serving_client.py.

Nets are small MLPs on the CPU (`device="cpu"`); outputs are compared to
a direct `net.output` at rtol 1e-4 / atol 1e-5 (the JAX tests' bound).
No assertion depends on load or timing: held requests are gated by
events and every wait has a deadline with 10x headroom.
"""

import concurrent.futures as cf
import json
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode,
    ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.serving import (
    NPZ_CONTENT_TYPE,
    ModelClient,
    ModelServer,
    decode_npz_request,
    decode_npz_response,
    encode_npz_request,
    encode_npz_response,
)
from deeplearning4j_tpu_torch.resilience import (
    InferenceUnavailableError,
    Retry,
    ServingError,
    injector,
)
from deeplearning4j_tpu_torch.resilience.faults import fire
from deeplearning4j_tpu_torch.zoo.util.imagenet import ImageNetLabels

pytestmark = pytest.mark.serving

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    injector().clear()
    yield
    injector().clear()


@pytest.fixture
def class_index(tmp_path):
    raw = {str(i): [f"n{i:08d}", name] for i, name in enumerate(
        ["tench", "goldfish", "white_shark", "tiger_shark",
         "hammerhead", "electric_ray"])}
    p = tmp_path / "class_index.json"
    p.write_text(json.dumps(raw))
    return str(p)


def _net(seed=7, n_in=8, n_out=6):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=n_out, loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _direct(net, *xs):
    out = net.output(*xs)
    return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


def _url(server):
    return f"http://127.0.0.1:{server.port}"


class _SlowNet:
    """Stand-in whose output blocks until released, then fires the
    test's `model.forward` point (fails the in-flight batch on cue)."""

    def __init__(self, release=None):
        self.release = release
        self.started = threading.Event()

    def output(self, x):
        self.started.set()
        if self.release is not None:
            self.release.wait(timeout=10.0)
        fire("model.forward")
        return np.asarray(x)


# ===================================================== round trips
def test_model_server_round_trip(class_index):
    net = _net()
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    labels = ImageNetLabels(class_index)
    server = ModelServer(net, labels=labels, device="cpu").start()
    try:
        client = ModelClient(_url(server))
        st = client.status()
        assert st["inference_mode"] == "batched" and st["has_labels"]
        direct = _direct(net, x)
        resp = client.predict(x)
        np.testing.assert_allclose(np.asarray(resp["outputs"]), direct,
                                   rtol=RTOL, atol=ATOL)
        resp = client.predict(x, decode_top=2)
        assert len(resp["decoded"]) == 4
        best = resp["decoded"][0][0]
        assert best["class"] == int(np.argmax(direct[0]))
        assert best["label"] == labels.get_label(best["class"])
        assert best["probability"] == pytest.approx(
            float(direct[0].max()), rel=1e-4)
    finally:
        server.stop()


def test_model_server_concurrent_clients():
    net = _net()
    rng = np.random.default_rng(1)
    inputs = [rng.normal(size=(2, 8)).astype(np.float32) for _ in range(6)]
    server = ModelServer(net, device="cpu").start()
    try:
        client = ModelClient(_url(server))
        with cf.ThreadPoolExecutor(6) as ex:
            outs = list(ex.map(lambda a: client.predict(a)["outputs"],
                               inputs))
        for x, o in zip(inputs, outs):
            np.testing.assert_allclose(np.asarray(o, np.float32),
                                       _direct(net, x), rtol=RTOL,
                                       atol=ATOL)
    finally:
        server.stop()


def test_model_server_error_paths():
    server = ModelServer(_net(), device="cpu").start()   # no labels
    try:
        client = ModelClient(_url(server))
        with pytest.raises(ServingError) as ei:
            client.predict(np.zeros((1, 8), np.float32), decode_top=3)
        assert ei.value.status == 400 and "labels" in ei.value.message
        with pytest.raises(ServingError) as ei:
            ModelClient(_url(server), retry=Retry(max_attempts=1))._request(
                "/nope", {})
        assert ei.value.status == 404
        assert ei.value.error_class == "NotFound"
    finally:
        server.stop()


# ====================================================== npz wire
def test_binary_wire_round_trip_and_encoding():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    req = decode_npz_request(encode_npz_request(x, {"tenant": "gold"}))
    np.testing.assert_array_equal(req["inputs"], x)
    assert req["tenant"] == "gold"
    multi = decode_npz_request(encode_npz_request({"a": x, "b": x + 1}, {}))
    assert set(multi["inputs"]) == {"a", "b"}
    resp = decode_npz_response(
        encode_npz_response([x, x * 2], {"model": "m", "version": "v"}))
    assert isinstance(resp["outputs"], list) and len(resp["outputs"]) == 2
    np.testing.assert_array_equal(resp["outputs"][1], x * 2)
    assert resp["model"] == "m"
    assert NPZ_CONTENT_TYPE == "application/x-npz"

    net = _net()
    xs = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    server = ModelServer(net, device="cpu").start()
    try:
        r_bin = ModelClient(_url(server), breaker=None).predict(xs)
        assert isinstance(r_bin["outputs"], np.ndarray)
        r_json = ModelClient(_url(server), breaker=None,
                             wire="json").predict(xs)
        assert isinstance(r_json["outputs"], list)
        direct = _direct(net, xs)
        np.testing.assert_allclose(r_bin["outputs"], direct, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(np.asarray(r_json["outputs"],
                                              np.float32), direct,
                                   rtol=RTOL, atol=ATOL)
        assert r_bin["model"] == r_json["model"] == "default"
    finally:
        server.stop()


def test_binary_wire_decode_top_rides_meta(class_index):
    net = _net()
    x = np.random.default_rng(1).normal(size=(2, 8)).astype(np.float32)
    server = ModelServer(net, labels=ImageNetLabels(class_index),
                         device="cpu").start()
    try:
        resp = ModelClient(_url(server), breaker=None).predict(
            x, decode_top=2)
        assert isinstance(resp["outputs"], np.ndarray)
        assert len(resp["decoded"]) == 2
        assert resp["decoded"][0][0]["class"] == int(
            np.argmax(_direct(net, x)[0]))
    finally:
        server.stop()


def test_binary_wire_multi_input_dict():
    conf = (NeuralNetConfiguration.Builder().seed(5).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .graph_builder()
            .add_inputs("a", "b")
            .set_input_types(a=InputType.feed_forward(3),
                             b=InputType.feed_forward(5))
            .add_layer("da", DenseLayer(n_out=4), "a")
            .add_layer("db", DenseLayer(n_out=4), "b")
            .add_layer("out", OutputLayer(n_out=3, loss="mcxent"),
                       "da", "db")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, 3)).astype(np.float32)
    b = rng.normal(size=(2, 5)).astype(np.float32)
    server = ModelServer(net, device="cpu").start()
    try:
        r = ModelClient(_url(server), breaker=None).predict({"a": a, "b": b})
        assert isinstance(r["outputs"], np.ndarray)
        np.testing.assert_allclose(r["outputs"], _direct(net, a, b),
                                   rtol=RTOL, atol=ATOL)
    finally:
        server.stop()


# ================================================ error taxonomy
@pytest.mark.parametrize("wire", ["npz", "json"])
def test_wrong_shape_request_answers_400(wire):
    """A request of the wrong per-example shape is the client's fault:
    ParallelInference rejects it before queueing (ValueError), so the
    server answers 400 as the JAX server does — never a 500 from a
    shape error inside the batch."""
    server = ModelServer(_net(), device="cpu").start()
    try:
        client = ModelClient(_url(server), wire=wire,
                             retry=Retry(max_attempts=1), breaker=None)
        with pytest.raises(ServingError) as ei:
            client.predict(np.zeros((2, 5), np.float32))
        assert ei.value.status == 400
        assert ei.value.error_class == "ValueError"
        assert "(5,)" in ei.value.message and "(8,)" in ei.value.message
        # the server is unharmed: a right-shape request still answers
        assert np.asarray(client.predict(
            np.zeros((2, 8), np.float32))["outputs"]).shape == (2, 6)
    finally:
        server.stop()


def test_http_error_taxonomy():
    """404 unknown route, 400 malformed payload, 500 model crash — with
    error_class in every body."""
    class _BoomNet:
        def output(self, x):
            raise RuntimeError("model exploded")

    server = ModelServer(_net(), device="cpu").start()
    client = ModelClient(_url(server), retry=Retry(max_attempts=1))
    try:
        with pytest.raises(ServingError) as ei:
            client._request("/nope", {})
        assert ei.value.status == 404
        with pytest.raises(ServingError) as ei:
            client._request("/predict", {"not_inputs": 1})
        assert ei.value.status == 400 and "inputs" in ei.value.message
        with pytest.raises(ServingError) as ei:
            client.predict(np.zeros((1, 8), np.float32), decode_top=3)
        assert ei.value.status == 400
    finally:
        server.stop()

    boom = ModelServer(_BoomNet(), inference_mode="sequential",
                       device="cpu").start()
    client = ModelClient(_url(boom), retry=Retry(max_attempts=1))
    try:
        with pytest.raises(ServingError) as ei:
            client.predict(np.zeros((1, 4), np.float32))
        assert ei.value.status == 500
        assert ei.value.error_class == "RuntimeError"
        assert "model exploded" in ei.value.message
    finally:
        boom.stop()


@pytest.mark.chaos
def test_batcher_death_fails_all_inflight_and_flips_healthz():
    """A's batch is held inside the model until B..F are queued; then
    `model.forward` fails A's batch (500) and `inference.batch` kills
    the batcher, which drains B..F (503). /healthz and /readyz flip."""
    release = threading.Event()
    net = _SlowNet(release=release)
    pi = ParallelInference(net, batch_limit=1, queue_limit=16,
                           max_wait_ms=0.0, default_timeout_s=10.0)
    server = ModelServer(pi, device="cpu").start()
    try:
        client = ModelClient(_url(server), retry=Retry(max_attempts=1))
        assert client.healthz()
        x = np.ones((1, 2), np.float32)
        with cf.ThreadPoolExecutor(6) as ex:
            futures = [ex.submit(client.predict, x) for _ in range(6)]
            assert net.started.wait(timeout=10.0)
            deadline = time.monotonic() + 10.0
            while pi.queue_depth() < 5 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert pi.queue_depth() >= 5
            injector().inject("model.forward", mode="raise", at_hit=1,
                              times=1 << 30)
            injector().inject("inference.batch", mode="raise", at_hit=1,
                              times=1 << 30)
            release.set()
            outcomes = [f.exception(timeout=20.0) for f in futures]
        assert all(isinstance(o, ServingError) for o in outcomes)
        assert sorted(o.status for o in outcomes) == [500, 503, 503, 503,
                                                      503, 503]
        assert not pi.healthy
        assert client.healthz() is False and client.readyz() is False
        with pytest.raises(InferenceUnavailableError):
            pi.output(x)
    finally:
        injector().clear()
        release.set()
        server.stop()
        pi.shutdown()


def test_status_and_probes_report_degradation_facts():
    server = ModelServer(_net(), device="cpu").start()
    client = ModelClient(_url(server))
    try:
        st = client.status()
        assert st["healthy"] and st["ready"] and st["queue_depth"] == 0
        assert client.healthz() and client.readyz()
    finally:
        server.stop()
    with pytest.raises((ConnectionError, OSError)):
        client._probe("/healthz")   # listener gone: transport failure


# ========================================== modes, /status, traces
def test_sequential_mode_serves_direct_with_host_results():
    net = _net()
    pi = ParallelInference(net, inference_mode=InferenceMode.SEQUENTIAL)
    try:
        assert pi.mode == "sequential" and pi.healthy
        assert pi.stats()["warmed_buckets"] == []   # no batcher, no warmup
        x = np.random.default_rng(6).normal(size=(3, 8)).astype(np.float32)
        out = pi.output(x)
        assert isinstance(out, np.ndarray)
        np.testing.assert_allclose(out, _direct(net, x), rtol=RTOL,
                                   atol=ATOL)
        with pytest.raises(ValueError, match="per-example shape"):
            pi.output(np.zeros((1, 3), np.float32))
        with pytest.raises(ValueError, match="inference_mode"):
            ParallelInference(net, inference_mode="fast")
        with pytest.raises(NotImplementedError, match="10c"):
            pi.lint_records()
    finally:
        pi.shutdown()
    assert not pi.healthy


def test_warmup_inputs_and_queue_limit():
    """`warmup_inputs` gives a stub net its shapes (warmup and the
    request check read them); `queue_limit` is what admission reads."""
    class _Echo:
        def output(self, x):
            return np.asarray(x)

    pi = ParallelInference(_Echo(), batch_limit=4, queue_limit=7,
                           warmup_inputs=[(3,)])
    try:
        assert pi.queue_limit == 7
        assert pi.stats()["warmed_buckets"] == [1, 2, 4]
        np.testing.assert_allclose(pi.output(np.ones((2, 3), np.float32)),
                                   1.0)
        with pytest.raises(ValueError, match="per-example shape"):
            pi.output(np.ones((2, 4), np.float32))
        assert pi.trace_stats() == {}   # a stub net has no program cache
    finally:
        pi.shutdown()


def test_zero_new_traces_after_warmup_under_mixed_load():
    net = _net()
    pi = ParallelInference(net, batch_limit=8, queue_limit=64)
    try:
        assert pi.stats()["warmed_buckets"] == [1, 2, 4, 8]
        assert pi.trace_stats()["trace_counts"] == {"predict": 4}
        base = pi.trace_stats()["total_traces"]
        rng = np.random.default_rng(0)
        inputs = [rng.normal(size=(int(s), 8)).astype(np.float32)
                  for s in rng.integers(1, 20, size=40)]
        with cf.ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(pi.output, inputs))
        assert all(o.shape[0] == x.shape[0] for o, x in zip(outs, inputs))
        assert pi.trace_stats()["total_traces"] == base
        # a call off the warmed shapes is a new trace: the pin can fail
        net.output(np.zeros((3, 8), np.float32))
        assert pi.trace_stats()["total_traces"] == base + 1
        ev = pi.trace_stats()["compile_events"][-1]
        assert ev["key"] == "predict" and "float32[3,8]" in ev["signature"]
    finally:
        pi.shutdown()


def test_status_surfaces_pipeline_and_trace_counters():
    server = ModelServer(_net(), batch_limit=8, device="cpu").start()
    try:
        client = ModelClient(_url(server))
        client.predict(np.zeros((3, 8), np.float32))
        st = client.status()
        assert st["pipeline"]["warmed_buckets"] == [1, 2, 4, 8]
        assert st["pipeline"]["pipeline_depth"] == 2
        assert st["pipeline"]["bucket_cap"] == 8
        assert st["pipeline"]["batches_dispatched"] >= 1
        assert st["total_traces"] == 4
        assert st["trace_counts"] == {"predict": 4}
        assert st["recompiles"]["total"] == 4
        assert client.metrics()["dl4j_jit_traces_total"] == 4
    finally:
        server.stop()


def test_registry_entry_points_default_to_cuda():
    """No CPU fallback: without a GPU, a server that builds its own
    registry raises unless the caller asks for the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from deeplearning4j_tpu_torch.serving import ModelRegistry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelServer(_net())


@pytest.mark.parametrize("route", ["poisoned_predict", "unknown_route"])
def test_error_before_the_body_is_read_still_answers(route):
    """A handler that fails before it parses the body (an armed fault
    point, an unknown route) answers with its status, not a broken pipe:
    the server reads a 16 MB body before it answers and closes."""
    class _Echo:
        def output(self, x):
            return np.asarray(x)

    server = ModelServer(_Echo(), model_name="m", device="cpu").start()
    try:
        client = ModelClient(_url(server), retry=Retry(max_attempts=1),
                             breaker=None)
        big = np.zeros((4, 1024, 1024), np.float32)
        with pytest.raises(ServingError) as ei:
            if route == "unknown_route":
                client._request_bytes("/nope", big.tobytes(),
                                      NPZ_CONTENT_TYPE)
            else:
                injector().inject("rollout.canary_poison", times=1)
                client.predict(big, model="m")
        assert ei.value.status == (404 if route == "unknown_route"
                                   else 500)
        assert np.asarray(client.predict(np.ones((1, 2), np.float32),
                                         model="m")["outputs"]).size == 2
    finally:
        server.stop()
