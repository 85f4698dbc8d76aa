"""The port's ModelClient (deeplearning4j_tpu_torch/parallel/serving.py)
on the CPU, client side: the counterparts of tests/test_resilience.py's
client taxonomy cases (typed errors with Retry-After, retries, the
default CircuitBreaker opening on 503s and not on 4xx) and
tests/test_serving.py's fallback to the JSON wire, plus the port's own
points: `http.client` transport failures (a reset, a truncated body, a
garbled status line) reach retry and failover as ConnectionErrors, and a
ReplicaRouter fails over when a replica dies mid-response.

Stub servers poll for shutdown every 50 ms; every wait has a deadline.
"""

import http.server
import json
import socket
import socketserver
import threading

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.serving import (
    ModelClient,
    ModelServer,
)
from deeplearning4j_tpu_torch.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    RetriesExhaustedError,
    Retry,
    ServingError,
)

pytestmark = pytest.mark.serving

RTOL, ATOL = 1e-4, 1e-5


def _net(seed=7, n_in=8, n_out=6):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=n_out, loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _url(server):
    return f"http://127.0.0.1:{server.port}"


def _stub_http_server(handler_fn):
    """HTTP server whose POST answers `handler_fn(nth) -> (status, body,
    headers)`; returns (httpd, hits)."""
    hits = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            hits.append(self.headers.get("Content-Type"))
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            status, body, headers = handler_fn(len(hits), raw)
            self.send_response(status)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    class _S(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True

    httpd = _S(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return httpd, hits


def _stop_stub(httpd):
    httpd.shutdown()
    httpd.server_close()


def test_binary_wire_falls_back_to_json_for_old_servers():
    def old_server(nth, raw):
        try:
            json.loads(raw.decode())
            return 200, b'{"outputs": [[1.0]]}', []
        except Exception as e:   # noqa: BLE001 - the old-server shape
            return 400, json.dumps(
                {"error": f"malformed JSON body: {e}",
                 "error_class": "_ClientError"}).encode(), []

    httpd, hits = _stub_http_server(old_server)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        client = ModelClient(url, breaker=None, retry=Retry(max_attempts=1))
        assert client.predict([[1.0]])["outputs"] == [[1.0]]
        assert not client._npz_ok
        assert hits == ["application/x-npz", "application/json"]
        client.predict([[1.0]])
        assert hits[-1] == "application/json" and len(hits) == 3
        strict = ModelClient(url, breaker=None, wire="npz",
                             retry=Retry(max_attempts=1))
        with pytest.raises(ServingError) as ei:
            strict.predict([[1.0]])
        assert ei.value.status == 400 and strict._npz_ok
    finally:
        _stop_stub(httpd)


def test_client_surfaces_503_with_retry_after_and_retries():
    def handler(nth, raw):
        if nth < 3:
            return (503, b'{"error": "queue full", '
                    b'"error_class": "OverloadedError"}',
                    [("Retry-After", "1")])
        return 200, b'{"outputs": [[1.0]]}', []

    httpd, hits = _stub_http_server(handler)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with pytest.raises(ServingError) as ei:
            ModelClient(url, retry=Retry(max_attempts=1)).predict([[1.0]])
        assert ei.value.status == 503
        assert ei.value.error_class == "OverloadedError"
        assert ei.value.message == "queue full"
        assert ei.value.retry_after_s == 1.0 and ei.value.retryable
        hits.clear()
        out = ModelClient(url, retry=Retry(
            max_attempts=4, initial_backoff_s=0.01,
            retryable=ModelClient._retryable)).predict([[1.0]])
        assert out["outputs"] == [[1.0]]
        assert len(hits) == 3
    finally:
        _stop_stub(httpd)


def test_model_client_has_circuit_breaker_by_default():
    assert isinstance(ModelClient("http://x").breaker, CircuitBreaker)
    assert ModelClient("http://x", breaker=None).breaker is None


def test_model_client_breaker_opens_on_503s_and_half_opens():
    ok = [False]

    def handler(nth, raw):
        if ok[0]:
            return 200, b'{"outputs": [[1.0]]}', []
        return (503, b'{"error": "queue full", '
                b'"error_class": "OverloadedError"}',
                [("Retry-After", "1")])

    httpd, hits = _stub_http_server(handler)
    try:
        now = [0.0]
        breaker = CircuitBreaker(failure_threshold=3, reset_timeout_s=10.0,
                                 clock=lambda: now[0])
        client = ModelClient(
            f"http://127.0.0.1:{httpd.server_address[1]}",
            retry=Retry(max_attempts=1, retryable=lambda e: False),
            breaker=breaker)
        for _ in range(3):
            with pytest.raises(ServingError):
                client.predict([[1.0]])
        assert breaker.state == CircuitBreaker.OPEN
        server_hits = len(hits)
        with pytest.raises(CircuitOpenError) as ei:
            client.predict([[1.0]])
        assert ei.value.retry_after_s > 0 and len(hits) == server_hits
        now[0] = 11.0
        ok[0] = True
        assert client.predict([[1.0]])["outputs"] == [[1.0]]
        assert breaker.state == CircuitBreaker.CLOSED
    finally:
        _stop_stub(httpd)


def test_model_client_4xx_does_not_trip_breaker():
    httpd, hits = _stub_http_server(
        lambda nth, raw: (400, b'{"error": "bad", '
                          b'"error_class": "ValueError"}', []))
    try:
        breaker = CircuitBreaker(failure_threshold=2)
        client = ModelClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                             retry=Retry(max_attempts=1), breaker=breaker)
        for _ in range(4):
            with pytest.raises(ServingError) as ei:
                client.predict([[1.0]])
            assert ei.value.status == 400
        assert breaker.state == CircuitBreaker.CLOSED and len(hits) == 4
    finally:
        _stop_stub(httpd)


# ======================================== transport failures (http.client)
def _dying_server(response: bytes):
    """A raw socket server that reads one request and answers with
    `response` (possibly truncated), then drops the connection."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    stop = threading.Event()

    def run():
        sock.settimeout(0.1)
        while not stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                continue
            try:
                conn.settimeout(5.0)
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                conn.sendall(response)
            except OSError:
                pass
            finally:
                conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def close():
        stop.set()
        t.join(timeout=5.0)
        sock.close()

    return sock.getsockname()[1], close


@pytest.mark.parametrize("response", [
    b"",                                                     # reset
    b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n\r\n{\"out",  # truncated
    b"garbage\r\n\r\n",                                      # bad status
], ids=["disconnect", "incomplete_read", "bad_status_line"])
def test_transport_failures_surface_as_connection_errors(response):
    """Every transport-level http.client failure reaches the retry and
    breaker logic as a ConnectionError (urllib's URLError is an
    OSError; http.client's IncompleteRead and BadStatusLine are not), so
    the client counts it as unavailability and retries it."""
    port, close = _dying_server(response)
    try:
        client = ModelClient(f"http://127.0.0.1:{port}", timeout=5.0,
                             retry=Retry(max_attempts=2,
                                         initial_backoff_s=0.01,
                                         retryable=ModelClient._retryable),
                             breaker=None)
        with pytest.raises(RetriesExhaustedError) as ei:
            client.predict(np.zeros((1, 8), np.float32))
        assert isinstance(ei.value.cause, ConnectionError)
        assert ei.value.attempts == 2
        assert ModelClient._breaker_counted(ei.value.cause)
    finally:
        close()


def test_router_fails_over_when_a_replica_dies_mid_response():
    """A replica that dies mid-response (truncated body) fails over to a
    healthy replica through the router: the caller sees one answer."""
    from deeplearning4j_tpu_torch.serving import ReplicaRouter

    port, close = _dying_server(
        b"HTTP/1.1 200 OK\r\nContent-Type: application/x-npz\r\n"
        b"Content-Length: 4096\r\n\r\nPK\x03\x04")
    net = _net()
    server = ModelServer(net, device="cpu").start()
    try:
        router = ReplicaRouter(
            [f"http://127.0.0.1:{port}", _url(server)],
            client_factory=lambda u: ModelClient(
                u, timeout=5.0, retry=Retry(max_attempts=1)))
        x = np.random.default_rng(4).normal(size=(3, 8)).astype(np.float32)
        for _ in range(3):
            r = router.predict(x)
            np.testing.assert_allclose(np.asarray(r["outputs"]),
                                       net.output(x).numpy(), rtol=RTOL,
                                       atol=ATOL)
        assert router.stats()["failovers"] >= 1
    finally:
        server.stop()
        close()
