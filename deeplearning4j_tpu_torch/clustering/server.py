"""Nearest-neighbour REST microservice + client (counterpart of
deeplearning4j_tpu/clustering/server.py).

Parity: deeplearning4j-nearestneighbor-server / -client / -model —
a small HTTP service answering k-NN queries over an indexed corpus
(ref NearestNeighborsServer.java; JSON request/response records in
deeplearning4j-nearestneighbor-model).

The corpus lives on the server's device (the card unless `device`
says otherwise) and each POST runs `distances.knn` there; single exact
queries can use the host VPTree. stdlib http.server, the same pattern
as stats.dashboard.UIServer. The client speaks `http.client` (the port
never imports urllib): a transport fault reaches the caller as a
ConnectionError, and an error status as a ServingError carrying the
server's message.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from deeplearning4j_tpu_torch.clustering.distances import as_points, knn
from deeplearning4j_tpu_torch.resilience.errors import ServingError


class NearestNeighborsServer:
    """POST /knn {"points": [[...], ...], "k": 5} ->
    {"results": [{"indices": [...], "distances": [...]}, ...]}
    GET /status -> {"num_points": N, "dims": D, "metric": ...}"""

    def __init__(self, corpus, port: int = 0, host: str = "127.0.0.1",
                 metric: str = "euclidean", device=None):
        self.corpus = as_points(corpus, device)
        if self.corpus.ndim != 2:
            raise ValueError("corpus must be [N, D]")
        self.metric = metric
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def _answer(self, points, k: int = 1):
        """k-NN of `points` ([n, D] or [D]) over the corpus, as the
        response records."""
        pts = np.asarray(points, np.float32)
        if pts.ndim == 1:
            pts = pts[None, :]
        idx, dist = knn(pts, self.corpus, k=int(k), metric=self.metric)
        return [{"indices": row_i, "distances": row_d}
                for row_i, row_d in zip(idx.tolist(), dist.tolist())]

    def start(self) -> "NearestNeighborsServer":
        import http.server
        import socketserver

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.rstrip("/") == "/status":
                    self._send(200, {
                        "num_points": int(server.corpus.shape[0]),
                        "dims": int(server.corpus.shape[1]),
                        "metric": server.metric})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    # the body is read before any answer, so a client
                    # never sees its upload cut off by an early error
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                    if self.path.rstrip("/") != "/knn":
                        raise ValueError(f"no route {self.path}")
                    req = json.loads(raw.decode())
                    self._send(200, {"results": server._answer(
                        req["points"], req.get("k", 1))})
                except Exception as e:   # noqa: BLE001 - HTTP boundary
                    self._send(400, {"error": str(e)})

            def log_message(self, *a):
                pass

        class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="NearestNeighborsServer-http")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class NearestNeighborsClient:
    """ref NearestNeighborsClient.java."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _exchange(self, method: str, route: str, payload=None) -> dict:
        """One HTTP exchange: the JSON answer, a ServingError for an
        error status, a ConnectionError for a transport fault."""
        import http.client

        scheme, _, rest = self.url.partition("://")
        if scheme != "http" or not rest:
            raise ValueError(f"not an http URL: {self.url!r}")
        host, slash, prefix = rest.partition("/")
        path = (slash + prefix if slash else "") + route
        data = None if payload is None else json.dumps(payload).encode()
        conn = http.client.HTTPConnection(host, timeout=self.timeout)
        try:
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            status, reason, body = r.status, r.reason, r.read()
        except http.client.HTTPException as e:
            raise ConnectionError(
                f"{method} {self.url}{route}: {type(e).__name__}: {e}") \
                from e
        finally:
            conn.close()
        try:
            obj = json.loads(body.decode())
        except ValueError:
            obj = {}
        if not 200 <= status < 300:
            msg = obj.get("error") if isinstance(obj, dict) else None
            raise ServingError(status=status,
                               message=msg or f"HTTP {status}: {reason}",
                               body=obj if isinstance(obj, dict) else {})
        return obj

    def knn(self, point, k: int = 1):
        """Single query -> (indices, distances)."""
        res = self._exchange("POST", "/knn", {
            "points": [list(map(float, point))], "k": k})["results"][0]
        return res["indices"], res["distances"]

    def knn_batch(self, points, k: int = 1):
        res = self._exchange("POST", "/knn", {
            "points": [list(map(float, p)) for p in points], "k": k})
        return res["results"]

    def status(self) -> dict:
        return self._exchange("GET", "/status")
