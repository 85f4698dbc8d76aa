"""Network-facing model serving over ParallelInference (counterpart of
deeplearning4j_tpu/parallel/serving.py: the same routes, JSON and npz
wires, error taxonomy, metric names and fault points).

Parity: dl4j-streaming's Camel serve route
(streaming/routes/DL4jServeRouteBuilder.java — accept a record over
the wire, run `model.output`, hand the result to a post-processor) and
the ModelServer role around ParallelInference. Kafka/Camel transports
stay out of scope (VERDICT r4); the serving surface itself is plain
HTTP+JSON like the nearest-neighbor microservice
(clustering/server.py), so the round-trip is testable anywhere.

Routes (single-model compatibility surface — routes to the registry's
default model):
  POST /predict  {"inputs": [[...], ...]}          -> {"outputs": [...]}
  POST /predict  {"inputs": ..., "decode_top": 5}  -> adds "decoded"
                 (requires an ImageNetLabels source; zoo/util/imagenet)
  GET  /status   -> model + queue + telemetry facts (uptime_s,
                 monotonic request/error counters from the registry)
  GET  /metrics  -> Prometheus text exposition of the global
                 MetricsRegistry (training, serving, checkpoint, and
                 resilience domains — one scrape covers the process)
  GET  /healthz  -> liveness: 200 while every active model's batcher is
                 alive, 503 after one dies or the server shuts down
  GET  /readyz   -> readiness: 200 only while accepting traffic

Multi-model control plane (serving/ModelRegistry behind the same
server — every model × version has its own warmed ParallelInference):
  POST   /v1/models/<name>/predict      predict on the ACTIVE version;
                 body may carry {"tenant": ...} (or X-Tenant header)
                 for admission, and "inputs" may be a dict of named
                 input streams for multi-input graphs
  POST   /v1/models/<name>/generate     continuous-batched
                 autoregressive generation (serving/continuous.py
                 DecodeEngine attached via `decode_engine=` /
                 `attach_decode_engine`): {"prompt": [ids...],
                 "max_new_tokens": n, "eos_id": id?} -> {"tokens":
                 [...], "finish_reason": "eos"|"length"}. Speaks the
                 npz wire too (prompt as an int array entry; the
                 VARIABLE-LENGTH token output rides back as a raw
                 int32 array). 429 + Retry-After on slot exhaustion
  GET    /v1/models                     catalog: every model, version,
                 lifecycle state, active/previous pointers
  GET    /v1/models/<name>/status       per-model pipeline/trace facts
  PUT    /v1/models/<name>/versions/<v> {"path": zip, "activate": true}
                 load a model zip through the integrity-checked
                 serializer (corrupted uploads are REJECTED, 409) and
                 hot-swap with zero downtime
  POST   /v1/models/<name>/swap         {"version": v} activate a
                 loaded standby version
  POST   /v1/models/<name>/rollback     one-call flip to the previous
                 (still-warm) version
  DELETE /v1/models/<name>/versions/<v> retire a non-active version
  DELETE /v1/models/<name>              remove the model entirely

Failure taxonomy (resilience subsystem) instead of blanket 400:
  404 unknown route / unknown model or version
  400 malformed payload / client error
  429 + Retry-After tenant quota exhausted or priority class shed
  409 lifecycle conflict (delete active, swap to retired) or a
      corrupted upload failing integrity checks
  503 + Retry-After overload, shutdown, or dead batcher
  500 model/handler crash
Every error body is {"error": msg, "error_class": ExceptionName}.
A request whose per-example shape differs from the model's is a 400:
ParallelInference checks it before queueing (a ValueError). The JAX
server fails inside the batch there and answers 500.

ModelClient speaks http.client (the port never imports urllib). Every
transport-level failure — refused or reset connection, timeout, a
truncated or garbled response (any http.client.HTTPException) — reaches
the retry, breaker and failover logic as a ConnectionError, so a replica
killed mid-response fails over instead of surfacing to the caller.

Threads: HTTP handler threads only queue work. `net.output` runs on
ParallelInference's batcher thread and `generate` on the DecodeEngine's
loop thread, each on the weights' own device.

Requests are funneled through each model's ParallelInference in
BATCHED mode, so concurrent small clients coalesce into full batches on
the card (the reference's BatchedInferenceObservable role); the tenant
AdmissionController (serving/admission.py) sheds the lowest priority
class first before the bounded queue fills.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.observability.metrics import (
    get_registry,
    parse_prometheus,
)
from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode,
    ParallelInference,
)
from deeplearning4j_tpu_torch.resilience.errors import (
    CheckpointIntegrityError,
    CircuitOpenError,
    DeadlineExceededError,
    InferenceUnavailableError,
    ModelNotFoundError,
    OverloadedError,
    QuotaExceededError,
    RetriesExhaustedError,
    ServingError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire
from deeplearning4j_tpu_torch.resilience.retry import CircuitBreaker, Retry

# NOTE: the control-plane classes (ModelRegistry, AdmissionController)
# are imported lazily inside ModelServer.__init__ — serving/registry.py
# imports the parallel package, so a module-level import here would be
# circular from either entry point.

# errors that mean "back off and retry": surfaced as 503 + Retry-After
_UNAVAILABLE = (OverloadedError, ShutdownError, InferenceUnavailableError,
                DeadlineExceededError)


class _ClientError(ValueError):
    """Request was malformed — maps to HTTP 400."""


# ---------------------------------------------------- binary wire format
# npz-over-HTTP: input arrays ride as raw .npz bytes (one zip entry per
# input stream, `__meta__` a JSON string entry for the scalar fields)
# instead of JSON-encoded nested lists — no .tolist() host
# materialization on either side and ~4x fewer bytes for float32.
# ModelClient speaks it by default and falls back to JSON once per
# client when the server predates the format.
NPZ_CONTENT_TYPE = "application/x-npz"


def _npz_bytes(arrays: dict, meta: dict) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return buf.getvalue()


def encode_npz_request(inputs, meta: dict) -> bytes:
    """`inputs`: one array, or {name: array} for multi-input graphs."""
    if isinstance(inputs, dict):
        arrays = {f"input:{k}": np.asarray(v) for k, v in inputs.items()}
    else:
        arrays = {"input": np.asarray(inputs)}
    return _npz_bytes(arrays, meta)


def decode_npz_request(raw: bytes) -> dict:
    """Parse an npz request body into the same dict shape the JSON
    route produces (inputs as arrays instead of nested lists)."""
    import io

    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            meta = (json.loads(str(z["__meta__"]))
                    if "__meta__" in z.files else {})
            named = {k[len("input:"):]: z[k]
                     for k in z.files if k.startswith("input:")}
            inputs = named if named else (
                z["input"] if "input" in z.files else None)
    except (OSError, ValueError, KeyError) as e:
        raise _ClientError(f"malformed npz body: {e}") from None
    if inputs is None:
        raise _ClientError("npz body carries no 'input' entry")
    if not isinstance(meta, dict):
        raise _ClientError("npz __meta__ must be a JSON object")
    return {"inputs": inputs, **meta}


def encode_npz_response(outputs, meta: dict) -> bytes:
    if isinstance(outputs, list):
        arrays = {f"output:{i}": np.asarray(o)
                  for i, o in enumerate(outputs)}
    else:
        arrays = {"output": np.asarray(outputs)}
    return _npz_bytes(arrays, meta)


def decode_npz_response(raw: bytes) -> dict:
    """Client-side parse: the response dict with `outputs` as host
    numpy array(s) — never round-tripped through JSON lists."""
    import io

    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        resp = (json.loads(str(z["__meta__"]))
                if "__meta__" in z.files else {})
        multi = sorted((k for k in z.files if k.startswith("output:")),
                       key=lambda k: int(k.split(":", 1)[1]))
        if multi:
            resp["outputs"] = [z[k] for k in multi]
        elif "output" in z.files:
            resp["outputs"] = z["output"]
    return resp


class ModelServer:
    """Serve trained MultiLayerNetwork/ComputationGraph models over
    HTTP.

    Single-model compatibility: `ModelServer(net)` registers `net` as
    the registry's default model and the single-model routes
    (/predict, /status, probes) serve it. Multi-model: pass
    `registry=` (a serving.ModelRegistry) or keep registering models on
    `server.registry` — each model × version gets its own warmed
    ParallelInference and the /v1/models routes drive the lifecycle.

    `tenants` ({name: {"rate": ..., "burst": ..., "priority": ...}} or
    {name: TenantConfig}) arms the admission layer: per-tenant token
    buckets and priority classes, lowest class shed first under queue
    pressure. `labels` (optional ImageNetLabels) enables decoded top-k
    responses — the user-facing half of the zoo
    (`decode_predictions`)."""

    def __init__(self, net=None, port: int = 0, host: str = "127.0.0.1",
                 inference_mode: str = InferenceMode.BATCHED,
                 batch_limit: int = 32, labels=None,
                 output_activation: bool = True,
                 pipeline_depth: int = 2, warmup: bool = True,
                 max_wait_ms: float = 2.0, adaptive_wait: bool = True,
                 tracer=None, registry=None, admission=None,
                 tenants=None, model_name: str = "default",
                 queue_limit: int = 64, decode_engine=None,
                 decode_engines=None, journal_dir: Optional[str] = None,
                 device=None):
        """`device`: where the built registry restores uploaded model
        zips — None means cuda (raises without a GPU), "cpu" as the CPU
        tests pass. Ignored with a caller's `registry=`."""
        from deeplearning4j_tpu_torch.serving.admission import (
            AdmissionController,
            TenantConfig,
        )
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry

        self._owns_registry = registry is None
        self.registry = registry if registry is not None else \
            ModelRegistry(device=device,
                          inference_mode=inference_mode,
                          batch_limit=batch_limit,
                          queue_limit=queue_limit,
                          pipeline_depth=pipeline_depth,
                          warmup=warmup, max_wait_ms=max_wait_ms,
                          adaptive_wait=adaptive_wait, tracer=tracer)
        if net is not None:
            self.registry.register(model_name, net)
        if admission is not None:
            self.admission = admission
        elif tenants:
            self.admission = AdmissionController(
                {n: (t if isinstance(t, TenantConfig)
                     else TenantConfig.from_dict(n, t))
                 for n, t in tenants.items()})
        else:
            self.admission = None
        # continuous-batching decode engines, keyed by model name
        # (serving/continuous.py — the /v1/models/<m>/generate route)
        self.decode_engines = dict(decode_engines or {})
        if decode_engine is not None:
            self.decode_engines.setdefault(model_name, decode_engine)
        # durable serving: one write-ahead generation journal per
        # model-version under `journal_dir` (serving/journal.py).
        # Attaching RECOVERS — a server constructed on the journal dir
        # a crashed process left behind re-admits every in-flight
        # generation (resume_tokens replay) before it serves a request
        self.journal_dir = journal_dir
        self._journals = {}
        for name, engine in self.decode_engines.items():
            self._attach_journal(name, engine)
        self.tracer = tracer if tracer is not None \
            else getattr(self._default_pi(), "tracer", None)
        # engines without their own tracer inherit the server's: the
        # server-side rpc.generate span and the engine's generation
        # span tree land in ONE buffer (one export) per process
        if self.tracer is not None:
            for engine in self.decode_engines.values():
                if getattr(engine, "tracer", None) is None:
                    engine.tracer = self.tracer
        self.labels = labels
        self.host = host
        self.port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._served = 0
        self._served_lock = threading.Lock()
        self._ready = False
        self._started_engines = set()
        self._t0 = time.monotonic()

    # --------------------------------------------------------- plumbing
    @property
    def pi(self):
        """The default model's ACTIVE ParallelInference (the
        single-model surface)."""
        return self._default_pi()

    def _default_pi(self):
        try:
            e = self.registry.default_entry()
            with e._lock:
                return e.versions[e.active].pi if e.active else None
        except (ModelNotFoundError, ShutdownError):
            return None

    def _healthy(self) -> bool:
        """Live while every active model version's batcher is alive. A
        server with decode engines and no active model version (a
        decode-only replica) is live while it is started: the registry
        alone reads it unhealthy, and the JAX server answers its
        /healthz 503, so a FleetController would remove every decode
        replica it polls."""
        if self.registry.healthy():
            return True
        return self._ready and bool(self.decode_engines) \
            and not self._serves_a_model()

    def _serves_a_model(self) -> bool:
        try:
            return any(self.registry.entry(n).active
                       for n in self.registry.model_names())
        except (ModelNotFoundError, ShutdownError):
            return False   # racing a removal or the shutdown

    # ------------------------------------------------------------ handlers
    @staticmethod
    def _request_arrays(req: dict, pi) -> list:
        """The request's input arrays: a bare array for single-input
        models, or a dict of named streams ordered by the graph's
        network_inputs for multi-input graphs."""
        try:
            inputs = req["inputs"]
        except KeyError:
            raise _ClientError("missing required field 'inputs'") from None
        try:
            if isinstance(inputs, dict):
                names = getattr(getattr(pi.net, "conf", None),
                                "network_inputs", None) or \
                    sorted(inputs)
                missing = [n for n in names if n not in inputs]
                if missing:
                    raise _ClientError(
                        f"missing named inputs {missing} "
                        f"(model wants {list(names)})")
                xs = [np.asarray(inputs[n], np.float32) for n in names]
            else:
                xs = [np.asarray(inputs, np.float32)]
        except _ClientError:
            raise
        except (TypeError, ValueError) as e:
            raise _ClientError(f"bad 'inputs': {e}") from None
        if req.get("single", False):
            xs = [x[None, ...] for x in xs]   # one unbatched example
        return xs

    def _handle_predict(self, req: dict, model: Optional[str] = None,
                        tenant: Optional[str] = None,
                        binary: bool = False) -> dict:
        entry = (self.registry.entry(model) if model is not None
                 else self.registry.default_entry())
        tenant = tenant or req.get("tenant")
        top = int(req.get("decode_top", 0))
        if top > 0 and self.labels is None:
            raise _ClientError(
                "server started without labels; decode_top unavailable")
        # the lease pins ONE (version, pi) pair: a hot-swap between
        # admission and response is invisible to this request
        with entry.lease() as (version, pi):
            priority = None
            if self.admission is not None:
                cfg = self.admission.admit(tenant, entry.name,
                                           pi.queue_depth(),
                                           pi.queue_limit)
                # admitted requests also DEQUEUE in class order:
                # high-before-normal-before-low inside the bounded queue
                priority = cfg.priority
            xs = self._request_arrays(req, pi)
            out = pi.output(*xs, priority=priority)
            _obs.count("dl4j_serving_model_requests_total",
                       labels={"model": entry.name, "version": version})
        with self._served_lock:
            self._served += xs[0].shape[0]
        multi = isinstance(out, list)
        # binary wire: outputs stay host numpy arrays (the handler npz-
        # encodes them straight from these buffers); JSON wire converts
        # to nested lists — the completion stage already paid the
        # device fetch either way, so both are host-side copies
        if binary:
            outputs = ([np.asarray(o) for o in out] if multi
                       else np.asarray(out))
        else:
            outputs = (
                [np.asarray(o).tolist() for o in out]
                if multi else np.asarray(out).tolist())
        resp = {
            "outputs": outputs,
            "model": entry.name,
            "version": version,
        }
        if multi:
            resp["multi_output"] = True
        if top > 0 and not multi:
            out = np.asarray(out)
            resp["decoded"] = [
                [{"class": c, "wnid": w, "label": l, "probability": p}
                 for (c, w, l, p) in row]
                for row in self.labels.decode_predictions(out, top=top)]
        return resp

    # --------------------------------------------------------- generate
    def attach_decode_engine(self, name: str, engine) -> "ModelServer":
        """Attach a continuous-batching DecodeEngine to model `name`
        (the /v1/models/<name>/generate route). With `journal_dir`
        set, the engine also gets its per-model-version write-ahead
        journal (recovery included)."""
        self.decode_engines[name] = engine
        if self.tracer is not None \
                and getattr(engine, "tracer", None) is None:
            engine.tracer = self.tracer
        self._attach_journal(name, engine)
        return self

    def _attach_journal(self, name: str, engine) -> None:
        """Open (or recover) model `name`'s journal and arm the
        engine with it. Engines that already carry a journal keep it
        (the caller-owned rule)."""
        if self.journal_dir is None \
                or getattr(engine, "_journal", None) is not None:
            return
        from deeplearning4j_tpu_torch.serving.journal import GenerationJournal

        try:
            version = self.registry.entry(name).active or "v0"
        except ModelNotFoundError:
            version = "v0"
        journal = GenerationJournal(
            os.path.join(self.journal_dir, f"{name}@{version}"))
        self._journals[name] = journal
        engine.attach_journal(journal, recover=True)

    def _handle_generate(self, req: dict, model: Optional[str],
                         tenant: Optional[str] = None) -> dict:
        name = model or self.registry.default_model
        engine = self.decode_engines.get(name)
        if engine is None:
            raise ModelNotFoundError(
                f"model {name!r} has no decode engine attached")
        # npz wire reuses the generic 'inputs' array entry as the
        # prompt; JSON spells it 'prompt'
        prompt = req.get("prompt", req.get("inputs"))
        if prompt is None:
            raise _ClientError("missing required field 'prompt'")
        try:
            prompt = [int(t) for t in np.asarray(prompt).ravel()]
        except (TypeError, ValueError) as e:
            raise _ClientError(f"bad 'prompt': {e}") from None
        try:
            max_new = int(req.get("max_new_tokens", 16))
            eos_id = req.get("eos_id")
            eos_id = None if eos_id is None else int(eos_id)
            timeout_s = float(req.get("timeout_s", 60.0))
            deadline_s = req.get("deadline_s")
            deadline_s = None if deadline_s is None else float(deadline_s)
            resume = req.get("resume_tokens")
            if resume is not None:
                resume = [int(t) for t in np.asarray(resume).ravel()]
            rid = req.get("request_id")
            rid = None if rid is None else str(rid)
            trace = req.get("trace")
            trace = None if trace is None else str(trace)
        except (TypeError, ValueError) as e:
            raise _ClientError(f"bad generate parameters: {e}") \
                from None
        tenant = tenant or req.get("tenant")
        if self.tracer is None:
            return self._run_generation(
                engine, name, prompt, max_new, eos_id, timeout_s,
                deadline_s, resume, rid, tenant, trace)
        if trace is None:
            from deeplearning4j_tpu_torch.observability.tracing import (
                new_trace_id,
            )

            trace = new_trace_id()
        # the replica-side request span: the engine's "generate" root
        # span (opened by submit on this thread) nests under it via the
        # tracer's implicit stack, so one process's leg is one subtree
        with self.tracer.span("rpc.generate", cat="serving",
                              args={"trace": trace, "model": name,
                                    "request_id": rid or ""}):
            return self._run_generation(
                engine, name, prompt, max_new, eos_id, timeout_s,
                deadline_s, resume, rid, tenant, trace)

    def _run_generation(self, engine, name, prompt, max_new, eos_id,
                        timeout_s, deadline_s, resume, rid, tenant,
                        trace) -> dict:
        if not engine.running:
            if not self._ready:
                # retiring replica: never restart a decode loop the
                # shutdown path already tore down — tell the caller to
                # take its generation elsewhere instead
                raise ShutdownError("server stopping; replica retiring")
            # lazily start the decode loop; stop() tears down only
            # loops this server started (caller-owned engines keep
            # running — the caller-owned ParallelInference rule)
            engine.ensure_started()
            self._started_engines.add(name)
        try:
            handle = engine.submit(prompt, max_new, eos_id=eos_id,
                                   tenant=tenant, deadline_s=deadline_s,
                                   resume_tokens=resume,
                                   request_id=rid, trace=trace)
        except ValueError as e:
            raise _ClientError(str(e)) from None
        try:
            handle.result(timeout_s=timeout_s)
        except ShutdownError as e:
            # replica retiring mid-generation: the 503 body carries the
            # tokens decoded so far plus a `resumable` marker, so the
            # caller (ModelClient / ReplicaRouter) can re-dispatch the
            # request to a healthy replica as a continuation instead of
            # losing the work (the trace id rides along, so the next
            # leg joins the same timeline)
            e.partial = {"tokens": handle.tokens_so_far(),
                         "finish_reason": "migrated",
                         "model": name, "resumable": True,
                         "trace": handle.trace}
            raise
        except TimeoutError:
            # transport-level wait budget, distinct from the engine's
            # own deadline sweep: free the slot and surface a resumable
            # 503 with whatever was decoded (same continuation contract)
            handle.cancel()
            err = DeadlineExceededError(
                f"generation exceeded timeout_s={timeout_s}")
            err.partial = {"tokens": handle.tokens_so_far(),
                           "finish_reason": "timeout",
                           "model": name, "resumable": True,
                           "trace": handle.trace}
            raise err from None
        return {
            "tokens": handle.tokens_so_far(),
            "model": name,
            "finish_reason": handle.finish_reason,
            "evictions": handle.evictions,
            "replays": handle.replays,
            "request_id": handle.request_id,
            "trace": handle.trace,
        }

    # ------------------------------------------------- lifecycle routes
    def _handle_put_version(self, model: str, version: str,
                            req: dict) -> dict:
        path = req.get("path")
        if not path or not isinstance(path, str):
            raise _ClientError(
                "body must carry 'path': a server-readable model zip")
        self.registry.load_version(
            model, version, path,
            model_type=req.get("model_type", "auto"),
            activate=bool(req.get("activate", True)),
            warmup_inputs=req.get("warmup_inputs"))
        return {"model": model, "version": version,
                "active": self.registry.entry(model).active}

    def _handle_model_command(self, model: str, command: str,
                              req: dict) -> dict:
        if command == "rollback":
            version = self.registry.rollback(model)
        elif command == "swap":
            version = req.get("version")
            if not version:
                raise _ClientError("swap needs 'version' in the body")
            self.registry.swap(model, version)
        else:
            raise ModelNotFoundError(f"no model command {command!r}")
        return {"model": model,
                "active": self.registry.entry(model).active,
                "previous": self.registry.entry(model).previous}

    # ----------------------------------------------------------- status
    def _status_facts(self) -> dict:
        pi = self._default_pi()
        entry = None
        try:
            entry = self.registry.default_entry()
        except (ModelNotFoundError, ShutdownError):
            pass
        facts = {
            "model": (type(pi.net).__name__ if pi is not None
                      else None),
            "default_model": self.registry.default_model,
            "version": (entry.active if entry is not None else None),
            "models": self.registry.model_names(),
            "inference_mode": (pi.mode if pi is not None else None),
            "batch_limit": (pi.batch_limit if pi is not None else None),
            "served": self._served,
            "queue_depth": (pi.queue_depth() if pi is not None else 0),
            "healthy": self._healthy(),
            "ready": self._ready and self._healthy(),
            "has_labels": self.labels is not None}
        # pipelined data-plane + compile-once guard facts: bucket
        # warmup, trace/recompile counters, adaptive-wait state
        if pi is not None:
            facts["pipeline"] = pi.stats()
            trace = pi.trace_stats()
            facts["trace_counts"] = trace.get("trace_counts", {})
            facts["total_traces"] = trace.get("total_traces", 0)
            # recompile forensics: "why did that request take 8s" —
            # the signature/duration/cost ring of recent new traces
            facts["recompiles"] = {
                "total": trace.get("compiles_total", 0),
                "recent": trace.get("compile_events", []),
            }
        if self.admission is not None:
            facts["admission"] = self.admission.stats()
        # continuous-batching decode engines: slot occupancy, token
        # throughput, eviction/prefill counters, compile-trace pins
        if self.decode_engines:
            facts["decode"] = {name: engine.stats()
                               for name, engine
                               in self.decode_engines.items()}
        # durable serving: per-model journal occupancy (live WAL
        # entries, torn tails truncated, compactions, disk bytes)
        if self._journals:
            facts["journal"] = {name: j.stats()
                                for name, j in self._journals.items()}
        # telemetry facts (observability/): uptime + the registry's
        # monotonic request/error counters (process-wide, survive
        # across this server's construction), plus span-buffer facts
        # when a tracer is attached
        reg = get_registry()
        facts["uptime_s"] = round(time.monotonic() - self._t0, 3)
        facts["requests_total"] = int(reg.counter_value(
            "dl4j_serving_requests_total"))
        facts["errors_total"] = int(reg.counter_value(
            "dl4j_serving_errors_total"))
        facts["telemetry"] = {
            "enabled": _obs.telemetry_enabled(),
            "dropped_emissions": reg.dropped,
            "spans": (self.tracer.stats()
                      if self.tracer is not None else None),
        }
        return facts

    def _metrics_text(self) -> str:
        """The GET /metrics body: refresh the pull-style gauges from
        the live front-end, then render the whole registry."""
        pi = self._default_pi()
        if pi is not None:
            _obs.set_gauge("dl4j_serving_queue_depth",
                           pi.queue_depth())
            trace = pi.trace_stats()
            _obs.set_gauge("dl4j_jit_traces_total",
                           trace.get("total_traces", 0))
        return get_registry().prometheus_text()

    # --------------------------------------------------------------- start
    def start(self) -> "ModelServer":
        import http.server
        import socketserver

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            _raw = None   # the request body, once read

            def _send(self, code, obj, headers=()):
                body = json.dumps(obj).encode()
                self._read_raw()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code, text, content_type):
                self._send_bytes(code, text.encode(), content_type)

            def _send_bytes(self, code, body, content_type):
                self._read_raw()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_error(self, code, exc, headers=()):
                _obs.count("dl4j_serving_errors_total",
                           labels={"code": str(code)})
                body = {"error": str(exc),
                        "error_class": type(exc).__name__}
                # a retiring replica attaches the partial generation
                # (tokens so far + resumable marker) to the exception;
                # ship it in the error body so the caller can migrate
                # the request instead of restarting from scratch
                partial = getattr(exc, "partial", None)
                if isinstance(partial, dict):
                    body.update(partial)
                self._send(code, body, headers)

            def _send_404(self):
                self._send(404, {"error": f"no route {self.path}",
                                 "error_class": "NotFound"})

            def _read_raw(self) -> bytes:
                """The request body, read once. Every answer reads it
                first: a handler that fails before parsing (a fault
                point, an unknown route) and closes the connection on
                a client still sending a large body would surface as a
                broken pipe instead of its status — the JAX server does
                that. As in the JAX server, the read takes whatever
                Content-Length says (a body cap is later work for both
                packages)."""
                if self._raw is None:
                    n = int(self.headers.get("Content-Length", 0))
                    self._raw = self.rfile.read(n) if n else b""
                return self._raw

            @staticmethod
            def _parse_json(raw: bytes) -> dict:
                try:
                    req = json.loads(raw.decode() or "{}")
                except (ValueError, UnicodeDecodeError) as e:
                    raise _ClientError(f"malformed JSON body: {e}") \
                        from None
                if not isinstance(req, dict):
                    raise _ClientError("body must be a JSON object")
                return req

            def _read_body(self) -> dict:
                return self._parse_json(self._read_raw())

            @staticmethod
            def _model_route(path):
                """('name', 'cmd', 'ver') from /v1/models/... paths;
                None when the path is not under /v1/models."""
                parts = [p for p in path.split("/") if p]
                if len(parts) < 2 or parts[0] != "v1" \
                        or parts[1] != "models":
                    return None
                name = parts[2] if len(parts) > 2 else None
                cmd = parts[3] if len(parts) > 3 else None
                ver = parts[4] if len(parts) > 4 else None
                return name, cmd, ver

            def _guarded(self, fn, value_error_code=400):
                """Run a handler under the full error taxonomy.
                `value_error_code` routes bare ValueErrors: 400 on data
                routes (bad request payloads), 409 on lifecycle routes
                (swap/delete conflicts)."""
                try:
                    return fn()
                except _ClientError as e:
                    self._send_error(400, e)
                except ModelNotFoundError as e:
                    self._send_error(404, e)
                except QuotaExceededError as e:
                    retry_after = getattr(e, "retry_after_s", 1.0) or 1.0
                    self._send_error(
                        429, e,
                        [("Retry-After", f"{max(1, int(retry_after))}")])
                except CheckpointIntegrityError as e:
                    # rejected corrupt/torn uploads
                    self._send_error(409, e)
                except ValueError as e:
                    self._send_error(value_error_code, e)
                except _UNAVAILABLE as e:
                    retry_after = getattr(e, "retry_after_s", 1.0) or 1.0
                    self._send_error(
                        503, e,
                        [("Retry-After", f"{max(1, int(retry_after))}")])
                except Exception as e:   # noqa: BLE001 - HTTP boundary
                    self._send_error(500, e)

            def do_GET(self):
                path = self.path.rstrip("/")
                route = self._model_route(path)
                if path == "/status":
                    self._send(200, server._status_facts())
                elif path == "/metrics":
                    # Prometheus text exposition (scrape target)
                    self._send_text(
                        200, server._metrics_text(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    if server._healthy():
                        self._send(200, {"status": "ok"})
                    else:
                        self._send(503, {"status": "unhealthy",
                                         "healthy": False},
                                   [("Retry-After", "1")])
                elif path == "/readyz":
                    if server._ready and server._healthy():
                        self._send(200, {"status": "ready"})
                    else:
                        self._send(503, {"status": "not ready"},
                                   [("Retry-After", "1")])
                elif route is not None:
                    name, cmd, _ = route
                    if name is None:
                        self._send(200, server.registry.models_status())
                    elif cmd == "status":
                        self._guarded(lambda: self._send(
                            200, server.registry.entry(name).status()))
                    else:
                        self._send_404()
                else:
                    self._send_404()

            def _predict(self, model):
                _obs.count("dl4j_serving_requests_total")
                t0 = time.perf_counter()

                def _run():
                    _fire("serve.request")
                    # chaos drill: an armed `rollout.canary_poison`
                    # degrades THIS replica's serving — mode=delay adds
                    # latency, mode=raise turns the request into a 500;
                    # the FleetController's canary SLO watch must catch
                    # either shape and auto-roll the canary back
                    _fire("rollout.canary_poison")
                    binary = NPZ_CONTENT_TYPE in (
                        self.headers.get("Content-Type") or "")
                    req = (decode_npz_request(self._read_raw())
                           if binary else self._read_body())
                    resp = server._handle_predict(
                        req, model=model,
                        tenant=self.headers.get("X-Tenant"),
                        binary=binary)
                    _obs.observe("dl4j_serving_request_seconds",
                                 time.perf_counter() - t0)
                    if binary:
                        outputs = resp.pop("outputs")
                        self._send_bytes(
                            200, encode_npz_response(outputs, resp),
                            NPZ_CONTENT_TYPE)
                    else:
                        self._send(200, resp)

                self._guarded(_run)

            def _generate(self, model):
                _obs.count("dl4j_serving_requests_total")
                t0 = time.perf_counter()

                def _run():
                    _fire("serve.request")
                    binary = NPZ_CONTENT_TYPE in (
                        self.headers.get("Content-Type") or "")
                    req = (decode_npz_request(self._read_raw())
                           if binary else self._read_body())
                    resp = server._handle_generate(
                        req, model=model,
                        tenant=self.headers.get("X-Tenant"))
                    _obs.observe("dl4j_serving_request_seconds",
                                 time.perf_counter() - t0)
                    if resp.get("finish_reason") == "deadline":
                        # request deadline expired mid-generation: 504
                        # with the partial stream in a JSON body (both
                        # wires — the client reads HTTP error bodies as
                        # JSON, so npz framing would hide the tokens)
                        self._send(504, resp)
                    elif binary:
                        # the VARIABLE-LENGTH token output rides as a
                        # raw int32 array entry, length set by this
                        # request's generation alone
                        tokens = np.asarray(resp.pop("tokens"),
                                            np.int32)
                        self._send_bytes(
                            200, encode_npz_response(tokens, resp),
                            NPZ_CONTENT_TYPE)
                    else:
                        self._send(200, resp)

                self._guarded(_run)

            def do_POST(self):
                path = self.path.rstrip("/")
                route = self._model_route(path)
                if path == "/predict":
                    self._predict(None)
                elif route is not None and route[1] == "predict":
                    self._predict(route[0])
                elif route is not None and route[1] == "generate":
                    self._generate(route[0])
                elif route is not None and route[1] in ("rollback",
                                                        "swap"):
                    name, cmd, _ = route
                    self._guarded(lambda: self._send(
                        200, server._handle_model_command(
                            name, cmd, self._read_body())),
                        value_error_code=409)
                else:
                    self._send_404()

            def do_PUT(self):
                route = self._model_route(self.path.rstrip("/"))
                if route is None or route[1] != "versions" \
                        or route[2] is None:
                    self._send_404()
                    return
                name, _, ver = route
                self._guarded(lambda: self._send(
                    200, server._handle_put_version(
                        name, ver, self._read_body())),
                    value_error_code=409)

            def do_DELETE(self):
                route = self._model_route(self.path.rstrip("/"))
                if route is None or route[0] is None:
                    self._send_404()
                    return
                name, cmd, ver = route

                def _run():
                    if cmd == "versions" and ver is not None:
                        server.registry.delete_version(name, ver)
                        self._send(200, {"model": name, "deleted": ver})
                    elif cmd is None:
                        server.registry.remove(name)
                        self._send(200, {"deleted": name})
                    else:
                        self._send_404()

                self._guarded(_run, value_error_code=409)

            def log_message(self, *a):
                pass

        class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ModelServer-http")
        self._thread.start()
        self._ready = True
        return self

    def stop(self):
        self._ready = False   # flip /readyz before tearing anything down
        # stop decode-engine loops BEFORE the HTTP listener: in-flight
        # generate handlers unblock with ShutdownError and answer 503
        # with their partial streams over still-open connections — the
        # migration handoff — instead of dying with the socket. Only
        # loops THIS server started are stopped; caller-started engines
        # keep running (the PI ownership rule).
        for name in sorted(self._started_engines):
            engine = self.decode_engines.get(name)
            if engine is not None:
                engine.stop()
        self._started_engines.clear()
        # close journals AFTER the engines stop appending. Closing is
        # not completion: requests the shutdown interrupted stay live
        # on disk for the next process to recover
        for journal in self._journals.values():
            journal.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._owns_registry:
            # the registry shuts down only the ParallelInference
            # front-ends it built — never a caller-supplied one
            self.registry.shutdown()


_DEFAULT_BREAKER = object()   # sentinel: "construct the default breaker"


class ModelClient:
    """Client for ModelServer (the serve-route consumer).

    HTTP errors surface as typed ServingError carrying the status code
    and the server's JSON {error, error_class} payload (no more
    swallowed bodies). Idempotent calls (/predict, /status, probes)
    retry on connection errors and 503 per `retry` — pass
    `retry=Retry(max_attempts=1)` to disable.

    A CircuitBreaker guards every request BY DEFAULT: repeated
    unavailability (503s, connection errors, retry exhaustion) opens
    the circuit and subsequent calls fail fast with CircuitOpenError —
    letting a drowning server breathe instead of hammering it — until
    the cooldown lets one probe through (half-open). Any response from
    the server, even a 4xx/500, proves liveness and closes the circuit.
    Pass `breaker=None` to disable, or your own CircuitBreaker to tune
    thresholds. Health probes (`healthz`/`readyz`) bypass the breaker:
    a probe must see the instantaneous truth."""

    def __init__(self, url: str, timeout: float = 30.0,
                 retry: Optional[Retry] = None,
                 breaker=_DEFAULT_BREAKER, wire: str = "auto"):
        """`wire`: "auto" (default) speaks the binary npz format and
        permanently falls back to JSON the first time the server turns
        out to predate it; "npz" never falls back; "json" never tries
        binary (byte-compatible with JSON-only clients)."""
        if wire not in ("auto", "npz", "json"):
            raise ValueError(f"wire must be auto|npz|json: {wire!r}")
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.wire = wire
        self._npz_ok = wire != "json"
        self.retry = retry if retry is not None else Retry(
            max_attempts=3, initial_backoff_s=0.05, max_backoff_s=1.0,
            retryable=self._retryable)
        self.breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(failure_threshold=5, reset_timeout_s=5.0)
            if breaker is _DEFAULT_BREAKER else breaker)

    @staticmethod
    def _retryable(exc: Exception) -> bool:
        if isinstance(exc, ServingError):
            return exc.retryable
        return isinstance(exc, (ConnectionError, OSError, TimeoutError))

    @staticmethod
    def _breaker_counted(exc: Exception) -> bool:
        """Failures that indicate an UNAVAILABLE dependency (and should
        trip the breaker) vs. responses that merely report an error."""
        if isinstance(exc, ServingError):
            return exc.retryable         # 503/429: back off
        if isinstance(exc, RetriesExhaustedError):
            return True
        return isinstance(exc, (ConnectionError, OSError, TimeoutError))

    def _call_guarded(self, fn):
        """Run `fn` under the circuit breaker (when enabled). Counted
        failures open it; any server response — success OR typed
        4xx/500 error — records success (the dependency is alive)."""
        if self.breaker is None:
            return fn()

        def _probe_once():
            try:
                return True, fn(), None
            except Exception as e:   # noqa: BLE001 - breaker boundary
                if self._breaker_counted(e):
                    raise             # breaker records the failure
                return False, None, e  # alive: breaker records success

        ok, result, exc = self.breaker.call(_probe_once)
        if not ok:
            raise exc
        return result

    def _exchange(self, method: str, route: str,
                  data: Optional[bytes] = None,
                  content_type: Optional[str] = None):
        """One HTTP exchange over http.client: (status, reason, headers,
        body bytes). Transport-level failures raise ConnectionError (or
        the OSError/TimeoutError they already are), never an
        http.client.HTTPException: a truncated or garbled response is
        an unavailable replica, not an answer."""
        import http.client

        scheme, _, rest = self.url.partition("://")
        if scheme not in ("http", "https") or not rest:
            raise ValueError(f"not an http(s) URL: {self.url!r}")
        host, slash, prefix = rest.partition("/")
        path = (slash + prefix if slash else "") + route
        conn_cls = (http.client.HTTPSConnection if scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(host, timeout=self.timeout)
        try:
            headers = {"Content-Type": content_type} if content_type \
                else {}
            conn.request(method, path, body=data, headers=headers)
            r = conn.getresponse()
            return r.status, r.reason, r.headers, r.read()
        except http.client.HTTPException as e:
            raise ConnectionError(
                f"{method} {self.url}{route}: {type(e).__name__}: {e}") \
                from e
        finally:
            conn.close()

    def _fetch(self, method: str, route: str,
               data: Optional[bytes] = None,
               content_type: Optional[str] = None):
        """`_exchange` with a non-2xx status raised as a ServingError;
        returns (headers, body bytes)."""
        status, reason, headers, body = self._exchange(
            method, route, data, content_type)
        if not 200 <= status < 300:
            raise self._serving_error(status, reason, headers, body)
        return headers, body

    def _request(self, route: str, payload: Optional[dict] = None,
                 method: Optional[str] = None) -> dict:
        def _once():
            data = (json.dumps(payload).encode()
                    if payload is not None else None)
            _, body = self._fetch(
                method or ("GET" if data is None else "POST"), route,
                data, "application/json")
            return json.loads(body.decode())

        return self._call_guarded(lambda: self.retry.call(_once))

    @staticmethod
    def _serving_error(status: int, reason: str, headers,
                       raw: bytes) -> ServingError:
        """The server's JSON error payload as a ServingError."""
        try:
            body = json.loads(raw.decode())
        except Exception:   # noqa: BLE001 - body may be anything
            body = {}
        if not isinstance(body, dict):
            body = {}
        retry_after = headers.get("Retry-After") if headers else None
        return ServingError(
            status=status,
            message=body.get("error", f"HTTP Error {status}: {reason}"),
            error_class=body.get("error_class", ""),
            body=body,
            retry_after_s=float(retry_after) if retry_after else None)

    def _post(self, route: str, payload: dict) -> dict:
        return self._request(route, payload)

    def _request_bytes(self, route: str, data: bytes,
                       content_type: str) -> dict:
        """POST raw bytes; parse the response by ITS content type
        (npz responses come back with `outputs` as host numpy arrays,
        JSON responses as JSON). Same retry + breaker discipline as
        `_request`."""
        def _once():
            headers, body = self._fetch("POST", route, data, content_type)
            if NPZ_CONTENT_TYPE in (headers.get("Content-Type") or ""):
                return decode_npz_response(body)
            return json.loads(body.decode())

        return self._call_guarded(lambda: self.retry.call(_once))

    @staticmethod
    def _old_server_error(e: ServingError) -> bool:
        """True when an npz POST bounced off a server that predates
        the binary wire: its JSON-only route 400s with 'malformed JSON
        body' (binary bytes that happen to decode) or 500s on the
        UnicodeDecodeError. Genuine application errors (bad shapes,
        missing labels, quota, overload) pass through untouched."""
        if e.status == 415:
            return True
        if e.status == 400 and "malformed JSON body" in (str(e) or ""):
            return True
        return e.status == 500 and e.error_class == "UnicodeDecodeError"

    def predict(self, inputs, decode_top: int = 0,
                model: Optional[str] = None,
                tenant: Optional[str] = None) -> dict:
        """POST /predict, or /v1/models/<model>/predict when `model`
        is given. `inputs` may be an array or (for multi-input graphs)
        a dict of named input streams; `tenant` rides in the body for
        the server's admission layer.

        Wire format: binary npz by default — inputs ship as raw array
        bytes and `outputs` come back as host numpy array(s), never
        round-tripped through JSON nested lists. The first response
        proving the server predates the format flips this client to
        the legacy JSON wire permanently (`wire="json"` forces it;
        JSON responses keep the historical list-shaped outputs)."""
        route = (f"/v1/models/{model}/predict" if model is not None
                 else "/predict")
        meta = {}
        if decode_top:
            meta["decode_top"] = decode_top
        if tenant is not None:
            meta["tenant"] = tenant
        if self._npz_ok:
            try:
                return self._request_bytes(
                    route, encode_npz_request(inputs, meta),
                    NPZ_CONTENT_TYPE)
            except ServingError as e:
                if self.wire == "npz" or not self._old_server_error(e):
                    raise
                self._npz_ok = False   # old server: JSON from here on
        if isinstance(inputs, dict):
            payload = {"inputs": {
                k: np.asarray(v).tolist()
                for k, v in inputs.items()}}
        else:
            payload = {
                "inputs": np.asarray(inputs).tolist()}
        payload.update(meta)
        return self._request(route, payload)

    def generate(self, prompt, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 resume_tokens=None,
                 max_resumes: int = 3,
                 request_id: Optional[str] = None,
                 trace: Optional[str] = None) -> dict:
        """POST /v1/models/<model>/generate — continuous-batched
        autoregressive generation. Returns {"tokens": [int, ...],
        "finish_reason": "eos"|"length"|"deadline", ...}; the token
        list length varies per request (eos can cut it short). Binary
        npz wire by default: the prompt ships as a raw int array and
        the variable-length output comes back as one — same
        fall-back-to-JSON discipline as `predict`. Slot exhaustion
        surfaces as a 429 ServingError with Retry-After.

        Generation durability: a replica that retires mid-generation
        answers 503 with the tokens decoded so far and a `resumable`
        marker; this client re-issues the request as a CONTINUATION
        carrying those tokens (`resume_tokens` on the wire, up to
        `max_resumes` times), so the final stream is byte-identical to
        an uninterrupted call — greedy decode replay, not re-sampling.
        `deadline_s` rides to the engine's deadline sweep; an expired
        deadline comes back as HTTP 504 whose partial stream is
        returned here as a normal dict with finish_reason="deadline".

        `request_id` is the idempotency key (client-generated here
        when not supplied): it is STABLE across every resume retry of
        this logical call, so a retry after an ambiguous disconnect —
        the response lost, the server's fate unknown — joins the
        original journaled stream instead of double-executing."""
        resume = ([int(t) for t in np.asarray(resume_tokens).ravel()]
                  if resume_tokens is not None else [])
        rid = str(request_id) if request_id else uuid.uuid4().hex
        trace = str(trace) if trace else None
        last: Optional[Exception] = None
        for _ in range(max(0, int(max_resumes)) + 1):
            try:
                return self._generate_once(
                    prompt, max_new_tokens, eos_id=eos_id, model=model,
                    tenant=tenant, timeout_s=timeout_s,
                    deadline_s=deadline_s,
                    resume_tokens=resume or None, request_id=rid,
                    trace=trace)
            except (ServingError, RetriesExhaustedError) as e:
                partial = self._resumable_partial(e)
                if partial is None:
                    raise
                # re-raised on budget exhaustion: the LAST resumable
                # failure still carries its partial body, so an outer
                # router can keep migrating where this client stopped
                last = e
                got = partial.get("tokens") or []
                if len(got) > len(resume):
                    resume = [int(t) for t in got]
                # a server that minted the trace id reports it in the
                # partial body — carry it into the next leg so the
                # continuation joins the same timeline
                if trace is None and partial.get("trace"):
                    trace = str(partial["trace"])
        raise last

    @staticmethod
    def _resumable_partial(e: Exception) -> Optional[dict]:
        """The server's resumable-partial body out of a generate
        failure, or None when the failure carries no continuation
        (connection refused, plain 503, 4xx...)."""
        if isinstance(e, RetriesExhaustedError):
            e = e.cause
        if not isinstance(e, ServingError):
            return None
        body = e.body or {}
        if body.get("resumable") and body.get("tokens") is not None:
            return body
        return None

    def _generate_once(self, prompt, max_new_tokens: int,
                       eos_id: Optional[int], model: Optional[str],
                       tenant: Optional[str],
                       timeout_s: Optional[float],
                       deadline_s: Optional[float],
                       resume_tokens: Optional[list],
                       request_id: Optional[str] = None,
                       trace: Optional[str] = None) -> dict:
        model = model or "default"
        route = f"/v1/models/{model}/generate"
        meta = {"max_new_tokens": int(max_new_tokens)}
        if request_id is not None:
            meta["request_id"] = str(request_id)
        if trace is not None:
            meta["trace"] = str(trace)
        if eos_id is not None:
            meta["eos_id"] = int(eos_id)
        if tenant is not None:
            meta["tenant"] = tenant
        if timeout_s is not None:
            meta["timeout_s"] = float(timeout_s)
        if deadline_s is not None:
            meta["deadline_s"] = float(deadline_s)
        if resume_tokens:
            meta["resume_tokens"] = [int(t) for t in resume_tokens]
        try:
            if self._npz_ok:
                try:
                    resp = self._request_bytes(
                        route,
                        encode_npz_request(
                            np.asarray(prompt, np.int32), meta),
                        NPZ_CONTENT_TYPE)
                    out = resp.pop("outputs", None)
                    if out is not None and "tokens" not in resp:
                        resp["tokens"] = [int(t) for t in
                                          np.asarray(out).ravel()]
                    return resp
                except ServingError as e:
                    if self.wire == "npz" \
                            or not self._old_server_error(e):
                        raise
                    self._npz_ok = False   # old server: JSON now on
            payload = {"prompt": [int(t) for t in
                                  np.asarray(prompt).ravel()]}
            payload.update(meta)
            return self._request(route, payload)
        except ServingError as e:
            if e.status == 504 and e.body.get("tokens") is not None:
                # deadline expired server-side: the 504 body IS the
                # partial result — surface it as one
                return dict(e.body)
            raise

    def status(self, model: Optional[str] = None) -> dict:
        if model is not None:
            return self._request(f"/v1/models/{model}/status")
        return self._request("/status")

    # --------------------------------------------- model lifecycle
    def models(self) -> dict:
        """GET /v1/models — the registry catalog."""
        return self._request("/v1/models")

    def put_version(self, model: str, version: str, path: str,
                    activate: bool = True, model_type: str = "auto",
                    warmup_inputs=None) -> dict:
        """PUT /v1/models/<model>/versions/<version> — load a model
        zip (server-side path) through the integrity-checked
        serializer and optionally hot-swap to it."""
        payload = {"path": path, "activate": activate,
                   "model_type": model_type}
        if warmup_inputs is not None:
            payload["warmup_inputs"] = [list(s) for s in warmup_inputs]
        return self._request(
            f"/v1/models/{model}/versions/{version}", payload,
            method="PUT")

    def swap(self, model: str, version: str) -> dict:
        return self._request(f"/v1/models/{model}/swap",
                             {"version": version})

    def rollback(self, model: str) -> dict:
        return self._request(f"/v1/models/{model}/rollback", {})

    def delete_version(self, model: str, version: str) -> dict:
        return self._request(
            f"/v1/models/{model}/versions/{version}", method="DELETE")

    def delete_model(self, model: str) -> dict:
        return self._request(f"/v1/models/{model}", method="DELETE")

    def metrics(self) -> dict:
        """GET /metrics parsed into {sample_name[{labels}]: value} —
        the test-friendly view of the Prometheus exposition (raw text
        via `metrics_text()`)."""
        return parse_prometheus(self.metrics_text())

    def metrics_text(self) -> str:
        _, body = self._fetch("GET", "/metrics")
        return body.decode()

    def healthz(self) -> bool:
        """True iff the server reports itself live (no retry — a probe
        must see the instantaneous truth)."""
        try:
            self._probe("/healthz")
            return True
        except ServingError as e:
            if e.status == 503:
                return False
            raise

    def readyz(self) -> bool:
        try:
            self._probe("/readyz")
            return True
        except ServingError as e:
            if e.status == 503:
                return False
            raise

    def _probe(self, route: str) -> dict:
        _, body = self._fetch("GET", route)
        return json.loads(body.decode())
