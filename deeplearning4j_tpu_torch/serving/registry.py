"""ModelRegistry: N named models × versions with zero-downtime
hot-swap and one-call rollback (counterpart of
deeplearning4j_tpu/serving/registry.py).

The control-plane core above the ParallelInference data plane. Every
model VERSION owns its own ParallelInference batcher (bucket pool,
pipeline window, warmup state) so versions never share compiled-trace
or staging-buffer state; the registry's job is lifecycle:

  load      `load_version()` restores a model zip through the
            model_serializer/checkpoint_integrity machinery — sha256
            sidecar validation plus structural restore — and REJECTS
            corrupted uploads (CheckpointIntegrityError, counted in
            dl4j_serving_load_rejected_total) before they can touch
            traffic;
  warm      a new version's ParallelInference is constructed (and its
            pow2 buckets pre-traced) BEFORE the active pointer flips,
            so the first post-swap request never pays a compile;
  swap      the flip itself is one pointer write under the entry lock —
            requests lease (version, pi) atomically, so every response
            is computed end-to-end by exactly one version. The old
            version keeps draining its in-flight pipeline window on its
            still-running batcher (state `standby`) and stays warm as
            the rollback target;
  rollback  one call flips active back to the previous version — still
            warm, zero downtime in the other direction;
  retire    versions older than `keep_warm` standbys drain (leases and
            pipeline window to zero) in a background thread and only
            then shut their batcher down.

Lease discipline: `entry.lease()` pins one (version, pi) pair for the
duration of a request. A swap between lease and response is harmless —
the leased version finishes the request and the drain logic waits for
the lease count to hit zero before any shutdown. That is the whole
zero-dropped / zero-mixed-version guarantee, and the chaos test in
tests/test_torch_serving_registry.py hammers it mid-soak.

Device: restored versions load onto the registry's `device` (None means
cuda, and raises without a GPU). A model zip carries no compute dtype,
so a restored version computes in f32 whatever the version it replaces
computed in — as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import zipfile
from contextlib import contextmanager
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.resilience.errors import (
    CheckpointIntegrityError,
    ModelNotFoundError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.util import model_serializer

logger = logging.getLogger("deeplearning4j_tpu_torch")

# version lifecycle states
ACTIVE, STANDBY, RETIRING, RETIRED = ("active", "standby",
                                      "retiring", "retired")


class _Version:
    """One servable version: the net, its own batcher, lease count."""

    __slots__ = ("version", "net", "pi", "owns_pi", "state",
                 "source_path", "loaded_at", "leases", "served")

    def __init__(self, version: str, net, pi: ParallelInference,
                 owns_pi: bool, source_path: Optional[str]):
        self.version = version
        self.net = net
        self.pi = pi
        self.owns_pi = owns_pi
        self.state = STANDBY
        self.source_path = source_path
        self.loaded_at = time.time()
        self.leases = 0
        self.served = 0

    def facts(self) -> dict:
        return {"state": self.state, "leases": self.leases,
                "served": self.served, "source_path": self.source_path,
                "loaded_at": self.loaded_at,
                "healthy": self.pi.healthy}


class ModelEntry:
    """One named model: its version set and the active pointer."""

    def __init__(self, name: str, registry: "ModelRegistry"):
        self.name = name
        self._registry = registry
        self._lock = threading.RLock()
        self.versions: Dict[str, _Version] = {}
        self.active: Optional[str] = None
        self.previous: Optional[str] = None
        self.warmup_inputs = None   # remembered for later uploads
        self._seq = 0

    # ------------------------------------------------------------ leases
    @contextmanager
    def lease(self):
        """Pin the ACTIVE (version, pi) pair for one request. The pin
        is what makes a concurrent swap invisible: this request
        finishes on the version it started on, and that version cannot
        shut down while the lease is held."""
        with self._lock:
            if self.active is None:
                raise ModelNotFoundError(
                    f"model {self.name!r} has no active version")
            v = self.versions[self.active]
            v.leases += 1
        try:
            yield v.version, v.pi
            with self._lock:
                v.served += 1
        finally:
            with self._lock:
                v.leases -= 1

    # ------------------------------------------------------- lifecycle
    def next_version_name(self) -> str:
        with self._lock:
            self._seq += 1
            name = f"v{self._seq}"
            while name in self.versions:
                self._seq += 1
                name = f"v{self._seq}"
            return name

    def add(self, ver: _Version, activate: bool) -> None:
        with self._lock:
            if ver.version in self.versions:
                old = self.versions[ver.version]
                if old.state in (ACTIVE,):
                    raise ValueError(
                        f"version {ver.version!r} of {self.name!r} is "
                        "active; swap away before replacing it")
                self._registry._retire_async(self.name, old)
            self.versions[ver.version] = ver
        if activate:
            self.activate(ver.version)

    def activate(self, version: str) -> None:
        """The atomic flip. The new version is already constructed and
        warmed by the time this runs; the old active becomes the warm
        `standby` rollback target and keeps draining its in-flight
        window on its own still-running batcher."""
        swapped = False
        with self._lock:
            if version not in self.versions:
                raise ModelNotFoundError(
                    f"model {self.name!r} has no version {version!r}")
            ver = self.versions[version]
            if ver.state in (RETIRING, RETIRED):
                raise ValueError(
                    f"version {version!r} of {self.name!r} is "
                    f"{ver.state}; reload it before activating")
            if self.active == version:
                return
            old = self.active
            if old is not None:
                self.versions[old].state = STANDBY
                swapped = True
            self.active = version
            self.previous = old
            ver.state = ACTIVE
            self._trim_standbys()
        # emission stays outside the registry lock (the
        # obs registry takes its own lock)
        if swapped:
            _obs.count("dl4j_serving_swaps_total",
                       labels={"model": self.name})

    def rollback(self) -> str:
        with self._lock:
            if self.previous is None \
                    or self.previous not in self.versions:
                raise ModelNotFoundError(
                    f"model {self.name!r} has no previous version to "
                    "roll back to")
            target = self.previous
            ver = self.versions[target]
            if ver.state != STANDBY:
                raise ValueError(
                    f"previous version {target!r} of {self.name!r} is "
                    f"{ver.state}, not standby — cannot roll back")
            old = self.active
            self.active = target
            self.previous = old
            ver.state = ACTIVE
            if old is not None:
                self.versions[old].state = STANDBY
        _obs.count("dl4j_serving_rollbacks_total",
                   labels={"model": self.name})
        return target

    def _trim_standbys(self) -> None:
        """Retire standbys beyond keep_warm (called under the lock).
        The previous (rollback target) is always kept."""
        keep = {self.active, self.previous}
        standbys = [v for v in self.versions.values()
                    if v.state == STANDBY and v.version not in keep]
        standbys.sort(key=lambda v: v.loaded_at)
        excess = len(standbys) - max(0, self._registry.keep_warm - 1)
        for v in standbys[:max(0, excess)]:
            self._registry._retire_async(self.name, v)

    def delete_version(self, version: str) -> None:
        with self._lock:
            if version not in self.versions:
                raise ModelNotFoundError(
                    f"model {self.name!r} has no version {version!r}")
            ver = self.versions[version]
            if ver.state == ACTIVE:
                raise ValueError(
                    f"version {version!r} of {self.name!r} is active; "
                    "swap or roll back before deleting it")
            if self.previous == version:
                self.previous = None
            del self.versions[version]
        self._registry._retire_async(self.name, ver)

    def status(self) -> dict:
        with self._lock:
            facts = {
                "name": self.name,
                "active": self.active,
                "previous": self.previous,
                "versions": {v.version: v.facts()
                             for v in self.versions.values()},
            }
            active = (self.versions.get(self.active)
                      if self.active else None)
        if active is not None:
            facts["pipeline"] = active.pi.stats()
            facts["trace"] = active.pi.trace_stats()
            facts["queue_depth"] = active.pi.queue_depth()
            facts["healthy"] = active.pi.healthy
        return facts


class ModelRegistry:
    """The model catalog a multi-model ModelServer serves from.

    `pi_kwargs` (batch_limit, queue_limit, pipeline_depth, warmup,
    max_wait_ms, adaptive_wait, completion_streams, tracer, ...) are
    applied to every version's ParallelInference this registry
    constructs; pre-built ParallelInference front-ends register as-is
    and are never shut down by the registry (caller owns them).
    `device` is where `load_version` restores model zips: None means
    cuda (raises without a GPU), "cpu" as the CPU tests pass."""

    def __init__(self, keep_warm: int = 1,
                 drain_timeout_s: float = 30.0, device=None,
                 **pi_kwargs):
        self.device = resolve_device(device)
        self.keep_warm = max(0, int(keep_warm))
        self.drain_timeout_s = float(drain_timeout_s)
        self.pi_kwargs = dict(pi_kwargs)
        self._lock = threading.RLock()
        self._entries: Dict[str, ModelEntry] = {}
        self._default: Optional[str] = None
        self._drainers: List[threading.Thread] = []
        self._closed = False

    # -------------------------------------------------------- catalog
    def _check_open(self) -> None:
        """A lookup racing `shutdown` is a 503 (ShutdownError: retry
        elsewhere), never a 404 — the JAX package answers 404 there,
        which a ReplicaRouter surfaces instead of failing over."""
        if self._closed:
            raise ShutdownError("registry is shut down")

    def entry(self, name: str) -> ModelEntry:
        with self._lock:
            self._check_open()
            try:
                return self._entries[name]
            except KeyError:
                raise ModelNotFoundError(
                    f"no model named {name!r} "
                    f"(have: {sorted(self._entries)})") from None

    def default_entry(self) -> ModelEntry:
        with self._lock:
            self._check_open()
            if self._default is None:
                raise ModelNotFoundError("registry is empty")
            return self._entries[self._default]

    @property
    def default_model(self) -> Optional[str]:
        return self._default

    def model_names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def _entry_or_create(self, name: str) -> ModelEntry:
        created_n = None
        with self._lock:
            self._check_open()
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = ModelEntry(name, self)
                if self._default is None:
                    self._default = name
                created_n = len(self._entries)
        if created_n is not None:
            _obs.set_gauge("dl4j_serving_active_models", created_n)
        return e

    # ------------------------------------------------------- register
    def register(self, name: str, net_or_pi, version: Optional[str] = None,
                 activate: bool = True, warmup_inputs=None,
                 source_path: Optional[str] = None) -> str:
        """Register an in-memory net (a ParallelInference is built and
        warmed around it) or a pre-built ParallelInference (registered
        as-is, caller keeps ownership). Returns the version id."""
        e = self._entry_or_create(name)
        if warmup_inputs is not None:
            e.warmup_inputs = warmup_inputs
        version = version or e.next_version_name()
        if isinstance(net_or_pi, ParallelInference):
            pi, net, owns = net_or_pi, net_or_pi.net, False
        else:
            net = net_or_pi
            pi = self._make_pi(net, e.warmup_inputs)
            owns = True
        e.add(_Version(version, net, pi, owns, source_path), activate)
        return version

    def load_version(self, name: str, version: Optional[str],
                     path: str, model_type: str = "auto",
                     activate: bool = True, warmup_inputs=None) -> str:
        """Restore a model zip through the integrity-checked
        serializer path and register it. A corrupted or torn upload is
        rejected (CheckpointIntegrityError) before the version exists —
        it can never take traffic. The model ENTRY is created first —
        a rejected upload leaves the name visible with no servable
        versions, so operators see the attempt in /status."""
        self._entry_or_create(name)
        try:
            net = self._restore(path, model_type)
        except CheckpointIntegrityError:
            _obs.count("dl4j_serving_load_rejected_total",
                       labels={"model": name})
            raise
        except Exception as exc:   # noqa: BLE001 - structural rejects
            _obs.count("dl4j_serving_load_rejected_total",
                       labels={"model": name})
            raise CheckpointIntegrityError(
                f"model upload {path!r} failed structural restore: "
                f"{exc}") from exc
        return self.register(name, net, version=version,
                             activate=activate,
                             warmup_inputs=warmup_inputs,
                             source_path=path)

    def _restore(self, path: str, model_type: str):
        if model_type == "auto":
            if not model_serializer.verify_model(path):
                raise CheckpointIntegrityError(
                    f"{path} failed sha256 validation "
                    "(truncated or torn upload?)")
            try:
                with zipfile.ZipFile(path, "r") as z:
                    names = set(z.namelist())
                    meta = (json.loads(
                        z.read(model_serializer.META_ENTRY).decode())
                        if model_serializer.META_ENTRY in names else {})
            except (zipfile.BadZipFile, OSError, ValueError) as exc:
                raise CheckpointIntegrityError(
                    f"{path} is not a readable model zip: {exc}") \
                    from exc
            model_type = meta.get("model_type", "MultiLayerNetwork")
        if model_type in ("ComputationGraph", "graph"):
            return model_serializer.restore_computation_graph(
                path, device=self.device)
        return model_serializer.restore_multi_layer_network(
            path, device=self.device)

    def _make_pi(self, net, warmup_inputs) -> ParallelInference:
        kwargs = dict(self.pi_kwargs)
        if warmup_inputs is not None:
            kwargs.setdefault("warmup_inputs", warmup_inputs)
        # construction IS the warm phase: buckets pre-trace here,
        # before the version can be activated
        return ParallelInference(net, **kwargs)

    # ------------------------------------------------------ lifecycle
    def swap(self, name: str, version: str) -> None:
        self.entry(name).activate(version)

    def rollback(self, name: str) -> str:
        return self.entry(name).rollback()

    def delete_version(self, name: str, version: str) -> None:
        self.entry(name).delete_version(version)

    def remove(self, name: str) -> None:
        """Remove a model entirely; every version drains then shuts
        down in the background."""
        with self._lock:
            e = self.entry(name)
            del self._entries[name]
            if self._default == name:
                self._default = next(iter(sorted(self._entries)), None)
            remaining = len(self._entries)
        _obs.set_gauge("dl4j_serving_active_models", remaining)
        with e._lock:
            vers = list(e.versions.values())
            e.versions.clear()
            e.active = e.previous = None
        for v in vers:
            self._retire_async(name, v)

    def _retire_async(self, name: str, ver: _Version) -> None:
        """Drain-then-shutdown in a daemon thread: wait for leases and
        the in-flight pipeline window to clear (bounded by
        drain_timeout_s), then stop the batcher. Never blocks a swap."""
        ver.state = RETIRING

        def _drain():
            deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < deadline:
                stats = ver.pi.stats()
                if (ver.leases == 0 and stats["queue_depth"] == 0
                        and stats["in_flight"] == 0):
                    break
                time.sleep(0.01)
            else:
                logger.warning(
                    "model %s version %s drain timed out after %.1fs "
                    "(leases=%d); shutting down anyway", name,
                    ver.version, self.drain_timeout_s, ver.leases)
            if ver.owns_pi:
                ver.pi.shutdown()
            ver.state = RETIRED

        t = threading.Thread(
            target=_drain, daemon=True,
            name=f"ModelRegistry-drain-{name}-{ver.version}")
        t.start()
        with self._lock:
            self._drainers = [d for d in self._drainers
                              if d.is_alive()] + [t]

    # --------------------------------------------------------- status
    def models_status(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
            default = self._default
        return {"default": default,
                "models": {e.name: e.status() for e in entries}}

    def healthy(self) -> bool:
        """True while every model's ACTIVE version is healthy. Standby
        and retiring versions don't gate liveness — and neither does an
        entry with no active version yet (a first upload still loading,
        or one whose only upload was rejected): flipping /healthz 503
        mid-PUT would get the pod killed by its liveness probe."""
        with self._lock:
            entries = list(self._entries.values())
        saw_active = False
        for e in entries:
            with e._lock:
                v = e.versions.get(e.active) if e.active else None
            if v is None:
                continue
            saw_active = True
            if not v.pi.healthy:
                return False
        return saw_active

    def shutdown(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            entries = list(self._entries.values())
            self._entries.clear()
            self._default = None
            drainers = list(self._drainers)
        for e in entries:
            with e._lock:
                vers = list(e.versions.values())
            for v in vers:
                if v.owns_pi:
                    v.pi.shutdown()
                v.state = RETIRED
        for t in drainers:
            t.join(timeout=timeout_s)
