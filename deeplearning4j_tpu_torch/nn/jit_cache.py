"""JitCache: a program cache that counts builds AND explains them
(counterpart of deeplearning4j_tpu/nn/jit_cache.py).

The JAX package compiles one XLA program per (function, input
signature); an unexpected shape reaching a cached `jax.jit` function
silently retraces and recompiles. The port's programs run eagerly, so
here a "trace" is a program key's first call with an input signature:
the first call of a stored program (which on the card also loads its
kernels and warms the caching allocator for its shapes), and again
whenever a call brings shapes the key has not seen — where the JAX
program would retrace. Each program body calls `record_trace(key)` on
such a call only, so "did this load cause a (re)build?" stays an
asserted property with the JAX package's API.

Forensics: `__setitem__` wraps every stored callable in a thin timing
shim. A call during which the trace counter advanced was a build; the
shim records a compile event — the concrete shape/dtype signature of
the args, the call's wall duration, a wall-clock timestamp, and the
program's cost digest when one was registered (`register_cost`) — into
a bounded ring, and bumps `dl4j_jit_compiles_total`. Calls past the
first pay two perf_counter reads and one int compare. A program built
outside the dict — StepProgram's captured k-step groups — records its
event through `record_compile`.

    cache = JitCache()
    first = [True]
    def f(x):
        if first[0]:
            first[0] = False
            cache.record_trace("predict")
        return x * 2
    cache["predict"] = f
    ...
    cache.compile_events()   # [{key, signature, duration_s, ...}]
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability import metrics as _obs

COMPILE_RING = 16


def policy_name(compute_dtype) -> str:
    """Canonical short name of a net's compute-precision policy:
    'bf16'/'f16' for mixed precision, 'f32' when no compute dtype is
    set — a declared fact at registration time."""
    if compute_dtype is None:
        return "f32"
    import numpy as np

    name = getattr(compute_dtype, "name", None)
    if name is None:
        text = str(compute_dtype)
        name = text[len("torch."):] if text.startswith("torch.") else None
    if name is None:
        try:
            name = np.dtype(compute_dtype).name
        except TypeError:
            name = getattr(compute_dtype, "__name__", str(compute_dtype))
    return {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
            "float64": "f64"}.get(name, name)


def _describe(a, depth: int = 0) -> str:
    """Compact signature of one argument: tensors and arrays as
    dtype[shape], containers abbreviated to their first few entries."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        dims = ",".join(str(int(d)) for d in shape)
        name = str(dtype)
        if name.startswith("torch."):
            name = name[len("torch."):]
        return f"{name}[{dims}]"
    if depth >= 3:
        return type(a).__name__
    if isinstance(a, (list, tuple)):
        head = ",".join(_describe(v, depth + 1) for v in a[:3])
        tail = f",…+{len(a) - 3}" if len(a) > 3 else ""
        return f"[{head}{tail}]"
    if isinstance(a, dict):
        head = ",".join(f"{k}:{_describe(v, depth + 1)}"
                        for k, v in list(a.items())[:3])
        tail = f",…+{len(a) - 3}" if len(a) > 3 else ""
        return "{" + head + tail + "}"
    if a is None:
        return "None"
    return type(a).__name__


def describe_signature(args, kwargs=None) -> str:
    parts = [_describe(a) for a in args]
    for k, v in (kwargs or {}).items():
        parts.append(f"{k}={_describe(v)}")
    return "(" + ", ".join(parts) + ")"


class JitCache(dict):
    """Dict of programs + per-key build counters + a compile-event
    forensics ring.

    Counters survive `clear()` of the program dict deliberately: a
    cleared cache that rebuilds is exactly the event the counters exist
    to expose."""

    def __init__(self, *args, compile_ring: int = COMPILE_RING,
                 **kwargs):
        super().__init__()
        self._trace_lock = threading.Lock()
        self._trace_counts: Dict[str, int] = {}
        # lock-free fast-path read for the call shim (GIL-atomic int);
        # writes stay under the lock
        self._total = 0
        self._compiles = 0
        self._compile_events: deque = deque(
            maxlen=max(1, int(compile_ring)))
        self._costs: Dict[str, dict] = {}
        self._policies: Dict[str, str] = {}
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def record_trace(self, key: str) -> None:
        """Call from a program body on its first call: runs once per
        build, never on later calls."""
        with self._trace_lock:
            self._trace_counts[key] = self._trace_counts.get(key, 0) + 1
            self._total += 1

    def trace_counts(self) -> Dict[str, int]:
        with self._trace_lock:
            return dict(self._trace_counts)

    def total_traces(self) -> int:
        with self._trace_lock:
            return sum(self._trace_counts.values())

    # ------------------------------------------------------- forensics
    def __setitem__(self, key, fn):
        if callable(fn) and not getattr(fn, "_jit_cache_shim", False):
            fn = self._instrument(key, fn)
        super().__setitem__(key, fn)

    def _instrument(self, key, fn):
        """Timing shim: a call during which the trace counter advanced
        was a build — record the forensics event."""
        def call(*args, **kwargs):
            before = self._total
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self._total != before:
                self._note_compile(key, self._total - before,
                                   time.perf_counter() - t0,
                                   args, kwargs)
            return out

        call._jit_cache_shim = True
        call.__wrapped__ = fn
        return call

    def _note_compile(self, key, traces: int, duration_s: float,
                      args, kwargs) -> None:
        try:
            signature = describe_signature(args, kwargs)
        except Exception:   # noqa: BLE001 - forensics is best-effort
            signature = "<unavailable>"
        self.record_compile(key, signature, duration_s, traces=traces)

    def record_compile(self, key, signature: str, duration_s: float,
                       traces: int = 1, **extra) -> None:
        """Record one build of a program that does not live in the
        dict (engine/step_program.py's CUDA-graph captures): a compile
        event with `extra`'s fields, and `dl4j_jit_compiles_total`.
        The trace counters are left alone."""
        event = {
            "key": str(key),
            "signature": signature,
            "duration_s": round(duration_s, 6),
            "traces": int(traces),
            "wall_time": time.time(),
            "cost_digest": self._cost_digest(key),
            **extra,
        }
        with self._trace_lock:
            self._compiles += int(traces)
            self._compile_events.append(event)
        _obs.count("dl4j_jit_compiles_total", n=int(traces))

    def _cost_digest(self, key) -> Optional[dict]:
        cost = self._costs.get(str(key))
        if cost is None:
            return None
        return {"flops": cost.get("flops"),
                "bytes_accessed": cost.get("bytes_accessed")}

    def register_cost(self, key, cost: dict) -> None:
        """Attach a cost-model entry ({flops, bytes_accessed, ...}) to
        `key`: future compile events for the key carry the digest, and
        ring events already recorded without one are backfilled."""
        with self._trace_lock:
            self._costs[str(key)] = dict(cost)
            digest = {"flops": cost.get("flops"),
                      "bytes_accessed": cost.get("bytes_accessed")}
            for ev in self._compile_events:
                if ev["key"] == str(key) and ev["cost_digest"] is None:
                    ev["cost_digest"] = dict(digest)

    def costs(self) -> Dict[str, dict]:
        with self._trace_lock:
            return {k: dict(v) for k, v in self._costs.items()}

    def register_policy(self, key, policy: str) -> None:
        """Declare the compute-precision policy of the program stored
        at `key` ('bf16'/'f16'/'f32' — see `policy_name`)."""
        with self._trace_lock:
            self._policies[str(key)] = str(policy)

    def policy(self, key) -> Optional[str]:
        with self._trace_lock:
            return self._policies.get(str(key))

    def policies(self) -> Dict[str, str]:
        with self._trace_lock:
            return dict(self._policies)

    def compile_events(self) -> List[dict]:
        """Snapshot of the recent-compiles ring, oldest first."""
        with self._trace_lock:
            return [dict(ev) for ev in self._compile_events]

    def compiles_total(self) -> int:
        with self._trace_lock:
            return self._compiles
