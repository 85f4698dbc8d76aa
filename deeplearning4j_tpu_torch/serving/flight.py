"""Crash flight recorder: the last-N-steps story the journal can't tell
(a copy of deeplearning4j_tpu/serving/flight.py; host-only Python).

The write-ahead journal is request-level (admitted/progress/done) —
enough to recover work, useless for answering "what was the engine
DOING in the seconds before it quarantined a slot / tripped the
watchdog / restarted." A `FlightRecorder` is a bounded in-memory ring
of cheap step-event tuples (slot joins/leaves, prefill-chunk
dispatches, step verdicts, evictions, quarantines, restarts) appended
by the decode engine as it works; recording costs one tuple append, so
it stays on even in production.

On a crash-adjacent event (quarantine, watchdog restart, engine
restart) — or on `SIGUSR2` for a live postmortem — `dump()` writes the
ring ATOMICALLY (tmp file + `os.replace`) as a JSON document next to
whatever `dump_dir` the engine was given, so a half-written dump can
never masquerade as a whole one. Dump paths are tracked module-wide
and `reap_stray_flight_dumps()` removes them (the port's decode tests
call it on teardown, mirroring the journal reaper).

The SIGUSR2 handler only serializes host-side tuples to a file: it
makes no CUDA call, so a signal landing while the loop thread waits
inside the runtime cannot re-enter it.

`install_signal_dump()` is opt-in (never installed implicitly): it
hooks SIGUSR2 to dump every live recorder, chaining any previous
handler.
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import List, Optional

from deeplearning4j_tpu_torch.observability import metrics as _obs

# every recorder constructed in this process (weak — dead recorders
# drop out); the SIGUSR2 handler dumps whatever is still live
_LIVE_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
# dump files written by any recorder — reaped by the decode tests so
# an interrupted drill leaks no postmortem litter into later runs
_FLIGHT_DUMPS: List[str] = []
_DUMPS_LOCK = threading.Lock()


def reap_stray_flight_dumps() -> None:
    """Remove every flight-recorder dump file written in this process.
    Teardown backstop for chaos tests — idempotent, touches nothing if
    no recorder ever dumped."""
    with _DUMPS_LOCK:
        paths, _FLIGHT_DUMPS[:] = list(_FLIGHT_DUMPS), []
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def install_signal_dump(signum: int = getattr(signal, "SIGUSR2", 0)):
    """Hook `signum` (default SIGUSR2) to dump every live recorder —
    the kill -USR2 live-postmortem path. Chains the previous handler;
    returns it so callers/tests can restore. Main thread only (signal
    module requirement); returns None when unavailable."""
    if not signum:
        return None

    prev = signal.getsignal(signum)

    def _dump_all(sig, frame):
        for rec in list(_LIVE_RECORDERS):
            rec.dump("sigusr2")
        if callable(prev):
            prev(sig, frame)

    signal.signal(signum, _dump_all)
    return prev


class FlightRecorder:
    """Bounded ring of recent engine step events + atomic crash dump.

    `note()` is called under the engine's step lock, so it must stay
    O(1) and allocation-light: one tuple append into a deque(maxlen).
    `dump()` does file I/O and is only ever called OUTSIDE the step
    lock (the engine collects a dump *reason* under the lock and dumps
    after releasing it)."""

    def __init__(self, capacity: int = 512,
                 dump_dir: Optional[str] = None,
                 name: str = "decoder"):
        self.capacity = max(16, int(capacity))
        self.name = str(name)
        self.dump_dir = dump_dir or tempfile.gettempdir()
        self._ring: deque = deque(maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._dumps = 0
        self._last_dump: Optional[str] = None
        self._last_reason: Optional[str] = None
        self._seq = 0
        _LIVE_RECORDERS.add(self)

    # ---------------------------------------------------------- record
    def note(self, kind: str, step: int, **fields) -> None:
        """One ring entry: (t_rel_s, step, kind, fields-or-None)."""
        self._ring.append((time.perf_counter() - self._t0, int(step),
                           kind, fields or None))

    # ----------------------------------------------------------- reads
    def events(self) -> List[dict]:
        out = []
        for t, step, kind, fields in list(self._ring):
            ev = {"t_s": round(t, 6), "step": step, "kind": kind}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"events": len(self._ring),
                    "capacity": self.capacity,
                    "dumps": self._dumps,
                    "last_dump": self._last_dump,
                    "last_reason": self._last_reason}

    # ------------------------------------------------------------ dump
    def dump(self, reason: str) -> Optional[str]:
        """Atomically write the ring as JSON; returns the dump path, or
        None when the write failed (a full disk must not cascade into
        the decode loop). Never called under the step lock."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        doc = {"name": self.name, "reason": str(reason),
               "pid": os.getpid(), "wall_time_s": time.time(),
               "uptime_s": round(time.perf_counter() - self._t0, 6),
               "events": self.events()}
        path = os.path.join(
            self.dump_dir,
            f"flight-{self.name}-{os.getpid()}-{seq:03d}.json")
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dump_dir,
                                       prefix=".flight-", suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            return None
        with _DUMPS_LOCK:
            _FLIGHT_DUMPS.append(path)
        with self._lock:
            self._dumps += 1
            self._last_dump = path
            self._last_reason = str(reason)
        _obs.count("dl4j_decode_flight_dumps_total",
                   labels={"reason": str(reason)})
        return path


def load_dump(path: str) -> dict:
    """Read a dump back (inspection workflow: `python -m json.tool`
    works too — this helper just keeps tests honest about the shape)."""
    with open(path) as f:
        return json.load(f)
