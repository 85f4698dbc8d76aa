"""Write-ahead generation journal: durable serving state on disk (a copy
of deeplearning4j_tpu/serving/journal.py; host-only Python, the same
record framing and segment names, so a journal written by either
package recovers in the other).

The decode engine's
replay discipline (re-prefill of the ORIGINAL prompt + forced replay
of the recorded tokens is bitwise-identical — serving/continuous.py)
means the minimal replayable state of ANY generation is just
`(prompt, params, tokens-so-far)`. The journal persists exactly that,
write-ahead:

  admitted{id, tenant, prompt, params, deadline}
          appended BEFORE the request becomes visible to the step
          loop — the WAL ordering that makes recovery complete
  progress{id, start, tokens}
          absolute-positioned token deltas from the step loop.
          Idempotent by construction: replaying a progress record
          twice lands the same tokens at the same positions
  done{id, finish_reason}
          terminal states a restart must NOT resurrect (eos / length /
          deadline / cancelled / poisoned / shed / unrecoverable).
          Crash-shaped finishes (ShutdownError on engine stop,
          watchdog restart exhaustion) are deliberately NOT journaled:
          those streams stay live on disk, which is exactly what makes
          them recoverable after a cold restart.

Record framing (torn-tail safety): every record is
`<u32 len><sha256(payload)><payload json>`. Appends go to the head
segment and are group-fsync'd on a configurable interval / byte
threshold; a crash mid-append leaves a torn tail that recovery
TRUNCATES back to the last whole record — the checkpoint_integrity
newest-valid discipline applied to a log instead of a snapshot.

Segments (`seg-%08d.wal`) rotate at `segment_bytes`; rotation runs
compaction: every LIVE request is consolidated (admitted + one
progress record at its current state) into a fresh segment published
atomically via `checkpoint_integrity.atomic_writer`, a new empty head
opens AFTER it, and every older segment is deleted. Idempotent replay
makes a kill at ANY point of compaction safe — old segments and the
consolidated one replay to the same live set, and recovery scans
whatever segments survive, oldest to newest.

`frame_record` / `read_records` / `write_records` are the shared
framing (the JAX package's FleetController persists its state through
the same helpers).

Chaos points (resilience/faults.py):
  journal.write_torn      fired with the head segment path right after
                          an append lands — a `truncate` spec mauls
                          the tail, the torn-write drill
  journal.fsync_fail      fired just before the group os.fsync —
                          `raise` is consumed by keeping the unsynced
                          bytes pending (the next flush retries);
                          durability degrades, serving continues
  journal.recover_corrupt fired once per replayed record during the
                          recovery scan — `raise` declares THAT record
                          corrupt: treated as a torn tail, the segment
                          truncated to the records before it
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import weakref
from hashlib import sha256
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.checkpoint_integrity import (
    atomic_writer,
)
from deeplearning4j_tpu_torch.resilience.errors import FaultInjectedError
from deeplearning4j_tpu_torch.resilience.faults import fire as _fire

_LEN = struct.Struct("<I")
_DIGEST = 32                       # sha256 digest bytes per record
SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".wal"

# every journal constructed in this process (weak — dead journals drop
# out); the decode tests close whatever a failed durability test left
# open so no WAL file handle leaks into later tier-1 tests
_LIVE_JOURNALS: "weakref.WeakSet[GenerationJournal]" = weakref.WeakSet()
# mkdtemp dirs handed out by `ephemeral_journal_dir` — reaped with the
# journals so an interrupted bench/test run leaks no /tmp litter
_EPHEMERAL_DIRS: List[str] = []


def reap_stray_journals() -> None:
    """Close every journal still open and remove tracked ephemeral
    dirs. Teardown backstop for chaos tests — idempotent, touches
    nothing if every journal was closed properly."""
    for j in list(_LIVE_JOURNALS):
        j.close()
    while _EPHEMERAL_DIRS:
        shutil.rmtree(_EPHEMERAL_DIRS.pop(), ignore_errors=True)


def ephemeral_journal_dir(prefix: str = "dl4j-journal-") -> str:
    """A mkdtemp journal dir tracked for teardown (bench/drill use —
    tests prefer tmp_path): `reap_stray_journals` removes it."""
    import tempfile

    d = tempfile.mkdtemp(prefix=prefix)
    _EPHEMERAL_DIRS.append(d)
    return d


# ------------------------------------------------------- record framing
def frame_record(rec: dict) -> bytes:
    """One framed record: `<u32 len><sha256(payload)><payload>`. The
    payload is canonical JSON (sorted keys, no whitespace), so framing
    the same dict twice yields identical bytes — recovery relies on
    this to recompute valid-prefix lengths."""
    payload = json.dumps(rec, sort_keys=True,
                         separators=(",", ":")).encode()
    return _LEN.pack(len(payload)) + sha256(payload).digest() + payload


def read_records(path: str) -> Tuple[List[dict], int, int]:
    """Parse the longest valid record prefix of `path`: returns
    (records, valid_bytes, file_bytes). valid_bytes < file_bytes means
    a torn tail (a crash mid-append) — everything past the last whole
    record is ignored, and the caller may truncate it away."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return [], 0, 0
    records: List[dict] = []
    off, n = 0, len(blob)
    while off + _LEN.size + _DIGEST <= n:
        (plen,) = _LEN.unpack_from(blob, off)
        start = off + _LEN.size + _DIGEST
        end = start + plen
        if end > n:
            break
        if sha256(blob[start:end]).digest() \
                != blob[off + _LEN.size:start]:
            break
        try:
            rec = json.loads(blob[start:end].decode())
        except (ValueError, UnicodeDecodeError):
            break
        if not isinstance(rec, dict):
            break
        records.append(rec)
        off = end
    return records, off, n


def write_records(path: str, records: List[dict]) -> None:
    """Atomically publish `records` as one framed file (write tmp,
    fsync, rename — checkpoint_integrity.atomic_writer): readers see
    the old file or the new one, never a half-written hybrid. Shared
    by journal compaction and FleetController state persistence."""
    blob = b"".join(frame_record(r) for r in records)
    with atomic_writer(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(blob)


class GenerationJournal:
    """Per-replica write-ahead generation journal.

    Thread-safe: bookkeeping AND file appends serialize under one io
    lock (the lock's whole job is the blocking resource, the
    concurrency lint's file-lock exemption). Construction recovers:
    every segment is scanned oldest to newest, each record replayed
    idempotently, torn tails truncated in place; `live()` then holds
    every request a crash interrupted, ready for the engine's
    resume_tokens replay path.

    `fsync_interval_s=0` fsyncs every append (strict durability);
    otherwise appends buffer until the interval elapses or
    `fsync_bytes` of unsynced records accumulate — group commit. The
    window bounds what a POWER loss could lose to the last interval;
    a plain process kill loses nothing (appends are flushed to the OS
    on every write), and recovery replay regenerates trailing tokens
    bitwise anyway."""

    def __init__(self, directory, fsync_interval_s: float = 0.05,
                 fsync_bytes: int = 64 * 1024,
                 segment_bytes: int = 1 << 20,
                 clock=time.monotonic):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fsync_interval_s = float(fsync_interval_s)
        self.fsync_bytes = int(fsync_bytes)
        self.segment_bytes = int(segment_bytes)
        self._clock = clock
        self._io_lock = threading.Lock()
        # rid -> {prompt, max_new_tokens, eos_id, tenant, deadline_s,
        #         tokens, done, finish_reason}
        self._requests: Dict[str, dict] = {}
        self._live_count = 0       # maintained by _replay, O(1) stats
        self._records = 0
        self._fsyncs = 0
        self._fsync_failures = 0
        self._torn_tails = 0
        self._compactions = 0
        self._bytes = 0            # framed bytes across segments
        self._unsynced = 0
        self._last_sync = self._clock()
        self._head_f = None
        self._head_index = 0
        self._head_pathname = self._seg_path(0)
        self._head_bytes = 0
        self._closed = False
        # deferred metric deltas: counted under the io lock, emitted
        # outside it by _emit (the repo-wide emission discipline)
        self._pend_records = 0
        self._pend_fsyncs = 0
        self._pend_compactions = 0
        torn = self._recover()
        self._open_head()
        _LIVE_JOURNALS.add(self)
        if torn:
            self._torn_tails += torn
            _obs.count("dl4j_journal_torn_tails_total", n=torn)
        self._emit()

    # ---------------------------------------------------------- segments
    def _segments(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        segs = sorted(n for n in names
                      if n.startswith(SEGMENT_PREFIX)
                      and n.endswith(SEGMENT_SUFFIX))
        return [os.path.join(self.directory, n) for n in segs]

    def _seg_path(self, index: int) -> str:
        return os.path.join(
            self.directory,
            f"{SEGMENT_PREFIX}{index:08d}{SEGMENT_SUFFIX}")

    @staticmethod
    def _seg_index(path: str) -> int:
        name = os.path.basename(path)
        return int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])

    def _head_path(self) -> str:
        return self._head_pathname

    def _open_head(self) -> None:
        """Open a FRESH head segment past every existing one — recovery
        never appends to a segment an earlier process wrote, so a torn
        tail can never be buried under new valid records."""
        segs = self._segments()
        if segs:
            self._head_index = self._seg_index(segs[-1]) + 1
        self._head_pathname = self._seg_path(self._head_index)
        self._head_f = open(self._head_pathname, "ab")
        self._head_bytes = 0

    # ---------------------------------------------------------- recovery
    def _recover(self) -> int:
        """Scan all segments oldest to newest, replay each record
        idempotently, truncate torn tails in place. Returns the number
        of torn tails truncated."""
        torn = 0
        total = 0
        for path in self._segments():
            records, valid, size = read_records(path)
            seg_torn = valid < size
            replayed = 0
            for rec in records:
                try:
                    # `journal.recover_corrupt` chaos: a raise verdict
                    # declares THIS record corrupt — it and everything
                    # after it are a torn tail, truncated like one
                    _fire("journal.recover_corrupt")
                except FaultInjectedError:
                    seg_torn = True
                    # canonical framing: re-framing the replayed
                    # prefix recomputes its exact byte length
                    valid = sum(len(frame_record(r))
                                for r in records[:replayed])
                    break
                self._replay(rec)
                replayed += 1
            if seg_torn:
                torn += 1
                try:
                    with open(path, "r+b") as f:
                        f.truncate(valid)
                    size = valid
                except OSError:
                    pass
            total += size
        self._bytes = total
        return torn

    def _replay(self, rec: dict) -> None:
        """Apply one record to the in-memory request map. Idempotent:
        duplicate admits are ignored, progress placement is absolute,
        done is terminal — so recovery may replay overlapping segments
        (mid-compaction kills) and land in the same state."""
        kind = rec.get("kind")
        rid = rec.get("id")
        if not rid:
            return
        if kind == "admitted":
            rid = str(rid)
            if rid not in self._requests:
                self._requests[rid] = {
                    "prompt": [int(t)
                               for t in rec.get("prompt") or []],
                    "max_new_tokens": int(
                        rec.get("max_new_tokens") or 1),
                    "eos_id": rec.get("eos_id"),
                    "tenant": rec.get("tenant"),
                    "deadline_s": rec.get("deadline_s"),
                    "trace": rec.get("trace"),
                    "tokens": [],
                    "done": False,
                    "finish_reason": None,
                }
                self._live_count += 1
        elif kind == "progress":
            req = self._requests.get(str(rid))
            if req is None or req["done"]:
                return
            start = int(rec.get("start") or 0)
            toks = [int(t) for t in rec.get("tokens") or []]
            if start <= len(req["tokens"]):
                req["tokens"][start:start + len(toks)] = toks
        elif kind == "done":
            req = self._requests.get(str(rid))
            if req is not None:
                if not req["done"]:
                    self._live_count -= 1
                req["done"] = True
                req["finish_reason"] = rec.get("finish_reason")

    # --------------------------------------------------------- appending
    def append_admitted(self, rid, prompt, max_new_tokens,
                        eos_id: Optional[int] = None,
                        tenant: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        trace: Optional[str] = None) -> None:
        """Journal a request's admission. Idempotent on `rid`: a client
        retry (or a racing duplicate submit) appends nothing. `trace`
        is the request's cross-process trace id — journaled so a
        cold-restart recovery leg rejoins the original timeline."""
        rid = str(rid)
        rec = {"kind": "admitted", "id": rid,
               "prompt": [int(t) for t in prompt],
               "max_new_tokens": int(max_new_tokens)}
        if eos_id is not None:
            rec["eos_id"] = int(eos_id)
        if tenant is not None:
            rec["tenant"] = str(tenant)
        if deadline_s is not None:
            rec["deadline_s"] = float(deadline_s)
        if trace is not None:
            rec["trace"] = str(trace)
        with self._io_lock:
            if rid not in self._requests:
                self._replay(rec)
                self._write(rec)

    def record_progress(self, rid, tokens) -> None:
        """Append the NEW tokens of `rid` — the delta past what the
        journal already holds — as an absolute-positioned progress
        record. Passing the full token list every time is the
        intended calling convention; the journal computes the delta."""
        rid = str(rid)
        toks = [int(t) for t in tokens]
        with self._io_lock:
            req = self._requests.get(rid)
            if req is not None and not req["done"] \
                    and len(toks) > len(req["tokens"]):
                start = len(req["tokens"])
                rec = {"kind": "progress", "id": rid, "start": start,
                       "tokens": toks[start:]}
                self._replay(rec)
                self._write(rec)

    def append_done(self, rid, finish_reason: Optional[str]) -> None:
        """Journal a request's terminal state — a restart will not
        resurrect it. No-op for unknown or already-done ids."""
        rid = str(rid)
        with self._io_lock:
            req = self._requests.get(rid)
            if req is not None and not req["done"]:
                rec = {"kind": "done", "id": rid,
                       "finish_reason": finish_reason}
                self._replay(rec)
                self._write(rec)

    def flush(self, force: bool = True) -> None:
        """Group-commit checkpoint: fsync now (`force=True`) or let
        the interval/byte policy decide (`force=False` — the step
        loop's per-iteration call)."""
        with self._io_lock:
            self._maybe_sync(force)
        self._emit()

    def close(self) -> None:
        """Flush and close the head segment. Closing is NOT completion:
        the live set stays on disk for the next process to recover."""
        with self._io_lock:
            if self._closed:
                return
            self._maybe_sync(True)
            if self._head_f is not None:
                try:
                    self._head_f.close()
                except OSError:
                    pass
                self._head_f = None
            self._closed = True
        self._emit()

    # ------------------------------------------------- io (under lock)
    def _write(self, rec: dict) -> None:
        if self._closed or self._head_f is None:
            return
        blob = frame_record(rec)
        self._head_f.write(blob)
        self._head_f.flush()
        self._records += 1
        self._pend_records += 1
        self._head_bytes += len(blob)
        self._bytes += len(blob)
        self._unsynced += len(blob)
        # `journal.write_torn` chaos: a truncate spec mauls the head
        # segment right after this append landed — the torn-tail drill
        # recovery must truncate back from
        _fire("journal.write_torn", path=self._head_path())
        self._maybe_sync(False)
        if self._head_bytes >= self.segment_bytes:
            self._compact_locked()

    def _maybe_sync(self, force: bool) -> None:
        if self._unsynced <= 0 or self._head_f is None:
            return
        now = self._clock()
        if not force and self.fsync_interval_s > 0 \
                and self._unsynced < self.fsync_bytes \
                and now - self._last_sync < self.fsync_interval_s:
            return
        try:
            # `journal.fsync_fail` chaos: the group fsync failing must
            # not lose the journal — the bytes stay pending and the
            # next flush retries them
            _fire("journal.fsync_fail")
            os.fsync(self._head_f.fileno())
        except (OSError, FaultInjectedError):
            self._fsync_failures += 1
            return
        self._fsyncs += 1
        self._pend_fsyncs += 1
        self._unsynced = 0
        self._last_sync = now

    # -------------------------------------------------------- compaction
    def compact(self) -> int:
        """Consolidate the journal: rewrite every LIVE request into one
        fresh segment (atomic publish), open a new empty head AFTER
        it, delete every older segment — done requests' records vanish
        with them. Returns the number of segments deleted. Safe to
        kill at any point: the consolidated segment only becomes
        visible complete (fsync + rename), and idempotent replay means
        any mix of old and new segments recovers the same live set."""
        with self._io_lock:
            deleted = self._compact_locked()
        self._emit()
        return deleted

    def _compact_locked(self) -> int:
        if self._closed or self._head_f is None:
            return 0
        self._maybe_sync(True)
        olds = self._segments()
        try:
            self._head_f.close()
        except OSError:
            pass
        consolidated = self._head_index + 1
        records: List[dict] = []
        for rid in sorted(self._requests):
            req = self._requests[rid]
            if req["done"]:
                continue
            rec = {"kind": "admitted", "id": rid,
                   "prompt": list(req["prompt"]),
                   "max_new_tokens": req["max_new_tokens"]}
            if req["eos_id"] is not None:
                rec["eos_id"] = req["eos_id"]
            if req["tenant"] is not None:
                rec["tenant"] = req["tenant"]
            if req["deadline_s"] is not None:
                rec["deadline_s"] = req["deadline_s"]
            if req.get("trace") is not None:
                rec["trace"] = req["trace"]
            records.append(rec)
            if req["tokens"]:
                records.append({"kind": "progress", "id": rid,
                                "start": 0,
                                "tokens": list(req["tokens"])})
        write_records(self._seg_path(consolidated), records)
        # a done request survives only in memory from here: the engine
        # keeps its own bounded dedup map; the journal's job is the
        # LIVE set, and forgetting the finished keeps it O(in-flight)
        self._requests = {rid: req
                          for rid, req in self._requests.items()
                          if not req["done"]}
        self._head_index = consolidated + 1
        self._head_pathname = self._seg_path(self._head_index)
        self._head_f = open(self._head_pathname, "ab")
        self._head_bytes = 0
        self._unsynced = 0
        deleted = 0
        for path in olds:
            try:
                os.remove(path)
                deleted += 1
            except OSError:
                pass
        try:
            self._bytes = os.path.getsize(self._seg_path(consolidated))
        except OSError:
            self._bytes = 0
        self._compactions += 1
        self._pend_compactions += 1
        return deleted

    # ------------------------------------------------------------- facts
    def live(self) -> Dict[str, dict]:
        """Every admitted-but-not-done request: the recovery work
        list. Token lists are copies — safe to hand to submit()."""
        with self._io_lock:
            return {rid: {"prompt": list(req["prompt"]),
                          "max_new_tokens": req["max_new_tokens"],
                          "eos_id": req["eos_id"],
                          "tenant": req["tenant"],
                          "deadline_s": req["deadline_s"],
                          "trace": req.get("trace"),
                          "tokens": list(req["tokens"])}
                    for rid, req in self._requests.items()
                    if not req["done"]}

    def stats(self) -> Dict:
        with self._io_lock:
            live = self._live_count
            return {
                "directory": self.directory,
                "segments": len(self._segments()),
                "bytes": self._bytes,
                "live": live,
                "done": len(self._requests) - live,
                "records": self._records,
                "fsyncs": self._fsyncs,
                "fsync_failures": self._fsync_failures,
                "torn_tails": self._torn_tails,
                "compactions": self._compactions,
                "fsync_interval_s": self.fsync_interval_s,
            }

    def _emit(self) -> None:
        """Drain deferred metric deltas OUTSIDE the io lock. Called at
        group-commit boundaries (flush/compact/close/init), NOT per
        append — the hot decode loop appends thousands of records a
        second and one emission per step is plenty for dashboards."""
        with self._io_lock:
            rec = self._pend_records
            fs = self._pend_fsyncs
            comp = self._pend_compactions
            self._pend_records = 0
            self._pend_fsyncs = 0
            self._pend_compactions = 0
            nbytes = self._bytes
            live = self._live_count
        if rec:
            _obs.count("dl4j_journal_records_total", n=rec)
        if fs:
            _obs.count("dl4j_journal_fsyncs_total", n=fs)
        if comp:
            _obs.count("dl4j_journal_compactions_total", n=comp)
        _obs.set_gauge("dl4j_journal_bytes", nbytes)
        _obs.set_gauge("dl4j_journal_live", live)
