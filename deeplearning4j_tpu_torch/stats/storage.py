"""Stats storage SPI + in-memory and file backends (a copy of
deeplearning4j_tpu/stats/storage.py; a FileStatsStorage written by either
package is read by the other).

Parity: api/storage/StatsStorage.java (SPI shared by UI & Spark),
ui/storage/InMemoryStatsStorage.java:21, FileStatsStorage.java /
MapDBStatsStorage.java:22 (persistent). The file backend is append-only
JSONL — durable, tail-able, and diff-friendly."""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.stats.report import StatsReport


class StatsStorage:
    """SPI: put/list/get reports + change listeners
    (ref: StatsStorage.java / StatsStorageRouter.java)."""

    def put_report(self, report: StatsReport) -> None:
        raise NotImplementedError

    def session_ids(self) -> List[str]:
        raise NotImplementedError

    def reports(self, session_id: str) -> List[StatsReport]:
        raise NotImplementedError

    def latest(self, session_id: str) -> Optional[StatsReport]:
        rs = self.reports(session_id)
        return rs[-1] if rs else None

    def add_listener(self, fn: Callable[[StatsReport], None]) -> None:
        self._listeners().append(fn)

    def _listeners(self) -> list:
        if not hasattr(self, "_cbs"):
            self._cbs = []
        return self._cbs

    def _notify(self, report: StatsReport) -> None:
        for fn in self._listeners():
            fn(report)

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """ref: InMemoryStatsStorage.java:21."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_session: Dict[str, List[StatsReport]] = {}

    def put_report(self, report: StatsReport) -> None:
        with self._lock:
            self._by_session.setdefault(report.session_id, []).append(report)
        self._notify(report)

    def session_ids(self) -> List[str]:
        with self._lock:
            return list(self._by_session)

    def reports(self, session_id: str) -> List[StatsReport]:
        with self._lock:
            return list(self._by_session.get(session_id, []))


class FileStatsStorage(StatsStorage):
    """Append-only JSONL file storage (ref: FileStatsStorage.java /
    MapDBStatsStorage.java:22 persistent role). Reopening the same path
    loads previously recorded reports."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._mem = InMemoryStatsStorage()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._mem.put_report(StatsReport.from_json(line))
        self._fh = open(path, "a")

    def put_report(self, report: StatsReport) -> None:
        with self._lock:
            self._fh.write(report.to_json() + "\n")
            self._fh.flush()
        self._mem.put_report(report)
        self._notify(report)

    def session_ids(self) -> List[str]:
        return self._mem.session_ids()

    def reports(self, session_id: str) -> List[StatsReport]:
        return self._mem.reports(session_id)

    def close(self) -> None:
        with self._lock:
            self._fh.close()


class RemoteStatsStorageRouter(StatsStorage):
    """POSTs reports as JSON to a remote UIServer's /remote endpoint
    (ref: deeplearning4j-core api/storage/impl/
    RemoteUIStatsStorageRouter.java:33 -> RemoteReceiverModule). Write
    path only; reads raise (query the receiving server instead)."""

    def __init__(self, url: str, timeout: float = 10.0,
                 retry_count: int = 3):
        if not url.rstrip("/").endswith("/remote"):
            url = url.rstrip("/") + "/remote"
        self.url = url
        self.timeout = timeout
        self.retry_count = retry_count

    def put_report(self, report: StatsReport) -> None:
        import http.client

        scheme, _, rest = self.url.partition("://")
        if scheme not in ("http", "https") or not rest:
            raise ValueError(f"not an http(s) URL: {self.url!r}")
        host, _, path = rest.partition("/")
        conn_cls = (http.client.HTTPSConnection if scheme == "https"
                    else http.client.HTTPConnection)
        body = report.to_json().encode()
        last = None
        for _ in range(max(1, self.retry_count)):
            conn = conn_cls(host, timeout=self.timeout)
            try:
                conn.request("POST", "/" + path, body=body, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                if resp.status < 400:
                    self._notify(report)
                    return
                last = f"HTTP {resp.status} {resp.reason}"
            except (OSError, http.client.HTTPException) as e:   # retried
                last = e
            finally:
                conn.close()
        raise IOError(f"failed to POST stats report to {self.url}: {last}")

    def session_ids(self):
        raise NotImplementedError(
            "RemoteStatsStorageRouter is write-only; query the receiving "
            "UIServer's storage")

    def reports(self, session_id):
        raise NotImplementedError(
            "RemoteStatsStorageRouter is write-only; query the receiving "
            "UIServer's storage")
