"""Crash-safe file writes (a copy of the two helpers of
deeplearning4j_tpu/resilience/checkpoint_integrity.py that the port's
model writer needs).

  sha256_file(path)    the digest a `<path>.sha256` sidecar records
  atomic_writer(path)  tmp file in the same directory -> flush -> fsync
                       -> os.replace (atomic on POSIX), so a kill
                       mid-write never publishes a partial file
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Iterator


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


@contextlib.contextmanager
def atomic_writer(path: str, suffix: str = ".tmp") -> Iterator[str]:
    """Yield a tmp path next to `path`; publish atomically on success.

    On exception the tmp file is removed and nothing is published — the
    previous version of `path` (if any) survives a crash mid-write."""
    path = os.fspath(path)
    tmp = path + suffix
    try:
        yield tmp
        with open(tmp, "rb+") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
