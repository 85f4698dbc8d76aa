"""Crash-safe file writes and checkpoint checksum manifests (a copy of the
single-host part of deeplearning4j_tpu/resilience/checkpoint_integrity.py).

A relaunched job resumes from its newest checkpoint only if (a) a kill
mid-write can never publish a partial file and (b) a torn write that
slips through anyway is *detected* and skipped in favor of the newest
valid checkpoint. This module provides both halves:

  sha256_file(path)         the digest a manifest entry or a
                            `<path>.sha256` sidecar records
  atomic_writer(path)       tmp file in the same directory -> flush ->
                            fsync -> os.replace (atomic on POSIX)
  MANIFEST (manifest.json)  per-directory {filename: {sha256, size, ...}},
                            itself written atomically; the hash is taken
                            from the tmp file BEFORE the fault-injection
                            point, so a torn write shows up as a
                            mismatch on load
  newest_valid_checkpoint   scan fallback when the latest pointer or
                            file is damaged
  apply_retention           keep_last pruning of step files + manifest
  write_tree_manifest       the same integrity story for a checkpoint
                            that is a directory (`manifest.sha256.json`
                            inside it)
  compute_state_digest      a canonical digest of the arrays inside an
                            .npz checkpoint (container-timestamp-immune)

The manifest's keys and the file names (`step-%08d.npz`) are the JAX
package's, so either package validates the other's checkpoint
directories. The multi-process part (the per-rank divergence quorum, the
ZeRO-1 shard sidecars, `*_quorum_resume_step`) waits for the port's
cluster supervisor (ROADMAP queues 8-9).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import shutil
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import CheckpointIntegrityError

MANIFEST = "manifest.json"
TREE_MANIFEST = "manifest.sha256.json"
_STEP_RE = re.compile(r"step-(\d+)\.npz$")
# any step checkpoint: .npz files AND directories (step-N.orbax)
_STEP_ANY_RE = re.compile(r"step-(\d+)\.(npz|orbax)$")


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


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_writer(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(data)


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode())


# ----------------------------------------------------------------- manifest
def _manifest_path(directory: str) -> str:
    return os.path.join(directory, MANIFEST)


def read_manifest(directory: str) -> Dict[str, dict]:
    p = _manifest_path(directory)
    if not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        # a damaged manifest must not take down recovery — files can
        # still be structurally validated one by one
        return {}


def record_checksum(directory: str, filename: str, sha256: str,
                    size: int, extra: Optional[dict] = None) -> None:
    """Merge one entry into the directory manifest (atomic rewrite)."""
    manifest = read_manifest(directory)
    manifest[filename] = {"sha256": sha256, "size": int(size),
                          **(extra or {})}
    atomic_write_json(_manifest_path(directory), manifest)


def forget_checksum(directory: str, filename: str) -> None:
    manifest = read_manifest(directory)
    if filename in manifest:
        del manifest[filename]
        atomic_write_json(_manifest_path(directory), manifest)


def _matches(path: str, entry: dict) -> bool:
    """`path` has the size and sha256 its manifest entry records."""
    try:
        if os.path.getsize(path) != entry["size"] \
                or sha256_file(path) != entry["sha256"]:
            _obs.count("dl4j_checkpoint_validate_failures_total")
            return False
        return True
    except OSError:
        return False


def validate_file(directory: str, filename: str) -> bool:
    """True iff `filename` matches its manifest entry (size + sha256).

    Files with no manifest entry (pre-manifest checkpoints) pass on
    existence alone — structural validation is the caller's fallback."""
    path = os.path.join(directory, filename)
    if not os.path.exists(path):
        return False
    entry = read_manifest(directory).get(filename)
    return entry is None or _matches(path, entry)


def require_valid(directory: str, filename: str) -> None:
    if not validate_file(directory, filename):
        raise CheckpointIntegrityError(
            f"{filename} in {directory} failed checksum validation "
            "(truncated or torn write?)")


# ------------------------------------------------------------ tree manifest
def write_tree_manifest(directory: str) -> Dict[str, dict]:
    """Record {relpath: {sha256, size}} for every file under
    `directory` (a directory checkpoint's integrity sidecar, written
    atomically after the checkpoint's files). Returns the entries."""
    entries: Dict[str, dict] = {}
    for root, _, files in os.walk(directory):
        for fn in files:
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, directory)
            if rel == TREE_MANIFEST:
                continue
            entries[rel] = {"sha256": sha256_file(path),
                            "size": os.path.getsize(path)}
    atomic_write_json(os.path.join(directory, TREE_MANIFEST), entries)
    return entries


def validate_tree(directory: str) -> bool:
    """True iff every file recorded in the directory's tree manifest
    matches (size + sha256). Directories without a manifest pass on
    existence alone."""
    if not os.path.isdir(directory):
        return False
    mp = os.path.join(directory, TREE_MANIFEST)
    if not os.path.exists(mp):
        return True
    try:
        with open(mp) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return False
    return all(_matches(os.path.join(directory, rel), ent)
               for rel, ent in entries.items())


def require_valid_tree(directory: str) -> None:
    if not validate_tree(directory):
        raise CheckpointIntegrityError(
            f"{directory} failed tree-manifest validation "
            "(torn checkpoint directory?)")


# ----------------------------------------------------------------- recovery
def step_filename(step: int) -> str:
    return f"step-{step:08d}.npz"


def list_step_checkpoints(directory: str) -> List[int]:
    if not directory or not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                               os.listdir(directory)) if m)


def list_all_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Every step checkpoint in the directory as (step, filename),
    sorted by step — .npz files AND checkpoint directories, so retention
    and fallback scans see one step timeline."""
    if not directory or not os.path.isdir(directory):
        return []
    return sorted((int(m.group(1)), fn) for fn in os.listdir(directory)
                  for m in [_STEP_ANY_RE.match(fn)] if m)


def newest_valid_checkpoint(directory: str,
                            structural_check=None) -> Optional[int]:
    """Newest step whose file passes checksum (and, when the manifest
    has no entry, `structural_check(path)`) — None if nothing valid."""
    for step in reversed(list_step_checkpoints(directory)):
        fn = step_filename(step)
        if not validate_file(directory, fn):
            continue
        if (structural_check is not None
                and read_manifest(directory).get(fn) is None):
            try:
                structural_check(os.path.join(directory, fn))
            except Exception:   # noqa: BLE001 - any load failure = invalid
                continue
        return step
    return None


def compute_state_digest(path: str) -> str:
    """Canonical digest of the ARRAYS inside a .npz checkpoint: sorted
    keys, dtype/shape/raw bytes. Two copies of the same training state
    hash equal even though the zip containers differ (per-entry
    timestamps). TrainingMaster records it in the manifest at save."""
    with np.load(path, allow_pickle=False) as z:
        return state_digest_of({k: z[k] for k in z.files})


def state_digest_of(arrays: Dict[str, np.ndarray]) -> str:
    """The canonical digest of a {key: array} payload (what
    `compute_state_digest` reads back from its file)."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def state_digest(directory: str, filename: str) -> Optional[str]:
    """The recorded state digest for `filename` (written at save into
    the manifest), recomputed from the file when the manifest predates
    it. None when the file is missing or unreadable."""
    entry = read_manifest(directory).get(filename)
    if entry and "state_sha256" in entry:
        return entry["state_sha256"]
    path = os.path.join(directory, filename)
    if not os.path.exists(path):
        return None
    try:
        return compute_state_digest(path)
    except Exception:   # noqa: BLE001 - torn/corrupt file: no digest
        return None


def apply_retention(directory: str, keep_last: int) -> List[int]:
    """Prune step checkpoints beyond the newest `keep_last`; returns the
    pruned steps. keep_last <= 0 keeps everything. Covers .npz files
    and checkpoint directories on one step timeline."""
    if keep_last <= 0:
        return []
    entries = list_all_checkpoints(directory)
    pruned = entries[:-keep_last] if len(entries) > keep_last else []
    for _, fn in pruned:
        path = os.path.join(directory, fn)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            with contextlib.suppress(OSError):
                os.remove(path)
            forget_checksum(directory, fn)
    return [step for step, _ in pruned]
