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

  divergence_quorum         per-rank copies of one step (`rank-<r>/`)
                            vote by state digest; a minority fork is
                            renamed aside (`.divergent`) and healed from
                            the quorum copy; a tie raises
                            CheckpointDivergenceError
  quorum_resume_step        the newest step with quorum (the cluster
                            supervisor's per-rank resume handshake)

The manifest's keys and the file names (`step-%08d.npz`) are the JAX
package's, so either package validates the other's checkpoint
directories.

  shard_sidecar_filename    a ZeRO-1 rank's optimizer-state slice file
                            (`step-%08d.updshard.npz`), its manifest entry
                            tied to the main state's digest
  shard_slice_dirs          the rank directories that hold a step's slices,
                            one per dp coordinate
  collect_sharded_slices    the validated slice set of a step (or None)
  sharded_quorum_resume_step
                            the quorum over ZeRO-1 copies: replicated state
                            votes over the save-time world, slices do not,
                            and slice-set completeness gates the election
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import re
import shutil
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.resilience.errors import (
    CheckpointDivergenceError,
    CheckpointIntegrityError,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

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


# ------------------------------------------------- divergence quorum
DIVERGENT_SUFFIX = ".divergent"
_RANK_DIR_RE = re.compile(r"rank-(\d+)$")


def rank_checkpoint_dir(base: str, rank: int) -> str:
    """Rank `rank`'s own checkpoint directory under the shared base —
    one convention so workers and the supervisor derive it alike."""
    return os.path.join(base, f"rank-{rank}")


def _present_rank_dirs(base_dir: str) -> List[int]:
    """The ranks that have a `rank-<r>` directory under `base_dir`."""
    if not base_dir or not os.path.isdir(base_dir):
        return []
    ranks = []
    for fn in os.listdir(base_dir):
        m = _RANK_DIR_RE.match(fn)
        if m and os.path.isdir(os.path.join(base_dir, fn)):
            ranks.append(int(m.group(1)))
    return sorted(ranks)


def _quarantine_aside(path: str) -> str:
    """Rename a divergent copy aside (never deleted); returns its new
    path."""
    aside = path + DIVERGENT_SUFFIX
    i = 0
    while os.path.exists(aside):
        i += 1
        aside = f"{path}{DIVERGENT_SUFFIX}.{i}"
    os.replace(path, aside)
    return aside


def divergence_quorum(base_dir: str, nprocs: int, step: int,
                      heal: bool = True) -> dict:
    """Compare every rank's copy of checkpoint `step` and elect the
    quorum state digest.

    A digest wins when it is held by a strict majority of the gang
    (`> nprocs // 2`) and by strictly more ranks than any rival digest.
    Minority / torn / missing ranks are then HEALED (with `heal=True`):
    a divergent copy is renamed aside with ``.divergent`` (never
    deleted) and the quorum rank's file + manifest entry are copied
    into place, so every rank resumes from the SAME bytes. Two or more
    digests with no such winner is a fork with no ground truth —
    CheckpointDivergenceError, fail loudly before any resume. A single
    digest held only by a minority elects nothing (``digest: None`` —
    the step simply lacks enough copies; callers fall back to an older
    step).

    Returns ``{"step", "digest", "ranks": {rank: digest|None},
    "healed": [rank...], "quarantined": [path...]}``."""
    fn = step_filename(step)
    ranks = list(range(int(nprocs)))
    digests: Dict[int, Optional[str]] = {}
    for r in ranks:
        d = rank_checkpoint_dir(base_dir, r)
        digests[r] = (state_digest(d, fn)
                      if validate_file(d, fn) else None)
    tally: Dict[str, List[int]] = {}
    for r, dg in digests.items():
        if dg is not None:
            tally.setdefault(dg, []).append(r)
    report = {"step": int(step), "digest": None, "ranks": digests,
              "healed": [], "quarantined": []}
    if not tally:
        return report
    ordered = sorted(tally.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    top_digest, top_ranks = ordered[0]
    majority = len(top_ranks) > len(ranks) // 2
    contested = len(ordered) > 1
    if contested and (not majority
                      or len(ordered[1][1]) == len(top_ranks)):
        raise CheckpointDivergenceError(
            f"checkpoint step {step} diverges across ranks with no "
            f"quorum: {[(dg[:12], rs) for dg, rs in ordered]} — "
            "refusing to elect a fork", step=int(step),
            votes={dg: list(rs) for dg, rs in tally.items()})
    if not majority:
        return report          # one digest, too few copies: no quorum
    report["digest"] = top_digest
    if not heal:
        return report
    src_dir = rank_checkpoint_dir(base_dir, top_ranks[0])
    src = os.path.join(src_dir, fn)
    src_entry = read_manifest(src_dir).get(fn)
    for r in ranks:
        if digests[r] == top_digest:
            continue
        d = rank_checkpoint_dir(base_dir, r)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, fn)
        if os.path.exists(path):
            aside = _quarantine_aside(path)
            report["quarantined"].append(aside)
            logger.warning(
                "divergence quorum: rank %d checkpoint step %d "
                "out-voted (%s vs quorum %s) — quarantined to %s",
                r, step, (digests[r] or "invalid")[:12],
                top_digest[:12], aside)
        shutil.copy2(src, path)
        if src_entry is not None:
            extra = {k: v for k, v in src_entry.items()
                     if k not in ("sha256", "size")}
            record_checksum(d, fn, src_entry["sha256"],
                            src_entry["size"], extra=extra)
        else:
            record_checksum(d, fn, sha256_file(path),
                            os.path.getsize(path),
                            extra={"step": int(step),
                                   "state_sha256": top_digest})
        report["healed"].append(r)
    return report


def quorum_resume_step(base_dir: str, nprocs: int,
                       heal: bool = True) -> Optional[dict]:
    """The per-rank analogue of `newest_valid_checkpoint` with the
    divergence gate in front: the newest step whose state digest has
    quorum across the `nprocs` rank directories, minorities healed.
    Raises CheckpointDivergenceError when the newest contested step is
    an unresolvable fork; returns None when no step has quorum."""
    steps = set()
    for r in range(int(nprocs)):
        steps.update(list_step_checkpoints(
            rank_checkpoint_dir(base_dir, r)))
    for step in sorted(steps, reverse=True):
        report = divergence_quorum(base_dir, nprocs, step, heal=heal)
        if report["digest"] is not None:
            return report
    return None


# --------------------------------------------- sharded optimizer state
# ZeRO-1 checkpoints (engine/sharding.py) split each rank's copy in two:
# the MAIN step file holds the replicated portion (params, BN states,
# step bookkeeping, the unshardable optimizer leaves and the layout) —
# the same state on every rank, so the divergence quorum votes over it
# unchanged — and a SIDECAR holds the slice of the sharded
# optimizer-state leaves that the rank's dp coordinate keeps (its
# `shard_rank` of `shard_world` = dp). On a mesh whose other axes exceed
# 1 the ranks of one coordinate write equal slices; the manifest entry's
# `processes` (the save-time world; absent: `shard_world`) places them:
# dp is the mesh's slowest axis, so coordinate d's first rank is
# d * processes / dp. The sidecar's manifest entry records
# `main_state_sha256`, tying the slice to the main state it was saved
# with: a rank whose main copy was out-voted as a fork carries a slice
# recorded against the forked digest, so the slice is rejected and the
# resume falls back to an older, fully agreed step (no other rank holds
# a forked replica's rows).
SHARD_SUFFIX = ".updshard.npz"


def shard_sidecar_filename(step: int) -> str:
    return f"step-{step:08d}{SHARD_SUFFIX}"


def _saved_processes(base_dir: str, step: int, shard_world: int) -> int:
    """The world that wrote `step`'s slices: rank 0's sidecar manifest
    entry's `processes`, else `shard_world` (a world that was all dp)."""
    entry = read_manifest(rank_checkpoint_dir(base_dir, 0)).get(
        shard_sidecar_filename(step)) or {}
    return int(entry.get("processes", shard_world))


def shard_slice_dirs(base_dir: str, step: int,
                     shard_world: int) -> List[str]:
    """The rank directories under `base_dir` whose sidecars hold `step`'s
    slices, one per dp coordinate in coordinate order: the first rank of
    each coordinate (module note above)."""
    procs = _saved_processes(base_dir, step, shard_world)
    per = max(1, procs // max(1, shard_world))
    return [rank_checkpoint_dir(base_dir, d * per)
            for d in range(shard_world)]


def collect_sharded_slices(dirs: List[str], step: int,
                           expect_digest: Optional[str] = None
                           ) -> Optional[Dict[int, str]]:
    """{shard_rank: path} of the validated optimizer-state slice sidecars
    for `step` across `dirs` — None when ANY slice is missing, fails its
    checksum, or (with `expect_digest`) was recorded against a different
    main-state digest than the elected one. A hole in the slice set is a
    hole in the optimizer state: callers fall back to an older step
    rather than zero-fill."""
    fn = shard_sidecar_filename(step)
    out: Dict[int, str] = {}
    for d in dirs:
        if not validate_file(d, fn):
            return None
        entry = read_manifest(d).get(fn) or {}
        if expect_digest is not None \
                and entry.get("main_state_sha256") != expect_digest:
            logger.warning(
                "sharded checkpoint: slice %s in %s recorded against "
                "digest %s, elected %s — rejected", fn, d,
                str(entry.get("main_state_sha256"))[:12],
                expect_digest[:12])
            return None
        rank = entry.get("shard_rank")
        if rank is None:
            return None
        out[int(rank)] = os.path.join(d, fn)
    if sorted(out) != list(range(len(dirs))):
        return None
    return out


def _saved_shard_world(base_dir: str, ranks: List[int],
                       step: int) -> Optional[int]:
    """Save-time world of `step`, read from the first valid copy's
    `shard_world` field (0 = unsharded layout). None when no copy is
    readable."""
    fn = step_filename(step)
    for r in ranks:
        d = rank_checkpoint_dir(base_dir, r)
        if not validate_file(d, fn):
            continue
        try:
            with np.load(os.path.join(d, fn)) as z:
                return (int(z["shard_world"])
                        if "shard_world" in z.files else 0)
        except Exception:   # noqa: BLE001 - torn copy: try another rank
            continue
    return None


def sharded_quorum_resume_step(base_dir: str, nprocs: int,
                               heal: bool = True) -> Optional[dict]:
    """`quorum_resume_step` for sharded-optimizer checkpoints: the newest
    step whose replicated state has quorum AND whose slice set is
    complete and tied to the elected digest.

    The vote runs over the SAVE-time world (read from the candidate
    copies), not the surviving gang's `nprocs`: after a 3→2 shrink the
    step was written by three ranks and all three slices are needed to
    reassemble the optimizer state, so rank dirs beyond the current
    world still vote and still contribute their slice. On a mesh with
    other axes above 1 every rank votes and one rank per dp coordinate
    contributes the slice (`shard_slice_dirs`). The returned report gains
    ``shard_world`` and ``slices`` ({shard_rank: sidecar path}) for the
    resharding-on-resume loader."""
    ranks_present = _present_rank_dirs(base_dir)
    steps = set()
    for r in ranks_present:
        steps.update(list_step_checkpoints(
            rank_checkpoint_dir(base_dir, r)))
    for step in sorted(steps, reverse=True):
        world = _saved_shard_world(base_dir, ranks_present, step)
        if world is None:
            continue
        if world == 0:
            # unsharded layout (a step saved before ZeRO-1): plain quorum
            # over the current gang
            report = divergence_quorum(base_dir, nprocs, step, heal=heal)
            if report["digest"] is not None:
                return report
            continue
        report = divergence_quorum(
            base_dir, _saved_processes(base_dir, step, world), step,
            heal=heal)
        if report["digest"] is None:
            continue
        dirs = shard_slice_dirs(base_dir, step, world)
        slices = collect_sharded_slices(
            dirs, step, expect_digest=report["digest"])
        if slices is None:
            logger.warning(
                "sharded quorum: step %d elected but its optimizer slice "
                "set is incomplete/untrusted — falling back to an older "
                "step", step)
            continue
        report["shard_world"] = world
        report["slices"] = slices
        return report
    return None


def apply_retention(directory: str, keep_last: int) -> List[int]:
    """Prune step checkpoints beyond the newest `keep_last`; returns the
    pruned steps. keep_last <= 0 keeps everything. Covers .npz files
    and checkpoint directories on one step timeline."""
    if keep_last <= 0:
        return []
    entries = list_all_checkpoints(directory)
    pruned = entries[:-keep_last] if len(entries) > keep_last else []
    for step, fn in pruned:
        path = os.path.join(directory, fn)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            with contextlib.suppress(OSError):
                os.remove(path)
            forget_checksum(directory, fn)
        # a pruned step's optimizer-state slice sidecar goes with it
        side = shard_sidecar_filename(step)
        if os.path.exists(os.path.join(directory, side)):
            with contextlib.suppress(OSError):
                os.remove(os.path.join(directory, side))
            forget_checksum(directory, side)
    return [step for step, _ in pruned]
