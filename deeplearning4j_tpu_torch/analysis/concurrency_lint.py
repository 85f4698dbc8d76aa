"""Pass 2 — static concurrency lint + thread/lock catalog (counterpart
of deeplearning4j_tpu/analysis/concurrency_lint.py, the same rules).

Catalogs every `threading.Thread` / `Lock` / `RLock` / `Condition`
construction in the package and enforces the production-thread
discipline — over the port's serving (ParallelInference's batcher and
completion threads, the HTTP server), decode (DecodeEngine's loop and
watchdog), cluster (heartbeat, supervisor), gang and input-pipeline
threads:

  thr-unnamed-thread       every thread is named (hang forensics)
  thr-non-daemon-thread    every background thread is a daemon
  thr-orphan-thread        every thread has a join-or-ledger shutdown
  thr-blocking-under-lock  no blocking I/O or metric/fault emission
                           while holding a registry lock

The runtime half of this pass is `sanitizers.LockOrderSanitizer`
(DL4J_TPU_SANITIZE=locks): the static rules keep the thread population
legible; the sanitizer proves the lock *orders* those threads use stay
acyclic.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from deeplearning4j_tpu_torch.analysis.findings import Finding, pragma_allows
from deeplearning4j_tpu_torch.analysis.source import (
    SourceFile,
    call_name,
    dotted,
)

# callables that block (or can block unboundedly) — forbidden while a
# registry lock is held; file/io-named locks are exempt (their entire
# job is serializing the blocking resource itself)
BLOCKING_CALLS = {"sleep", "open", "fsync", "urlopen", "join",
                  "wait_for", "check_output", "run", "Popen",
                  "connect", "recv", "send", "sendall", "accept"}
EMISSION_HELPERS = {"count", "observe", "set_gauge", "gauge_fn",
                    "count_observe", "fire", "_fire"}
LOCKISH = re.compile(r"lock", re.IGNORECASE)
FILE_LOCK = re.compile(r"file|io", re.IGNORECASE)


@dataclass
class ThreadSite:
    file: str
    line: int
    named: bool
    name_literal: Optional[str]
    daemon: bool
    bound_to: Optional[str]
    joined: bool
    symbol: str


@dataclass
class LockSite:
    file: str
    line: int
    kind: str                 # Lock | RLock | Condition | Semaphore
    bound_to: Optional[str]
    symbol: str


@dataclass
class Catalog:
    threads: List[ThreadSite] = field(default_factory=list)
    locks: List[LockSite] = field(default_factory=list)


def _obs_aliases(sf: SourceFile) -> Set[str]:
    """Names under which this module can emit metrics/faults: module
    aliases of observability.metrics / resilience.faults plus directly
    imported helper names."""
    aliases: Set[str] = set()
    for node in sf.walk():
        if isinstance(node, ast.ImportFrom) and node.module:
            if "observability" in node.module or "faults" in node.module \
                    or "resilience" in node.module:
                for a in node.names:
                    nm = a.asname or a.name
                    if a.name in ("metrics", "faults") \
                            or nm in EMISSION_HELPERS \
                            or a.name in EMISSION_HELPERS:
                        aliases.add(nm)
    return aliases


def run(sources: List[SourceFile]) -> List[Finding]:
    findings, _ = run_with_catalog(sources)
    return findings


def run_with_catalog(sources: List[SourceFile]):
    findings: List[Finding] = []
    catalog = Catalog()
    for sf in sources:
        parents = sf.parents
        emit_aliases = _obs_aliases(sf)
        for node in sf.walk():
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d in ("threading.Thread", "Thread"):
                    findings.extend(
                        _check_thread(sf, node, parents, catalog))
                elif d in ("threading.Lock", "threading.RLock",
                           "threading.Condition", "threading.Semaphore",
                           "threading.BoundedSemaphore"):
                    catalog.locks.append(LockSite(
                        sf.rel, node.lineno, d.split(".")[-1],
                        _bound_name(parents.get(id(node))),
                        sf.qualname_of(node)))
            elif isinstance(node, ast.With):
                findings.extend(
                    _check_with_lock(sf, node, emit_aliases))
    return findings, catalog


def _bound_name(parent) -> Optional[str]:
    if isinstance(parent, ast.Assign):
        t = parent.targets[0]
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute):
            return t.attr
    return None


def _check_thread(sf: SourceFile, node: ast.Call, parents,
                  catalog: Catalog) -> List[Finding]:
    findings: List[Finding] = []
    kwargs = {kw.arg for kw in node.keywords if kw.arg}
    name_lit = None
    daemon = False
    for kw in node.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant):
            name_lit = str(kw.value.value)
        if kw.arg == "daemon":
            daemon = not (isinstance(kw.value, ast.Constant)
                          and kw.value.value is False)
    symbol = sf.qualname_of(node)
    bound = _bound_name(parents.get(id(node)))

    joined = False
    if bound is not None:
        # join-or-ledger: `X.join(` on the bound name, an aliased join
        # (`t = self.X` ... `t.join(`), or membership in a joined /
        # drained ledger list (`.append(X)` plus any `.join(` in the
        # module)
        pat_direct = re.compile(re.escape(bound) + r"\.join\(")
        pat_alias = re.compile(r"=\s*self\." + re.escape(bound) + r"\b")
        pat_append = re.compile(r"\.append\(\s*" + re.escape(bound)
                                + r"\s*\)")
        has_join = ".join(" in sf.text
        joined = bool(pat_direct.search(sf.text)
                      or (pat_alias.search(sf.text) and has_join)
                      or (pat_append.search(sf.text) and has_join))

    catalog.threads.append(ThreadSite(
        sf.rel, node.lineno, "name" in kwargs, name_lit, daemon,
        bound, joined, symbol))

    if "name" not in kwargs \
            and not pragma_allows(sf.allow, node.lineno,
                                  "thr-unnamed-thread"):
        findings.append(Finding(
            "thr-unnamed-thread", sf.rel, node.lineno,
            "threading.Thread(...) without name= — anonymous threads "
            "make faulthandler/watchdog dumps unreadable",
            symbol=symbol))
    if not daemon \
            and not pragma_allows(sf.allow, node.lineno,
                                  "thr-non-daemon-thread"):
        findings.append(Finding(
            "thr-non-daemon-thread", sf.rel, node.lineno,
            "threading.Thread(...) without daemon=True — a background "
            "thread that outlives a crash turns it into a hang",
            symbol=symbol))
    if (bound is None or not joined) \
            and not pragma_allows(sf.allow, node.lineno,
                                  "thr-orphan-thread"):
        how = ("constructed fire-and-forget (never bound)"
               if bound is None else
               f"bound to '{bound}' but never joined or ledgered")
        findings.append(Finding(
            "thr-orphan-thread", sf.rel, node.lineno,
            f"thread {how} — shutdown cannot prove it exited",
            symbol=symbol))
    return findings


def _check_with_lock(sf: SourceFile, node: ast.With,
                     emit_aliases: Set[str]) -> List[Finding]:
    lock_names = []
    for item in node.items:
        d = dotted(item.context_expr)
        if d and LOCKISH.search(d) and not FILE_LOCK.search(d) \
                and "()" not in d:
            lock_names.append(d)
    if not lock_names:
        return []
    findings: List[Finding] = []
    for sub in sf.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        cn = call_name(sub)
        bad: Optional[str] = None
        f = sub.func
        if cn in BLOCKING_CALLS:
            # `join` only counts for str-join-free receivers: x.join(
            # with zero args is "".join() style — require the call to
            # have no str-literal receiver
            if cn == "join" and isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Constant):
                continue
            if cn in ("run", "Popen", "check_output", "connect",
                      "recv", "send", "sendall", "accept"):
                # require a dotted receiver suggesting subprocess/socket
                recv = dotted(f) if isinstance(f, ast.Attribute) else ""
                if not re.search(r"subprocess|socket|sock|conn",
                                 recv, re.IGNORECASE):
                    continue
            bad = f"blocking call '{cn}(...)'"
        if cn in EMISSION_HELPERS:
            is_emit = False
            if isinstance(f, ast.Name) and f.id in emit_aliases:
                is_emit = True
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in emit_aliases:
                is_emit = True
            if is_emit:
                bad = f"metric/fault emission '{cn}(...)'"
        if bad is None:
            continue
        if pragma_allows(sf.allow, sub.lineno, "thr-blocking-under-lock"):
            continue
        findings.append(Finding(
            "thr-blocking-under-lock", sf.rel, sub.lineno,
            f"{bad} while holding {'/'.join(lock_names)} — blocks every "
            f"thread contending for the lock and invites lock-order "
            f"inversions",
            symbol=sf.qualname_of(sub)))
    return findings
