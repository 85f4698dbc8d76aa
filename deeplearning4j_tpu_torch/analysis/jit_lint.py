"""Pass 1 — host syncs and CUDA-graph hygiene (counterpart of
deeplearning4j_tpu/analysis/jit_lint.py, retargeted to PyTorch).

The port has no jit: its step programs run eagerly, and its one
compiled form is `StepProgram.run_group`'s CUDA graph (engine/
step_program.py `_CapturedGroup`, which captures `_group_body`). So
the pass keeps the JAX pass's host-sync rule and replaces the three
rules that name jit mechanisms with their CUDA-graph counterparts
(findings.py holds the id table):

  jit-host-sync            blocking device->host sync on a hot path
  graph-uncapturable-op    an op a CUDA graph capture refuses, in a
                           function reachable from the captured body
  graph-per-call-key       a group/program key built from a per-call
                           value (builds again on every value)
  graph-read-after-replay  a captured group's static buffer read after
                           a later replay() overwrote it

Decision on jit-traced-python-scalar: a Python scalar passed to a
callable retraces nothing in eager PyTorch, and the captured group
takes its per-step scalars as a [k, 2] tensor. Its real counterpart is
a cache key that moves with a per-call value — graph-per-call-key.

Reachability, as in the JAX pass: a class-hierarchy call graph where
`self.m()` resolves, a name-based over-approximation where it does not.

  - hot roots: the `fit`/`output`/`predict`/HTTP-handler names, every
    `threading.Thread` target, and the engine's entry points by exact
    qualname (`ROOT_QUALNAMES`: StepProgram's run/run_batch/run_group,
    the four StepHarness entry points, DecodeProgram's dispatches,
    ParallelInference.output);
  - capture roots: the functions the captured body runs, by qualname
    (`CAPTURE_ROOTS`: `StepProgram._group_body`, the net's `_step`, the
    ZeRO-1 step), plus every call made inside a
    `with torch.cuda.graph(...)` block; the walk stays in the modules
    the train step can run (`CAPTURE_SCOPE`);
  - a call through a name the function binds itself (a parameter or a
    local: `step = net._step_impl or net._step; step(...)`) follows no
    name edge — the callable it holds is rooted explicitly, and matching
    the local's name against every function so named reaches nothing
    it can run.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.findings import (
    Finding,
    pragma_allows,
)
from deeplearning4j_tpu_torch.analysis.source import (
    SourceFile,
    call_name,
    dotted,
)

# entry points of the step/serving hot paths (thread targets are added
# dynamically — every Thread body is a hot path in this codebase)
ROOT_NAMES = {"fit", "output", "predict", "do_POST", "do_GET"}

_PKG = "deeplearning4j_tpu_torch"
# the engine's and the serving planes' stable entry points, by exact
# qualname
ROOT_QUALNAMES = {
    f"{_PKG}/engine/step_program.py::StepProgram.run",
    f"{_PKG}/engine/step_program.py::StepProgram.run_batch",
    f"{_PKG}/engine/step_program.py::StepProgram.run_group",
    f"{_PKG}/engine/harness.py::StepHarness.guarded",
    f"{_PKG}/engine/harness.py::StepHarness.step_scope",
    f"{_PKG}/engine/harness.py::StepHarness.session",
    f"{_PKG}/engine/harness.py::StepHarness.check_preemption",
    f"{_PKG}/engine/decode_program.py::DecodeProgram.step",
    f"{_PKG}/engine/decode_program.py::DecodeProgram.prefill_chunk",
    f"{_PKG}/engine/decode_program.py::DecodeProgram.copy_page",
    f"{_PKG}/parallel/inference.py::ParallelInference.output",
}

# what run_group's CUDA graph runs, by qualname within its file (so a
# fixture's StepProgram._group_body roots the same way)
CAPTURE_ROOTS = {"StepProgram._group_body", "BaseNetwork._step",
                 "build_zero1_step.step"}
# the package's modules the captured train step can run: the net's math
# (nn/), the tree utilities, the ZeRO-1 step and the collectives. The
# capture walk follows no name edge into the rest of the package — a
# tensor's `.apply`/`.eval`/`.get` is no serving handler's — while files
# outside the package (fixtures) are all in scope
CAPTURE_SCOPE = ("nn/", "util/", "engine/sharding.py",
                 "engine/step_program.py", "parallel/collectives.py",
                 "parallel/tensor_parallel.py")

# files whose host syncs are the *instrument* (the StepPhaseProfiler's
# deliberate sampled sync)
SANCTIONED_SYNC_FILES = ("observability/perf.py",)

# float()/int() of a call to one of these methods reads a tensor value
# to the host (receivers that are host modules are not tensors)
TENSOR_VALUED = {"score", "sum", "mean", "max", "min", "norm", "argmax",
                 "argmin", "std", "var", "prod", "amax", "amin",
                 "count_nonzero", "dot"}
HOST_MODULES = {"np", "numpy", "math", "statistics", "time", "os"}

# constructions and ops a CUDA graph capture refuses: a pageable
# host-to-device copy, a data-dependent output shape (the size is read
# back), a stream/device/event synchronize
H2D_CONSTRUCTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
DATA_DEPENDENT = {"nonzero", "unique", "masked_select", "bincount",
                  "unique_consecutive", "argwhere"}

# attributes that move every call: a key holding one captures again
PER_CALL_ATTRS = {"iteration", "epoch", "_score", "_lr_score_factor",
                  "learning_rate", "lr", "_epoch"}
CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "time.time_ns", "time.perf_counter_ns"}
KEY_FUNC = re.compile(r"(^|_)key$")

# a captured group's static buffers (step_program.py _CapturedGroup)
STATIC_ATTRS = {"out", "static", "_in", "static_out", "static_in"}


@dataclass
class _FuncInfo:
    sf: SourceFile
    node: ast.FunctionDef
    qualname: str
    calls: Set[str] = field(default_factory=set)
    self_calls: Set[str] = field(default_factory=set)
    owner_class: Optional[str] = None
    thread_targets: Set[str] = field(default_factory=set)


# ------------------------------------------------------- reachability
def _is_self_call(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self")


def _local_names(sf: SourceFile, fn) -> Set[str]:
    """Names `fn` binds itself: its parameters and its assignment
    targets (nested defs excluded — those are functions)."""
    a = fn.args
    out = {x.arg for x in a.args + a.kwonlyargs + a.posonlyargs}
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)
    for sub in sf.walk(fn):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            out.add(sub.id)
    return out


class _ClassGraph:
    """Class-hierarchy map for real `self.m()` edge resolution (as in
    the JAX pass): classes link by base NAME across the whole package,
    so `self.m()` resolves to the method bodies of the class, its
    ancestors and its descendants."""

    def __init__(self, sources: List[SourceFile]):
        self.entries: Dict[str, List[dict]] = {}
        self.derived: Dict[str, Set[str]] = {}
        for sf in sources:
            for node in sf.walk():
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = [dotted(b).split(".")[-1] for b in node.bases]
                methods = {
                    ch.name: f"{sf.rel}::{sf.qualname_of(ch)}"
                    for ch in node.body
                    if isinstance(ch, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))}
                self.entries.setdefault(node.name, []).append(
                    {"bases": [b for b in bases if b],
                     "methods": methods})
                for b in bases:
                    if b:
                        self.derived.setdefault(b, set()).add(node.name)

    def related(self, cls: str) -> Set[str]:
        out: Set[str] = set()
        frontier = [cls]
        while frontier:
            c = frontier.pop()
            if c in out:
                continue
            out.add(c)
            for entry in self.entries.get(c, ()):
                frontier.extend(entry["bases"])
        frontier = [cls]
        down: Set[str] = set()
        while frontier:
            c = frontier.pop()
            if c in down:
                continue
            down.add(c)
            frontier.extend(self.derived.get(c, ()))
        return out | down

    def resolve(self, cls: str, method: str) -> List[str]:
        return [entry["methods"][method]
                for c in self.related(cls)
                for entry in self.entries.get(c, ())
                if method in entry["methods"]]


class CallGraph:
    """Functions of the analyzed sources with their call edges."""

    def __init__(self, sources: List[SourceFile]):
        self.funcs: List[_FuncInfo] = []
        self.by_name: Dict[str, List[_FuncInfo]] = {}
        self.by_qual: Dict[str, _FuncInfo] = {}
        self.classes = _ClassGraph(sources)
        for sf in sources:
            method_owner: Dict[int, str] = {}
            for node in sf.walk():
                if isinstance(node, ast.ClassDef):
                    for ch in node.body:
                        if isinstance(ch, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                            method_owner[id(ch)] = node.name
            for node in sf.functions():
                fi = _FuncInfo(sf, node,
                               f"{sf.rel}::{sf.qualname_of(node)}",
                               owner_class=method_owner.get(id(node)))
                local = _local_names(sf, node)
                for sub in sf.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    n = call_name(sub)
                    if n:
                        if _is_self_call(sub):
                            fi.self_calls.add(n)
                        elif not (isinstance(sub.func, ast.Name)
                                  and n in local):
                            fi.calls.add(n)
                    if n == "Thread":
                        for kw in sub.keywords:
                            if kw.arg == "target":
                                tn = dotted(kw.value).split(".")[-1]
                                if tn:
                                    fi.thread_targets.add(tn)
                self.funcs.append(fi)
                self.by_name.setdefault(node.name, []).append(fi)
                self.by_qual[fi.qualname] = fi

    def reach(self, roots: List[_FuncInfo],
              extra_names: Set[str] = frozenset(),
              scope=None) -> Set[str]:
        """Qualnames reachable from `roots` (and every function named in
        `extra_names`); `scope(rel)` False stops the walk at a file."""
        seen: Set[str] = set()
        frontier = list(roots)
        for n in extra_names:
            frontier.extend(self.by_name.get(n, ()))
        while frontier:
            fi = frontier.pop()
            if fi.qualname in seen \
                    or (scope is not None and not scope(fi.sf.rel)):
                continue
            seen.add(fi.qualname)
            for called in fi.self_calls:
                targets = (self.classes.resolve(fi.owner_class, called)
                           if fi.owner_class else [])
                if targets:
                    for q in targets:
                        callee = self.by_qual.get(q)
                        if callee is not None \
                                and callee.qualname not in seen:
                            frontier.append(callee)
                    continue
                for callee in self.by_name.get(called, ()):
                    if callee.qualname not in seen:
                        frontier.append(callee)
            for called in fi.calls | fi.thread_targets:
                for callee in self.by_name.get(called, ()):
                    if callee.qualname not in seen:
                        frontier.append(callee)
        return seen


def build_reachable(sources: List[SourceFile],
                    graph: Optional[CallGraph] = None) -> Set[str]:
    """Qualnames reachable from the hot-path roots."""
    g = graph or CallGraph(sources)
    thread_roots: Set[str] = set()
    for fi in g.funcs:
        thread_roots |= fi.thread_targets
    roots = [fi for fi in g.funcs
             if fi.node.name in ROOT_NAMES
             or fi.node.name in thread_roots
             or fi.qualname in ROOT_QUALNAMES]
    return g.reach(roots)


def _graph_blocks(sf: SourceFile, fnode) -> List[ast.With]:
    return [w for w in sf.walk(fnode) if isinstance(w, ast.With)
            and any(dotted(it.context_expr.func).endswith("cuda.graph")
                    for it in w.items
                    if isinstance(it.context_expr, ast.Call))]


def build_captured(sources: List[SourceFile],
                   graph: Optional[CallGraph] = None) -> Set[str]:
    """Qualnames reachable from what a CUDA graph capture runs."""
    g = graph or CallGraph(sources)
    roots = [fi for fi in g.funcs
             if fi.qualname.split("::", 1)[1] in CAPTURE_ROOTS]
    names: Set[str] = set()
    for fi in g.funcs:
        for w in _graph_blocks(fi.sf, fi.node):
            local = _local_names(fi.sf, fi.node)
            for sub in fi.sf.walk(w):
                if isinstance(sub, ast.Call):
                    n = call_name(sub)
                    if n and not (isinstance(sub.func, ast.Name)
                                  and n in local):
                        names.add(n)
    return g.reach(roots, names, _in_capture_scope)


def _in_capture_scope(rel: str) -> bool:
    if not rel.startswith(_PKG + "/"):
        return True
    return rel[len(_PKG) + 1:].startswith(CAPTURE_SCOPE)


# ------------------------------------------------------------- markers
def _host_value(expr) -> bool:
    """`expr` is a host module's result (`np.asarray(x)`, `math.fsum`):
    reading it back syncs nothing."""
    return isinstance(expr, ast.Call) \
        and dotted(expr.func).split(".")[0] in HOST_MODULES


def _host_sync_marker(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute) and not _host_value(f.value):
        if f.attr == "item" and not node.args:
            return ".item()"
        if f.attr == "tolist" and not node.args:
            return ".tolist()"
        if f.attr == "cpu" and not node.args:
            return ".cpu()"
        if f.attr == "numpy" and not node.args \
                and dotted(f.value) not in HOST_MODULES:
            return ".numpy()"
        if dotted(f).endswith("cuda.synchronize"):
            return "torch.cuda.synchronize()"
    if isinstance(f, ast.Name) and f.id in ("float", "int") \
            and len(node.args) == 1:
        a = node.args[0]
        if isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute) \
                and a.func.attr in TENSOR_VALUED \
                and dotted(a.func.value).split(".")[0] not in HOST_MODULES:
            return f"{f.id}(x.{a.func.attr}(...))"
    return None


def _uncapturable_marker(node: ast.Call) -> Optional[str]:
    m = _host_sync_marker(node)
    if m is not None:
        return m
    d = dotted(node.func)
    if d in H2D_CONSTRUCTORS:
        return f"{d}(...)"
    cn = call_name(node)
    if cn in DATA_DEPENDENT:
        return f"{cn}(...)"
    if cn == "synchronize":
        return f"{d}()"
    if cn == "pin_memory":
        return ".pin_memory()"
    return None


# ------------------------------------------------------------- checks
def run(sources: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    graph = CallGraph(sources)
    reachable = build_reachable(sources, graph)
    captured = build_captured(sources, graph)
    for sf in sources:
        in_sanctioned = any(sf.rel.endswith(x)
                            for x in SANCTIONED_SYNC_FILES)
        for fnode in sf.functions():
            qual = f"{sf.rel}::{sf.qualname_of(fnode)}"
            symbol = sf.qualname_of(fnode)
            # --- jit-host-sync ----------------------------------------
            if qual in reachable and not in_sanctioned:
                synced: Set[int] = set()   # one finding per line
                for sub in sf.walk(fnode):
                    if not isinstance(sub, ast.Call) \
                            or sub.lineno in synced:
                        continue
                    marker = _host_sync_marker(sub)
                    if marker is None or pragma_allows(
                            sf.allow, sub.lineno, "jit-host-sync"):
                        continue
                    synced.add(sub.lineno)
                    findings.append(Finding(
                        "jit-host-sync", sf.rel, sub.lineno,
                        f"{marker} forces a device->host sync on a hot "
                        f"path (reachable from "
                        f"{'/'.join(sorted(ROOT_NAMES))}, an engine "
                        f"entry point or a thread body)", symbol=symbol))
            # --- graph-uncapturable-op --------------------------------
            blocks = _graph_blocks(sf, fnode)
            if qual in captured or blocks:
                body = [fnode] if qual in captured else blocks
                seen_lines: Set[int] = set()
                for b in body:
                    for sub in sf.walk(b):
                        if not isinstance(sub, ast.Call) \
                                or sub.lineno in seen_lines:
                            continue
                        marker = _uncapturable_marker(sub)
                        if marker is None or pragma_allows(
                                sf.allow, sub.lineno,
                                "graph-uncapturable-op"):
                            continue
                        seen_lines.add(sub.lineno)
                        findings.append(Finding(
                            "graph-uncapturable-op", sf.rel, sub.lineno,
                            f"{marker} inside what run_group's CUDA graph "
                            f"captures — the capture refuses it (or the "
                            f"replay skips its host side)",
                            symbol=symbol))
            # --- graph-per-call-key -----------------------------------
            if KEY_FUNC.search(fnode.name):
                findings.extend(_per_call_key(sf, fnode, symbol))
            # --- graph-read-after-replay ------------------------------
            findings.extend(_read_after_replay(sf, fnode, symbol))
    return findings


def _per_call_key(sf: SourceFile, fnode, symbol: str) -> List[Finding]:
    out: List[Finding] = []
    for sub in sf.walk(fnode):
        label = None
        if isinstance(sub, ast.Attribute) \
                and isinstance(sub.ctx, ast.Load) \
                and sub.attr in PER_CALL_ATTRS:
            label = dotted(sub)
        elif isinstance(sub, ast.Call):
            d = dotted(sub.func)
            if d in CLOCK_CALLS:
                label = f"{d}()"
            elif _host_sync_marker(sub) is not None:
                label = _host_sync_marker(sub)
        if label is None or pragma_allows(sf.allow, sub.lineno,
                                          "graph-per-call-key"):
            continue
        out.append(Finding(
            "graph-per-call-key", sf.rel, sub.lineno,
            f"key '{fnode.name}' is built from {label}, which changes "
            f"per call — every new value captures or builds the program "
            f"again", symbol=symbol))
    return out


def _static_alias(value) -> Optional[str]:
    """The static attribute an assignment's value aliases (`g.out`,
    `g.out[0]`, `g.static`), None for anything else — a `.clone()` or
    `clone(...)` of it included."""
    v = value
    while isinstance(v, ast.Subscript):
        v = v.value
    if isinstance(v, ast.Attribute) and v.attr in STATIC_ATTRS:
        return dotted(v)
    return None


def _read_after_replay(sf: SourceFile, fnode,
                       symbol: str) -> List[Finding]:
    """A name bound to a captured group's static buffer, read after a
    later `.replay()` without being rebound in between."""
    replays = sorted(sub.lineno for sub in sf.walk(fnode)
                     if isinstance(sub, ast.Call)
                     and call_name(sub) == "replay")
    if not replays:
        return []
    aliases: List[Tuple[int, str, str]] = []
    loads: List[Tuple[int, str]] = []
    stores: List[Tuple[int, str]] = []
    for sub in sf.walk(fnode):
        if isinstance(sub, ast.Assign):
            src = _static_alias(sub.value)
            if src is not None:
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        aliases.append((sub.lineno, t.id, src))
        if isinstance(sub, ast.Name):
            (loads if isinstance(sub.ctx, ast.Load)
             else stores).append((sub.lineno, sub.id))
    out: List[Finding] = []
    for bound_at, name, src in aliases:
        later = [r for r in replays if r > bound_at]
        if not later:
            continue
        replay_at = later[0]
        for ln in sorted(l for l, n in loads
                         if n == name and l > replay_at):
            if any(n == name and bound_at < sl <= ln
                   for sl, n in stores):
                break
            if pragma_allows(sf.allow, ln, "graph-read-after-replay"):
                break
            out.append(Finding(
                "graph-read-after-replay", sf.rel, ln,
                f"'{name}' aliases the captured group's static buffer "
                f"{src} and is read after a later replay() overwrote it "
                f"— clone it before the replay", symbol=symbol))
            break
    return out
