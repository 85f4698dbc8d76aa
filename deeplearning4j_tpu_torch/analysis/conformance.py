"""Pass 3 — registry conformance (counterpart of
deeplearning4j_tpu/analysis/conformance.py, the same rules), run over
the port's registries: REGISTERED_POINTS (resilience/faults.py),
REGISTERED_METRICS (observability/metrics.py) and
REGISTERED_PROGRAM_RULES (analysis/program_lint.py).

Generalizes the three hand-written pin tests (fault-point registry,
REGISTERED_METRICS, dashboard metric literals) into one pass so there
is a single source of truth:

  reg-unregistered-fault-point  fire("...") literal not registered
  reg-unfired-fault-point       registered point with no fire site
  reg-unregistered-metric       emitted/referenced dl4j_* literal not
                                registered (nor a registered prefix)
  reg-unemitted-metric          registered non-derived metric never
                                emitted
  reg-swallowed-exception       `except Exception: pass` outside the
                                guarded-telemetry annotation discipline
  reg-untested-registry-name    registered name no test ever mentions
  reg-unregistered-program-rule Rule("prog-...") catalog entry not in
                                the pinned REGISTERED_PROGRAM_RULES
  reg-unimplemented-program-rule pinned program rule with no Rule(...)
                                catalog definition

The registries themselves are read from the *AST* of the modules that
define them (frozenset literals assigned to REGISTERED_POINTS /
REGISTERED_METRICS / DERIVED_METRICS / REGISTERED_PROGRAM_RULES), so
this pass — like the other two — never imports the analyzed code. The
program-rule pin mirrors the metric discipline: the `prog-*` ids in
the findings.py catalog and the registry in program_lint.py must move
in the same commit, and every pinned id must be named by a test.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.findings import Finding, pragma_allows
from deeplearning4j_tpu_torch.analysis.source import (
    SourceFile,
    call_name,
    const_str,
)

EMIT_HELPERS = ("count", "observe", "set_gauge", "gauge_fn")
FUSED_HELPERS = ("count_observe",)
FIRE_NAMES = ("fire", "_fire")
METRIC_NAME = re.compile(r"\bdl4j_[a-z0-9_]+\b")
# literals in these telemetry domains must be registered names (or a
# registered-name prefix — the dashboard's startswith filters); other
# dl4j_ namespaces (w2v kernel labels etc.) are not metrics
METRIC_DOMAINS = re.compile(
    r"dl4j_(train|serving|checkpoint|cluster|retry|breaker|jit|obs"
    r"|perf|pipeline|mesh|fleet|rollout|decode|journal)_")


@dataclass
class RegistryView:
    points: Set[str] = field(default_factory=set)
    points_site: Tuple[str, int] = ("", 0)
    metrics: Set[str] = field(default_factory=set)
    metrics_site: Tuple[str, int] = ("", 0)
    derived: Set[str] = field(default_factory=set)
    program_rules: Set[str] = field(default_factory=set)
    program_rules_site: Tuple[str, int] = ("", 0)

    @property
    def complete(self) -> bool:
        return bool(self.points) and bool(self.metrics)


def parse_registries(sources: List[SourceFile]) -> RegistryView:
    """Pull REGISTERED_POINTS / REGISTERED_METRICS / DERIVED_METRICS
    out of whichever analyzed files define them (frozenset literals)."""
    view = RegistryView()
    for sf in sources:
        for node in sf.walk():
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id not in ("REGISTERED_POINTS",
                                "REGISTERED_METRICS",
                                "DERIVED_METRICS",
                                "REGISTERED_PROGRAM_RULES"):
                    continue
                names = _literal_names(node.value)
                if names is None:
                    continue
                if t.id == "REGISTERED_POINTS":
                    view.points = names
                    view.points_site = (sf.rel, node.lineno)
                elif t.id == "REGISTERED_METRICS":
                    view.metrics = names
                    view.metrics_site = (sf.rel, node.lineno)
                elif t.id == "REGISTERED_PROGRAM_RULES":
                    view.program_rules = names
                    view.program_rules_site = (sf.rel, node.lineno)
                else:
                    view.derived = names
    return view


def program_rule_sites(sources: List[SourceFile]
                       ) -> List[Tuple[str, SourceFile, int]]:
    """Every `Rule("prog-...", ...)` catalog definition in the
    analyzed sources (the findings.py catalog, read as AST)."""
    out = []
    for sf in sources:
        for node in sf.walk():
            if isinstance(node, ast.Call) \
                    and call_name(node) == "Rule" and node.args:
                lit = const_str(node.args[0])
                if lit is not None and lit.startswith("prog-"):
                    out.append((lit, sf, node.lineno))
    return out


def _literal_names(value) -> Optional[Set[str]]:
    if isinstance(value, ast.Call) and call_name(value) == "frozenset" \
            and value.args:
        value = value.args[0]
    try:
        v = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return None
    if isinstance(v, (set, frozenset, list, tuple)) \
            and all(isinstance(x, str) for x in v):
        return set(v)
    return None


# ----------------------------------------------------------- fire sites
def fire_sites(sources: List[SourceFile]
               ) -> List[Tuple[str, SourceFile, int, str]]:
    out = []
    for sf in sources:
        for node in sf.walk():
            if isinstance(node, ast.Call) \
                    and call_name(node) in FIRE_NAMES and node.args:
                lit = const_str(node.args[0])
                if lit is not None:
                    out.append((lit, sf, node.lineno,
                                sf.qualname_of(node)))
    return out


# ------------------------------------------------------- emission sites
def emission_sites(sources: List[SourceFile]
                   ) -> List[Tuple[str, SourceFile, int]]:
    """(metric name, file, line) for every emission call site. The
    registry-definition module itself is not a site."""
    out = []
    for sf in sources:
        if _defines_registry(sf, "REGISTERED_METRICS"):
            continue
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            if cn in EMIT_HELPERS and node.args:
                lit = const_str(node.args[0])
                if lit is not None and lit.startswith("dl4j_"):
                    out.append((lit, sf, node.lineno))
            elif cn in FUSED_HELPERS and len(node.args) >= 2:
                for a in node.args[:2]:
                    lit = const_str(a)
                    if lit is not None and lit.startswith("dl4j_"):
                        out.append((lit, sf, node.lineno))
    return out


def _defines_registry(sf: SourceFile, name: str) -> bool:
    for node in sf.walk():
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
    return False


def metric_literals(sources: List[SourceFile]
                    ) -> List[Tuple[str, SourceFile, int]]:
    """Every dl4j_* name appearing in any string constant (including
    prefix literals like the dashboard's startswith filters)."""
    out = []
    for sf in sources:
        if _defines_registry(sf, "REGISTERED_METRICS"):
            continue
        for node in sf.walk():
            s = const_str(node)
            if s is None:
                continue
            for m in METRIC_NAME.findall(s):
                out.append((m, sf, node.lineno))
    return out


# --------------------------------------------------------------- checks
def run(sources: List[SourceFile],
        tests_dir: Optional[Path] = None,
        test_glob: str = "*.py") -> List[Finding]:
    """The conformance findings of `sources`; registered names are held
    against the test files under `tests_dir` matching `test_glob` (the
    port's CLI: `test_torch_*.py`)."""
    findings: List[Finding] = []
    view = parse_registries(sources)

    # ---- fault points ------------------------------------------------
    fired: Dict[str, List[Tuple[SourceFile, int, str]]] = {}
    for name, sf, line, symbol in fire_sites(sources):
        fired.setdefault(name, []).append((sf, line, symbol))
    if view.points:
        for name, sites in sorted(fired.items()):
            if name in view.points:
                continue
            sf, line, symbol = sites[0]
            if pragma_allows(sf.allow, line,
                             "reg-unregistered-fault-point"):
                continue
            findings.append(Finding(
                "reg-unregistered-fault-point", sf.rel, line,
                f'fire("{name}") is not listed in REGISTERED_POINTS',
                symbol=symbol))
        for name in sorted(view.points - set(fired)):
            findings.append(Finding(
                "reg-unfired-fault-point", view.points_site[0],
                view.points_site[1],
                f'registered fault point "{name}" has no fire(...) '
                f'site in the package'))

    # ---- metrics -----------------------------------------------------
    emitted: Dict[str, List[Tuple[SourceFile, int]]] = {}
    for name, sf, line in emission_sites(sources):
        emitted.setdefault(name, []).append((sf, line))
    flagged_at_site: Set[Tuple[str, str]] = set()
    if view.metrics:
        for name, sites in sorted(emitted.items()):
            if name in view.metrics:
                continue
            sf, line = sites[0]
            if pragma_allows(sf.allow, line, "reg-unregistered-metric"):
                continue
            flagged_at_site.add((sf.rel, name))
            findings.append(Finding(
                "reg-unregistered-metric", sf.rel, line,
                f'emission of "{name}" which is not listed in '
                f'REGISTERED_METRICS'))
        for name in sorted(view.metrics - view.derived - set(emitted)):
            findings.append(Finding(
                "reg-unemitted-metric", view.metrics_site[0],
                view.metrics_site[1],
                f'registered metric "{name}" has no emission site in '
                f'the package'))
        # referenced literals in telemetry domains must resolve
        seen_msgs = set()
        for name, sf, line in metric_literals(sources):
            if not METRIC_DOMAINS.match(name):
                continue
            if name in view.metrics:
                continue
            if any(m.startswith(name) for m in view.metrics):
                continue   # prefix literal (dashboard filters)
            if pragma_allows(sf.allow, line, "reg-unregistered-metric"):
                continue
            key = (sf.rel, name)
            if key in seen_msgs or key in flagged_at_site:
                continue
            seen_msgs.add(key)
            findings.append(Finding(
                "reg-unregistered-metric", sf.rel, line,
                f'literal "{name}" is in a telemetry domain but is '
                f'neither a registered metric nor a registered-name '
                f'prefix'))

    # ---- program-rule registry pin -----------------------------------
    rule_sites = program_rule_sites(sources)
    if view.program_rules:
        for name, sf, line in sorted(rule_sites):
            if name in view.program_rules:
                continue
            if pragma_allows(sf.allow, line,
                             "reg-unregistered-program-rule"):
                continue
            findings.append(Finding(
                "reg-unregistered-program-rule", sf.rel, line,
                f'Rule("{name}") is not listed in '
                f"REGISTERED_PROGRAM_RULES"))
        declared = {n for n, _, _ in rule_sites}
        for name in sorted(view.program_rules - declared):
            findings.append(Finding(
                "reg-unimplemented-program-rule",
                view.program_rules_site[0], view.program_rules_site[1],
                f'pinned program rule "{name}" has no Rule(...) '
                f"catalog definition"))

    # ---- exception swallows ------------------------------------------
    findings.extend(swallow_sites(sources))

    # ---- test coverage -----------------------------------------------
    if tests_dir is not None and view.complete:
        blob = "\n".join(
            p.read_text() for p in sorted(Path(tests_dir).rglob(test_glob))
            if "__pycache__" not in p.parts)
        for name in sorted(view.points):
            if name not in blob:
                findings.append(Finding(
                    "reg-untested-registry-name", view.points_site[0],
                    view.points_site[1],
                    f'fault point "{name}" is named by no test'))
        for name in sorted(view.metrics):
            if name not in blob:
                findings.append(Finding(
                    "reg-untested-registry-name", view.metrics_site[0],
                    view.metrics_site[1],
                    f'metric "{name}" is named by no test'))
        for name in sorted(view.program_rules):
            if name not in blob:
                findings.append(Finding(
                    "reg-untested-registry-name",
                    view.program_rules_site[0],
                    view.program_rules_site[1],
                    f'program rule "{name}" is named by no test'))
    return findings


def swallow_sites(sources: List[SourceFile]) -> List[Finding]:
    """`except Exception:`/bare `except:` whose body is only pass/
    continue and whose except line carries no annotation (noqa with a
    reason, the repo's guarded-telemetry discipline) — silent failure
    swallowing."""
    findings: List[Finding] = []
    for sf in sources:
        lines = sf.text.splitlines()
        for node in sf.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException"))
            if not broad:
                continue
            if not all(isinstance(b, (ast.Pass, ast.Continue))
                       for b in node.body):
                continue
            src_line = lines[node.lineno - 1] \
                if node.lineno - 1 < len(lines) else ""
            if "noqa" in src_line:
                continue
            if pragma_allows(sf.allow, node.lineno,
                             "reg-swallowed-exception"):
                continue
            findings.append(Finding(
                "reg-swallowed-exception", sf.rel, node.lineno,
                "broad except swallowing every failure with no "
                "annotation — guarded-telemetry sites must carry a "
                "noqa reason",
                symbol=sf.qualname_of(node)))
    return findings
