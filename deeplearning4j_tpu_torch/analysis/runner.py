"""Orchestrates the static passes + the program pass + baseline + CLI
(counterpart of deeplearning4j_tpu/analysis/runner.py).

Used two ways:

  - `tools/analyze_torch.py` (zero-dependency CLI; exit 0 = clean vs
    baseline, 1 = new findings, 2 = usage error). The default run is
    the three AST passes over `deeplearning4j_tpu_torch/` — parsed,
    never imported, no torch — with `tests/test_torch_*.py` as the
    tests the conformance pass reads. The `--programs` mode adds
    pass 4 (analysis/program_lint): it imports torch, builds the
    representative program set on the CPU (analysis/programs) and lints
    each program's recorded op stream against its declared facts.
  - `tests/test_torch_analysis.py` runs `analyze()` inside tier-1 so a
    new violation fails CI with the same report a developer sees
    locally.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence, Set

from deeplearning4j_tpu_torch.analysis import (
    concurrency_lint,
    conformance,
    jit_lint,
)
from deeplearning4j_tpu_torch.analysis.findings import (
    RULES,
    Baseline,
    Finding,
)
from deeplearning4j_tpu_torch.analysis.source import load_sources

PASSES = ("jit", "concurrency", "conformance")
PROGRAM_PASS = "programs"
PKG_NAME = "deeplearning4j_tpu_torch"
TEST_GLOB = "test_torch_*.py"
BASELINE_NAME = "analyze_torch_baseline.json"


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)
    new: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale: List[dict] = field(default_factory=list)
    files_scanned: int = 0
    programs_checked: int = 0
    catalog: Optional[object] = None
    reports: List[dict] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.new


def analyze(pkg_dir, root=None, tests_dir=None,
            baseline: Optional[Baseline] = None,
            passes: Sequence[str] = PASSES,
            only: Optional[Set[str]] = None,
            program_records=None,
            test_glob: str = "*.py") -> AnalysisResult:
    """Run the selected passes over `pkg_dir`.

    `only` (repo-relative paths) limits which files *report* findings
    (--diff mode); the conformance pass still reads the whole package —
    registry equality is a global property — but its findings are
    filtered to the changed files. The "programs" pass lints
    `program_records` (default: the representative set from
    analysis/programs — imports torch). `test_glob` picks the files
    under `tests_dir` that count as tests."""
    pkg_dir = Path(pkg_dir)
    root = Path(root) if root is not None else pkg_dir.parent
    ast_passes = [p for p in passes if p != PROGRAM_PASS]
    sources = load_sources(pkg_dir, root) if ast_passes else []
    narrowed = sources if only is None \
        else [sf for sf in sources if sf.rel in only]

    findings: List[Finding] = []
    catalog = None
    programs_checked = 0
    reports: List[dict] = []
    if "jit" in passes:
        all_jit = jit_lint.run(sources)
        findings += [f for f in all_jit
                     if only is None or f.file in only]
    if "concurrency" in passes:
        con, catalog = concurrency_lint.run_with_catalog(narrowed)
        findings += con
    if "conformance" in passes:
        conf = conformance.run(sources, tests_dir=tests_dir,
                               test_glob=test_glob)
        findings += [f for f in conf
                     if only is None or f.file in only]
    if PROGRAM_PASS in passes:
        from deeplearning4j_tpu_torch.analysis import program_lint
        records = program_records
        if records is None:
            from deeplearning4j_tpu_torch.analysis import programs
            records = programs.build_default_records()
        programs_checked = len(records)
        prog, reports = program_lint.run_with_reports(records)
        findings += [f for f in prog
                     if only is None or f.file in only]

    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    res = AnalysisResult(findings=findings,
                         files_scanned=len(narrowed),
                         programs_checked=programs_checked,
                         catalog=catalog, reports=reports)
    if baseline is None:
        res.new = list(findings)
    else:
        res.new, res.suppressed, stale = baseline.apply(findings)
        # one baseline serves both modes: an entry is stale only when
        # the pass that would report it ran
        ran = {PROGRAM_PASS: "program"}
        kinds = {ran.get(p, p) for p in passes}
        res.stale = [e for e in stale
                     if getattr(RULES.get(e["rule"]), "pass_name",
                                None) in kinds]
    return res


# ----------------------------------------------------------------- CLI
def _git_changed_files(root: Path, ref: str) -> Set[str]:
    files: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", ref, "--", "*.py"],
                ["git", "ls-files", "--others", "--exclude-standard",
                 "--", "*.py"]):
        try:
            out = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if out.returncode == 0:
            files |= {ln.strip() for ln in out.stdout.splitlines()
                      if ln.strip()}
    return files


def render_catalog(catalog) -> str:
    lines = ["thread/lock catalog:"]
    for t in catalog.threads:
        nm = t.name_literal or ("<dynamic>" if t.named else "<unnamed>")
        lines.append(
            f"  thread {t.file}:{t.line} name={nm} "
            f"daemon={'y' if t.daemon else 'N'} "
            f"bound={t.bound_to or '-'} "
            f"joined={'y' if t.joined else 'N'}")
    for lk in catalog.locks:
        lines.append(f"  {lk.kind.lower():9s} {lk.file}:{lk.line} "
                     f"bound={lk.bound_to or '-'}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dl4j-analyze-torch",
        description="static invariant checker for deeplearning4j_tpu_torch "
                    "(host syncs and CUDA-graph hygiene, concurrency "
                    "discipline, registry conformance; --programs: the "
                    "program lint)")
    ap.add_argument("paths", nargs="*",
                    help="restrict to these files (repo-relative)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto from this file)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: tools/{BASELINE_NAME})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline "
                         "file (keeping the reasons of entries it had) "
                         "and exit 0")
    ap.add_argument("--diff", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="check only files changed vs REF "
                         "(default HEAD) — fast local iteration")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--catalog", action="store_true",
                    help="print the thread/lock catalog")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma list of passes (default: all of "
                         f"{','.join(PASSES)})")
    ap.add_argument("--programs", action="store_true",
                    help="run pass 4 (the program lint) over the "
                         "representative program set instead of the "
                         "AST passes — imports torch, runs on the CPU")
    args = ap.parse_args(argv)

    if args.rules:
        from deeplearning4j_tpu_torch.analysis.findings import (
            JAX_RULE_MAP,
        )
        for r in RULES.values():
            print(f"{r.id:30s} [{r.pass_name}] {r.description}")
        by_kind = {"static": 0, "program": 0, "runtime": 0}
        for r in RULES.values():
            kind = r.pass_name if r.pass_name in by_kind else "static"
            by_kind[kind] += 1
        for jid, pid in sorted(JAX_RULE_MAP.items()):
            print(f"JAX {jid} -> {pid}")
        print(f"{len(RULES)} rules ({by_kind['static']} static, "
              f"{by_kind['program']} program, "
              f"{by_kind['runtime']} runtime sanitizer)")
        return 0

    root = Path(args.root) if args.root else \
        Path(__file__).resolve().parents[2]
    pkg_dir = root / PKG_NAME
    tests_dir = root / "tests"
    if not pkg_dir.is_dir():
        print(f"error: package dir not found under {root}",
              file=sys.stderr)
        return 2
    baseline_path = Path(args.baseline) if args.baseline \
        else root / "tools" / BASELINE_NAME

    only: Optional[Set[str]] = None
    if args.paths:
        only = set()
        for p in args.paths:
            rp = Path(p)
            try:
                only.add(rp.resolve().relative_to(
                    root.resolve()).as_posix())
            except ValueError:
                only.add(rp.as_posix())
    if args.diff is not None:
        changed = {f for f in _git_changed_files(root, args.diff)
                   if f.startswith(PKG_NAME + "/")}
        only = changed if only is None else (only & changed)
        if not only:
            print("dl4j-analyze-torch: no changed package files vs "
                  f"{args.diff}; nothing to check")
            return 0

    if args.programs:
        passes = (PROGRAM_PASS,)
    else:
        passes = tuple(p.strip() for p in args.passes.split(",")
                       if p.strip())
        for p in passes:
            if p not in PASSES:
                print(f"error: unknown pass '{p}'", file=sys.stderr)
                return 2

    baseline = None
    if not args.no_baseline and baseline_path.exists():
        baseline = Baseline.load(baseline_path)

    res = analyze(pkg_dir, root=root, tests_dir=tests_dir,
                  baseline=None if args.write_baseline else baseline,
                  passes=passes, only=only, test_glob=TEST_GLOB)

    if args.write_baseline:
        reasons = baseline.reasons() if baseline is not None else {}
        out = Baseline.from_findings(res.findings, reasons)
        if baseline is not None:
            # the entries of the passes that did not run stay
            kinds = {"program" if p == PROGRAM_PASS else p
                     for p in passes}
            out.entries = [e for e in baseline.entries
                           if getattr(RULES.get(e["rule"]), "pass_name",
                                      None) not in kinds] + out.entries
        out.save(baseline_path)
        print(f"dl4j-analyze-torch: wrote {len(res.findings)} "
              f"suppressions to {baseline_path}")
        return 0

    if args.catalog and res.catalog is not None:
        print(render_catalog(res.catalog))

    for rep in res.reports:
        print("program " + rep.get("summary", rep.get("name", "")))
    for f in res.new:
        print(f.render())
    for e in res.stale:
        print(f"stale baseline entry (violation fixed — remove it): "
              f"{e['rule']} {e['file']} [{e.get('symbol', '')}]")
    by_rule = {}
    for f in res.findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    scanned = (f"{res.programs_checked} programs"
               if PROGRAM_PASS in passes
               else f"{res.files_scanned} files")
    print(f"dl4j-analyze-torch: {len(res.new)} new finding(s), "
          f"{len(res.suppressed)} baselined, {len(res.stale)} stale "
          f"baseline entr(ies); {scanned}, "
          f"{len(RULES)} rules"
          + (f"; by rule: " +
             ", ".join(f"{k}={v}" for k, v in sorted(by_rule.items()))
             if by_rule else ""))
    return 1 if res.new else 0
