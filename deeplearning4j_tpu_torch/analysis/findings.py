"""Rule catalog, findings, and the checked-in baseline (counterpart of
deeplearning4j_tpu/analysis/findings.py).

A `Finding` is one violation of one `Rule` at one source location.
Findings are matched against the baseline
(`tools/analyze_torch_baseline.json`) by *fingerprint* — rule + file +
enclosing symbol + message, no line number — so pre-existing violations
stay suppressed across unrelated edits while NEW violations (or an old
one moving to a new function) fail tier-1. Baseline entries that no
longer fire are reported as stale so the burn-down list shrinks
explicitly, never silently. An entry may carry a `reason` (one line:
why the site stays as it is); matching ignores it.

Inline sanctioning: a source line (or the line directly above it) may
carry

    # analyze: allow=<rule-id>[,<rule-id>] — <reason>

which suppresses those rules for that statement. Pragmas are for sites
that are *correct by design* (the StepPhaseProfiler's deliberate device
sync, the completion stage's one device-to-host read); the baseline is
for debt.

The catalog is the port's. Where a JAX rule means the same thing in
PyTorch it keeps its id; where it names a JAX mechanism the port does
not have (jit donation, retracing), a port rule of the same family takes
its place:

  JAX id                     port id                  why
  jit-host-sync              jit-host-sync            same hazard: .item(),
                                                      .tolist(), .cpu(),
                                                      .numpy(), a device
                                                      synchronize, float()/
                                                      int() of a tensor
  jit-missing-donate         graph-uncapturable-op    the port's compiled
                                                      step is run_group's
                                                      CUDA graph: what
                                                      breaks it is an op
                                                      the capture refuses
  jit-use-after-donation     graph-read-after-replay  a captured group's
                                                      static buffers are
                                                      overwritten by the
                                                      next replay, as a
                                                      donated buffer is
                                                      invalidated
  jit-traced-python-scalar   graph-per-call-key       a group or program
                                                      key built from a
                                                      per-call value
                                                      captures (builds)
                                                      again on every value
  thr-*, reg-*, prog-*, san-*  the same ids           same meaning

The `prog-*` rules keep their ids and their intent; their evidence is
the op stream of one eager call recorded under a TorchDispatchMode and
the hand kernels' launches by route and dtype (program_lint.py).
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

PRAGMA_RE = re.compile(r"#\s*analyze:\s*allow=([a-z0-9,\-]+)")


@dataclass(frozen=True)
class Rule:
    id: str
    pass_name: str          # "jit" | "concurrency" | "conformance"
                            # | "program" | "runtime"
    description: str


# JAX rule id -> the port rule that takes its place (ids not listed keep
# their name in the port)
JAX_RULE_MAP = {
    "jit-missing-donate": "graph-uncapturable-op",
    "jit-use-after-donation": "graph-read-after-replay",
    "jit-traced-python-scalar": "graph-per-call-key",
}

# every rule id of the JAX package's catalog
JAX_RULE_IDS = (
    "jit-host-sync", "jit-missing-donate", "jit-traced-python-scalar",
    "jit-use-after-donation", "thr-unnamed-thread",
    "thr-non-daemon-thread", "thr-orphan-thread",
    "thr-blocking-under-lock", "reg-unregistered-fault-point",
    "reg-unfired-fault-point", "reg-unregistered-metric",
    "reg-unemitted-metric", "reg-swallowed-exception",
    "reg-untested-registry-name", "reg-unregistered-program-rule",
    "reg-unimplemented-program-rule", "prog-fp32-matmul-under-policy",
    "prog-unhonored-donation", "prog-transpose-churn",
    "prog-hidden-host-transfer", "prog-dead-output",
    "prog-excess-padding", "prog-unsharded-optimizer-state",
    "san-lock-order-cycle", "san-long-held-lock",
)


def port_rule_id(jax_id: str) -> str:
    """The port's id for a JAX rule id."""
    return JAX_RULE_MAP.get(jax_id, jax_id)


_RULE_LIST = [
    # ---- pass 1: host syncs and CUDA-graph hygiene ----
    Rule("jit-host-sync", "jit",
         "host-sync call (.item()/.tolist()/.cpu()/.numpy()/"
         "torch.cuda.synchronize()/float() or int() of a tensor-valued "
         "call) in a function reachable from the step/serving hot paths, "
         "outside the sanctioned sites"),
    Rule("graph-uncapturable-op", "jit",
         "op a CUDA graph capture refuses (a host sync, a host-to-device "
         "tensor construction, a data-dependent-shape op, a stream or "
         "device synchronize) in a function reachable from run_group's "
         "captured body — the capture fails, or the replay skips it"),
    Rule("graph-per-call-key", "jit",
         "group or program cache key built from a per-call value "
         "(iteration, learning rate, a clock, a host read) — every new "
         "value captures or builds the program again"),
    Rule("graph-read-after-replay", "jit",
         "a captured group's static output or input buffer read after a "
         "later replay() without a clone first — the replay has "
         "overwritten it"),
    # ---- pass 2: concurrency ----
    Rule("thr-unnamed-thread", "concurrency",
         "threading.Thread(...) without name= — anonymous threads make "
         "hang forensics (faulthandler dumps, watchdog reports) useless"),
    Rule("thr-non-daemon-thread", "concurrency",
         "threading.Thread(...) that is not daemon=True — a non-daemon "
         "background thread turns any crash into a hang at exit"),
    Rule("thr-orphan-thread", "concurrency",
         "thread started with no join-or-ledger shutdown path (not "
         "bound, or bound but never joined/tracked) — shutdown cannot "
         "prove the thread is gone"),
    Rule("thr-blocking-under-lock", "concurrency",
         "blocking call (sleep/open/join/socket) or metric/fault "
         "emission while holding a registry lock — serializes the hot "
         "path and invites lock-order inversions"),
    # ---- pass 3: registry conformance ----
    Rule("reg-unregistered-fault-point", "conformance",
         'fire("...") literal not listed in faults.REGISTERED_POINTS'),
    Rule("reg-unfired-fault-point", "conformance",
         "REGISTERED_POINTS entry with no fire(...) site in the package"),
    Rule("reg-unregistered-metric", "conformance",
         "emitted or referenced dl4j_* metric literal not listed in "
         "metrics.REGISTERED_METRICS (nor a registered-name prefix)"),
    Rule("reg-unemitted-metric", "conformance",
         "REGISTERED_METRICS entry (non-derived) with no emission site"),
    Rule("reg-swallowed-exception", "conformance",
         "bare `except Exception: pass` (or continue) without the "
         "guarded-telemetry annotation — silent failure swallowing"),
    Rule("reg-untested-registry-name", "conformance",
         "registered fault point or metric name not named by any test"),
    Rule("reg-unregistered-program-rule", "conformance",
         'Rule("prog-...") in the catalog not listed in the pinned '
         "REGISTERED_PROGRAM_RULES registry (analysis/program_lint.py)"),
    Rule("reg-unimplemented-program-rule", "conformance",
         "REGISTERED_PROGRAM_RULES entry with no Rule(...) catalog "
         "definition — a pinned program rule nothing implements"),
    # ---- pass 4: program lint (one eager call's recorded op stream) ----
    Rule("prog-fp32-matmul-under-policy", "program",
         "aten mm/addmm/bmm/linear/convolution op, or a hand-kernel "
         "launch, in f32 (or on a kernel's \"simple\" route) inside a "
         "program whose declared precision_policy is bf16/f16 — the "
         "tensor cores run at a fraction of their rate and the policy is "
         "silently violated"),
    Rule("prog-unhonored-donation", "program",
         "argument declared updated in place whose storage changed, or "
         "that was copied whole, during the call — the caller's buffer "
         "is not the one updated, and the copy doubles its memory"),
    Rule("prog-transpose-churn", "program",
         "permute/contiguous/clone/copy bytes above threshold in the "
         "recorded program — layout thrash burning memory bandwidth "
         "the roofline charges to the model"),
    Rule("prog-hidden-host-transfer", "program",
         "aten._local_scalar_dense (a host read), a data-dependent-shape "
         "op or a copy to the CPU inside a hot program — every call "
         "blocks the host on the device"),
    Rule("prog-dead-output", "program",
         "computed program output no caller consumes — the program "
         "pays flops and memory for a value that is dropped on the "
         "floor"),
    Rule("prog-excess-padding", "program",
         "serving pow2 bucket fill ratio below threshold — most of "
         "every dispatched batch is padding, so the tensor cores run "
         "mostly dead rows"),
    Rule("prog-unsharded-optimizer-state", "program",
         "ZeRO-1 program whose per-rank optimizer state is larger than "
         "the MeshManager plan's slice — the state is silently "
         "replicated, n x the promised memory"),
    # ---- runtime sanitizers (DL4J_TPU_SANITIZE=locks) ----
    Rule("san-lock-order-cycle", "runtime",
         "cyclic lock-acquisition order observed across threads — a "
         "potential deadlock (A held while taking B, elsewhere B held "
         "while taking A)"),
    Rule("san-long-held-lock", "runtime",
         "lock held longer than the sanitizer threshold — a blocking "
         "operation is living inside a critical section"),
]

RULES: Dict[str, Rule] = {r.id: r for r in _RULE_LIST}


@dataclass
class Finding:
    rule: str
    file: str               # repo-relative posix path
    line: int
    message: str            # MUST NOT embed line numbers (fingerprint)
    symbol: str = ""        # enclosing function qualname, "" at module level

    def fingerprint(self) -> str:
        raw = f"{self.rule}|{self.file}|{self.symbol}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.file}:{self.line}: {self.rule}{sym} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "fingerprint": self.fingerprint()}


# ------------------------------------------------------------- baseline
@dataclass
class Baseline:
    entries: List[dict] = field(default_factory=list)

    @classmethod
    def load(cls, path) -> "Baseline":
        with open(path) as f:
            data = json.load(f)
        return cls(entries=list(data.get("suppressions", [])))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"version": 1,
                       "note": "pre-existing findings of the port's "
                               "analyzer, suppressed pending burn-down "
                               "(each with its reason); new violations "
                               "fail tier-1",
                       "suppressions": self.entries}, f, indent=2,
                      sort_keys=False)
            f.write("\n")

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      reasons: Dict[str, str] = None) -> "Baseline":
        """A baseline of `findings`; `reasons` ({fingerprint: reason})
        keeps the reasons of the entries it had."""
        out = []
        for f in findings:
            e = f.to_dict()
            if reasons and e["fingerprint"] in reasons:
                e["reason"] = reasons[e["fingerprint"]]
            out.append(e)
        return cls(entries=out)

    def reasons(self) -> Dict[str, str]:
        return {e["fingerprint"]: e["reason"] for e in self.entries
                if e.get("reason")}

    def apply(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """Split findings into (new, suppressed) and report stale
        baseline entries. Multiplicity-aware: two identical findings
        need two baseline entries."""
        budget: Dict[str, int] = {}
        for e in self.entries:
            budget[e["fingerprint"]] = budget.get(e["fingerprint"], 0) + 1
        new, suppressed = [], []
        for f in findings:
            fp = f.fingerprint()
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                suppressed.append(f)
            else:
                new.append(f)
        stale = []
        for e in self.entries:
            if budget.get(e["fingerprint"], 0) > 0:
                budget[e["fingerprint"]] -= 1
                stale.append(e)
        return new, suppressed, stale


def parse_pragmas(text: str) -> Dict[int, set]:
    """Map 1-based line number -> set of allowed rule ids."""
    allow: Dict[int, set] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = PRAGMA_RE.search(line)
        if m:
            allow[i] = {r.strip() for r in m.group(1).split(",")
                        if r.strip()}
    return allow


def pragma_allows(allow: Dict[int, set], line: int, rule: str) -> bool:
    """A pragma on the flagged line, or on the line directly above it,
    sanctions the site."""
    return (rule in allow.get(line, ()) or
            rule in allow.get(line - 1, ()))
