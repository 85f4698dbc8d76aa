"""dl4j-analyze for the port: static invariant checker + program lint +
runtime sanitizers (counterpart of deeplearning4j_tpu/analysis).

Three static passes (AST-only — analyzed code is parsed, never
imported), a program pass (the one pass that imports torch, only when
invoked), plus an opt-in runtime lock-order sanitizer:

  jit          host syncs on the step/serving hot paths and CUDA-graph
               hygiene of run_group's captured body
  concurrency  thread/lock discipline + the thread/lock catalog
  conformance  fault-point / metric / program-rule registries,
               swallow discipline, test coverage of registered names
  programs     one eager call of each registered program recorded op by
               op (a TorchDispatchMode plus the hand kernels' launches
               by route and dtype): declared precision policy vs the
               matmul dtypes and kernel routes, in-place arguments,
               transpose churn, hidden host transfers, dead outputs,
               serving bucket fill, ZeRO-1 state size
               (program_lint.py, `--programs` mode)

Entry points:

  python tools/analyze_torch.py            # full run vs the baseline
  python tools/analyze_torch.py --diff     # changed files only
  python tools/analyze_torch.py --rules    # the rule catalog
  python tools/analyze_torch.py --programs # program lint (torch, CPU)
  DL4J_TPU_SANITIZE=locks + install_from_env()  # lock-order sanitizer

Module scope stays import-light everywhere (program_lint included) so
the default analyzer still runs in a bare interpreter without torch.
"""

from deeplearning4j_tpu_torch.analysis.findings import (  # noqa: F401
    RULES,
    Baseline,
    Finding,
    Rule,
)
from deeplearning4j_tpu_torch.analysis.program_lint import (  # noqa: F401
    REGISTERED_PROGRAM_RULES,
    ProgramRecord,
    Thresholds,
)
from deeplearning4j_tpu_torch.analysis.runner import (  # noqa: F401
    AnalysisResult,
    analyze,
    main,
)
from deeplearning4j_tpu_torch.analysis.sanitizers import (  # noqa: F401
    LockOrderSanitizer,
    active_sanitizer,
    install_from_env,
)

__all__ = [
    "RULES", "Rule", "Finding", "Baseline", "AnalysisResult",
    "analyze", "main", "LockOrderSanitizer", "active_sanitizer",
    "install_from_env", "ProgramRecord", "Thresholds",
    "REGISTERED_PROGRAM_RULES",
]
