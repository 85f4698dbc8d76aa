#!/usr/bin/env python3
"""dl4j-analyze-torch CLI — static invariant checker for
deeplearning4j_tpu_torch (the port), beside tools/analyze.py.

Zero-dependency by default: loads ONLY deeplearning4j_tpu_torch/analysis/*
(stdlib + ast), never the package __init__ (which would pull in torch).
The analyzed code is parsed, not imported, so this runs in about a
second in a bare interpreter:

    python tools/analyze_torch.py            # whole tree vs the baseline
    python tools/analyze_torch.py --diff     # only files changed vs HEAD
    python tools/analyze_torch.py --rules    # rule catalog (+ JAX ids)
    python tools/analyze_torch.py --catalog  # thread/lock census
    python tools/analyze_torch.py --programs # pass 4: the program lint

`--programs` is the one mode that DOES import torch: it builds the
representative program set on the CPU (analysis/programs.py, one of
them a 2-rank gloo gang of CPU processes) and lints one eager call of
each against its declared precision policy, in-place arguments,
consumed outputs, bucket fill and ZeRO-1 plan
(analysis/program_lint.py), in under 60 s.

Exit codes: 0 clean (vs tools/analyze_torch_baseline.json), 1 new
findings, 2 usage error.
"""

import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "deeplearning4j_tpu_torch"


def _load_analysis_package():
    """Import deeplearning4j_tpu_torch.analysis WITHOUT executing the
    heavy package __init__: register a stub parent whose __path__ points
    at the real directory, then import the subpackage normally."""
    if PKG not in sys.modules:
        stub = types.ModuleType(PKG)
        stub.__path__ = [str(ROOT / PKG)]
        sys.modules[PKG] = stub
    from deeplearning4j_tpu_torch.analysis import runner
    return runner


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if "--programs" in sys.argv[1:]:
        # program mode executes the real package (it builds nets, a
        # serving front-end and a gloo gang) on the CPU
        from deeplearning4j_tpu_torch.analysis import runner
    else:
        runner = _load_analysis_package()
    sys.exit(runner.main())
