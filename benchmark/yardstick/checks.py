"""The numbers that decide `correct`, each a gap between the program and
the float32 reference, and their limits (set per cell in
`workloads/<cell>.json` under `limits`, from the readings PERF.md
gives).

Training (traffic/train.py): the relative loss gap of the worst checked
step whose loss the program gives (`loss_gap`); for the norms of the
first step's gradient (as the optimizer holds it after one step), of the
parameters' change after the checked steps and of the BatchNorm
statistics' change, the gap between the program's and the reference's
norm of each leaf against the reference's norm of that leaf or of the
median leaf, whichever is larger, taken at the worst leaf (`grad_gap`,
`change_gap`, `stats_gap`) and at the median leaf (`*_median_gap`).
Leaves whose reference gradient is under a thousandth of the median
leaf's (a convolution's bias under BatchNorm, which the normalization
cancels) move by rounding alone and are left out of the gradient and
change gaps by that rule.
"""

from __future__ import annotations

import math
import statistics

EXCLUDE_BELOW = 1e-3


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """{leaf: |prog norm - ref norm| / max(ref norm, median ref norm)}
    (NaN where the program lacks the leaf)."""
    keys = list(keys)
    if not keys:
        return {}
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def _worst(gaps: dict) -> float:
    if not gaps or any(g != g for g in gaps.values()):
        return math.inf
    return max(gaps.values())


def _top(gaps: dict, prog: dict, ref: dict, n: int = 6) -> list:
    return [[".".join(k), round(g, 5), prog.get(k), ref[k]]
            for k, g in sorted(gaps.items(), key=lambda kv: -kv[1]
                               if kv[1] == kv[1] else -math.inf)[:n]]


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog/ref: {"losses": [...], "grad", "change", "stats": {leaf:
    norm}}."""
    g = ref["grad"]
    med = statistics.median(g.values())
    kept = [k for k, v in g.items() if v >= EXCLUDE_BELOW * med]
    read = [(a, b) for a, b in zip(prog["losses"], ref["losses"])
            if a is not None]
    losses = [abs(a - b) / abs(b) if b else math.inf for a, b in read]
    if len(prog["losses"]) != len(ref["losses"]) or any(
            a != a for a, _ in read):
        losses.append(math.inf)
    gaps = {"grad": leaf_gaps(prog["grad"], g, kept),
            "change": leaf_gaps(prog["change"], ref["change"], kept),
            "stats": leaf_gaps(prog["stats"], ref["stats"],
                               ref["stats"].keys())}
    numbers = {"loss_gap": max(losses) if losses else math.inf}
    for k, v in gaps.items():
        numbers[f"{k}_gap"] = _worst(v)
        numbers[f"{k}_median_gap"] = (statistics.median(v.values())
                                      if _worst(v) < math.inf else math.inf)
    notes = {"excluded_leaves": len(g) - len(kept), "leaves": len(g),
             "loss_gaps": losses,
             "losses_missing": len(prog["losses"]) - len(read),
             "worst_leaves": {k: _top(v, prog[k], ref[k])
                              for k, v in gaps.items()}}
    return numbers, notes


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the cell limits is there, finite and within its
    limit. The cell's `limits` name the numbers it compares; the others
    are reported, not compared (PERF.md says why for each cell)."""
    return all(k in numbers and numbers[k] == numbers[k]
               and numbers[k] <= v for k, v in limits.items())
