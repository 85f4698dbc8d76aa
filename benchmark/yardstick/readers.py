"""What the per-layer readers (metrics/<metric>.py) share. A reader
gets the run's record and returns a number, or None where its run has
nothing for it to read (the harness then leaves the metric out).

The record: `kind` (the traffic's, "train"), `nodes` (the reference's
node list), `params` (the cell's parameters), `window` (the timed
window: seconds, steps, images) and, in a --trace 1 run, `trace`
(yardstick/trace.py's summary of the traced sub-window, plus its
`steps` and `images`, the program's kernel `launches` counted over it,
and its `pipeline` counters)."""

from __future__ import annotations

from yardstick import flops, peaks


def traced(run, kind):
    t = run.get("trace")
    return t if run.get("kind") == kind and t else None


def hand_kernel_s(t, direction=None) -> float:
    """Device seconds of the hand-written kernels (of one direction)."""
    return sum(v for k, v in t["kernel_s"].items()
               if flops.kernel_direction(k) is not None
               and direction in (None, flops.kernel_direction(k)))


def roofline(run, direction) -> float | None:
    """Σ bound / Σ device time of the hand-written kernels of one
    direction over the traced sub-window, in %; None where the program's
    launch counts differ from the calls the configuration's shapes give
    (the shares would then be of other work) or where none ran."""
    t = run["trace"]
    n = t["steps"]
    w = flops.hand_kernel_work(run["nodes"], run["params"]["batch"],
                               train=True)[direction]
    bound = w["bound_s"] * n
    want = {kernel: c * n for kernel, c in w["calls"].items()}
    if not want or any(t["launches"].get(k) != v for k, v in want.items()):
        return None
    spent = hand_kernel_s(t, direction)
    return 100.0 * bound / spent if spent > 0 else None


def glue_ms(run) -> float | None:
    t = run["trace"]
    n = t["steps"]
    if not n:
        return None
    return 1e3 * (t["busy_s"] - hand_kernel_s(t)) / n


def idle_share(run) -> float | None:
    t = run["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run) -> float | None:
    """images x 3 x 2 x forward multiply-adds over the window, against
    the bf16 peak, in %."""
    w = run["window"]
    images = w["images"]
    if not images or w["seconds"] <= 0:
        return None
    return 100.0 * images * 3 * 2 * flops.forward_macs(run["nodes"]) \
        / w["seconds"] / peaks.BF16_FLOPS
