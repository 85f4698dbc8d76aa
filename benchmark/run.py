"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is `workloads/<cell>.json`; its configuration, traffic driver
and per-layer readers are found by name (yardstick/manifest.py). With
--trace 0 the line carries the cell's end-to-end metrics; with --trace 1
its per-layer metrics, read from a profiled sub-window after the timed
window, with the device's busy and window seconds and a breakdown. Both
decide `correct` by comparing what the timed path produced with the
float32 reference (yardstick/checks.py), and print each compared number
beside its limit: last on standard error, and last in the line
(`checks`).

Exits non-zero, printing no result, where CUDA is unavailable or the
cell needs more cards than are visible, and where a module of JAX or of
the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
for _p in (str(CHECKOUT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from yardstick import checks, device, manifest  # noqa: E402


def cache_dirs(root: Path = CHECKOUT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own CUDA kernels build into its package's `_build/`)."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def context(wl, cfg, seed, seconds, trace, dev, t_start, hooks=None):
    ref = manifest.reference(cfg["reference"])
    return types.SimpleNamespace(
        wl=wl, cfg=cfg, seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=dev, t_start=t_start,
        nodes=ref.build(cfg), small_gamma=ref.small_gamma,
        hooks=hooks or {})


def run_cell(wl, cfg, seed, seconds, trace, dev, t_start, hooks=None):
    """The traffic driver's result for one run (see traffic/*.py)."""
    ctx = context(wl, cfg, seed, seconds, trace, dev, t_start, hooks)
    res = manifest.traffic(wl["traffic"]).run(ctx)
    res["correct"] = (checks.judge(res["numbers"], wl["limits"])
                      and res["failed"] == 0)
    return res


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def result_line(wl, res, trace, e2e_names, per_layer_names, units,
                facts, power_w):
    """The result's JSON object, `checks` last."""
    metrics = {}
    if trace:
        for name in per_layer_names:
            mod = manifest.metric(name)
            v = mod.read(res["run"])
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        values = dict(res["end_to_end"], setup_s=res["setup_s"])
        for name in e2e_names:
            metrics[name] = {"value": _finite(values[name]),
                             "unit": units[name]}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": facts}
    t = res["run"].get("trace")
    if trace and t:
        line["device"] = dict(facts, busy_s=t["busy_s"],
                              window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["power_limit_w"] = power_w
    checked = {k: {"value": _finite(res["numbers"].get(k)), "limit": v}
               for k, v in wl["limits"].items()}
    checked["failed"] = {"value": int(res["failed"]), "limit": 0}
    line["checks"] = checked
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    wl = manifest.workload(args.workload)
    cfg = manifest.config(wl["config"])
    torch = device.require_cards(wl["chips"])
    e2e, per_layer = manifest.declared(args.workload)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    res = run_cell(wl, cfg, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0), T_START)
    line = result_line(wl, res, args.trace, e2e, per_layer, units,
                       device.facts(wl["chips"], res["memory_peak_bytes"]),
                       device.power_limit_w())
    bad = device.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(json.dumps({"numbers": res["numbers"],
                      "notes": res.get("notes", {})}, default=str),
          file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
