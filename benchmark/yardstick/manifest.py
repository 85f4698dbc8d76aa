"""Find cells, configurations, traffic drivers, per-layer readers and
references by name, as files under the benchmark's folder:

  workloads/<cell>.json    {config, traffic, chips, why, params, limits}
  configs/<config>.json    sizes, source, `reduced`, `assumed`, how the
                           program builds it (`program`)
  traffic/<kind>.py        `END_TO_END` (the metrics it reports) and
                           `run(ctx)`
  metrics/<metric>.py      LAYER, UNIT, SOURCE, MOVES, BETTER, `read(run)`
  reference/<name>.py      `build(cfg)` -> node list
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
WORKLOAD_KEYS = {"config", "traffic", "chips", "why", "params", "limits"}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str):
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = f"benchmark_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, root: Path = ROOT) -> dict:
    wl = _json(root / "workloads" / f"{name}.json")
    missing = WORKLOAD_KEYS - set(wl)
    if missing:
        raise ValueError(f"workload {name}: missing keys {sorted(missing)}")
    return dict(wl, name=name)


def workload_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(kind: str, root: Path = ROOT):
    return _module(root / "traffic" / f"{kind}.py", "traffic")


def reference(name: str, root: Path = ROOT):
    return _module(root / "reference" / f"{name}.py", "reference")


def metric_names(root: Path = ROOT) -> list:
    return sorted(p.name[:-3] for p in (root / "metrics").glob("*.py")
                  if not p.name.startswith("_"))


def metric(name: str, root: Path = ROOT):
    return _module(root / "metrics" / f"{name}.py", "metric")


def declared(cell: str, bench: Path = CHECKOUT / "BENCHMARK.json"):
    """(end-to-end names, per-layer names) that BENCHMARK.json asks of
    `cell`: a metric with `workloads` where that list names the cell,
    a per-layer metric without it where the cell reports its `moves`."""
    b = _json(bench)
    e2e = [m["name"] for m in b["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per_layer = [m["name"] for m in b["per_layer"]
                 if cell in m.get("workloads", [cell])
                 and m["moves"] in e2e]
    return e2e, per_layer
