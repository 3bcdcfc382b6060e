"""Find a cell's files by the names `BENCHMARK.json` gives them.

A cell (an entry of `workloads`) names a configuration (an entry of
`configs`, whose `file` holds its sizes and serving settings) and a
traffic mix (`portbench/traffic/<traffic>.json`).  Each metric is read by
`portbench/metrics/<name>.py`, a module with `read(ctx) -> float | None`.
Nothing here knows a cell, a mix or a metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str]          # per-layer metrics only
    workloads: Optional[List[str]]
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict                  # the configuration file
    traffic_name: str
    traffic: dict                 # the traffic mix file
    end_to_end: List[Metric]      # the metrics this cell reports
    per_layer: List[Metric]


def _load_reader(name: str, pkg: Path) -> Callable:
    path = pkg / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: List[dict], cell: str, pkg: Path) -> List[Metric]:
    out = []
    for m in entries:
        if m.get("workloads") is not None and cell not in m["workloads"]:
            continue
        out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                          m.get("layer"), m.get("workloads"),
                          _load_reader(m["name"], pkg)))
    return out


def load_cell(workload: str, root: Path, pkg: Path = HERE) -> Cell:
    """The cell named `workload` of `root/BENCHMARK.json`, its mix and
    metric readers from `pkg` (this package's folder)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (pkg / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=w["name"], chips=int(w["chips"]),
                config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                end_to_end=_metrics(bench["end_to_end"], w["name"], pkg),
                per_layer=_metrics(bench["per_layer"], w["name"], pkg))


def read_metrics(metrics: List[Metric], ctx) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read; a reader that finds nothing returns None and its
    metric is left out."""
    out = {}
    for m in metrics:
        v = m.read(ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out
