"""Finds everything a run needs by the names in BENCHMARK.json: the cell,
its configuration file, its traffic file (benchmark/traffic/<name>.json)
and the reader of each metric (benchmark/metrics/<name>.py). Adding a
cell, a configuration, a traffic mix or a metric adds files and entries
and edits none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    moves: Optional[str] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    config_dir: Path
    traffic_name: str
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries, cell: str) -> List[Metric]:
    out = []
    for m in entries:
        metric = Metric(name=m["name"], unit=m["unit"], better=m["better"],
                        source=m["source"], workloads=m.get("workloads"),
                        moves=m.get("moves"))
        if metric.applies(cell):
            out.append(metric)
    return out


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def resolve(cell_name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell of that name with its configuration, traffic and the
    metrics it reports. Raises KeyError for an unknown cell."""
    man = manifest if manifest is not None else load_manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in man["configs"]}
    cfg_file = ROOT / configs[w["config"]]["file"]
    with open(cfg_file) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    return Cell(name=cell_name, chips=int(w["chips"]),
                config_name=w["config"], config=config,
                config_dir=cfg_file.parent, traffic_name=w["traffic"],
                traffic=traffic,
                end_to_end=_metrics(man["end_to_end"], cell_name),
                per_layer=_metrics(man["per_layer"], cell_name))


def reader(name: str) -> Callable:
    """`read(view)` of benchmark/metrics/<name>.py: the metric's value from
    a finished run, or None when the run holds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


