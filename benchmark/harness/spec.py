"""What a run reads: ``BENCHMARK.json`` at the root of the checkout, the
cell's configuration file (its ``file``) and its traffic file
(``benchmark/traffic/<traffic>.json``).  Everything is found by the names
``BENCHMARK.json`` gives, so a new cell, configuration, traffic mix or
metric is a new entry and new files, never an edit."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""
    workloads: List[str] = field(default_factory=list)
    bound: float = 0.0

    def reported_in(self, cell: str) -> bool:
        return not self.workloads or cell in self.workloads


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" /
                        f"{w['traffic']}.json")
    e2e = [Metric(**m) for m in spec["end_to_end"]]
    layer = [Metric(**m) for m in spec["per_layer"]]
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in e2e if m.reported_in(name)],
                per_layer=[m for m in layer if m.reported_in(name)])
