"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
given in ``configs``, and a traffic mix,
``perfbench/traffic/<traffic>.json``, whose ``loop`` names the module
that runs it, ``perfbench/loops/<loop>.py``.  Each metric is read by
``perfbench/metrics/<name>.py``; a cell's limits for ``correct`` are
``perfbench/limits/<cell>.json``.  Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    root: Path = field(default=ROOT)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark's, loaded from its file by path (its name
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + re.sub(r"\W", "_", name), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reported(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    limits_path = root / "perfbench" / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, w, config, traffic, e2e, per_layer, limits, root)


def loop(cell_: Cell):
    kind = cell_.traffic["loop"]
    return load_module(cell_.root / "perfbench" / "loops" / f"{kind}.py",
                       "loop_" + kind)


def reader(cell_: Cell, metric: str):
    return load_module(cell_.root / "perfbench" / "metrics" / f"{metric}.py",
                       "metric_" + metric)
