"""Find a cell's configuration, traffic and metric readers by name.

``BENCHMARK.json`` names every cell, configuration and metric.  Each
lives in a file of its own, found by that name:

* ``bench/configs/<config>.json`` (the ``file`` of the configuration),
* ``bench/traffic/<cell>.json``,
* ``bench/metrics/<metric>.py`` with ``read(record) -> float | None``,
* ``bench/reference/<family>.py`` with ``logits(...)``.

A later cell, metric or configuration is added as files and entries; no
file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{name}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(work["chips"]),
                end_to_end=[m for m in spec["end_to_end"] if _listed(m, name)],
                per_layer=[m for m in spec["per_layer"] if _listed(m, name)])


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH
                  ) -> Callable[[object], Optional[float]]:
    """``read`` of ``bench/metrics/<name>.py``."""
    return _load_module(bench / "metrics" / f"{name}.py").read


def reference(family: str):
    """The plain reference module of one model family,
    ``bench/reference/<family>.py``."""
    return importlib.import_module(f"reference.{family}")


def read_metrics(metrics: List[dict], record) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something to read; a reader that returns None leaves its metric out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
