"""BENCHMARK.json against the contract's limits, and cells, traffic,
configurations and metric readers found by name."""
from __future__ import annotations

import json
import re
import shutil

from conftest import BENCH, ROOT
from harness import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and 1 <= spec["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in spec["command"])
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['name']}.json").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= set(cells)
        names.add(m["name"])
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for cell in cells:
        got = catalog.find_cell(cell)
        reported = {m["name"] for m in got.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert got.per_layer
        for m in got.per_layer:
            mv = next(x for x in spec["end_to_end"] if x["name"] == m["moves"])
            assert cell in mv.get("workloads", [cell])
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_new_cell_metric_and_config_are_found_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    cfg = json.loads(
        (BENCH / "configs" / "olmoe-widths-capdrop.json").read_text())
    (tmp_path / "bench" / "configs" / "new-model.json").write_text(
        json.dumps(dict(cfg, name="new-model")))
    spec["configs"].append({"name": "new-model", "source": "x",
                            "file": "bench/configs/new-model.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new-model.chat", "config": "new-model",
                              "traffic": "chat", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric", "unit": "%",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "bench" / "traffic" / "new-model.chat.json").write_text(
        json.dumps({"clients": 3, "check": {}}))
    (tmp_path / "bench" / "metrics" / "new_metric.py").write_text(
        "def read(r):\n    return 42.0\n")
    cell = catalog.find_cell("new-model.chat", root=tmp_path,
                             bench=tmp_path / "bench")
    assert cell.config["name"] == "new-model"
    assert cell.traffic["clients"] == 3
    assert "new_metric" in {m["name"] for m in cell.per_layer}
    read = catalog.metric_reader("new_metric", bench=tmp_path / "bench")
    assert read(None) == 42.0


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    metrics = [{"name": "mfu.decode", "unit": "%"},
               {"name": "setup_s", "unit": "s"}]

    class R:
        trace = None
        setup_s = 12.5
    got = catalog.read_metrics(metrics, R())
    assert got == {"setup_s": {"value": 12.5, "unit": "s"}}
