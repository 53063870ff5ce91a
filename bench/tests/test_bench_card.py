"""On the card: one short run of each cell prints a whole result line
(run on the chip with ``python -m pytest bench/tests -m cuda``)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_prints_a_result_line(card, cell):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "10", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]
