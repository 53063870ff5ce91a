"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
references import nothing of the port; without a card, or in a
directory that holds only the benchmark, a run fails with no result."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        got = set(_imports(f)) & BANNED
        assert not got, (f, got)


def test_the_references_import_nothing_of_the_port():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert "repro_torch" not in set(_imports(f)), f


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "olmoe-widths-capdrop.reasoning", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        env=env, timeout=300)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_in_a_directory_of_the_benchmark_alone_a_run_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
