"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run quietly on the CPU when no card is present."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, "jax was imported"
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
print(len(names))
"""

# `import jax`, `from jax...`, `import repro` / `repro.x`, `from repro(.x) import`
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def test_every_module_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip()) >= 20     # every subpackage was walked


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PORT.rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_source_has_no_jax_or_reference_import(path):
    src = (REPO / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.serve import Engine", "from repro import x",
                 "import repro"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import matmul",
                 "import jaxlib_free_module"):
        assert not _FORBIDDEN.search(line), line


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.serve import Engine, ServeConfig

    model = build_model(get_config("llama3.2-1b").reduced())
    params = model.init(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": [1.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)


def test_cpu_engine_is_only_by_request():
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    model = build_model(get_config("llama3.2-1b").reduced())
    params = model.init(0, device="cpu")
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=32,
                                            device="cpu"))
    assert eng.device.type == "cpu"
    assert eng.generate([[1, 2, 3]], 2) and eng.stats()["chunks"] == 1
