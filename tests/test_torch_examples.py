"""The port's three examples and its prefix-cache smoke on the CPU.

Each example runs as a subprocess with ``--device cpu --reduced`` (the
card's runs are ``chip_smoke.py``'s ``examples`` phase).  The prefix
smoke's ``drive`` runs on an engine whose weights are bridged from the
reference script's own init, and its counters and served tokens must equal
the reference script's run.
"""
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
EXAMPLES = ("torch_quickstart", "torch_autotune_and_serve",
            "torch_train_with_failure_recovery")
TABLE = os.path.join(SRC, "repro_torch", "tuned", "h100.json")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(example, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_TORCH_HARDWARE", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", f"{example}.py"),
         "--device", "cpu", "--reduced", *args], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=240)


def _table_hash():
    with open(TABLE, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_quickstart_tunes_trains_and_serves():
    proc = _run("torch_quickstart")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert re.search(r"the registry now resolves 4096\^3: \S+ \(exact\)",
                     out), out
    losses = [float(x) for x in re.findall(r"loss (\S+)", out)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    tokens = json.loads(out.split("[serve] generated: ")[1].splitlines()[0])
    assert [len(t) for t in tokens] == [8, 8]
    assert all(0 <= t < 256 for row in tokens for t in row)


def test_autotune_resolves_every_lookup_exact_and_leaves_the_table():
    before = _table_hash()
    proc = _run("torch_autotune_and_serve")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "persisted and reloaded 2 tuned entries" in out
    lookups = re.findall(r"\[serve\]   (decode GEMM|prefill flash) +(\S+) "
                         r"-> \S+ \((\w+)\)", out)
    assert {k for k, _s, _src in lookups} == {"decode GEMM",
                                              "prefill flash"}
    assert all(src == "exact" for _k, _s, src in lookups), lookups
    assert _table_hash() == before


def test_recovery_replays_bit_for_bit(tmp_path):
    proc = _run("torch_train_with_failure_recovery", "--ckpt-dir",
                str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "latest checkpoint: step 10" in proc.stdout
    assert "max param diff after resumed run: 0.00e+00" in proc.stdout
    assert sorted(os.listdir(tmp_path))


@pytest.mark.parametrize("name", EXAMPLES + ("torch_prefix_cache_smoke",))
def test_entry_refuses_without_a_card_unless_asked(monkeypatch, capsys,
                                                   name):
    folder = "scripts" if name.endswith("smoke") else "examples"
    mod = _load(os.path.join(REPO, folder, f"{name}.py"), f"_t_{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the prefix smoke against the reference script
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_smoke(tmp_path_factory):
    """The reference script's own run: its stats JSON and every pass's
    served tokens (its ``_drive`` wrapped to record them)."""
    ref = _load(os.path.join(REPO, "scripts", "prefix_cache_smoke.py"),
                "_ref_prefix_smoke")
    served = []
    real = ref._drive

    def recording(eng, prompts):
        results = real(eng, prompts)
        served.append([list(r.tokens) for r in results])
        return results
    ref._drive = recording
    out = tmp_path_factory.mktemp("ref_smoke") / "stats.json"
    argv = sys.argv
    sys.argv = ["prefix_cache_smoke.py", "--json", str(out)]
    try:
        assert ref.main() == 0
    finally:
        sys.argv = argv
    return ref, json.loads(out.read_text()), served


def test_prefix_smoke_equals_the_reference_scripts(reference_smoke):
    ref, ref_stats, ref_served = reference_smoke
    port = _load(os.path.join(REPO, "scripts", "torch_prefix_cache_smoke.py"),
                 "_port_prefix_smoke")
    for name in ("PAGE", "PREFIX_LENGTHS", "N_REQUESTS", "MAX_NEW", "SEED",
                 "ARCH"):
        assert getattr(port, name) == getattr(ref, name), name
    from repro.configs.catalog import ARCHITECTURES as JAX_ARCHS
    from repro.models import build_model as jax_build_model
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.models import build_model, params_from_numpy

    jcfg = JAX_ARCHS[ref.ARCH].reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    cfg = ARCHITECTURES[port.ARCH].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg)
    eng = port.make_engine(params, model, "cpu")
    failures, served = port.drive(eng, cfg.vocab_size, log=lambda _m: None)
    assert failures == []
    assert eng.stats()["prefix_cache"] == ref_stats["prefix_cache"]
    assert served == ref_served
    assert ref_stats["prefix_cache"]["cached_tokens_served"] == 420


def test_prefix_smoke_script_passes_and_writes_stats(tmp_path):
    port = _load(os.path.join(REPO, "scripts", "torch_prefix_cache_smoke.py"),
                 "_port_prefix_smoke_main")
    out = tmp_path / "stats.json"
    assert port.main(["--device", "cpu", "--json", str(out)]) == 0
    pc = json.loads(out.read_text())["prefix_cache"]
    assert (pc["hits_full"], pc["hits_partial"], pc["inserts"]) == (12, 12,
                                                                   24)
