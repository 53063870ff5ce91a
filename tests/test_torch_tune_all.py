"""``scripts/torch_tune_all.py`` against the reference's
``scripts/tune_all.py``: the forward capture of every catalog architecture
at full width (b = 4, s = 4096, fake tensors) gives the reference's
``(m, k, n)`` set, architecture by architecture (42 unique shapes over the
10); every backward product is the dX or dW of a forward product, laid out
as ``_gemm_op_backward`` runs it; the flash problems are the reference's 20;
and a model-mode run writes a table that loads strictly, without JAX or
the reference package in the process.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES as REF_ARCHS  # noqa: E402
from repro.core import capture_gemm_shapes as ref_capture  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES  # noqa: E402
from repro_torch.core import registry, tuning_db  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_tune_all.py"


@pytest.fixture(scope="module")
def tune_all():
    spec = importlib.util.spec_from_file_location("torch_tune_all",
                                                  str(SCRIPT))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def captured(tune_all):
    """``tune_all.capture`` of an architecture, forward and backward, run
    once a module."""
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = tune_all.capture(ARCHITECTURES[arch])
        return memo[arch]
    return get


def _reference_shapes(name):
    """The reference script's capture (``scripts/tune_all.py:24-33``)."""
    model = ref_build(REF_ARCHS[name])
    batch = {"tokens": jax.ShapeDtypeStruct((4, 4096), jnp.int32)}
    batch.update(model.extra_inputs(4))
    with ref_capture() as shapes:
        jax.eval_shape(lambda p, bt: model.forward(p, bt), model.abstract(),
                       batch)
    return shapes


@pytest.fixture(scope="module")
def forward(tune_all):
    """{arch: (the port's forward calls, the reference's shapes)}."""
    return {name: (tune_all.capture(cfg, backward=False)[0],
                   _reference_shapes(name))
            for name, cfg in ARCHITECTURES.items()}


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_forward_capture_is_the_references_per_architecture(forward, arch):
    calls, ref = forward[arch]
    assert sorted({c[:3] for c in calls}) == sorted(set(ref))
    assert len(calls) >= len(ref)         # the reference scans its layers
    assert all(c[4] in (torch.bfloat16, torch.float32) for c in calls)


def test_forward_union_is_the_references_42_shapes(forward, tune_all):
    ours = {c[:3] for calls, _ in forward.values() for c in calls}
    assert ours == {s for _, ref in forward.values() for s in ref}
    assert len(ours) == 42
    problems = tune_all.gemm_problems(
        [c for calls, _ in forward.values() for c in calls], [])
    assert {p[1][:3] for p in problems} == ours
    assert {p[0] for p in problems} == {torch.bfloat16}


def test_flash_problems_are_the_references_20(tune_all):
    """``scripts/tune_all.py:43-47``: every head dim x the prefill
    buckets."""
    dims = sorted({c.resolved_head_dim for c in REF_ARCHS.values()
                   if c.num_heads})
    want = sorted({(s, s, d) for d in dims
                   for s in (128, 512, 1024, 2048, 4096)})
    assert tune_all.flash_problems(ARCHITECTURES.values()) == want
    assert len(want) == 20 and dims == [64, 80, 128, 160]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama-3.2-vision-11b"])
def test_backward_products_are_dx_and_dw_of_forward_products(tune_all,
                                                             captured, arch):
    """dX = dZ @ w.T (M, N, K), the weight read K-major; dW = x.T @ dZ
    (K, M, N), x.T copied row-major and a bf16 M padded to a multiple of 8
    (the vlm's cross K/V over 4 x 1601 image tokens); the unembed's pair
    is f32 (its cotangent is), the rest bf16.  Every forward product has
    its dW; a dX is missing only where the input needs no gradient (the
    image embeddings)."""
    cfg = ARCHITECTURES[arch]
    fwd, bwd = captured(arch)
    fwd_shapes = {c[:3] for c in fwd}
    unembed = (4 * 4096, cfg.d_model, cfg.vocab_size)
    assert unembed in fwd_shapes
    dx = {(m, n, k) for m, k, n in fwd_shapes}
    dw = {(k, m + (-m % 8), n) for m, k, n in fwd_shapes}
    f32 = sorted(c[:3] for c in bwd if c[4] == torch.float32)
    m, k, n = unembed
    assert f32 == sorted([(m, n, k), (k, m, n)])
    for m_, k_, n_, kmajor, out in bwd:
        assert (m_, k_, n_) in dx | dw, (m_, k_, n_)
        if (m_, k_, n_) in dw - dx:
            assert not kmajor
        elif out == torch.bfloat16:
            assert kmajor                  # w.t() of a row-major weight
    assert dw <= {c[:3] for c in bwd}
    missing_dx = dx - {c[:3] for c in bwd}
    if arch == "llama-3.2-vision-11b":
        assert missing_dx == {(6404, 1024, 4096)}
        assert (4096, 6408, 1024) in {c[:3] for c in bwd}
    else:
        assert missing_dx == set()
    problems = tune_all.gemm_problems(fwd, bwd)
    assert {p[0] for p in problems if p[1][:3] in f32} == {torch.float32}
    assert len({p[1][:3] for p in problems}) == len(fwd_shapes | {
        c[:3] for c in bwd})


def test_model_mode_run_writes_a_table_that_loads_strictly(tmp_path,
                                                          tune_all, captured):
    """``--mode model --arch llama3.2-1b --db-dir tmp`` in a fresh
    process that never imports JAX or the reference package: every
    captured problem and llama's flash problems land as entries the
    registry resolves ``exact``; measure mode needs the card."""
    run = ("import runpy, sys; sys.argv = [sys.argv[1]] + sys.argv[2:]; "
           "code = 0\n"
           "try:\n    runpy.run_path(sys.argv[0], run_name='__main__')\n"
           "except SystemExit as e:\n    code = e.code\n"
           "bad = sorted(m for m in sys.modules if m == 'jax' or "
           "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
           "print('IMPORTED', bad)\nsys.exit(code)")
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    env.pop("REPRO_TORCH_TUNED_DIR", None)
    out = subprocess.run(
        [sys.executable, "-c", run, str(SCRIPT), "--mode", "model",
         "--arch", "llama3.2-1b", "--db-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED []" in out.stdout
    assert ("llama3.2-1b                113 GEMMs,  5 unique shapes; "
            "backward  226 GEMMs, 10 unique shapes") in out.stdout
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    path = tmp_path / "h100.json"
    db = tuning_db.TuningDB.from_file(str(path))
    assert db.hardware == "h100" and db.measured_on is None
    assert db.stale() == []
    assert all(r.source == "model" for r in db.records())
    reg = registry.TileRegistry()
    assert tuning_db.load_into_registry(reg, str(path), strict=True) == len(
        db)
    fwd, bwd = captured("llama3.2-1b")
    want = {(str(dt).replace("torch.", ""), p[:3])
            for dt, p in tune_all.gemm_problems(fwd, bwd)}
    want |= {("bfloat16", p) for p in tune_all.flash_problems(
        [ARCHITECTURES["llama3.2-1b"]])}
    assert {(r.dtype, r.shape) for r in db.records()} == want
    assert len(lines) == len(tune_all.gemm_problems(fwd, bwd)) + 5
    for rec in db.records():
        got = reg.lookup_op(rec.op, "h100", rec.dtype, rec.shape)
        assert (got.source, got.config) == ("exact", rec.config)
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--arch", "mamba2-130m", "--db-dir",
         str(tmp_path / "m")], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(tmp_path))
    if not torch.cuda.is_available():
        assert out.returncode != 0 and "needs the card" in out.stderr


def test_committed_table_covers_the_captured_problems(tune_all, captured):
    """The committed h100 table holds a measured entry for each of
    llama3.2-1b's captured problems, forward and backward, and for every
    flash problem of the catalog."""
    db = tuning_db.TuningDB.from_file(str(
        REPO / "src" / "repro_torch" / "tuned" / "h100.json"))
    fwd, bwd = captured("llama3.2-1b")
    for dtype, problem in tune_all.gemm_problems(fwd, bwd):
        rec = db.get_op("gemm", str(dtype).replace("torch.", ""),
                        registry.key_shape("gemm", dtype, problem[:3]))
        assert rec is not None and rec.source == "measure", problem
    for problem in tune_all.flash_problems(ARCHITECTURES.values()):
        rec = db.get_op("flash_attention", "bfloat16", problem)
        assert rec is not None and rec.source == "measure", problem
