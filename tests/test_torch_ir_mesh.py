"""The port's IR checker on the fake ``data=4,model=2`` mesh, and
``bf16_partials`` on a K-split product, in one subprocess (the fake
process group is process-wide):

* the mesh leg's smoke cases (llama3.2-1b, both schedulers, bf16) run
  clean against the committed fingerprints;
* the seeded regression: the engine built under ambient
  ``rules_for_mesh(mesh, fsdp=True)`` instead of its inference-TP rules
  re-gathers weights inside the decode loop, and IR001 catches it in
  ``decode_loop``; without the override no IR001 fires;
* a K-split shard's local product under ``bf16_partials`` is bf16 and
  equals the reference's ``kernels/ops.py::_xla_gemm(...,
  bf16_partials=True)`` on the same operands.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import json, logging, sys
logging.disable(logging.WARNING)
import torch
from torch.distributed.tensor import DTensor, Shard
from repro_torch.analysis.ir import checks
from repro_torch.analysis.ir.matrix import IRCase, default_matrix
from repro_torch.analysis.ir.runner import run_ir
from repro_torch.analysis.ir.trace import trace_case
from repro_torch.core import gemm_api
from repro_torch.distributed import ops as dops
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import end_fake_world, make_fake_mesh

out = {}
cases = default_matrix(mesh_specs=("data=4,model=2",),
                       families=("llama3.2-1b",), dtypes=("bfloat16",))
findings, blob = run_ir(cases, cache_dir=sys.argv[1])
out["smoke"] = {"cases": [r["case"] for r in blob["ir_cases"]],
                "findings": [f.render() for f in findings
                             if f.check_id != "IR005"
                             or f.severity == "error"],
                "while_collectives": {r["case"]: r["while_collectives"]
                                      for r in blob["ir_cases"]}}

case = IRCase("llama3.2-1b", "wave", "data=4,model=2", "bfloat16")
mesh = make_fake_mesh(case.mesh_spec)
bad = trace_case(case, rules_override=sh.rules_for_mesh(mesh, fsdp=True))
out["fsdp"] = {"errors": bad.errors, "ir001": sorted(
    (f.scope, f.message) for f in checks.check_case(bad)
    if f.check_id == "IR001")}
good = trace_case(case)
out["inference_tp"] = sorted(f.render() for f in checks.check_case(good))

mesh = make_fake_mesh("model=2")
g = torch.Generator().manual_seed(0)
x = torch.randn(4, 64, generator=g).bfloat16()
w = torch.randn(64, 32, generator=g).bfloat16()
wd = DTensor.from_local(w[:32], mesh, [Shard(0)], run_check=False,
                        shape=w.shape, stride=w.stride())
seen = []
def local(xl, wl, **kw):
    res = gemm_api.matmul(xl, wl, **kw)
    seen.append((xl, wl, kw["out_dtype"], res))
    return res
with gemm_api.execution_context(bf16_partials=True):
    dops.matmul(x, wd, bias=None, activation=None, out_dtype=None,
                local_matmul=local)
with gemm_api.execution_context(bf16_partials=False):
    dops.matmul(x, wd, bias=None, activation=None, out_dtype=None,
                local_matmul=local)
out["partials"] = [{"x": xl.float().tolist(), "w": wl.float().tolist(),
                    "out_dtype": str(od), "dtype": str(res.dtype),
                    "res": res.float().tolist()}
                   for xl, wl, od, res in seen]
end_fake_world()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("ir_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, cache], cwd=str(REPO),
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_mesh_smoke_cases_are_clean(mesh_run):
    smoke = mesh_run["smoke"]
    assert smoke["cases"] == ["llama3.2-1b/continuous/data4xmodel2/bfloat16",
                              "llama3.2-1b/wave/data4xmodel2/bfloat16"]
    assert smoke["findings"] == []
    # the decode steps do run collectives on the mesh (activations only)
    assert all(n > 0 for n in smoke["while_collectives"].values())


def test_seeded_fsdp_regression_is_caught_by_ir001(mesh_run):
    fsdp = mesh_run["fsdp"]
    assert fsdp["errors"] == {}
    scopes = {scope for scope, _ in fsdp["ir001"]}
    assert scopes == {"decode_loop"}, fsdp["ir001"]
    assert all("all-gather" in msg and "fsdp=False" in msg
               for _, msg in fsdp["ir001"])
    assert mesh_run["inference_tp"] == []


def test_bf16_partials_local_product_equals_the_references(mesh_run):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ops import _xla_gemm
    on, off = mesh_run["partials"]
    assert (on["out_dtype"], on["dtype"]) == ("torch.bfloat16",) * 2
    assert (off["out_dtype"], off["dtype"]) == ("torch.float32",) * 2
    assert np.asarray(on["x"]).shape == (4, 32)      # the K-split block
    ref = _xla_gemm(jnp.asarray(on["x"], jnp.bfloat16),
                    jnp.asarray(on["w"], jnp.bfloat16), alpha=1.0, beta=0.0,
                    bias=None, activation=None, out_dtype=None,
                    bf16_partials=True)
    assert str(ref.dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(ref, np.float32),
                                  np.asarray(on["res"], np.float32))
    # off: the same block's f32 partial sums, which round to the above
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(off["res"], jnp.float32).astype(
            jnp.bfloat16), np.float32), np.asarray(on["res"], np.float32))
