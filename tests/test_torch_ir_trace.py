"""The port's IR checker on real traces (one device, CPU): hashes stable
across traces and against the committed fingerprints, the ``ir`` CLI's
exit codes, ``report --ir smoke``, the step shapes the engine really runs
against IR004's enumeration (the dynamic twin of the reference's
``tests/test_recompile_count.py``), and the backward products' dtypes
(IR002 on the train step).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.cli import main  # noqa: E402
from repro_torch.analysis.ir import (checks, fingerprints,  # noqa: E402
                                     recompile)
from repro_torch.analysis.ir.matrix import IRCase, smoke_matrix  # noqa: E402
from repro_torch.analysis.ir.trace import trace_case  # noqa: E402

CASE = IRCase("llama3.2-1b", "continuous", None, "bfloat16")


@pytest.fixture(scope="module")
def traced():
    return trace_case(CASE)


def _hashes(result):
    return {e: s.program_hash for e, s in result.entries.items()}


def test_same_case_traces_to_identical_hashes(traced):
    again = trace_case(CASE)
    assert not traced.errors and not again.errors
    assert set(traced.entries) == {"admit", "decode_chunk"}
    assert _hashes(traced) == _hashes(again)
    assert checks.check_case(traced) == []
    assert traced.hardware == "cpu" and traced.torch_version == \
        torch.__version__


def test_fresh_trace_matches_committed_fingerprint(traced):
    """The committed file was blessed in another process; a fresh trace
    reproduces its hashes (comparable on the torch version it was blessed
    under only)."""
    blob = fingerprints.load_fingerprints()
    if blob.get("torch_version") != torch.__version__:
        pytest.skip("fingerprints blessed under another torch version")
    committed = blob["cases"][CASE.case_id]["entries"]
    for entry, summary in traced.entries.items():
        assert summary.program_hash == committed[entry]["program_hash"], \
            entry
        assert summary.prim_histogram == committed[entry]["prims"]


def test_cli_ir_smoke_clean_and_unblessed_fails(tmp_path):
    out = str(tmp_path / "ir.json")
    cache = str(tmp_path / "cache")
    assert main(["ir", "--smoke", "--json", out, "--cache-dir", cache]) == 0
    blob = json.load(open(out))
    assert {r["case"] for r in blob["ir_cases"]} == \
        {c.case_id for c in smoke_matrix()}
    assert blob["errors"] == 0 and blob["torch_version"] == \
        torch.__version__
    assert all(not r["failed_entries"] for r in blob["ir_cases"])
    # an empty fingerprint file makes every smoke case unblessed -> exit 1
    empty = tmp_path / "fp.json"
    empty.write_text(json.dumps(
        {"schema_version": fingerprints.FINGERPRINT_SCHEMA_VERSION,
         "torch_version": None, "cases": {}}))
    assert main(["ir", "--smoke", "--fingerprints", str(empty),
                 "--cache-dir", cache]) == 1
    # the report gate with the smoke leg (summaries off the cache)
    assert main(["report", "--ir", "smoke", "--cache-dir", cache]) == 0


# ---------------------------------------------------------------------------
# the dynamic twin of IR004
# ---------------------------------------------------------------------------

def _engine(scheduler):
    import dataclasses
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(ARCHITECTURES["llama3.2-1b"].reduced(),
                              dtype="bfloat16")
    model = build_model(cfg)
    return Engine(model, model.init(0, device="cpu"), ServeConfig(
        scheduler=scheduler, device="cpu", max_batch=4, max_len=64))


def _gen(eng, lengths, new_tokens):
    vocab = eng.model.cfg.vocab_size
    return eng.generate([[(3 * i + j) % vocab for j in range(n)]
                         for i, n in enumerate(lengths)], new_tokens)


def test_step_shapes_the_engine_runs_are_enumerated(monkeypatch):
    """Over ragged traffic, every (plen,) / (width,) / (width, chunk) the
    port's engine calls a step with is one of IR004's keys."""
    keys = recompile.wave_keys(64)
    wave = _engine("wave")
    widths = []
    loop = wave._decode_loop
    monkeypatch.setattr(wave, "_decode_loop", lambda *a: (
        widths.append(a[5]), loop(*a))[1])
    for lengths, new in (([3, 5], 4), ([12, 14], 4), ([4, 15], 7),
                         ([3], 12), ([40, 2], 20), ([1], 63)):
        _gen(wave, lengths, new)
    assert {(p,) for p in wave._plen_buckets} <= set(keys["prefill"])
    assert {(w,) for w in widths} <= set(keys["decode_loop"])
    assert len(set(widths)) >= 3

    cont = _engine("continuous")
    ckeys = recompile.continuous_keys(64, 4, chunk=cont._chunk)
    chunks = []
    gather = cont._gather_pool
    monkeypatch.setattr(cont, "_gather_pool", lambda pool, gidx: (
        chunks.append((gidx.shape[1], cont._chunk)), gather(pool, gidx))[1])
    _gen(cont, [3, 5, 12, 4, 7, 9], 12)
    _gen(cont, [30, 2, 17], 40)
    assert {(p,) for p in cont._plen_buckets} <= set(ckeys["admit"])
    assert set(chunks) <= set(ckeys["decode_chunk"])
    assert len(set(chunks)) >= 3


def test_backward_products_return_their_operands_dtype():
    """An f32 product of the backward (the unembed's f32 cotangent against
    a bf16 weight) returns f32 and is cast after, as the reference's
    transposed dots are: no product accumulates f32 into bf16 (IR002)."""
    from repro_torch.core.gemm_api import matmul
    from repro_torch.launch.step_stats import count_step
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 64, generator=g).bfloat16().requires_grad_()
    w = torch.randn(64, 32, generator=g).bfloat16().requires_grad_()
    with count_step(program=True) as stats:
        y = matmul(x, w, out_dtype=torch.float32)
        y.square().sum().backward()
    dots = {(d["lhs"], d["out"]) for d in stats.program.dots}
    assert ("float32", "float32") in dots
    assert all(lhs == out or (lhs, out) in checks.ACC_ALLOW
               for lhs, out in dots)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
