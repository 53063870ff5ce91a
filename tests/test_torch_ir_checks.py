"""The port's IR checker (``repro_torch.analysis.ir``) against the
reference's, with no tracing: IR000-IR003 on the same synthetic summaries
give the same (check id, severity, scope) findings; IR004's step-key
counts equal the reference's jit-key counts and both committed
fingerprint files for all 40 cases; IR004/IR005's diff and re-bless
mechanics; the matrix's case ids letter for letter.
"""
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.analysis.ir import checks as ref_checks  # noqa: E402
from repro.analysis.ir import fingerprints as ref_fingerprints  # noqa: E402
from repro.analysis.ir import matrix as ref_matrix  # noqa: E402
from repro.analysis.ir import recompile as ref_recompile  # noqa: E402
from repro.analysis.ir import trace as ref_trace  # noqa: E402
from repro_torch.analysis.findings import SEV_ERROR, SEV_WARNING  # noqa: E402
from repro_torch.analysis.ir import (checks, fingerprints,  # noqa: E402
                                     recompile)
from repro_torch.analysis.ir import matrix, trace  # noqa: E402

WEIGHT = [64, 64]              # a weight leaf shape of the synthetic case
ACTIVATION = [4, 16, 64]       # same numel (4096) but an activation shape
BUDGET = 8 * 1024 ** 3         # hbm_bytes of the port's cpu profile and
                               # the reference's cpu-interpret profile
MESH_SPECS = (None, "data=4,model=2")
CASES = matrix.default_matrix(mesh_specs=MESH_SPECS)


def _both_cases(entries, dtype="bfloat16", hardware=None, errors=None):
    """The same synthetic case as the reference's and the port's
    ``CaseResult``: ``entries`` maps entry -> summary fields."""
    out = []
    for mod, hw, hash_key, ver_key in (
            (ref_trace, "cpu-interpret", "jaxpr_hash", "jax_version"),
            (trace, "cpu", "program_hash", "torch_version")):
        summaries = {}
        for entry, kw in entries.items():
            base = dict(
                entry=entry, prim_histogram={"dot_general": 2},
                converts=[], dots=[], f64_avals=0,
                memory={"argument_bytes": 1024, "output_bytes": 512,
                        "temp_bytes": 256, "peak_bytes": None},
                while_collectives=[], collectives=[])
            base[hash_key] = "h" * 8
            base.update(kw)
            summaries[entry] = mod.EntrySummary(**base)
        out.append(mod.CaseResult(**{
            "case_id": f"llama3.2-1b/wave/single/{dtype}",
            "entries": summaries,
            "weight_shapes": [WEIGHT, [2] + WEIGHT, [128, 64]],
            "params_bytes": 1 << 20, "hardware": hardware or hw,
            ver_key: "x", "errors": errors or {}}))
    return out


def _coll(op, dims):
    n = 1
    for d in dims:
        n *= d
    return {"op": op, "numel": n, "bytes": 2 * n, "dims": dims}


_UPCAST = {"src": "bfloat16", "dst": "float32", "numel": 4096,
           "dims": WEIGHT}
_ACT_UPCAST = dict(_UPCAST, dims=ACTIVATION)
_OK_DOT = {"lhs": "bfloat16", "rhs": "bfloat16", "out": "float32"}
_BAD_DOT = {"lhs": "float32", "rhs": "float32", "out": "float16"}


def _mem(peak):
    return {"memory": {"argument_bytes": None, "output_bytes": None,
                       "temp_bytes": None, "peak_bytes": peak}}


#: (name, case kwargs, the findings' check ids the reference's tests
#: expect) of the reference's synthetic-summary tests
SYNTHETIC = [
    ("ir000_trace_error", dict(entries={},
                               errors={"prefill": "ValueError: boom"}),
     ["IR000"]),
    ("ir001_weight_gather_in_decode_loop", dict(entries={
        "decode_loop": {"while_collectives":
                        [_coll("all-gather", WEIGHT)] * 2}}),
     ["IR001"]),
    ("ir001_scan_sliced_weight", dict(entries={
        "decode_chunk": {"while_collectives": [
            _coll("all-reduce", [2] + WEIGHT)]}}),
     ["IR001"]),
    ("ir001_ignores_activation_collectives", dict(entries={
        "decode_loop": {"while_collectives": [
            _coll("all-reduce", ACTIVATION)]}}),
     []),
    ("ir001_only_decode_entries_gate", dict(entries={
        "prefill": {"while_collectives": [_coll("all-gather", WEIGHT)]},
        "train_step": {"while_collectives": [
            _coll("all-gather", WEIGHT)]}}),
     []),
    ("ir002_f64_anywhere", dict(entries={"prefill": {"f64_avals": 3}}),
     ["IR002"]),
    ("ir002_weight_upcast_in_bf16_serve", dict(entries={
        "prefill": {"converts": [_UPCAST]}}),
     ["IR002"]),
    ("ir002_activation_upcast_is_clean", dict(entries={
        "prefill": {"converts": [_ACT_UPCAST]}}),
     []),
    ("ir002_train_step_upcast_is_exempt", dict(entries={
        "train_step": {"converts": [_UPCAST]}}),
     []),
    ("ir002_f32_case_has_no_bf16_contract", dict(entries={
        "prefill": {"converts": [_UPCAST]}}, dtype="float32"),
     []),
    ("ir002_dot_allowlist_ok", dict(entries={"prefill": {"dots": [_OK_DOT]}}),
     []),
    ("ir002_dot_outside_allowlist", dict(entries={
        "prefill": {"dots": [_OK_DOT, _BAD_DOT]}}),
     ["IR002"]),
    ("ir003_over_budget", dict(entries={"prefill": _mem(BUDGET + 1)}),
     ["IR003"]),
    ("ir003_within_headroom_warns", dict(entries={
        "prefill": _mem(int(BUDGET * 0.9))}),
     ["IR003"]),
    ("ir003_fallback_sum_is_clean", dict(entries={"prefill": {}}), []),
    ("ir003_unknown_hardware", dict(entries={"prefill": {}},
                                    hardware="martian-npu"),
     ["IR003"]),
]


def _key(findings):
    return sorted((f.check_id, f.severity, f.scope) for f in findings)


@pytest.mark.parametrize("name,kw,expect", SYNTHETIC,
                         ids=[s[0] for s in SYNTHETIC])
def test_synthetic_findings_equal_the_references(name, kw, expect):
    ref_case, case = _both_cases(**kw)
    got = checks.check_case(case)
    assert _key(got) == _key(ref_checks.check_case(ref_case))
    assert sorted({f.check_id for f in got}) == expect


def test_peak_fallback_and_warning_severity():
    _, case = _both_cases({"prefill": _mem(int(BUDGET * 0.9))})
    assert [f.severity for f in checks.check_memory(case)] == [SEV_WARNING]
    _, case = _both_cases({"prefill": _mem(BUDGET + 1)})
    assert [f.severity for f in checks.check_memory(case)] == [SEV_ERROR]
    _, case = _both_cases({"x": {}})
    assert checks.peak_bytes(case.entries["x"]) == 1024 + 512 + 256
    assert checks.ACC_ALLOW == ref_checks.ACC_ALLOW
    assert (checks.DECODE_ENTRIES, checks.WEIGHT_MOVING_OPS,
            checks.HEADROOM_WARN) == (ref_checks.DECODE_ENTRIES,
                                      ref_checks.WEIGHT_MOVING_OPS,
                                      ref_checks.HEADROOM_WARN)


# ---------------------------------------------------------------------------
# the matrix and IR004
# ---------------------------------------------------------------------------

def test_matrix_equals_the_references():
    ref = ref_matrix.default_matrix(mesh_specs=MESH_SPECS)
    assert [c.case_id for c in CASES] == [c.case_id for c in ref]
    assert len(CASES) == 40
    assert [c.entries for c in CASES] == [c.entries for c in ref]
    assert [c.case_id for c in matrix.smoke_matrix()] == [
        c.case_id for c in ref_matrix.smoke_matrix()]
    assert (matrix.SERVE_KW, matrix.FAMILIES, matrix.SCHEDULERS,
            matrix.DTYPES) == (ref_matrix.SERVE_KW, ref_matrix.FAMILIES,
                               ref_matrix.SCHEDULERS, ref_matrix.DTYPES)


def _committed_ref():
    return ref_fingerprints.load_fingerprints()["cases"]


def _committed():
    return fingerprints.load_fingerprints()["cases"]


@pytest.mark.parametrize("case", CASES, ids=[c.case_id for c in CASES])
def test_ir004_counts_equal_the_references(case):
    """The port's step-key counts = the reference's jit-key counts (its
    unroll is fixed per case, so any unroll gives the same counts) = both
    committed files."""
    got = recompile.enumerate_jit_keys(case)
    ref_case = ref_matrix.IRCase(case.family, case.scheduler,
                                 case.mesh_spec, case.dtype)
    for unroll in (1, 4):
        assert got == ref_recompile.enumerate_jit_keys(ref_case, unroll)
    assert got == _committed_ref()[case.case_id]["jit_keys"]
    assert got == _committed()[case.case_id]["jit_keys"]


def test_step_keys_follow_the_engine_bucket_policy():
    from repro_torch.serve.engine import _bucket_len
    keys = recompile.wave_keys(max_len=64)
    assert keys["prefill"] and keys["decode_loop"]
    for (width,) in keys["decode_loop"]:
        assert width == _bucket_len(width)
    # a serve-shape / bucket change moves the static key count
    assert len(recompile.wave_keys(128)["prefill"]) > len(keys["prefill"])
    c8 = recompile.continuous_keys(64, 4, chunk=8)
    c16 = recompile.continuous_keys(64, 4, chunk=16)
    assert c8["decode_chunk"] != c16["decode_chunk"]
    assert all(chunk == 8 for _w, chunk in c8["decode_chunk"])


def test_committed_fingerprints_cover_the_full_matrix():
    """5 families x 2 schedulers x 2 meshes x 2 dtypes, every cell blessed
    in src/repro_torch/analysis/ir_fingerprints.json."""
    blob = fingerprints.load_fingerprints()
    assert blob["torch_version"]
    assert sorted(blob["cases"]) == sorted(c.case_id for c in CASES)
    for case in CASES:
        rec = blob["cases"][case.case_id]
        assert set(rec["entries"]) == set(case.entries)
        assert rec["jit_keys"]["total"] == sum(
            v for k, v in rec["jit_keys"].items() if k != "total")
        for entry in rec["entries"].values():
            assert len(entry["program_hash"]) == 64 and entry["prims"]


# ---------------------------------------------------------------------------
# IR004 / IR005 diff and re-bless mechanics
# ---------------------------------------------------------------------------

def _both_compare(case_id, record, committed, matches):
    """The port's and the reference's findings for the same records
    (hash keys renamed to each one's schema)."""
    def ref_rec(r):
        return {"jit_keys": r["jit_keys"], "entries": {
            e: {"jaxpr_hash": v["program_hash"], "prims": v["prims"]}
            for e, v in r["entries"].items()}}
    ref_committed = {"jax_version": committed.get("torch_version"),
                     "cases": {k: ref_rec(v) for k, v in
                               committed.get("cases", {}).items()}}
    got = fingerprints.compare_case(case_id, record, committed, matches)
    ref = ref_fingerprints.compare_case(case_id, ref_rec(record),
                                        ref_committed, matches)
    assert _key(got) == _key(ref)
    return got


def _rec(h, prims):
    return {"program_hash": h, "prims": prims}


def test_ir004_diff_names_the_entry_point():
    record = {"jit_keys": {"prefill": 12, "decode_loop": 7, "total": 19},
              "entries": {}}
    committed = {"torch_version": "x",
                 "cases": {"c": {"jit_keys": {"prefill": 10,
                                              "decode_loop": 7, "total": 17},
                                 "entries": {}}}}
    fs = _both_compare("c", record, committed, True)
    assert sorted(f.scope for f in fs) == ["prefill", "total"]
    assert {f.check_id for f in fs} == {"IR004"}
    assert "10 -> 12" in [f for f in fs if f.scope == "prefill"][0].message


def test_ir005_hash_drift_gates_only_on_matching_torch_version():
    record = {"jit_keys": {}, "entries": {
        "prefill": _rec("new", {"repro_torch.gemm": 4,
                                "aten._to_copy": 2})}}
    committed = {"torch_version": "2.11", "cases": {"c": {
        "jit_keys": {}, "entries": {
            "prefill": _rec("old", {"repro_torch.gemm": 5})}}}}
    errs = _both_compare("c", record, committed, True)
    assert [f.severity for f in errs] == [SEV_ERROR]
    assert "+2 aten._to_copy" in errs[0].message
    assert "-1 repro_torch.gemm" in errs[0].message
    warns = _both_compare("c", record, committed, False)
    assert [f.severity for f in warns] == [SEV_WARNING]
    assert "torch 2.11" in warns[0].message


def test_ir005_unfingerprinted_case_and_entry_churn():
    fs = _both_compare("new-case", {"jit_keys": {}, "entries": {}},
                       {"torch_version": "x", "cases": {}}, True)
    assert "no committed fingerprint" in fs[0].message
    record = {"jit_keys": {}, "entries": {"admit": _rec("h", {})}}
    committed = {"torch_version": "x", "cases": {"c": {
        "jit_keys": {}, "entries": {"decode_chunk": _rec("h", {})}}}}
    fs = _both_compare("c", record, committed, True)
    assert sorted(f.scope for f in fs) == ["admit", "decode_chunk"]
    assert {f.check_id for f in fs} == {"IR005"}


def test_fingerprint_schema_mismatch_and_merge(tmp_path):
    path = tmp_path / "fp.json"
    path.write_text(json.dumps({"schema_version": 999, "cases": {}}))
    with pytest.raises(ValueError, match="--write-fingerprints"):
        fingerprints.load_fingerprints(str(path))
    path = str(tmp_path / "fp2.json")
    fingerprints.merge_fingerprints(
        {"a/x": {"jit_keys": {"total": 1}, "entries": {}}}, "v", path)
    fingerprints.merge_fingerprints(
        {"b/y": {"jit_keys": {"total": 2}, "entries": {}}}, "v", path)
    blob = fingerprints.load_fingerprints(path)
    assert sorted(blob["cases"]) == ["a/x", "b/y"]
    assert blob["torch_version"] == "v"
    assert fingerprints.structural_diff({"a": 1, "b": 2}, {"b": 3, "c": 1}) \
        == ref_fingerprints.structural_diff({"a": 1, "b": 2},
                                            {"b": 3, "c": 1})
