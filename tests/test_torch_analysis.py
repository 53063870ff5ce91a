"""The port's static checker (``repro_torch.analysis``) on bad and clean
fixtures, its ratchet, the live gate over ``src/repro_torch``, and each
check held against the reference's ``repro.analysis`` wherever the two
compute the same thing (ST001's key scan, the sharding coverage, the JSON
blob's keys), plus the port's ``testing`` fallback against the
reference's.

The fixtures are a miniature ``src/repro_torch`` tree written to a
temporary directory; every line a check must flag carries an ``# expect:``
marker naming the check ids, and the findings must be exactly those.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import pragmas  # noqa: E402
from repro_torch.analysis.artifacts import (  # noqa: E402
    parse_mesh_label, validate_tuned_dir, validate_tuning_db)
from repro_torch.analysis.callgraph import CallGraph  # noqa: E402
from repro_torch.analysis.findings import (  # noqa: E402
    Finding, SEV_ERROR, default_baseline_path, load_baseline, ratchet,
    save_baseline)
from repro_torch.analysis.purity import PurityChecker  # noqa: E402
from repro_torch.core.tile_config import (  # noqa: E402
    FlashAttentionConfig, OP_FLASH_ATTENTION, TileConfig, block_of)
from repro_torch.core.tuning_db import TuningDB, TuningRecord  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

FIXTURES = {
    "src/repro_torch/models/model.py": '''
        import random
        import time

        import numpy as np
        import torch


        class Model:
            def forward(self, params, batch):
                return _helper(batch)

            def decode_step(self, params, tokens, cache, offset):
                x = tokens.float()
                n = int(x.sum())                    # expect: TP002
                if torch.any(x > 0):                # expect: TP003
                    x = x + random.random()         # expect: TP004
                y = x.cpu()                         # expect: TP001
                z = np.asarray(x)                   # expect: TP001
                t = time.time()                     # expect: TP004
                r = torch.randn(3)                  # expect: TP004
                g = torch.randn(3, generator=self.gen)
                keep = x.nonzero()                  # expect: TP001
                ok = x.item()                       # analysis: allow(TP001)
                # a slug waives its check on the line below
                # analysis: allow(host-transfer)
                back = x.to("cpu")
                return n, y, z, t, r, g, keep, ok, back


        def _helper(batch):
            return bool(batch[0].any())             # expect: TP002


        def host_only(x):
            # not step code, not a driver: silent
            return float(np.asarray(x).sum()) + x.item()
        ''',
    "src/repro_torch/kernels/clean_step.py": '''
        import torch
        from torch.utils.checkpoint import checkpoint


        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, gen):
                if x.ndim == 2:                     # static: the rank
                    x = x.reshape(-1)
                if torch.is_grad_enabled():         # host state
                    x = x + 0
                scale = float(x.shape[0])           # static: shape math
                n = int(x.size(0))                  # static: metadata
                noise = torch.randn(x.shape, generator=gen)
                k = x.repeat_interleave(2, dim=0)   # constant repeats
                return x * scale + noise + n, k

            @staticmethod
            def backward(ctx, g, gk):
                return g, None
        ''',
    "src/repro_torch/kernels/roots.py": '''
        import torch
        from torch.utils.checkpoint import checkpoint


        def block(x):
            return x.tolist()                       # expect: TP001


        def remat(x):
            return checkpoint(block, x, use_reentrant=False)


        @torch.library.custom_op("fixture::op", mutates_args=())
        def op(x: torch.Tensor) -> torch.Tensor:
            return x * float(x.max())               # expect: TP002


        def _backward(ctx, g):
            return g.repeat_interleave(ctx.saved_tensors[0])  # expect: TP001


        op.register_autograd(_backward)
        ''',
    "src/repro_torch/serve/bad_driver.py": '''
        import torch

        from repro_torch.profiling import annotate


        class Engine:
            def __init__(self, model):
                self.model = model

            def bad_wave(self, batch):
                out = self.model.prefill(None, batch, None)  # expect: TP005
                torch.cuda.synchronize()            # expect: TP001
                return out.tolist()                 # expect: TP001

            def _prefill(self, batch):
                # every call site is annotated: covered
                return self.model.prefill(None, batch, None)

            def admit(self, batch):
                with annotate("serve.prefill_admit"):
                    return self._prefill(batch)

            def admit_wave(self, batch):
                with annotate("serve.prefill_wave"):
                    out = self._prefill(batch)
                return out

            def _prefill_leaky(self, batch):
                return self.model.prefill(None, batch, None)  # expect: TP005

            def leaky_a(self, batch):
                with annotate("serve.prefill_admit"):
                    return self._prefill_leaky(batch)

            def leaky_b(self, batch):
                return self._prefill_leaky(batch)

            def _gather(self, idx):
                return int(idx[0])                  # expect: TP002

            def chunk(self, idx):
                with annotate("serve.decode_chunk"):
                    g = self._gather(idx)
                    # the chunk's one transfer
                    # analysis: allow(TP001)
                    host = torch.zeros(1).cpu()
                return g, host

            def stale(self):
                return 1                            # analysis: allow(TP001)
        ''',
    "src/repro_torch/train/trainer.py": '''
        import torch


        def make_train_step(model):
            def train_step(state, batch):
                loss = model.forward_hidden(state, batch)
                if loss.isnan().any():              # expect: TP003
                    raise ValueError("nan")
                return loss
            return train_step


        class Trainer:
            def __init__(self, model):
                self._step = make_train_step(model)

            def run(self, state, batch):
                return self._step(state, batch)     # expect: TP005
        ''',
}
STALE_PRAGMA = ("src/repro_torch/serve/bad_driver.py", "Engine.stale")


def _source(rel):
    """A fixture file's text, as written to the fixture tree."""
    return textwrap.dedent(FIXTURES[rel]).lstrip("\n")


def _expected():
    """{(path, line, check id)} of every ``# expect:`` marker."""
    out = set()
    for rel in FIXTURES:
        for i, line in enumerate(_source(rel).splitlines(), 1):
            if "# expect:" in line:
                for cid in line.split("# expect:")[1].split(","):
                    out.add((rel, i, cid.strip()))
    return out


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis_fixture")
    for rel in FIXTURES:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(_source(rel))
    return str(root)


@pytest.fixture(scope="module")
def graph(fixture_root):
    return CallGraph(fixture_root)


@pytest.fixture(scope="module")
def linted(graph):
    ledger = pragmas.PragmaLedger()
    findings = PurityChecker(graph, ledger=ledger).run()
    return findings, ledger


# ---------------------------------------------------------------------------
# the step-code call graph
# ---------------------------------------------------------------------------

def test_step_code_roots_and_their_callees(graph):
    step = {i.qualname for i in graph.traced_functions()}
    assert {"Model.forward", "Model.decode_step", "_helper",
            "Scale.forward", "Scale.backward", "block", "op", "_backward",
            "make_train_step.<locals>.train_step",
            "Engine._gather"} <= step


def test_host_code_stays_out_of_step_code(graph):
    step = {i.qualname for i in graph.traced_functions()}
    for host in ("host_only", "remat", "Engine.bad_wave", "Engine.chunk",
                 "Engine._prefill", "Trainer.run", "make_train_step"):
        assert host not in step, host


# ---------------------------------------------------------------------------
# TP00x on the fixtures
# ---------------------------------------------------------------------------

def test_every_check_fires_exactly_at_its_marked_lines(linted):
    findings, _ = linted
    got = {(f.path, f.line, f.check_id) for f in findings}
    assert got == _expected(), "\n".join(
        f.render() for f in sorted(findings))
    assert {f.check_id for f in findings} == {"TP001", "TP002", "TP003",
                                              "TP004", "TP005"}


def test_findings_anchor_to_their_scopes(linted):
    findings, _ = linted
    by = {}
    for f in findings:
        by.setdefault(f.check_id, set()).add(f.scope)
    assert by["TP005"] == {"Engine.bad_wave", "Engine._prefill_leaky",
                           "Trainer.run"}
    assert by["TP003"] == {"Model.decode_step",
                           "make_train_step.<locals>.train_step"}
    assert by["TP002"] == {"Model.decode_step", "_helper", "op",
                           "Engine._gather"}
    assert {"block", "_backward", "Engine.bad_wave"} <= by["TP001"]


def test_clean_step_code_is_silent(linted):
    findings, _ = linted
    assert not [f for f in findings if "clean_step" in f.path]


def test_pragmas_suppress_by_id_and_by_slug(linted):
    findings, ledger = linted
    model = "src/repro_torch/models/model.py"
    lines = _source(model).splitlines()
    waived = {i for i, line in enumerate(lines, 1)
              if "analysis: allow" in line}
    assert len(waived) == 2
    for ln in waived:
        assert ledger.suppressed(model, ln) == {"TP001"}
    flagged = {f.line for f in findings if f.path == model}
    assert not flagged & (waived | {ln + 1 for ln in waived})


def test_a_stale_pragma_is_pr900(graph, linted):
    _, ledger = linted
    sites = pragmas.scan_pragmas(graph)
    stale = pragmas.unused_pragma_findings(sites, ledger)
    path, _scope = STALE_PRAGMA
    lines = _source(path).splitlines()
    line = next(i for i, t in enumerate(lines, 1)
                if "return 1" in t and "allow" in t)
    assert [(f.check_id, f.path, f.line) for f in stale] == [
        ("PR900", path, line)]
    live = [r for r in pragmas.pragma_table(sites, ledger) if r["live"]]
    assert len(live) == len(sites) - 1


# ---------------------------------------------------------------------------
# the ratchet (the reference's tests on the port's findings.py)
# ---------------------------------------------------------------------------

def _finding(check="TP001", scope="f", path="src/x.py"):
    return Finding(check_id=check, severity=SEV_ERROR, path=path, line=7,
                   scope=scope, message="m")


def test_ratchet_accepts_baselined_findings(tmp_path):
    path = str(tmp_path / "baseline.json")
    current = [_finding(scope="a"), _finding(scope="b")]
    save_baseline(current, path)
    assert ratchet(current, load_baseline(path)) == ([], [])


def test_ratchet_fails_on_any_new_finding(tmp_path):
    path = str(tmp_path / "baseline.json")
    save_baseline([_finding(scope="a")], path)
    extra = _finding(scope="b")
    new, fixed = ratchet([_finding(scope="a"), extra], load_baseline(path))
    assert new == [extra] and fixed == []


def test_ratchet_is_line_free_and_reports_fixed_keys(tmp_path):
    path = str(tmp_path / "baseline.json")
    save_baseline([_finding(scope="a"), _finding(scope="gone")], path)
    moved = Finding(check_id="TP001", severity=SEV_ERROR, path="src/x.py",
                    line=99, scope="a", message="m")
    new, fixed = ratchet([moved], load_baseline(path))
    assert new == [] and fixed == ["TP001:src/x.py:gone"]


def test_missing_baseline_means_empty_floor(tmp_path):
    assert load_baseline(str(tmp_path / "nope.json")) == {}


def test_baseline_schema_version_is_enforced(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"schema_version": 99, "findings": []}))
    with pytest.raises(ValueError, match="schema_version"):
        load_baseline(str(path))


# ---------------------------------------------------------------------------
# the live gate: the port against its committed (empty) baseline
# ---------------------------------------------------------------------------

def test_committed_baseline_is_empty():
    assert default_baseline_path() == os.path.join(
        SRC, "repro_torch", "analysis", "baseline.json")
    assert load_baseline() == {}


def test_port_lint_is_clean_against_the_empty_baseline():
    graph = CallGraph(REPO)
    ledger = pragmas.PragmaLedger()
    findings = PurityChecker(graph, ledger=ledger).run()
    findings += pragmas.unused_pragma_findings(pragmas.scan_pragmas(graph),
                                               ledger)
    errors = [f for f in findings if f.severity == SEV_ERROR]
    new, _fixed = ratchet(errors, load_baseline())
    assert new == [], "\n".join(f.render() for f in new)
    # every sanctioned sync is a live pragma, and the lint did reach them
    assert ledger.count() >= 7
    assert "src/repro_torch/serve/engine.py:Engine._decode_step" in \
        graph.traced


def test_mesh_admission_copies_fixed_rows_from_host_slots(monkeypatch):
    """Port fault (queue 3): on a mesh, an admission copied the prefill's
    fixed cache rows with ``slots.tolist()``, a device-to-host sync the
    reference does not have.  The engine now hands the host slot list."""
    from repro_torch.serve import engine as eng_mod
    seen = []
    monkeypatch.setattr(eng_mod.dops, "copy_rows",
                        lambda dst, src, bd, rows: seen.append((bd, rows)))

    def no_sync(self):
        raise AssertionError("tensor.tolist() on the admission path")
    monkeypatch.setattr(torch.Tensor, "tolist", no_sync)
    fixed = {"ssm": torch.zeros(3, 4, 2, 2, 2)}
    fake = types.SimpleNamespace(mesh=object(), _fixed=fixed)
    slots = torch.tensor([0, 2])
    eng_mod.Engine._scatter_fixed(fake, {"ssm": torch.ones(3, 4, 2, 2, 2)},
                                  slots, [0, 2])
    assert seen == [(1, [0, 2])]


# ---------------------------------------------------------------------------
# ST001 against the reference's scanner
# ---------------------------------------------------------------------------

def _synth_engine():
    """The reference tests' ``_SYNTH_ENGINE`` text, read from their file."""
    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_analysis.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_SYNTH_ENGINE"
                for t in node.targets):
            return node.value.value
    raise AssertionError("_SYNTH_ENGINE not found")


def test_st001_scan_equals_the_references(tmp_path):
    from repro.analysis.stats_checks import emitted_stats_keys as ref_keys
    from repro_torch.analysis.stats_checks import emitted_stats_keys
    path = tmp_path / "engine.py"
    path.write_text(_synth_engine())
    keys, line = emitted_stats_keys(str(path))
    assert (keys, line) == ref_keys(str(path))
    assert {"requests", "scheduler", "bogus_key"} <= keys
    live = os.path.join(SRC, "repro_torch", "serve", "engine.py")
    assert emitted_stats_keys(live)[0] == ref_keys(live)[0]


def test_st001_flags_drift_in_both_directions(tmp_path):
    from repro_torch.analysis.stats_checks import check_stats_schema
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "engine.py").write_text(_synth_engine())
    found = check_stats_schema(str(tmp_path), os.path.join("sub",
                                                           "engine.py"))
    scopes = {f.scope for f in found}
    assert "stats.bogus_key" in scopes
    assert "stats.schema_version" in scopes
    assert all(f.check_id == "ST001" and f.severity == SEV_ERROR
               for f in found)


def test_st001_live_port_engine_matches_its_schema():
    from repro_torch.analysis.stats_checks import check_stats_schema
    from repro_torch.serve.stats_schema import STATS_SCHEMA
    assert check_stats_schema(REPO) == []
    assert len(STATS_SCHEMA) == 38


# ---------------------------------------------------------------------------
# AR00x on synthetic tables and the committed one
# ---------------------------------------------------------------------------

def _save_db(tmp_path, records, hardware="h100", stem=None):
    db = TuningDB(hardware)
    for rec in records:
        db.add(rec, keep_best=False)
    path = str(tmp_path / f"{stem or hardware}.json")
    db.save(path)
    return path


def _gemm(cfg, shape, dtype="bfloat16", **kw):
    return TuningRecord(dtype=dtype, shape=shape, block=block_of(cfg), **kw)


def _checks(findings):
    return {f.check_id for f in findings}


DECODE = TileConfig(16, 128, 64, kernel="decode", stages=3)


@pytest.mark.parametrize("case,cfg,shape,want", [
    ("misaligned", TileConfig(128, 32, 256, kernel="wgmma", stages=4),
     (4096, 2048, 2048), {"AR001"}),
    ("not instantiated", TileConfig(128, 64, 192, kernel="wgmma",
                                    stages=4), (4096, 2048, 2048), {"AR001"}),
    ("over shared memory", TileConfig(256, 64, 256, kernel="wgmma",
                                      stages=8), (4096, 2048, 2048),
     {"AR001", "AR002"}),
])
def test_ar001_ar002_gemm_schedules(tmp_path, case, cfg, shape, want):
    found = validate_tuning_db(_save_db(tmp_path, [_gemm(cfg, shape)]))
    assert _checks(found) == want, case
    assert all(f.severity == SEV_ERROR for f in found)


def test_ar001_ar002_flash_at_an_uninstantiated_head_dim(tmp_path):
    cfg = FlashAttentionConfig(128, 128, kernel="wgmma", stages=2)
    rec = TuningRecord(op=OP_FLASH_ATTENTION, dtype="bfloat16",
                       shape=(256, 256, 160), block=block_of(cfg))
    found = validate_tuning_db(_save_db(tmp_path, [rec]))
    assert _checks(found) == {"AR001", "AR002"}


def test_ar003_orphan_mesh_axis(tmp_path):
    found = validate_tuning_db(_save_db(tmp_path, [
        _gemm(DECODE, (16, 2048, 2048), mesh="ring4")]))
    assert _checks(found) == {"AR003"}


@pytest.mark.parametrize("rec", [
    _gemm(DECODE, (4096, 2048, 2048)),          # a decode schedule at M 4096
    _gemm(DECODE, (16, 2048, 2048), dtype="bfloat17"),
])
def test_ar004_stale_entries_warn(tmp_path, rec):
    found = validate_tuning_db(_save_db(tmp_path, [rec]))
    assert _checks(found) == {"AR004"}
    assert all(f.severity != SEV_ERROR for f in found)


@pytest.mark.parametrize("hardware,stem", [("vax-9000", None),
                                           ("h100", "cpu")])
def test_ar005_unknown_or_mismatched_hardware(tmp_path, hardware, stem):
    path = _save_db(tmp_path, [], hardware=hardware, stem=stem)
    assert _checks(validate_tuning_db(path)) == {"AR005"}


def test_a_good_entry_passes_clean(tmp_path):
    path = _save_db(tmp_path, [_gemm(DECODE, (16, 2048, 2048),
                                     mesh="data4xmodel2")])
    assert validate_tuning_db(path) == []


def test_committed_h100_table_passes_clean():
    tuned = os.path.join(SRC, "repro_torch", "tuned")
    assert os.listdir(tuned) == ["h100.json"]
    assert validate_tuned_dir(tuned, root=REPO) == []


def test_mesh_label_parser():
    assert parse_mesh_label("data4xmodel2") == [("data", 4), ("model", 2)]
    assert parse_mesh_label("ring4") == [("ring", 4)]
    assert parse_mesh_label("4data") is None
    assert parse_mesh_label("") is None


# ---------------------------------------------------------------------------
# SH00x against the reference's coverage
# ---------------------------------------------------------------------------

def test_coverage_equals_the_references():
    from repro.analysis import coverage as ref
    from repro_torch.analysis import coverage as port
    assert port.COVERAGE_FAMILIES == ref.COVERAGE_FAMILIES

    def key(findings):
        return {(f.check_id, f.severity, f.scope) for f in findings}
    got = key(port.check_coverage())
    assert got == key(ref.check_coverage())
    # the reference's six OLMoE expert-stack warnings
    assert {c for c, _s, _p in got} == {"SH002"} and len(got) == 6
    assert port.coverage_summary() == ref.coverage_summary()


# ---------------------------------------------------------------------------
# the CLI: exit codes, the JSON blob, no JAX
# ---------------------------------------------------------------------------

def _cli(args, cwd=REPO, pythonpath=SRC, code=None):
    env = dict(os.environ, PYTHONPATH=pythonpath)
    cmd = ([sys.executable, "-c", code] if code else
           [sys.executable, "-m", "repro_torch.analysis", *args])
    return subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=240)


def test_cli_report_exits_0_without_jax_and_writes_the_references_keys(
        tmp_path):
    port_json, ref_json = tmp_path / "port.json", tmp_path / "ref.json"
    proc = _cli(None, code=(
        "import sys\nfrom repro_torch.analysis.cli import main\n"
        f"rc = main(['report', '--json', {str(port_json)!r}])\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.startswith('repro.')]\n"
        "sys.exit(rc)\n"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[analyze] ok" in proc.stdout
    ref = subprocess.run([sys.executable, "-m", "repro.analysis", "lint",
                          "--json", str(ref_json)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    port, want = json.loads(port_json.read_text()), json.loads(
        ref_json.read_text())
    assert set(port) == set(want)
    assert port["errors"] == 0 and port["warnings"] == 6
    assert set(port["findings"][0]) == set(Finding(
        "X", SEV_ERROR, "p", 0, "s", "m").to_json())


def test_cli_exits_1_on_a_new_finding(tmp_path):
    shutil.copytree(os.path.join(SRC, "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    leak = tmp_path / "src" / "repro_torch" / "serve" / "leak.py"
    leak.write_text("def drain(t):\n    return t.item()\n")
    proc = _cli(["lint", "--strict"], cwd=str(tmp_path),
                pythonpath=str(tmp_path / "src"))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "leak.py:2: TP001" in proc.stdout
    proc = _cli(["pragmas"], cwd=str(tmp_path),
                pythonpath=str(tmp_path / "src"))
    assert proc.returncode == 0 and "7 live, 0 stale" in proc.stdout


@pytest.mark.parametrize("args", [["ir", "--bogus"], ["lint", "--bogus"], []])
def test_cli_usage_errors_exit_2(args):
    proc = _cli(args)
    assert proc.returncode == 2, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# repro_torch.testing: the fallback draws the reference's values
# ---------------------------------------------------------------------------

_DRAWS = """
import json, sys
sys.modules["hypothesis"] = None
import repro.testing, repro_torch.testing
out = {}
for mod in (repro.testing, repro_torch.testing):
    assert not mod.HAVE_HYPOTHESIS
    got = []
    st = mod.strategies

    @mod.settings(max_examples=9)
    @mod.given(a=st.integers(0, 1000), b=st.sampled_from("xyz"),
               c=st.floats(0.0, 2.0), d=st.booleans())
    def prop(a, b, c, d):
        got.append([a, b, c, d])
    prop()
    out[mod.__name__] = got
print(json.dumps(out))
"""


def test_testing_fallback_draws_equal_the_references():
    proc = _cli(None, code=_DRAWS)
    assert proc.returncode == 0, proc.stderr
    draws = json.loads(proc.stdout)
    assert len(draws["repro_torch.testing"]) == 9
    assert draws["repro_torch.testing"] == draws["repro.testing"]
