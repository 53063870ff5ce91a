"""The port's static checker CLI: the front door of ``repro_torch.analysis``.

Runnable two ways (the same entry point)::

    PYTHONPATH=src python -m repro_torch.analysis <cmd>
    repro-torch-analyze <cmd>                     # installed console script

Subcommands::

    lint        host-sync lint (TP00x) + unused-pragma check (PR900)
    artifacts   tuned-table validation (AR00x) of src/repro_torch/tuned
    coverage    sharding-rule coverage (SH00x) of the model families
    stats       Engine.stats() keys vs the versioned schema (ST001)
    ir          IR-level program contracts (IR000-IR005) over the traced
                config matrix: see repro_torch/analysis/ir/
    pragmas     list every `# analysis: allow(...)` site and what it eats
    report      lint + artifacts + coverage + stats (+ optional --ir leg)
                behind the committed-baseline ratchet gate

Exit codes (the reference's)::

    0   clean: no findings beyond the committed baseline
    1   new findings (or --strict with any error finding)
    2   usage error (unknown flag or subcommand)

``report`` is the gate: errors not in ``src/repro_torch/analysis/
baseline.json`` (empty) exit 1; warnings are printed but never fail.
``--update-baseline`` blesses the current error set as the new floor.
``--json FILE`` writes the findings (any subcommand).  Nothing here
imports JAX or the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
TUNED_DIR = os.path.join(REPO_ROOT, "src", "repro_torch", "tuned")


def _lint_findings():
    """-> (findings incl. PR900, graph, pragma sites, ledger)."""
    from repro_torch.analysis import pragmas
    from repro_torch.analysis.callgraph import CallGraph
    from repro_torch.analysis.purity import PurityChecker
    graph = CallGraph(REPO_ROOT)
    ledger = pragmas.PragmaLedger()
    findings = PurityChecker(graph, ledger=ledger).run()
    sites = pragmas.scan_pragmas(graph)
    findings += pragmas.unused_pragma_findings(sites, ledger)
    return findings, graph, sites, ledger


def _artifact_findings():
    from repro_torch.analysis.artifacts import validate_tuned_dir
    return validate_tuned_dir(TUNED_DIR, root=REPO_ROOT)


def _coverage_findings():
    from repro_torch.analysis.coverage import check_coverage
    return check_coverage()


def _stats_findings():
    from repro_torch.analysis.stats_checks import check_stats_schema
    return check_stats_schema(REPO_ROOT)


def _ir_cases(args):
    from repro_torch.analysis.ir.matrix import (DTYPES, FAMILIES, SCHEDULERS,
                                                default_matrix, smoke_matrix)
    if getattr(args, "smoke", False):
        return smoke_matrix()
    meshes = tuple(None if m in ("single", "none") else m
                   for m in (args.mesh or ["single"]))
    return default_matrix(
        mesh_specs=meshes,
        families=tuple(args.families.split(",")) if args.families
        else FAMILIES,
        schedulers=tuple(args.schedulers.split(",")) if args.schedulers
        else SCHEDULERS,
        dtypes=tuple(args.dtypes.split(",")) if args.dtypes else DTYPES)


def _run_ir(args):
    from repro_torch.analysis.ir.runner import run_ir
    return run_ir(_ir_cases(args),
                  use_cache=not getattr(args, "no_cache", False),
                  cache_dir=getattr(args, "cache_dir", None),
                  write_fingerprints=getattr(args, "write_fingerprints",
                                             False),
                  fingerprint_path=getattr(args, "fingerprints", None))


def _emit(findings, args, extra_blob=None):
    from repro_torch.analysis.findings import SEV_ERROR, sort_findings
    findings = sort_findings(findings)
    for f in findings:
        print(f.render())
    errors = [f for f in findings if f.severity == SEV_ERROR]
    warnings = [f for f in findings if f.severity != SEV_ERROR]
    print(f"[analyze] {len(errors)} error(s), {len(warnings)} warning(s)")
    if getattr(args, "json", None):
        blob = {"findings": [f.to_json() for f in findings],
                "errors": len(errors), "warnings": len(warnings)}
        blob.update(extra_blob or {})
        with open(args.json, "w") as fh:
            json.dump(blob, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"[analyze] wrote {args.json}")
    return errors, warnings


def _ratchet_gate(errors, warnings, baseline_path):
    """The shared exit-code policy: new errors beyond the baseline -> 1."""
    from repro_torch.analysis.findings import load_baseline, ratchet
    baseline = load_baseline(baseline_path)
    new, fixed = ratchet(errors, baseline)
    if fixed:
        print(f"[analyze] {len(fixed)} baseline finding(s) no longer fire; "
              f"ratchet forward with --update-baseline:")
        for key in fixed:
            print(f"  fixed: {key}")
    if new:
        print(f"[analyze] FAIL: {len(new)} finding(s) not in the baseline "
              f"({len(baseline)} tolerated):")
        for f in new:
            print(f"  new: {f.render()}")
        print("[analyze] fix them, pragma a sanctioned exception "
              "(# analysis: allow(<id>) with its reason), or, exceptionally, "
              "bless with --update-baseline")
        return 1
    print(f"[analyze] ok: no findings beyond the baseline "
          f"({len(baseline)} tolerated, {len(warnings)} warning(s))")
    return 0


def _print_pragmas(sites, ledger):
    from repro_torch.analysis.pragmas import pragma_table
    rows = pragma_table(sites, ledger)
    if not rows:
        print("[pragmas] no `# analysis: allow` pragmas in src/repro_torch")
        return rows
    for r in rows:
        state = ("suppresses " + ", ".join(r["suppresses"]) if r["live"]
                 else "STALE (suppresses nothing -> PR900)")
        print(f"[pragmas] {r['path']}:{r['line']} "
              f"allow({', '.join(r['allows'])}): {state}")
    live = sum(1 for r in rows if r["live"])
    print(f"[pragmas] {len(rows)} pragma(s), {live} live, "
          f"{len(rows) - live} stale")
    return rows


def cmd_lint(args):
    findings, graph, sites, ledger = _lint_findings()
    if args.verbose:
        for info in graph.traced_functions():
            print(f"[step] {info.key}  <- {graph.traced_via[info.key]}")
    if args.list_pragmas:
        _print_pragmas(sites, ledger)
    errors, _ = _emit(findings, args,
                      {"traced_functions": len(graph.traced)})
    return 1 if errors and args.strict else 0


def cmd_artifacts(args):
    errors, _ = _emit(_artifact_findings(), args)
    return 1 if errors and args.strict else 0


def cmd_coverage(args):
    from repro_torch.analysis.coverage import coverage_summary
    findings = _coverage_findings()
    summary = coverage_summary() if args.summary else None
    if summary:
        for family, kinds in summary.items():
            stat = ", ".join(
                f"{kind}: {v['sharded']}/{v['leaves']} leaves sharded"
                for kind, v in kinds.items())
            print(f"[coverage] {family}: {stat}")
    errors, _ = _emit(findings, args, {"coverage": summary} if summary
                      else None)
    return 1 if errors and args.strict else 0


def cmd_stats(args):
    errors, _ = _emit(_stats_findings(), args)
    return 1 if errors and args.strict else 0


def cmd_pragmas(args):
    _, _, sites, ledger = _lint_findings()
    rows = _print_pragmas(sites, ledger)
    if getattr(args, "json", None):
        with open(args.json, "w") as fh:
            json.dump({"pragmas": rows}, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"[analyze] wrote {args.json}")
    return 0


def cmd_ir(args):
    findings, blob = _run_ir(args)
    errors, warnings = _emit(findings, args, blob)
    if args.write_fingerprints:
        print(f"[analyze] fingerprints blessed -> {blob['blessed_path']} "
              f"({len(blob['ir_cases'])} case(s))")
        return 0
    return _ratchet_gate(errors, warnings, args.baseline)


def cmd_report(args):
    from repro_torch.analysis.findings import save_baseline
    findings, graph, sites, ledger = _lint_findings()
    findings = (findings + _artifact_findings() + _coverage_findings()
                + _stats_findings())
    extra = {"traced_functions": len(graph.traced)}
    if args.ir != "off":
        args.smoke = args.ir == "smoke"
        ir_findings, ir_blob = _run_ir(args)
        findings += ir_findings
        extra.update(ir_blob)
    errors, warnings = _emit(findings, args, extra)
    if args.update_baseline:
        path = save_baseline(errors, args.baseline)
        print(f"[analyze] baseline blessed -> {path} "
              f"({len(errors)} finding(s))")
        return 0
    return _ratchet_gate(errors, warnings, args.baseline)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The port's static invariant checker (exit 0 clean / "
                    "1 new findings / 2 usage error)",
        prog="repro-torch-analyze")
    ap.add_argument("--list-pragmas", action="store_true",
                    help="shortcut for the `pragmas` subcommand")
    sub = ap.add_subparsers(dest="cmd")

    def common(p):
        p.add_argument("--json", help="write findings JSON to this path")
        p.add_argument("--strict", action="store_true",
                       help="exit 1 on any error finding (no baseline)")

    p = sub.add_parser("lint", help="host-sync lint (TP00x) + "
                                    "unused-pragma check (PR900)")
    common(p)
    p.add_argument("--verbose", action="store_true",
                   help="also print the step-code function set")
    p.add_argument("--list-pragmas", action="store_true",
                   help="print the pragma ledger before the findings")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("artifacts",
                       help="tuned-table validation (AR00x)")
    common(p)
    p.set_defaults(fn=cmd_artifacts)

    p = sub.add_parser("coverage",
                       help="sharding-rule coverage of model families "
                            "(SH00x)")
    common(p)
    p.add_argument("--summary", action="store_true",
                   help="print per-family sharded-leaf statistics")
    p.set_defaults(fn=cmd_coverage)

    p = sub.add_parser("stats",
                       help="Engine.stats() key set vs the versioned "
                            "stats schema (ST001)")
    common(p)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("pragmas",
                       help="list `# analysis: allow` sites and what "
                            "each suppresses")
    p.add_argument("--json", help="write the pragma table to this path")
    p.set_defaults(fn=cmd_pragmas)

    def ir_flags(p):
        p.add_argument("--mesh", action="append",
                       help="mesh spec leg (repeatable); 'single' or "
                            "omit = 1 device")
        p.add_argument("--families", help="comma-separated family subset")
        p.add_argument("--schedulers", help="comma-separated scheduler "
                                            "subset")
        p.add_argument("--dtypes", help="comma-separated dtype subset")
        p.add_argument("--smoke", action="store_true",
                       help="one-family bf16 single-device smoke subset")
        p.add_argument("--no-cache", action="store_true",
                       help="retrace even when .ir_cache/ has a summary")
        p.add_argument("--cache-dir", help="summary cache dir "
                                           "(default .ir_cache/)")
        p.add_argument("--write-fingerprints", action="store_true",
                       help="bless the traced programs into "
                            "src/repro_torch/analysis/ir_fingerprints.json "
                            "(exit 0)")
        p.add_argument("--fingerprints",
                       help="fingerprint file (default "
                            "src/repro_torch/analysis/ir_fingerprints.json)")

    p = sub.add_parser("ir",
                       help="IR program contracts (IR000-IR005) over the "
                            "traced config matrix")
    p.add_argument("--json", help="write findings + IR report JSON")
    p.add_argument("--baseline",
                   help="ratchet file (default "
                        "src/repro_torch/analysis/baseline.json)")
    ir_flags(p)
    p.set_defaults(fn=cmd_ir)

    p = sub.add_parser("report",
                       help="all checks + the committed-baseline ratchet "
                            "gate")
    p.add_argument("--json", help="write findings JSON to this path")
    p.add_argument("--baseline",
                   help="ratchet file (default "
                        "src/repro_torch/analysis/baseline.json)")
    p.add_argument("--update-baseline", action="store_true",
                   help="bless the current error findings as the new floor")
    p.add_argument("--ir", choices=("off", "smoke", "full"), default="off",
                   help="also run the IR matrix leg (default off)")
    ir_flags(p)
    p.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    if args.cmd is None:
        if args.list_pragmas:
            return cmd_pragmas(argparse.Namespace(json=None))
        ap.error("a subcommand is required (or --list-pragmas)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
