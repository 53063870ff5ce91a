"""Orchestrate the IR pass: trace (or cache-load) every case, run IR000-
IR003, enumerate IR004 key counts, and diff IR004/IR005 against the
committed fingerprint file.  Returns ``(findings, report_blob)``: the
findings feed the shared baseline ratchet exactly like the lint's, and
the blob is the reference's ``IR_REPORT`` artifact (its ``jax_*`` keys
named ``torch_*``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Finding, SEV_ERROR
from repro_torch.analysis.ir import checks, fingerprints, recompile
from repro_torch.analysis.ir.matrix import IRCase
from repro_torch.analysis.ir.trace import (CaseResult, source_digest,
                                           traced_case_cached)


def run_ir(cases: Sequence[IRCase], *,
           use_cache: bool = True,
           cache_dir: Optional[str] = None,
           write_fingerprints: bool = False,
           fingerprint_path: Optional[str] = None,
           ) -> Tuple[List[Finding], dict]:
    t0 = time.time()
    src_digest = source_digest()
    committed = fingerprints.load_fingerprints(fingerprint_path)
    torch_matches = committed.get("torch_version") == torch.__version__

    findings: List[Finding] = []
    rows: List[dict] = []
    records: Dict[str, dict] = {}
    for case in cases:
        result: CaseResult = traced_case_cached(
            case, cache_dir=cache_dir, src_digest=src_digest,
            use_cache=use_cache)
        case_findings = checks.check_case(result)
        jit_keys = recompile.enumerate_jit_keys(case)
        record = fingerprints.case_record(result, jit_keys)
        records[case.case_id] = record
        if not write_fingerprints:
            case_findings += fingerprints.compare_case(
                case.case_id, record, committed, torch_matches)
        findings += case_findings
        rows.append({
            "case": case.case_id,
            "entries": sorted(result.entries),
            "failed_entries": sorted(result.errors),
            "jit_keys": jit_keys,
            "peak_bytes": {e: checks.peak_bytes(s)
                           for e, s in sorted(result.entries.items())},
            "while_collectives": sum(len(s.while_collectives)
                                     for s in result.entries.values()),
            "errors": sum(1 for f in case_findings
                          if f.severity == SEV_ERROR),
            "warnings": sum(1 for f in case_findings
                            if f.severity != SEV_ERROR),
            "cached": result.cached,
            "seconds": result.seconds,
        })

    blessed_path = None
    if write_fingerprints:
        blessed_path = fingerprints.merge_fingerprints(
            records, torch.__version__, fingerprint_path)

    blob = {
        "ir_cases": rows,
        "torch_version": torch.__version__,
        "fingerprint_torch_version": committed.get("torch_version"),
        "hash_gate_active": torch_matches,
        "source_digest": src_digest[:16],
        "blessed_path": blessed_path,
        "seconds": round(time.time() - t0, 2),
    }
    return findings, blob
