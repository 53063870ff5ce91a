"""IR005 program fingerprints + the committed
``src/repro_torch/analysis/ir_fingerprints.json``.

Every traced case commits, per entry point, the hash of its canonical op
sequence and the op histogram behind it, plus the IR004 static step-key
counts.  An unintended program change (an op sneaking into the decode
loop, a remat policy flipping, a bucketing edit) fails with a
*structural* diff ("+2 aten._to_copy, -1 repro_torch.gemm in
decode_chunk") instead of silently shifting perf three PRs later.

Blessing workflow: make the change, read the diff IR005 prints, then
re-bless both legs with::

    PYTHONPATH=src python -m repro_torch.analysis ir --write-fingerprints
    PYTHONPATH=src python -m repro_torch.analysis ir \\
        --mesh data=4,model=2 --write-fingerprints

Writes *merge* per case, so the single-device and mesh legs maintain one
file.  Hashes are only comparable within one torch version (another
release dispatches other ops for the same code); the file records the
version it was blessed under, and on a version mismatch IR005 degrades to
a warning-severity structural comparison instead of failing the gate.
IR004 key counts are pure bucket math and gate on every version.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding, SEV_ERROR, SEV_WARNING
from repro_torch.analysis.ir.trace import CaseResult

FINGERPRINT_SCHEMA_VERSION = 1


def default_fingerprint_path() -> str:
    """``ir_fingerprints.json`` beside the analysis package's
    ``baseline.json``."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ir_fingerprints.json")


def case_record(case: CaseResult, jit_keys: Dict[str, int]) -> dict:
    """The per-case blob committed to the fingerprint file."""
    return {
        "jit_keys": dict(sorted(jit_keys.items())),
        "entries": {
            entry: {"program_hash": s.program_hash,
                    "prims": dict(sorted(s.prim_histogram.items()))}
            for entry, s in sorted(case.entries.items())
        },
    }


def load_fingerprints(path: Optional[str] = None) -> dict:
    path = path or default_fingerprint_path()
    if not os.path.exists(path):
        return {"schema_version": FINGERPRINT_SCHEMA_VERSION,
                "torch_version": None, "cases": {}}
    with open(path) as f:
        blob = json.load(f)
    ver = blob.get("schema_version")
    if ver != FINGERPRINT_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: ir_fingerprints schema_version {ver!r} != supported "
            f"{FINGERPRINT_SCHEMA_VERSION}; regenerate with "
            f"`python -m repro_torch.analysis ir --write-fingerprints`")
    return blob


def merge_fingerprints(records: Dict[str, dict], torch_version: str,
                       path: Optional[str] = None) -> str:
    """Bless ``{case_id: case_record}`` into the committed file, keeping
    cases from other legs (the mesh matrix) untouched."""
    path = path or default_fingerprint_path()
    blob = load_fingerprints(path)
    blob["cases"].update(records)
    out = {
        "schema_version": FINGERPRINT_SCHEMA_VERSION,
        "torch_version": torch_version,
        "note": ("Per-config program fingerprints (IR005) and static "
                 "step-key counts (IR004) of the port.  Re-bless after an "
                 "intended program change with `python -m "
                 "repro_torch.analysis ir --write-fingerprints`, once "
                 "without and once with --mesh data=4,model=2."),
        "cases": {k: blob["cases"][k] for k in sorted(blob["cases"])},
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def structural_diff(old_prims: Dict[str, int],
                    new_prims: Dict[str, int]) -> str:
    """Readable op-histogram delta: ``+2 aten._to_copy, -1
    repro_torch.gemm`` (empty string when histograms match: the change is
    below the op level, e.g. shapes or dtypes)."""
    deltas = []
    for prim in sorted(set(old_prims) | set(new_prims)):
        d = new_prims.get(prim, 0) - old_prims.get(prim, 0)
        if d:
            deltas.append(f"{d:+d} {prim}")
    return ", ".join(deltas)


def _finding(check_id: str, severity: str, case_id: str, scope: str,
             message: str) -> Finding:
    return Finding(check_id=check_id, severity=severity,
                   path=f"ir:{case_id}", line=0, scope=scope, message=message)


def compare_case(case_id: str, record: dict, committed: dict,
                 torch_matches: bool) -> List[Finding]:
    """Diff one case's fresh record against the committed fingerprints.

    IR004 (step-key counts) always gates; IR005 (program hashes) gates
    only when the running torch version matches the blessed one, else
    downgrades to structural warnings.
    """
    out: List[Finding] = []
    base = committed.get("cases", {}).get(case_id)
    if base is None:
        out.append(_finding(
            "IR005", SEV_ERROR, case_id, "-",
            "config has no committed fingerprint — new matrix cell; bless "
            "with `python -m repro_torch.analysis ir --write-fingerprints`"))
        return out

    for entry in sorted(set(base["jit_keys"]) | set(record["jit_keys"])):
        old = base["jit_keys"].get(entry)
        new = record["jit_keys"].get(entry)
        if old != new:
            out.append(_finding(
                "IR004", SEV_ERROR, case_id, entry,
                f"static step-key count changed: {old} -> {new} (bucket "
                f"policy or step signature moved; expected? re-bless "
                f"with --write-fingerprints)"))

    for entry in sorted(set(base["entries"]) | set(record["entries"])):
        old = base["entries"].get(entry)
        new = record["entries"].get(entry)
        if old is None or new is None:
            out.append(_finding(
                "IR005", SEV_ERROR, case_id, entry,
                f"entry {'appeared' if old is None else 'disappeared'} "
                f"relative to the committed fingerprint"))
            continue
        if old["program_hash"] == new["program_hash"]:
            continue
        diff = structural_diff(old["prims"], new["prims"])
        detail = (f"op delta: {diff}" if diff else
                  "same op histogram — shape/dtype-level change")
        if torch_matches:
            out.append(_finding(
                "IR005", SEV_ERROR, case_id, entry,
                f"traced program changed ({detail}); if intended, re-bless "
                f"with `python -m repro_torch.analysis ir "
                f"--write-fingerprints`"))
        else:
            out.append(_finding(
                "IR005", SEV_WARNING, case_id, entry,
                f"program hash differs under torch "
                f"{committed.get('torch_version') or '?'}"
                f"-blessed fingerprints ({detail}); hash gate inactive "
                f"across torch versions"))
    return out
