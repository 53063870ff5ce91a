"""Findings + the committed-baseline ratchet of the port's static checks.

The port's counterpart of the reference's ``analysis/findings.py``, with
the same record and the same ratchet.  A :class:`Finding` is one invariant
violation: a check id (``TP001``, ``AR002``, ...), a severity, a
repo-relative location, and a *scope* (the function qualname, artifact
entry or param leaf it anchors to).  The ratchet identity is
``check_id:path:scope``, not the line: unrelated edits shift lines all the
time, and a ratchet that churned on every shift would be re-blessed
blindly.  The line is still reported for navigation.

The committed baseline, ``src/repro_torch/analysis/baseline.json``, lists
the findings allowed to exist.  Any error whose key it does not list fails
the gate; a baseline key no finding matches any more is reported, so the
smaller set can be blessed with ``python -m repro_torch.analysis report
--update-baseline``.  The shipped baseline is **empty**: every sanctioned
host sync carries an ``# analysis: allow(...)`` pragma at its line instead,
so the waiver is visible in the code it waives.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

#: current on-disk schema of the baseline file
BASELINE_SCHEMA_VERSION = 1

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEVERITIES = (SEV_ERROR, SEV_WARNING)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One static-invariant violation, ratchet-keyed by (check, path, scope)."""
    check_id: str            # e.g. "TP001"
    severity: str            # error | warning
    path: str                # repo-relative file (or artifact) path
    line: int                # 1-based; 0 for whole-file/artifact findings
    scope: str               # function qualname / artifact entry / param leaf
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}; "
                             f"known: {SEVERITIES}")

    @property
    def key(self) -> str:
        """Line-free ratchet identity (see module docstring)."""
        return f"{self.check_id}:{self.path}:{self.scope}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return (f"{loc}: {self.check_id} [{self.severity}] "
                f"{self.scope}: {self.message}")

    def to_json(self) -> dict:
        return {"check_id": self.check_id, "severity": self.severity,
                "path": self.path, "line": self.line, "scope": self.scope,
                "message": self.message, "key": self.key}


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Stable report order: errors first, then path/line/check."""
    return sorted(findings,
                  key=lambda f: (f.severity != SEV_ERROR, f.path, f.line,
                                 f.check_id, f.scope))


# ---------------------------------------------------------------------------
# Baseline ratchet
# ---------------------------------------------------------------------------

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str] = None) -> Dict[str, dict]:
    """``{finding key: baseline entry}``; missing file -> empty baseline."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        blob = json.load(f)
    ver = blob.get("schema_version")
    if ver != BASELINE_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: analysis baseline schema_version {ver!r} != supported "
            f"{BASELINE_SCHEMA_VERSION}; regenerate with "
            f"`python -m repro_torch.analysis report --update-baseline`")
    return {e["key"]: e for e in blob.get("findings", [])}


def save_baseline(findings: Iterable[Finding],
                  path: Optional[str] = None) -> str:
    """Bless the given findings as the new ratchet floor."""
    path = path or default_baseline_path()
    entries = sorted(
        ({"key": f.key, "check_id": f.check_id, "severity": f.severity,
          "path": f.path, "scope": f.scope, "message": f.message}
         for f in findings), key=lambda e: e["key"])
    blob = {
        "schema_version": BASELINE_SCHEMA_VERSION,
        "note": ("Known findings the analyze gate tolerates (ratchet floor)."
                 "  Shrink it; never grow it without a review.  Bless with"
                 " `python -m repro_torch.analysis report"
                 " --update-baseline`."),
        "findings": entries,
    }
    with open(path, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def ratchet(findings: Iterable[Finding], baseline: Dict[str, dict],
            ) -> Tuple[List[Finding], List[str]]:
    """Split current findings against the baseline.

    Returns ``(new_findings, fixed_keys)``: findings whose key the baseline
    does not list (these fail the gate), and baseline keys no current
    finding matches (candidates for re-blessing the smaller floor).
    """
    current = list(findings)
    current_keys = {f.key for f in current}
    new = [f for f in current if f.key not in baseline]
    fixed = sorted(k for k in baseline if k not in current_keys)
    return sort_findings(new), fixed
