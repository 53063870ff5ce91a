"""Pragma ledger: every ``# analysis: allow(...)`` site under
``src/repro_torch``, what it actually suppresses, and the PR900
unused-pragma check.

The port's counterpart of the reference's ``analysis/pragmas.py``.
Pragmas are the sanctioned-waiver mechanism of the host-sync lint (see
:mod:`repro_torch.analysis.purity`): a ``# analysis: allow(TP001)`` on (or
right above) an offending line silences that check there.  A waiver whose
offense has since been refactored away would silently excuse the *next*
violation written on that line, so the lint runs with a
:class:`PragmaLedger` that records every suppression it performs, and
:func:`unused_pragma_findings` turns each pragma site that suppressed
nothing into a **PR900** error on the same baseline ratchet as every other
finding.

``python -m repro_torch.analysis --list-pragmas`` (or the ``pragmas``
subcommand) prints the ledger: each site, the checks it waives, and which
findings it is currently eating.
"""
from __future__ import annotations

import dataclasses
import io
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, SEV_ERROR
from repro_torch.analysis.purity import _PRAGMA_RE, SLUGS

#: slug -> check id (a pragma may name either; the ledger normalizes)
_SLUG_TO_ID = {slug: cid for cid, slug in SLUGS.items()}


@dataclasses.dataclass(frozen=True)
class PragmaSite:
    """One ``# analysis: allow(...)`` occurrence in the source tree."""
    path: str                                # repo-relative module path
    line: int                                # 1-indexed pragma line
    check_ids: Optional[Tuple[str, ...]]     # None = bare allow (waives all)
    text: str                                # the pragma text as written

    @property
    def label(self) -> str:
        if self.check_ids is None:
            return "allow(*)"
        return f"allow({', '.join(self.check_ids)})"


def _normalize(tokens: str) -> Tuple[str, ...]:
    out = []
    for tok in tokens.split(","):
        tok = tok.strip()
        if tok:
            out.append(_SLUG_TO_ID.get(tok, tok))
    return tuple(sorted(set(out)))


def _comment_lines(source: str) -> Set[int]:
    """Line numbers holding a real ``#`` comment token — pragma *mentions*
    in docstrings and string literals (this package documents the syntax a
    lot) are not pragma sites."""
    out: Set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.add(tok.start[0])
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def scan_pragmas(graph) -> List[PragmaSite]:
    """Every pragma site in the graph's module index (all of
    src/repro_torch)."""
    sites: List[PragmaSite] = []
    for path, mod in sorted(graph.modules.items()):
        commented = _comment_lines("\n".join(mod.lines) + "\n")
        for lineno, line in enumerate(mod.lines, start=1):
            if lineno not in commented:
                continue
            m = _PRAGMA_RE.search(line)
            if m is None:
                continue
            tokens = m.group(1)
            ids = (None if tokens is None or not tokens.strip()
                   else _normalize(tokens))
            sites.append(PragmaSite(path=path, line=lineno, check_ids=ids,
                                    text=m.group(0).strip()))
    return sites


class PragmaLedger:
    """Suppressions the lint actually performed, keyed by pragma site."""

    def __init__(self):
        self._hits: Dict[Tuple[str, int], Set[str]] = {}

    def record(self, path: str, pragma_line: int, check_id: str) -> None:
        self._hits.setdefault((path, pragma_line), set()).add(check_id)

    def suppressed(self, path: str, line: int) -> Set[str]:
        return self._hits.get((path, line), set())

    def count(self) -> int:
        return sum(len(v) for v in self._hits.values())


def unused_pragma_findings(sites: Sequence[PragmaSite],
                           ledger: PragmaLedger) -> List[Finding]:
    """PR900 — a pragma that no longer suppresses anything.  Either its
    offense was refactored away (delete the pragma) or it was written
    somewhere the lint never looks (it never worked)."""
    out: List[Finding] = []
    for site in sites:
        if ledger.suppressed(site.path, site.line):
            continue
        out.append(Finding(
            check_id="PR900", severity=SEV_ERROR, path=site.path,
            line=site.line, scope=site.label,
            message=(f"`{site.text}` suppresses no finding (a stale waiver): "
                     f"delete it (a dead pragma silently excuses the next "
                     f"violation written on this line)")))
    return out


def pragma_table(sites: Sequence[PragmaSite],
                 ledger: PragmaLedger) -> List[dict]:
    """JSON-ready rows for ``--list-pragmas`` and the findings blob."""
    return [{
        "path": s.path,
        "line": s.line,
        "allows": list(s.check_ids) if s.check_ids is not None else ["*"],
        "suppresses": sorted(ledger.suppressed(s.path, s.line)),
        "live": bool(ledger.suppressed(s.path, s.line)),
    } for s in sites]
