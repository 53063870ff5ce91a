"""ST001: the port's ``Engine.stats()`` key set must match its
``stats_schema``.

The port's counterpart of the reference's ``analysis/stats_checks.py``,
over ``src/repro_torch/serve/engine.py`` and
:mod:`repro_torch.serve.stats_schema`.  The stats schema is the documented,
versioned contract that launchers, benchmarks and the CI step summary
render from.  The engine *emits* that dict imperatively — a seeded
``self._stats`` counter literal plus ``out["..."] = ...`` assignments in
``stats()`` — so nothing ties emission to documentation at runtime except
the tests that happen to call :func:`~repro_torch.serve.stats_schema
.validate_stats`.  This check closes the loop statically: it AST-scans
``engine.py`` for every key the engine can emit and diffs that set against
``STATS_SCHEMA``.  Drift in either direction is an error:

==========  =========  =====================================================
check id    severity   fires on
==========  =========  =====================================================
``ST001``   error      a key ``stats()`` emits that ``STATS_SCHEMA`` does
                       not document, or a documented key no code path
                       emits — bump ``SCHEMA_VERSION`` and update the
                       schema (and its consumers) instead of letting the
                       surfaces drift apart
==========  =========  =====================================================

The scan is deliberately syntactic: string-literal keys in the
``self._stats`` seed dict and in subscript stores onto ``stats()``'s
result dict.  Dynamically-computed keys would evade it, which is exactly
the style this check exists to keep out of the telemetry surface.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding, SEV_ERROR

SLUGS = {
    "ST001": "stats-schema-drift",
}

#: the module that emits the stats dict, relative to the repo root
ENGINE_REL = os.path.join("src", "repro_torch", "serve", "engine.py")


def _literal_keys(node: ast.Dict) -> Set[str]:
    return {k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


class _EmittedKeys(ast.NodeVisitor):
    """Collect every stats key ``Engine`` can emit.

    Two emission sites, by construction of the engine:

    * the ``self._stats = {...}`` counter seed in ``__init__`` (its keys
      pass straight through ``stats()``'s ``dict(self._stats)`` copy);
    * ``<name>["key"] = ...`` subscript stores inside the ``stats``
      method, whatever the local result dict is called.
    """

    def __init__(self):
        self.keys: Set[str] = set()
        self.stats_line: int = 0
        self._in_stats = False

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node.name == "stats":
            self.stats_line = node.lineno
            self._in_stats = True
            self.generic_visit(node)
            self._in_stats = False
        else:
            self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # self._stats = {...} seed literal
        for tgt in node.targets:
            if (isinstance(tgt, ast.Attribute) and tgt.attr == "_stats"
                    and isinstance(node.value, ast.Dict)):
                self.keys |= _literal_keys(node.value)
            if (self._in_stats and isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.slice, ast.Constant)
                    and isinstance(tgt.slice.value, str)
                    and isinstance(tgt.value, ast.Name)):
                self.keys.add(tgt.slice.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        tgt = node.target
        if (isinstance(tgt, ast.Attribute) and tgt.attr == "_stats"
                and isinstance(node.value, ast.Dict)):
            self.keys |= _literal_keys(node.value)
        self.generic_visit(node)


def emitted_stats_keys(engine_path: str) -> Tuple[Set[str], int]:
    """The statically-visible key set ``stats()`` can emit, plus the
    ``stats()`` def line for finding locations."""
    with open(engine_path) as f:
        tree = ast.parse(f.read(), filename=engine_path)
    visitor = _EmittedKeys()
    visitor.visit(tree)
    return visitor.keys, visitor.stats_line


def check_stats_schema(root: str, engine_rel: Optional[str] = None
                       ) -> List[Finding]:
    """ST001 over one repo checkout; empty list = schema and emission
    agree exactly."""
    from repro_torch.serve.stats_schema import STATS_SCHEMA
    rel = engine_rel or ENGINE_REL
    path = os.path.join(root, rel)
    findings: List[Finding] = []
    if not os.path.exists(path):
        findings.append(Finding(
            check_id="ST001", severity=SEV_ERROR, path=rel, line=0,
            scope="Engine.stats",
            message="engine module missing: nothing emits the stats "
                    "schema"))
        return findings
    emitted, line = emitted_stats_keys(path)
    documented = set(STATS_SCHEMA)
    for key in sorted(emitted - documented):
        findings.append(Finding(
            check_id="ST001", severity=SEV_ERROR, path=rel, line=line,
            scope=f"stats.{key}",
            message=f"stats() emits {key!r} but stats_schema.STATS_SCHEMA "
                    f"does not document it; add it to the schema and bump "
                    f"SCHEMA_VERSION"))
    for key in sorted(documented - emitted):
        findings.append(Finding(
            check_id="ST001", severity=SEV_ERROR, path=rel, line=line,
            scope=f"stats.{key}",
            message=f"STATS_SCHEMA documents {key!r} but no stats() code "
                    f"path emits it; remove it from the schema and bump "
                    f"SCHEMA_VERSION"))
    return findings
