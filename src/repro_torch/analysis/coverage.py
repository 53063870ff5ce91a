"""Sharding-coverage check: the SH00x family over the port's rules.

The port's counterpart of the reference's ``analysis/coverage.py``.
``distributed/sharding.py`` maps logical param axes (``vocab``, ``ff``,
``embed``, ...) to mesh axes.  Nothing guarantees every model family's
param tree speaks that vocabulary: a new module can introduce an axis name
the rules have never heard of, and ``spec_for_param`` will silently
replicate the leaf.  This check walks each family's ``ParamSpec`` template
(``build_model(cfg.reduced()).template``: shapes and logical axes, no
tensors) and audits it against both rule sets the port serves with (FSDP
for training, inference tensor parallelism for serving):

==========  =========  =====================================================
check id    severity   fires on
==========  =========  =====================================================
``SH001``   error      a leaf carrying a logical axis name absent from
                       ``ShardingRules.logical_map``: no rule matches; the
                       leaf is silently replicated forever
``SH002``   warning    two dims of one leaf mapping to the same mesh axis:
                       first-dim-wins applies, the second dim is quietly
                       replicated
``SH003``   warning    a dead rule: a logical axis the rule set maps to a
                       mesh axis that **no** leaf of any family uses
``SH004``   warning    a >=2-D leaf with >= 2 named (non-``layer``) axes
                       whose spec is fully replicated under the rules
==========  =========  =====================================================

The audit runs on a size-1 stub mesh so divisibility never masks a mapping
question.  Scopes name each leaf as the reference's
``jax.tree_util.keystr`` does (``['blocks']['attn']['wq']``), so the two
packages' findings compare one for one.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding, SEV_ERROR, SEV_WARNING

SLUGS = {
    "SH001": "unmatched-leaf",
    "SH002": "multi-dim-same-axis",
    "SH003": "dead-rule",
    "SH004": "replicated-matrix",
}

#: one representative per model family (dense / ssm / moe / vlm / audio),
#: the reference's ``COVERAGE_FAMILIES``
COVERAGE_FAMILIES = ("llama3.2-1b", "mamba2-130m", "olmoe-1b-7b",
                     "llama-3.2-vision-11b", "whisper-large-v3")

#: the two rule sets the port runs: FSDP training, inference TP
RULE_SET_KINDS = ("fsdp", "inference-tp")

_PATH = "src/repro_torch/distributed/sharding.py"


class _StubMesh:
    """Duck-typed mesh: the spec functions read only axis names and
    sizes.  Size-1 axes make every dim divisible, so the audit sees the
    pure rule mapping rather than one topology's divisor accidents."""
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


def _rule_sets():
    from repro_torch.distributed.sharding import rules_for_mesh
    mesh = _StubMesh()
    return {"fsdp": rules_for_mesh(mesh, fsdp=True),
            "inference-tp": rules_for_mesh(mesh, fsdp=False)}


def _keyed_leaves(tree, key: str = "") -> List[Tuple[str, object]]:
    """(keystr path, leaf) pairs, dict keys sorted as JAX flattens them."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _keyed_leaves(tree[k], f"{key}[{k!r}]")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += _keyed_leaves(v, f"{key}[{i}]")
        return out
    return [(key, tree)]


def _leaf_items(family: str) -> List[Tuple[str, object]]:
    """(path, ParamSpec) pairs of one family's param template."""
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.models import build_model

    cfg = ARCHITECTURES[family].reduced()
    return _keyed_leaves(build_model(cfg).template)


def check_coverage(families=COVERAGE_FAMILIES) -> List[Finding]:
    findings: List[Finding] = []
    rule_sets = _rule_sets()
    # logical axes seen on any leaf of any family
    seen_axes: set = set()

    for family in families:
        for path, spec in _leaf_items(family):
            axes = tuple(spec.axes)
            seen_axes.update(a for a in axes if a is not None)
            for kind, rules in rule_sets.items():
                mapping = rules.logical_map()
                scope = f"{family}:{path}[{kind}]"
                unknown = sorted({a for a in axes
                                  if a is not None and a not in mapping})
                if unknown:
                    findings.append(Finding(
                        check_id="SH001", severity=SEV_ERROR, path=_PATH,
                        line=0, scope=scope,
                        message=(f"logical axes {unknown} match no rule in "
                                 f"ShardingRules.logical_map: leaf "
                                 f"{spec.shape} silently replicated")))
                    continue
                mapped = [mapping.get(a) for a in axes]
                hits = [m for m in mapped if m is not None]
                if len(hits) != len(set(hits)):
                    dup = sorted({m for m in hits if hits.count(m) > 1})
                    findings.append(Finding(
                        check_id="SH002", severity=SEV_WARNING, path=_PATH,
                        line=0, scope=scope,
                        message=(f"dims {axes} map {dup} twice: "
                                 f"first-dim-wins replicates the rest")))
                # a matrix is worth a warning only when >= 2 of its dims
                # carry real (non-layer-stacking) logical names and still
                # none of them is sharded
                named = [a for a in axes if a not in (None, "layer")]
                if len(named) >= 2 and not hits:
                    findings.append(Finding(
                        check_id="SH004", severity=SEV_WARNING, path=_PATH,
                        line=0, scope=scope,
                        message=(f"{len(spec.shape)}-D leaf {spec.shape} "
                                 f"with axes {axes} is fully replicated "
                                 f"under the {kind} rules")))

    # dead rules: mapped logical axes no family's template ever mentions
    for kind, rules in rule_sets.items():
        for logical, mesh_axis in rules.logical_map().items():
            if logical is None or mesh_axis is None:
                continue
            if logical not in seen_axes:
                findings.append(Finding(
                    check_id="SH003", severity=SEV_WARNING, path=_PATH,
                    line=0, scope=f"{logical}[{kind}]",
                    message=(f"rule {logical!r} -> {mesh_axis!r} matches "
                             f"no param leaf of any model family: dead "
                             f"rule (or a family lost its axis names)")))
    return findings


def coverage_summary(families=COVERAGE_FAMILIES) -> Dict[str, dict]:
    """Per-family leaf/spec statistics for the CLI report."""
    from repro_torch.distributed.sharding import spec_for_param
    rule_sets = _rule_sets()
    mesh = _StubMesh()
    out: Dict[str, dict] = {}
    for family in families:
        items = _leaf_items(family)
        per_kind = {}
        for kind, rules in rule_sets.items():
            sharded = sum(
                1 for _p, s in items
                if any(a is not None for a in spec_for_param(mesh, rules, s)))
            per_kind[kind] = {"leaves": len(items), "sharded": sharded}
        out[family] = per_kind
    return out
