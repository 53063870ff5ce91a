"""IR check families over traced-case summaries: IR001 collective
placement, IR002 numerics, IR003 memory budget.

Each check is a pure function of a :class:`~repro_torch.analysis.ir.trace.
CaseResult` (which may have come straight off the ``.ir_cache/`` disk
cache) plus the case's :class:`~repro_torch.core.hardware.HardwareProfile`:
no re-tracing.  Findings use ``path="ir:<case_id>"`` and ``scope=<entry>``,
so the ratchet identity survives line churn the same way the lint's does.
Ids, severities, constants and messages are the reference's.

* **IR000**: an entry that failed to trace at all.  The matrix is the
  product the reference ships; a cell that stopped running is a shipped
  configuration that stopped existing.
* **IR001**: a weight-sized all-gather/all-reduce inside the decode steps
  of a *decode* entry (``decode_loop``/``decode_chunk``).  The regression
  the reference's check was made for: FSDP rules leaking into serving,
  so that decode re-gathers weights every step; in the port, DTensor
  all-gathers of weights inside the decode loop.  "Weight-sized" =
  result *shape* equal to some >=2-d params leaf (or one layer of a
  stacked leaf) of ``WEIGHT_NUMEL_MIN``+ elements: activation
  all-reduces (batch x vocab) pass, as do activations whose element
  count merely collides with a weight's.
* **IR002**: numerics: any f64 value anywhere (silent x64 promotion, a
  numpy constant); a bf16->f32 conversion of a weight-shaped tensor inside
  a bf16-case *serve* entry (the whole weight upcast, paying the f32
  bandwidth the dtype knob was meant to save; ``train_step`` is exempt:
  f32 master params and optimizer moments are the mixed-precision
  recipe); a product whose operand -> result dtype transition is not in
  the explicit ``ACC_ALLOW`` allowlist.
* **IR003**: the traced run's peak live bytes vs the profile's
  ``hbm_bytes``: error over budget, warning within ``HEADROOM_WARN``.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, SEV_ERROR, SEV_WARNING
from repro_torch.analysis.ir.trace import CaseResult, EntrySummary
from repro_torch.core.hardware import HardwareProfile, find_profile

#: decode entries whose step bodies must stay free of weight-sized
#: collectives (training legitimately all-gathers FSDP-sharded weights)
DECODE_ENTRIES = ("decode_loop", "decode_chunk")

#: collective ops that move whole buffers (permutes move shards and are
#: how sharded KV caches legitimately rotate)
WEIGHT_MOVING_OPS = ("all-gather", "all-reduce")

#: sanctioned (operand dtype -> result dtype) transitions of a product.
#: Everything else that changes dtype across a product is a silent
#: promotion IR002 flags.
ACC_ALLOW = {
    ("bfloat16", "float32"),
    ("float16", "float32"),
    ("int8", "int32"),
    ("uint8", "int32"),
}

#: IR003 warns when the peak exceeds this fraction of hbm_bytes
HEADROOM_WARN = 0.8


def _finding(check_id: str, severity: str, case: CaseResult, entry: str,
             message: str) -> Finding:
    return Finding(check_id=check_id, severity=severity,
                   path=f"ir:{case.case_id}", line=0, scope=entry,
                   message=message)


def check_trace_errors(case: CaseResult) -> List[Finding]:
    """IR000: an entry of the shipped matrix no longer runs."""
    return [_finding("IR000", SEV_ERROR, case, entry,
                     f"entry failed to trace/lower: {err}")
            for entry, err in sorted(case.errors.items())]


def check_collectives(case: CaseResult) -> List[Finding]:
    """IR001: weight-sized collectives inside the decode loops."""
    out: List[Finding] = []
    weights = {tuple(s) for s in case.weight_shapes}
    for entry in DECODE_ENTRIES:
        summary = case.entries.get(entry)
        if summary is None:
            continue
        flagged = {}
        for rec in summary.while_collectives:
            if (rec["op"] in WEIGHT_MOVING_OPS
                    and tuple(rec.get("dims", ())) in weights):
                key = (rec["op"], tuple(rec["dims"]))
                flagged[key] = flagged.get(key, 0) + 1
        for (op, dims), count in sorted(flagged.items()):
            shape = "x".join(map(str, dims))
            out.append(_finding(
                "IR001", SEV_ERROR, case, entry,
                f"{count}x weight-shaped `{op}` ({shape}) inside "
                f"the fused decode loop — weights are being re-gathered "
                f"per step (FSDP rules leaking into serving; use "
                f"inference-TP rules: rules_for_mesh(mesh, fsdp=False))"))
    return out


def _entry_numeric_findings(case: CaseResult, entry: str,
                            summary: EntrySummary) -> List[Finding]:
    out: List[Finding] = []
    if summary.f64_avals:
        out.append(_finding(
            "IR002", SEV_ERROR, case, entry,
            f"{summary.f64_avals} float64 value(s) in the traced program — "
            f"silent x64 promotion; no profile budgets f64"))
    model_dtype = case.case_id.rsplit("/", 1)[1]
    # train_step legitimately promotes whole weights: mixed-precision
    # training keeps f32 master params and optimizer moments by design.
    # The bandwidth-sensitive contract is on the serve path only.
    if model_dtype == "bfloat16" and entry != "train_step":
        weights = {tuple(s) for s in case.weight_shapes}
        upcasts = [c for c in summary.converts
                   if c["src"] == "bfloat16" and c["dst"] == "float32"
                   and tuple(c.get("dims", ())) in weights]
        if upcasts:
            total = sum(c["numel"] for c in upcasts)
            shapes = sorted({"x".join(map(str, c["dims"])) for c in upcasts})
            out.append(_finding(
                "IR002", SEV_ERROR, case, entry,
                f"{len(upcasts)} weight-shaped bf16->f32 upcast(s) "
                f"({', '.join(shapes)}; {total} elements) — whole weights "
                f"promoted to f32 inside a bf16 program defeats the dtype "
                f"knob"))
    bad_accs = sorted({(d["lhs"], d["out"]) for d in summary.dots
                       if d["lhs"] != d["out"]
                       and (d["lhs"], d["out"]) not in ACC_ALLOW})
    for lhs, acc in bad_accs:
        out.append(_finding(
            "IR002", SEV_ERROR, case, entry,
            f"dot_general accumulates {lhs} into {acc}, which is not in "
            f"the accumulate-dtype allowlist {sorted(ACC_ALLOW)}"))
    return out


def check_numerics(case: CaseResult) -> List[Finding]:
    """IR002: silent upcasts / promotions in the traced programs."""
    out: List[Finding] = []
    for entry, summary in sorted(case.entries.items()):
        out += _entry_numeric_findings(case, entry, summary)
    return out


def peak_bytes(summary: EntrySummary) -> int:
    """Live-buffer peak: the traced run's own number when it has one, else
    the argument+output+temp sum (the reference's fallback, for summaries
    that carry those fields)."""
    mem = summary.memory
    if mem.get("peak_bytes"):
        return int(mem["peak_bytes"])
    return sum(int(mem.get(k) or 0) for k in
               ("argument_bytes", "output_bytes", "temp_bytes"))


def check_memory(case: CaseResult) -> List[Finding]:
    """IR003: peak live bytes vs the hardware profile's HBM capacity."""
    profile: HardwareProfile = find_profile(case.hardware)
    if profile is None:
        return [_finding("IR003", SEV_ERROR, case, "-",
                         f"case traced against unregistered hardware "
                         f"{case.hardware!r}; no capacity to budget against")]
    budget = profile.hbm_bytes
    out: List[Finding] = []
    for entry, summary in sorted(case.entries.items()):
        peak = peak_bytes(summary)
        if peak > budget:
            out.append(_finding(
                "IR003", SEV_ERROR, case, entry,
                f"live-buffer peak {peak / 2**30:.2f} GiB exceeds "
                f"{profile.name} HBM capacity {budget / 2**30:.2f} GiB"))
        elif peak > HEADROOM_WARN * budget:
            out.append(_finding(
                "IR003", SEV_WARNING, case, entry,
                f"live-buffer peak {peak / 2**30:.2f} GiB is within "
                f"{(1 - HEADROOM_WARN) * 100:.0f}% of {profile.name} HBM "
                f"capacity {budget / 2**30:.2f} GiB"))
    return out


def check_case(case: CaseResult) -> List[Finding]:
    """All per-case checks (IR000-IR003); IR004/IR005 live in
    :mod:`~repro_torch.analysis.ir.fingerprints` because they compare
    against the committed file rather than the case alone."""
    return (check_trace_errors(case) + check_collectives(case)
            + check_numerics(case) + check_memory(case))
