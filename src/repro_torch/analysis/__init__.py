"""Static invariant checking for the port, in its own terms.

The port's counterpart of the reference's ``analysis`` package.  Eager
PyTorch refuses none of the host syncs JAX refuses at trace time, so the
port needs these checks more than the reference does.  Everything here is
stdlib ``ast`` plus the port's own modules: no JAX, no accelerator, so it
runs on the card's machine too.

* :mod:`~repro_torch.analysis.callgraph` — module index + the step-code
  call graph (what runs once per device step: the ``Model`` step methods,
  autograd and ``torch.library`` bodies, checkpointed functions, the
  ``make_*_step`` steps, the serve engine's decode scopes);
* :mod:`~repro_torch.analysis.purity` — TP00x host-sync lint over that
  graph and the serve/train drivers (transfers and waits, coercions,
  Python branches on device values, nondeterminism, step entries outside
  ``profiling.annotate`` scopes);
* :mod:`~repro_torch.analysis.artifacts` — AR00x validation of
  ``src/repro_torch/tuned/*.json`` against their ``HardwareProfile`` and
  the schedules ``kernels/csrc`` instantiates;
* :mod:`~repro_torch.analysis.coverage` — SH00x sharding-rule coverage
  of the model families' ``ParamSpec`` templates;
* :mod:`~repro_torch.analysis.stats_checks` — ST001, the engine's
  ``stats()`` keys against ``serve.stats_schema``;
* :mod:`~repro_torch.analysis.findings` — the :class:`Finding` record
  and the committed-baseline ratchet (``analysis/baseline.json``, empty);
* :mod:`~repro_torch.analysis.pragmas` — the ``# analysis: allow``
  waiver ledger and the PR900 unused-pragma check.

Entry point: :mod:`repro_torch.analysis.cli`: ``python -m
repro_torch.analysis`` or the ``repro-torch-analyze`` console script
(``lint | artifacts | coverage | stats | pragmas | report``).
"""
from repro_torch.analysis.findings import (BASELINE_SCHEMA_VERSION, Finding,
                                           SEV_ERROR, SEV_WARNING,
                                           default_baseline_path,
                                           load_baseline, ratchet,
                                           save_baseline, sort_findings)

__all__ = [
    "BASELINE_SCHEMA_VERSION", "Finding", "SEV_ERROR", "SEV_WARNING",
    "default_baseline_path", "load_baseline", "ratchet", "save_baseline",
    "sort_findings",
]
