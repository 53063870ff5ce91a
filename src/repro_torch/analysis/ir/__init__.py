"""IR-level program contract checker: run the config matrix's engine
entries once each under a dispatch counter, and check the programs they
dispatch.

The lint (:mod:`repro_torch.analysis.purity`) sees source text; the
profiler sees one live run.  A whole regression class lives in between,
visible only in the *program* an entry runs: a weight all-gather DTensor
placed inside the decode loop, a silent dtype promotion, a bucket edit
that fans out the step shapes.  The port runs eagerly, so nothing checks
its step programs the way XLA's lowering checked the reference's: this
package runs each engine entry once on tiny CPU tensors under
``launch.step_stats``'s ``TorchDispatchMode`` counter, for every (model
family x scheduler x mesh x dtype) cell the reference ships, and checks
what it dispatched.

Modules:

* :mod:`~repro_torch.analysis.ir.matrix`       — the IRCase config matrix;
* :mod:`~repro_torch.analysis.ir.trace`        — the traced run + the
  check-ready EntrySummary extraction + the ``.ir_cache/`` summary cache;
* :mod:`~repro_torch.analysis.ir.checks`       — IR000 (trace failure),
  IR001 (decode-loop collective placement), IR002 (numerics), IR003
  (memory budget vs ``HardwareProfile.hbm_bytes``);
* :mod:`~repro_torch.analysis.ir.recompile`    — IR004 static step-key
  enumeration (one key: one step shape, one CUDA graph to capture);
* :mod:`~repro_torch.analysis.ir.fingerprints` — IR005 program
  fingerprints vs the committed
  ``src/repro_torch/analysis/ir_fingerprints.json``;
* :mod:`~repro_torch.analysis.ir.runner`       — orchestration ->
  (findings, IR_REPORT blob).

Entry point: ``python -m repro_torch.analysis ir``.  Nothing here imports
JAX or the reference package.
"""
from repro_torch.analysis.ir.matrix import (DTYPES, FAMILIES, IRCase,
                                            SCHEDULERS, default_matrix,
                                            smoke_matrix)
from repro_torch.analysis.ir.runner import run_ir

__all__ = ["DTYPES", "FAMILIES", "IRCase", "SCHEDULERS", "default_matrix",
           "run_ir", "smoke_matrix"]
