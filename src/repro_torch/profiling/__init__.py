"""Profiling: capture -> per-op-family breakdown -> PROFILE_*.json.

The port's counterpart of the reference's ``profiling`` package, over
``torch.profiler``:

* :mod:`repro_torch.profiling.tracer` — ``trace(...)`` (a
  ``torch.profiler`` capture scoped to a context manager, strict no-op when
  disabled) and ``annotate(...)`` (the named markers the serve engine and
  the trainer put around their waves, chunks and steps);
* :mod:`repro_torch.profiling.breakdown` — a stdlib-only reader of the
  Chrome trace ``torch.profiler`` writes, rolling device time up into op
  families (collective, GEMM, attention, host transfer, other), counting
  host syncs and naming each kernel's launching op, on the reference's
  versioned ``PROFILE_*.json`` schema;
* ``scripts/torch_profile.py`` — the CLI that captures a serve or train
  pass, renders the breakdown and diffs two PROFILE files.
"""
from repro_torch.profiling.breakdown import (FAMILIES, PROFILE_SCHEMA_VERSION,
                                             build_profile,
                                             classify_event_name,
                                             load_trace_events,
                                             summarize_events,
                                             validate_profile)
from repro_torch.profiling.tracer import TraceSession, annotate, trace

__all__ = [
    "trace", "annotate", "TraceSession",
    "load_trace_events", "summarize_events", "build_profile",
    "validate_profile", "classify_event_name",
    "FAMILIES", "PROFILE_SCHEMA_VERSION",
]
