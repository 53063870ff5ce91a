"""Trace capture: a scoped ``torch.profiler`` session + code markers.

``trace(dir)`` runs ``torch.profiler.profile`` over the block, with the
CPU's activity and, where a card is present, CUDA's, and writes the
capture into a directory of its own under ``dir`` (what
``breakdown.load_trace_events`` reads).  When profiling is off
(``enabled=False`` or no directory) it is a STRICT no-op: no directory
created, no environment variable touched, no profiler started, so it can
stay in the serve and train launchers at no cost.  A capture on the card
that holds no device event is an error, raised when the block ends: a
breakdown of host ops alone would pass for the card's.

``annotate(name)`` is the span the engine, the trainer and the model's
layers put around their hot paths: a ``torch.profiler.record_function``
range (a host-side ``user_annotation`` event, to which a trace's reader
attributes the kernels launched inside it, e.g. ``serve.decode_chunk``).
``count(name, **values)`` records host-side counts beside the spans: a
zero-length range named ``"<name> k1=v1 k2=v2"`` (a range's own arguments
never reach the Chrome trace).  While no profiler runs on the calling
thread both cost one check and enter nothing, so they are unconditional.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.profiling.breakdown import (DEVICE_CATEGORIES,
                                             capture_files, find_capture_dirs,
                                             load_trace_events)


@dataclasses.dataclass
class TraceSession:
    """Handle yielded by :func:`trace`: where the capture landed (if on)."""
    dir: Optional[str]
    enabled: bool
    #: the events of this session's capture, once read
    _events: Optional[List[dict]] = dataclasses.field(default=None,
                                                      repr=False)

    def trace_files(self) -> List[str]:
        """The captured ``*.pt.trace.json`` files under ``dir`` (newest
        capture first); a process may trace more than once into one dir."""
        if not self.dir:
            return []
        return [f for d in find_capture_dirs(self.dir)
                for f in capture_files(d)]

    def events(self) -> List[dict]:
        """Parsed Chrome-trace events of the newest capture ([] when off;
        read once)."""
        if not self.enabled:
            return []
        if self._events is None:
            self._events = load_trace_events(self.dir)
        return self._events


@contextlib.contextmanager
def trace(out_dir: Optional[str] = None, *,
          enabled: bool = True) -> Iterator[TraceSession]:
    """Capture a ``torch.profiler`` trace into ``out_dir`` for the block.

    Disabled (``enabled=False`` or falsy ``out_dir``) it yields an inert
    session and touches nothing.  Enabled, it creates
    ``out_dir/<time_ns>/``, starts the profiler (CUDA activity too where a
    card is present), and stops it on exit, also on an exception, after a
    device sync, so a crashed wave still leaves a parseable capture.
    """
    if not enabled or not out_dir:
        yield TraceSession(dir=None, enabled=False)
        return
    capture = os.path.join(out_dir, str(time.time_ns()))
    os.makedirs(capture)
    on_card = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # uncompressed: gzip's default level takes longer than the run it
    # traces for a serve's ~10^5 events
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(capture))
    session = TraceSession(dir=out_dir, enabled=True)
    prof.start()
    try:
        yield session
    finally:
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
    if not on_card:
        return
    session._events = load_trace_events(capture)
    if not any(e.get("cat") in DEVICE_CATEGORIES for e in session._events):
        raise RuntimeError(
            f"the capture in {capture!r} holds no device event: the "
            "profiler did not trace the card")


#: what :func:`annotate` returns while no profiler runs (reentrant)
_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    """A ``torch.profiler`` session records this thread's ranges."""
    return torch.autograd._profiler_enabled()


def annotate(name: str):
    """Mark a code region in the trace timeline: a context manager that
    enters a ``record_function`` range while a profiler runs, and nothing
    otherwise."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


def count_label(name: str, values: Dict[str, int]) -> str:
    """``"<name> k1=v1 k2=v2"``: the range name :func:`count` records."""
    return " ".join([name] + [f"{k}={int(v)}" for k, v in values.items()])


def parse_count(label: str) -> Tuple[str, Dict[str, int]]:
    """Inverse of :func:`count_label`: ``(name, {key: int})``."""
    name, *pairs = label.split(" ")
    return name, {k: int(v) for k, v in (p.split("=", 1) for p in pairs)}


def count(name: str, **values: int) -> None:
    """Record integer counts in the trace, while a profiler runs: a
    zero-length range named :func:`count_label` ``(name, values)``."""
    if _profiling():
        with torch.profiler.record_function(count_label(name, values)):
            pass
