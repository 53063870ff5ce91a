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

``annotate(name)`` is the marker the engine and trainer put around their
hot paths: a ``torch.profiler.record_function`` range (a host-side
``user_annotation`` event, how the breakdown attributes wall time to e.g.
``serve.decode_chunk``), plus an NVTX range on the card.  Both are near
free when no trace is active, so annotations are unconditional.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, List, Optional

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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Mark a code region in the trace timeline (and, on the card, as an
    NVTX range)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
