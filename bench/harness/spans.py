"""The program's own spans and counts inside a traced slice.

The program marks regions of its work with named ranges (``model.attn``,
``model.moe.route``, ``serve.kv_gather``, ...) and records what each
admission prefill and decode chunk did as a zero-length range whose name
carries the counts: ``"serve.counts.chunk rows=64 steps=8 ..."``.  Both
are ``user_annotation`` events of the trace's host side.  A device kernel
belongs to a span when the host call that launched it (matched by the
trace's correlation id) lies inside one of its instances, as in
``trace.py``.

Every reader returns None when the slice holds none of what it reads, so
a program that lacks a span (or runs the step in a way that records
none) leaves the metric out instead of reading 0.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Tuple

from harness.trace import DECODE, Trace

_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

#: the program's count ranges read here
ADMIT_COUNTS = "serve.counts.admit"
CHUNK_COUNTS = "serve.counts.chunk"


def parse_count(label: str) -> Tuple[str, Dict[str, int]]:
    """``"<name> k1=v1 k2=v2"`` -> ``(name, {k1: v1, k2: v2})`` (integer
    values); a plain span's name parses to ``(name, {})``."""
    name, *pairs = label.split(" ")
    return name, {k: int(v) for k, v in (p.split("=", 1) for p in pairs)}


def _union(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(intervals: List[Tuple[float, float]], t: float) -> bool:
    """``t`` lies in one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


class Spans:
    """The launch map, the span instances and the counts of one slice,
    rebuilt from ``Trace.host``."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.launch: Dict[object, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.counts: Dict[str, List[Dict[str, int]]] = \
            collections.defaultdict(list)
        for e in trace.host:
            cat = e.get("cat")
            if cat in _LAUNCH_CATEGORIES:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    self.launch[c] = e["ts"]
            elif cat == "user_annotation":
                name, values = parse_count(str(e.get("name", "")))
                if values:
                    self.counts[name].append(values)
                else:
                    self.spans[name].append((e["ts"], e["ts"] + e["dur"]))

    def launched_at(self, kernel: dict) -> Optional[float]:
        """Host time of the call that launched a device event."""
        return self.launch.get((kernel.get("args") or {}).get("correlation"))

    def share_in_decode(self, names: Iterable[str]) -> Optional[float]:
        """Of the kernel time that the slice's decode chunks launched, the
        share launched inside spans named ``names``, in %."""
        chunks = _union(self.spans.get(DECODE, []))
        inner = _union(iv for n in names for iv in self.spans.get(n, []))
        if not chunks or not inner:
            return None
        total = part = 0.0
        for k in self.trace.kernels:
            t = self.launched_at(k)
            if t is None or not _inside(chunks, t):
                continue
            total += k["dur"]
            if _inside(inner, t):
                part += k["dur"]
        return 100.0 * part / total if total else None

    def count_sums(self, name: str) -> Optional[Dict[str, int]]:
        """Each key's sum over the slice's ``name`` counts (None if it
        holds none)."""
        rows = self.counts.get(name)
        if not rows:
            return None
        out: Dict[str, int] = collections.Counter()
        for values in rows:
            out.update(values)
        return dict(out)


def share_in_decode(r, names: Iterable[str]) -> Optional[float]:
    """``Spans.share_in_decode`` of a run's traced slice."""
    if r.trace is None or not r.trace.kernels:
        return None
    return Spans(r.trace).share_in_decode(names)


def count_sums(r, name: str) -> Optional[Dict[str, int]]:
    """``Spans.count_sums`` of a run's traced slice."""
    if r.trace is None:
        return None
    return Spans(r.trace).count_sums(name)
