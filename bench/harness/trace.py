"""A traced slice of the window: ``torch.profiler`` over whole scheduler
boundaries, and what is read from it.

The profiler starts at one boundary and stops some boundaries later, both
on the server's worker thread (whose ops and the program's ``serve.*``
markers it then records).  At a boundary the device is idle (the chunk
before it ended in a host copy), so the slice holds whole admissions and
whole decode chunks.  Device time comes from the device's own events
(kernels, copies, sets).  A kernel belongs to a marker when the host call
that launched it (matched by the trace's correlation id) lies inside it.

The kernel families are a frozen copy of the program's trace breakdown
(``repro_torch/profiling/breakdown.py``), kept here so that a later change
of the program cannot change the yardstick.
"""
from __future__ import annotations

import bisect
import collections
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
_HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                    "cuda_driver", "python_function")

_COLLECTIVE_RE = re.compile(
    r"nccl|c10d(_functional)?::|all_?reduce|all_?gather|reduce_?scatter|"
    r"all_?to_?all")
_ATTENTION_RE = re.compile(
    r"flash|fmha|softmax|attention|scaled_dot_product")
_GEMM_RE = re.compile(
    r"gemm|gemv|cublas|cutlass|nvjet|xmma|"
    r"^aten::(mm|bmm|addmm|baddbmm|addbmm|addmv|mv|dot|matmul|einsum|"
    r"linear|_scaled_mm)$")

#: the program's span names read here
DECODE = "serve.decode_chunk"
PREFILL = "serve.prefill_admit"


def family(name: str) -> str:
    """Family of one kernel name: collective, attention, gemm or other."""
    low = name.lower()
    if _COLLECTIVE_RE.search(low):
        return "collective"
    if _ATTENTION_RE.search(low):
        return "attention"
    if _GEMM_RE.search(low):
        return "gemm"
    return "other"


def base_op(name: str) -> str:
    """A kernel's name without return type, template arguments and
    parameters, so its instantiations fold into one."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The events of one traced slice (times in the trace's microseconds)."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATEGORIES]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in xs if e.get("cat") in _HOST_CATEGORIES]
        self._launch = {}
        for e in xs:
            if e.get("cat") in _LAUNCH_CATEGORIES:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    self._launch[c] = e["ts"]
        self.markers: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" and \
                    str(e.get("name", "")).startswith("serve."):
                self.markers[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        for v in self.markers.values():
            v.sort()
        ts = [e["ts"] for e in xs]
        ends = [e["ts"] + e["dur"] for e in xs]
        self.start = min(ts) if ts else 0.0
        self.end = max(ends) if ends else 0.0

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    # -- whole slice ----------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _union([(e["ts"], e["ts"] + e["dur"]) for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    # -- by marker --------------------------------------------------------------
    def _marker_index(self, name: str, ev: dict) -> Optional[int]:
        """Which instance of marker ``name`` launched device event ``ev``."""
        c = (ev.get("args") or {}).get("correlation")
        t = self._launch.get(c)
        spans = self.markers.get(name, [])
        if t is None or not spans:
            return None
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return i
        return None

    def kernels_in(self, name: str) -> Dict[int, List[dict]]:
        """Device kernels launched inside each instance of marker ``name``."""
        out: Dict[int, List[dict]] = collections.defaultdict(list)
        for e in self.kernels:
            i = self._marker_index(name, e)
            if i is not None:
                out[i].append(e)
        return out

    def family_s(self, name: str, fam: str) -> float:
        """Device seconds of kernels of family ``fam`` launched inside
        marker ``name``."""
        return sum(e["dur"] for ks in self.kernels_in(name).values()
                   for e in ks if family(e.get("name", "")) == fam) * 1e-6

    def device_span_s(self, name: str) -> float:
        """Sum over the instances of marker ``name`` of the device span of
        what each launched (its first kernel's start to its last's end)."""
        total = 0.0
        for ks in self.kernels_in(name).values():
            total += max(e["ts"] + e["dur"] for e in ks) - min(e["ts"]
                                                               for e in ks)
        return total * 1e-6

    # -- breakdown -----------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> List[list]:
        acc: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            acc[base_op(e.get("name", "?"))] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time on the device, summed by what the host was doing: the
        innermost host event (marker, op or runtime call) around each gap's
        middle, under its enclosing ``serve.*`` marker."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        host = sorted(self.host, key=lambda e: (e["ts"], -e["dur"]))
        acc: Dict[str, float] = collections.defaultdict(float)
        stack: List[dict] = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            # host calls nest on the worker thread: a stack of the open ones
            while i < len(host) and host[i]["ts"] <= mid:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < \
                        host[i]["ts"]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
                stack.pop()
            open_ = [e for e in stack if e["ts"] + e["dur"] >= mid]
            marker = next((e["name"] for e in reversed(open_)
                           if str(e.get("name", "")).startswith("serve.")),
                          None)
            inner = next((e["name"] for e in reversed(open_)
                          if not str(e.get("name", "")).startswith("serve.")),
                         None)
            label = "/".join(x for x in (marker, inner) if x) or \
                "host: no traced call"
            acc[label] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:n]]


class Tracer:
    """Starts ``torch.profiler`` when, ``after_s`` or more past the
    window's opening, a request is sent (so the slice opens with the
    admission prefill that takes it) and stops it ``boundaries``
    boundaries later."""

    def __init__(self, after_s: float, boundaries: int, on_card: bool):
        self.after_s = float(after_s)
        self.boundaries = int(boundaries)
        self.on_card = on_card
        self.t0: Optional[float] = None
        self.prof = None
        self.k_start: Optional[int] = None
        self.k_stop: Optional[int] = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self._cut = False

    def _profiler(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        loads the tracing library."""
        p = self._profiler()
        p.start()
        p.stop()

    def on_boundary(self, k: int, now: float, admits: bool) -> None:
        """Between boundaries, with ``k`` the next (see ``loop.py``)."""
        if self.t0 is None or self.k_stop is not None:
            return
        if self.k_start is None:
            if now >= self.t0 + self.after_s and admits:
                self.prof = self._profiler()
                self.prof.start()
                self.k_start, self.t_start = k, now
        elif k >= self.k_start + self.boundaries or self._cut:
            self.prof.stop()
            self.k_stop, self.t_stop = k, now

    def cut(self, timeout_s: float = 120.0) -> None:
        """Before the window closes: a slice still open ends at the next
        boundary (the profiler stops on the thread that started it)."""
        import time
        if self.k_start is None or self.k_stop is not None:
            return
        self._cut = True
        deadline = time.perf_counter() + timeout_s
        while self.k_stop is None and time.perf_counter() < deadline:
            time.sleep(0.01)

    def export(self, path: str) -> Optional[Trace]:
        if self.k_stop is None:
            return None
        self.prof.export_chrome_trace(path)
        return Trace.load(path)
