"""What a run measured, and the arithmetic the metric readers share.

A ``Record`` holds the client's view of every request (host clock), the
scheduler's boundaries, the window and, in a traced run, the traced slice.
End-to-end metrics are taken over the whole window from the client's
side; per-layer metrics over the traced slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from harness import flops, peaks
from harness.loop import Rec
from harness.trace import Trace


@dataclasses.dataclass
class Record:
    cell: str
    cfg: dict                     # the model's configuration as run
    traffic: dict
    seconds: float
    t0: float                     # window opens (host clock)
    t1: float                     # window closes
    setup_s: float
    recs: List[Rec]
    boundary_times: List[float]
    decode_chunk: int
    trace: Optional[Trace] = None
    k_start: Optional[int] = None  # traced slice: boundaries [k_start, k_stop)
    k_stop: Optional[int] = None


def p95(values: List[float]) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95.0))


def in_window(r: Record, t: Optional[float]) -> bool:
    return t is not None and r.t0 <= t < r.t1


def window_tokens(r: Record) -> int:
    return sum(n for q in r.recs for t, n, _ in q.deliveries
               if in_window(r, t))


def whole_pass_rate(r: Record) -> Optional[float]:
    """Tokens per second over every pass the window touches: every token
    that the passes after the last scheduler boundary at or before its
    opening, through the first at or after its close, delivered, over the
    time between those two boundaries.  A pass's tokens are the work done
    since the boundary before it, so that time holds the whole window,
    no pass is counted in part, and a stall at either end counts as
    time.  The last pass is delivered whole once the boundary after it
    has begun (``run.py`` closes the loop then)."""
    bt = r.boundary_times
    before = [k for k, t in enumerate(bt, 1) if t <= r.t0]
    after = [k for k, t in enumerate(bt, 1) if t >= r.t1]
    if not before or len(after) < 2:
        return None
    a, z = before[-1], after[0]
    n = sum(n for q in r.recs for _, n, k in q.deliveries if a < k <= z)
    return n / (bt[z - 1] - bt[a - 1])


def ttfts(r: Record) -> List[float]:
    """Submit to first token of each request whose first token came in the
    window, and the wait so far of each request sent before the window
    closed and still without one."""
    out = []
    for q in r.recs:
        if q.t_submit >= r.t1:
            continue
        if in_window(r, q.t_first):
            out.append(q.t_first - q.t_submit)
        elif q.t_first is None or q.t_first >= r.t1:
            out.append(r.t1 - q.t_submit)
    return out


def tpots(r: Record) -> List[float]:
    """Per request with two deliveries or more in the window: seconds from
    its first to its last delivery there over the tokens after the first."""
    out = []
    for q in r.recs:
        d = [x for x in q.deliveries if in_window(r, x[0])]
        if len(d) >= 2:
            out.append((d[-1][0] - d[0][0]) / sum(x[1] for x in d[1:]))
    return out


def window_prompt_tokens(r: Record) -> int:
    return sum(q.n_prompt for q in r.recs if in_window(r, q.t_first))


def window_admissions(r: Record) -> int:
    return len({q.first_boundary for q in r.recs if in_window(r, q.t_first)})


# -- the traced slice -----------------------------------------------------


def _in_slice(r: Record, k: Optional[int]) -> bool:
    return k is not None and r.k_start <= k < r.k_stop


def slice_ok(r: Record) -> bool:
    """A slice was traced on the card (it holds device events)."""
    return (r.trace is not None and r.k_start is not None
            and bool(r.trace.device))


def slice_admissions(r: Record) -> List[List[int]]:
    """Prompt lengths of each admission in the slice."""
    groups = {}
    for q in r.recs:
        if _in_slice(r, q.first_boundary):
            groups.setdefault(q.first_boundary, []).append(q.n_prompt)
    return [groups[k] for k in sorted(groups)]


def _decode_runs(r: Record):
    """(boundary, context of the delivery's first decoded token, decoded
    tokens) of each delivery in the slice; a request's first token is the
    prefill's and is left out."""
    for q in r.recs:
        seen = 0
        for t, n, k in q.deliveries:
            first = seen
            seen += n
            if not _in_slice(r, k):
                continue
            if first == 0:
                first, n = 1, n - 1
            if n > 0:
                yield k, q.n_prompt + first, n


def slice_flops(r: Record) -> float:
    """Useful model FLOPs of the slice: its decoded tokens at their own
    contexts and its admitted prompts' real tokens."""
    total = 0.0
    for _, c, n in _decode_runs(r):
        # decoded tokens at contexts c .. c + n - 1
        total += n * 2 * flops.matmul_params_per_token(r.cfg)
        total += flops.attention_flops(r.cfg, 1) * (n * c + n * (n - 1) // 2)
    for lengths in slice_admissions(r):
        total += sum(flops.prompt_flops(r.cfg, n) for n in lengths)
    return total


def mfu_pct(r: Record) -> Optional[float]:
    if not slice_ok(r):
        return None
    return 100.0 * slice_flops(r) / (r.trace.window_s * peaks.BF16_FLOPS)


def decode_gemm_bound_s(r: Record) -> float:
    """Least time of the slice's decode steps' matrix products: each chunk
    runs ``decode_chunk`` steps over its live rows, each at the middle of
    the context it decodes in that chunk."""
    chunks = {}
    for k, c, n in _decode_runs(r):
        chunks.setdefault(k, []).append(c + n // 2)
    return sum(r.decode_chunk * flops.decode_step_gemm_bound_s(r.cfg, ctxs)
               for ctxs in chunks.values())


def idle_pct(r: Record) -> Optional[float]:
    if not slice_ok(r):
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
