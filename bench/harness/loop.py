"""The closed loop over the program's server, and what it records.

One ``Server`` (the program's entry, ``repro_torch.serve.server``) runs
the engine on its worker thread.  Every client's next request is sent from
its last one's terminal stream event, on that thread, so the order of
submissions depends on the scheduler's decisions alone, never on thread
timing.  The requests' token ids are drawn in set-up (``Traffic.prepare``),
so a submission on that thread costs a queue put.

The scheduler's boundaries are read from the stream events alone.  At
each boundary the continuous scheduler admits what fits (one prefill),
runs one decode chunk over every live row and then delivers the chunk's
tokens in one pass: every live request gets one block of ``chunk``
tokens (fewer at the end of its budget), the rows that stay live first,
in the order they were admitted, then the rows this boundary admitted.
So a block that starts at index ``chunk * j`` (j > 0) belongs to the pass
after the request's last one, and a request's first block belongs to the
current pass while any request is live.  When none is (every row of the
pass ended in it), a new request's first block is still in this pass if
it was sent before the pass and a slot was free, and in the next one
otherwise.  A pass k delivers the work of boundary k: the first block
tells which requests shared an admission prefill.  (A request the engine
preempts starts again at index 0; the run counts such restarts.)
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional

from harness.traffic import Spec, Traffic


class WindowClosed(Exception):
    """Raised from a stream callback to end the engine's drain once the
    window has closed (the engine fails the requests still running)."""


@dataclasses.dataclass
class Rec:
    """One request as the client saw it."""
    spec: Spec
    t_submit: float
    #: the pass that was being delivered when this request was sent
    sent_in: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    #: [host time, tokens, boundary] of each delivery (one a pass)
    deliveries: List[list] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    #: the boundary whose admission prefilled this request
    first_boundary: Optional[int] = None
    t_done: Optional[float] = None
    reason: Optional[str] = None
    restarts: int = 0
    error: Optional[str] = None
    handle: object = None

    @property
    def n_prompt(self) -> int:
        return len(self.spec.prompt)


class ClosedLoop:
    """Clients of one traffic over one server.

    ``on_boundary(k, now, admits)`` is called on the worker thread while a
    pass delivers tokens (the device is idle: the chunk ended in a host
    copy), with ``k`` the boundary that runs next: once as the pass
    begins (``admits`` False) and after each request sent in it (``admits``
    True: boundary ``k`` admits that request).  The tracer starts and
    stops there."""

    def __init__(self, server_cls, engine, traffic: Traffic, slots: int,
                 chunk: int,
                 on_boundary: Optional[Callable[[int, float, bool], None]]
                 = None):
        self.traffic = traffic
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.clock = time.perf_counter
        self.recs: List[Rec] = []
        #: the pass being delivered (0 before the first) and when each began
        self.boundary = 0
        self.boundary_times: List[float] = []
        self._live: Dict[int, int] = {}       # id(rec) -> pass of its block
        self._in_pass = 0                     # requests with a block in it
        self.sending = True
        self.closing = False
        self._on_boundary_hook = on_boundary
        self.server = server_cls(engine)

    # -- worker thread ----------------------------------------------------
    def _begin_pass(self, k: int, now: float) -> None:
        if k != self.boundary + 1:
            raise RuntimeError(f"stream events skipped from pass "
                               f"{self.boundary} to {k}")
        self.boundary = k
        self.boundary_times.append(now)
        self._in_pass = 0
        if self._on_boundary_hook is not None:
            self._on_boundary_hook(k + 1, now, False)

    def _pass_of_first_block(self, rec: Rec) -> int:
        if self._live:
            return self.boundary
        if rec.sent_in < self.boundary and self._in_pass < self.slots:
            return self.boundary
        return self.boundary + 1

    def _on_event(self, rec: Rec, ev) -> None:
        if self.closing:
            raise WindowClosed()
        now = self.clock()
        key = id(rec)
        if ev.finished:
            self._live.pop(key, None)
            rec.t_done, rec.reason = now, ev.finish_reason
            if self.sending:
                self.submit(rec.spec.client)
                if self._on_boundary_hook is not None:
                    self._on_boundary_hook(self.boundary + 1, now, True)
            return
        i = int(ev.index)
        if i % self.chunk == 0:               # the first token of a block
            if i == 0:
                if rec.tokens:                # the engine restarted it
                    rec.restarts += 1
                    rec.tokens, rec.deliveries, rec.t_first = [], [], None
                self._live.pop(key, None)
                k = self._pass_of_first_block(rec)
            else:
                k = self._live[key] + 1
            if k != self.boundary:
                self._begin_pass(k, now)
            self._live[key] = k
            self._in_pass += 1
            rec.deliveries.append([now, 0, k])
            if i == 0:
                rec.t_first, rec.first_boundary = now, k
        if i != len(rec.tokens):
            raise RuntimeError(f"token {i} of a request came after "
                               f"{len(rec.tokens)}")
        rec.tokens.append(int(ev.token))
        rec.deliveries[-1][1] += 1

    # -- any thread -------------------------------------------------------
    def submit(self, client: int) -> Rec:
        from repro_torch.serve.api import Request
        spec = self.traffic.request(client)
        rec = Rec(spec=spec, t_submit=self.clock(), sent_in=self.boundary)
        self.recs.append(rec)
        rec.handle = self.server.submit(Request(
            prompt=spec.prompt, max_new_tokens=spec.max_new,
            stream=functools.partial(self._on_event, rec)))
        return rec

    def start(self, clients: int, fill: int, timeout_s: float) -> None:
        """Start the server, send every client's first request and wait
        until ``fill`` of them have their first token."""
        self.server.start()
        for c in range(clients):
            self.submit(c)
        deadline = self.clock() + timeout_s
        while sum(r.t_first is not None for r in self.recs) < fill:
            if self.clock() > deadline:
                raise TimeoutError(f"{fill} first tokens not in {timeout_s}s")
            if any(r.handle is not None and r.handle.done
                   and r.reason is None for r in self.recs):
                raise RuntimeError("a request failed during set-up")
            time.sleep(0.005)

    def close(self, timeout_s: float = 300.0) -> None:
        """Stop sending, end the drain at its next delivery, stop the
        server and wait for its worker."""
        self.sending = False
        self.closing = True
        self.server.stop(drain=False, timeout=timeout_s)
