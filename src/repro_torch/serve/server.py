"""Async streaming front-end: a long-lived server over one Engine.

The port's copy of the JAX package's ``serve/server.py``.  The Engine is
single-threaded by design — every kernel launch, page table and counter is
touched from one thread.  The :class:`Server` puts that thread
to work continuously (MaxText's ``OfflineInference``/``JetThread`` shape):

* callers on any thread ``submit(Request)`` into a queue and immediately
  get a :class:`~repro_torch.serve.api.RequestHandle`;
* one daemon **worker thread** owns the engine: it drains the queue into
  ``engine.submit`` and calls ``engine.run()``, which enters
  ``torch.no_grad()`` on that thread and issues its CUDA work on the
  default stream;
* while a drain is in flight, the engine polls the server's **ingest hook**
  at every decode-chunk boundary, so requests arriving mid-drain join the
  live batch without waiting for it to finish — true continuous ingestion,
  not run-to-completion batching;
* per-token ``stream`` callbacks and handle resolution happen on the
  worker thread the moment tokens/results are host-visible, so TTFT in
  ``stats()["latency"]`` measures the real submit-to-first-token path.

Requests served through a Server cannot carry ``Request.row`` (an index
into per-drain input arrays), which contradicts open-ended ingestion.

On a multi-rank mesh every rank's engine must admit the same arrivals at
the same boundary.  Rank 0 owns the Server; every other rank runs
:func:`follow` on its engine.  Rank 0's worker broadcasts (over the
default process group) the start of each drain, each boundary's arrivals
(prompt, token budget and temperature; streams and handles stay on rank
0) and the shutdown; the followers' engines submit the same requests and
so make the same scheduling decisions, chunk for chunk.

Example::

    with Server(engine) as srv:
        h = srv.submit(Request(prompt=[5, 9, 2], max_new_tokens=16,
                               stream=print))
        tokens = h.result(timeout=60).tokens
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.serve import api

#: rank 0's control messages to the followers
_DRAIN, _STOP = "drain", "stop"


def _broadcast(obj=None):
    """Rank 0's ``obj`` on every rank of the default process group."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _wire(req: api.Request) -> tuple:
    """What a follower needs of a request: no stream, no handle."""
    return (list(req.prompt), int(req.max_new_tokens), req.temperature)


def follow(engine) -> int:
    """Mirror rank 0's :class:`Server` on this rank of a multi-rank mesh
    until it stops: run a drain of ``engine`` whenever rank 0 does,
    admitting the arrivals rank 0 broadcasts at each boundary.  Returns
    the requests served (their results stay on rank 0)."""
    def ingest():
        return [(api.Request(prompt=p, max_new_tokens=n, temperature=t),
                 api.RequestHandle()) for p, n, t in _broadcast()]
    engine._ingest_hook = ingest
    served = 0
    try:
        while _broadcast() == _DRAIN:
            served += len(engine.run())
    finally:
        engine._ingest_hook = None
    return served


class Server:
    """Threaded request ingestion + streaming over one Engine.

    Args:
      engine: a :class:`repro_torch.serve.Engine`.  The server owns it while
        running — no other thread may call it.
      poll_timeout_s: how long the idle worker blocks waiting for the next
        request before re-checking for shutdown.
    """

    def __init__(self, engine, poll_timeout_s: float = 0.05):
        mesh = getattr(engine, "mesh", None)
        #: a multi-rank mesh: the worker keeps the followers in step
        self._leads = mesh is not None and mesh.size() > 1
        if self._leads and dist.get_rank() != 0:
            raise RuntimeError("on a multi-rank mesh rank 0 owns the Server; "
                               "every other rank runs serve.server.follow")
        self.engine = engine
        self.poll_timeout_s = float(poll_timeout_s)
        self._ingest: "queue.Queue[Tuple[api.Request, api.RequestHandle]]" \
            = queue.Queue()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._submitted = 0
        self._served = 0
        self._failed = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Server":
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self.engine._ingest_hook = self._poll_ingest
        self._worker = threading.Thread(target=self._work, name="serve-worker",
                                        daemon=True)
        self._worker.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0
             ) -> None:
        """Shut the worker down.  ``drain=True`` serves everything already
        submitted first; ``drain=False`` fails queued-but-unstarted
        requests with ``RuntimeError``."""
        if self._worker is None:
            return
        if not drain:
            self._drop_pending(RuntimeError("server stopped before serving"))
        self._stop.set()
        self._worker.join(timeout)
        alive = self._worker.is_alive()
        self._worker = None
        self.engine._ingest_hook = None
        if alive:
            raise RuntimeError(f"server worker did not stop in {timeout}s")

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    # -- ingestion (any thread) -----------------------------------------
    def submit(self, request: api.Request) -> api.RequestHandle:
        """Queue one request; returns its handle immediately.  The engine
        assigns the request id when the worker ingests it (handles resolve
        regardless)."""
        if self._worker is None or self._stop.is_set():
            raise RuntimeError("server is not running")
        if request.row is not None:
            raise ValueError(
                "server-mode requests cannot carry row=; use "
                "Engine.generate for per-request input arrays")
        handle = api.RequestHandle()
        with self._lock:
            self._submitted += 1
        self._ingest.put((request, handle))
        return handle

    # -- worker thread ---------------------------------------------------
    def _poll_ingest(self) -> List[Tuple[api.Request, api.RequestHandle]]:
        """Engine callback at each chunk/wave boundary: everything queued
        since the last boundary joins the live batch (and, on a multi-rank
        mesh, every follower's)."""
        items = self._take_pending()
        if self._leads:
            _broadcast([_wire(req) for req, _ in items])
        return items

    def _take_pending(self) -> List[Tuple[api.Request, api.RequestHandle]]:
        items = []
        while True:
            try:
                items.append(self._ingest.get_nowait())
            except queue.Empty:
                return items

    def _work(self) -> None:
        while True:
            if self._ingest.empty():
                if self._stop.is_set():
                    if self._leads:
                        _broadcast(_STOP)
                    return
                try:
                    item = self._ingest.get(timeout=self.poll_timeout_s)
                except queue.Empty:
                    continue
                self._ingest.put(item)      # run()'s ingest poll takes it
            if self._leads:
                _broadcast(_DRAIN)
            try:
                results = self.engine.run()
            except Exception as exc:
                # engine.run already failed the handles of active rows;
                # anything still in the ingest queue fails here so no
                # caller blocks forever on a dead drain
                self._drop_pending(exc)
                with self._lock:
                    self._failed += 1
                continue
            with self._lock:
                self._served += len(results)

    def _drop_pending(self, exc: BaseException) -> None:
        for _, handle in self._take_pending():
            if not handle.done:
                handle._set_error(exc)

    # -- telemetry -------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Engine stats plus a ``server`` counter block."""
        st = self.engine.stats()
        with self._lock:
            st["server"] = {
                "submitted": self._submitted,
                "served": self._served,
                "failed_drains": self._failed,
                "pending": self._ingest.qsize(),
                "running": self._worker is not None,
            }
        return st
